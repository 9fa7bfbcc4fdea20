// The 2x2 / stride-2 transposed convolution and its backward:
//     y[n, 2i+di, 2j+dj, o] = sum_c x[n, i, j, c] w[c, o, di, dj] + b[o]
//     dx[n, i, j, c]        = sum_{di, dj, o} g[n, 2i+di, 2j+dj, o] w[c, o, di, dj]
//     dw[c, o, di, dj]      = sum_{n, i, j} x[n, i, j, c] g[n, 2i+di, 2j+dj, o]
//     db[o]                 = sum of g over n, y, x
//
// Replaces: unet_goolenet_tpu/ops/pallas/conv.py:conv_transpose2x2_pallas
// (forward _deconv_kernel; VJP _deconv_bwd: _deconv_dx_kernel and
// _deconv_dwdb_kernel). w is torch's ConvTranspose2d (cin, cout, 2, 2).
//
// Design, all on dense_conv.cuh and conv_dw.cuh:
//   * forward: conv_kernel's DECONV mode, the transposed conv as a 1x1 conv
//     with 4 cout outputs ordered (di, dj, o), scattered to the parities in
//     the epilogue (as up_level.cu's first launch).
//   * dx: conv_kernel with D2S staging and the AFFINE epilogue at scale 1,
//     bias 0: a 1x1 conv with K = 4 cout over g read at the four parities
//     (the inverse depth-to-space), no copy of g.
//   * dW, db: one launch of conv_dw.cuh's wgrad_kernel with K = 1, a GEMM
//     of M = cin, N = 4 cout (32 channels at the four parities a block), K =
//     the pixels in steps of 64 through a cp.async ring, g read at its
//     parities the same way, mma.sync in bf16; the blocks of x's first 64
//     channels also sum the g tiles they stage for db. The pixels are split
//     as wgrad_plan says and the chunks summed in a fixed order in the same
//     launch, into torch's (cin, cout, 2, 2) and db.
// cin and cout are multiples of 64 (the UNet's 64-512).
//
// Bound on an H100: 8 cin cout FLOP per input pixel; at up1 (64 -> 64,
// 112^2 -> 224^2) and batch 4 that is 1.6 GFLOP against 16 MB moved in bf16:
// memory bound, ~0.005 ms.
#include "conv_dw.cuh"

template <typename T>
static cudaError_t launch_deconv(const void* x, const void* w, const float* b, void* out, int N,
                                 int H, int W, int cin, int cout, cudaStream_t s) {
  using namespace dense;
  ConvArgs a{};
  a.src0 = x; a.c0 = cin; a.cin = cin; a.w = w; a.b = b; a.out = out; a.cout = cout;
  a.H = H; a.W = W;
  return launch<T, 1, DENSE, DECONV>(a, N, 4 * cout / common::C, s);
}

template <typename T>
static cudaError_t launch_dx(const void* g, const void* w, const float* ones, const float* zeros,
                             void* dx, int N, int H, int W, int cin, int cout, cudaStream_t s) {
  using namespace dense;
  ConvArgs a{};
  a.src0 = g; a.c0 = 4 * cout; a.cin = 4 * cout; a.w = w; a.b = zeros; a.scale = ones;
  a.relu = 0; a.out = dx; a.cout = cin; a.H = H; a.W = W;
  return launch<T, 1, D2S, AFFINE>(a, N, cin / common::C, s);
}

// dtype: 0 = float32, 1 = bfloat16. H, W: x's size. x (N, H, W, cin); w
// blocked as a 1x1 conv with 4 cout outputs (ops/kernels/up2.py:
// deconv_as_conv1x1, then blocked_taps); b (cout,) float32; out (N, 2H, 2W,
// cout). Returns a cudaError_t (0 on success).
extern "C" int deconv_launch(int dtype, const void* x, const void* w, const float* b, void* out,
                             int N, int H, int W, int cin, int cout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_deconv<float>(x, w, b, out, N, H, W, cin, cout, s);
  if (dtype == 1) return launch_deconv<__nv_bfloat16>(x, w, b, out, N, H, W, cin, cout, s);
  return (int)cudaErrorInvalidValue;
}

// dx (N, H, W, cin) of g (N, 2H, 2W, cout); w blocked as a 1x1 conv from 4
// cout inputs ordered (di, dj, o) to cin outputs; ones, zeros (cin,) float32.
extern "C" int deconv_dx_launch(int dtype, const void* g, const void* w, const float* ones,
                                const float* zeros, void* dx, int N, int H, int W, int cin,
                                int cout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dx<float>(g, w, ones, zeros, dx, N, H, W, cin, cout, s);
  if (dtype == 1) return launch_dx<__nv_bfloat16>(g, w, ones, zeros, dx, N, H, W, cin, cout, s);
  return (int)cudaErrorInvalidValue;
}

// out = dw (cin, cout, 2, 2) then db (cout,), float32, of x (N, H, W, cin)
// and g (N, 2H, 2W, cout); chunks, per_chunk and reduce (0 one chunk, 1 a
// cluster, 2 the grid) from wgrad_plan; for a grid reduce, part (chunks, 4
// cin cout + cout) float32 scratch and bar two unsigned counters, zero, that
// the launch leaves zero (both null otherwise).
extern "C" int deconv_dwdb_launch(int dtype, const void* x, const void* g, float* part,
                                  unsigned* bar, float* out, int N, int H, int W, int cin,
                                  int cout, int chunks, int per_chunk, int reduce,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cin % common::C) return (int)cudaErrorInvalidValue;
  wgrad::WgArgs a{};
  a.x = x; a.g = g; a.cx = a.cin = cin; a.cg = cout; a.N = N; a.H = H; a.W = W;
  a.mtiles = cin / common::C; a.ntiles = cout / 32;
  a.items = (int)(((long long)N * H * W + wgrad::STEP - 1) / wgrad::STEP);
  a.chunks = chunks; a.per_chunk = per_chunk; a.reduce = reduce;
  a.dw_size = 4 * cin * cout; a.stride = a.dw_size + cout; a.out = out; a.part = part; a.bar = bar;
  if (dtype == 0) return wgrad::launch_wgrad<float, 1>(a, s);
  if (dtype == 1) return wgrad::launch_wgrad<__nv_bfloat16, 1>(a, s);
  return (int)cudaErrorInvalidValue;
}
