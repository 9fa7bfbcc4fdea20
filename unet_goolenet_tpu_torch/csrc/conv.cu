// The fused 3x3 convolution with its backward, and the fused conv-stack
// pair, for the UNet's ConvBatchNorm blocks:
//     fused_conv3x3   y  = [relu](conv3x3_p1(x, w) * scale + bias)
//       its dx        dx = conv3x3_p1(gc, w flipped and io-transposed)
//       its dw        dw = sum over pixels of x_pad[p + tap] gc[p]
//     fused_convstack2 y = CBN2(CBN1(x)), each CBN as fused_conv3x3 + relu
// where gc = dy * scale (masked by y > 0 under relu) is formed by the caller.
//
// Replaces: unet_goolenet_tpu/ops/pallas/conv.py:fused_conv3x3 (forward
// _fwd_kernel; VJP _fused_bwd, whose dx reuses the forward kernel and whose
// dw is _dw_kernel) and :fused_convstack2 (_stack2_kernel). dscale and
// dbias stay plain reductions, as in the JAX VJP.
//
// Forward and dx: one launch of dense_conv.cuh's conv_kernel in AFFINE mode
// (out = acc * scale + bias, then relu if asked). cin may be any count (the
// UNet's first conv has 3): the kernel stages the slab beyond cin as zeros
// and the host pads the weights' cin to 64 with zeros; cout is a multiple
// of 64. dw: one launch of conv_dw.cuh's wgrad_kernel with K = 3 (bf16: TMA
// boxes into a 4-stage ring and wgmma, 3 warpgroups of 3 taps; float32: a
// cp.async ring and FMA; a pixel tile fitted to the level's width; the
// pixels split into chunks by ops/kernels/conv.py:wgrad_plan and the chunks
// summed in a fixed order inside the same launch), written straight into
// torch's (cout, cin, 3, 3); the host pads a ragged x (cin = 3) to 8
// channels.
//
// The pair: two AFFINE launches with relu, the intermediate (N, H, W, cmid)
// through device memory (mostly L2), as pool + down1 (down1.cu) does. On
// chip it would need cmid channels of the intermediate over the tile and its
// halo, 10 x 18 x 512 x 2 = 184 KB in bf16 at cmid = 512, beside the second
// conv's weight slab (74 KB): over a block's 227 KB.
//
// Bound on an H100: the 3x3 conv's 18 * cin * cout FLOP a pixel on the bf16
// tensor cores (989 TFLOP/s) or float32 FMA (67 TFLOP/s) against x, w and y
// once through memory (3.35 TB/s): at 224^2 and batch 4, 64 -> 64 is 14.8
// GFLOP against 51 MB in bf16, ~0.015 ms either way; dw does the same
// operations against x and g (bounds of the whole pass: conv_dw.cuh);
// chip_smoke.py computes each shape's bound.
#include "conv_dw.cuh"

template <typename T>
static cudaError_t launch_conv3x3(const void* x, const void* w, const float* scale,
                                  const float* bias, void* out, int N, int H, int W, int cin,
                                  int cout, int relu, cudaStream_t s) {
  using namespace dense;
  ConvArgs a{};
  a.src0 = x; a.c0 = cin; a.cin = (cin + common::C - 1) / common::C * common::C;
  a.w = w; a.b = bias; a.scale = scale; a.relu = relu; a.out = out; a.cout = cout;
  a.H = H; a.W = W;
  return launch<T, 3, DENSE, AFFINE>(a, N, cout / common::C, s);
}

// dtype: 0 = float32, 1 = bfloat16. x (N, H, W, cin); w blocked
// ([cout/64][9][64][cin64] bf16, [cout/64][9][cin64][64] float, cin64 = cin
// rounded up to 64, zeros beyond cin); scale, bias (cout,) float32; out
// (N, H, W, cout). Returns a cudaError_t (0 on success).
extern "C" int conv3x3_launch(int dtype, const void* x, const void* w, const float* scale,
                              const float* bias, void* out, int N, int H, int W, int cin,
                              int cout, int relu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_conv3x3<float>(x, w, scale, bias, out, N, H, W, cin, cout, relu, s);
  if (dtype == 1)
    return launch_conv3x3<__nv_bfloat16>(x, w, scale, bias, out, N, H, W, cin, cout, relu, s);
  return (int)cudaErrorInvalidValue;
}

// The pair: mid (N, H, W, cmid) is scratch. Weights as conv3x3_launch's.
extern "C" int convstack2_launch(int dtype, const void* x, const void* w1, const float* s1,
                                 const float* b1, const void* w2, const float* s2,
                                 const float* b2, void* mid, void* out, int N, int H, int W,
                                 int cin, int cmid, int cout, void* stream) {
  int err = conv3x3_launch(dtype, x, w1, s1, b1, mid, N, H, W, cin, cmid, 1, stream);
  if (err != 0) return err;
  return conv3x3_launch(dtype, mid, w2, s2, b2, out, N, H, W, cmid, cout, 1, stream);
}

// dw (cout, cin, 3, 3) float32 of x (N, H, W, cx), cx >= cin a multiple of
// 8 (zeros beyond cin), and gc (N, H, W, cout); tw (the pixel tile's width:
// 16 or 32 for bf16, 16, 28 or 14 for float32), chunks, per_chunk and
// reduce (0 one chunk, 1 a cluster, 2 the grid) from wgrad_plan; for a grid
// reduce, part (chunks, 9 cin cout) float32 scratch and bar two unsigned
// counters, zero, that the launch leaves zero (both null otherwise).
template <typename T>
static cudaError_t launch_conv_dw(wgrad::WgArgs a, int tw, cudaStream_t s) {
  if (tw == 16) return wgrad::launch_wgrad<T, 3, 16>(a, s);
  if constexpr (sizeof(T) == 2) {   // wgmma k steps stay in one tile row
    if (tw == 32) return wgrad::launch_wgrad<T, 3, 32>(a, s);
  } else {
    if (tw == 28) return wgrad::launch_wgrad<T, 3, 28>(a, s);
    if (tw == 14) return wgrad::launch_wgrad<T, 3, 14>(a, s);
  }
  return cudaErrorInvalidValue;
}

extern "C" int conv3x3_dw_launch(int dtype, const void* x, const void* g, float* part,
                                 unsigned* bar, float* dw, int N, int H, int W, int cx, int cin,
                                 int cout, int tw, int chunks, int per_chunk, int reduce,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int th = wgrad::tile_rows(tw);
  wgrad::WgArgs a{};
  a.x = x; a.g = g; a.cx = cx; a.cin = cin; a.cg = cout; a.N = N; a.H = H; a.W = W;
  a.tiles_x = (W + tw - 1) / tw; a.tiles = a.tiles_x * ((H + th - 1) / th);
  a.mtiles = (cin + common::C - 1) / common::C; a.ntiles = cout / common::C;
  a.items = N * a.tiles; a.chunks = chunks; a.per_chunk = per_chunk;
  a.reduce = reduce;
  a.dw_size = a.stride = 9 * cin * cout; a.out = dw; a.part = part; a.bar = bar;
  if (dtype == 0) return launch_conv_dw<float>(a, tw, s);
  if (dtype == 1) return launch_conv_dw<__nv_bfloat16>(a, tw, s);
  return (int)cudaErrorInvalidValue;
}
