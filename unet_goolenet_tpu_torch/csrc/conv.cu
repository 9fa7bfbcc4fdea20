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
// Weights: one launch a forward call lays torch's float32 (cout, cin, 3, 3)
// out for both the forward and dx (conv3x3_weight_launch; float32 writes
// dx's layout only for a forward whose backward takes dx); the backward
// reuses it.
// Forward and dx in bf16: conv3x3.cuh's conv3x3_gemm (TMA + wgmma implicit
// GEMM; tiles and K split from ops/kernels/conv.py:conv_plan). In float32:
// one launch of dense_conv.cuh's conv_kernel in AFFINE mode (out = acc *
// scale + bias, then relu if asked) on FMA; cin may be any count (the
// UNet's first conv has 3): the kernel stages the slab beyond cin as zeros
// and the weights carry cin rounded up to 64 with zeros; cout is a multiple
// of 64. dw: one launch of conv_dw.cuh's wgrad_kernel with K = 3 (bf16: TMA
// boxes into a 4-stage ring and wgmma, 3 warpgroups of 3 taps; float32: a
// cp.async ring and FMA; a pixel tile fitted to the level's width; the
// pixels split into chunks by ops/kernels/conv.py:wgrad_plan and the chunks
// summed in a fixed order inside the same launch), written straight into
// torch's (cout, cin, 3, 3); the trainer pads a ragged bf16 x (cin = 3)
// to 16 channels once a forward, for the forward and dw, which reads only
// x's first cin channels (the host pads a float32 x to 8 for dw).
//
// The pair: two forward launches with relu, the intermediate (N, H, W,
// cmid) through device memory (mostly L2), as pool + down1 (down1.cu) does.
// On chip it would need cmid channels of the intermediate over the tile and
// its halo, 10 x 18 x 512 x 2 = 184 KB in bf16 at cmid = 512, beside the
// second conv's weights: over a block's 227 KB.
//
// Bound on an H100: the 3x3 conv's 18 * cin * cout FLOP a pixel on the bf16
// tensor cores (989 TFLOP/s) or float32 FMA (67 TFLOP/s) against x, w and y
// once through memory (3.35 TB/s): at 224^2 and batch 4, 64 -> 64 is 14.8
// GFLOP against 51 MB in bf16, ~0.015 ms either way; dw does the same
// operations against x and g (bounds of the whole pass: conv_dw.cuh);
// chip_smoke.py computes each shape's bound.
#include "conv3x3.cuh"

// dtype: 0 = float32, 1 = bfloat16. w torch's (cout, cin, 3, 3) float32.
// bf16: wk (9, cout, cin8) bf16, cin8 = cin rounded up to 8 (wd unused);
// float32: wk dense_conv.cuh's forward layout (cout/64, 9, cin64, 64) and wd
// dx's, (cin64/64, 9, cout, 64), cin64 = cin rounded up to 64; wd null for a
// forward no dx call will follow (then not written).
extern "C" int conv3x3_weight_launch(int dtype, const float* w, void* wk, float* wd, int cin,
                                     int cout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cin < 1 || cout % common::C || cout < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    const int cin8 = (cin + 7) / 8 * 8, total = cout * cin8;
    conv3::weight_bf16_kernel<<<(total + 255) / 256, 256, 0, s>>>(
        w, static_cast<__nv_bfloat16*>(wk), cin, cin8, cout);
  } else if (dtype == 0) {
    const int cin64 = (cin + common::C - 1) / common::C * common::C, total = cout * cin64;
    conv3::weight_f32_kernel<<<(total + 255) / 256, 256, 0, s>>>(w, static_cast<float*>(wk), wd,
                                                                 cin, cin64, cout);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// bf16, one conv3x3_gemm launch. dx = 0: the forward, src x (N, H, W, cin16)
// (cin16 = cin rounded up to 16, zeros beyond cin), out (N, H, W, cout); dx =
// 1: src gc (N, H, W, cout), out (N, H, W, cin), scale and bias null. wk
// from conv3x3_weight_launch; scale, bias (out channels,) float32 or null.
// R, S, bn, splits and clusters from conv_plan (clusters: the persistent
// grid's, lowered to what the card runs at once for a split).
extern "C" int conv3x3_gemm_launch(int dx, const void* src, const void* wk, const float* scale,
                                   const float* bias, void* out, int N, int H, int W, int cin,
                                   int cout, int relu, int R, int S, int bn, int splits,
                                   int clusters, void* stream) {
  using namespace conv3;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cin8 = (cin + 7) / 8 * 8;
  if (N < 1 || H < 1 || W < 1 || cin < 1 || cout % common::C || cout < 1)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.scale = scale; a.bias = bias; a.out = out; a.H = H; a.W = W; a.relu = relu;
  a.ncols = dx ? cin : cout;
  a.C = dx ? cout : (cin + 15) / 16 * 16;
  a.slabs = (a.C + BK - 1) / BK;
  if (!plan_tiles(a, N, R, S, bn, splits, clusters)) return (int)cudaErrorInvalidValue;
  // BN = 64 tiles are 256 rows (two m64 blocks a warpgroup), BN = 128 tiles 128
  if (dx) {
    if (bn == 128) return launch<128, true, 1, 4>(a, src, N, wk, cin8, cout, s);
    return launch<64, true, 2, 4>(a, src, N, wk, cin8, cout, s);
  }
  if (bn == 128) return launch<128, false, 1, 4>(a, src, N, wk, cin8, cout, s);
  if (a.C == 16) return launch<64, false, 2, 1>(a, src, N, wk, cin8, cout, s);
  return launch<64, false, 2, 4>(a, src, N, wk, cin8, cout, s);
}

// float32, one conv_kernel launch: x (N, H, W, cin), w the blocked layout
// of conv3x3_weight_launch (forward: cin64 rows a tap; dx: its wd, with cin
// = the forward's cout); scale, bias (cout,) float32 or null (1 and 0); out
// (N, H, W, cout).
extern "C" int conv3x3_launch(const float* x, const float* w, const float* scale,
                              const float* bias, float* out, int N, int H, int W, int cin,
                              int cout, int relu, void* stream) {
  using namespace dense;
  ConvArgs a{};
  a.src0 = x; a.c0 = cin; a.cin = (cin + common::C - 1) / common::C * common::C;
  a.w = w; a.b = bias; a.scale = scale; a.relu = relu; a.out = out; a.cout = cout;
  a.H = H; a.W = W;
  return launch<float, 3, DENSE, AFFINE>(a, N, cout / common::C,
                                         static_cast<cudaStream_t>(stream));
}

// dw (cout, cin, 3, 3) float32 of x (N, H, W, cx), cx >= cin a multiple of
// 8 (the channels past cin not read), and gc (N, H, W, cout); tw (the pixel tile's width:
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
