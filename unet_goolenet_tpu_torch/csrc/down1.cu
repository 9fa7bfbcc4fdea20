// pool + down1: out = relu(conv3x3(h) + b2), h = relu(conv3x3(maxpool2x2(x1)) + b1).
//
// Replaces: unet_goolenet_tpu/ops/pallas/down1.py:fused_pool_down1 (kernel
// body _pool_down1_kernel). x1 (N, 2H, 2W, c) NHWC -> out (N, H, W, co).
// The pooled map and h are rounded to the activation type, as there.
//
// Bound on an H100: 1.85 + 3.70 GFLOP per 224^2 image (64->128 and
// 128->128 3x3 convs at 112^2) against 12.8 MB moved in bf16 (x1 read once,
// out written once): ~430 FLOP/byte, above the card's ~295 ridge, so the
// tensor-core work bounds it, ~0.090 ms at batch 16 in bf16.
//
// bf16: three launches, with the weights laid out once when the model is
// folded (no layout launch a call):
//   1. pool.cuh's streaming pool: p = maxpool2x2(x1), (N, H, W, c).
//   2. conv3x3.cuh's conv3x3_gemm, AFFINE with relu and the float32 b1 (the
//      trainer's kernel): h = relu(conv3x3(p) + b1), (N, H, W, co).
//   3. the same over h: out = relu(conv3x3(h) + b2).
// The convs' weights are (9, cout, cin) bf16 (wk[tap][co][ci]); their tiles
// and K splits come from ops/kernels/conv.py:conv_plan (down1.py's
// down1_plans), passed in as 10 ints. Positions outside the image are zero
// after the pool, as the TPU kernel pads the pooled map: the GEMM's TMA halo
// box fills them with zeros, whatever the sign of x1.
// Why a pooled copy, and not the max in the GEMM's staging: the GEMM feeds
// its A operand by TMA, which copies and cannot take a max. Staging the max
// through registers instead needs a tile's pooled halo from x1: 16 x 16
// pooled pixels for a 256-row tile, 32 x 32 x 64 bf16 = 128 KB of x1 a
// slab, beside the GEMM's 214 KB of rings, over a block's 227 KB. The copy
// costs one more write and read of p (at batch 16, x1 102.8 MB, p 25.7 MB:
// ~51 MB, ~15 us at 3.35 TB/s, under 5% of the call).
// What the TPU kernel keeps on chip and this does not: p and h. h (N, H, W,
// co) goes through device memory (103 MB at batch 16): keeping it on chip
// needs all co channels of h over the second conv's halo for each output
// tile, and each conv waits for the whole of the stage before, as in the
// decoder level (up_level.cu).
//
// float32: two launches of dense_conv.cuh's conv_kernel (FMA):
//   1. POOL staging + RELU: each 8x16 tile stages the 2x2 max of x1 over its
//      10x18 halo (zeros outside the image, whatever the sign of x1), then
//      the 64->128 conv, two 64-channel output blocks; h is written.
//   2. RELU: the 128->128 conv over h in two input slabs.
// Shared memory per block: 65 KB (float32), 214 or 202 KB (the bf16 GEMM).
#include "conv3x3.cuh"
#include "pool.cuh"

static cudaError_t down1_f32(const void* x1, const void* w1, const float* b1, const void* w2,
                             const float* b2, void* h, void* out, int N, int H, int W, int c,
                             int co, cudaStream_t s) {
  using namespace dense;
  ConvArgs a{};
  a.src0 = x1; a.c0 = c; a.cin = c; a.w = w1; a.b = b1; a.out = h; a.cout = co;
  a.H = H; a.W = W;
  cudaError_t err = launch<float, 3, POOL, RELU>(a, N, co / common::C, s);
  if (err != cudaSuccess) return err;
  a.src0 = h; a.c0 = co; a.cin = co; a.w = w2; a.b = b2; a.out = out;
  return launch<float, 3, DENSE, RELU>(a, N, co / common::C, s);
}

// One bf16 conv3x3_gemm launch, AFFINE with relu and no scale: out (N, H, W,
// cout) = relu(conv3x3(src) + b), src (N, H, W, cin), wk (9, cout, cin); p =
// (R, S, bn, splits, clusters) from conv_plan.
static cudaError_t down1_conv(const void* src, const void* wk, const float* b, void* out, int N,
                              int H, int W, int cin, int cout, const int* p, cudaStream_t s) {
  using namespace conv3;
  Args a{};
  a.H = H; a.W = W; a.C = cin; a.slabs = cin / BK; a.ncols = cout; a.relu = 1; a.bias = b;
  a.out = out;
  if (!plan_tiles(a, N, p[0], p[1], p[2], p[3], p[4])) return cudaErrorInvalidValue;
  if (p[2] == 64) return launch<64, false, 2, 4>(a, src, N, wk, cin, cout, s);
  return launch<128, false, 1, 4>(a, src, N, wk, cin, cout, s);
}

// dtype: 0 = float32, 1 = bfloat16. H, W: output (= pooled) size; x1 is
// (N, 2H, 2W, c), h scratch and out (N, H, W, co), c and co multiples of 64.
// bf16: p (N, H, W, c) scratch, w1 (9, co, c) and w2 (9, co, co) bf16, plan
// the two conv launches' (R, S, bn, splits, clusters); float32: the blocked
// layouts of dense_conv.cuh, p and plan unused. Biases float32. Returns a
// cudaError_t (0 on success).
extern "C" int pool_down1_launch(int dtype, const void* x1, const void* w1, const float* b1,
                                 const void* w2, const float* b2, void* p, void* h, void* out,
                                 int N, int H, int W, int c, int co, const int* plan,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c % common::C || co % common::C) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)down1_f32(x1, w1, b1, w2, b2, h, out, N, H, W, c, co, s);
  if (dtype != 1 || !plan || !p) return (int)cudaErrorInvalidValue;
  cudaError_t err = pool::launch_pool_fwd<__nv_bfloat16>(x1, p, N, H, W, c, s);
  if (err == cudaSuccess) err = down1_conv(p, w1, b1, h, N, H, W, c, co, plan, s);
  if (err == cudaSuccess) err = down1_conv(h, w2, b2, out, N, H, W, co, co, plan + 5, s);
  return (int)err;
}
