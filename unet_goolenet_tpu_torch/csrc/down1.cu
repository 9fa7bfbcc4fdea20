// pool + down1: out = relu(conv3x3(h) + b2), h = relu(conv3x3(maxpool2x2(x1)) + b1).
//
// Replaces: unet_goolenet_tpu/ops/pallas/down1.py:fused_pool_down1 (kernel
// body _pool_down1_kernel). x1 (N, 2H, 2W, 64) NHWC -> out (N, H, W, 128).
// The pooled map and h are rounded to the activation type, as there.
//
// Bound on an H100: 1.85 + 3.70 GFLOP per 224^2 image (64->128 and
// 128->128 3x3 convs at 112^2) against 12.8 MB moved in bf16 (x1 read once,
// out written once): ~430 FLOP/byte, above the card's ~295 ridge, so the
// tensor-core work bounds it, ~0.090 ms at batch 16 in bf16.
//
// Design: two launches of dense_conv.cuh's conv_kernel.
//   1. POOL staging + RELU: each 8x16 tile stages the 2x2 max of x1 over its
//      10x18 halo (zeros outside the image, whatever the sign of x1), then
//      the 64->128 conv, two 64-channel output blocks; h is written.
//   2. RELU: the 128->128 conv over h in two input slabs.
// h (N, H, W, 128) goes through device memory: keeping it on chip needs all
// 128 channels of h over the tile and its halo (180 pixels x 128 channels)
// as accumulators of one block, which the 64-channel blocks of
// conv_kernel do not hold. That fusion is later work. Shared memory per
// block: 110 KB (bf16) / 65 KB (float), see dense_conv.cuh.
#include "dense_conv.cuh"

template <typename T>
static cudaError_t launch_down1(const void* x1, const void* w1, const float* b1, const void* w2,
                                const float* b2, void* h, void* out, int N, int H, int W, int c,
                                int co, cudaStream_t s) {
  using namespace dense;
  ConvArgs a{};
  a.src0 = x1; a.c0 = c; a.cin = c; a.w = w1; a.b = b1; a.out = h; a.cout = co;
  a.H = H; a.W = W;
  cudaError_t err = launch<T, 3, POOL, RELU>(a, N, co / common::C, s);
  if (err != cudaSuccess) return err;
  a.src0 = h; a.c0 = co; a.cin = co; a.w = w2; a.b = b2; a.out = out;
  return launch<T, 3, DENSE, RELU>(a, N, co / common::C, s);
}

// dtype: 0 = float32, 1 = bfloat16. H, W: output (= pooled) size; x1 is
// (N, 2H, 2W, c), h scratch and out (N, H, W, co). Returns a cudaError_t.
extern "C" int pool_down1_launch(int dtype, const void* x1, const void* w1, const float* b1,
                                 const void* w2, const float* b2, void* h, void* out, int N,
                                 int H, int W, int c, int co, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_down1<float>(x1, w1, b1, w2, b2, h, out, N, H, W, c, co, s);
  if (dtype == 1)
    return launch_down1<__nv_bfloat16>(x1, w1, b1, w2, b2, h, out, N, H, W, c, co, s);
  return (int)cudaErrorInvalidValue;
}
