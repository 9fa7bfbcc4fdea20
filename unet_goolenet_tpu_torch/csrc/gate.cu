// Gate pass of a decoder level: e1 = relu(conv3x3(x) + b) and the
// per-image, per-channel mean and max of e1 over (H, W).
//
// Replaces two Pallas kernels that share _cbn_stats_kernel on the TPU:
//   * unet_goolenet_tpu/ops/pallas/up1.py:fused_cbn_stats (up1: x1
//     (N, 224, 224, 64)), behind the up1_gate wrapper;
//   * unet_goolenet_tpu/ops/pallas/up2.py:fused_cbn_stats_dense (up2, up3,
//     up4: C = 128, 256, 512 at 112^2, 56^2, 28^2), behind up_gate_dense.
// One kernel serves both: x (N, H, W, C), C any multiple of 64, H and W any
// size.
//
// Bound on an H100: 3.70 GFLOP per 224^2 image at every level (the C -> C
// 3x3 conv). Moved in bf16 (x read, e1 written): 12.8 MB at up1 (~290
// FLOP/byte, on the card's ~295 ridge, so ~0.061 ms at batch 16, set by
// memory by a hair), 6.4 MB at up2-up4 (~580 FLOP/byte: ~0.060 ms, set by
// the tensor cores).
//
// Design: one launch of dense_conv.cuh's conv_kernel in STATS mode, one
// block per (8x16 tile, 64 output channels, image). The input streams
// through shared memory in 64-channel slabs with the nine 64x64 weight taps
// of each slab staged at once (110 KB per block in bf16), because a level's
// weights (up to 4.7 MB) do not fit. The statistics are taken from the
// float32 values before e1 is rounded, so e1 is never read back. The TPU
// kernel carries the running sum/max across its sequential grid; CUDA
// blocks run in no order, so each block writes its tile's partials to an
// (N, tiles, C) buffer and a second small kernel reduces them in tile
// order: deterministic, no float atomics.
#include "dense_conv.cuh"

// reduce the (N, tiles, C) partials in tile order
__global__ void dense_stats_kernel(const float* __restrict__ psum, const float* __restrict__ pmax,
                                   float* __restrict__ mean, float* __restrict__ mx, int tiles,
                                   int C, float hw) {
  const int n = blockIdx.x;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float s = 0.f, m = 0.f;
    for (int t = 0; t < tiles; ++t) {
      s += psum[((size_t)n * tiles + t) * C + c];
      m = fmaxf(m, pmax[((size_t)n * tiles + t) * C + c]);
    }
    mean[(size_t)n * C + c] = s / hw;
    mx[(size_t)n * C + c] = m;
  }
}

template <typename T>
static cudaError_t launch_gate(const void* x, const void* w, const float* b, void* e1,
                               float* psum, float* pmax, float* mean, float* mx, int N, int H,
                               int W, int C, cudaStream_t s) {
  using namespace dense;
  ConvArgs a{};
  a.src0 = x; a.c0 = C; a.cin = C; a.w = w; a.b = b; a.out = e1; a.cout = C;
  a.H = H; a.W = W; a.psum = psum; a.pmax = pmax;
  cudaError_t err = launch<T, 3, DENSE, STATS>(a, N, C / common::C, s);
  if (err != cudaSuccess) return err;
  dense_stats_kernel<<<N, 256, 0, s>>>(psum, pmax, mean, mx, tiles(H, W), C,
                                       (float)H * (float)W);
  return cudaGetLastError();
}

extern "C" int gate_tiles(int H, int W) { return dense::tiles(H, W); }

// dtype: 0 = float32, 1 = bfloat16. psum/pmax: (N, tiles, C) scratch;
// mean/mx: (N, C). Returns a cudaError_t (0 on success).
extern "C" int gate_launch(int dtype, const void* x, const void* w, const float* b, void* e1,
                           float* psum, float* pmax, float* mean, float* mx, int N, int H,
                           int W, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_gate<float>(x, w, b, e1, psum, pmax, mean, mx, N, H, W, C, s);
  if (dtype == 1)
    return launch_gate<__nv_bfloat16>(x, w, b, e1, psum, pmax, mean, mx, N, H, W, C, s);
  return (int)cudaErrorInvalidValue;
}
