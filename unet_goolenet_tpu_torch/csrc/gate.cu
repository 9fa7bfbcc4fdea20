// Gate pass of a decoder level: e1 = relu(conv3x3(x) + b) and the
// per-image, per-channel mean and max of e1 over (H, W).
//
// Replaces two Pallas kernels that share _cbn_stats_kernel on the TPU:
//   * unet_goolenet_tpu/ops/pallas/up1.py:fused_cbn_stats (up1: x1
//     (N, 224, 224, 64)), behind the up1_gate wrapper;
//   * unet_goolenet_tpu/ops/pallas/up2.py:fused_cbn_stats_dense (up2, up3,
//     up4: C = 128, 256, 512 at 112^2, 56^2, 28^2), behind up_gate_dense.
// One entry point serves both: x (N, H, W, C), C any multiple of 64, H and
// W any size.
//
// Bound on an H100: 3.70 GFLOP per 224^2 image at every level (the C -> C
// 3x3 conv). Moved in bf16 (x read, e1 written): 12.8 MB at up1 (~290
// FLOP/byte, on the card's ~295 ridge, so ~0.061 ms at batch 16, set by
// memory by a hair), 6.4 MB at up2-up4 (~580 FLOP/byte: ~0.060 ms, set by
// the tensor cores).
//
// Two launches in either dtype: the conv with the statistics' per-tile
// partials, then gate_stats_kernel, which sums the partials of each image
// in slot order (the TPU kernel carries a running sum/max across its
// sequential grid; CUDA blocks run in no order). Deterministic, no float
// atomics. The statistics are taken from the float32 values before e1 is
// rounded, so e1 is never read back.
//   * bf16: conv3x3.cuh's conv3x3_gemm (the trainer's TMA + wgmma implicit
//     GEMM) with its STATS epilogue, tiles and K splits from
//     ops/kernels/conv.py:conv_plan, passed in as 5 ints; weights (9, C, C)
//     bf16, laid out once when the model is folded. Partials (N, rtiles
//     ctiles splits, C): one slot a (M tile of the image, K-split rank).
//   * float32: dense_conv.cuh's FMA conv_kernel in STATS mode, one block a
//     (8x16 tile, 64 output channels, image), weights in its blocked
//     layout; partials (N, tiles, C), one slot a tile.
#include "conv3x3.cuh"

// mean, max (N, C) from the (N, slots, C) partials, each (image, channel)
// summed in slot order by one thread; grid (C / 32, N)
__global__ void gate_stats_kernel(const float* __restrict__ psum, const float* __restrict__ pmax,
                                  float* __restrict__ mean, float* __restrict__ mx, int slots,
                                  int C, float hw) {
  const int n = blockIdx.y, c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const size_t base = (size_t)n * slots * C + c;
  float s = 0.f, m = 0.f;
#pragma unroll 8
  for (int t = 0; t < slots; ++t) {
    s += psum[base + (size_t)t * C];
    m = fmaxf(m, pmax[base + (size_t)t * C]);
  }
  mean[(size_t)n * C + c] = s / hw;
  mx[(size_t)n * C + c] = m;
}

// bf16: one conv3x3_gemm launch, STATS epilogue; *slots gets the partials'
// slots an image
static cudaError_t gate_bf16(const void* x, const void* wk, const float* b, void* e1, float* psum,
                             float* pmax, int N, int H, int W, int C, const int* p, int* slots,
                             cudaStream_t s) {
  using namespace conv3;
  Args a{};
  a.H = H; a.W = W; a.C = C; a.slabs = C / BK; a.ncols = C; a.relu = 1; a.bias = b; a.out = e1;
  a.psum = psum; a.pmax = pmax;
  if (!plan_tiles(a, N, p[0], p[1], p[2], p[3], p[4])) return cudaErrorInvalidValue;
  *slots = a.rtiles * a.ctiles * a.splits;
  if (p[2] == 64) return launch<64, false, 2, 4, STATS>(a, x, N, wk, C, C, s);
  return launch<128, false, 1, 4, STATS>(a, x, N, wk, C, C, s);
}

extern "C" int gate_tiles(int H, int W) { return dense::tiles(H, W); }

// dtype: 0 = float32, 1 = bfloat16. w: float32 dense_conv.cuh's blocked
// layout, bf16 (9, C, C); plan: bf16 (R, S, bn, splits, clusters) from
// conv_plan, float32 unused. psum/pmax: (N, slots, C) scratch, slots =
// gate_tiles(H, W) in float32, rtiles ctiles splits of the plan in bf16;
// mean/mx: (N, C). Returns a cudaError_t (0 on success).
extern "C" int gate_launch(int dtype, const void* x, const void* w, const float* b, void* e1,
                           float* psum, float* pmax, float* mean, float* mx, int N, int H,
                           int W, int C, const int* plan, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C % common::C) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  int slots = 0;
  if (dtype == 0) {
    using namespace dense;
    ConvArgs a{};
    a.src0 = x; a.c0 = C; a.cin = C; a.w = w; a.b = b; a.out = e1; a.cout = C;
    a.H = H; a.W = W; a.psum = psum; a.pmax = pmax;
    err = launch<float, 3, DENSE, STATS>(a, N, C / common::C, s);
    slots = tiles(H, W);
  } else if (dtype == 1 && plan) {
    err = gate_bf16(x, w, b, e1, psum, pmax, N, H, W, C, plan, &slots, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  gate_stats_kernel<<<dim3(C / 32, N), 32, 0, s>>>(psum, pmax, mean, mx, slots, C,
                                                   (float)H * (float)W);
  return (int)cudaGetLastError();
}
