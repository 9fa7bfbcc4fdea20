// The 2x2 / stride-2 max pool's forward, a streaming kernel for Hopper:
//     y[n, i, j, c] = the first maximum of x[n, 2i+di, 2j+dj, c] over
//                     (di, dj) in (r0c0, r0c1, r1c0, r1c1) order
// NaN counts as the maximum and ties go to the first, as in torch's
// max_pool2d. The chosen element's bits are copied, so y holds exactly one
// of its window's values (-0.0 before +0.0 stays -0.0, a NaN keeps its
// payload).
//
// Replaces: unet_goolenet_tpu/ops/pallas/conv.py:max_pool2x2_pallas (forward
// _pool_kernel), through pool.cu's pool_launch (the trainer's pool), and
// serves as the first of pool_down1's bf16 launches (down1.cu).
//
// Bound on an H100: memory, x read once and y written once (1.25 |x|) at
// 3.35 TB/s: a 16x224x224x64 bf16 x1 (102.8 MB, y 25.7 MB) 0.038 ms, the
// trainer's four pools at batch 4 (60 MB in bf16) 0.018 ms.
//
// Design: a unit is 16 bytes of y, 8 channels in bf16 or 4 in float32, of
// one output pixel; unit u is y's bytes 16u on, so consecutive threads take
// consecutive units and each warp's loads and stores are coalesced (at C =
// 64 bf16 a pixel is 8 units). A unit's window is four 16-byte loads; each
// thread takes UNITS units a round (a grid stride apart), 16 loads in
// flight before the first maximum. The loads bypass L1
// (ld.global.nc.L1::no_allocate: x is read once); the stores are plain, so
// that y stays in L2 for the conv that reads it next. The grid is one wave
// of as many blocks as the SMs hold, walking the units in rounds, or one
// block a 256 units where fewer. The indexing is flat, so a row need not
// hold a whole number of units' pixels (a ragged level). C must be a
// multiple of 16 / sizeof(T): 8 in bf16, 4 in float32.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace pool {
namespace {

constexpr int THREADS = 256;
constexpr int UNITS = 4;   // units a thread a round: 4 x 4 loads in flight

__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// the float value of an element's bits (bf16: the upper half of a float)
template <typename T> __device__ __forceinline__ float value(uint32_t b) {
  return __uint_as_float(sizeof(T) == 2 ? b << 16 : b);
}

// the first maximum of each element over the window's four vectors
template <typename T>
__device__ __forceinline__ uint4 window_max(const uint4 (&v)[4]) {
  constexpr int L = 16 / sizeof(T), BITS = 8 * sizeof(T);
  constexpr uint32_t MASK = BITS == 32 ? 0xffffffffu : (1u << BITS) - 1;
  uint32_t w[4][4], out[4] = {0, 0, 0, 0};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    w[k][0] = v[k].x; w[k][1] = v[k].y; w[k][2] = v[k].z; w[k][3] = v[k].w;
  }
#pragma unroll
  for (int e = 0; e < L; ++e) {
    const int word = e * BITS / 32, shift = e * BITS % 32;
    uint32_t best = (w[0][word] >> shift) & MASK;
    float m = value<T>(best);
#pragma unroll
    for (int k = 1; k < 4; ++k) {
      const uint32_t b = (w[k][word] >> shift) & MASK;
      const float f = value<T>(b);
      if (f > m || (isnan(f) && !isnan(m))) {
        m = f;
        best = b;
      }
    }
    out[word] |= best << shift;
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

// x (N, 2H, 2W, C), y (N, H, W, C); cv = C / L units a pixel, total =
// N H W cv units (below 2^30, so u never wraps)
template <typename T>
__global__ void __launch_bounds__(THREADS) pool_kernel(const T* __restrict__ x, T* __restrict__ y,
                                                       int W, int cv, uint32_t total) {
  constexpr int L = 16 / sizeof(T);
  const uint32_t stride = gridDim.x * THREADS;
  const size_t C = (size_t)cv * L, rs = 2 * (size_t)W * C;   // x's pixel and row, in T
#pragma unroll 1
  for (uint32_t base = blockIdx.x * THREADS + threadIdx.x; base < total; base += UNITS * stride) {
    uint4 v[UNITS][4];
#pragma unroll
    for (int k = 0; k < UNITS; ++k) {
      const uint32_t u = base + k * stride;
      if (u < total) {
        const uint32_t q = u % cv, opix = u / cv, xo = opix % W, row = opix / W;   // row = n H + i
        const T* p = x + ((size_t)4 * row * W + 2 * xo) * C + q * L;   // x[n, 2i, 2j]
        v[k][0] = ld_stream(p);
        v[k][1] = ld_stream(p + C);
        v[k][2] = ld_stream(p + rs);
        v[k][3] = ld_stream(p + rs + C);
      }
    }
#pragma unroll
    for (int k = 0; k < UNITS; ++k) {
      const uint32_t u = base + k * stride;
      if (u < total) *reinterpret_cast<uint4*>(y + (size_t)u * L) = window_max<T>(v[k]);
    }
  }
}

// One launch: x (N, 2H, 2W, C) -> y (N, H, W, C), both 16-byte aligned.
template <typename T>
cudaError_t launch_pool_fwd(const void* x, void* y, int N, int H, int W, int C, cudaStream_t s) {
  constexpr int L = 16 / sizeof(T);
  if (N < 1 || H < 1 || W < 1 || C < L || C % L) return cudaErrorInvalidValue;
  const size_t total = (size_t)N * H * W * (C / L);
  if (total >= (1u << 30)) return cudaErrorInvalidValue;   // 80 GiB of x and y: past the card
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pool_kernel<T>, THREADS, 0);
  if (err != cudaSuccess) return err;
  const size_t wave = (size_t)sms * (per_sm > 0 ? per_sm : 1);
  const int grid = (int)std::min(wave, (total + THREADS - 1) / THREADS);
  pool_kernel<T><<<grid, THREADS, 0, s>>>(static_cast<const T*>(x), static_cast<T*>(y), W, C / L,
                                          (uint32_t)total);
  return cudaGetLastError();
}

}  // namespace
}  // namespace pool
