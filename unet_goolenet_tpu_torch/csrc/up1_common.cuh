// Shared pieces of the up1 kernels (up1_gate.cu, up1_tail.cu).
//
// Layout: activations are dense NHWC with C = 64 channels, element type T =
// float or __nv_bfloat16. Inside a block every activation tile lives in
// shared memory in Traits<T>::S (float for float, bf16 for bf16),
// pixel-major, one pixel every Traits<T>::PITCH elements; the bf16 pitch is
// padded to 72 so that the tensor-core fragment loads below hit distinct
// banks.
//
// Conv<T, R> accumulates a convolution over an R-pixel output region:
//   * T = float: float32 FMA. A warp's 32 lanes own the 64 output channels
//     (lane l: channels 2l, 2l+1) for the pixels p = warp + 8j; every lane
//     reads the same input pixel (a shared-memory broadcast) and its own two
//     weight columns. Weights ([tap][ci][co] in global memory) are staged one
//     tap at a time as float [ci][co].
//   * T = bf16: tensor cores, mma.sync.m16n8k16 bf16 with float32
//     accumulators. A warp owns 16-pixel M tiles (pixels 16m .. 16m+15 of the
//     region) times all 64 output channels (8 N tiles of 8); A fragments are
//     read straight from the bf16 tile, each row at its own pixel offset.
//     Weights ([tap][co][ci] in global memory) are staged for all taps at once
//     with 16-byte copies into rows padded to 72.
// visit(f) calls f(p, co, v0, v1) for every output pixel p < R and channel
// pair (co, co+1) the thread owns.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace up1 {

constexpr int C = 64;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

template <typename T> struct Traits;
template <> struct Traits<float> {
  using S = float;                     // shared-memory element type
  static constexpr int PITCH = C;      // elements per pixel in shared memory
  static constexpr int WS = C * C;     // weight staging: one tap, [ci][co]
};
template <> struct Traits<__nv_bfloat16> {
  using S = __nv_bfloat16;
  static constexpr int PITCH = C + 8;
  static constexpr int WPITCH = C + 8;       // elements per staged weight row
  static constexpr int WS = 9 * C * WPITCH;  // weight staging: 9 taps, [tap][co][ci]
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// round to T's precision, keep computing in float
template <typename T> __device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

// four consecutive elements as float4 (16-byte aligned for float, 8 for bf16)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 a, b;
  memcpy(&a, &u.x, 4);
  memcpy(&b, &u.y, 4);
  const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
  return make_float4(fa.x, fa.y, fb.x, fb.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y), b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  memcpy(&u.x, &a, 4);
  memcpy(&u.y, &b, 4);
  *reinterpret_cast<uint2*>(p) = u;
}

// two consecutive channels
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T, int R> struct Conv;

// ---------------------------------------------------------------- float32 FMA
template <int R> struct Conv<float, R> {
  static constexpr int PX = (R + WARPS - 1) / WARPS;
  static constexpr int PITCH = Traits<float>::PITCH;
  float acc[PX][2];

  __device__ Conv() {
#pragma unroll
    for (int j = 0; j < PX; ++j) acc[j][0] = acc[j][1] = 0.f;
  }

  // acc += conv3x3 over the region (out_cols wide) reading src at
  // (r + dr + ky, c + dc + kx); wg is [9][cin_total][64], ci_off selects a
  // 64-channel slab. Synchronises the block around each weight staging.
  __device__ void run(const float* src, int src_cols, int out_cols, int dr, int dc,
                      const float* wg, int cin_total, int ci_off, float* ws) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int off[PX];
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      const int p = warp + WARPS * j;
      off[j] = p < R ? ((p / out_cols) * src_cols + p % out_cols) * PITCH : 0;
    }
    for (int t = 0; t < 9; ++t) {
      __syncthreads();
      const float* wt = wg + ((size_t)t * cin_total + ci_off) * C;
      for (int i = threadIdx.x * 4; i < C * C; i += THREADS * 4)
        *reinterpret_cast<float4*>(ws + i) = *reinterpret_cast<const float4*>(wt + i);
      __syncthreads();
      const float* s = src + ((dr + t / 3) * src_cols + dc + t % 3) * PITCH;
      const float* w = ws + 2 * lane;
#pragma unroll 2
      for (int ci = 0; ci < C; ci += 4) {
        const float2 w0 = *reinterpret_cast<const float2*>(w + (ci + 0) * C);
        const float2 w1 = *reinterpret_cast<const float2*>(w + (ci + 1) * C);
        const float2 w2 = *reinterpret_cast<const float2*>(w + (ci + 2) * C);
        const float2 w3 = *reinterpret_cast<const float2*>(w + (ci + 3) * C);
#pragma unroll
        for (int j = 0; j < PX; ++j) {
          const float4 v = *reinterpret_cast<const float4*>(s + off[j] + ci);
          float a0 = acc[j][0], a1 = acc[j][1];
          a0 = fmaf(v.x, w0.x, a0); a1 = fmaf(v.x, w0.y, a1);
          a0 = fmaf(v.y, w1.x, a0); a1 = fmaf(v.y, w1.y, a1);
          a0 = fmaf(v.z, w2.x, a0); a1 = fmaf(v.z, w2.y, a1);
          a0 = fmaf(v.w, w3.x, a0); a1 = fmaf(v.w, w3.y, a1);
          acc[j][0] = a0; acc[j][1] = a1;
        }
      }
    }
  }

  template <class F> __device__ void visit(F&& f) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      const int p = warp + WARPS * j;
      if (p < R) f(p, 2 * lane, acc[j][0], acc[j][1]);
    }
  }
};

// ---------------------------------------------------------------- bf16 MMA
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Stage ntaps 64 x 64 weight blocks (global [tap][co][ci_total], 64-channel
// slab at ci_off) into ws as [tap][co][WPITCH], 16 bytes per copy.
__device__ __forceinline__ void stage_taps(__nv_bfloat16* ws, const __nv_bfloat16* wg, int ntaps,
                                           int cin_total, int ci_off) {
  constexpr int WPITCH = Traits<__nv_bfloat16>::WPITCH;
  for (int i = threadIdx.x; i < ntaps * C * (C / 8); i += THREADS) {
    const int row = i / (C / 8), ch = i % (C / 8);   // row = tap * C + co
    *reinterpret_cast<uint4*>(ws + row * WPITCH + ch * 8) =
        *reinterpret_cast<const uint4*>(wg + (size_t)row * cin_total + ci_off + ch * 8);
  }
}

template <int R> struct Conv<__nv_bfloat16, R> {
  using bf16 = __nv_bfloat16;
  static constexpr int MTILES = (R + 15) / 16;
  static constexpr int MT = (MTILES + WARPS - 1) / WARPS;   // M tiles per warp
  static constexpr int PITCH = Traits<bf16>::PITCH;
  static constexpr int WPITCH = Traits<bf16>::WPITCH;
  float acc[MT][8][4];

  __device__ Conv() {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int n = 0; n < 8; ++n) acc[i][n][0] = acc[i][n][1] = acc[i][n][2] = acc[i][n][3] = 0.f;
  }

  // off[i][h]: shared-memory offset of the thread's A row h (pixel
  // 16m + g + 8h of the warp's i-th M tile) as f(p); 0 past the region
  template <class F> __device__ void rows(int (&off)[MT][2], F&& f) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = (warp + WARPS * i) * 16 + (lane >> 2) + 8 * h;
        off[i][h] = p < R ? f(p) : 0;
      }
  }

  // acc += A x W for one staged 64 x 64 tap wt ([co][WPITCH]); A's rows are
  // the 64 channels at s + off
  __device__ void mma_tap(const bf16* s, const int (&off)[MT][2], const bf16* wt) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    s += 2 * t;
#pragma unroll
    for (int kc = 0; kc < C; kc += 16) {
      uint32_t b[8][2];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const bf16* wr = wt + (n * 8 + g) * WPITCH + kc + 2 * t;
        b[n][0] = ld32(wr);
        b[n][1] = ld32(wr + 8);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (warp + WARPS * i >= MTILES) continue;
        const bf16* s0 = s + off[i][0] + kc;
        const bf16* s1 = s + off[i][1] + kc;
        const uint32_t a0 = ld32(s0), a1 = ld32(s1), a2 = ld32(s0 + 8), a3 = ld32(s1 + 8);
#pragma unroll
        for (int n = 0; n < 8; ++n) mma_bf16(acc[i][n], a0, a1, a2, a3, b[n][0], b[n][1]);
      }
    }
  }

  // 3x3 conv as in Conv<float>::run; wg is [9][64][cin_total] and all nine
  // taps are staged at once (ws holds Traits<bf16>::WS elements)
  __device__ void run(const bf16* src, int src_cols, int out_cols, int dr, int dc,
                      const bf16* wg, int cin_total, int ci_off, bf16* ws) {
    int off[MT][2];
    rows(off, [&](int p) { return ((p / out_cols) * src_cols + p % out_cols) * PITCH; });
    __syncthreads();
    stage_taps(ws, wg, 9, cin_total, ci_off);
    __syncthreads();
    for (int tap = 0; tap < 9; ++tap)
      mma_tap(src + ((dr + tap / 3) * src_cols + dc + tap % 3) * PITCH, off,
              ws + tap * C * WPITCH);
  }

  template <class F> __device__ void visit(F&& f) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int m = warp + WARPS * i;
      if (m >= MTILES) continue;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = m * 16 + g + 8 * h;
          if (p < R) f(p, n * 8 + 2 * t, acc[i][n][2 * h], acc[i][n][2 * h + 1]);
        }
    }
  }
};

}  // namespace up1
