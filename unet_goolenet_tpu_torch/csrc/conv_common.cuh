// The convolution machinery under dense_conv.cuh's float32 conv_kernel (the
// float32 pool + down1, gate pass, decoder level and 3x3 conv of down1.cu,
// gate.cu, up_level.cu and conv.cu), and what the other kernels share: the
// element conversions and loads, mma_bf16 (conv_dw.cuh's mma.sync) and the
// cp.async copies.
//
// Layout: activations are dense NHWC with C = 64 channels a slab. Inside a
// block every activation tile lives in shared memory as float, pixel-major,
// one pixel every Traits<float>::PITCH elements.
//
// Conv<float, R> accumulates a convolution over an R-pixel output region on
// float32 FMA. A warp's 32 lanes own the 64 output channels (lane l:
// channels 2l, 2l+1) for the pixels p = warp + 8j; every lane reads the same
// input pixel (a shared-memory broadcast) and its own two weight columns.
// Weights ([tap][ci][co] in global memory) are staged one tap at a time as
// float [ci][co].
// visit(f) calls f(p, co, v0, v1) for every output pixel p < R and channel
// pair (co, co+1) the thread owns.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace common {

constexpr int C = 64;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

template <typename T> struct Traits;
template <> struct Traits<float> {
  using S = float;                     // shared-memory element type
  static constexpr int PITCH = C;      // elements per pixel in shared memory
  static constexpr int WS = C * C;     // weight staging: one tap, [ci][co]
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

  // acc += convKxK over the region (out_cols wide) reading src at
  // (r + ky, c + kx); wg is [K*K][cin_total][64], ci_off selects a 64-channel
  // slab. Synchronises the block around each weight staging.
  template <int K = 3>
  __device__ void run(const float* src, int src_cols, int out_cols, const float* wg,
                      int cin_total, int ci_off, float* ws) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int off[PX];
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      const int p = warp + WARPS * j;
      off[j] = p < R ? ((p / out_cols) * src_cols + p % out_cols) * PITCH : 0;
    }
    for (int t = 0; t < K * K; ++t) {
      __syncthreads();
      const float* wt = wg + ((size_t)t * cin_total + ci_off) * C;
      for (int i = threadIdx.x * 4; i < C * C; i += THREADS * 4)
        *reinterpret_cast<float4*>(ws + i) = *reinterpret_cast<const float4*>(wt + i);
      __syncthreads();
      const float* s = src + ((t / K) * src_cols + t % K) * PITCH;
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

// ---------------------------------------------------------------- shared pieces
// conv_dw.cuh's bf16 product: d += A B, one m16n8k16 tile, float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy that does not pass through registers; with
// valid = false it writes 16 zero bytes and reads nothing. Complete with
// cp_async_wait_all() and a barrier before the data is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace common
