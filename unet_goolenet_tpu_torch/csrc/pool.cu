// 2x2 / stride-2 max pool and its backward:
//     y[n, i, j, c]  = max of x[n, 2i+di, 2j+dj, c] over (di, dj)
//     dx             = dy routed to the first maximum of each window in
//                      (r0c0, r0c1, r1c0, r1c1) order, zeros elsewhere
// NaN counts as the maximum, and ties go to the first, as in torch's
// max_pool2d and its backward.
//
// Replaces: unet_goolenet_tpu/ops/pallas/conv.py:max_pool2x2_pallas (forward
// _pool_kernel; its backward _pool_bwd is plain jnp with the same
// first-maximum rule, here a kernel too).
//
// One thread per output pixel and 4 channels (16-byte float / 8-byte bf16
// loads of each window row), grid-stride; H and W of x even, C a multiple of
// 4. Bound on an H100: memory, x read and y written once (1.25 x |x|), or
// x and dy read and dx written (2.25 x |x|): at 224^2 x 64 and batch 4 in
// bf16, ~0.010 and ~0.018 ms.
#include <math.h>

#include "conv_common.cuh"

namespace {

using namespace common;

__device__ __forceinline__ void comps(float4 v, float (&f)[4]) {
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}

// the window's 4 x 4 values of the thread's pixel; returns false past the end
template <typename T>
__device__ __forceinline__ const T* window(const T* x, size_t i, int H, int W, int C,
                                           size_t& opix, int& q) {
  q = i % (C / 4);
  opix = i / (C / 4);                     // output pixel, (n * H + y) * W + x
  const size_t xo = opix % W, yo = (opix / W) % H, n = opix / ((size_t)W * H);
  return x + ((n * 2 * H + 2 * yo) * 2 * W + 2 * xo) * C + 4 * q;
}

// index of the first maximum of v[0..3] (NaN wins, as in torch)
__device__ __forceinline__ int first_max(const float (&v)[4]) {
  int k = 0;
  for (int j = 1; j < 4; ++j)
    if (v[j] > v[k] || (isnan(v[j]) && !isnan(v[k]))) k = j;
  return k;
}

template <typename T>
__global__ void pool_kernel(const T* __restrict__ x, T* __restrict__ y, int N, int H, int W,
                            int C) {
  const size_t total = (size_t)N * H * W * (C / 4);
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    size_t opix;
    int q;
    const T* p = window(x, i, H, W, C, opix, q);
    const size_t rs = (size_t)2 * W * C;
    float v[4][4], o[4];
    comps(load4(p), v[0]); comps(load4(p + C), v[1]);
    comps(load4(p + rs), v[2]); comps(load4(p + rs + C), v[3]);
    for (int c = 0; c < 4; ++c) {
      const float w4[4] = {v[0][c], v[1][c], v[2][c], v[3][c]};
      o[c] = w4[first_max(w4)];
    }
    store4(y + opix * C + 4 * q, make_float4(o[0], o[1], o[2], o[3]));
  }
}

template <typename T>
__global__ void pool_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gy,
                                T* __restrict__ gx, int N, int H, int W, int C) {
  const size_t total = (size_t)N * H * W * (C / 4);
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    size_t opix;
    int q;
    const T* p = window(x, i, H, W, C, opix, q);
    const size_t rs = (size_t)2 * W * C, base = p - x;
    float v[4][4], g[4], out[4][4];
    comps(load4(p), v[0]); comps(load4(p + C), v[1]);
    comps(load4(p + rs), v[2]); comps(load4(p + rs + C), v[3]);
    comps(load4(gy + opix * C + 4 * q), g);
    for (int c = 0; c < 4; ++c) {
      const float w4[4] = {v[0][c], v[1][c], v[2][c], v[3][c]};
      const int k = first_max(w4);
      for (int j = 0; j < 4; ++j) out[j][c] = j == k ? g[c] : 0.f;
    }
    const size_t offs[4] = {0, (size_t)C, rs, rs + C};
    for (int j = 0; j < 4; ++j)
      store4(gx + base + offs[j], make_float4(out[j][0], out[j][1], out[j][2], out[j][3]));
  }
}

int grid_for(size_t total) {
  const size_t b = (total + 255) / 256;
  return (int)(b < 8192 ? b : 8192);
}

template <typename T>
cudaError_t launch_pool(const void* x, const void* gy, void* out, int N, int H, int W, int C,
                        bool bwd, cudaStream_t s) {
  if (C % 4) return cudaErrorInvalidValue;
  const int blocks = grid_for((size_t)N * H * W * (C / 4));
  if (bwd)
    pool_bwd_kernel<T><<<blocks, 256, 0, s>>>(static_cast<const T*>(x), static_cast<const T*>(gy),
                                              static_cast<T*>(out), N, H, W, C);
  else
    pool_kernel<T><<<blocks, 256, 0, s>>>(static_cast<const T*>(x), static_cast<T*>(out), N, H,
                                          W, C);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. H, W: the output size; x (N, 2H, 2W,
// C), y (N, H, W, C). Returns a cudaError_t (0 on success).
extern "C" int pool_launch(int dtype, const void* x, void* y, int N, int H, int W, int C,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_pool<float>(x, nullptr, y, N, H, W, C, false, s);
  if (dtype == 1) return launch_pool<__nv_bfloat16>(x, nullptr, y, N, H, W, C, false, s);
  return (int)cudaErrorInvalidValue;
}

// gx (N, 2H, 2W, C) of x (N, 2H, 2W, C) and gy (N, H, W, C).
extern "C" int pool_bwd_launch(int dtype, const void* x, const void* gy, void* gx, int N, int H,
                               int W, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_pool<float>(x, gy, gx, N, H, W, C, true, s);
  if (dtype == 1) return launch_pool<__nv_bfloat16>(x, gy, gx, N, H, W, C, true, s);
  return (int)cudaErrorInvalidValue;
}
