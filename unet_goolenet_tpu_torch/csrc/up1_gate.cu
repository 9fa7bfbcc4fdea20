// up1 gate pass: e1 = relu(conv3x3(x1, w) + b) and the per-image,
// per-channel mean and max of e1 over (H, W).
//
// Replaces: unet_goolenet_tpu/ops/pallas/up1.py:fused_cbn_stats (kernel body
// _cbn_stats_kernel). The TPU kernel carries the running sum/max in its output
// block across a sequential row-tile grid; CUDA blocks run in no order, so
// here each block writes its tile's partial sums and maxes to an
// (N, tiles, C) buffer and a second small kernel (up1_stats_kernel, below)
// reduces them in tile order: deterministic, no float atomics.
//
// Bounds on an H100: a 3x3 64->64 conv at 224^2 is 9*64*64*2 = 73.7 kFLOP
// per pixel against 256 bytes moved (bf16 in + out), about 290 FLOP/byte:
// on the tensor cores' ridge. The bf16 conv runs on mma.sync (Conv<bf16> in
// up1_common.cuh), the float32 one on FMA; the read of x1 and the write of e1
// are each done once, and the statistics are taken from the float32 values
// before e1 is rounded, so the pass never re-reads e1. wgmma/TMA are later
// work.
//
// Design: one 256-thread block per 16x16 output tile of one image. The
// (16+2)^2 x 64 input halo is staged into shared memory (Traits<T>::S) with
// zeros outside the image, so the conv needs no bounds checks. After the conv
// the relu'd float32 tile is written to shared memory (over the halo tile for
// float, over the weight staging for bf16); then each warp writes e1 and
// sums/maxes a fixed set of pixels, and the warps' partials are combined in a
// fixed order.
#include "up1_common.cuh"

namespace up1 {

constexpr int GH = 16, GW = 16;               // output tile
constexpr int GIR = GH + 2, GIC = GW + 2;     // input halo tile
constexpr int YT_PITCH = C + 8;               // float output tile, padded
template <typename T>
constexpr size_t gate_smem() {
  return sizeof(typename Traits<T>::S) * ((size_t)GIR * GIC * Traits<T>::PITCH + Traits<T>::WS) +
         sizeof(float) * 2 * WARPS * C;
}
template <typename T>
constexpr bool yt_fits() {   // the float output tile fits where it is put
  return sizeof(float) * GH * GW * YT_PITCH <=
         sizeof(typename Traits<T>::S) *
             (sizeof(T) == 4 ? (size_t)GIR * GIC * Traits<T>::PITCH : (size_t)Traits<T>::WS);
}
static_assert(yt_fits<float>() && yt_fits<__nv_bfloat16>(), "output tile does not fit");

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
up1_gate_kernel(const T* __restrict__ x, const T* __restrict__ w, const float* __restrict__ b,
                T* __restrict__ e1, float* __restrict__ psum, float* __restrict__ pmax,
                int H, int W, int tiles_x) {
  using S = typename Traits<T>::S;
  constexpr int PITCH = Traits<T>::PITCH;
  extern __shared__ float4 smem4[];
  S* xin = reinterpret_cast<S*>(smem4);
  S* ws = xin + GIR * GIC * PITCH;
  float* red_sum = reinterpret_cast<float*>(ws + Traits<T>::WS);
  float* red_max = red_sum + WARPS * C;
  // the relu'd float output tile, after the conv: over the dead halo tile
  // (float) or the dead weight staging (bf16, whose halo tile is too small)
  float* yt = reinterpret_cast<float*>(sizeof(T) == 4 ? xin : ws);

  const int n = blockIdx.y, tile = blockIdx.x, tiles = gridDim.x;
  const int y0 = (tile / tiles_x) * GH, x0 = (tile % tiles_x) * GW;
  const T* xn = x + (size_t)n * H * W * C;

  for (int i = threadIdx.x; i < GIR * GIC * (C / 4); i += THREADS) {
    const int q = i % (C / 4), pix = i / (C / 4);
    const int Y = y0 - 1 + pix / GIC, X = x0 - 1 + pix % GIC;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (Y >= 0 && Y < H && X >= 0 && X < W) v = load4(xn + ((size_t)Y * W + X) * C + 4 * q);
    store4(xin + pix * PITCH + 4 * q, v);
  }

  Conv<T, GH * GW> conv;
  conv.run(xin, GIC, GW, 0, 0, w, C, 0, ws);
  __syncthreads();   // every warp is done reading xin
  conv.visit([&](int p, int co, float a0, float a1) {
    store2(yt + p * YT_PITCH + co, fmaxf(a0 + b[co], 0.f), fmaxf(a1 + b[co + 1], 0.f));
  });
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, co = 2 * lane;
  // relu output is >= 0 and every tile holds at least one image pixel, so 0
  // is a safe initial max
  float s0 = 0.f, s1 = 0.f, m0 = 0.f, m1 = 0.f;
  for (int p = warp; p < GH * GW; p += WARPS) {
    const int Y = y0 + p / GW, X = x0 + p % GW;
    if (Y < H && X < W) {
      const float2 v = load2(yt + p * YT_PITCH + co);
      store2(e1 + (((size_t)n * H + Y) * W + X) * C + co, v.x, v.y);
      s0 += v.x; s1 += v.y;
      m0 = fmaxf(m0, v.x); m1 = fmaxf(m1, v.y);
    }
  }
  red_sum[warp * C + co] = s0; red_sum[warp * C + co + 1] = s1;
  red_max[warp * C + co] = m0; red_max[warp * C + co + 1] = m1;
  __syncthreads();
  if (threadIdx.x < C) {
    float s = 0.f, m = 0.f;
    for (int k = 0; k < WARPS; ++k) {
      s += red_sum[k * C + threadIdx.x];
      m = fmaxf(m, red_max[k * C + threadIdx.x]);
    }
    const size_t o = ((size_t)n * tiles + tile) * C + threadIdx.x;
    psum[o] = s;
    pmax[o] = m;
  }
}

// second pass: reduce the (N, tiles, C) partials in tile order
__global__ void up1_stats_kernel(const float* __restrict__ psum, const float* __restrict__ pmax,
                                 float* __restrict__ mean, float* __restrict__ mx, int tiles,
                                 float hw) {
  const int n = blockIdx.x, c = threadIdx.x;
  float s = 0.f, m = 0.f;
  for (int t = 0; t < tiles; ++t) {
    s += psum[((size_t)n * tiles + t) * C + c];
    m = fmaxf(m, pmax[((size_t)n * tiles + t) * C + c]);
  }
  mean[n * C + c] = s / hw;
  mx[n * C + c] = m;
}

template <typename T>
static cudaError_t launch_gate(const void* x, const void* w, const float* b, void* e1,
                               float* psum, float* pmax, float* mean, float* mx, int N, int H,
                               int W, cudaStream_t stream) {
  const int tiles_x = (W + GW - 1) / GW, tiles = tiles_x * ((H + GH - 1) / GH);
  constexpr size_t smem = gate_smem<T>();
  cudaError_t err = cudaFuncSetAttribute(up1_gate_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  up1_gate_kernel<T><<<dim3(tiles, N), THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), b, static_cast<T*>(e1), psum, pmax,
      H, W, tiles_x);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  up1_stats_kernel<<<N, C, 0, stream>>>(psum, pmax, mean, mx, tiles, (float)H * (float)W);
  return cudaGetLastError();
}

}  // namespace up1

extern "C" int up1_gate_tiles(int H, int W) {
  return ((W + up1::GW - 1) / up1::GW) * ((H + up1::GH - 1) / up1::GH);
}

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success).
extern "C" int up1_gate_launch(int dtype, const void* x, const void* w, const float* b, void* e1,
                               float* psum, float* pmax, float* mean, float* mx, int N, int H,
                               int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return up1::launch_gate<float>(x, w, b, e1, psum, pmax, mean, mx, N, H, W, s);
  if (dtype == 1)
    return up1::launch_gate<__nv_bfloat16>(x, w, b, e1, psum, pmax, mean, mx, N, H, W, s);
  return (int)cudaErrorInvalidValue;
}
