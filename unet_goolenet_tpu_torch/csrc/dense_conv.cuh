// One implicit-GEMM convolution kernel for the gate passes, the dense
// decoder and encoder levels and the training convolutions (gate.cu,
// up_level.cu, down1.cu, conv.cu), where channel counts run from 3 to 1024
// and neither the weights nor an intermediate of a whole level fit in a
// block's shared memory.
//
// conv_kernel<T, K, SRC, MODE> computes, for one 8x16-pixel output tile of
// one image and one block of 64 output channels (grid: tiles x cout/64 x N),
//     acc = sum over 64-channel input slabs of convKxK(slab, w) (pad K/2)
// and then an epilogue chosen by MODE:
//     RELU    out = relu(acc + b)
//     STATS   out = relu(acc + b), plus the tile's per-channel sum and max
//             of the float32 values before rounding (the gate pass)
//     GATE    d2 = round(relu(acc + b)); out = e1 + round(g1p * d2)
//     DECONV  (K = 1) out[2y+di, 2x+dj] = acc + b: the 2x2/s2 transposed
//             conv as a 1x1 conv with 4*cout outputs ordered (di, dj, co)
//     HEAD    (cout = 64) y = round(relu(acc + b)); out = y @ wout + bout:
//             a 1x1 head with ncls outputs, so that only the logits reach
//             device memory
//     AFFINE  out = acc * scale + b, then relu if a.relu: the fused conv +
//             BatchNorm epilogue of conv.cu
// Every stored value is rounded to T, as the TPU kernels round them; the
// arithmetic is float32.
//
// Input slabs (SRC): DENSE reads channel ci < c0 from src0 (c0 channels per
// pixel) and the rest from src1, so a conv over concat[up, gated] reads both
// tensors without a concatenated copy (the split sum of the pair conv). c0
// need not be a multiple of 64 when src1 is absent (the UNet's first conv
// has 3 input channels): the slab beyond c0 stages as zeros, and the weights
// carry cin = c0 rounded up to 64 with zero rows there. POOL reads src0 at
// twice the output size and stages the 2x2 max of each pixel; positions
// outside the image stage as exact zeros, so the kernel needs no sign
// assumption on its input.
//
// Per slab the (8+K-1) x (16+K-1) x 64 input halo is staged into shared
// memory with zeros outside the image (16-byte cp.async copies, or through
// registers for POOL and a ragged slab), then Conv<T, 128> (conv_common.cuh)
// accumulates: bf16 on mma.sync.m16n8k16 with ldmatrix fragments and all K*K
// taps of the 64 x 64 weight block staged at once, float32 on FMA one tap at
// a time. The epilogue goes through a float32 tile in shared memory (over the
// dead halo tile for float, over the dead weight staging for bf16), so that
// each warp writes whole 64-channel pixel rows. Weights arrive per output
// block, [block][tap][64 co][cin] for bf16 and [block][tap][cin][64 co] for
// float. Shared memory: 110 KB (bf16) / 65 KB (float).
#pragma once

#include "conv_common.cuh"

namespace dense {
namespace {

using namespace common;

constexpr int TH = 8, TW = 16, TR = TH * TW;   // output tile
constexpr int YT_PITCH = C + 8;                // float epilogue tile, padded
enum Mode { RELU = 0, STATS = 1, GATE = 2, DECONV = 3, HEAD = 4, AFFINE = 5 };
enum Src { DENSE = 0, POOL = 1 };

struct ConvArgs {
  const void* src0;
  const void* src1;
  int c0, cin;           // channels from src0, channels in all
  const void* w;
  const float* b;
  void* out;
  int cout;              // output channels (DECONV: of the upsampled map)
  int H, W, tiles_x;     // output size (DECONV: input size); tiles per row
  const void* e1;        // GATE: (N, H, W, cout)
  const void* g1p;       // GATE: (N, cout), 1 + gate
  float* psum;           // STATS: (N, tiles, cout) per-tile partials
  float* pmax;
  const void* wout;      // HEAD: (64, ncls) [channel][class]
  const float* bout;     // HEAD: (ncls,)
  int ncls;
  const float* scale;    // AFFINE: (cout,)
  int relu;              // AFFINE: 1 = relu after the affine epilogue
};

template <typename T>
constexpr size_t conv_smem() {
  return sizeof(typename Traits<T>::S) *
             ((size_t)(TH + 2) * (TW + 2) * Traits<T>::PITCH + Traits<T>::WS) +
         sizeof(float) * 2 * WARPS * C;
}
template <typename T>
constexpr bool tile_fits() {   // the float epilogue tile fits where it is put
  return sizeof(float) * TR * YT_PITCH <=
         sizeof(typename Traits<T>::S) *
             (sizeof(T) == 4 ? (size_t)(TH + 2) * (TW + 2) * Traits<T>::PITCH
                             : (size_t)Traits<T>::WS);
}
static_assert(tile_fits<float>() && tile_fits<__nv_bfloat16>(), "epilogue tile does not fit");

__device__ __forceinline__ float4 max4(float4 a, float4 b) {
  return make_float4(fmaxf(a.x, b.x), fmaxf(a.y, b.y), fmaxf(a.z, b.z), fmaxf(a.w, b.w));
}

// Stage rows x cols pixels x 64 channels of src (cs channels per pixel, the
// slab from channel cofs) at image position (y0, x0) into xin, with zeros
// outside the H x W image and beyond the source's channels: 16-byte cp.async
// copies for a whole slab, through registers for a ragged one.
template <typename T>
__device__ __forceinline__ void stage_slab(typename Traits<T>::S* xin, const T* src, int n,
                                           int y0, int x0, int rows, int cols, int H, int W,
                                           int cs, int cofs) {
  constexpr int PITCH = Traits<T>::PITCH, V = 16 / sizeof(T);
  const int valid = cs - cofs;   // channels of the slab the source holds
  if (valid >= C && cs % V == 0) {
    for (int i = threadIdx.x; i < rows * cols * (C / V); i += blockDim.x) {
      const int q = i % (C / V), pix = i / (C / V);
      const int Y = y0 + pix / cols, X = x0 + pix % cols;
      const bool in = Y >= 0 && Y < H && X >= 0 && X < W;
      cp_async16(xin + pix * PITCH + V * q,
                 in ? src + (((size_t)n * H + Y) * W + X) * cs + cofs + V * q : src, in);
    }
    cp_async_wait_all();   // the caller's barrier publishes the tile
    return;
  }
  for (int i = threadIdx.x; i < rows * cols * C; i += blockDim.x) {
    const int q = i % C, pix = i / C;
    const int Y = y0 + pix / cols, X = x0 + pix % cols;
    float v = 0.f;
    if (q < valid && Y >= 0 && Y < H && X >= 0 && X < W)
      v = to_f(src[(((size_t)n * H + Y) * W + X) * cs + cofs + q]);
    xin[pix * PITCH + q] = from_f<T>(v);
  }
}

template <typename T, int K, int SRC, int MODE>
__global__ void __launch_bounds__(THREADS, 1) conv_kernel(const ConvArgs a) {
  using S = typename Traits<T>::S;
  constexpr int PITCH = Traits<T>::PITCH;
  constexpr int HALO = K / 2, IR = TH + 2 * HALO, IC = TW + 2 * HALO;
  extern __shared__ float4 smem4[];
  S* xin = reinterpret_cast<S*>(smem4);
  S* ws = xin + (TH + 2) * (TW + 2) * PITCH;
  float* red_sum = reinterpret_cast<float*>(ws + Traits<T>::WS);
  float* red_max = red_sum + WARPS * C;
  float* yt = reinterpret_cast<float*>(sizeof(T) == 4 ? (void*)xin : (void*)ws);

  const int tile = blockIdx.x, nb = blockIdx.y, n = blockIdx.z;
  const int H = a.H, W = a.W;
  const int y0 = (tile / a.tiles_x) * TH, x0 = (tile % a.tiles_x) * TW;
  const T* wblk = static_cast<const T*>(a.w) + (size_t)nb * K * K * C * a.cin;

  Conv<T, TR> conv;
  for (int ci0 = 0; ci0 < a.cin; ci0 += C) {
    const bool first = ci0 < a.c0;
    const T* src = static_cast<const T*>(first ? a.src0 : a.src1);
    const int cs = first ? a.c0 : a.cin - a.c0;   // channels per source pixel
    const int cofs = first ? ci0 : ci0 - a.c0;    // slab offset in the source
    __syncthreads();   // every warp is done reading the previous slab
    if constexpr (SRC == POOL) {
      for (int i = threadIdx.x; i < IR * IC * (C / 4); i += THREADS) {
        const int q = i % (C / 4), pix = i / (C / 4);
        const int Y = y0 - HALO + pix / IC, X = x0 - HALO + pix % IC;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (Y >= 0 && Y < H && X >= 0 && X < W) {
          const size_t rs = (size_t)2 * W * cs;
          const T* p = src + ((size_t)n * 2 * H + 2 * Y) * rs + (size_t)2 * X * cs + cofs + 4 * q;
          v = max4(max4(load4(p), load4(p + cs)), max4(load4(p + rs), load4(p + rs + cs)));
        }
        store4(xin + pix * PITCH + 4 * q, v);
      }
    } else {
      stage_slab<T>(xin, src, n, y0 - HALO, x0 - HALO, IR, IC, H, W, cs, cofs);
    }
    conv.template run<K>(xin, IC, TW, wblk, a.cin, ci0, ws);
  }
  __syncthreads();   // every warp is done with xin and ws

  const int ncb = a.cout / C;   // DECONV: output blocks per parity
  const float* bias = a.b + (MODE == DECONV ? nb % ncb : nb) * C;
  conv.visit([&](int p, int co, float v0, float v1) {
    if constexpr (MODE == AFFINE) {
      v0 *= a.scale[nb * C + co];
      v1 *= a.scale[nb * C + co + 1];
    }
    yt[p * YT_PITCH + co] = v0 + bias[co];
    yt[p * YT_PITCH + co + 1] = v1 + bias[co + 1];
  });
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, co = 2 * lane;
  const int cg = (MODE == DECONV ? nb % ncb : nb) * C + co;   // output channel
  T* out = static_cast<T*>(a.out);
  float s0 = 0.f, s1 = 0.f, m0 = 0.f, m1 = 0.f;   // relu output >= 0
  for (int p = warp; p < TR; p += WARPS) {
    const int Y = y0 + p / TW, X = x0 + p % TW;
    if (Y >= H || X >= W) continue;
    float v0 = yt[p * YT_PITCH + co], v1 = yt[p * YT_PITCH + co + 1];
    size_t o;
    if constexpr (MODE == DECONV) {
      const int par = nb / ncb;
      o = ((size_t)n * 2 * H + 2 * Y + (par >> 1)) * 2 * W + 2 * X + (par & 1);
    } else {
      o = ((size_t)n * H + Y) * W + X;
      if (MODE != AFFINE || a.relu) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
    }
    if constexpr (MODE == HEAD) {   // p is warp-uniform: the shuffles see every lane
      const T* wo = static_cast<const T*>(a.wout);
      v0 = rnd<T>(v0);
      v1 = rnd<T>(v1);
      for (int k = 0; k < a.ncls; ++k) {
        float s = v0 * to_f(wo[co * a.ncls + k]) + v1 * to_f(wo[(co + 1) * a.ncls + k]);
#pragma unroll
        for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
        if (lane == 0) out[o * a.ncls + k] = from_f<T>(s + a.bout[k]);
      }
      continue;
    }
    if constexpr (MODE == GATE) {
      const float2 e = load2(static_cast<const T*>(a.e1) + o * a.cout + cg);
      const float2 g = load2(static_cast<const T*>(a.g1p) + (size_t)n * a.cout + cg);
      v0 = e.x + rnd<T>(g.x * rnd<T>(v0));
      v1 = e.y + rnd<T>(g.y * rnd<T>(v1));
    }
    store2(out + o * a.cout + cg, v0, v1);
    if constexpr (MODE == STATS) {
      s0 += v0; s1 += v1;
      m0 = fmaxf(m0, v0); m1 = fmaxf(m1, v1);
    }
  }
  if constexpr (MODE == STATS) {
    red_sum[warp * C + co] = s0; red_sum[warp * C + co + 1] = s1;
    red_max[warp * C + co] = m0; red_max[warp * C + co + 1] = m1;
    __syncthreads();
    if (threadIdx.x < C) {
      float s = 0.f, m = 0.f;
      for (int k = 0; k < WARPS; ++k) {
        s += red_sum[k * C + threadIdx.x];
        m = fmaxf(m, red_max[k * C + threadIdx.x]);
      }
      const size_t o = ((size_t)n * gridDim.x + tile) * a.cout + nb * C + threadIdx.x;
      a.psum[o] = s;
      a.pmax[o] = m;
    }
  }
}

inline int tiles_x(int W) { return (W + TW - 1) / TW; }
inline int tiles(int H, int W) { return tiles_x(W) * ((H + TH - 1) / TH); }

// one launch of conv_kernel over N images and nblocks output blocks
template <typename T, int K, int SRC, int MODE>
cudaError_t launch(ConvArgs a, int N, int nblocks, cudaStream_t stream) {
  // a ragged c0 only as the sole source, with cin = c0 rounded up to 64
  const bool ragged_ok = SRC == DENSE && a.src1 == nullptr && a.cin == (a.c0 + C - 1) / C * C;
  if (a.cin % C || a.cout % C || (a.c0 % C && !ragged_ok)) return cudaErrorInvalidValue;
  a.tiles_x = tiles_x(a.W);
  constexpr size_t smem = conv_smem<T>();
  cudaError_t err = cudaFuncSetAttribute(conv_kernel<T, K, SRC, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  conv_kernel<T, K, SRC, MODE><<<dim3(tiles(a.H, a.W), nblocks, N), THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dense
