// up1 level + 1x1 head in one kernel: only the logits reach device memory.
//
// Replaces: unet_goolenet_tpu/ops/pallas/up1.py:fused_up1_outc (kernel body
// _up1_kernel). Per output tile of TH x TW pixels:
//     up     = convT2x2(y) + b_up                 rows/cols [-3, +3] around the tile
//     d2     = relu(conv3x3(up) + b_d2)           [-2, +2]
//     gated  = e1 + (1 + gate) * d2               [-2, +2]
//     h      = relu(conv3x3(concat[up, gated]) + b_pair)   [-1, +1]
//     y1     = relu(conv3x3(h) + b_blk1)          the tile
//     logits = y1 @ w_outc + b_outc
// up, gated and h live in shared memory, rounded to the input dtype between
// stages as the TPU kernel rounds them. Every stage writes
// exact zeros at positions outside the image (rows AND columns, since the
// tile is 2-D), which is the zero padding the next conv expects.
//
// Bounds on an H100: the level does ~4 3x3 convs' worth of work per output
// pixel (d2, the 128-channel pair conv, blk1) plus the deconv, ~300 kFLOP per
// pixel, against ~6.5 bytes read per pixel of logits in bf16 (y, e1) and the
// logits themselves: compute-bound by a wide margin. What the fusion removes
// is device-memory traffic: up, d2, gated and h (each N x 224 x 224 x 64)
// never leave the SM. In bf16 the 3x3 convs and the deconv (as four
// per-parity GEMMs) run on the tensor cores (mma.sync, Conv<bf16> in
// up1_common.cuh), with each conv's nine weight taps staged at once; in
// float32 they run on FMA, one tap staged at a time. The 1x1 head is FMA in
// both. The halo recompute costs ~1.6x the tile's own conv work at 8 x 16
// tiles. wgmma/TMA and larger tiles are later work.
//
// Shared memory: up (14 x 22 px), gated (12 x 20), h (10 x 18) at
// Traits<T>::PITCH elements of Traits<T>::S per pixel, plus the weight
// staging: 198 KB (float) / 183 KB (bf16), one block per SM. The y source
// tile for the deconv borrows the gated buffer, and the block1 output
// borrows the up buffer.
#include "up1_common.cuh"

namespace up1 {

constexpr int TH = 8, TW = 16;                 // output tile
constexpr int UR = TH + 6, UC = TW + 6;        // up tile, origin (y0-3, x0-3)
constexpr int GR = TH + 4, GC = TW + 4;        // d2 / gated tile, origin (y0-2, x0-2)
constexpr int HR = TH + 2, HC = TW + 2;        // h tile, origin (y0-1, x0-1)
constexpr int YR = UR / 2 + 1, YC = UC / 2 + 1;  // deconv source tile, origin (y0/2-2, x0/2-2)
template <typename T>
constexpr size_t tail_smem() {
  return sizeof(typename Traits<T>::S) *
         ((size_t)(UR * UC + GR * GC + HR * HC) * Traits<T>::PITCH + Traits<T>::WS);
}
static_assert(YR * YC <= GR * GC, "deconv source tile must fit in the gated buffer");
static_assert(TH * TW <= UR * UC, "block1 output must fit in the up buffer");
static_assert(TH % 2 == 0 && TW % 2 == 0, "tile origins must be even for the deconv");

__device__ __forceinline__ bool inside(int Y, int X, int H, int W) {
  return Y >= 0 && Y < H && X >= 0 && X < W;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
up1_tail_kernel(const T* __restrict__ y, const T* __restrict__ e1, const T* __restrict__ g1p,
                const T* __restrict__ wup, const float* __restrict__ bup,
                const T* __restrict__ wd2, const float* __restrict__ bd2,
                const T* __restrict__ wpair, const float* __restrict__ bpair,
                const T* __restrict__ wblk1, const float* __restrict__ bblk1,
                const T* __restrict__ wout, const float* __restrict__ bout,
                T* __restrict__ out, int H, int W, int ncls, int tiles_x) {
  using S = typename Traits<T>::S;
  constexpr int PITCH = Traits<T>::PITCH;
  extern __shared__ float4 smem4[];
  S* up = reinterpret_cast<S*>(smem4);
  S* gt = up + UR * UC * PITCH;
  S* hh = gt + GR * GC * PITCH;
  S* ws = hh + HR * HC * PITCH;
  S* ys = gt;   // deconv source, dead before gated is written
  S* yb = up;   // block1 output, written after the last read of up

  const int n = blockIdx.y, tile = blockIdx.x;
  const int y0 = (tile / tiles_x) * TH, x0 = (tile % tiles_x) * TW;
  const int H2 = H / 2, W2 = W / 2;
  const int ry0 = y0 / 2 - 2, rx0 = x0 / 2 - 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, co = 2 * lane;

  // ---- deconv source tile, zeros outside the input
  const T* yn = y + (size_t)n * H2 * W2 * C;
  for (int i = threadIdx.x; i < YR * YC * (C / 4); i += THREADS) {
    const int q = i % (C / 4), pix = i / (C / 4);
    const int Y = ry0 + pix / YC, X = rx0 + pix % YC;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (inside(Y, X, H2, W2)) v = load4(yn + ((size_t)Y * W2 + X) * C + 4 * q);
    store4(ys + pix * PITCH + 4 * q, v);
  }

  // ---- up = convT2x2(y) + b_up: pixel (Y, X) = y[Y/2, X/2] @ wup[parity]
  if constexpr (sizeof(T) == 2) {
    // per parity (di, dj) a GEMM over the 7 x 11 up pixels of that parity,
    // whose A rows are their source pixels in ys; wup is [parity][co][ci]
    __syncthreads();
    stage_taps(ws, wup, 4, C, 0);
    __syncthreads();
    for (int par = 0; par < 4; ++par) {
      const int r0 = ((par >> 1) + 1) & 1, c0 = ((par & 1) + 1) & 1;   // Y = y0-3+r is even iff r odd
      Conv<T, (UR / 2) * (UC / 2)> conv;
      int off[decltype(conv)::MT][2];
      conv.rows(off, [&](int q) {
        const int r = r0 + 2 * (q / (UC / 2)), c = c0 + 2 * (q % (UC / 2));
        return (((r - 3) >> 1) + 2) * YC * PITCH + (((c - 3) >> 1) + 2) * PITCH;
      });
      conv.mma_tap(ys, off, ws + par * C * Traits<T>::WPITCH);
      conv.visit([&](int q, int c, float a0, float a1) {
        const int r = r0 + 2 * (q / (UC / 2)), cc = c0 + 2 * (q % (UC / 2));
        const bool in = inside(y0 - 3 + r, x0 - 3 + cc, H, W);
        store2(up + (r * UC + cc) * PITCH + c, in ? rnd<T>(a0 + bup[c]) : 0.f,
               in ? rnd<T>(a1 + bup[c + 1]) : 0.f);
      });
    }
  } else {
    const float b0 = bup[co], b1 = bup[co + 1];
    for (int par = 0; par < 4; ++par) {
      __syncthreads();
      for (int i = threadIdx.x * 4; i < C * C; i += THREADS * 4)
        store4(ws + i, load4(wup + (size_t)par * C * C + i));
      __syncthreads();
      const float* w = ws + co;
      for (int p = warp; p < UR * UC; p += WARPS) {
        const int Y = y0 - 3 + p / UC, X = x0 - 3 + p % UC;
        if ((((Y & 1) << 1) | (X & 1)) != par) continue;
        float a0 = 0.f, a1 = 0.f;
        if (inside(Y, X, H, W)) {
          const float* s = ys + (((Y >> 1) - ry0) * YC + (X >> 1) - rx0) * PITCH;
#pragma unroll 4
          for (int ci = 0; ci < C; ci += 4) {
            const float4 v = *reinterpret_cast<const float4*>(s + ci);
            const float2 w0 = *reinterpret_cast<const float2*>(w + (ci + 0) * C);
            const float2 w1 = *reinterpret_cast<const float2*>(w + (ci + 1) * C);
            const float2 w2 = *reinterpret_cast<const float2*>(w + (ci + 2) * C);
            const float2 w3 = *reinterpret_cast<const float2*>(w + (ci + 3) * C);
            a0 = fmaf(v.x, w0.x, a0); a1 = fmaf(v.x, w0.y, a1);
            a0 = fmaf(v.y, w1.x, a0); a1 = fmaf(v.y, w1.y, a1);
            a0 = fmaf(v.z, w2.x, a0); a1 = fmaf(v.z, w2.y, a1);
            a0 = fmaf(v.w, w3.x, a0); a1 = fmaf(v.w, w3.y, a1);
          }
          a0 = rnd<T>(a0 + b0);
          a1 = rnd<T>(a1 + b1);
        }
        store2(up + p * PITCH + co, a0, a1);
      }
    }
  }

  // ---- d2 = relu(conv3x3(up) + b_d2); gated = e1 + (1 + gate) * d2
  {
    Conv<T, GR * GC> conv;
    conv.run(up, UC, GC, 0, 0, wd2, C, 0, ws);
    const T* en = e1 + (size_t)n * H * W * C;
    conv.visit([&](int p, int c, float a0, float a1) {
      const int Y = y0 - 2 + p / GC, X = x0 - 2 + p % GC;
      float v0 = 0.f, v1 = 0.f;
      if (inside(Y, X, H, W)) {
        const float d0 = rnd<T>(fmaxf(a0 + bd2[c], 0.f));
        const float d1 = rnd<T>(fmaxf(a1 + bd2[c + 1], 0.f));
        const float2 e = load2(en + ((size_t)Y * W + X) * C + c);
        const float2 g = load2(g1p + (size_t)n * C + c);
        v0 = rnd<T>(e.x + rnd<T>(g.x * d0));
        v1 = rnd<T>(e.y + rnd<T>(g.y * d1));
      }
      store2(gt + p * PITCH + c, v0, v1);
    });
  }

  // ---- h = relu(conv3x3(up, Wa) + conv3x3(gated, Wb) + b_pair)
  {
    Conv<T, HR * HC> conv;
    conv.run(up, UC, HC, 1, 1, wpair, 2 * C, 0, ws);
    conv.run(gt, GC, HC, 0, 0, wpair, 2 * C, C, ws);
    conv.visit([&](int p, int c, float a0, float a1) {
      const int Y = y0 - 1 + p / HC, X = x0 - 1 + p % HC;
      const bool in = inside(Y, X, H, W);
      store2(hh + p * PITCH + c, in ? rnd<T>(fmaxf(a0 + bpair[c], 0.f)) : 0.f,
             in ? rnd<T>(fmaxf(a1 + bpair[c + 1], 0.f)) : 0.f);
    });
  }

  // ---- y1 = relu(conv3x3(h) + b_blk1) into the (dead) up buffer
  {
    Conv<T, TH * TW> conv;
    conv.run(hh, HC, TW, 0, 0, wblk1, C, 0, ws);
    conv.visit([&](int p, int c, float a0, float a1) {
      store2(yb + p * PITCH + c, rnd<T>(fmaxf(a0 + bblk1[c], 0.f)),
             rnd<T>(fmaxf(a1 + bblk1[c + 1], 0.f)));
    });
  }
  __syncthreads();

  // ---- logits = y1 @ w_outc + b_outc (channel order rotated per pixel to
  // spread shared-memory banks)
  for (int i = threadIdx.x; i < TH * TW * ncls; i += THREADS) {
    const int p = i / ncls, k = i % ncls;
    const int Y = y0 + p / TW, X = x0 + p % TW;
    if (!inside(Y, X, H, W)) continue;
    float s = 0.f;
    for (int cc = 0; cc < C; ++cc) {
      const int c = (cc + p) & (C - 1);
      s = fmaf(to_f(yb[p * PITCH + c]), to_f(wout[c * ncls + k]), s);
    }
    out[(((size_t)n * H + Y) * W + X) * ncls + k] = from_f<T>(s + bout[k]);
  }
}

template <typename T>
static cudaError_t launch_tail(const void* y, const void* e1, const void* g1p, const void* wup,
                               const float* bup, const void* wd2, const float* bd2,
                               const void* wpair, const float* bpair, const void* wblk1,
                               const float* bblk1, const void* wout, const float* bout, void* out,
                               int N, int H, int W, int ncls, cudaStream_t stream) {
  const int tiles_x = (W + TW - 1) / TW, tiles = tiles_x * ((H + TH - 1) / TH);
  constexpr size_t smem = tail_smem<T>();
  cudaError_t err = cudaFuncSetAttribute(up1_tail_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  up1_tail_kernel<T><<<dim3(tiles, N), THREADS, smem, stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(e1), static_cast<const T*>(g1p),
      static_cast<const T*>(wup), bup, static_cast<const T*>(wd2), bd2,
      static_cast<const T*>(wpair), bpair, static_cast<const T*>(wblk1), bblk1,
      static_cast<const T*>(wout), bout, static_cast<T*>(out), H, W, ncls, tiles_x);
  return cudaGetLastError();
}

}  // namespace up1

// dtype: 0 = float32, 1 = bfloat16. H, W: output (= 2x input) size.
// Returns a cudaError_t (0 on success).
extern "C" int up1_tail_launch(int dtype, const void* y, const void* e1, const void* g1p,
                               const void* wup, const float* bup, const void* wd2,
                               const float* bd2, const void* wpair, const float* bpair,
                               const void* wblk1, const float* bblk1, const void* wout,
                               const float* bout, void* out, int N, int H, int W, int ncls,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return up1::launch_tail<float>(y, e1, g1p, wup, bup, wd2, bd2, wpair, bpair, wblk1, bblk1,
                                   wout, bout, out, N, H, W, ncls, s);
  if (dtype == 1)
    return up1::launch_tail<__nv_bfloat16>(y, e1, g1p, wup, bup, wd2, bd2, wpair, bpair, wblk1,
                                           bblk1, wout, bout, out, N, H, W, ncls, s);
  return (int)cudaErrorInvalidValue;
}
