// The weight gradient of a KxK stride-1 convolution (pad K/2) as a split-K
// reduction over pixels, for conv.cu (K = 3: the fused conv3x3's dw) and
// deconv.cu (K = 1 over the four output parities: the 2x2/s2 transposed
// conv's dW and db):
//     part[chunk, tap, ci, co] = sum over the chunk's pixels p of
//                                x_pad[p + tap, ci] * g[p, co]
//     dw[tap, ci, co]          = sum over chunks, in chunk order
// x is (N, H, W, cx); g is (N, H, W, cout), or with GD2S the (N, 2H, 2W,
// cout/4) output gradient of the transposed conv read as (N, H, W, cout)
// with columns ordered (di, dj, c) (the inverse depth-to-space).
//
// Why split-K and not one block per output: the reduction runs over N*H*W,
// 200,704 pixels at 224^2 and batch 4, while dw has as few as 9 x 64 x 64
// values (one block's worth). Each block owns a chunk of 8x16 pixel tiles, a
// 64-channel slab of x and 64 columns of g, accumulates in registers over its
// tiles in order and writes float32 partials; a second kernel sums the
// partials in chunk order. Deterministic, no float atomics, as the gate
// statistics (gate.cu). The host picks the chunk count so that the grid
// fills the card about twice.
//
// Per tile the x halo (8+K-1) x (16+K-1) x 64 and the g tile 8 x 16 x 64 are
// staged into shared memory with zeros outside the image (and beyond x's
// channels, for the UNet's 3-channel input), then:
//   * bf16: mma.sync.m16n8k16 with float32 accumulators, M = 16 input
//     channels, N = 8 output channels, K = the 16 pixels of one tile row.
//     Both operands lie pixel-major in shared memory, so their fragments come
//     from ldmatrix.trans. Work unit = (tap, 16-channel m tile, half of the
//     64 columns); 12 warps take K*K*8 units (6 each at K = 3).
//   * float32: FMA. Work unit = (tap, 16 input channels); lane l owns
//     columns 2l, 2l+1; each pixel's g pair is read once and x values are
//     shared-memory broadcasts.
// With gsum, the blocks of slab 0 also sum their g columns (the deconv's db)
// into per-chunk partials. Shared memory: 44 KB (bf16) / 77 KB (float).
#pragma once

#include "dense_conv.cuh"

namespace wgrad {
namespace {

using namespace common;
using dense::TH;
using dense::TR;
using dense::TW;

constexpr int DW_WARPS = 12, DW_THREADS = DW_WARPS * 32;

struct DwArgs {
  const void* x;
  int cx, cin;            // channels of x per pixel; cx rounded up to 64
  const void* g;
  int cg, cout;           // channels of g per pixel; columns of dw (cg, or 4 cg with GD2S)
  int H, W, tiles_x, tiles;   // x's size; tiles per row, per image
  int items, per_chunk;   // N * tiles tiles in all; tiles per chunk
  float* part;            // (chunks, K*K, cin, cout)
  float* gsum;            // (chunks, cout) or null
};

template <typename T, int K>
constexpr size_t dw_smem() {
  return sizeof(typename Traits<T>::S) * Traits<T>::PITCH *
         ((size_t)(TH + K - 1) * (TW + K - 1) + TR);
}

// four 8x8 bf16 matrices, transposed on load (see DwAcc<bf16>)
__device__ __forceinline__ void ldsm_x4_t(uint32_t& r0, uint32_t& r1, uint32_t& r2, uint32_t& r3,
                                          const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_addr(p)));
}

template <typename T, int K> struct DwAcc;

template <int K> struct DwAcc<float, K> {
  static constexpr int IC = TW + K - 1, PITCH = Traits<float>::PITCH;
  static constexpr int UNITS = K * K * 4;   // (tap, 16 input channels)
  static constexpr int UPW = (UNITS + DW_WARPS - 1) / DW_WARPS;
  float acc[UPW][16][2];

  __device__ DwAcc() {
#pragma unroll
    for (int u = 0; u < UPW; ++u)
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[u][j][0] = acc[u][j][1] = 0.f;
  }

  __device__ void run(const float* xin, const float* gs) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int p = 0; p < TR; ++p) {
      const int r = p / TW, c = p % TW;
      const float2 g2 = *reinterpret_cast<const float2*>(gs + p * PITCH + 2 * lane);
#pragma unroll
      for (int u = 0; u < UPW; ++u) {
        const int unit = warp + DW_WARPS * u;
        if (unit >= UNITS) break;   // warp-uniform
        const int tap = unit / 4, grp = unit % 4;
        const float* xp = xin + ((r + tap / K) * IC + c + tap % K) * PITCH + grp * 16;
#pragma unroll
        for (int j = 0; j < 16; j += 4) {
          const float4 v = *reinterpret_cast<const float4*>(xp + j);
          acc[u][j][0] = fmaf(v.x, g2.x, acc[u][j][0]);
          acc[u][j][1] = fmaf(v.x, g2.y, acc[u][j][1]);
          acc[u][j + 1][0] = fmaf(v.y, g2.x, acc[u][j + 1][0]);
          acc[u][j + 1][1] = fmaf(v.y, g2.y, acc[u][j + 1][1]);
          acc[u][j + 2][0] = fmaf(v.z, g2.x, acc[u][j + 2][0]);
          acc[u][j + 2][1] = fmaf(v.z, g2.y, acc[u][j + 2][1]);
          acc[u][j + 3][0] = fmaf(v.w, g2.x, acc[u][j + 3][0]);
          acc[u][j + 3][1] = fmaf(v.w, g2.y, acc[u][j + 3][1]);
        }
      }
    }
  }

  // part: this chunk's (K*K, cin, cout) partials
  __device__ void store(float* part, int cin, int cout, int slab, int nb) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int u = 0; u < UPW; ++u) {
      const int unit = warp + DW_WARPS * u;
      if (unit >= UNITS) break;
      const int tap = unit / 4, ci0 = slab * C + (unit % 4) * 16, co = nb * C + 2 * lane;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<float2*>(part + ((size_t)tap * cin + ci0 + j) * cout + co) =
            make_float2(acc[u][j][0], acc[u][j][1]);
    }
  }
};

template <int K> struct DwAcc<__nv_bfloat16, K> {
  using bf16 = __nv_bfloat16;
  static constexpr int IC = TW + K - 1, PITCH = Traits<bf16>::PITCH;
  static constexpr int UNITS = K * K * 8;   // (tap, m tile of 16 channels, half of the columns)
  static constexpr int UPW = (UNITS + DW_WARPS - 1) / DW_WARPS;
  float acc[UPW][4][4];

  __device__ DwAcc() {
#pragma unroll
    for (int u = 0; u < UPW; ++u)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[u][j][0] = acc[u][j][1] = acc[u][j][2] = acc[u][j][3] = 0.f;
  }

  // One k step is one tile row (16 pixels). A (m = input channel, k =
  // pixel) and B (k = pixel, n = column) both lie [pixel][channel] in shared
  // memory: ldmatrix.trans reads 8 pixel rows of 8 channels each and hands
  // out the transposed fragment. A's matrices are (m 0-7 | 8-15) x (k 0-7 |
  // 8-15); B's are (n tile j | j+1) x (k 0-7 | 8-15).
  __device__ void run(const bf16* xin, const bf16* gs) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int qb = lane >> 3, kb = (lane & 7) + 8 * (qb & 1), nofs = 8 * (qb >> 1);
    const int ka = (lane & 7) + 8 * (lane >> 4), mofs = 8 * ((lane >> 3) & 1);
    for (int r = 0; r < TH; ++r) {
      uint32_t b[8][2];
      const bf16* gp = gs + (r * TW + kb) * PITCH + nofs;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ldsm_x4_t(b[2 * j][0], b[2 * j][1], b[2 * j + 1][0], b[2 * j + 1][1], gp + 16 * j);
#pragma unroll
      for (int u = 0; u < UPW; ++u) {
        const int unit = warp + DW_WARPS * u;
        if (unit >= UNITS) break;   // warp-uniform
        const int tap = unit / 8, mt = (unit / 2) % 4, half = unit % 2;
        uint32_t a0, a1, a2, a3;
        ldsm_x4_t(a0, a1, a2, a3,
                  xin + ((r + tap / K) * IC + ka + tap % K) * PITCH + mt * 16 + mofs);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[u][j], a0, a1, a2, a3, b[half * 4 + j][0], b[half * 4 + j][1]);
      }
    }
  }

  __device__ void store(float* part, int cin, int cout, int slab, int nb) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int u = 0; u < UPW; ++u) {
      const int unit = warp + DW_WARPS * u;
      if (unit >= UNITS) break;
      const int tap = unit / 8, mt = (unit / 2) % 4, half = unit % 2;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ci = slab * C + mt * 16 + g + 8 * h;
          const int co = nb * C + (half * 4 + j) * 8 + 2 * t;
          *reinterpret_cast<float2*>(part + ((size_t)tap * cin + ci) * cout + co) =
              make_float2(acc[u][j][2 * h], acc[u][j][2 * h + 1]);
        }
    }
  }
};

// grid: (chunks, cout / 64, cin / 64)
template <typename T, int K, bool GD2S>
__global__ void __launch_bounds__(DW_THREADS, 1) dw_kernel(const DwArgs a) {
  using S = typename Traits<T>::S;
  constexpr int PITCH = Traits<T>::PITCH, HALO = K / 2;
  constexpr int IR = TH + 2 * HALO, IC = TW + 2 * HALO, V = 16 / sizeof(T);
  extern __shared__ float4 smem4[];
  S* xin = reinterpret_cast<S*>(smem4);
  S* gs = xin + IR * IC * PITCH;

  const int chunk = blockIdx.x, nb = blockIdx.y, slab = blockIdx.z;
  const int col0 = nb * C;                                   // first column
  const int par = GD2S ? col0 / a.cg : 0;                    // its output parity
  const int gofs = GD2S ? col0 % a.cg : col0;                // its channel in g
  const T* x = static_cast<const T*>(a.x);
  const T* g = static_cast<const T*>(a.g);
  const int H = a.H, W = a.W;

  DwAcc<T, K> acc;
  float gsum = 0.f;
  const int i1 = min(a.items, (chunk + 1) * a.per_chunk);
  for (int it = chunk * a.per_chunk; it < i1; ++it) {
    const int n = it / a.tiles, tile = it % a.tiles;
    const int y0 = (tile / a.tiles_x) * TH, x0 = (tile % a.tiles_x) * TW;
    __syncthreads();   // every warp is done with the previous tile
    dense::stage_slab<T>(xin, x, n, y0 - HALO, x0 - HALO, IR, IC, H, W, a.cx, slab * C);
    if constexpr (GD2S) {
      for (int i = threadIdx.x; i < TR * (C / V); i += DW_THREADS) {
        const int q = i % (C / V), pix = i / (C / V);
        const int Y = y0 + pix / TW, X = x0 + pix % TW;
        const bool in = Y < H && X < W;
        const size_t o = ((size_t)n * 2 * H + 2 * Y + (par >> 1)) * 2 * W + 2 * X + (par & 1);
        cp_async16(gs + pix * PITCH + V * q, in ? g + o * a.cg + gofs + V * q : g, in);
      }
      cp_async_wait_all();
    } else {
      dense::stage_slab<T>(gs, g, n, y0, x0, TH, TW, H, W, a.cg, gofs);
    }
    __syncthreads();
    acc.run(xin, gs);
    if (a.gsum && slab == 0 && threadIdx.x < C)
      for (int p = 0; p < TR; ++p) gsum += to_f(gs[p * PITCH + threadIdx.x]);
  }
  acc.store(a.part + (size_t)chunk * K * K * a.cin * a.cout, a.cin, a.cout, slab, nb);
  if (a.gsum && slab == 0 && threadIdx.x < C) a.gsum[(size_t)chunk * a.cout + col0 + threadIdx.x] = gsum;
}

// dw = the partials summed in chunk order, for ci < cin_valid, written as
// torch lays the weight out: layout 0, a conv's (cout, cin, K, K); layout 1,
// a transposed conv's (cin, cout/4, 2, 2) from columns ordered (di, dj, c).
__global__ void dw_reduce_kernel(const float* __restrict__ part, int chunks, int taps, int cin,
                                 int cin_valid, int cout, int layout, float* __restrict__ dw) {
  const size_t total = (size_t)taps * cin_valid * cout;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const int co = e % cout, ci = (e / cout) % cin_valid, tap = e / ((size_t)cout * cin_valid);
    float s = 0.f;
    for (int c = 0; c < chunks; ++c) s += part[(((size_t)c * taps + tap) * cin + ci) * cout + co];
    if (layout == 0) {
      dw[((size_t)co * cin_valid + ci) * taps + tap] = s;
    } else {
      const int cg = cout / 4, par = co / cg, c = co % cg;
      dw[((size_t)ci * cg + c) * 4 + par] = s;
    }
  }
}

// db[c] = sum over parities, then chunks in order, of the column sums
__global__ void db_reduce_kernel(const float* __restrict__ gsum, int chunks, int cg,
                                 float* __restrict__ db) {
  for (int c = threadIdx.x; c < cg; c += blockDim.x) {
    float s = 0.f;
    for (int par = 0; par < 4; ++par)
      for (int k = 0; k < chunks; ++k) s += gsum[(size_t)k * 4 * cg + par * cg + c];
    db[c] = s;
  }
}

inline int reduce_blocks(size_t total) {
  const size_t b = (total + 255) / 256;
  return (int)(b < 4096 ? b : 4096);
}

// the dw kernel over x (N, H, W, cx) and g, then the chunk-order reduce into
// dw (and db with GD2S); part (chunks, K*K, cin, cout) and gsum (chunks,
// cout) are scratch
template <typename T, int K, bool GD2S>
cudaError_t launch_dw(const void* x, const void* g, float* part, float* gsum, float* dw,
                      float* db, int N, int H, int W, int cx, int cg, int chunks,
                      int per_chunk, cudaStream_t s) {
  DwArgs a{};
  a.x = x; a.cx = cx; a.cin = (cx + C - 1) / C * C;
  a.g = g; a.cg = cg; a.cout = GD2S ? 4 * cg : cg;
  a.H = H; a.W = W; a.tiles_x = dense::tiles_x(W); a.tiles = dense::tiles(H, W);
  a.items = N * a.tiles; a.per_chunk = per_chunk; a.part = part; a.gsum = GD2S ? gsum : nullptr;
  if (cg % C || chunks < 1 || (size_t)chunks * per_chunk < (size_t)a.items) return cudaErrorInvalidValue;
  constexpr size_t smem = dw_smem<T, K>();
  cudaError_t err = cudaFuncSetAttribute(dw_kernel<T, K, GD2S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dw_kernel<T, K, GD2S><<<dim3(chunks, a.cout / C, a.cin / C), DW_THREADS, smem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = (size_t)K * K * cx * a.cout;
  dw_reduce_kernel<<<reduce_blocks(total), 256, 0, s>>>(part, chunks, K * K, a.cin, cx, a.cout,
                                                        GD2S ? 1 : 0, dw);
  err = cudaGetLastError();
  if (err != cudaSuccess || !GD2S) return err;
  db_reduce_kernel<<<1, 256, 0, s>>>(gsum, chunks, cg, db);
  return cudaGetLastError();
}

}  // namespace
}  // namespace wgrad
