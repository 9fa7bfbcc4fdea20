// The bf16 3x3 convolution (pad 1) of the trainer, forward and input
// gradient, as one implicit GEMM for Hopper:
//     forward  y  = [relu](conv3x3_p1(x, w) * scale + bias)
//     dx       dx = conv3x3_p1(gc, w flipped and io-transposed)
// with float32 accumulation and each output rounded once to bf16; scale and
// bias may be null (1 and 0).
//
// Replaces: unet_goolenet_tpu/ops/pallas/conv.py:fused_conv3x3 (forward
// _fwd_kernel; its VJP's dx, which runs the same kernel on flipped,
// io-transposed weights) and, two launches with relu, :fused_convstack2
// (_stack2_kernel).
//
// Bound on an H100: 18 cin cout FLOP an output pixel on the bf16 tensor
// cores (989 TFLOP/s) against x, w and y once through memory (3.35 TB/s):
// above the ridge point at every trainer shape, so bound by operations,
// 0.30 ms for the 27 forward convs of a pass at batch 4 and 224^2 (dx the
// same, less the first conv's); chip_smoke.py computes each shape's bound.
//
// conv3x3_gemm<BN, DX, MB, KS>: M = output pixels, N = output channels, K =
// 9 taps x the input channels, in K tiles of one tap of a 64-channel slab.
// Block: two consumer warpgroups (the product, MB blocks of 64 rows each:
// BM = 128 MB GEMM rows a tile), one producer warp (the loads); one block an
// SM, persistent.
//   * A, one halo a slab: the tile's R rows x S pixels of output read the
//     (R + 2) x (S + 2) halo, which is one TMA box of the activations (x, or
//     gc for dx) x 64 channels, 128-byte swizzled, one 128-byte row a pixel.
//     The GEMM's rows are the halo's: row p = r (S + 2) + s, whose two pad
//     columns are discarded outputs (2 of every 16 rows at S = 14), and tap
//     (ky, kx) is the same operand ky (S + 2) + kx rows on, just a start
//     address. The pad, the ragged edge and the channels a 3-channel x lacks
//     (the host pads it to 16) are the box's zero fill. So the nine taps of
//     a slab read its activations once, not nine times (PERF.md §6 says how
//     one shifted box a tap and one box a channel plane compared).
//     The halo ring has 2 stages (ASTAGES): each holds a whole slab, 9 K
//     tiles of lookahead, and a third does not fit beside the 6-stage B ring
//     and the epilogue tile in 227 KB.
//   * B, the weights, laid out once a forward call as (9, cout, cin8) bf16
//     (wk[tap][co][ci], cin8 = cin rounded up to 8, zeros beyond cin;
//     weight_bf16_kernel), which dx reuses: the forward's K tile (tap, 64
//     ci) x BN co is one K-major box, dx's (tap 8 - t, 64 co) x BN ci is
//     BN / 64 MN-major boxes of the same tensor, so the flip and the
//     io-transpose are in the addressing. One box a K tile into a ring of 6.
//     (Reading torch's float32 w in place instead, through registers, makes
//     each tap's K tile a stride-9 gather; PERF.md §6 says why the layout
//     was kept.)
//   * The pipeline: the producer warp waits for a stage's "empty" mbarrier
//     and issues its boxes, completing on its "full" one; each consumer
//     warpgroup keeps one wgmma group in flight and releases a stage when
//     the group after it is issued and the group itself done. 64-column
//     tiles are 256 rows (MB = 2), so that each weight tile feeds twice the
//     pixels; a 16-channel input runs one k step a K tile (KS = 1), not 4.
//   * Tiles and the split of K come from ops/kernels/conv.py:conv_plan (plain
//     Python the CPU tests reach): the M tile fitted to the level's width,
//     the N tile (128, or 64 where the columns do not divide by 128) and,
//     where the tiles leave SMs idle (the 14^2 and 28^2 levels), K split
//     into whole slabs over the `splits` blocks of a thread-block cluster,
//     summed in distributed shared memory in rank order (deterministic: two
//     calls give the same bits). A cluster walks tiles cid, cid + clusters,
//     ..., so the grid is one wave and the next tile's loads run under this
//     tile's epilogue.
//   * Epilogue: the float32 tile goes through shared memory beside the
//     rings; each thread keeps one 8-channel column, with its scale and bias
//     in registers, applies them and relu to a pixel at a time and stores 16
//     bytes of NHWC (a ragged channel count, dx of the 3-channel input,
//     stores element by element).
//   * Epilogue modes (EPI) for the decoder level of up_level.cu, beside the
//     trainer's AFFINE (the default, which the trainer's instantiations
//     take): GATE, d2 = round(relu(acc + b)), out = e1 + round(g1p * d2),
//     the thread's 8 values of e1 one 16-byte load a pixel and of g1p (1 +
//     gate, per image) in registers a tile; PAIR, AFFINE over two sources:
//     K slabs below c0slabs come from amap, the rest from amap2 at channel
//     (slab - c0slabs) 64, so the pair conv reads concat[up, gated] with no
//     concatenated copy; HEAD (BN = ncols = 64): y = round(relu(acc + b)),
//     logits = y @ wout + bout, a pixel's 64 channels being the 8 threads of
//     one 8-lane group, reduced by shuffles inside the group; the loop runs
//     warp-uniformly and masks the store, so the shuffles never lose a
//     lane at the image edge; wout (64 x ncls bf16) is read through L1;
//     64 input channels are one K slab, so the head never splits K.
//     And for the gate pass of gate.cu, STATS: e1 = round(relu(acc + b)),
//     plus the per-image, per-channel sum and max of the float32 relu(acc +
//     b) before rounding. Each thread sums its column over the pixels it
//     stores (inside the image: never a pad column or a row past it); the
//     threads that share a column reduce by shuffles within a warp, then
//     over the 8 warps through 8 KB of shared memory past the barriers, in
//     a fixed order; one partial a (M tile, rank) goes to psum / pmax (N,
//     rtiles ctiles splits, C), slot (tile in image) splits + rank, written
//     in every call (0 and 0 for a rank with no pixels; relu makes 0 the
//     max's identity), and gate.cu's second launch sums the slots in order.
//     No float atomics: two calls give the same bits.
// Shared memory: 214 KB a block (BN = 128) or 202 KB (BN = 64, MB = 2), in
// every epilogue mode; STATS 8 KB (4 KB) more.
#pragma once

#include <algorithm>

#include "hopper.cuh"

namespace conv3 {
namespace {

using namespace common;
using hop::fence_async_shared;
using hop::mbar_wait;
using hop::pack16;
using hop::sw_desc;
using hop::wgmma_n128;
using hop::wgmma_n64;
using wgrad::mbar_expect;
using wgrad::mbar_init;
using wgrad::tma4;
using bf16 = __nv_bfloat16;

constexpr int BK = 64;        // channels of a slab: a K tile is one tap of a slab
constexpr int CONSUMERS = 256;             // two warpgroups: the product and the epilogue
constexpr int THREADS = CONSUMERS + 32;    // and one producer warp: the loads
constexpr int MAX_SPLIT = 3;  // the most K splits a cluster sums (ops/kernels/conv.py)
constexpr int MAX_HW = 32;    // the widest halo row, S + 2
constexpr int ASTAGES = 2;
constexpr int BSTAGES = 6;
// epilogue modes (EPI); AFFINE is the trainer's
enum { AFFINE = 0, GATE = 1, PAIR = 2, HEAD = 3, STATS = 4 };

// BN columns; GEMM rows BM = 128 MB, each warpgroup MB blocks of 64 (BN =
// 64 takes MB = 2, so that a weight tile serves 256 rows)
template <int BN, int MB> struct Geo {
  static constexpr int BM = 128 * MB;
  // pixel rows (128 bytes: 64 channels) an A stage holds: the halo, and what
  // the discarded rows past it read (row BM - 1 at the last tap), rounded to
  // a whole swizzle period of 8 rows
  static constexpr int AROWS = (BM + 2 * MAX_HW + 2 + 7) / 8 * 8;
  static constexpr int ABYTES = AROWS * 128;
  static constexpr int BBYTES = BN * 128;   // B: 64 k x BN columns
  static constexpr int TP = BN + 8;         // floats a row of the epilogue tile
  static constexpr int TILE = BM * TP * 4;
  static constexpr int CPR = BN / 8;        // 16-byte output chunks a tile row
  // the B ring (1024-byte aligned for its swizzle), the A ring, the tile,
  // then the full and empty barriers of both rings
  static constexpr int AOFF = BSTAGES * BBYTES;
  static constexpr int TOFF = AOFF + ASTAGES * ABYTES;
  static constexpr int BAROFF = TOFF + TILE;
  static constexpr size_t SMEM = (size_t)BAROFF + 16 * (BSTAGES + ASTAGES);
  // STATS only, past the barriers: each consumer warp's column sums, then maxima
  static constexpr int STATS_BYTES = 2 * (CONSUMERS / 32) * BN * 4;
  static_assert(BBYTES % 1024 == 0 && ABYTES % 1024 == 0, "boxes on a 1024-byte swizzle period");
};

struct Args {
  CUtensorMap amap;      // A (C, W, H, N) bf16, boxes of 64 x (S + 2) x (R + 2) x 1
  CUtensorMap bmap;      // wk (cin8, cout, 9, 1) bf16: boxes 64 x BN (forward), 64 x 64 (dx)
  const float* scale;    // (ncols,) or null
  const float* bias;     // (ncols,) or null
  void* out;             // (N, H, W, ncols) bf16; HEAD: (N, H, W, ncls)
  int H, W, ncols, relu;
  int C;                 // A's channels (a multiple of 16; PAIR: each source's)
  int R, S, rtiles, ctiles, mtiles, tiles;
  int slabs, sper, splits, clusters;   // K: slabs of 64 channels, sper a split
  // the decoder level's epilogues (up_level.cu)
  CUtensorMap amap2;     // PAIR: the second source, as amap, K slabs c0slabs on
  int c0slabs;
  const void* e1;        // GATE: (N, H, W, ncols) bf16
  const void* g1p;       // GATE: (N, ncols) bf16, 1 + gate
  const void* wout;      // HEAD: (ncols, ncls) bf16
  const float* bout;     // HEAD: (ncls,)
  int ncls;
  // the gate pass's statistics (STATS): (N, rtiles ctiles splits, ncols)
  float* psum;
  float* pmax;
};

// 8 bf16 at a 16-byte aligned p, as float
__device__ __forceinline__ void unpack16(const bf16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  __nv_bfloat162 h[4];
  memcpy(h, &u, 16);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// Warpgroup g owns GEMM rows 64 (MB g + m) .. + 63 of the tile (m < MB), all
// BN columns, as wgmma fragments (warp w of the group: rows 16w + lane/4 +
// 8h, columns 8j + 2 (lane % 4) + e in register 4j + 2h + e of block m). A K
// tile is KS k steps of 16 channels (4; 1 for a 16-channel input, whose
// other 48 are zeros). Row p is halo pixel p of the
// tile's (S + 2)-wide rows; tap (ky, kx) reads it ky rows and kx pixels on:
// a start address ky (S + 2) + kx rows of 128 bytes on (the 128-byte swizzle
// is a function of the address, so a shifted start reads the rows as TMA
// swizzled them; the descriptor's base offset stays 0). A k step advances A
// and a K-major B (forward) by 32 bytes, an MN-major B (dx) by 16 k rows.
template <int BN, bool DX, int MB, int KS> struct Acc {
  float d[MB][BN / 2];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int m = 0; m < MB; ++m)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) d[m][i] = 0.f;
  }
  // start the K tile's k steps; the first K tile of an output tile (first)
  // overwrites the accumulators
  __device__ __forceinline__ void issue(const unsigned char* as, int shift,
                                        const unsigned char* bs, bool first) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int m = 0; m < MB; ++m) {
      const unsigned char* a0 = as + (shift + ((threadIdx.x >> 7) * MB + m) * 64) * 128;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const uint64_t da = sw_desc(a0 + 32 * ks, 16, 8 * 128);
        const uint64_t db = DX ? sw_desc(bs + 16 * 128 * ks, 64 * 128, 8 * 128)
                               : sw_desc(bs + 32 * ks, 16, 8 * 128);
        const int accumulate = !first || ks > 0;
        if constexpr (BN == 128) wgmma_n128<DX>(d[m], da, db, accumulate);
        else wgmma_n64<DX>(d[m], da, db, accumulate);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  }
  // the K tile before the last one issued is done (its stage may be refilled)
  __device__ __forceinline__ void wait_previous() {
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  }
  __device__ __forceinline__ void finish() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int m = 0; m < MB; ++m)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+f"(d[m][i])::"memory");
  }
  __device__ __forceinline__ void to_tile(float* tile) const {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int m = 0; m < MB; ++m) {
      const int row = 64 * ((threadIdx.x >> 7) * MB + m) + 16 * ((threadIdx.x >> 5) & 3);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(tile + (row + lane / 4 + 8 * h) * Geo<BN, MB>::TP + 8 * j +
                                     2 * (lane & 3)) =
              make_float2(d[m][4 * j + 2 * h], d[m][4 * j + 2 * h + 1]);
    }
  }
};

// the consumers' own barrier (named barrier 1; the producer warp is not in it)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// grid: clusters x splits; block b is rank b % splits of cluster b / splits,
// which takes tiles cid, cid + clusters, ... (tile t: M tile t % mtiles, N
// tile t / mtiles) and slabs rank * sper on of each, all nine taps of a slab.
// Warp 8 loads, lane 0 issuing: each slab's halo (one box) into the A ring,
// each K tile's weights into the B ring, once their stage is empty. Warps
// 0-7 (two warpgroups) drain them with one wgmma group in flight, release
// each stage when its last group is done, and write the tiles.
template <int BN, bool DX, int MB, int KS, int EPI = AFFINE>
__global__ void __launch_bounds__(THREADS, 1) conv3x3_gemm(const __grid_constant__ Args a) {
  static_assert(EPI == AFFINE || !DX, "dx takes the affine epilogue");
  static_assert(EPI != HEAD || BN == 64, "the head takes one 64-column tile a pixel");
  using G = Geo<BN, MB>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const int rank = blockIdx.x % a.splits, cid = blockIdx.x / a.splits;
  const int sl0 = rank * a.sper, scount = min(a.slabs - sl0, a.sper);
  const int ntl = cid < a.tiles ? (a.tiles - 1 - cid) / a.clusters + 1 : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, hw = a.S + 2;
  float* tl = reinterpret_cast<float*>(smem + G::TOFF);
  uint64_t* full_b = reinterpret_cast<uint64_t*>(smem + G::BAROFF);
  uint64_t* empty_b = full_b + BSTAGES;
  uint64_t* full_a = empty_b + BSTAGES;
  uint64_t* empty_a = full_a + ASTAGES;
  auto bstage = [&](int s) { return smem + s * G::BBYTES; };
  auto astage = [&](int s) { return smem + G::AOFF + s * G::ABYTES; };
  namespace cg = cooperative_groups;

  if (threadIdx.x == 0) {
    if (smem_addr(smem) & 1023) __trap();   // the swizzled boxes need 1024-byte alignment
    for (int s = 0; s < BSTAGES; ++s) {
      mbar_init(full_b + s);                          // the producer's expect_tx, then the bytes
      hop::mbar_init_n(empty_b + s, CONSUMERS / 32);  // one arrival a consumer warp
    }
    for (int s = 0; s < ASTAGES; ++s) {
      mbar_init(full_a + s);
      hop::mbar_init_n(empty_a + s, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();   // the barriers are initialised

  if (warp == CONSUMERS / 32) {   // the producer
    // cluster barriers passed: the consumers pass two a tile, so before waiting
    // for a stage that empties in tile v this warp passes those of tiles < v
    int synced = 0;
    auto catch_up = [&](int v) {
      for (; a.splits > 1 && synced < 2 * v; ++synced) cg::this_cluster().sync();
    };
    int ia = 0, ib = 0;   // slabs and K tiles loaded so far
#pragma unroll 1
    for (int u = 0; u < ntl; ++u) {
      const int t = cid + u * a.clusters, mt = t % a.mtiles, nt = t / a.mtiles;
      const int ct = mt % a.ctiles, rt = mt / a.ctiles % a.rtiles, img = mt / a.ctiles / a.rtiles;
#pragma unroll 1
      for (int v = 0; v < scount; ++v, ++ia) {
        const int slab = sl0 + v, sa = ia % ASTAGES;
        if (ia >= ASTAGES) {
          catch_up((ia - ASTAGES) / scount);
          mbar_wait(empty_a + sa, (ia / ASTAGES - 1) & 1);
        }
        if (lane == 0) {   // the slab's halo: (R + 2) x (S + 2) pixels x 64 channels, zeros
          // past the image and past A's channels
          mbar_expect(full_a + sa, (uint32_t)((a.R + 2) * hw * 128));
          if constexpr (EPI == PAIR) {   // slabs from c0slabs on: the second source
            const bool two = slab >= a.c0slabs;
            tma4(astage(sa), two ? &a.amap2 : &a.amap, (two ? slab - a.c0slabs : slab) * BK,
                 ct * a.S - 1, rt * a.R - 1, img, full_a + sa);
          } else {
            tma4(astage(sa), &a.amap, slab * BK, ct * a.S - 1, rt * a.R - 1, img, full_a + sa);
          }
        }
        __syncwarp();
#pragma unroll 1
        for (int tap = 0; tap < 9; ++tap, ++ib) {
          const int sb = ib % BSTAGES;
          if (ib >= BSTAGES) {
            catch_up((ib - BSTAGES) / (9 * scount));
            mbar_wait(empty_b + sb, (ib / BSTAGES - 1) & 1);
          }
          if (lane == 0) {   // the tap's weights: 64 k x BN columns
            mbar_expect(full_b + sb, (uint32_t)G::BBYTES);
            if constexpr (DX) {
#pragma unroll
              for (int q = 0; q < BN / 64; ++q)
                tma4(bstage(sb) + q * 64 * 128, &a.bmap, nt * BN + q * 64, slab * BK, 8 - tap, 0,
                     full_b + sb);
            } else {
              tma4(bstage(sb), &a.bmap, slab * BK, nt * BN, tap, 0, full_b + sb);
            }
          }
          __syncwarp();
        }
      }
    }
    catch_up(ntl);
    return;
  }

  Acc<BN, DX, MB, KS> acc;
  acc.zero();
  int ia = 0, ib = 0;
  bool pending = false;   // the last K tile issued still holds its stages
#pragma unroll 1
  for (int u = 0; u < ntl; ++u) {
#pragma unroll 1
    for (int v = 0; v < scount; ++v, ++ia) {
      const int sa = ia % ASTAGES;
      mbar_wait(full_a + sa, (ia / ASTAGES) & 1);   // the slab's halo has landed
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap, ++ib) {
        const int sb = ib % BSTAGES;
        mbar_wait(full_b + sb, (ib / BSTAGES) & 1);   // the tap's weights have landed
        acc.issue(astage(sa), tap / 3 * hw + tap % 3, bstage(sb), v == 0 && tap == 0);
        acc.wait_previous();
        if (pending && lane == 0) {   // the K tile before is done: its stages are free
          hop::mbar_arrive(empty_b + (ib - 1) % BSTAGES);
          if (tap == 0) hop::mbar_arrive(empty_a + (ia - 1) % ASTAGES);
        }
        pending = true;
      }
    }
    acc.finish();
    if (lane == 0) {
      hop::mbar_arrive(empty_b + (ib - 1) % BSTAGES);
      hop::mbar_arrive(empty_a + (ia - 1) % ASTAGES);
    }
    pending = false;

    // The float32 tile; then each 16-byte chunk of the output is written
    // once: with splits, by one rank of the cluster, summed over the ranks'
    // tiles in rank order. A rank's share is whole tile rows, so that each
    // thread keeps one 8-channel column and its scale and bias.
    acc.to_tile(tl);
    if (a.splits > 1) cg::this_cluster().sync(); else consumers_sync();
    const int t = cid + u * a.clusters, mt = t % a.mtiles, nt = t / a.mtiles;
    const int ct = mt % a.ctiles, rt = mt / a.ctiles % a.rtiles, img = mt / a.ctiles / a.rtiles;
    const int rows = (a.R * a.S + a.splits - 1) / a.splits, p1 = min(a.R * a.S, (rank + 1) * rows);
    const int q = threadIdx.x % G::CPR, col = nt * BN + q * 8, nv = min(8, a.ncols - col);
    float sc[8], bi[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      sc[e] = a.scale && e < nv ? a.scale[col + e] : 1.f;
      bi[e] = a.bias && e < nv ? a.bias[col + e] : 0.f;
    }
    if constexpr (EPI == HEAD) {
      // cq = 64 is one K slab, so one rank. A pixel's 64 channels are 8
      // consecutive lanes (CPR = 8); the loop is uniform over the warp, so
      // that every lane reaches the shuffles: a pixel past the tile or the
      // image reads row 0 and stores nothing.
      const bf16* wo = static_cast<const bf16*>(a.wout) + (size_t)col * a.ncls;
      for (int p0 = 0; p0 < p1; p0 += CONSUMERS / G::CPR) {
        const int po = p0 + threadIdx.x / G::CPR;
        const int ry = po / a.S, sx = po % a.S, r = rt * a.R + ry, x = ct * a.S + sx;
        const bool in = po < p1 && r < a.H && x < a.W;
        const float* tp = tl + (in ? (ry * hw + sx) * G::TP : 0) + q * 8;
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = rnd<bf16>(fmaxf(tp[e] * sc[e] + bi[e], 0.f));
        bf16* dst = static_cast<bf16*>(a.out) + (((size_t)img * a.H + r) * a.W + x) * a.ncls;
        for (int k = 0; k < a.ncls; ++k) {
          float s = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) s = fmaf(v[e], to_f(wo[e * a.ncls + k]), s);
          s += __shfl_xor_sync(0xffffffffu, s, 4);   // inside the pixel's 8-lane group
          s += __shfl_xor_sync(0xffffffffu, s, 2);
          s += __shfl_xor_sync(0xffffffffu, s, 1);
          if (in && k % 8 == q) dst[k] = from_f<bf16>(s + a.bout[k]);
        }
      }
    } else {
      float gp[8];
      if constexpr (EPI == GATE)   // the tile's image's 1 + gate (ncols a multiple of 64)
        unpack16(static_cast<const bf16*>(a.g1p) + (size_t)img * a.ncols + col, gp);
      float ssum[8], smax[8];   // STATS: the column's sum and max over this thread's pixels
      if constexpr (EPI == STATS) {
#pragma unroll
        for (int e = 0; e < 8; ++e) ssum[e] = smax[e] = 0.f;
      }
      for (int po = rank * rows + threadIdx.x / G::CPR; nv > 0 && po < p1;
           po += CONSUMERS / G::CPR) {
        const int ry = po / a.S, sx = po % a.S, r = rt * a.R + ry, x = ct * a.S + sx;
        if (r >= a.H || x >= a.W) continue;
        const int off = (ry * hw + sx) * G::TP + q * 8;
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; e += 4) {
          float4 w[MAX_SPLIT];   // every rank's values in flight at once, then summed in rank order
          if (a.splits == 1) w[0] = *reinterpret_cast<const float4*>(tl + off + e);
#pragma unroll
          for (int z = 0; z < MAX_SPLIT; ++z)
            if (z < a.splits && a.splits > 1)
              w[z] = *reinterpret_cast<const float4*>(
                  cg::this_cluster().map_shared_rank(tl + off + e, z));
          float4 s4 = w[0];
#pragma unroll
          for (int z = 1; z < MAX_SPLIT; ++z)
            if (z < a.splits) { s4.x += w[z].x; s4.y += w[z].y; s4.z += w[z].z; s4.w += w[z].w; }
          v[e] = s4.x; v[e + 1] = s4.y; v[e + 2] = s4.z; v[e + 3] = s4.w;
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          v[e] = v[e] * sc[e] + bi[e];
          if (a.relu) v[e] = fmaxf(v[e], 0.f);
        }
        const size_t o = (((size_t)img * a.H + r) * a.W + x) * a.ncols + col;
        if constexpr (EPI == STATS) {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            ssum[e] += v[e];
            smax[e] = fmaxf(smax[e], v[e]);
          }
        }
        if constexpr (EPI == GATE) {   // v is relu(d2 + b): gated = e1 + round(g1p round(v))
          float e1v[8];
          unpack16(static_cast<const bf16*>(a.e1) + o, e1v);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = e1v[e] + rnd<bf16>(gp[e] * rnd<bf16>(v[e]));
        }
        bf16* dst = static_cast<bf16*>(a.out) + o;
        if (nv == 8 && a.ncols % 8 == 0) {   // 16-byte aligned
          *reinterpret_cast<uint4*>(dst) = pack16<bf16>(v);
        } else {
          for (int e = 0; e < nv; ++e) dst[e] = from_f<bf16>(v[e]);
        }
      }
      if constexpr (EPI == STATS) {
        // the lanes of a warp that share the column (q, q + CPR, ...), then
        // the 8 warps in order: one partial a (tile, rank)
#pragma unroll
        for (int off = G::CPR; off < 32; off *= 2)
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            ssum[e] += __shfl_xor_sync(0xffffffffu, ssum[e], off);
            smax[e] = fmaxf(smax[e], __shfl_xor_sync(0xffffffffu, smax[e], off));
          }
        constexpr int WARPS = CONSUMERS / 32;
        float* st = reinterpret_cast<float*>(smem + G::SMEM);   // [sum, max][warp][BN]
        if (lane < G::CPR) {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            st[warp * BN + q * 8 + e] = ssum[e];
            st[(WARPS + warp) * BN + q * 8 + e] = smax[e];
          }
        }
        consumers_sync();
        const int c = threadIdx.x;
        if (c < BN && nt * BN + c < a.ncols) {
          float s = 0.f, m = 0.f;
#pragma unroll
          for (int w = 0; w < WARPS; ++w) {
            s += st[w * BN + c];
            m = fmaxf(m, st[(WARPS + w) * BN + c]);
          }
          const int per = a.rtiles * a.ctiles;
          const size_t o = ((size_t)img * per * a.splits + (mt % per) * a.splits + rank) * a.ncols +
                           nt * BN + c;
          a.psum[o] = s;
          a.pmax[o] = m;
        }
      }
    }
    // peers read this tile, and the next tile's to_tile overwrites it, after here
    if (a.splits > 1) cg::this_cluster().sync(); else consumers_sync();
  }
}

// wk[tap][co][ci] = bf16(w[co][ci][tap]) for ci < cin, 0 for cin <= ci <
// cin8: thread i = co * cin8 + ci reads w's 9 taps (consecutive threads,
// consecutive 36 bytes) and writes one element of each tap's plane
// (consecutive threads, consecutive elements).
__global__ void weight_bf16_kernel(const float* __restrict__ w, bf16* __restrict__ wk, int cin,
                                   int cin8, int cout) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cout * cin8) return;
  const int co = i / cin8, ci = i % cin8;
  const float* src = w + ((size_t)co * cin + ci) * 9;
  const size_t plane = (size_t)cout * cin8;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
    wk[tap * plane + i] = from_f<bf16>(ci < cin ? __ldg(src + tap) : 0.f);
}

// float32: dense_conv.cuh's blocked layouts, forward wf[co/64][tap][ci][co%64]
// = w[co][ci][tap] (ci < cin64, zeros beyond cin) and dx's wd[ci/64][tap][co]
// [ci%64] = w[co][ci][8 - tap] (zeros for ci >= cin), unless wd is null;
// thread i = ci * cout + co.
__global__ void weight_f32_kernel(const float* __restrict__ w, float* __restrict__ wf,
                                  float* __restrict__ wd, int cin, int cin64, int cout) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cout * cin64) return;
  const int co = i % cout, ci = i / cout;
  const float* src = w + ((size_t)co * cin + ci) * 9;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const float v = ci < cin ? __ldg(src + tap) : 0.f;
    wf[(((size_t)(co / C) * 9 + tap) * cin64 + ci) * C + co % C] = v;
    if (wd) wd[(((size_t)(ci / C) * 9 + 8 - tap) * cout + co) * C + ci % C] = v;
  }
}

// The persistent grid may hold no more clusters than the card runs at once
// (a GPC fits a whole number of them).
template <int BN, bool DX, int MB, int KS, int EPI>
int active_clusters(int splits, size_t smem, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = splits;
  attr.val.clusterDim.y = attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, conv3x3_gemm<BN, DX, MB, KS, EPI>, &cfg) != cudaSuccess)
    return 0;
  return n;
}

// The tiles of a launch over a.ncols columns and a.slabs K slabs of an N x
// a.H x a.W output, from ops/kernels/conv.py:conv_plan (R, S, bn, splits,
// clusters: the persistent grid's, lowered to what the card runs at once
// for a split); false if the plan does not fit the kernel.
inline bool plan_tiles(Args& a, int N, int R, int S, int bn, int splits, int clusters) {
  if (R < 1 || S < 1 || S + 2 > MAX_HW || (bn != 64 && bn != 128) || splits < 1 ||
      splits > MAX_SPLIT || clusters < 1)
    return false;
  a.R = R; a.S = S; a.rtiles = (a.H + R - 1) / R; a.ctiles = (a.W + S - 1) / S;
  a.mtiles = N * a.rtiles * a.ctiles;
  a.tiles = a.mtiles * ((a.ncols + bn - 1) / bn);
  a.splits = splits; a.sper = (a.slabs + splits - 1) / splits;
  a.clusters = std::min(clusters, a.tiles);
  return (splits - 1) * a.sper < a.slabs;
}

// One launch. src: A's activations (N, H, W, C) bf16, C a multiple of 16 (the
// forward's x, dx's gc); src2 (PAIR): the second source, as src; wk (9,
// cout, cin8). The tile: BN columns, 128 MB rows, KS k steps a K tile.
template <int BN, bool DX, int MB, int KS, int EPI = AFFINE>
cudaError_t launch(Args a, const void* src, int N, const void* wk, int cin8, int cout,
                   cudaStream_t s, const void* src2 = nullptr) {
  using G = Geo<BN, MB>;
  const size_t smem = G::SMEM + (EPI == STATS ? G::STATS_BYTES : 0);
  if (a.R * (a.S + 2) > G::BM) return cudaErrorInvalidValue;
  const int C = a.C;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)a.W, (cuuint64_t)a.H, (cuuint64_t)N};
  const cuuint64_t strides[3] = {2ull * C, 2ull * C * a.W, 2ull * C * a.W * a.H};
  const cuuint32_t box[4] = {BK, (cuuint32_t)a.S + 2, (cuuint32_t)a.R + 2, 1};
  if (!wgrad::tensor_map4(&a.amap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, src, dims, strides, box,
                          CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  if (EPI == PAIR && !wgrad::tensor_map4(&a.amap2, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, src2, dims,
                                         strides, box, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  const cuuint64_t wdims[4] = {(cuuint64_t)cin8, (cuuint64_t)cout, 9, 1};
  const cuuint64_t row = 2ull * cin8, wstrides[3] = {row, row * cout, row * cout * 9};
  const cuuint32_t wbox[4] = {BK, DX ? 64u : (cuuint32_t)BN, 1, 1};
  if (!wgrad::tensor_map4(&a.bmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, wk, wdims, wstrides, wbox,
                          CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  auto kernel = conv3x3_gemm<BN, DX, MB, KS, EPI>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  if (a.splits == 1) {
    kernel<<<a.clusters, THREADS, smem, s>>>(a);
    return cudaGetLastError();
  }
  const int fit = active_clusters<BN, DX, MB, KS, EPI>(a.splits, smem, s);
  if (fit < 1) return cudaErrorInvalidConfiguration;
  a.clusters = std::min(a.clusters, fit);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.clusters * a.splits);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = a.splits;
  attr.val.clusterDim.y = attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

}  // namespace
}  // namespace conv3
