// The weight gradient of a KxK stride-1 convolution (pad K/2), for conv.cu
// (K = 3: the fused conv3x3's dw) and deconv.cu (K = 1 over the four output
// parities: the 2x2/s2 transposed conv's dW and db):
//     dw[tap, ci, co] = sum over pixels p of x_pad[p + tap, ci] * g[p, co]
// written as torch lays the weight out: a conv's (cout, cin, 3, 3), a
// transposed conv's (cin, cout, 2, 2) followed by db (cout,). x is (N, H, W,
// cx); g is (N, H, W, cout), or for K = 1 the (N, 2H, 2W, cout) output
// gradient of the transposed conv, read at its four parities. Results are
// float32 from float32 or bf16 inputs.
//
// Replaces: unet_goolenet_tpu/ops/pallas/conv.py:_dw_kernel (the VJP dw of
// fused_conv3x3) and :_deconv_dwdb_kernel (the VJP dW, db of
// conv_transpose2x2_pallas).
//
// Bound on an H100 at the trainer's shapes (batch 4, 224^2; chip_smoke.py
// computes it per shape): the 27 dw calls of a pass are 300 GFLOP, 0.30 ms on
// the bf16 tensor cores (4.5 ms in float32 FMA) against 0.51 GB of x and g,
// 0.15 ms: bound by operations. The four dW/db calls are 6.6 GFLOP against
// 67 MB: bound by bytes, 0.020 ms.
//
// One template, wgrad_kernel<T, K, TW>: a GEMM with M = (tap, input
// channel), N = the columns of g, and the pixels as its reduction dimension,
// one launch a call. What each part does about what held the single-buffered
// kernel back:
//   * Output tiles and items. A block owns 64 input channels (all K*K taps)
//     x 64 columns (K = 3), or x 32 channels at all four parities, 128
//     columns whose dw row is contiguous (K = 1), and walks a chunk of
//     items: pixel tiles with their halo (K = 3), or 64 consecutive pixels
//     (K = 1). The K = 3 tile fits the level's width: bf16 8x16 or 4x32 (a
//     wgmma k step is 16 pixels of one tile row), so the 28-wide levels
//     waste 12.5%, not 23%; float32 8x16, 4x28 or 7x14 (its k steps may span
//     tile rows), none at the 56- and 28-wide levels.
//   * Staging. bf16 K = 3: TMA. Each stage is 16 box copies (8 channel
//     planes of x's halo, 8 of g's tile) that one thread issues and an
//     mbarrier counts in; the boxes' zero fill gives the halo, the ragged
//     edge and the channels a 3-channel x lacks; 4 stages, a stage refilled
//     as soon as its item is done. The tensor maps are encoded on the host
//     through the runtime's driver entry point (no link against the driver).
//     The other paths: a ring of cp.async groups (bf16 K = 1: 4 stages,
//     float32: 2 for K = 3, 3 for K = 1), one barrier a stage, 16-byte
//     copies zero-filled outside the image (the host pads a ragged x to 8
//     channels).
//   * The product. bf16 K = 3: wgmma.m64n64k16, both operands read by
//     descriptor from shared memory without swizzle. x and g lie as 8
//     planes of [pixel][8 channels], so any 8 consecutive pixels are one
//     core matrix and tap (dy, dx)'s operand is the halo dy rows and dx
//     pixels in: just another start address, no shifted copy. Warpgroup dx
//     (of 3) holds the taps (dy, dx), dy = 0-2, as three 64 x 64 float32
//     accumulators: 96 of 122 registers. bf16 K = 1: mma.sync.m16n8k16 from
//     ldmatrix.trans, 32 x 32 warp tiles of the 64 x 128 block tile (8
//     warps, all busy). float32: FMA, at
//     K = 3 units of (tap, 16 channels), 3 a warp, a lane two columns, x
//     read as shared-memory broadcasts (a 3-channel slab runs only its one
//     channel group); at K = 1 a thread owns 4 channels x 8 columns.
//   * db (K = 1). The blocks of the first input-channel tile also sum the g
//     tiles they stage, every thread a column half, in a fixed order; no
//     separate launch.
//   * The plan (ops/kernels/conv.py:wgrad_plan) sizes the split from the
//     work: the pixels go into chunks only as far as the output tiles leave
//     SMs idle, never below 8 items a chunk, and the grid stays one wave of
//     one block per SM. The chunks are summed in the same launch, in an
//     order fixed by the chunk count alone, with no float atomics, so two
//     calls give the same bits: one chunk writes the result directly; a few
//     chunks (the plan says how many) form one thread-block cluster a tile
//     and sum their tiles in distributed shared memory, in rank order; more
//     write float32 partials, meet at a grid barrier (an integer counter;
//     the launch is cooperative, so every block is resident; a block that
//     waits ~2 s traps instead of hanging the card; the last one out resets
//     it) and then every block sums a slice of the partials. So only the
//     56^2 to 224^2 levels' partials reach device memory, 0.28 GB a pass,
//     against 1.05 GB when chunks filled the card twice whatever the shape,
//     and no one SM reduces a tile alone (at 224^2, 131 partials).
// The epilogue goes through a float32 tile in shared memory over the dead
// ring, so that dw rows leave as contiguous float4 runs. Shared memory: 156
// / 168 KB (bf16, K = 3, 8x16 / 4x32), 145-154 KB (float, K = 3), 104 KB
// (bf16, K = 1), 144 KB (float, K = 1); one block per SM.
#pragma once

#include <cuda.h>            // CUtensorMap (the driver is reached through the runtime)
#include <cudaTypedefs.h>    // PFN_cuTensorMapEncodeTiled

#include <cooperative_groups.h>

#include "dense_conv.cuh"

namespace wgrad {
namespace {

using namespace common;

constexpr int STEP = 64;           // K = 1: pixels per item
// K = 3 pixel tiles, by width: 8x16 and 4x32 (bf16), 8x16, 4x28 and 7x14
// (float32); wgrad_plan picks the one with the fewest k steps
constexpr int tile_rows(int tw) { return tw == 16 ? 8 : tw == 28 || tw == 32 ? 4 : 7; }
constexpr int OROW3 = 9 * C + 4;   // epilogue tile, K = 3: [co][ci][tap], padded rows
constexpr int OROW1 = 4 * 32 + 4;  // K = 1: [ci][c][parity], padded rows
// how a launch's chunks are summed (the plan chooses): one chunk; a cluster
// of at most 8 (the portable cluster size) in distributed shared memory; or
// partials and a grid barrier
enum Reduce { ONE = 0, CLUSTER = 1, GRID = 2 };

struct WgArgs {
  const void* x;
  const void* g;
  int cx, cin;            // x's channels per pixel (a multiple of 8, >= cin: those past
                          // cin are not read); dw's input channels
  int cg;                 // g's channels per pixel
  int N, H, W;            // x's size
  int tiles_x, tiles;     // K = 3: pixel tiles per row, per image
  int mtiles, ntiles;     // output tiles: input-channel blocks x column blocks
  int items, per_chunk, chunks, reduce;   // reduce: ONE, CLUSTER or GRID
  int dw_size, stride;    // floats of dw; of the whole result (dw, then db)
  float* out;             // the result
  float* part;            // (chunks, stride) partials of a GRID reduce
  unsigned* bar;          // two counters, zero between launches, of a GRID reduce
  CUtensorMap xmap, gmap; // bf16, K = 3: x and g as NHWC boxes of 8 channels (TMA)
};

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 bf16 matrices, transposed on load: lane l addresses row l % 8 of
// matrix l / 8, a row of 8 channels of one pixel
__device__ __forceinline__ void ldsm_x4_t(uint32_t& r0, uint32_t& r1, uint32_t& r2, uint32_t& r3,
                                          const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_addr(p)));
}

template <typename T, int K, int TW_ = 16> struct Geo {
  static constexpr bool BF = sizeof(T) == 2;
  // bf16 K = 3 feeds wgmma: each stage holds x and g as 8 planes of [pixel][8
  // channels], so any 8 consecutive pixels form one core matrix
  static constexpr int V = 16 / sizeof(T);                  // elements per 16-byte copy
  static constexpr int TW = TW_, TH = tile_rows(TW), TR = TH * TW;   // K = 3 pixel tile
  static constexpr int IC = TW + 2, IR = TH + 2;            // and its halo
  static constexpr int KSTEPS = (TR + 15) / 16;             // bf16 k steps (16 pixels) a tile
  static constexpr int XPX = K == 3 ? IR * IC : STEP;       // x pixels staged per item
  static constexpr int GPX = K == 3 ? 16 * KSTEPS : STEP;   // g pixel rows staged per item
  static constexpr bool PLANAR = BF && K == 3;
  static constexpr int PAD = BF && !PLANAR ? 8 : 0;         // ldmatrix rows on distinct banks
  static constexpr int XP = C + PAD;                        // elements a pixel
  static constexpr int GP = (K == 3 ? C : 4 * 32) + PAD;
  // pixels a plane holds (planar: rounded up to 128 bytes, where TMA writes)
  static constexpr int XPL = PLANAR ? (XPX + 7) / 8 * 8 : XPX;
  static constexpr int GPL = GPX;
  static constexpr int XOFF = XPL * XP;                     // elements to g's part of a stage
  static constexpr int STAGE = XOFF + GPL * GP;             // elements per stage
  static constexpr int WARPS = K == 3 ? 12 : 8, THREADS = 32 * WARPS;
  static constexpr int STAGES = BF ? 4 : (K == 3 ? 2 : 3);
  static constexpr size_t RING = sizeof(T) * (size_t)STAGES * STAGE;
  static constexpr size_t TILE = sizeof(float) * (K == 3 ? (size_t)C * OROW3
                                                          : (size_t)C * OROW1 + 2 * 4 * 32 + 32);
  static constexpr size_t SMEM = (RING > TILE ? RING : TILE) + 8 * STAGES;   // + mbarriers
  // where dw[tap, ci, col] of the block's tile sits in the epilogue tile
  __device__ static int at(int tap, int ci, int col) {
    return K == 3 ? col * OROW3 + ci * 9 + tap : ci * OROW1 + (col & 31) * 4 + (col >> 5);
  }
};

// Stage item `item` of output tile (mt, nt): x's 64-channel slab mt over the
// item's pixels (K = 3: with the halo), and g's columns of tile nt.
template <typename T, int K, int TW>
__device__ __forceinline__ void load_item(T* st, const WgArgs& a, int item, int mt, int nt) {
  using G = Geo<T, K, TW>;
  constexpr int TH = G::TH, TR = G::TR, IC = G::IC, IR = G::IR;
  constexpr int V = G::V, CH = C / V;
  const T* x = static_cast<const T*>(a.x);
  const T* g = static_cast<const T*>(a.g);
  T* gs = st + G::XOFF;
  const int ci0 = mt * C;
  if constexpr (K == 3) {
    const int n = item / a.tiles, t = item % a.tiles;
    const int y0 = (t / a.tiles_x) * TH, x0 = (t % a.tiles_x) * TW;
    for (int i = threadIdx.x; i < IR * IC * CH; i += G::THREADS) {
      const int q = i % CH, pix = i / CH;
      const int Y = y0 - 1 + pix / IC, X = x0 - 1 + pix % IC, ch = ci0 + V * q;
      const bool ok = Y >= 0 && Y < a.H && X >= 0 && X < a.W && ch < a.cin;
      cp_async16(st + pix * G::XP + V * q,
                 ok ? x + (((size_t)n * a.H + Y) * a.W + X) * a.cx + ch : x, ok);
    }
    for (int i = threadIdx.x; i < TR * CH; i += G::THREADS) {
      const int q = i % CH, pix = i / CH;
      const int Y = y0 + pix / TW, X = x0 + pix % TW;
      const bool ok = Y < a.H && X < a.W;
      cp_async16(gs + pix * G::GP + V * q,
                 ok ? g + (((size_t)n * a.H + Y) * a.W + X) * a.cg + nt * C + V * q : g, ok);
    }
  } else {
    constexpr int GCH = 32 / V;   // copies per parity row of 32 channels
    const int HW = a.H * a.W, total = a.N * HW, p0 = item * STEP;
    for (int i = threadIdx.x; i < STEP * CH; i += G::THREADS) {
      const int q = i % CH, r = i / CH, p = p0 + r;
      const bool ok = p < total;
      cp_async16(st + r * G::XP + V * q, ok ? x + (size_t)p * a.cx + ci0 + V * q : x, ok);
    }
    for (int i = threadIdx.x; i < STEP * 4 * GCH; i += G::THREADS) {
      const int q = i % GCH, par = (i / GCH) % 4, r = i / (4 * GCH), p = p0 + r;
      const bool ok = p < total;
      const int n = p / HW, y = p % HW / a.W, xx = p % a.W;
      const size_t o = ((size_t)n * 2 * a.H + 2 * y + (par >> 1)) * 2 * a.W + 2 * xx + (par & 1);
      cp_async16(gs + r * G::GP + par * 32 + V * q, ok ? g + o * a.cg + nt * 32 + V * q : g, ok);
    }
  }
}

// TMA and mbarriers (bf16, K = 3)
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile("{\n.reg .pred p;\nWAIT_%=:\n"
               "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
               "@!p bra WAIT_%=;\n}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}
// one box of a 4-D tensor map at (c, x, y, n) into shared memory, completing
// its bytes on bar; boxes past the tensor's edges read as zeros
__device__ __forceinline__ void tma4(void* dst, const CUtensorMap* map, int c, int x, int y, int n,
                                     uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(x), "r"(y), "r"(n),
        "r"(smem_addr(bar))
      : "memory");
}

// bf16, K = 3: item `item` of output tile (mt, nt) by TMA, each channel plane
// of x's halo and of g's tile one box (the halo's and the ragged edge's
// zeros, and those of a 3-channel x's missing channels, are the boxes' fill)
// (planes: x's planes that hold channels; the rest stay zero from the start)
template <int TW>
__device__ __forceinline__ void tma_item(__nv_bfloat16* st, uint64_t* bar, const WgArgs& a,
                                         int item, int mt, int nt, int planes) {
  using G = Geo<__nv_bfloat16, 3, TW>;
  const int n = item / a.tiles, t = item % a.tiles;
  const int y0 = (t / a.tiles_x) * G::TH, x0 = (t % a.tiles_x) * TW;
  mbar_expect(bar, (planes * G::XPX + 8 * G::TR) * 16);
  for (int q = 0; q < planes; ++q)
    tma4(st + q * G::XPL * 8, &a.xmap, mt * C + 8 * q, x0 - 1, y0 - 1, n, bar);
#pragma unroll
  for (int q = 0; q < 8; ++q)
    tma4(st + G::XOFF + q * G::GPL * 8, &a.gmap, nt * C + 8 * q, x0, y0, n, bar);
}

template <typename T, int K, int TW> struct Acc;

// wgmma: a shared-memory matrix descriptor with no swizzle, for an operand
// stored as 8-element (16-byte) rows, 8 consecutive rows along the reduction
// (K) forming a core matrix: lbo = bytes from one core matrix to the next
// along K, sbo = along M or N
__device__ __forceinline__ uint64_t wg_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return ((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// d += A (64 x 16) B (16 x 64), both MN-major (transposed) bf16 in shared
// memory, float32 accumulators in registers (wgmma.m64n64k16; warp w of the
// warpgroup holds rows 16w .. 16w+15 as mma.m16n8 fragments, register 4j +
// 2h + e: row 16w + lane/4 + 8h, column 8j + 2 (lane % 4) + e)
__device__ __forceinline__ void wgmma_64x64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// keep the compiler from moving accumulator reads or writes across wgmma
__device__ __forceinline__ void wg_fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// bf16, K = 3, on wgmma: warpgroup dx (of 3) owns the taps (dy, dx), dy =
// 0-2, each a 64 x 64 float32 accumulator (96 registers a thread). A k step
// is 16 pixels of one tile row; its B operand (g) serves the three taps, and
// tap (dy, dx)'s A operand (x) starts at the halo pixel dy rows down and dx
// across: with the planar layout that is just another start address.
template <int TW> struct Acc<__nv_bfloat16, 3, TW> {
  using bf16 = __nv_bfloat16;
  using G = Geo<bf16, 3, TW>;
  static_assert(TW % 16 == 0, "a wgmma k step is 16 pixels of one tile row");
  float acc[3][32];

  __device__ Acc() {
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[dy][i] = 0.f;
  }

  // start the item's 24 products (KSTEPS x 3 taps); wait() for them
  __device__ void issue(const bf16* xs, const bf16* gs) {
    constexpr uint32_t XPLANE = G::XPL * 16, GPLANE = G::GPL * 16;   // bytes a plane
    const int dx = threadIdx.x >> 7;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int s = 0; s < G::KSTEPS; ++s) {
      const int r = s / (TW / 16), c0 = 16 * (s % (TW / 16));
      const uint64_t db = wg_desc(gs + 16 * s * 8, 128, GPLANE);
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
        wgmma_64x64(acc[dy], wg_desc(xs + ((r + dy) * G::IC + c0 + dx) * 8, 128, XPLANE), db);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  }

  // Drains all: with products left in flight past the next barrier, ptxas
  // serializes the wgmmas (the loop-carried accumulators count as touched).
  __device__ void wait() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) wg_fence_regs(acc[dy]);
  }

  // f(tap, ci, col, v(col), v(col + 1)) for each pair the thread holds
  template <class F> __device__ void visit(F&& f) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          f(3 * dy + (warp >> 2), (warp & 3) * 16 + g + 8 * h, 8 * j + 2 * t,
            acc[dy][4 * j + 2 * h], acc[dy][4 * j + 2 * h + 1]);
  }
};

// bf16, K = 1: warp w owns input channels 32 (w % 2) .. +31 and columns
// 32 (w / 2) .. +31 of the 64 x 128 tile; four k steps of 16 pixels an item.
template <int TW> struct Acc<__nv_bfloat16, 1, TW> {
  using bf16 = __nv_bfloat16;
  using G = Geo<bf16, 1>;
  float acc[2][4][4];

  __device__ Acc() {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.f;
  }

  __device__ void run(const bf16* xs, const bf16* gs, int) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int qb = lane >> 3, kb = (lane & 7) + 8 * (qb & 1), nofs = 8 * (qb >> 1);
    const int ka = (lane & 7) + 8 * (lane >> 4), mofs = 8 * ((lane >> 3) & 1);
    const bf16* xb = xs + ka * G::XP + (warp & 1) * 32 + mofs;
    const bf16* gb = gs + kb * G::GP + (warp >> 1) * 32 + nofs;
#pragma unroll
    for (int kk = 0; kk < STEP; kk += 16) {
      uint32_t b[4][2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
        ldsm_x4_t(b[2 * j][0], b[2 * j][1], b[2 * j + 1][0], b[2 * j + 1][1],
                  gb + kk * G::GP + 16 * j);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        uint32_t a0, a1, a2, a3;
        ldsm_x4_t(a0, a1, a2, a3, xb + kk * G::XP + 16 * m);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[m][j], a0, a1, a2, a3, b[j][0], b[j][1]);
      }
    }
  }

  template <class F> __device__ void visit(F&& f) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          f(0, (warp & 1) * 32 + m * 16 + g + 8 * h, (warp >> 1) * 32 + j * 8 + 2 * t,
            acc[m][j][2 * h], acc[m][j][2 * h + 1]);
  }
};

// float32, K = 3: units (tap, 16 input channels), unit u = tap * groups +
// group over the slab's groups of channels that x holds (4, or 1 for the
// UNet's 3-channel input), at most 3 per warp; lane l owns columns 2l, 2l+1.
// Each pixel's g pair is read once a unit, x as shared-memory broadcasts.
template <int TW> struct Acc<float, 3, TW> {
  using G = Geo<float, 3, TW>;
  static constexpr int UPW = 36 / G::WARPS;
  float acc[UPW][16][2];
  int groups = 4;

  __device__ Acc() {
#pragma unroll
    for (int u = 0; u < UPW; ++u)
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[u][j][0] = acc[u][j][1] = 0.f;
  }

  __device__ void run(const float* xs, const float* gs, int valid) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    groups = min(4, (valid + 15) / 16);
    const int units = 9 * groups;
    int xo[UPW];   // each unit's tap shift and channel group
#pragma unroll
    for (int u = 0; u < UPW; ++u) {
      const int unit = warp + G::WARPS * u, tap = unit / groups;
      xo[u] = ((tap / 3) * G::IC + tap % 3) * G::XP + (unit % groups) * 16;
    }
#pragma unroll 2
    for (int p = 0; p < G::TR; ++p) {
      const float* xp0 = xs + ((p / TW) * G::IC + p % TW) * G::XP;
      const float2 g2 = *reinterpret_cast<const float2*>(gs + p * G::GP + 2 * lane);
#pragma unroll
      for (int u = 0; u < UPW; ++u) {
        if (warp + G::WARPS * u >= units) break;   // warp-uniform
        const float* xp = xp0 + xo[u];
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

  template <class F> __device__ void visit(F&& f) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int u = 0; u < UPW; ++u) {
      const int unit = warp + G::WARPS * u;
      if (unit >= 9 * groups) break;   // the tile's other channels stay unwritten: ci >= cin
#pragma unroll
      for (int j = 0; j < 16; ++j)
        f(unit / groups, (unit % groups) * 16 + j, 2 * lane, acc[u][j][0], acc[u][j][1]);
    }
  }
};

// float32, K = 1: thread t owns input channels 4 (t % 16) .. +3 and columns
// 8 (t / 16) .. +7 of the 64 x 128 tile.
template <int TW> struct Acc<float, 1, TW> {
  using G = Geo<float, 1>;
  float acc[4][8];

  __device__ Acc() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  __device__ void run(const float* xs, const float* gs, int) {
    const float* xp = xs + 4 * (threadIdx.x & 15);
    const float* gp = gs + 8 * (threadIdx.x >> 4);
#pragma unroll 4
    for (int r = 0; r < STEP; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(xp + r * G::XP);
      const float4 g0 = *reinterpret_cast<const float4*>(gp + r * G::GP);
      const float4 g1 = *reinterpret_cast<const float4*>(gp + r * G::GP + 4);
      const float xv[4] = {v.x, v.y, v.z, v.w};
      const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xv[i], gv[j], acc[i][j]);
    }
  }

  template <class F> __device__ void visit(F&& f) const {
    const int ci = 4 * (threadIdx.x & 15), col = 8 * (threadIdx.x >> 4);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; j += 2) f(0, ci + i, col + j, acc[i][j], acc[i][j + 1]);
  }
};

// Wait until every block of the grid has arrived (the launch is cooperative,
// so all are resident); a block's global writes before it are visible to
// every block after it. A block that waits for more than ~2 s traps rather
// than hang the card.
__device__ __forceinline__ void grid_sync(unsigned* bar) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    atomicAdd(bar, 1u);
    const long long t0 = clock64();
    while (*reinterpret_cast<volatile unsigned*>(bar) < gridDim.x) {
      __nanosleep(64);
      if (clock64() - t0 > (1ll << 32)) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

// grid: output tiles x chunks, block b = (chunk, mt, nt) = (b % chunks, b /
// chunks / ntiles, b / chunks % ntiles), as wgrad_plan lays it out
template <typename T, int K, int TW>
__global__ void __launch_bounds__(Geo<T, K, TW>::THREADS, 1)
    wgrad_kernel(const __grid_constant__ WgArgs a) {
  using G = Geo<T, K, TW>;
  extern __shared__ __align__(128) float4 smem4[];
  T* ring = reinterpret_cast<T*>(smem4);
  const int chunk = blockIdx.x % a.chunks, mt = blockIdx.x / a.chunks / a.ntiles;
  const int nt = blockIdx.x / a.chunks % a.ntiles;   // a cluster holds one tile's chunks
  const int i0 = chunk * a.per_chunk, count = min(a.items - i0, a.per_chunk);
  const bool db = K == 1 && mt == 0;   // this block also sums g's columns
  const int valid = min(C, a.cin - mt * C);   // channels of the slab that dw takes

  Acc<T, K, TW> acc;
  float dbs = 0.f;
  if constexpr (G::PLANAR) {   // TMA fills the stages, one thread issuing; wgmma reads them
    uint64_t* full = reinterpret_cast<uint64_t*>(reinterpret_cast<char*>(smem4) + G::SMEM) -
                     G::STAGES;
    const int planes = (valid + 7) / 8;   // x's planes that hold channels
    if (planes < 8) {   // the others stay zero (wgmma reads them through the async proxy)
      constexpr int PL = G::XPL * 8;
      for (int i = threadIdx.x; i < G::STAGES * (8 - planes) * PL; i += G::THREADS)
        ring[i / ((8 - planes) * PL) * G::STAGE + planes * PL + i % ((8 - planes) * PL)] =
            from_f<T>(0.f);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    if (threadIdx.x == 0) {
      for (int s = 0; s < G::STAGES; ++s) mbar_init(full + s);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int s = 0; s < G::STAGES && s < count; ++s)
        tma_item<TW>(ring + s * G::STAGE, full + s, a, i0 + s, mt, nt, planes);
    }
    __syncthreads();
#pragma unroll 1
    for (int i = 0; i < count; ++i) {
      const int slot = i % G::STAGES;
      mbar_wait(full + slot, (i / G::STAGES) & 1);   // item i has landed
      const T* xs = ring + slot * G::STAGE;
      acc.issue(xs, xs + G::XOFF);
      acc.wait();
      __syncthreads();   // every warpgroup is done with the stage: refill it
      if (threadIdx.x == 0 && i + G::STAGES < count)
        tma_item<TW>(ring + slot * G::STAGE, full + slot, a, i0 + i + G::STAGES, mt, nt, planes);
    }
  } else {
    if constexpr (K == 3 && G::GPX > G::TR) {   // g rows past the tile stay zero in every stage
      constexpr int PAD = (G::GPX - G::TR) * G::GP;
      for (int i = threadIdx.x; i < G::STAGES * PAD; i += G::THREADS)
        ring[i / PAD * G::STAGE + G::XOFF + G::TR * G::GP + i % PAD] = from_f<T>(0.f);
    }
#pragma unroll 1
    for (int s = 0; s < G::STAGES - 1; ++s) {
      if (s < count) load_item<T, K, TW>(ring + s * G::STAGE, a, i0 + s, mt, nt);
      cp_async_commit();
    }
#pragma unroll 1
    for (int i = 0; i < count; ++i) {
      cp_async_wait<G::STAGES - 2>();   // item i has landed (this thread's copies)
      __syncthreads();                  // ... everyone's; and item i-1's slot is free
      const int next = i + G::STAGES - 1;
      if (next < count)
        load_item<T, K, TW>(ring + next % G::STAGES * G::STAGE, a, i0 + next, mt, nt);
      cp_async_commit();
      const T* xs = ring + i % G::STAGES * G::STAGE;
      const T* gs = xs + G::XOFF;
      acc.run(xs, gs, valid);
      if (db) {   // column threadIdx.x % 128, pixels of half threadIdx.x / 128
        const T* col = gs + (threadIdx.x >> 7) * (STEP / 2) * G::GP + (threadIdx.x & 127);
#pragma unroll 8
        for (int r = 0; r < STEP / 2; ++r) dbs += to_f(col[r * G::GP]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is dead: the epilogue tile goes over it

  float* tile = reinterpret_cast<float*>(smem4);
  acc.visit([&](int tap, int ci, int col, float v0, float v1) {
    tile[G::at(tap, ci, col)] = v0;
    tile[G::at(tap, ci, col + 1)] = v1;
  });
  float* red = tile + C * OROW1;   // K = 1: the column halves' db sums, then the block's db
  if (db) red[threadIdx.x] = dbs;
  __syncthreads();
  if (db && threadIdx.x < 32) {
    float s = 0.f;
#pragma unroll
    for (int par = 0; par < 4; ++par)
      s += red[par * 32 + threadIdx.x] + red[128 + par * 32 + threadIdx.x];
    red[256 + threadIdx.x] = s;
  }
  __syncthreads();

  // The block's tile goes out: with one chunk into the result; in a cluster
  // the chunks' blocks share the writing, each value the sum of the tiles'
  // in rank (chunk) order read through distributed shared memory; for the
  // grid, into the chunk's partial.
  namespace cg = cooperative_groups;
  int first = threadIdx.x, step = G::THREADS;
  float* dst = a.out;
  if (a.reduce == CLUSTER) {
    cg::this_cluster().sync();   // every chunk's tile is in place
    first += chunk * G::THREADS;
    step *= a.chunks;
  } else if (a.reduce == GRID) {
    dst = a.part + (size_t)chunk * a.stride;
  }
  auto sum4 = [&](int off) {
    if (a.reduce != CLUSTER) return *reinterpret_cast<const float4*>(tile + off);
    float4 s = *reinterpret_cast<const float4*>(cg::this_cluster().map_shared_rank(tile + off, 0));
    for (int c = 1; c < a.chunks; ++c) {
      const float4 v =
          *reinterpret_cast<const float4*>(cg::this_cluster().map_shared_rank(tile + off, c));
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    return s;
  };
  auto sum1 = [&](int off) {
    if (a.reduce != CLUSTER) return tile[off];
    float s = *cg::this_cluster().map_shared_rank(tile + off, 0);
    for (int c = 1; c < a.chunks; ++c) s += *cg::this_cluster().map_shared_rank(tile + off, c);
    return s;
  };
  if constexpr (K == 3) {   // rows co of (cout, cin, 9): the tile's nci * 9 values are contiguous
    const int L = min(C, a.cin - mt * C) * 9;
    float* row0 = dst + ((size_t)nt * C * a.cin + mt * C) * 9;
    if (a.cin % 4 == 0) {   // whole float4s: L and the row starts are multiples of 4
      const int L4 = L / 4;
      for (int i = first; i < C * L4; i += step) {
        const int co = i / L4, e = i % L4;
        reinterpret_cast<float4*>(row0 + (size_t)co * a.cin * 9)[e] = sum4(co * OROW3 + 4 * e);
      }
    } else {
      for (int i = first; i < C * L; i += step) {
        const int co = i / L, e = i % L;
        row0[(size_t)co * a.cin * 9 + e] = sum1(co * OROW3 + e);
      }
    }
  } else {   // rows ci of (cin, cg, 4): the tile's 32 channels x 4 parities are contiguous
    for (int i = first; i < C * 32; i += step) {
      const int ci = i / 32, e = i % 32;
      reinterpret_cast<float4*>(dst + ((size_t)(mt * C + ci) * a.cg + nt * 32) * 4)[e] =
          sum4(ci * OROW1 + 4 * e);
    }
    if (mt == 0)
      for (int i = first; i < 32; i += step)
        dst[a.dw_size + nt * 32 + i] = sum1(C * OROW1 + 256 + i);
  }
  if (a.reduce == CLUSTER) cg::this_cluster().sync();   // peers read this tile until here
  if (a.reduce != GRID) return;

  // every chunk's partial is out: the grid sums them into the result in an
  // order fixed by chunks alone. Up to 8 chunks a thread sums a float4 in
  // chunk order, four float4s at a time; more, and four lanes share a float4,
  // lane j the chunks j, j + 4, ... (eight loads in flight), then a fixed tree.
  grid_sync(a.bar);
  const int n4 = a.stride / 4, all = gridDim.x * G::THREADS;
  const int gt = blockIdx.x * G::THREADS + threadIdx.x;
  const float4* part = reinterpret_cast<const float4*>(a.part);
  float4* out = reinterpret_cast<float4*>(a.out);
  if (a.chunks <= 8) {
    for (int e = gt; e < n4; e += 4 * all) {
      float4 s[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        s[u] = e + u * all < n4 ? __ldcg(part + e + u * all) : make_float4(0.f, 0.f, 0.f, 0.f);
      for (int c = 1; c < a.chunks; ++c)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (e + u * all < n4) {
            const float4 v = __ldcg(part + (size_t)c * n4 + e + u * all);
            s[u].x += v.x; s[u].y += v.y; s[u].z += v.z; s[u].w += v.w;
          }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (e + u * all < n4) out[e + u * all] = s[u];
    }
  } else {
    const int j = threadIdx.x & 3;
    const unsigned quad = 0xfu << (threadIdx.x & 28);
    for (int e = gt >> 2; e < n4; e += all / 4) {   // the four lanes of a quad share e
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
      for (int c = j; c < a.chunks; c += 4) {
        const float4 v = __ldcg(part + (size_t)c * n4 + e);
        s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
      }
#pragma unroll
      for (int m = 1; m <= 2; m <<= 1) {   // a + b == b + a: both partners get the same bits
        s.x += __shfl_xor_sync(quad, s.x, m);
        s.y += __shfl_xor_sync(quad, s.y, m);
        s.z += __shfl_xor_sync(quad, s.z, m);
        s.w += __shfl_xor_sync(quad, s.w, m);
      }
      if (j == 0) out[e] = s;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0 && atomicAdd(a.bar + 1, 1u) == gridDim.x - 1) {
    atomicExch(a.bar, 0u);   // every block is past the barrier: reset both
    atomicExch(a.bar + 1, 0u);
  }
}

// A 4-D TMA map over p: dims[0] contiguous elements of `type` (16-byte
// rows at least), dims 1-3 at strides (bytes) strides[0..2]; boxes of box[0..3]
// elements, zeros past the edges, laid out in shared memory as `swizzle`
// says. cuTensorMapEncodeTiled is reached through the runtime, so the library
// needs no link against the driver.
inline bool tensor_map4(CUtensorMap* map, CUtensorMapDataType type, const void* p,
                        const cuuint64_t dims[4], const cuuint64_t strides[3],
                        const cuuint32_t box[4],
                        CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_NONE) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode),
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      encode = nullptr;
      return false;
    }
  }
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, type, 4, const_cast<void*>(p), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// An NHWC bf16 tensor of C channels (a multiple of 8) as boxes of 8 channels
// x bw x bh pixels of one image.
inline bool nhwc_map(CUtensorMap* map, const void* p, int C, int W, int H, int N, int bw, int bh) {
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)N};
  const cuuint64_t strides[3] = {2ull * C, 2ull * C * W, 2ull * C * W * H};   // bytes
  const cuuint32_t box[4] = {8, (cuuint32_t)bw, (cuuint32_t)bh, 1};
  return tensor_map4(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p, dims, strides, box);
}

// One launch over a plan (wgrad_plan): items, chunks and per_chunk must
// cover the items with no empty chunk; a split plan needs part and bar and
// is launched cooperatively, which fails rather than run a grid that cannot
// be resident at once.
template <typename T, int K, int TW = 16>
cudaError_t launch_wgrad(WgArgs a, cudaStream_t s) {
  using G = Geo<T, K, TW>;
  if (a.cx % 8 || a.cin < 1 || a.cin > a.cx || a.cg % (K == 3 ? C : 32) || a.chunks < 1 ||
      a.per_chunk < 1 || (long long)a.chunks * a.per_chunk < a.items ||
      (long long)(a.chunks - 1) * a.per_chunk >= a.items || a.stride % 4)
    return cudaErrorInvalidValue;
  if ((a.reduce == ONE) != (a.chunks == 1) || (a.reduce == CLUSTER && a.chunks > 8) ||
      (a.reduce == GRID && (a.part == nullptr || a.bar == nullptr)) || a.reduce < ONE ||
      a.reduce > GRID)
    return cudaErrorInvalidValue;
  if constexpr (G::PLANAR)
    if (!nhwc_map(&a.xmap, a.x, a.cx, a.W, a.H, a.N, G::IC, G::IR) ||
        !nhwc_map(&a.gmap, a.g, a.cg, a.W, a.H, a.N, TW, G::TH))
      return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(wgrad_kernel<T, K, TW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.mtiles * a.ntiles * a.chunks), block(G::THREADS);
  if (a.reduce == ONE) {
    wgrad_kernel<T, K, TW><<<grid, block, G::SMEM, s>>>(a);
    return cudaGetLastError();
  }
  if (a.reduce == CLUSTER) {   // a tile's chunks in one cluster, consecutive blocks
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = block;
    cfg.dynamicSmemBytes = G::SMEM;
    cfg.stream = s;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = a.chunks;
    attr.val.clusterDim.y = attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, wgrad_kernel<T, K, TW>, a);
  }
  void* args[] = {&a};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(&wgrad_kernel<T, K, TW>), grid,
                                     block, args, G::SMEM, s);
}

}  // namespace
}  // namespace wgrad
