// The 2x2 / stride-2 transposed convolution and its backward:
//     y[n, 2i+di, 2j+dj, o] = sum_c x[n, i, j, c] w[c, o, di, dj] + b[o]
//     dx[n, i, j, c]        = sum_{di, dj, o} g[n, 2i+di, 2j+dj, o] w[c, o, di, dj]
//     dw[c, o, di, dj]      = sum_{n, i, j} x[n, i, j, c] g[n, 2i+di, 2j+dj, o]
//     db[o]                 = sum of g over n, y, x
//
// Replaces: unet_goolenet_tpu/ops/pallas/conv.py:conv_transpose2x2_pallas
// (forward _deconv_kernel; VJP _deconv_bwd: _deconv_dx_kernel and
// _deconv_dwdb_kernel). w is torch's ConvTranspose2d (cin, cout, 2, 2).
// cin and cout are multiples of 64 (the UNet's 64-512).
//
// Bound on an H100: 8 cin cout FLOP an input pixel, 1.64 GFLOP at each of the
// UNet's four levels at batch 4 (14^2 x 512 to 112^2 x 64), against 6.1, 8.5,
// 16 and 32 MB moved in bf16 (x, w and y once; dx moves the same): below the
// card's ridge point at every level, so bound by bytes, 0.019 ms for the four
// (chip_smoke.py computes each shape's bound). What pays is few launches,
// few passes over the bytes, and loads in flight while the math runs.
//
// Forward and dx: one GEMM kernel, deconv_gemm<T, DX>, M = pixels, N =
// columns, K = the reduction; 256 threads, M tiles of 128 pixels, K tiles of
// 64:
//   forward  M = N*H*W input pixels (x is one row of them), K = cin, N = 4
//            cout in tiles of 128: 32 o at the four parities, parity-major.
//            One launch: B is torch's float32 w as it lies, read through
//            registers a stage ahead (a warp loads one 512-byte row of w an
//            instruction) and rounded to T on its way into shared memory.
//   dx       M = N*H*W output pixels of x's grid, K = 4 cout ordered
//            (parity, o), 64 o of one parity a K tile, N = cin in tiles of
//            64. g viewed as (2 cout, W, 2, N*H) puts the pixels on rows and
//            (dj, o) on contiguous K for each row parity di: each K tile's A
//            is one box of that view (channel dj * cout + o0, di), so the
//            depth-to-space is in the addressing and g is never copied. An
//            M tile is R whole rows of x's width (R * W <= 128: 126 of 128
//            pixels at 14 wide) or a 128-pixel segment of a row. Two
//            launches: dx_weight_kernel lays w out as (cin, 4, cout) in T
//            (each input channel's row stays contiguous, so it reads and
//            writes coalesced), so that B is K-major rows that TMA brings
//            with A.
//   * Loads overlap math: one thread issues each stage's TMA boxes (128-byte
//     rows, zeros past the edges) into a ring of mbarrier stages, 3 deep, or
//     2 when the grid is more than two blocks an SM (then four fit an SM:
//     the 112^2 dx runs 448 blocks in one wave). bf16 drains them with
//     wgmma (m64n128k16 forward, B MN-major; m64n64k16 dx, B K-major),
//     every operand 128-byte swizzled and read by descriptor, two
//     warpgroups of 64 rows; the forward's next B goes into shared memory
//     while the tensor cores work. float32 runs FMA from the same tiles, a
//     thread 8 rows x BN/16 columns.
//   * Tiles and split of K per level (ops/kernels/conv.py:deconv_plan, plain
//     Python the CPU tests reach): dx splits K over up to 4 blocks of one
//     thread-block cluster while the grid stays within one block an SM (the
//     14^2 level: 7 x 8 tiles x 2 splits = 112 blocks), summed in
//     distributed shared memory in rank order: deterministic.
//   * Epilogue: the float32 tile goes through shared memory over the dead
//     ring; each thread stores 16 bytes, a warp whole pixel rows: the forward
//     adds b rounded to T (as the trainer's TPU kernel takes it; the decoder
//     level's, up_level.cu, keeps it float32: bias_f32) and writes each
//     parity's 32 channels (64 bytes in bf16, 128 in float32) at its output
//     pixel; dx writes rows of 64 channels. Every output is rounded once to
//     T, from float32 sums.
// dW, db: one launch of conv_dw.cuh's wgrad_kernel with K = 1, a GEMM of M =
// cin, N = 4 cout (32 channels at the four parities a block), K = the pixels
// in steps of 64 through a cp.async ring, g read at its parities the same
// way, mma.sync in bf16; the blocks of x's first 64 channels also sum the g
// tiles they stage for db. The pixels are split as wgrad_plan says and the
// chunks summed in a fixed order in the same launch, into torch's (cin,
// cout, 2, 2) and db.
// Shared memory: bf16 96 KB a block (forward) and 72 KB (dx), float32 192
// and 144 KB, with 3 stages; less for fewer.
#include <algorithm>
#include <type_traits>

#include "hopper.cuh"

namespace deconv {
namespace {

using namespace common;
using wgrad::mbar_expect;
using wgrad::mbar_init;
using wgrad::tma4;
using hop::fence_async_shared;
using hop::mbar_wait;
using hop::pack16;
using hop::sw_desc;
using hop::wgmma_n128;
using hop::wgmma_n64;

constexpr int BM = 128;      // pixels of an M tile (two warpgroups of 64 rows)
constexpr int BK = 64;       // K of a stage
constexpr int THREADS = 256;
constexpr int STAGES = 3;     // 2 for grids of more than two blocks an SM: more fit an SM
constexpr int MAX_SPLIT = 4; // the most K splits a cluster sums (ops/kernels/conv.py)

// A stage: A as BK / CH boxes of BM pixel rows x CH channels, then B, BK x
// BN: the forward's MN-major (BN / CH boxes of BK k rows x CH columns), dx's
// K-major (BK / CH boxes of BN rows x CH k). Every row is 128 bytes. bf16
// rows, and dx's B rows in both dtypes, are swizzled as TMA writes them and
// wgmma reads them (16-byte chunk c of row r at c ^ r % 8); the others are
// not.
template <typename T, bool DX> struct Geo {
  static constexpr int BN = DX ? 64 : 128;     // columns of an N tile
  static constexpr bool BF = sizeof(T) == 2;
  static constexpr int CH = 128 / sizeof(T);   // elements in a 128-byte row
  static constexpr int V = 16 / sizeof(T);     // elements in a 16-byte chunk
  static constexpr int ASUB = BM * 128;        // bytes of an A box
  static constexpr int BSUB = (DX ? BN : BK) * 128;   // bytes of a B box
  static constexpr int ABOX = BK / CH, BBOX = (DX ? BK : BN) / CH;
  static constexpr int ABYTES = ABOX * ASUB;
  static constexpr int STAGE = ABYTES + BBOX * BSUB;
  static constexpr int TP = BN + 8;            // floats a row of the epilogue tile
  static constexpr int TILE = BM * TP * 4;
  static constexpr int CPR = BN / V;           // 16-byte output chunks a tile row
  static_assert(STAGE % 1024 == 0, "boxes on a 1024-byte swizzle period");
  // chunk c of row r of a B box as it lies in shared memory
  __device__ static int chunk(int c, int r) { return BF || DX ? c ^ (r & 7) : c; }
  // the ring (or the epilogue tile over it), then the stages' mbarriers
  __host__ __device__ static size_t body(int slots) {
    return (size_t)slots * STAGE > (size_t)TILE ? (size_t)slots * STAGE : (size_t)TILE;
  }
  static size_t smem(int slots) { return body(slots) + 8 * slots; }
};

struct DcArgs {
  CUtensorMap amap;     // A as (channels, pixels, di, rows), boxes of CH x S x 1 x R
  CUtensorMap wmap;     // dx: B, w as (cin, 4 cout) in T, boxes of CH k x BN rows
  const float* w;       // forward: B, torch's w (cin, cout, 2, 2) float32
  const void* wk;       // dx: B, w as (cin, 4, cout) in T
  const float* bias;    // forward: (cout,) float32
  int bias_f32;         // forward: 1 adds bias as it is, 0 rounded to T
  void* out;
  int H, W;             // forward: x's size, where the outputs go
  int cin, cout;
  int rows, width;      // A's view: rows of width pixels (forward: one row of N*H*W)
  int R, S, ctiles;     // an M tile: R rows x S pixels; tiles a row
  int mtiles, ntiles, ktiles, kper, splits, slots;
};

// The forward's B, one stage (BK rows x BN columns) in registers, from
// torch's float32 w as it lies: loaded from device memory (L2) a stage
// ahead, rounded to T and stored into the ring the next iteration. k = c;
// the tile's columns are parity-major, column par * BN/4 + ol holding w[k,
// o0 + ol, par]. Warp w loads rows w, w + 8, ...: lane l the four parities
// of o0 + l (one float4), so that a warp's load is one row's 512 contiguous
// bytes, and stores them as one element of each parity's run.
template <typename T> struct BStage {
  using G = Geo<T, false>;
  static constexpr int ROWS = BK / (THREADS / 32);   // rows a warp
  static_assert(G::BN / 4 == 32, "a lane an o of the tile");
  float4 r[ROWS];

  __device__ __forceinline__ void load(const DcArgs& a, int kt, int nt) {
    const float* src = a.w + ((size_t)kt * BK + (threadIdx.x >> 5)) * 4 * a.cout +
                       (nt * 32 + (threadIdx.x & 31)) * 4;
#pragma unroll
    for (int j = 0; j < ROWS; ++j)
      r[j] = __ldg(reinterpret_cast<const float4*>(src + (size_t)j * (THREADS / 32) * 4 * a.cout));
  }

  __device__ __forceinline__ void store(unsigned char* bs) const {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      const int k = (threadIdx.x >> 5) + j * (THREADS / 32);
#pragma unroll
      for (int par = 0; par < 4; ++par) {
        const int n = par * 32 + lane;
        const float v = par == 0 ? r[j].x : par == 1 ? r[j].y : par == 2 ? r[j].z : r[j].w;
        *reinterpret_cast<T*>(bs + n / G::CH * G::BSUB + k * 128 +
                              G::chunk(n % G::CH / G::V, k) * 16 + n % G::V * sizeof(T)) =
            from_f<T>(v);
      }
    }
  }
};
struct NoB {};   // dx: B comes by TMA

template <typename T, bool DX> struct Acc;

// bf16: warpgroup g owns rows 64g .. 64g+63 of the tile, all BN columns, as
// wgmma fragments (warp w of the group: rows 16w + lane/4 + 8h, columns 8j +
// 2 (lane % 4) + e in register 4j + 2h + e). A stage's four k steps
// advance A by 32 bytes within its 128-byte rows, and B by 16 k rows
// (forward) or 32 bytes (dx).
template <bool DX> struct Acc<__nv_bfloat16, DX> {
  using G = Geo<__nv_bfloat16, DX>;
  static constexpr int BN = G::BN;
  float d[BN / 2];

  __device__ Acc() {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;
  }
  __device__ __forceinline__ void issue(const unsigned char* as, const unsigned char* bs) {
    const unsigned char* a0 = as + (threadIdx.x >> 7) * 64 * 128;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const uint64_t da = sw_desc(a0 + 32 * ks, 16, 8 * 128);
      const uint64_t db = DX ? sw_desc(bs + 32 * ks, 16, 8 * 128)
                             : sw_desc(bs + 16 * 128 * ks, G::BSUB, 8 * 128);
      if constexpr (BN == 128) wgmma_n128<!DX>(d, da, db); else wgmma_n64<!DX>(d, da, db);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  }
  __device__ __forceinline__ void finish(const unsigned char*, const unsigned char*) {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+f"(d[i])::"memory");
  }
  __device__ __forceinline__ void to_tile(float* tile) const {
    const int lane = threadIdx.x & 31, row = 64 * (threadIdx.x >> 7) + 16 * ((threadIdx.x >> 5) & 3);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(tile + (row + lane / 4 + 8 * h) * G::TP + 8 * j + 2 * (lane & 3)) =
            make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
  }
};

// float32: FMA, a thread 8 rows x BN/16 columns: rows t/16 + 16i (i < 8);
// per 4 k, 8 float4 of A (lanes of a half-warp share them). The forward's B
// is MN-major: columns 4 (t % 16) + 64 q + e, a float4 a column quad and k.
// dx's is K-major: columns t % 16 + 16 e, a float4 of 4 k a column.
template <bool DX> struct Acc<float, DX> {
  using G = Geo<float, DX>;
  static constexpr int BN = G::BN;
  static constexpr int NC = BN / 16;   // columns a thread
  float d[8][NC];

  __device__ Acc() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) d[i][c] = 0.f;
  }
  __device__ __forceinline__ void issue(const unsigned char*, const unsigned char*) {}
  __device__ __forceinline__ void finish(const unsigned char* as, const unsigned char* bs) {
    const int tn = threadIdx.x & 15;
    const unsigned char* ap = as + (threadIdx.x >> 4) * 128;
#pragma unroll 2
    for (int kq = 0; kq < BK / 4; ++kq) {   // A box kq / 8, chunk kq % 8
      float4 av[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        av[i] = *reinterpret_cast<const float4*>(ap + kq / 8 * G::ASUB + 16 * 128 * i + kq % 8 * 16);
      if constexpr (DX) {   // B row n, chunk kq % 8 of box kq / 8
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int n = tn + 16 * c;
          const float4 bv = *reinterpret_cast<const float4*>(
              bs + kq / 8 * G::BSUB + n * 128 + G::chunk(kq % 8, n) * 16);
#pragma unroll
          for (int i = 0; i < 8; ++i)
            d[i][c] = fmaf(av[i].w, bv.w, fmaf(av[i].z, bv.z,
                      fmaf(av[i].y, bv.y, fmaf(av[i].x, bv.x, d[i][c]))));
        }
      } else {
        const unsigned char* bp = bs + tn / 8 * G::BSUB + tn % 8 * 16;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int q = 0; q < NC / 4; ++q) {
            const float4 bv =
                *reinterpret_cast<const float4*>(bp + 2 * q * G::BSUB + (4 * kq + kk) * 128);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float x = kk == 0 ? av[i].x : kk == 1 ? av[i].y : kk == 2 ? av[i].z : av[i].w;
              d[i][4 * q] = fmaf(x, bv.x, d[i][4 * q]);
              d[i][4 * q + 1] = fmaf(x, bv.y, d[i][4 * q + 1]);
              d[i][4 * q + 2] = fmaf(x, bv.z, d[i][4 * q + 2]);
              d[i][4 * q + 3] = fmaf(x, bv.w, d[i][4 * q + 3]);
            }
          }
      }
    }
  }
  __device__ __forceinline__ void to_tile(float* tile) const {
    const int tm = threadIdx.x >> 4, tn = threadIdx.x & 15;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float* row = tile + (tm + 16 * i) * G::TP;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if constexpr (DX) row[tn + 16 * c] = d[i][c];
        else row[4 * tn + 64 * (c / 4) + c % 4] = d[i][c];
      }
    }
  }
};

// grid: M tiles x N tiles x splits, block b = (split, mt, nt) = (b % splits,
// b / splits % mtiles, b / splits / mtiles); a split's blocks are one cluster
template <typename T, bool DX>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 2 ? 2 : 1)
    deconv_gemm(const __grid_constant__ DcArgs a) {
  using G = Geo<T, DX>;
  constexpr int V = G::V, BN = G::BN;
  extern __shared__ __align__(1024) unsigned char smem[];
  const int split = blockIdx.x % a.splits, tile = blockIdx.x / a.splits;
  const int mt = tile % a.mtiles, nt = tile / a.mtiles;
  const int rt = mt / a.ctiles, ct = mt % a.ctiles;
  const int kt0 = split * a.kper, kcount = min(a.ktiles - kt0, a.kper), slots = a.slots;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::body(slots));
  auto stage = [&](int s) { return smem + s * G::STAGE; };

  // one thread: k tile kt's A boxes into slot s (zeros past the view's
  // edges count as bytes too): the forward's channels kt * BK on, or dx's
  // o = o0 .. o0 + 63 at parity par = (di, dj), channel dj * cout + o of row
  // di, for k = kt * BK = par * cout + o0
  auto fetch = [&](int s, int kt) {
    const int k = kt * BK, par = DX ? k / a.cout : 0, c0 = DX ? (par & 1) * a.cout + k % a.cout : k;
    mbar_expect(full + s, (uint32_t)(G::ABOX * a.R * a.S * 128 + (DX ? G::BBOX * G::BSUB : 0)));
    for (int q = 0; q < G::ABOX; ++q)
      tma4(stage(s) + q * G::ASUB, &a.amap, c0 + q * G::CH, ct * a.S, par >> 1, rt * a.R, full + s);
    if constexpr (DX)   // and its B rows
      for (int q = 0; q < G::BBOX; ++q)
        tma4(stage(s) + G::ABYTES + q * G::BSUB, &a.wmap, kt * BK + q * G::CH, nt * BN, 0, 0,
             full + s);
  };
  auto bbuf = [&](int i) { return stage(i % slots) + G::ABYTES; };   // B of k tile i

  if (threadIdx.x == 0) {
    if (smem_addr(smem) & 1023) __trap();   // the swizzled boxes need 1024-byte alignment
    for (int s = 0; s < slots; ++s) mbar_init(full + s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < slots && s < kcount; ++s) fetch(s, kt0 + s);
  }
  __syncthreads();   // the barriers are initialised
  // the forward's B of k tile 0 in place, the next in registers
  std::conditional_t<DX, NoB, BStage<T>> bst;
  if constexpr (!DX) {
    bst.load(a, kt0, nt);
    bst.store(bbuf(0));
    if (kcount > 1) bst.load(a, kt0 + 1, nt);
    fence_async_shared();
    __syncthreads();
  }

  Acc<T, DX> acc;
#pragma unroll 1
  for (int i = 0; i < kcount; ++i) {
    const int s = i % slots;
    mbar_wait(full + s, (i / slots) & 1);   // k tile i's boxes have landed
    acc.issue(stage(s), bbuf(i));
    if constexpr (!DX) {   // under the tensor cores: the next B out, the one after in
      if (i + 1 < kcount) bst.store(bbuf(i + 1));
      if (i + 2 < kcount) bst.load(a, kt0 + i + 2, nt);
      fence_async_shared();
    }
    acc.finish(stage(s), bbuf(i));
    __syncthreads();   // slot s is consumed, the forward's next B is in place
    if (threadIdx.x == 0 && i + slots < kcount) {
      fence_async_shared();
      fetch(s, kt0 + i + slots);
    }
  }

  // The float32 tile over the dead ring; then each 16-byte chunk of the
  // output is written once: with splits, by one rank of the cluster, summed
  // over the ranks' tiles in rank order.
  fence_async_shared();
  float* tl = reinterpret_cast<float*>(smem);
  acc.to_tile(tl);
  namespace cg = cooperative_groups;
  if (a.splits > 1) cg::this_cluster().sync(); else __syncthreads();

  const int rs = a.R * a.S, nch = rs * G::CPR, per = (nch + a.splits - 1) / a.splits;
  const int c1 = min(nch, (split + 1) * per);
  for (int c = split * per + threadIdx.x; c < c1; c += THREADS) {
    const int p = c / G::CPR, cg16 = c % G::CPR;
    const int r = rt * a.R + p / a.S, j = ct * a.S + p % a.S;
    if (r >= a.rows || j >= a.width) continue;
    const int off = p * G::TP + cg16 * V;
    float v[V];
#pragma unroll
    for (int e = 0; e < V; e += 4) {
      float4 u[MAX_SPLIT];   // every rank's values in flight at once, then summed in rank order
      if (a.splits == 1) u[0] = *reinterpret_cast<const float4*>(tl + off + e);
#pragma unroll
      for (int z = 0; z < MAX_SPLIT; ++z)
        if (z < a.splits && a.splits > 1)
          u[z] = *reinterpret_cast<const float4*>(cg::this_cluster().map_shared_rank(tl + off + e, z));
      float4 s4 = u[0];
#pragma unroll
      for (int z = 1; z < MAX_SPLIT; ++z)
        if (z < a.splits) { s4.x += u[z].x; s4.y += u[z].y; s4.z += u[z].z; s4.w += u[z].w; }
      v[e] = s4.x; v[e + 1] = s4.y; v[e + 2] = s4.z; v[e + 3] = s4.w;
    }
    T* dst;
    if constexpr (DX) {
      dst = static_cast<T*>(a.out) + ((size_t)r * a.width + j) * a.cin + nt * BN + cg16 * V;
    } else {   // column run cg16 / QP is parity (di, dj) of V channels from o
      constexpr int QP = BN / 4 / V;
      const int par = cg16 / QP, o = nt * (BN / 4) + (cg16 % QP) * V;
      const int m = r * a.width + j, hw = a.H * a.W;
      const int n = m / hw, i = m % hw / a.W, jj = m % a.W;
      const size_t px = ((size_t)n * 2 * a.H + 2 * i + (par >> 1)) * 2 * a.W + 2 * jj + (par & 1);
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] += a.bias_f32 ? a.bias[o + e] : rnd<T>(a.bias[o + e]);
      dst = static_cast<T*>(a.out) + px * a.cout + o;
    }
    *reinterpret_cast<uint4*>(dst) = pack16<T>(v);
  }
  if (a.splits > 1) cg::this_cluster().sync();   // peers read this tile until here
}

// The M tiling of A's view (rows of width pixels), the K split and the
// ring's stages; false if the split leaves a block without k tiles.
inline bool plan(DcArgs& a, int n, int bn, int splits, int sms) {
  a.S = std::min(a.width, BM);
  a.R = std::min(a.rows, std::max(1, BM / a.width));
  a.ctiles = (a.width + a.S - 1) / a.S;
  a.mtiles = (a.rows + a.R - 1) / a.R * a.ctiles;
  a.ntiles = n / bn;
  a.splits = splits;
  a.kper = (a.ktiles + splits - 1) / splits;
  a.slots = std::min((long long)a.mtiles * a.ntiles * splits > 2 * sms ? 2 : STAGES, a.kper);
  return n % bn == 0 && splits >= 1 && splits <= MAX_SPLIT && (splits - 1) * a.kper < a.ktiles;
}

// dx's B: torch's w (cin, cout, 2, 2) float32 as wk (cin, 4, cout) in T,
// wk[c, par, o] = w[c, o, par]. Thread i reads w[c, o, :] (a float4:
// consecutive threads, consecutive 16 bytes) and writes one element of each
// parity's row (consecutive threads, consecutive elements).
template <typename T>
__global__ void dx_weight_kernel(const float4* __restrict__ w, T* __restrict__ wk, int cout,
                                 int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;   // c * cout + o
  if (i >= total) return;
  const float4 v = __ldg(w + i);
  T* dst = wk + (size_t)(i / cout) * 4 * cout + i % cout;
  dst[0] = from_f<T>(v.x);
  dst[cout] = from_f<T>(v.y);
  dst[2 * cout] = from_f<T>(v.z);
  dst[3 * cout] = from_f<T>(v.w);
}

inline int sm_count() {   // of the current device, read once
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 1;
  }
  return sms;
}

// One launch over n columns in `splits` K splits; A given as a 4-D view for
// its TMA map.
template <typename T, bool DX>
cudaError_t launch(DcArgs a, int n, int splits, const void* src, const cuuint64_t dims[4],
                   const cuuint64_t strides[3], cudaStream_t s) {
  using G = Geo<T, DX>;
  constexpr int BN = G::BN;
  if (!plan(a, n, BN, splits, sm_count())) return cudaErrorInvalidValue;
  const cuuint32_t box[4] = {(cuuint32_t)G::CH, (cuuint32_t)a.S, 1, (cuuint32_t)a.R};
  if (!wgrad::tensor_map4(&a.amap,
                          G::BF ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                          src, dims, strides, box,
                          G::BF ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  if (DX) {   // B: wk as (cin, 4 cout), CH k of BN rows a box
    const cuuint64_t wdims[4] = {4ull * a.cout, (cuuint64_t)a.cin, 1, 1};
    const cuuint64_t row = 4ull * a.cout * sizeof(T), wstrides[3] = {row, row * a.cin, row * a.cin};
    const cuuint32_t wbox[4] = {(cuuint32_t)G::CH, BN, 1, 1};
    if (!wgrad::tensor_map4(&a.wmap, G::BF ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                           : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                            a.wk, wdims, wstrides, wbox, CU_TENSOR_MAP_SWIZZLE_128B))
      return cudaErrorInvalidValue;
  }
  const size_t smem = G::smem(a.slots);
  cudaError_t err = cudaFuncSetAttribute(deconv_gemm<T, DX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.mtiles * a.ntiles * a.splits), block(THREADS);
  if (a.splits == 1) {
    deconv_gemm<T, DX><<<grid, block, smem, s>>>(a);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = a.splits;
  attr.val.clusterDim.y = attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, deconv_gemm<T, DX>, a);
}

}  // namespace
}  // namespace deconv

// dtype: 0 = float32, 1 = bfloat16. x (N, H, W, cin) in that dtype; w
// torch's (cin, cout, 2, 2) float32, as it lies; b (cout,) float32, added
// rounded to the dtype (bias_f32 = 0: the trainer's) or as it is (1: the
// decoder level's); out (N, 2H, 2W, cout). Returns a cudaError_t (0 on
// success).
extern "C" int deconv_launch(int dtype, const void* x, const float* w, const float* b, void* out,
                             int N, int H, int W, int cin, int cout, int bias_f32,
                             void* stream) {
  using namespace deconv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cin % BK || cout % C || N < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  DcArgs a{};
  a.w = w; a.bias = b; a.bias_f32 = bias_f32; a.out = out; a.H = H; a.W = W; a.cin = cin;
  a.cout = cout; a.rows = 1; a.width = N * H * W; a.ktiles = cin / BK;
  const cuuint64_t es = dtype == 0 ? 4 : 2, px = (cuuint64_t)a.width;
  const cuuint64_t dims[4] = {(cuuint64_t)cin, px, 1, 1};
  const cuuint64_t strides[3] = {cin * es, px * cin * es, px * cin * es};
  if (dtype == 0) return launch<float, false>(a, 4 * cout, 1, x, dims, strides, s);
  if (dtype == 1) return launch<__nv_bfloat16, false>(a, 4 * cout, 1, x, dims, strides, s);
  return (int)cudaErrorInvalidValue;
}

// dx (N, H, W, cin) of g (N, 2H, 2W, cout), both in dtype; wk = torch's
// (cin, cout, 2, 2) w as (cin, 4, cout) in dtype (each c's row in K order,
// k = par * cout + o); splits from deconv_plan.
extern "C" int deconv_dx_launch(int dtype, const void* g, const void* wk, void* dx, int N, int H,
                                int W, int cin, int cout, int splits, void* stream) {
  using namespace deconv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cin % C || cout % C || N < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  DcArgs a{};
  a.wk = wk; a.out = dx; a.H = H; a.W = W; a.cin = cin; a.cout = cout;
  a.rows = N * H; a.width = W; a.ktiles = 4 * cout / BK;
  // g as (2 cout, W, 2, N H): (dj, o) contiguous, then the pixel pairs, the
  // row parity di and the row pairs
  const cuuint64_t es = dtype == 0 ? 4 : 2, k = 2ull * cout;
  const cuuint64_t dims[4] = {k, (cuuint64_t)W, 2, (cuuint64_t)a.rows};
  const cuuint64_t strides[3] = {k * es, k * W * es, 2 * k * W * es};
  if (dtype == 0) return launch<float, true>(a, cin, splits, g, dims, strides, s);
  if (dtype == 1) return launch<__nv_bfloat16, true>(a, cin, splits, g, dims, strides, s);
  return (int)cudaErrorInvalidValue;
}

// wk (cin, 4, cout) in dtype of w (cin, cout, 2, 2) float32, dx's B.
extern "C" int deconv_dx_weight_launch(int dtype, const float* w, void* wk, int cin, int cout,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int total = cin * cout, blocks = (total + 255) / 256;
  const float4* w4 = reinterpret_cast<const float4*>(w);
  if (dtype == 0)
    deconv::dx_weight_kernel<float><<<blocks, 256, 0, s>>>(w4, static_cast<float*>(wk), cout, total);
  else if (dtype == 1)
    deconv::dx_weight_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(
        w4, static_cast<__nv_bfloat16*>(wk), cout, total);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// out = dw (cin, cout, 2, 2) then db (cout,), float32, of x (N, H, W, cin)
// and g (N, 2H, 2W, cout); chunks, per_chunk and reduce (0 one chunk, 1 a
// cluster, 2 the grid) from wgrad_plan; for a grid reduce, part (chunks, 4
// cin cout + cout) float32 scratch and bar two unsigned counters, zero, that
// the launch leaves zero (both null otherwise).
extern "C" int deconv_dwdb_launch(int dtype, const void* x, const void* g, float* part,
                                  unsigned* bar, float* out, int N, int H, int W, int cin,
                                  int cout, int chunks, int per_chunk, int reduce,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cin % common::C) return (int)cudaErrorInvalidValue;
  wgrad::WgArgs a{};
  a.x = x; a.g = g; a.cx = a.cin = cin; a.cg = cout; a.N = N; a.H = H; a.W = W;
  a.mtiles = cin / common::C; a.ntiles = cout / 32;
  a.items = (int)(((long long)N * H * W + wgrad::STEP - 1) / wgrad::STEP);
  a.chunks = chunks; a.per_chunk = per_chunk; a.reduce = reduce;
  a.dw_size = 4 * cin * cout; a.stride = a.dw_size + cout; a.out = out; a.part = part; a.bar = bar;
  if (dtype == 0) return wgrad::launch_wgrad<float, 1>(a, s);
  if (dtype == 1) return wgrad::launch_wgrad<__nv_bfloat16, 1>(a, s);
  return (int)cudaErrorInvalidValue;
}
