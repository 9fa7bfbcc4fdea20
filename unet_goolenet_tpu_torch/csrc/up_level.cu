// One decoder level after its gate pass (up1, up2, up3, up4):
//     up    = convT2x2(x) + b_up                        (N, H, W, C)
//     d2    = relu(conv3x3(up) + b_d2)
//     gated = e1 + (1 + gate) * d2
//     hh    = relu(conv3x3(concat[up, gated]) + b_pair)  (N, H, W, cq)
//     out   = relu(conv3x3(hh) + b_blk1)                (N, H, W, cq)
// and, for up1, the 1x1 head: logits = out @ w_outc + b_outc, in place of out.
//
// Replaces: unet_goolenet_tpu/ops/pallas/up2.py:_up2_kernel, behind both
// fused_up2 (up2; its packed output is a TPU layout) and fused_up_dense
// (up3, up4), through the up_level wrapper; and
// unet_goolenet_tpu/ops/pallas/up1.py:fused_up1_outc (up1 + head), through
// the up1_tail wrapper. (C, cq) = (64, 64) with the head, (128, 64),
// (256, 128), (512, 256) at the model's levels; any multiples of 64 here,
// and any even H, W.
//
// Bound on an H100, per 224^2 image: 0.41 (deconv) + 3.70 (d2) + 3.70
// (pair) + 0.92 (block1) = 8.73 GFLOP at up2-up4, 15.2 GFLOP at up1 (its
// pair and block1 run at 224^2), against ~10-20 MB moved in bf16 (x, e1
// read, out written): the tensor-core work bounds it, ~0.141 ms a level at
// batch 16 in bf16, ~0.246 ms at up1.
//
// bf16: four launches, on the two TMA + wgmma GEMMs of the trainer, with
// the weights laid out once when the model is folded (no layout launch a
// call):
//   1. deconv.cu's deconv_gemm (through deconv_launch): up, the transposed
//      conv as one GEMM over flattened input pixels, depth-to-space in the
//      epilogue's addressing, torch's float32 w_up read as it lies, b_up
//      added in float32 (bias_f32), as the TPU kernel keeps it.
//   2. conv3x3.cuh's conv3x3_gemm, GATE epilogue: d2 over up, then gated =
//      e1 + round((1 + gate) * round(d2)); writes gated.
//   3. conv3x3_gemm, PAIR: the pair conv over concat[up, gated], its K
//      slabs read from two tensor maps (up's C/64, then gated's), so the
//      concatenation is never copied and the split sum is plain K; writes hh.
//   4. conv3x3_gemm, AFFINE with relu (the trainer's kernel): block1 over
//      hh; writes out. With the head, HEAD instead: the block's 64 channels
//      are the whole of out, so the head runs in the epilogue and only the
//      logits are written.
// The convs' weights are (9, cout, cin) bf16 (wk[tap][co][ci], conv.cu's
// bf16 layout), the head's (64, ncls) bf16. Tiles and K splits of the three
// conv launches come from ops/kernels/conv.py:level_plan (conv_plan's, one
// a launch), passed in as 15 ints.
// Why four launches and not the TPU kernel's one: the TPU holds up, d2,
// gated and hh of a row tile in up to 100 MB of VMEM; a block here has
// 227 KB. Each conv needs its input over a halo at all of its input
// channels (d2 and the pair conv: up at C channels, 10 x 16 pixels for an
// 8x14 tile, 160 KB in bf16 at C = 512), and a level's weights run to
// 4.7 MB, so each conv streams 64-channel halo slabs and one weight tap a K
// tile, and each stage waits for the whole of the one before. Joining the
// deconv into launch 2 would recompute it for each output-channel tile over
// the halo, (C/BN) x 1.4 times its work, to save the deconv's launch.
// So up, gated and hh go through device memory (at batch 16 each is 103 MB
// at up1 and 51 MB at up2-up4, beyond the 50 MB L2).
// up, gated and hh are rounded to bf16 and biases stay float32, as in the
// TPU kernels, so kernel and plain version differ only in summation order.
// Shared memory a block: the deconv 96 KB (64 KB with its 2-stage ring),
// conv3x3_gemm 214 KB (128-column tiles) or 202 KB (64).
//
// float32: four launches of dense_conv.cuh's conv_kernel (FMA, 8x16-pixel
// tiles, 64-output-channel blocks, 65 KB a block), with the weights in its
// blocked layouts: DECONV (the transposed conv as a 1x1 conv with 4C
// outputs, scattered to the four output parities), GATE, RELU over both
// sources' slabs (the pair), then RELU or HEAD.
#include "conv3x3.cuh"

// csrc/deconv.cu
extern "C" int deconv_launch(int dtype, const void* x, const float* w, const float* b, void* out,
                             int N, int H, int W, int cin, int cout, int bias_f32, void* stream);

static cudaError_t level_f32(const void* x, const void* e1, const void* g1p, const void* wup,
                             const float* bup, const void* wd2, const float* bd2,
                             const void* wpair, const float* bpair, const void* wblk1,
                             const float* bblk1, const void* wout, const float* bout, int ncls,
                             void* up, void* gated, void* hh, void* out, int N, int H, int W,
                             int C, int cq, cudaStream_t s) {
  using namespace dense;
  constexpr int B = common::C;
  ConvArgs a{};
  a.src0 = x; a.c0 = C; a.cin = C; a.w = wup; a.b = bup; a.out = up; a.cout = C;
  a.H = H / 2; a.W = W / 2;
  cudaError_t err = launch<float, 1, DENSE, DECONV>(a, N, 4 * C / B, s);
  if (err != cudaSuccess) return err;

  a = ConvArgs{};
  a.src0 = up; a.c0 = C; a.cin = C; a.w = wd2; a.b = bd2; a.out = gated; a.cout = C;
  a.H = H; a.W = W; a.e1 = e1; a.g1p = g1p;
  err = launch<float, 3, DENSE, GATE>(a, N, C / B, s);
  if (err != cudaSuccess) return err;

  a = ConvArgs{};
  a.src0 = up; a.src1 = gated; a.c0 = C; a.cin = 2 * C; a.w = wpair; a.b = bpair; a.out = hh;
  a.cout = cq; a.H = H; a.W = W;
  err = launch<float, 3, DENSE, RELU>(a, N, cq / B, s);
  if (err != cudaSuccess) return err;

  a.src0 = hh; a.src1 = nullptr; a.c0 = cq; a.cin = cq; a.w = wblk1; a.b = bblk1; a.out = out;
  if (ncls == 0) return launch<float, 3, DENSE, RELU>(a, N, cq / B, s);
  a.wout = wout; a.bout = bout; a.ncls = ncls;
  return launch<float, 3, DENSE, HEAD>(a, N, 1, s);
}

// One bf16 conv3x3_gemm launch with epilogue EPI over a's sources (src, and
// src2 for PAIR), weights wk (9, cout, cin); p = (R, S, bn, splits,
// clusters) from level_plan. a holds H, W, C, slabs and the epilogue's
// operands.
template <int EPI>
static cudaError_t level_conv(conv3::Args a, const int* p, const void* src, const void* src2,
                              int N, const void* wk, int cin, int cout, cudaStream_t s) {
  using namespace conv3;
  a.ncols = cout;
  a.relu = 1;
  if (!plan_tiles(a, N, p[0], p[1], p[2], p[3], p[4]) || (EPI == HEAD && a.splits != 1))
    return cudaErrorInvalidValue;   // the head's 64 input channels are one K slab
  if (p[2] == 64) return launch<64, false, 2, 4, EPI>(a, src, N, wk, cin, cout, s, src2);
  if constexpr (EPI != HEAD)
    return launch<128, false, 1, 4, EPI>(a, src, N, wk, cin, cout, s, src2);
  return cudaErrorInvalidValue;   // the head takes 64-column tiles
}

static cudaError_t level_bf16(const void* x, const void* e1, const void* g1p, const float* wup,
                              const float* bup, const void* wd2, const float* bd2,
                              const void* wpair, const float* bpair, const void* wblk1,
                              const float* bblk1, const void* wout, const float* bout, int ncls,
                              void* up, void* gated, void* hh, void* out, int N, int H, int W,
                              int C, int cq, const int* plan, cudaStream_t s) {
  using namespace conv3;
  cudaError_t err = (cudaError_t)deconv_launch(1, x, wup, bup, up, N, H / 2, W / 2, C, C, 1, s);
  if (err != cudaSuccess) return err;

  Args a{};
  a.H = H; a.W = W; a.C = C; a.slabs = C / BK; a.bias = bd2; a.out = gated;
  a.e1 = e1; a.g1p = g1p;
  err = level_conv<GATE>(a, plan, up, nullptr, N, wd2, C, C, s);
  if (err != cudaSuccess) return err;

  a = Args{};
  a.H = H; a.W = W; a.C = C; a.slabs = 2 * C / BK; a.c0slabs = C / BK; a.bias = bpair;
  a.out = hh;
  err = level_conv<PAIR>(a, plan + 5, up, gated, N, wpair, 2 * C, cq, s);
  if (err != cudaSuccess) return err;

  a = Args{};
  a.H = H; a.W = W; a.C = cq; a.slabs = cq / BK; a.bias = bblk1; a.out = out;
  if (ncls == 0) return level_conv<AFFINE>(a, plan + 10, hh, nullptr, N, wblk1, cq, cq, s);
  a.wout = wout; a.bout = bout; a.ncls = ncls;
  return level_conv<HEAD>(a, plan + 10, hh, nullptr, N, wblk1, cq, cq, s);
}

// dtype: 0 = float32, 1 = bfloat16. H, W: output (= 2x input) size; x is
// (N, H/2, W/2, C), e1 (N, H, W, C), g1p (N, C); up and gated (N, H, W, C)
// and hh (N, H, W, cq) are scratch. ncls = 0: out is (N, H, W, cq) and wout,
// bout are unused; ncls > 0 (cq = 64): wout (cq, ncls), bout (ncls,), and out
// is the logits (N, H, W, ncls). Weights: bf16 wup torch's (C, C, 2, 2)
// float32, wd2, wpair, wblk1 (9, cout, cin) bf16, and plan the three conv
// launches' (R, S, bn, splits, clusters); float32 the blocked layouts of
// dense_conv.cuh (wup as a 1x1 conv with 4C outputs), plan unused. Biases
// float32. Returns a cudaError_t (0 on success).
extern "C" int up_level_launch(int dtype, const void* x, const void* e1, const void* g1p,
                               const void* wup, const float* bup, const void* wd2,
                               const float* bd2, const void* wpair, const float* bpair,
                               const void* wblk1, const float* bblk1, const void* wout,
                               const float* bout, int ncls, void* up, void* gated, void* hh,
                               void* out, int N, int H, int W, int C, int cq, const int* plan,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C % common::C || cq % common::C || (ncls > 0 && cq != common::C))
    return (int)cudaErrorInvalidValue;   // the head needs one 64-channel block
  if (dtype == 0)
    return level_f32(x, e1, g1p, wup, bup, wd2, bd2, wpair, bpair, wblk1, bblk1, wout, bout,
                     ncls, up, gated, hh, out, N, H, W, C, cq, s);
  if (dtype == 1 && plan)
    return level_bf16(x, e1, g1p, static_cast<const float*>(wup), bup, wd2, bd2, wpair, bpair,
                      wblk1, bblk1, wout, bout, ncls, up, gated, hh, out, N, H, W, C, cq, plan,
                      s);
  return (int)cudaErrorInvalidValue;
}
