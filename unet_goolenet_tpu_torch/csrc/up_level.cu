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
// Design: four launches of dense_conv.cuh's conv_kernel, each stage's output
// in device memory (mostly in the 50 MB L2 at batch 16).
//   1. DECONV: the transposed conv as a 1x1 conv with 4C outputs, scattered
//      to the four output parities; writes up.
//   2. GATE: d2 over up, then gated = e1 + round((1 + gate) * round(d2));
//      writes gated.
//   3. RELU: the pair conv over concat[up, gated] as one float32 sum over
//      both tensors' slabs (the split sum; up's share stays float32 until
//      the sum); writes hh.
//   4. RELU: block1 over hh; writes out. With the head, HEAD instead: the
//      block's 64 channels are the whole of out, so the head runs in the
//      epilogue and only the logits are written.
// Why four launches and not the TPU kernel's one: the TPU holds up, d2,
// gated and hh of a row tile in up to 100 MB of VMEM; a block here has
// 227 KB. Each conv needs its input over a halo at all of its input
// channels (d2 and the pair conv: up at C channels, 14 x 22 pixels for an
// 8x16 tile, 315 KB in bf16 at C = 512), and a level's weights run to
// 4.7 MB, so each conv streams 64-channel input slabs and 64 x 64-per-tap
// weight blocks, and each stage waits for the whole of the one before.
// Joining two stages in one launch means recomputing the earlier one per
// 64-channel output block over the halo: for the cheapest join, the deconv
// into launch 2, (C/64) x 1.4 times the deconv's work, 2.8x at up2 and
// 11x at up4, to save a launch that takes 11-15% of the level (measured
// split in PERF.md). A whole level does not fit on chip at up2 either: an
// 8x16 tile's up over a +-3 halo (14 x 22 x 128), gated over +-2 and hh over
// +-1 take 163 KB in bf16, and the nine taps of one 64 x 64 weight slab
// 74 KB more, 237 KB against 227; staging one tap at a time would fit, but
// cost 2.2x in time on the earlier up1 kernel (PERF.md). Keeping a whole
// level on chip, as that up1 kernel did at C = 64 with an 8x16 tile and a
// +-3 halo (up, gated and h in 183 KB bf16), took 1.7x as long as these four
// launches for the same up1 level and head: 2.554 against 1.495 ms in bf16
// at batch 16 (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
// up, gated and hh are rounded to the activation type and biases stay
// float32, as in the TPU kernels, so kernel and plain version differ only
// in summation order. Shared memory: 110 KB (bf16) / 65 KB (float) per
// block.
#include "dense_conv.cuh"

template <typename T>
static cudaError_t launch_level(const void* x, const void* e1, const void* g1p, const void* wup,
                                const float* bup, const void* wd2, const float* bd2,
                                const void* wpair, const float* bpair, const void* wblk1,
                                const float* bblk1, const void* wout, const float* bout,
                                int ncls, void* up, void* gated, void* hh, void* out, int N,
                                int H, int W, int C, int cq, cudaStream_t s) {
  using namespace dense;
  constexpr int B = common::C;
  if (ncls > 0 && cq != B) return cudaErrorInvalidValue;   // the head needs one block
  ConvArgs a{};
  a.src0 = x; a.c0 = C; a.cin = C; a.w = wup; a.b = bup; a.out = up; a.cout = C;
  a.H = H / 2; a.W = W / 2;
  cudaError_t err = launch<T, 1, DENSE, DECONV>(a, N, 4 * C / B, s);
  if (err != cudaSuccess) return err;

  a = ConvArgs{};
  a.src0 = up; a.c0 = C; a.cin = C; a.w = wd2; a.b = bd2; a.out = gated; a.cout = C;
  a.H = H; a.W = W; a.e1 = e1; a.g1p = g1p;
  err = launch<T, 3, DENSE, GATE>(a, N, C / B, s);
  if (err != cudaSuccess) return err;

  a = ConvArgs{};
  a.src0 = up; a.src1 = gated; a.c0 = C; a.cin = 2 * C; a.w = wpair; a.b = bpair; a.out = hh;
  a.cout = cq; a.H = H; a.W = W;
  err = launch<T, 3, DENSE, RELU>(a, N, cq / B, s);
  if (err != cudaSuccess) return err;

  a.src0 = hh; a.src1 = nullptr; a.c0 = cq; a.cin = cq; a.w = wblk1; a.b = bblk1; a.out = out;
  if (ncls == 0) return launch<T, 3, DENSE, RELU>(a, N, cq / B, s);
  a.wout = wout; a.bout = bout; a.ncls = ncls;
  return launch<T, 3, DENSE, HEAD>(a, N, 1, s);
}

// dtype: 0 = float32, 1 = bfloat16. H, W: output (= 2x input) size; x is
// (N, H/2, W/2, C), e1 (N, H, W, C), g1p (N, C); up and gated (N, H, W, C)
// and hh (N, H, W, cq) are scratch. ncls = 0: out is (N, H, W, cq) and wout,
// bout are unused; ncls > 0 (cq = 64): wout (cq, ncls), bout (ncls,), and out
// is the logits (N, H, W, ncls). Returns a cudaError_t (0 on success).
extern "C" int up_level_launch(int dtype, const void* x, const void* e1, const void* g1p,
                               const void* wup, const float* bup, const void* wd2,
                               const float* bd2, const void* wpair, const float* bpair,
                               const void* wblk1, const float* bblk1, const void* wout,
                               const float* bout, int ncls, void* up, void* gated, void* hh,
                               void* out, int N, int H, int W, int C, int cq, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_level<float>(x, e1, g1p, wup, bup, wd2, bd2, wpair, bpair, wblk1, bblk1, wout,
                               bout, ncls, up, gated, hh, out, N, H, W, C, cq, s);
  if (dtype == 1)
    return launch_level<__nv_bfloat16>(x, e1, g1p, wup, bup, wd2, bd2, wpair, bpair, wblk1,
                                       bblk1, wout, bout, ncls, up, gated, hh, out, N, H, W, C,
                                       cq, s);
  return (int)cudaErrorInvalidValue;
}
