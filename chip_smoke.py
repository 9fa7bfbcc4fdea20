"""Drive the PyTorch/CUDA port's serving and training paths once on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (the first failure exits non-zero):
  1. device: CUDA must be available; the card's name and power limit.
  2. build: compile the CUDA kernels from unet_goolenet_tpu_torch/csrc; the
     trainer's conv3x3_gemm instantiations (csrc/conv.cu) must use
     TRAINER_GEMM_REGISTERS registers, as ptxas reports them.
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the main path's shapes for N=4 at 224^2 (up1: x1 4x224x224x64, y
     4x112x112x64; pool_down1: x1 4x224x224x64; up_gate_dense and up_level at
     up2, up3 and up4: (C, cq) = (128, 64) at 112^2, (256, 128) at 56^2,
     (512, 256) at 28^2) in float32 (TF32 off) and bfloat16, and at a ragged
     level (up1 36x52, pool_down1 x1 40x56; the others C = 256 at 20x28);
     the bf16 gates (up1_gate, up_gate_dense), up1_tail, up_level and
     pool_down1 also against a second call, bit for bit.
  4. e2e, default configuration: 8 seeded gray PNGs (400x500 and 360x480)
     and two seeded reference-named checkpoints through `apps.infer_e2e.main`,
     bf16 then float32; result.txt must hold 8 grades in [0, 6) and both up1
     kernels must have launched. Then, in float32, the pipeline (kernel path)
     against the plain composition (engine.unet_trunk + engine.up1_plain) on
     4 images, with the classifier's fc bias centred on them so that they get
     at least 2 distinct grades: equal grades, seg logits within SEG_TOL of
     the largest |logit|, masks differing only where |logit| < 1e-3.
  5. e2e, all-fused configuration (fused_up2, fused_up34, fused_down1: the
     stage-2 trainer's ROI extractor runs it): the same float32 check of
     TwoStagePipeline against the plain composition, then one bf16 batch-16
     call of apps.train_cls.make_roi_extractor(fused=True); all five
     kernels' counters, set to 0 just before, must be > 0.
  6. timing (CUDA events, after warm-up): infer_grades images/s at batch 16
     and 64 in bf16 and float32 (median of 7 rounds), the default, all-fused
     and up2 + down1 configurations in turns (forwards, then backwards);
     each kernel at batch 16 against its plain version and the default
     configuration's cuDNN path for the same work, with its bound; the bf16
     gate and level kernels' device time and launches by stage (the gate:
     the conv with its statistics' partials, then their reduce; the level:
     deconv, d2 + gate combine, pair conv, block1 or block1 + head; told
     apart by kernel name) at up1 and each dense level, and pool_down1's
     (the pool, the first conv, the second, told apart by launch order),
     from a profiler trace, which must hold one launch a stage (a gate call
     two in all, a pool_down1 call three) and no weight layout; the 2x2 max
     pool at the serving shape x1 16x224x224x64 against its plain version
     and max_pool2d, device time from one trace, with its bound; a per-layer
     split of one bf16
     batch-64 call; host time per bf16
     call at batch 16 and 64, and one profiler trace of each, and of one
     all-fused bf16 batch-64 call (device busy vs wall, host syncs, top
     kernels).
  7. training kernels: kernels 6-9 (fused conv3x3 forward, its dx
     (conv3x3_dx) and its weight gradient; the conv-stack pair; the 2x2
     transposed conv, its dx and dW/db; the 2x2 max pool and its backward)
     against their plain versions in float32 (TF32 off) and bfloat16, at
     every conv, pair, deconv and pool shape of the trainer at batch 4 and
     224^2, and at the edges of the plans at batch 2: a ragged 20x28 level,
     cin = 3 on a ragged 36x52 image (dx: 3 output channels), 14x14
     512->512 (the weight gradient in one chunk, the bf16 forward and dx
     with K split) and 28x28 1024->256 (the widest); and of the transposed
     conv's tiles: a ragged 10x14 level, 3x5x7 (fewer pixels than an M
     tile), 1x3x3 (smaller than a tile's row) and 7x9 512->256 (cin !=
     cout). conv3x3_dw, deconv2x2_dwdb and the conv's forward and dx run
     twice on the same inputs and must give the same bits; the weight
     gradients are held, as their plain versions are measured, against the
     plain version in float64.
  8. training, the main path of this slice: 12 seeded PNGs (8 train, 4 val,
     400x500 with a lesion mask) through `apps.train_seg.main --kernels`
     for two epochs in bf16; every new kernel's counter, set to 0 just
     before, must be > 0, the losses finite and the best checkpoint must
     reload. Then one full-width 224^2 batch-4 train step and eval step in
     float32 with the kernels and on the stock path, both measured against
     the stock path in float64 from the same weights and batch: pass 0's
     loss and gradients, the batch statistics and parameters after the
     step, the eval loss. The kernel path may be no further from float64
     than three times the stock path plus a floor (TRAIN_TOL), over all
     leaves and leaf by leaf; the leaves whose gradient is zero
     analytically are left out of the gradients and the parameters.
  9. training timing: ms per train step and per eval step, kernels and
     stock, bf16 and float32, in turns; one profiled bf16 step each way
     (device busy, idle share, launches); each training kernel at the
     trainer's shapes against its plain version and the cuDNN call for the
     same work (F.conv2d, conv2d_input, conv2d_weight, conv_transpose2d and
     its gradients, max_pool2d and its backward; the dW/db's yardstick is
     conv2d_weight and the sum of the output gradient for db), with its
     bound and, for the weight gradients, the plan's partial bytes, for the
     conv's and the transposed conv's forward and dx their tiles, splits,
     device launches a call and ratio to the library call: device time, all of it from one
     profiler trace (the steps are host-bound, so CUDA events around
     back-to-back calls measure the host), and the wall time beside; and
     the profiled bf16 step's launches, both paths side by side.
Then a JSON line of the kernels, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Weights and images are random, made from seeds; nothing is downloaded.
Scratch files go to build/chip_smoke/ beside this script.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
from functools import partial
from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
SEED = 0
# kernel vs plain, as a fraction of the plain result's max |value|: float32
# differs only in summation order; bf16 rounds every stage at the same points
# in both, so one summation-order flip moves a value by a bf16 step (2^-8)
KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# float32 kernel path vs plain composition, seg logits as a fraction of the
# largest |logit|: the same bound as the kernels' own float32 check
SEG_TOL = 1e-4
# serving kernels: wrapper -> (source, the TPU kernel it replaces); pool_down1's
# down1.cu runs, in bf16, pool.cuh's pool and conv3x3.cuh's GEMM twice
KERNELS = {
    "up1_gate": ("unet_goolenet_tpu_torch/csrc/conv3x3.cuh",
                 "unet_goolenet_tpu/ops/pallas/up1.py:480"),
    "up1_tail": ("unet_goolenet_tpu_torch/csrc/up_level.cu",
                 "unet_goolenet_tpu/ops/pallas/up1.py:521"),
    "pool_down1": ("unet_goolenet_tpu_torch/csrc/down1.cu",
                   "unet_goolenet_tpu/ops/pallas/down1.py:108"),
    "up_gate_dense": ("unet_goolenet_tpu_torch/csrc/conv3x3.cuh",
                      "unet_goolenet_tpu/ops/pallas/up2.py:126"),
    "up_level": ("unet_goolenet_tpu_torch/csrc/up_level.cu",
                 "unet_goolenet_tpu/ops/pallas/up2.py:299"),
}
FUSED = dict(fused_up2=True, fused_up34=True, fused_down1=True)
# the configurations timed end to end: the default, all-fused, and the levels
# whose kernels beat the default path alone (up2, pool + down1)
CONFIGS = {"default": {}, "fused": FUSED, "up2_down1": dict(fused_up2=True, fused_down1=True)}
# the decoder levels up2, up3, up4 at 224^2: (output size, C, cq)
LEVELS = ((112, 128, 64), (56, 256, 128), (28, 512, 256))
# kernels 6-9 of the training path: wrapper -> (source, the TPU kernel it replaces)
TRAIN_KERNELS = {
    "fused_conv3x3": ("unet_goolenet_tpu_torch/csrc/conv3x3.cuh",
                      "unet_goolenet_tpu/ops/pallas/conv.py:177"),
    "conv3x3_dx": ("unet_goolenet_tpu_torch/csrc/conv3x3.cuh",
                   "unet_goolenet_tpu/ops/pallas/conv.py:190"),
    "conv3x3_dw": ("unet_goolenet_tpu_torch/csrc/conv_dw.cuh",
                   "unet_goolenet_tpu/ops/pallas/conv.py:132"),
    "fused_convstack2": ("unet_goolenet_tpu_torch/csrc/conv3x3.cuh",
                         "unet_goolenet_tpu/ops/pallas/conv.py:277"),
    "deconv2x2": ("unet_goolenet_tpu_torch/csrc/deconv.cu",
                  "unet_goolenet_tpu/ops/pallas/conv.py:334"),
    "deconv2x2_dx": ("unet_goolenet_tpu_torch/csrc/deconv.cu",
                     "unet_goolenet_tpu/ops/pallas/conv.py:393"),
    "deconv2x2_dwdb": ("unet_goolenet_tpu_torch/csrc/conv_dw.cuh",
                       "unet_goolenet_tpu/ops/pallas/conv.py:399"),
    "max_pool2x2": ("unet_goolenet_tpu_torch/csrc/pool.cu",
                    "unet_goolenet_tpu/ops/pallas/conv.py:476"),
    "max_pool2x2_bwd": ("unet_goolenet_tpu_torch/csrc/pool.cu",
                        "unet_goolenet_tpu/ops/pallas/conv.py:503"),
}
# the trainer's 3x3 convs that feed a BatchNorm at 224^2: (size, cin, cout,
# calls per forward), 27 in all; the first is inc, whose dx is never taken
UNET_CONVS = ((224, 3, 64, 1), (112, 64, 128, 1), (112, 128, 128, 3), (56, 128, 256, 1),
              (56, 256, 256, 3), (28, 256, 512, 1), (28, 512, 512, 3), (14, 512, 512, 4),
              (28, 1024, 256, 1), (28, 256, 256, 1), (56, 512, 128, 1), (56, 128, 128, 1),
              (112, 256, 64, 1), (112, 64, 64, 1), (224, 64, 64, 3), (224, 128, 64, 1))
# the eval step's conv-stack pairs (size, cin, cmid = cout), one call each
UNET_PAIRS = ((112, 64, 128), (56, 128, 256), (28, 256, 512), (14, 512, 512), (28, 1024, 256),
              (56, 512, 128), (112, 256, 64), (224, 128, 64))
# transposed convs (input size, C) and pools (input size, C), one call each
UNET_DECONVS = ((14, 512), (28, 256), (56, 128), (112, 64))
UNET_POOLS = ((224, 64), (112, 128), (56, 256), (28, 512))
# one float32 train step at 224^2, batch 4, kernels and stock, each measured
# against the stock path in float64 (errors_to): every error of the kernel
# path may be at most `ratio` times the stock path's plus `floor`, over all
# leaves and leaf by leaf (a leaf is held to the larger of its own stock
# error and the whole's, since a leaf's share of the rounding varies). The
# floors: pass 0's loss and the eval loss are well conditioned; the step's
# loss and parameters pass through AdamW's first update, lr * ~sign(g),
# which turns rounding in small gradients into whole-lr moves (the float32
# stock path read 1.1e-6 from float64 in the step's loss on the card, the
# kernel path 1.2e-5; PERF.md). `zero` is the share of the largest float64
# gradient below which a leaf counts as zero analytically (the conv biases
# ahead of BatchNorm, which AdamW moves by lr * sign(rounding noise)); such
# leaves are left out of the gradients and the parameters
TRAIN_TOL = dict(ratio=3.0, zero=1e-10,
                 floor=dict(loss0=1e-6, loss=1e-4, eval_loss=1e-5, grad=1e-4, stats=1e-4,
                            params=1e-3))
# H100 SXM data-sheet peaks (dense): bf16 tensor cores, float32 FMA (the
# kernels' float32 route), and device memory
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def trace_device_ms(fns: dict, reps: int = 5, launches: dict = None) -> dict:
    """Mean device milliseconds per call of each fns[label], all from one
    profiler trace: the device time of every kernel and copy the call
    launches. Unlike cuda_ms it leaves out the gaps in which the device
    waits for the host, which dominate a call that launches small kernels
    from Python. After one warm-up call of each, each fn is called reps
    times inside record_function(label). A device event belongs to the
    label whose host range holds the runtime call that launched it (the two
    share a correlation id), so host and device clocks are never compared.
    The trace may lose the device events of the first calls after it starts
    (one run lost the first label's), so it starts with one unlabelled call
    of the first fn, whose device time counts as unattributed.
    Fails if a label holds no device time. If `launches` is given, it
    receives each label's device events (kernels and copies) per call."""
    import bisect

    from torch.profiler import ProfilerActivity, profile, record_function

    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        next(iter(fns.values()))()
        torch.cuda.synchronize()
        for label, fn in fns.items():
            with record_function(label):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    on_device = [str(k.device_type()).endswith("CUDA") for k in events]
    spans = sorted((k.start_ns(), k.start_ns() + k.duration_ns(), k.name())
                   for k, dev in zip(events, on_device) if not dev and k.name() in fns)
    starts = [sp[0] for sp in spans]
    # the CUDA API calls that launch work (cudaLaunchKernel, cudaMemcpyAsync, ...)
    launched = {k.correlation_id(): k.start_ns() for k, dev in zip(events, on_device)
                if not dev and k.name().startswith("cu")}
    ns, count, lost = dict.fromkeys(fns, 0), dict.fromkeys(fns, 0), 0
    for k, dev in zip(events, on_device):
        if not dev or k.name() in fns:
            continue        # host events, and the device-side copies of the ranges
        t = launched.get(k.correlation_id())
        i = -1 if t is None else bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= spans[i][1]:
            ns[spans[i][2]] += k.duration_ns()
            count[spans[i][2]] += 1
        else:
            lost += k.duration_ns()
    empty = [label for label, t in ns.items() if t <= 0]
    say("timing", what="trace", labels=len(fns), calls_per_label=reps,
        device_ms=f"{sum(ns.values()) / 1e6:.3f}", device_ms_unattributed=f"{lost / 1e6:.3f}")
    if empty:
        fail(f"the trace holds no device time for {len(empty)} of {len(fns)} calls, "
             f"e.g. {empty[:3]}")
    if launches is not None:
        launches.update({label: c / reps for label, c in count.items()})
    return {label: t / 1e6 / reps for label, t in ns.items()}


def cuda_ms_spread(fn, rounds: int = 7, reps: int = 3):
    """(median, min, max) over rounds of cuda_ms: the e2e path launches
    hundreds of small kernels from Python, so host timing noise shows."""
    samples = sorted(cuda_ms(fn, reps) for _ in range(rounds))
    return samples[len(samples) // 2], samples[0], samples[-1]


def device_us(e) -> float:
    """Device microseconds of a profiler key_averages() entry."""
    return getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)


def set_tf32(on: bool) -> None:
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


# ------------------------------------------------------------------ inputs


class Case(NamedTuple):
    """One kernel call at one shape, with what it is held against and timed
    beside: its plain version, and the default configuration's cuDNN path
    for the same work. flops and nbytes are the work the function needs:
    each input (weights included) read once, each output written once."""
    name: str
    label: str
    kern: Callable
    plain: Callable
    default: Callable
    flops: float
    nbytes: float

    def bound(self, dtype) -> Tuple[float, str]:
        return bound_of(self.flops, self.nbytes, dtype)


def bound_of(flops: float, nbytes: float, dtype) -> Tuple[float, str]:
    """(ms, "operations" or "bytes"): the least time the card could take
    for flops operations on dtype and nbytes moved."""
    ops, mem = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(ops, mem) * 1e3, "operations" if ops >= mem else "bytes"


def _rand(g: torch.Generator, dev):
    return lambda *s, sc=1.0: (torch.randn(*s, generator=g) * sc).to(dev)


def _cast(dtype, *ts) -> tuple:
    return tuple(t.to(dtype) for t in ts)


def _nbytes(dtype, *ts, out: int = 0, biases=()) -> float:
    """Bytes of the tensors ts and of `out` more elements in dtype, and of
    float32 biases."""
    es = torch.finfo(dtype).bits / 8
    return es * (sum(t.numel() for t in ts) + out) + 4.0 * sum(b.numel() for b in biases)


def _cbn(x, w, b):
    from unet_goolenet_tpu_torch.ops.conv import conv2d

    return torch.relu(conv2d(x, w, b, padding=1))


def default_gate(x, w, b):
    """The default configuration's gate pass: cuDNN conv, then the stats."""
    e = _cbn(x, w, b)
    return e, e.float().mean(dim=(1, 2)), e.float().amax(dim=(1, 2))


def default_level(x, e1, g1p, w_up, b_up, w_d2, b_d2, w_pair, b_pair, w_blk1, b_blk1):
    """The default configuration's decoder level after the gate pass
    (engine._up_alig's ops), in the weights' dtype."""
    from unet_goolenet_tpu_torch.ops.conv import conv_transpose2x2

    up = conv_transpose2x2(x, w_up, b_up)
    gated = e1 + g1p[:, None, None, :] * _cbn(up, w_d2, b_d2)
    return _cbn(_cbn(torch.cat([up, gated], dim=-1), w_pair, b_pair), w_blk1, b_blk1)


def default_down1(x1, w1, b1, w2, b2):
    from unet_goolenet_tpu_torch.ops.pool import max_pool2d

    return _cbn(_cbn(max_pool2d(x1, 2), w1, b1), w2, b2)


def level_weights(r, c: int, cq: int) -> tuple:
    """Seeded (w_up, b_up, w_d2, b_d2, w_pair, b_pair, w_blk1, b_blk1) of one
    level, in the layouts the plain versions take, He-scaled."""
    return (r(c, c, 2, 2, sc=c ** -0.5), r(c, sc=0.1), r(c, c, 3, 3, sc=(9 * c) ** -0.5),
            r(c, sc=0.1), r(cq, 2 * c, 3, 3, sc=(18 * c) ** -0.5), r(cq, sc=0.1),
            r(cq, cq, 3, 3, sc=(9 * cq) ** -0.5), r(cq, sc=0.1))


def level_flops(px: int, c: int, cq: int) -> float:
    """deconv + d2 + pair + block1 per output pixel, times the pixels."""
    return float(px) * (2 * c * c + 18 * c * c + 36 * c * cq + 18 * cq * cq)


def up1_cases(n, h, w, dtype, dev, seed) -> list:
    """The two up1 kernels at output size (h, w), C = 64, one class."""
    from unet_goolenet_tpu_torch.ops.conv import conv2d
    from unet_goolenet_tpu_torch.ops.kernels import up1 as K

    g = torch.Generator().manual_seed(seed)
    r, c = _rand(g, dev), 64
    x1, wg, bg = r(n, h, w, c).to(dtype), r(c, c, 3, 3, sc=(9 * c) ** -0.5), r(c, sc=0.1)
    y, e1 = r(n, h // 2, w // 2, c).to(dtype), r(n, h, w, c).abs().to(dtype)
    g1p = (1 + torch.rand(n, c, generator=g)).to(dev)
    tail = (*level_weights(r, c, c), r(1, c, 1, 1, sc=c ** -0.5), r(1, sc=0.1))
    gw, tw = K.gate_weights(wg, bg, dtype), K.tail_weights(*tail, dtype=dtype)
    cast, px = _cast(dtype, *tail), n * h * w

    def tail_default():
        return conv2d(default_level(y, e1, g1p.to(dtype), *cast[:8]), *cast[8:])

    return [
        Case("up1_gate", f"{n}x{h}x{w}x{c}", partial(K.up1_gate, x1, gw),
             partial(K.up1_gate_ref, x1, wg, bg), partial(default_gate, x1, *_cast(dtype, wg, bg)),
             px * 18.0 * c * c, _nbytes(dtype, x1, wg, out=x1.numel(), biases=(bg,)) + 8.0 * n * c),
        Case("up1_tail", f"{n}x{h}x{w}x{c}", partial(K.up1_tail, y, e1, g1p, tw),
             partial(K.up1_tail_ref, y, e1, g1p, *tail), tail_default,
             level_flops(px, c, c) + px * 2.0 * c,
             _nbytes(dtype, y, e1, *tail[::2], out=px, biases=tail[1::2])),
    ]


def dense_cases(n, down1_hw, levels, dtype, dev, seed) -> list:
    """pool_down1 on an x1 of size down1_hw (64 -> 128 channels), and the
    dense gate and level kernels at each (output h, w, C, cq) of levels."""
    from unet_goolenet_tpu_torch.ops.kernels import down1 as D
    from unet_goolenet_tpu_torch.ops.kernels import up2 as U

    g = torch.Generator().manual_seed(seed)
    r = _rand(g, dev)
    h, w = down1_hw
    x1 = r(n, h, w, 64).to(dtype)
    dwb = (r(128, 64, 3, 3, sc=(9 * 64) ** -0.5), r(128, sc=0.1),
           r(128, 128, 3, 3, sc=(9 * 128) ** -0.5), r(128, sc=0.1))
    px = n * (h // 2) * (w // 2)
    cases = [Case("pool_down1", f"x1 {n}x{h}x{w}x64",
                  partial(D.pool_down1, x1, D.down1_weights(*dwb, dtype)),
                  partial(D.pool_down1_ref, x1, *dwb),
                  partial(default_down1, x1, *_cast(dtype, *dwb)),
                  px * 18.0 * (64 * 128 + 128 * 128),
                  _nbytes(dtype, x1, dwb[0], dwb[2], out=px * 128, biases=dwb[1::2]))]
    for lh, lw, c, cq in levels:
        skip, wg, bg = r(n, lh, lw, c).to(dtype), r(c, c, 3, 3, sc=(9 * c) ** -0.5), r(c, sc=0.1)
        x, e1 = r(n, lh // 2, lw // 2, c).to(dtype), r(n, lh, lw, c).abs().to(dtype)
        g1p = (1 + torch.rand(n, c, generator=g)).to(dev)
        lvl = level_weights(r, c, cq)
        px = n * lh * lw
        cases += [
            Case("up_gate_dense", f"{n}x{lh}x{lw}x{c}",
                 partial(U.up_gate_dense, skip, U.up_gate_weights(wg, bg, dtype)),
                 partial(U.up_gate_dense_ref, skip, wg, bg),
                 partial(default_gate, skip, *_cast(dtype, wg, bg)),
                 px * 18.0 * c * c,
                 _nbytes(dtype, skip, wg, out=skip.numel(), biases=(bg,)) + 8.0 * n * c),
            Case("up_level", f"out {n}x{lh}x{lw}x{cq} C={c}",
                 partial(U.up_level, x, e1, g1p, U.up_level_weights(*lvl, dtype=dtype)),
                 partial(U.up_level_ref, x, e1, g1p, *lvl),
                 partial(default_level, x, e1, g1p.to(dtype), *_cast(dtype, *lvl)),
                 level_flops(px, c, cq),
                 _nbytes(dtype, x, e1, *lvl[::2], out=px * cq, biases=lvl[1::2])),
        ]
    return cases


def all_cases(n, dtype, dev, seed, ragged=False) -> list:
    """Every kernel at the main path's shapes for n images at 224^2, or at
    a ragged level that no tile divides."""
    if ragged:
        return (up1_cases(n, 36, 52, dtype, dev, seed)
                + dense_cases(n, (40, 56), ((20, 28, 256, 128),), dtype, dev, seed + 1))
    return (up1_cases(n, 224, 224, dtype, dev, seed)
            + dense_cases(n, (224, 224), tuple((h, h, c, cq) for h, c, cq in LEVELS), dtype,
                          dev, seed + 1))


def counters() -> dict:
    """Each kernel's wrapper, whose .launches counts its launches."""
    from unet_goolenet_tpu_torch.ops.kernels import conv, down1, up1, up2

    return {"up1_gate": up1.up1_gate, "up1_tail": up1.up1_tail,
            "pool_down1": down1.pool_down1, "up_gate_dense": up2.up_gate_dense,
            "up_level": up2.up_level, **{name: getattr(conv, name) for name in TRAIN_KERNELS}}


def reset_counts() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in counters().items()}


def random_state_dict(model: torch.nn.Module, seed: int) -> dict:
    """Reference-named state dict with seeded values: He-scaled weights,
    non-trivial BatchNorm running statistics."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = v.clone()
        elif k.endswith("running_mean"):
            sd[k] = torch.randn(v.shape, generator=g) * 0.2
        elif k.endswith("running_var"):
            sd[k] = torch.rand(v.shape, generator=g) + 0.5
        elif "pos_embedding" in k:
            sd[k] = torch.randn(v.shape, generator=g) * 0.1
        elif v.ndim >= 2:
            sd[k] = torch.randn(v.shape, generator=g) * float(np.prod(v.shape[1:])) ** -0.5
        elif k.endswith(".weight"):
            sd[k] = torch.rand(v.shape, generator=g) + 0.5
        else:
            sd[k] = torch.randn(v.shape, generator=g) * 0.1
    return sd


def write_fixture(models) -> tuple:
    """8 gray PNGs in two native sizes, and the two checkpoints."""
    from PIL import Image

    img_dir = os.path.join(WORK, "images")
    os.makedirs(img_dir, exist_ok=True)
    for f in os.listdir(img_dir):
        os.remove(os.path.join(img_dir, f))
    rng = np.random.default_rng(SEED)
    for i in range(8):
        h, w = (400, 500) if i % 2 == 0 else (360, 480)
        yy, xx = np.mgrid[0:h, 0:w]
        blob = 120.0 * np.exp(-((yy - h * rng.uniform(0.3, 0.7)) ** 2
                                + (xx - w * rng.uniform(0.3, 0.7)) ** 2) / (2 * 50.0 ** 2))
        img = np.clip(60 + blob + rng.normal(0, 20, (h, w)), 0, 255).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(img_dir, f"{i + 1}.png"))
    unet, gnet = models
    unet_sd = random_state_dict(unet, SEED + 1)
    # the reference's dead keys, which loading must drop
    unet_sd["fc1.weight"] = torch.zeros(256, 512)
    unet_sd["fc2.weight"] = torch.zeros(1, 256)
    paths = (os.path.join(WORK, "unet.pt"), os.path.join(WORK, "gnet.pt"))
    torch.save({"net": unet_sd}, paths[0])
    torch.save({"net": random_state_dict(gnet, SEED + 2)}, paths[1])
    return img_dir, paths


# ------------------------------------------------------------------ phases


def phase_device() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    print(card, flush=True)
    say("device", name=repr(torch.cuda.get_device_name(0)), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    return card


def trainer_gemm_registers(log: str) -> dict:
    """ptxas's registers of each conv3x3_gemm instantiation that csrc/conv.cu
    compiles (the trainer's; the file's name is in the mangled name of its
    anonymous namespace), by template arguments."""
    regs, entry = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", ln)
        t = entry and re.search(r"_conv_cu_\w*conv3x3_gemmI(Li\d+ELb[01]ELi\d+ELi\d+ELi\d+E)E",
                                entry)
        if m and t:   # Li128ELb0ELi1ELi4ELi0E -> <128, false, 1, 4, 0>
            args = [("true" if v == "1" else "false") if k == "b" else v
                    for k, v in re.findall(r"L([ib])(\d+)E", t.group(1))]
            regs[f"<{', '.join(args)}>"] = int(m.group(1))
    return regs


def phase_build() -> None:
    from unet_goolenet_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.load()
    log = path.with_suffix(".log").read_text()
    regs = [ln.split(":", 1)[1].strip() for ln in log.splitlines() if "registers" in ln]
    trainer = trainer_gemm_registers(log)
    say("build", seconds=f"{time.perf_counter() - t0:.2f}", library=os.path.relpath(path, ROOT),
        trainer_conv3x3_gemm_registers=repr(trainer), ptxas=repr("; ".join(regs)))
    if not trainer or set(trainer.values()) != {TRAINER_GEMM_REGISTERS}:
        fail(f"the trainer's conv3x3_gemm instantiations use {trainer} registers, "
             f"expected {TRAINER_GEMM_REGISTERS}")


def dname(dtype) -> str:
    return str(dtype).split(".")[1]


def phase_kernels(dev) -> dict:
    """Each kernel against its plain version; returns the bf16 main-shape
    max |error| per kernel."""
    errs = {}
    for n, ragged in ((4, False), (2, True)):
        for dtype in (torch.float32, torch.bfloat16):
            cases = all_cases(n, dtype, dev, SEED + 2 * ragged, ragged)
            got = [case.kern() for case in cases]
            torch.cuda.synchronize()
            for case, out in zip(cases, got):
                worst_abs = worst_rel = 0.0
                pairs = zip(*(t if isinstance(t, tuple) else (t,) for t in (out, case.plain())))
                for g, r in pairs:
                    g, r = g.float(), r.float()
                    if g.shape != r.shape or not torch.isfinite(g).all():
                        fail(f"{case.name} {dtype} {case.label}: shape {tuple(g.shape)} "
                             f"or non-finite values")
                    err = (g - r).abs().max().item()
                    worst_abs = max(worst_abs, err)
                    worst_rel = max(worst_rel, err / max(r.abs().max().item(), 1e-30))
                ok = worst_rel <= KERNEL_TOL[dtype]
                extra = {}
                if dtype == torch.bfloat16 and case.name in REPEATED_SERVING:
                    extra["repeats_bitwise"] = all(
                        torch.equal(a, b) for a, b in zip(_tup(out), _tup(case.kern())))
                say("kernel", name=case.name, dtype=dname(dtype), shape=repr(case.label),
                    max_abs_err=f"{worst_abs:.3e}", max_rel_err=f"{worst_rel:.3e}",
                    tol=f"{KERNEL_TOL[dtype]:.0e}", ok=ok, **extra)
                if not ok:
                    fail(f"{case.name} disagrees with its plain version")
                if extra.get("repeats_bitwise") is False:
                    fail(f"{case.name}: a second call gave other bits")
                if not ragged and dtype == torch.bfloat16:
                    errs[case.name] = max(errs.get(case.name, 0.0), worst_abs)
            del cases, got
    return errs


def phase_e2e(dev) -> dict:
    """The default configuration through infer_e2e, then the all-fused one;
    returns each kernel's launches on its path."""
    from unet_goolenet_tpu_torch.apps import infer_e2e
    from unet_goolenet_tpu_torch.models import (
        GoogLeNetClassifier, UNetTaskAligWeight, load_reference_state_dict)

    img_dir, (unet_pt, gnet_pt) = write_fixture((UNetTaskAligWeight(1), GoogLeNetClassifier(6)))
    reset_counts()
    for flags in (["--bf16"], []):
        out = infer_e2e.main(["--image-dir", img_dir, "--unet-checkpoint", unet_pt,
                              "--gnet-checkpoint", gnet_pt, "--out-dir",
                              os.path.join(WORK, "out"), "--batch-size", "4",
                              "--device", str(dev), *flags])
        lines = open(out).read().splitlines()
        grades = [int(ln.split()[1]) for ln in lines]
        if len(lines) != 8 or not all(0 <= g < 6 for g in grades):
            fail(f"result.txt: expected 8 grades in [0, 6), got {lines}")
        say("e2e", dtype="bf16" if flags else "f32", graded=len(lines), grades=grades)
    launches = {k: v for k, v in read_counts().items() if k.startswith("up1_")}
    if any(v for k, v in read_counts().items() if k in TRAIN_KERNELS):
        fail("serving launched a training kernel")
    say("e2e", config="default", launches=launches)
    if min(launches.values()) == 0:
        fail(f"a kernel of the main path never launched: {launches}")

    gray = torch.from_numpy(np.stack([infer_e2e.read_gray(os.path.join(img_dir, f"{i}.png"))
                                      for i in (1, 3, 5, 7)]).astype(np.float32))
    unet = load_reference_state_dict(unet_pt, UNetTaskAligWeight(1))
    gnet = load_reference_state_dict(gnet_pt, GoogLeNetClassifier(6))
    check_kernel_path(dev, unet, gnet, gray)
    fused = phase_fused(dev, unet, gnet, gray)
    return {**fused, **launches}


def phase_fused(dev, unet, gnet, gray) -> dict:
    """The all-fused configuration: TwoStagePipeline in float32 against the
    plain composition, then one bf16 batch-16 call of the stage-2 trainer's
    ROI extractor; every kernel must have launched."""
    from unet_goolenet_tpu_torch.apps.train_cls import make_roi_extractor
    from unet_goolenet_tpu_torch.pipeline import preprocess_gray

    reset_counts()
    check_kernel_path(dev, unet, gnet, gray, **FUSED)
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    imgs = preprocess_gray(torch.rand((16, 400, 500), generator=g, device=dev) * 255.0)
    crops, logits = make_roi_extractor(unet, 224, fused=True, dtype=torch.bfloat16,
                                       device=dev)(imgs)
    torch.cuda.synchronize()
    if (crops.shape != (16, 224, 224, 3) or logits.shape != (16, 224, 224, 1)
            or not (torch.isfinite(crops).all() and torch.isfinite(logits).all())):
        fail("make_roi_extractor(fused=True): crops/logits of the wrong shape or not finite")
    launches = {k: v for k, v in read_counts().items() if k in KERNELS}
    say("e2e", config="all-fused", extractor="bf16 batch 16",
        mask_share=f"{(torch.sigmoid(logits[..., 0].float()) > 0.5).float().mean().item():.3f}",
        launches=launches)
    if min(launches.values()) == 0:
        fail(f"a kernel of the all-fused path never launched: {launches}")
    return launches


def check_kernel_path(dev, unet, gnet, gray, img_size: int = 224, **knobs) -> None:
    """float32: the pipeline (kernel path, with the given fused-level knobs)
    against the same graph as plain ops (unet_trunk with every knob off, and
    up1_plain). With random weights every image tends to get the same grade,
    which would let the grade check pass whatever the kernels return; so the
    fc bias is first centred on these images' logits. Centred logits sum to 0
    over the images in every class, so unless they tie, no one class can win
    on every image."""
    from unet_goolenet_tpu_torch.pipeline import TwoStagePipeline, engine, extract_roi
    from unet_goolenet_tpu_torch.pipeline.two_stage import preprocess_gray

    pipe = TwoStagePipeline(unet, gnet, device=dev, img_size=img_size, **knobs)
    with torch.no_grad():
        gnet.googlenet.fc.bias -= pipe.infer_from_gray(gray)["cls_logits"].mean(dim=0)
    pipe = TwoStagePipeline(unet, gnet, device=dev, img_size=img_size, **knobs)
    k = pipe.infer_from_gray(gray)
    with torch.inference_mode():
        imgs = preprocess_gray(gray.to(dev), out_hw=pipe.hw)
        P = pipe.unet_params
        seg = engine.up1_plain(P, *engine.unet_trunk(P, imgs))
        masks = (torch.sigmoid(seg[..., 0]) > 0.5).float()
        cls = engine.gnet_forward(pipe.gnet_params, extract_roi(imgs, masks, out_hw=pipe.hw)[0])
    if k["seg_logits"].shape != (len(gray), *pipe.hw, 1) or not (
            torch.isfinite(k["seg_logits"]).all() and torch.isfinite(k["cls_logits"]).all()):
        fail("kernel path: seg/cls logits of the wrong shape or not finite")
    flips = int(((k["masks"] != masks) & (seg[..., 0].abs() >= 1e-3)).sum())
    seg_err = (k["seg_logits"] - seg).abs().max().item()
    seg_bound = SEG_TOL * seg.abs().max().item()
    grades, plain_grades = k["grades"].tolist(), cls.argmax(dim=-1).tolist()
    say("e2e", check=f"f32 {'all-fused' if knobs else 'default'} kernel path vs plain",
        grades=grades, plain_grades=plain_grades,
        distinct_grades=len(set(plain_grades)), mask_flips_beyond_1e_3=flips,
        seg_logit_max_abs_err=f"{seg_err:.3e}", seg_logit_bound=f"{seg_bound:.3e}",
        cls_logit_max_abs_err=f"{(k['cls_logits'] - cls).abs().max().item():.3e}",
        mask_share=f"{masks.mean().item():.3f}")
    if len(set(plain_grades)) < 2:
        fail("the fixture graded every image alike: the grade check would have no teeth")
    if grades != plain_grades or flips or not seg_err <= seg_bound:
        fail("the kernel path and the plain composition disagree")


def time_e2e(dev, unet, gnet) -> None:
    """infer_grades of each of CONFIGS, in turns (forwards, then backwards),
    each a median of 7 rounds."""
    from unet_goolenet_tpu_torch.pipeline import TwoStagePipeline

    g = torch.Generator(device=dev).manual_seed(SEED)
    order = list(CONFIGS) + list(CONFIGS)[::-1]
    for dtype in (torch.bfloat16, torch.float32):
        pipes = {cfg: TwoStagePipeline(unet, gnet, device=dev, dtype=dtype, **knobs)
                 for cfg, knobs in CONFIGS.items()}
        for n in (16, 64):
            gray = torch.rand((n, 400, 500), generator=g, device=dev) * 255.0
            runs = {cfg: [] for cfg in CONFIGS}
            for cfg in order:
                runs[cfg].append(cuda_ms_spread(lambda: pipes[cfg].infer_grades(gray)))
            for cfg, rs in runs.items():
                ms = sum(r[0] for r in rs) / len(rs)
                say("timing", what="infer_grades", config=cfg, dtype=dname(dtype), batch=n,
                    median_ms=f"{ms:.3f}", run_medians_ms=",".join(f"{r[0]:.3f}" for r in rs),
                    min_ms=f"{min(r[1] for r in rs):.3f}", max_ms=f"{max(r[2] for r in rs):.3f}",
                    images_per_s=f"{n * 1000.0 / ms:.1f}", rounds=7, calls_per_round=3)


def time_kernels(dev) -> dict:
    """Each kernel at batch 16 at the main path's shapes, in turns with its
    plain version (plain, kernel, kernel, plain), then the default
    configuration's cuDNN path for the same work; returns, per kernel, the
    bf16 sums over its calls in one infer_grades call."""
    agg = {name: dict(ms=0.0, plain_ms=0.0, default_path_ms=0.0, bound_ms=0.0, ops=0.0, mem=0.0)
           for name in KERNELS}
    for dtype in (torch.bfloat16, torch.float32):
        cases = all_cases(16, dtype, dev, SEED + 7)
        for case in cases:
            p1, k1, k2, p2 = (cuda_ms(f, 10) for f in (case.plain, case.kern, case.kern,
                                                      case.plain))
            dm = cuda_ms(case.default, 10)
            km, pm = (k1 + k2) / 2, (p1 + p2) / 2
            bound, by = case.bound(dtype)
            say("timing", what=case.name, shape=repr(case.label), dtype=dname(dtype), batch=16,
                kernel_ms=f"{km:.3f}", plain_ms=f"{pm:.3f}", default_path_ms=f"{dm:.3f}",
                bound_ms=f"{bound:.4f}", bound_by=by, share_of_bound=f"{bound / km:.3f}",
                kernel_runs=f"{k1:.3f},{k2:.3f}", plain_runs=f"{p1:.3f},{p2:.3f}")
            if dtype == torch.bfloat16:
                a = agg[case.name]
                a["ms"] += km
                a["plain_ms"] += pm
                a["default_path_ms"] += dm
                a["bound_ms"] += bound
                a["ops"] += case.flops / PEAK_FLOPS[dtype]
                a["mem"] += case.nbytes / PEAK_BYTES
        del cases
    return agg


# the bf16 level's launches (csrc/up_level.cu): the transposed conv's GEMM,
# then conv3x3_gemm by its epilogue (csrc/conv3x3.cuh EPI, the last template
# argument); the gate pass's (csrc/gate.cu): conv3x3_gemm's STATS epilogue,
# then the partials' reduce; the weight-layout kernels, which neither call
# may launch
LEVEL_STAGES = {"1": "d2_gate", "2": "pair", "0": "block1", "3": "block1_head",
                "4": "gate_conv"}
STATS_KERNEL = "gate_stats_kernel"
LAYOUT_KERNELS = ("weight_bf16_kernel", "weight_f32_kernel", "dx_weight_kernel")
# serving kernels whose bf16 call must repeat bit for bit
REPEATED_SERVING = ("up1_gate", "up1_tail", "up_gate_dense", "up_level", "pool_down1")
# the ptxas registers of the trainer's conv3x3_gemm instantiations (csrc/conv.cu),
# which the serving epilogues on the same kernel must not move
TRAINER_GEMM_REGISTERS = 136


def level_stage(kernel: str) -> str:
    """The stage of a bf16 level or gate call that a device event of this
    name is."""
    if "deconv_gemm<" in kernel:
        return "deconv"
    if STATS_KERNEL in kernel:
        return "stats_reduce"
    m = re.search(r"conv3x3_gemm<\d+, (?:true|false), \d+, \d+, (\d+)>", kernel)
    if m:
        return LEVEL_STAGES.get(m.group(1), "other")
    return "layout" if any(k in kernel for k in LAYOUT_KERNELS) else "other"


def stages_by_name(prof, calls: int) -> tuple:
    """(ms, launches) a call by level_stage, from the trace's sums by kernel
    name."""
    ms, count = {}, {}
    for e in prof.key_averages():
        if device_us(e) <= 0 or not str(e.device_type).endswith("CUDA"):
            continue
        stage = level_stage(e.key)
        ms[stage] = ms.get(stage, 0.0) + device_us(e) / 1e3 / calls
        count[stage] = count.get(stage, 0) + e.count / calls
    return ms, count


def down1_stages(prof, calls: int) -> tuple:
    """(ms, launches) a pool_down1 call by stage, from the trace's device
    events (those stages_by_name sums) in launch order: a pool launch
    starts a call, and the first and second conv3x3_gemm launches after it
    are its two convs (one kernel, so only the order tells them apart)."""
    events = sorted((e.time_range.start, device_us(e), e.key) for e in prof.events()
                    if device_us(e) > 0 and str(e.device_type).endswith("CUDA"))
    us, count, conv = {}, {}, 0
    for _, dur, name in events:
        if "pool_kernel<" in name:
            stage, conv = "pool", 0
        elif "conv3x3_gemm<" in name:
            conv += 1
            stage = f"conv{conv}"
        else:
            stage = level_stage(name)
        us[stage] = us.get(stage, 0.0) + dur
        count[stage] = count.get(stage, 0) + 1
    return ({k: v / 1e3 / calls for k, v in us.items()},
            {k: v / calls for k, v in count.items()})


def level_stages(dev, calls: int = 10, tries: int = 3) -> None:
    """The bf16 gate, level and pool + down1 kernels' device time and
    launches by stage, batch 16, at up1 (the gate as up1_gate, the level
    with the head as up1_tail), each dense level (up_gate_dense, up_level)
    and down1 (pool_down1 on x1 16x224x224x64), from a profiler trace of
    `calls` calls: what each of its launches costs. Fails unless each level
    call launched the deconv and the three convs once each and no weight
    layout ("other" is the wrapper's cast of the gate), each gate call the
    conv and the reduce once each and nothing else, and each pool_down1
    call the pool once and the GEMM twice and nothing else.
    The trace may lose the device events of the first calls after it
    starts, so one call runs in the profiler's warm-up step, whose events
    are dropped, and the `calls` in its recorded step. A trace can still
    lose a few events (one run counted 0.8 and 0.9 launches a call of a
    gate's two kernels): a count that is not a whole number a call can only
    be such a loss, so that trace is taken again, up to `tries` times."""
    from torch.profiler import ProfilerActivity, profile, schedule

    levels = tuple((h, h, c, cq) for h, c, cq in LEVELS)
    cases = (up1_cases(16, 224, 224, torch.bfloat16, dev, SEED + 7)
             + dense_cases(16, (224, 224), levels, torch.bfloat16, dev, SEED + 7))
    for case in cases:
        if case.name not in ("up1_gate", "up1_tail", "up_gate_dense", "up_level", "pool_down1"):
            continue
        case.kern()
        torch.cuda.synchronize()
        for trace in range(1, tries + 1):
            with profile(activities=[ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
                for n in (1, calls):   # the warm-up step, then the recorded one
                    for _ in range(n):
                        case.kern()
                    torch.cuda.synchronize()
                    prof.step()
            ms, count = (down1_stages if case.name == "pool_down1" else stages_by_name)(
                prof, calls)
            if all(v == round(v) for v in count.values()):
                break
        if not ms:
            say("timing", what=f"{case.name}_stages", shape=repr(case.label),
                device_time="not measured (the trace holds no device time)")
            continue
        say("timing", what=f"{case.name}_stages", shape=repr(case.label), dtype="bfloat16",
            batch=16, traces=trace, launches_per_call=sum(count.values()),
            **{f"{k}_launches": v for k, v in count.items()}, sum_ms=f"{sum(ms.values()):.4f}",
            **{f"{k}_ms": f"{v:.4f}" for k, v in ms.items()})
        if case.name == "pool_down1":
            # each stage's bound: x1 16x224x224x64 pools to 112^2, then 64 -> 128 -> 128
            px, es = 16 * 112 * 112, 2.0
            bounds = {"pool": bound_of(0.75 * 4 * px * 64, es * 5 * px * 64, torch.bfloat16),
                      "conv1": bound_of(18.0 * px * 64 * 128,
                                        es * (px * 192 + 9 * 64 * 128) + 512, torch.bfloat16),
                      "conv2": bound_of(18.0 * px * 128 * 128,
                                        es * (px * 256 + 9 * 128 * 128) + 512, torch.bfloat16)}
            say("timing", what="pool_down1_stage_bounds", shape=repr(case.label),
                **{f"{k}_bound_ms": f"{b:.4f}" for k, (b, _) in bounds.items()},
                **{f"{k}_bound_by": by for k, (_, by) in bounds.items()},
                **{f"{k}_share": f"{b / ms[k]:.3f}" for k, (b, _) in bounds.items() if k in ms})
            if count != {"pool": 1, "conv1": 1, "conv2": 1}:
                fail(f"pool_down1: expected the pool once and the GEMM twice, got {count}")
            continue
        if case.name in ("up1_gate", "up_gate_dense"):
            if count != {"gate_conv": 1, "stats_reduce": 1}:
                fail(f"{case.name}: expected the conv and the reduce once each, got {count}")
            continue
        last = "block1_head" if case.name == "up1_tail" else "block1"
        if count.get("layout") or any(count.get(k) != 1 for k in ("deconv", "d2_gate", "pair",
                                                                  last)):
            fail(f"{case.name}: expected one launch a stage and no weight layout, got {count}")


def time_serving_pool(dev) -> None:
    """max_pool2x2 at the serving shape, x1 16x224x224x64 (the pool that
    starts pool_down1), bf16 and float32: device time of the kernel, its
    plain version and max_pool2d, from one profiler trace, with its bound
    (x read once, y written once)."""
    import torch.nn.functional as F
    from unet_goolenet_tpu_torch.ops.kernels import conv as K

    g = torch.Generator().manual_seed(SEED + 10)
    xs = {dt: torch.randn(16, 224, 224, 64, generator=g).to(dev, dt)
          for dt in (torch.bfloat16, torch.float32)}
    fns = {}
    for dt, x in xs.items():
        fns[f"{dname(dt)} kernel"] = partial(K.max_pool2x2, x)
        fns[f"{dname(dt)} plain"] = partial(K.max_pool2x2_ref, x)
        fns[f"{dname(dt)} library"] = partial(F.max_pool2d, _nchw(x), 2)
    ms = trace_device_ms(fns)
    for dt, x in xs.items():
        bound, by = bound_of(0.75 * x.numel(), x.element_size() * 1.25 * x.numel(), dt)
        km = ms[f"{dname(dt)} kernel"]
        say("timing", what="max_pool2x2_serving", shape=repr("16x224x224x64"), dtype=dname(dt),
            device_ms=f"{km:.4f}", plain_device_ms=f"{ms[f'{dname(dt)} plain']:.4f}",
            library_device_ms=f"{ms[f'{dname(dt)} library']:.4f}", bound_ms=f"{bound:.4f}",
            bound_by=by, share_of_bound=f"{bound / km:.3f}")


def phase_timing(dev, errs, launches, train_errs, train_launches) -> list:
    from unet_goolenet_tpu_torch.models import GoogLeNetClassifier, UNetTaskAligWeight
    from unet_goolenet_tpu_torch.pipeline import TwoStagePipeline, engine, extract_roi
    from unet_goolenet_tpu_torch.pipeline.two_stage import preprocess_gray

    unet, gnet = UNetTaskAligWeight(1), GoogLeNetClassifier(6)
    unet.load_state_dict(random_state_dict(unet, SEED + 1))
    gnet.load_state_dict(random_state_dict(gnet, SEED + 2))
    time_e2e(dev, unet, gnet)
    agg = time_kernels(dev)
    level_stages(dev)
    time_serving_pool(dev)

    # per-layer split of one bf16 batch-64 call (events between the stages)
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    pipe = TwoStagePipeline(unet, gnet, device=dev, dtype=torch.bfloat16)
    gray = torch.rand((64, 400, 500), generator=g, device=dev) * 255.0
    P = pipe.unet_params
    stages = {}

    def run():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        imgs = preprocess_gray(gray).to(torch.bfloat16)
        ev[1].record()
        logits = engine.unet_forward(P, imgs)
        ev[2].record()
        crops, _ = extract_roi(imgs, (torch.sigmoid(logits[..., 0]) > 0.5).float())
        ev[3].record()
        engine.gnet_forward(pipe.gnet_params, crops).argmax(-1)
        ev[4].record()
        torch.cuda.synchronize()
        for i, name in enumerate(("preprocess", "unet", "roi", "googlenet")):
            stages[name] = ev[i].elapsed_time(ev[i + 1])

    with torch.inference_mode():
        run()
        run()
        for case in up1_cases(64, 224, 224, torch.bfloat16, dev, SEED + 9):
            stages[case.name] = cuda_ms(case.kern, 3)
    stages["unet_trunk_rest"] = stages["unet"] - stages["up1_gate"] - stages["up1_tail"]
    say("timing", what="layers_bf16_b64_ms",
        **{k: f"{v:.3f}" for k, v in stages.items()})
    for n in (16, 64):
        batch = gray[:n].contiguous()
        profile_call(lambda: pipe.infer_grades(batch), f"infer_grades_bf16_b{n}")
    fused = TwoStagePipeline(unet, gnet, device=dev, dtype=torch.bfloat16, **FUSED)
    profile_call(lambda: fused.infer_grades(gray), "infer_grades_fused_bf16_b64")

    serving = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[name], "max_abs_err": errs[name],
                "ms": agg[name]["ms"], "plain_ms": agg[name]["plain_ms"],
                "bound_ms": agg[name]["bound_ms"],
                "bound_by": "operations" if agg[name]["ops"] >= agg[name]["mem"] else "bytes",
                "library_ms": None, "default_path_ms": agg[name]["default_path_ms"]}
               for name, (src, rep) in KERNELS.items()]
    tagg = time_train(dev)
    return serving + [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": train_launches[name], "max_abs_err": train_errs[name],
         "ms": tagg[name]["ms"], "plain_ms": tagg[name]["plain_ms"],
         "bound_ms": tagg[name]["bound_ms"],
         "bound_by": "operations" if tagg[name]["ops"] >= tagg[name]["mem"] else "bytes",
         "library_ms": tagg[name]["library_ms"]}
        for name, (src, rep) in TRAIN_KERNELS.items()]


# ------------------------------------------------------------------ training


class TCase(NamedTuple):
    """One training-kernel call at one shape: the wrapper's call, its plain
    version, the cuDNN call for the same work (or None), the work (flops,
    bytes: each input read once, each output written once), the calls of
    this shape in one forward + backward pass of the train step, and for a
    weight gradient its launch's plan (ops/kernels/conv.py:wgrad_plan)."""
    name: str
    label: str
    kern: Callable
    plain: Callable
    library: Callable
    flops: float
    nbytes: float
    per_pass: int
    plan: object = None

    def bound(self, dtype) -> Tuple[float, str]:
        return bound_of(self.flops, self.nbytes, dtype)


def _nchw(t):
    return t.permute(0, 3, 1, 2)


def conv_cases(n, h, w, cin, cout, per_pass, dtype, dev, seed, dx=True) -> list:
    """fused_conv3x3 as the trainer calls it (no scale, bias, no relu; the
    call lays the weight out), its dx conv3x3_dx (reusing the forward's
    layout, as the backward does) and conv3x3_dw, at one shape; a 3-channel
    bf16 x goes to the forward and dw padded to 16 channels, as the
    trainer's Conv3x3 pads it once for both (dw told to take the first 3;
    the plain versions take the 3). The bf16 forward and dx carry their launch's tiles
    (ops/kernels/conv.py:conv_plan)."""
    import torch.nn.functional as F
    from unet_goolenet_tpu_torch.ops.kernels import conv as K

    g = torch.Generator().manual_seed(seed)
    r = _rand(g, dev)
    x, wt, b = r(n, h, w, cin).to(dtype), r(cout, cin, 3, 3, sc=(9 * cin) ** -0.5), r(cout, sc=0.1)
    gy = r(n, h, w, cout, sc=1e-3).to(dtype)
    xk, wk = K._gemm_input(x), K.conv3x3_weight(wt, dtype)
    wl, bl = wt.to(dtype), b.to(dtype)
    px, label = n * h * w, f"{n}x{h}x{w} {cin}->{cout}"
    flops, es = 18.0 * px * cin * cout, torch.finfo(dtype).bits / 8
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = (lambda d: K.conv_plan(d, n, h, w, cin, cout, sms) if dtype == torch.bfloat16 else None)
    cases = [TCase("fused_conv3x3", label, partial(K.fused_conv3x3, xk, wt, None, b, False),
                   partial(K.fused_conv3x3_ref, x, wt, None, b, False),
                   lambda: F.conv2d(_nchw(x), wl, bl, padding=1), flops,
                   es * (x.numel() + px * cout) + 4.0 * (wt.numel() + cout), per_pass,
                   plan(False)),
             TCase("conv3x3_dw", label, partial(K.conv3x3_dw, xk, gy, cin),
                   partial(K.conv3x3_dw_ref, x, gy),
                   lambda: torch.nn.grad.conv2d_weight(_nchw(x), wt.shape, _nchw(gy), padding=1),
                   flops, es * (x.numel() + gy.numel()) + 4.0 * wt.numel(), per_pass,
                   K.wgrad_plan(9, n, h, w, cin, cout, dtype, sms))]
    if dx:
        cases.append(TCase("conv3x3_dx", label, partial(K.conv3x3_dx, gy, wt, wk),
                           partial(K.conv3x3_dx_ref, gy, wt),
                           lambda: torch.nn.grad.conv2d_input(_nchw(x).shape, wl, _nchw(gy),
                                                              padding=1),
                           flops, es * (gy.numel() + x.numel()) + 4.0 * wt.numel(), per_pass,
                           plan(True)))
    return cases


def pair_cases(n, h, cin, c, dtype, dev, seed) -> list:
    from unet_goolenet_tpu_torch.ops.kernels import conv as K

    g = torch.Generator().manual_seed(seed)
    r = _rand(g, dev)
    x = r(n, h, h, cin).to(dtype)
    w1, w2 = r(c, cin, 3, 3, sc=(9 * cin) ** -0.5), r(c, c, 3, 3, sc=(9 * c) ** -0.5)
    vs = (r(c).abs() + 0.5, r(c, sc=0.1), r(c).abs() + 0.5, r(c, sc=0.1))
    args = (x, w1, vs[0], vs[1], w2, vs[2], vs[3])
    px, es = n * h * h, torch.finfo(dtype).bits / 8
    return [TCase("fused_convstack2", f"{n}x{h}x{h} {cin}->{c}->{c}",
                  partial(K.fused_convstack2, *args), partial(K.fused_convstack2_ref, *args), None,
                  18.0 * px * c * (cin + c), es * (x.numel() + w1.numel() + w2.numel() + px * c)
                  + 16.0 * c, 0)]


def deconv_cases(n, h, w, c, dtype, dev, seed, cout=None) -> list:
    """The transposed conv (x (n, h, w, c), w (c, cout, 2, 2), cout = c
    unless given), its dx and its dW/db; the forward and dx carry their
    launch's tiles (ops/kernels/conv.py:deconv_plan)."""
    import torch.nn.functional as F
    from unet_goolenet_tpu_torch.ops.kernels import conv as K

    cout = cout or c
    g = torch.Generator().manual_seed(seed)
    r = _rand(g, dev)
    x, wt, b = r(n, h, w, c).to(dtype), r(c, cout, 2, 2, sc=c ** -0.5), r(cout, sc=0.1)
    gy = r(n, 2 * h, 2 * w, cout, sc=1e-3).to(dtype)
    wl, bl = wt.to(dtype), b.to(dtype)
    flops, es = 8.0 * n * h * w * c * cout, torch.finfo(dtype).bits / 8
    label = f"{n}x{h}x{w}x{c}" + (f"->{cout}" if cout != c else "")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return [
        TCase("deconv2x2", label, partial(K.deconv2x2, x, wt, b), partial(K.deconv2x2_ref, x, wt, b),
              lambda: F.conv_transpose2d(_nchw(x), wl, bl, stride=2), flops,
              es * (x.numel() + wt.numel() + gy.numel()) + 4.0 * cout, 1,
              K.deconv_plan(False, n, h, w, c, cout, sms)),
        TCase("deconv2x2_dx", label, partial(K.deconv2x2_dx, gy, wt),
              partial(K.deconv2x2_dx_ref, gy, wt), lambda: F.conv2d(_nchw(gy), wl, stride=2),
              flops, es * (gy.numel() + wt.numel() + x.numel()), 1,
              K.deconv_plan(True, n, h, w, c, cout, sms)),
        TCase("deconv2x2_dwdb", label, partial(K.deconv2x2_dwdb, x, gy),
              partial(K.deconv2x2_dwdb_ref, x, gy),
              lambda: (torch.nn.grad.conv2d_weight(_nchw(gy), wt.shape, _nchw(x), stride=2),
                       gy.sum((0, 1, 2))),
              flops + 1.0 * gy.numel(), es * (x.numel() + gy.numel()) + 4.0 * (wt.numel() + cout),
              1, K.wgrad_plan(1, n, h, w, c, cout, dtype, sms)),
    ]


def pool_cases(n, h, w, c, dtype, dev, seed) -> list:
    import torch.nn.functional as F
    from unet_goolenet_tpu_torch.ops.kernels import conv as K

    g = torch.Generator().manual_seed(seed)
    x = torch.randint(0, 5, (n, h, w, c), generator=g).to(dev, dtype)   # ties
    gy = torch.randn(n, h // 2, w // 2, c, generator=g).to(dev, dtype)
    _, idx = F.max_pool2d(_nchw(x), 2, return_indices=True)
    es, label = torch.finfo(dtype).bits / 8, f"{n}x{h}x{w}x{c}"
    bwd = torch.ops.aten.max_pool2d_with_indices_backward
    return [
        TCase("max_pool2x2", label, partial(K.max_pool2x2, x), partial(K.max_pool2x2_ref, x),
              lambda: F.max_pool2d(_nchw(x), 2), 0.75 * x.numel(), es * 1.25 * x.numel(), 1),
        TCase("max_pool2x2_bwd", label, partial(K.max_pool2x2_bwd, x, gy),
              partial(K.max_pool2x2_bwd_ref, x, gy),
              lambda: bwd(_nchw(gy), _nchw(x), [2, 2], [2, 2], [0, 0], [1, 1], False, idx),
              0.75 * x.numel(), es * 2.25 * x.numel(), 1),
    ]


def train_cases(n, dtype, dev, seed, ragged=False) -> list:
    """Every training kernel at the trainer's shapes for n images at 224^2,
    or at the edges: a ragged 20x28 level, cin = 3 on a ragged 36x52 image,
    for the weight-gradient plan 14x14 512->512 (one chunk) and 28x28
    1024->256 (the most output tiles), and for the transposed conv's tiles
    3x5x7 (fewer pixels than an M tile), 1x3x3 (smaller than a tile's row)
    and 7x9 512->256 (cin != cout)."""
    if ragged:
        return (conv_cases(n, 20, 28, 128, 64, 1, dtype, dev, seed)
                + conv_cases(n, 36, 52, 3, 64, 1, dtype, dev, seed + 1)
                + conv_cases(n, 14, 14, 512, 512, 1, dtype, dev, seed + 5)
                + conv_cases(n, 28, 28, 1024, 256, 1, dtype, dev, seed + 6)
                + pair_cases(n, 20, 128, 64, dtype, dev, seed + 2)
                + deconv_cases(n, 10, 14, 128, dtype, dev, seed + 3)
                + deconv_cases(3, 5, 7, 64, dtype, dev, seed + 7)
                + deconv_cases(1, 3, 3, 256, dtype, dev, seed + 8)
                + deconv_cases(n, 7, 9, 512, dtype, dev, seed + 9, cout=256)
                + pool_cases(n, 20, 28, 64, dtype, dev, seed + 4))
    cases = []
    for i, (h, cin, cout, k) in enumerate(UNET_CONVS):   # inc's dx is never taken
        cases += conv_cases(n, h, h, cin, cout, k, dtype, dev, seed + i, dx=i > 0)
    for i, (h, cin, c) in enumerate(UNET_PAIRS):
        cases += pair_cases(n, h, cin, c, dtype, dev, seed + 100 + i)
    for i, (h, c) in enumerate(UNET_DECONVS):
        cases += deconv_cases(n, h, h, c, dtype, dev, seed + 200 + i)
    for i, (h, c) in enumerate(UNET_POOLS):
        cases += pool_cases(n, h, h, c, dtype, dev, seed + 300 + i)
    return cases


# deterministic by design, so held to bitwise repeats: the weight gradients
# (also held to the plain version in float64) and the conv's forward and dx,
# whose K splits are summed in rank order
REPEATED = ("conv3x3_dw", "deconv2x2_dwdb", "fused_conv3x3", "conv3x3_dx")
F64_HELD = REPEATED[:2]


def _tup(t) -> tuple:
    return t if isinstance(t, tuple) else (t,)


def phase_train_kernels(dev) -> dict:
    """Each training kernel against its plain version, the weight
    gradients and the conv's forward and dx also against a second call;
    returns the bf16 main-shape max |error| per kernel."""
    errs = {}
    for n, ragged in ((4, False), (2, True)):
        for dtype in (torch.float32, torch.bfloat16):
            worst, repeats, f64 = {}, 0, {}
            for case in train_cases(n, dtype, dev, SEED + 11 + ragged, ragged):
                out, ref = case.kern(), case.plain()
                if case.name in REPEATED:
                    again = case.kern()
                    torch.cuda.synchronize()
                    if not all(torch.equal(a, b) for a, b in zip(*map(_tup, (out, again)))):
                        fail(f"{case.name} {dtype} {case.label}: two calls on the same inputs "
                             f"differ")
                    repeats += 1
                if case.name in F64_HELD:
                    # both against the plain version run in float64 on the same inputs
                    truth = case.plain.func(*(t.double() for t in case.plain.args))
                    for what, got in (("kernel", out), ("plain", ref)):
                        e = max((g.double() - t).abs().max().item() / t.abs().max().item()
                                for g, t in zip(_tup(got), _tup(truth)))
                        f64[case.name, what] = max(f64.get((case.name, what), 0.0), e)
                    if f64[case.name, "kernel"] > KERNEL_TOL[dtype]:
                        fail(f"{case.name} {dtype} {case.label}: {f64[case.name, 'kernel']:.3e} "
                             f"from float64")
                torch.cuda.synchronize()
                for g, r in zip(*map(_tup, (out, ref))):
                    g, r = g.float(), r.float()
                    if g.shape != r.shape or not torch.isfinite(g).all():
                        fail(f"{case.name} {dtype} {case.label}: shape or non-finite values")
                    err = (g - r).abs().max().item()
                    rel = err / max(r.abs().max().item(), 1e-30)
                    if rel > KERNEL_TOL[dtype]:
                        fail(f"{case.name} {dtype} {case.label} disagrees with its plain "
                             f"version: {rel:.3e} of its max |value|")
                    a, w = worst.get(case.name, (0.0, 0.0))
                    worst[case.name] = (max(a, err), max(w, rel))
            for name, (a, w) in worst.items():
                say("kernel", name=name, dtype=dname(dtype),
                    shapes=("edges: ragged 20x28, cin 3 at 36x52, 14x14 512->512 (bf16: K "
                            "split), 28x28 1024->256; deconv 10x14, 3x5x7, 1x3x3, 7x9 512->256"
                            if ragged else "trainer, batch 4, 224^2"),
                    max_abs_err=f"{a:.3e}", max_rel_err=f"{w:.3e}", tol=f"{KERNEL_TOL[dtype]:.0e}",
                    ok=True)
                if not ragged and dtype == torch.bfloat16:
                    errs[name] = a
            say("kernel", check="weight gradients and the conv's forward and dx called twice",
                dtype=dname(dtype), cases=repeats, bitwise_equal=True)
            for name in F64_HELD:
                say("kernel", check="max |error| against float64 / max |value|", name=name,
                    dtype=dname(dtype), kernel=f"{f64[name, 'kernel']:.3e}",
                    plain=f"{f64[name, 'plain']:.3e}")
    return errs


def write_seg_fixture(root: str, counts: dict) -> None:
    """Seeded RGB PNGs (400x500, a bright lesion on speckle) with 0/255
    masks in the reference's layout: <split>/images, <split>/labels."""
    from PIL import Image

    rng = np.random.default_rng(SEED + 5)
    for split, n in counts.items():
        for d in ("images", "labels"):
            path = os.path.join(root, split, d)
            os.makedirs(path, exist_ok=True)
            for f in os.listdir(path):
                os.remove(os.path.join(path, f))
        for i in range(n):
            h, w = 400, 500
            yy, xx = np.mgrid[0:h, 0:w]
            m = ((yy - h * rng.uniform(0.3, 0.7)) / rng.uniform(40, 90)) ** 2 \
                + ((xx - w * rng.uniform(0.3, 0.7)) / rng.uniform(40, 90)) ** 2 < 1
            img = np.clip(60 + 90 * m[..., None] + rng.normal(0, 25, (h, w, 3)), 0, 255)
            name = f"{i % 6 + 1}_{i}.png"
            Image.fromarray(img.astype(np.uint8)).save(os.path.join(root, split, "images", name))
            Image.fromarray((m * 255).astype(np.uint8)).save(
                os.path.join(root, split, "labels", name))


def phase_train(dev) -> dict:
    """The trainer through its entry point with --kernels (bf16), then the
    float32 kernel path against the stock path; returns the counters of the
    trainer's run."""
    from unet_goolenet_tpu_torch.apps import train_seg
    from unet_goolenet_tpu_torch.train.seg import init_seg_state

    root = os.path.join(WORK, "seg")
    write_seg_fixture(root, {"train": 8, "val": 4})
    ckpt = os.path.join(WORK, "ckpt")
    reset_counts()
    t0 = time.perf_counter()
    out = train_seg.main(["--train-dir", os.path.join(root, "train"), "--val-dir",
                          os.path.join(root, "val"), "--epochs", "2", "--batch-size", "4",
                          "--img-size", "224", "--device", str(dev), "--kernels", "--bf16",
                          "--save-dir", ckpt, "--seed", str(SEED)])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: v for k, v in read_counts().items() if k in TRAIN_KERNELS}
    say("train", entry="apps.train_seg.main --kernels --bf16", epochs=2, batch=4, img=224,
        seconds=f"{secs:.2f}", best_val_loss=f"{out['best_val_loss']:.5f}",
        best_dice=f"{out['best_dice']:.4f}", launches=launches)
    if min(launches.values()) == 0:
        fail(f"a kernel of the training path never launched: {launches}")
    if not np.isfinite(out["best_val_loss"]):
        fail("the trainer's val loss is not finite")
    state = init_seg_state(img_size=224, kernels=True, device=dev)
    from unet_goolenet_tpu_torch.train.checkpoint import CheckpointManager

    _, epoch = CheckpointManager(ckpt).restore(out["best_loss_checkpoint"], state)
    say("train", checkpoint=os.path.basename(out["best_loss_checkpoint"]), reloaded_epoch=epoch)
    check_train_step(dev)
    return launches


def one_train_step(dev, sd, imgs, labels, kernels: bool, dtype) -> dict:
    """From the state dict sd: pass 0's loss and gradients, then one train
    step (two AdamW updates) and one eval step, in dtype."""
    from unet_goolenet_tpu_torch.models import UNetTaskAligWeight
    from unet_goolenet_tpu_torch.train import optim
    from unet_goolenet_tpu_torch.train.losses import dc_and_bce_loss
    from unet_goolenet_tpu_torch.train.seg import SegState, make_seg_eval_step, make_seg_train_step

    model = UNetTaskAligWeight(1, img_size=imgs.shape[1], kernels=kernels).to(dev, dtype)
    model.load_state_dict(sd)
    model.train()
    imgs, labels = imgs.to(dtype), labels.to(dtype)
    loss0 = dc_and_bce_loss(model(imgs), labels)
    loss0.backward()
    grads = {k: (p.grad.detach().double() if p.grad is not None
                 else torch.zeros_like(p, dtype=torch.float64))
             for k, p in model.named_parameters()}
    model.load_state_dict(sd)
    opt = optim.make_adamw(model.parameters(), 1e-4)
    metrics = make_seg_train_step(SegState(model, opt))(imgs, labels)
    eval_loss, masks = make_seg_eval_step(model)(imgs, labels)
    return dict(loss0=loss0.item(), grads=grads, loss=metrics["loss"].item(),
                state={k: v.detach().double() for k, v in model.state_dict().items()
                       if not k.endswith("num_batches_tracked")},
                eval_loss=eval_loss.item(), masks=masks)


def errors_to(run: dict, truth: dict, sd: dict) -> dict:
    """run's distance from the float64 truth, each relative: pass 0's loss,
    the step's loss, the eval loss; and as (over all leaves, {leaf: error}),
    L2 norms of the difference over that of the truth: pass 0's gradients,
    the batch statistics after the step, and the parameters after the step
    (over the float64 step's own change). Gradients and parameters leave
    out the leaves zero analytically (below TRAIN_TOL["zero"] of the
    largest float64 gradient: the conv biases ahead of BatchNorm)."""
    big = max(v.abs().max().item() for v in truth["grads"].values())
    live = [k for k, v in truth["grads"].items() if v.abs().max().item() > TRAIN_TOL["zero"] * big]
    stat_keys = [k for k in truth["state"] if k.endswith(("running_mean", "running_var"))]

    def rel(diff, base, keys) -> tuple:
        d = {k: float((diff(k) ** 2).sum()) for k in keys}
        b = {k: float((base(k) ** 2).sum()) for k in keys}
        return ((sum(d.values()) / sum(b.values())) ** 0.5,
                {k: (d[k] / b[k]) ** 0.5 for k in keys})

    return dict(
        loss0=abs(run["loss0"] - truth["loss0"]) / abs(truth["loss0"]),
        loss=abs(run["loss"] - truth["loss"]) / abs(truth["loss"]),
        eval_loss=abs(run["eval_loss"] - truth["eval_loss"]) / abs(truth["eval_loss"]),
        grad=rel(lambda k: run["grads"][k] - truth["grads"][k], lambda k: truth["grads"][k], live),
        stats=rel(lambda k: run["state"][k] - truth["state"][k], lambda k: truth["state"][k],
                  stat_keys),
        params=rel(lambda k: run["state"][k] - truth["state"][k],
                   lambda k: truth["state"][k] - sd[k].to(truth["state"][k]), live))


def hold(stock: dict, kern: dict) -> tuple:
    """(failures, worst): each of kern's errors against TRAIN_TOL["ratio"]
    times stock's plus the floor, over all leaves and leaf by leaf (a leaf's
    limit from the larger of its stock error and the whole's); worst is each
    group's largest share of its limit, with the leaf."""
    ratio, bad, worst = TRAIN_TOL["ratio"], [], {}
    for k, floor in TRAIN_TOL["floor"].items():
        if not isinstance(stock[k], tuple):
            lim = ratio * stock[k] + floor
            worst[k] = (kern[k] / lim, "")
            if kern[k] > lim:
                bad.append(f"{k} {kern[k]:.3e} > {lim:.3e}")
            continue
        (s_all, s_leaf), (k_all, k_leaf) = stock[k], kern[k]
        lim = ratio * s_all + floor
        worst[k] = (k_all / lim, "all")
        if k_all > lim:
            bad.append(f"{k} over all leaves {k_all:.3e} > {lim:.3e}")
        for leaf, e in k_leaf.items():
            lim = ratio * max(s_leaf[leaf], s_all) + floor
            worst[k] = max(worst[k], (e / lim, leaf))
            if e > lim:
                bad.append(f"{k} {leaf} {e:.3e} > {lim:.3e}")
    return bad, worst


def check_train_step(dev) -> None:
    """One full-width 224^2 batch-4 train step and eval step, float32 (TF32
    off), with the kernels and on the stock path, each held to the stock
    path in float64 from the same weights and batch (hold, TRAIN_TOL). The
    step is ill-conditioned in float32 (train-mode BatchNorm and AdamW's
    sign-like first update amplify rounding), so two float32
    implementations cannot be held to each other tightly; the float64 stock
    path is the measure of both."""
    from unet_goolenet_tpu_torch.models import UNetTaskAligWeight

    torch.manual_seed(SEED + 6)
    sd = UNetTaskAligWeight(1).state_dict()
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    imgs = torch.rand((4, 224, 224, 3), generator=g, device=dev)
    yy, xx = torch.meshgrid(torch.arange(224, device=dev), torch.arange(224, device=dev),
                            indexing="ij")
    labels = (((yy - 112) ** 2 + (xx - 100) ** 2) < 60 ** 2).float()[None, :, :, None].expand(
        4, -1, -1, -1).contiguous()
    truth = one_train_step(dev, sd, imgs, labels, False, torch.float64)
    stock = errors_to(one_train_step(dev, sd, imgs, labels, False, torch.float32), truth, sd)
    kern_run = one_train_step(dev, sd, imgs, labels, True, torch.float32)
    kern = errors_to(kern_run, truth, sd)
    bad, worst = hold(stock, kern)
    mask_diff = (kern_run["masks"] != truth["masks"]).float().mean().item()
    whole = lambda e: {k: f"{v[0] if isinstance(v, tuple) else v:.3e}" for k, v in e.items()}
    say("train", check="f32 train + eval step vs the float64 stock path, 224^2 batch 4",
        loss0=f"{truth['loss0']:.8f}", eval_loss=f"{truth['eval_loss']:.8f}",
        live_leaves=len(kern["grad"][1]), stock_f32=repr(whole(stock)),
        kernels_f32=repr(whole(kern)),
        worst_share_of_limit=repr({k: f"{v:.3f}@{leaf}" for k, (v, leaf) in worst.items()}),
        eval_mask_share_differing=f"{mask_diff:.5f}", tol=repr(TRAIN_TOL))
    if bad:
        fail(f"the kernel path's train step is further from float64 than the stock path's "
             f"allows: {bad[:5]}")


def time_train(dev) -> dict:
    """ms per train step and eval step (kernels and stock, bf16 and
    float32, in turns), one profiled bf16 step each way, and each training
    kernel's device time against its plain version's and cuDNN's (the
    wrapper's whole call: its weight layout and scratch too); returns the
    per-kernel bf16 sums per forward + backward pass (eval-only kernels: per
    eval step)."""
    from unet_goolenet_tpu_torch.models import UNetTaskAligWeight
    from unet_goolenet_tpu_torch.train import optim
    from unet_goolenet_tpu_torch.train.seg import SegState, make_seg_eval_step, make_seg_train_step

    torch.manual_seed(SEED + 8)
    sd = UNetTaskAligWeight(1).state_dict()
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    imgs = torch.rand((4, 224, 224, 3), generator=g, device=dev)
    labels = (torch.rand((4, 224, 224, 1), generator=g, device=dev) > 0.7).float()
    for bf16 in (True, False):
        steps, evals = {}, {}
        for kernels in (False, True):
            model = UNetTaskAligWeight(1, kernels=kernels).to(dev)
            model.load_state_dict(sd)
            st = SegState(model, optim.make_adamw(model.parameters(), 1e-4))
            steps[kernels] = partial(make_seg_train_step(st, bf16=bf16), imgs, labels)
            evals[kernels] = partial(make_seg_eval_step(model, bf16=bf16), imgs, labels)
        runs = {(what, k): [] for what in ("step", "eval") for k in (False, True)}
        for k in (False, True, True, False):
            runs["step", k].append(cuda_ms(steps[k], 3))
            runs["eval", k].append(cuda_ms(evals[k], 5))
        for (what, k), rs in runs.items():
            say("timing", what=f"train_{what}", path="kernels" if k else "stock",
                dtype="bfloat16" if bf16 else "float32", batch=4, img=224,
                ms=f"{sum(rs) / len(rs):.3f}", runs_ms=",".join(f"{v:.3f}" for v in rs))
        if bf16:   # launches a step, both paths from this call's traces
            n = {k: profile_call(steps[k], f"train_step_bf16_b4_{'kernels' if k else 'stock'}")
                 for k in (False, True)}
            say("profile", what="train_step_bf16_b4_launches", stock=n[False], kernels=n[True],
                kernels_minus_stock=None if None in n.values() else n[True] - n[False])
        del steps, evals
    agg = {name: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, ops=0.0, mem=0.0)
           for name in TRAIN_KERNELS}
    cases = {dtype: train_cases(4, dtype, dev, SEED + 13)
             for dtype in (torch.bfloat16, torch.float32)}
    fns = {}
    for dtype, cs in cases.items():
        for i, case in enumerate(cs):
            fns[f"{dname(dtype)} {i} kernel"] = case.kern
            fns[f"{dname(dtype)} {i} plain"] = case.plain
            if case.library:
                fns[f"{dname(dtype)} {i} library"] = case.library
    per_call = {}
    ms = trace_device_ms(fns, launches=per_call)
    for name in F64_HELD:   # the float32 partials one pass writes
        for dtype, cs in cases.items():
            mb = sum(c.per_pass * c.plan.partial_bytes for c in cs if c.name == name) / 1e6
            say("timing", what=f"{name}_partials_per_pass", dtype=dname(dtype), batch=4, img=224,
                partial_mb=f"{mb:.3f}")
    for dtype, cs in cases.items():
        for i, case in enumerate(cs):
            km, pm = ms[f"{dname(dtype)} {i} kernel"], ms[f"{dname(dtype)} {i} plain"]
            lm = ms.get(f"{dname(dtype)} {i} library")
            bound, by = case.bound(dtype)
            plan = {} if case.plan is None else (
                dict(chunks=case.plan.chunks, partial_mb=f"{case.plan.partial_bytes / 1e6:.3f}")
                if hasattr(case.plan, "chunks") else
                dict(tiles=f"{case.plan.mtiles}x{case.plan.ntiles}", splits=case.plan.splits))
            if hasattr(case.plan, "bm"):   # the conv's: its M tile and N tile
                plan.update(m_tile=f"{case.plan.R}x{case.plan.S}", n_tile=case.plan.bn)
            if case.name in ("fused_conv3x3", "conv3x3_dx") or hasattr(case.plan, "ktiles"):
                plan.update(launches_per_call=f"{per_call[f'{dname(dtype)} {i} kernel']:g}")
            say("timing", what=case.name, shape=repr(case.label), dtype=dname(dtype), batch=4,
                device_ms=f"{km:.4f}", plain_device_ms=f"{pm:.4f}",
                library_device_ms="null" if lm is None else f"{lm:.4f}",
                vs_library="null" if lm is None else f"{km / lm:.3f}",
                wall_ms=f"{cuda_ms(case.kern, 5):.4f}", bound_ms=f"{bound:.4f}", bound_by=by,
                share_of_bound=f"{bound / km:.3f}", calls_per_pass=case.per_pass, **plan)
            if dtype == torch.bfloat16:
                a, w = agg[case.name], max(case.per_pass, 1)
                a["ms"] += w * km
                a["plain_ms"] += w * pm
                a["library_ms"] = None if lm is None else a["library_ms"] + w * lm
                a["bound_ms"] += w * bound
                a["ops"] += w * case.flops / PEAK_FLOPS[dtype]
                a["mem"] += w * case.nbytes / PEAK_BYTES
    for name in ("max_pool2x2", "max_pool2x2_bwd"):   # the pools' whole pass, beside their bound
        a = agg[name]
        say("timing", what=f"{name}_pass", dtype="bfloat16", batch=4, img=224,
            device_ms=f"{a['ms']:.4f}", bound_ms=f"{a['bound_ms']:.4f}",
            share_of_bound=f"{a['bound_ms'] / a['ms']:.3f}",
            library_device_ms=f"{a['library_ms']:.4f}")
    return agg


def host_ms(fn, calls: int = 7):
    """Median (host ms, wall ms) per call: host is until fn returns (Python
    and launch work, unless the call waits on the device), wall until the
    device is done. The device is idle at the start of each call."""
    host, wall = [], []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        host.append((t1 - t0) * 1e3)
        wall.append((time.perf_counter() - t0) * 1e3)
    return sorted(host)[calls // 2], sorted(wall)[calls // 2]


def profile_call(fn, what: str):
    """Host time per call, then one traced call: device busy time against
    wall time, the CUDA runtime calls that make the host wait, and the
    kernels that take most of the device time. Returns the traced call's
    device launches (kernels and copies), or None without device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    host, wall = host_ms(fn)
    say("host", what=what, host_ms=f"{host:.3f}", wall_ms=f"{wall:.3f}", calls=7,
        stat="median")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # device-side events only (kernels, copies), so nothing is counted twice
    kernels = sorted((e for e in events if str(e.device_type).endswith("CUDA") and device_us(e) > 0),
                     key=device_us, reverse=True)
    # runtime calls that can hold the host until the device catches up; the
    # last cudaDeviceSynchronize is this function's own
    waits = {e.key: e.count for e in events
             if "Synchronize" in e.key or e.key in ("cudaMemcpy", "cudaMemcpyAsync")}
    if not kernels:
        say("profile", what=what, device_time="not measured (the trace holds no device time)")
        return None
    busy_ms = sum(device_us(e) for e in kernels) / 1e3
    say("profile", what=what, wall_ms=f"{wall_ms:.3f}", device_busy_ms=f"{busy_ms:.3f}",
        idle_share=f"{max(0.0, 1 - busy_ms / wall_ms):.3f}",
        launches=sum(e.count for e in kernels), host_waits=repr(waits))
    for e in kernels[:12]:
        say("profile", what=what, kernel=repr(e.key[:90]), calls=e.count,
            ms=f"{device_us(e) / 1e3:.3f}")
    return sum(e.count for e in kernels)


def main() -> None:
    card = phase_device()
    dev = torch.device("cuda", 0)
    set_tf32(False)         # the plain versions' float32 convs stay float32
    os.makedirs(WORK, exist_ok=True)
    phase_build()
    errs = phase_kernels(dev)
    train_errs = phase_train_kernels(dev)
    launches = phase_e2e(dev)
    train_launches = phase_train(dev)
    kernels = phase_timing(dev, errs, launches, train_errs, train_launches)
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main()
