"""The dense decoder levels up2, up3 and up4, on two CUDA kernels.

Replaces the JAX package's Pallas kernels of those levels:

  * `up_gate_dense` <- `unet_goolenet_tpu/ops/pallas/up2.py:fused_cbn_stats_dense`
    (the gate pass): e1 = relu(conv3x3(x, w) + b), plus the per-image,
    per-channel mean and max of e1 over (H, W) that feed CoordAtt3's 1x1
    squeeze-excite gate. C = 128, 256, 512 at the model's levels. up1's
    gate pass (`up1.up1_gate`, C = 64) launches the same kernels.
  * `up_level` <- `unet_goolenet_tpu/ops/pallas/up2.py:fused_up2` and
    `:fused_up_dense` (one Pallas kernel, `_up2_kernel`):
        up    = convT2x2(x) + b_up
        d2    = relu(conv3x3(up) + b_d2)
        gated = e1 + (1 + gate) * d2
        hh    = relu(conv3x3(concat[up, gated]) + b_pair)
        out   = relu(conv3x3(hh) + b_blk1)
    with a dense (N, H, W, cq) output at every level; `fused_up2`'s packed
    output is a TPU layout. (C, cq) = (128, 64), (256, 128), (512, 256).

Sources: `csrc/gate.cu` and `csrc/up_level.cu` (notes on bounds, shared
memory and launch split there). The gate pass is two launches: in bfloat16
`csrc/conv3x3.cuh`'s TMA + wgmma GEMM with its STATS epilogue, which
writes e1 and one sum and max partial a (M tile, K-split rank), tiled by
`conv.conv_plan` (`ConvPlan.stats_slots` names the slots); in float32
`dense_conv.cuh`'s FMA `conv_kernel` in STATS mode, one partial a tile;
then a small kernel that sums each image's partials in slot order, with no
float atomics. The level is four launches: in bfloat16 the transposed conv
on `csrc/deconv.cu`'s TMA + wgmma GEMM and its three 3x3 convs on
`csrc/conv3x3.cuh`'s (epilogues GATE, PAIR over two tensor maps, and AFFINE
or the 1x1 head), tiled by `conv.level_plan`; in float32 four launches of
`dense_conv.cuh`'s FMA `conv_kernel`. The bf16 level is bound by its
tensor-core work (0.141 ms a level at batch 16 at 224^2), the bf16 gate by
its tensor-core work at up2-up4 (0.060 ms) and by a hair by memory at up1
(0.061 ms); a block holds 96 KB of shared memory in the
transposed conv and 202-214 KB in a 3x3 conv. It stays four launches
because each conv needs the whole of the stage before over a halo at every
channel, more than a block's 227 KB at these widths, so each stage waits
for the last. The kernels take dense NHWC tensors, float32 or bfloat16,
with channel counts that are multiples of 64 and any even level size, and
accumulate in float32. Stages are rounded to the input dtype at the TPU
kernel's points; biases stay float32.

`up_gate_weights` / `up_level_weights` lay the folded weights out once (the
engine does it in `fold_unet`): a gate or level call launches no weight
layout.
Each wrapper calls its custom op (`ugt::up_gate_dense`, `ugt::up_level`;
ops/kernels/library.py), which takes the plain version (`*_ref`) only for
a tensor on the CPU; for a CUDA tensor it launches the kernel
(`gate_launch`, `level_launch`) or raises. The op's CUDA implementation
counts the calls that launch in the wrapper's `.launches`.
"""

from __future__ import annotations

import torch

from unet_goolenet_tpu_torch.ops.conv import conv2d, conv_transpose2x2
from unet_goolenet_tpu_torch.ops.kernels._common import (
    BLOCK, INT, PTR, KernelWeights, bias, blocked_shape, blocked_taps, check, check_blocks,
    dense_channels, dtype_code, gemm_taps, kernel_weights, launched, lib_fn, round_to, stream)
from unet_goolenet_tpu_torch.ops.kernels.conv import _sms, conv_plan, level_plan


# ------------------------------------------------------------ plain versions


def up_gate_dense_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Plain version of `up_gate_dense`: x (N, H, W, C); w (C, C, 3, 3)
    folded OIHW; b (C,). Returns (e1 (N, H, W, C) in x's dtype, mean (N, C)
    f32, max (N, C) f32); the statistics are taken on e1 before rounding."""
    dt = x.dtype
    e1 = conv2d(x.float(), round_to(w, dt), b.float(), padding=1).relu()
    return e1.to(dt), e1.mean(dim=(1, 2)), e1.amax(dim=(1, 2))


def up_level_ref(x, e1, gate1p, w_up, b_up, w_d2, b_d2, w_pair, b_pair, w_blk1, b_blk1):
    """Plain version of `up_level`. x (N, H/2, W/2, C); e1 (N, H, W, C);
    gate1p (N, C) = 1 + gate; w_up (C, C, 2, 2) ConvTranspose2d layout; w_d2
    (C, C, 3, 3), w_pair (cq, 2C, 3, 3), w_blk1 (cq, cq, 3, 3) folded OIHW.
    Returns (N, H, W, cq) in x's dtype."""
    dt = x.dtype
    up = round_to(conv_transpose2x2(x.float(), round_to(w_up, dt), b_up.float()), dt)
    d2 = round_to(conv2d(up, round_to(w_d2, dt), b_d2.float(), padding=1).relu(), dt)
    gate = round_to(gate1p, dt)[:, None, None, :]
    gated = round_to(e1.float() + round_to(gate * d2, dt), dt)
    hh = conv2d(torch.cat([up, gated], dim=-1), round_to(w_pair, dt), b_pair.float(),
                padding=1).relu()
    hh = round_to(hh, dt)
    return conv2d(hh, round_to(w_blk1, dt), b_blk1.float(), padding=1).relu().to(dt)


# ------------------------------------------------------------ kernel wrappers


def gate_layout(w: torch.Tensor, b: torch.Tensor, dtype: torch.dtype):
    """The gate kernel's weights in `dtype`'s layouts: bf16 `gemm_taps` (9,
    C, C), float32 `blocked_taps`; the bias float32."""
    return (gemm_taps(w) if dtype == torch.bfloat16 else blocked_taps(w)), bias(b)


def gate_shape(c: int, dtype) -> tuple:
    """Shape of `gate_layout`'s weight for C channels."""
    return (9, c, c) if dtype == torch.bfloat16 else blocked_shape(c, c, 3)


def up_gate_weights(w: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> KernelWeights:
    """Weights of a gate pass (`up_gate_dense`, `up1.up1_gate`) for
    activations of `dtype`: w (C, C, 3, 3) folded OIHW, b (C,); on the CPU
    as given, on a card as `gate_layout` lays them out."""
    check_blocks(w)
    return kernel_weights(dtype, (w, b), lambda: gate_layout(w, b, dtype))


def deconv_as_conv1x1(w_up: torch.Tensor) -> torch.Tensor:
    """(Ci, Co, 2, 2) transposed-conv weights -> the (4*Co, Ci, 1, 1) 1x1
    conv whose output channel (di*2 + dj)*Co + o is output parity (di, dj),
    channel o."""
    ci, co = w_up.shape[:2]
    return w_up.permute(2, 3, 1, 0).reshape(4 * co, ci, 1, 1)


def level_layout(w_up, b_up, w_d2, b_d2, w_pair, b_pair, w_blk1, b_blk1, dtype: torch.dtype):
    """The level kernel's weights in `dtype`'s layouts: bf16 w_up as it lies
    in float32 (the transposed-conv GEMM reads it so) and each 3x3 conv as
    `gemm_taps` (9, cout, cin); float32 w_up as a 1x1 conv with 4C outputs
    and every conv in `blocked_taps`; biases float32."""
    if dtype == torch.bfloat16:
        convs = (gemm_taps(w_d2), gemm_taps(w_pair), gemm_taps(w_blk1))
        wup = w_up.detach().float().contiguous()
    else:
        convs = tuple(blocked_taps(w) for w in (w_d2, w_pair, w_blk1))
        wup = blocked_taps(deconv_as_conv1x1(w_up))
    return (wup, bias(b_up), convs[0], bias(b_d2), convs[1], bias(b_pair), convs[2],
            bias(b_blk1))


def up_level_weights(w_up, b_up, w_d2, b_d2, w_pair, b_pair, w_blk1, b_blk1,
                     dtype: torch.dtype) -> KernelWeights:
    """Weights of `up_level` for activations of `dtype`: on the CPU in the
    layouts `up_level_ref` takes, on a card as `level_layout` lays them out."""
    check_blocks(w_d2, w_pair, w_blk1)
    plain = (w_up, b_up, w_d2, b_d2, w_pair, b_pair, w_blk1, b_blk1)
    return kernel_weights(dtype, plain, lambda: level_layout(*plain, dtype=dtype))


def level_shapes(c: int, cq: int, dtype) -> tuple:
    """Shapes and dtypes of `level_layout`'s w_up, w_d2, w_pair, w_blk1."""
    if dtype == torch.bfloat16:
        return (((c, c, 2, 2), torch.float32), ((9, c, c), dtype), ((9, cq, 2 * c), dtype),
                ((9, cq, cq), dtype))
    return tuple((blocked_shape(co, ci, k), dtype)
                 for co, ci, k in ((4 * c, c, 1), (c, c, 3), (cq, 2 * c, 3), (cq, cq, 3)))


def gate_launch(name: str, x: torch.Tensor, weights):
    """One call of the gate kernels (csrc/gate.cu: the conv with its
    statistics' partials, then their reduce) on a CUDA tensor x (N, H, W,
    C) with weights laid out as `gate_layout` lays them out: (e1, mean,
    max). Checks every argument first; raises on any failure. The CUDA
    implementation of `library.up_gate_dense` and `library.up1_gate`."""
    code = dtype_code(name, x)
    n, h, wd, c = x.shape
    dense_channels(name, c)
    dev, dt = x.device, x.dtype
    check("x", x, (n, h, wd, c), dt)
    wk, bk = weights
    check("w", wk, gate_shape(c, dt), dt)
    check("b", bk, (c,), torch.float32)
    plan = None
    if dt == torch.bfloat16:
        p = conv_plan(False, n, h, wd, c, c, _sms(dev.index))
        plan, slots = (INT * 5)(*p.ints()), p.stats_slots
    else:
        slots = lib_fn("gate_tiles", [INT, INT])(h, wd)
    e1 = torch.empty_like(x)
    part = torch.empty((2, n, slots, c), device=dev, dtype=torch.float32)
    mean = torch.empty((n, c), device=dev, dtype=torch.float32)
    mx = torch.empty_like(mean)
    rc = lib_fn("gate_launch", [INT] + [PTR] * 8 + [INT] * 4 + [PTR] * 2)(
        code, x.data_ptr(), wk.data_ptr(), bk.data_ptr(), e1.data_ptr(),
        part[0].data_ptr(), part[1].data_ptr(), mean.data_ptr(), mx.data_ptr(),
        n, h, wd, c, plan, stream(x))
    launched(name, rc)
    return e1, mean, mx


def up_gate_dense(x: torch.Tensor, wts: KernelWeights):
    """Dense gate pass: (e1, mean, max) as `up_gate_dense_ref` describes,
    with weights from `up_gate_weights`; the op `ugt::up_gate_dense`."""
    return torch.ops.ugt.up_gate_dense(x, wts.args(x))


def level_launch(name: str, x: torch.Tensor, e1: torch.Tensor, gate1p: torch.Tensor,
                 weights) -> torch.Tensor:
    """One call of the level kernel (csrc/up_level.cu, four launches) on
    CUDA tensors: (N, H, W, cq) from weights laid out as `level_layout`
    lays them out, or the 1x1 head's (N, H, W, ncls) logits when the weights
    end with the head's (w_outc (cq, ncls), b_outc), as `up1.tail_weights`
    lays them out. Checks every argument first; raises on any failure. The
    CUDA implementation of `library.up_level` and `library.up1_tail`."""
    code = dtype_code(name, x)
    n, h2, w2, c = x.shape
    h, wd = 2 * h2, 2 * w2
    dev, dt = x.device, x.dtype
    wup, b_up, wd2, b_d2, wpair, b_pair, wblk1, b_blk1, *head = weights
    cq = b_pair.shape[0]
    dense_channels(name, c, cq)
    check("x", x, (n, h2, w2, c), dt)
    check("e1", e1, (n, h, wd, c), dt)
    g = gate1p.to(dt).contiguous()
    check("gate1p", g, (n, c), dt)
    for arg, t, (shape, wdt) in zip(("w_up", "w_d2", "w_pair", "w_blk1"),
                                    (wup, wd2, wpair, wblk1), level_shapes(c, cq, dt)):
        check(arg, t, shape, wdt)
    for arg, t, k in (("b_up", b_up, c), ("b_d2", b_d2, c), ("b_pair", b_pair, cq),
                      ("b_blk1", b_blk1, cq)):
        check(arg, t, (k,), torch.float32)
    wout = b_outc = None
    ncls = 0
    if head:
        wout, b_outc = head
        ncls = wout.shape[-1]
        if cq != BLOCK:
            raise ValueError(f"{name}: the 1x1 head takes cq={BLOCK}, got {cq}")
        check("w_outc", wout, (cq, ncls), dt)
        check("b_outc", b_outc, (ncls,), torch.float32)
    plan = None
    if dt == torch.bfloat16:
        plan = (INT * 15)(*level_plan(n, h, wd, c, cq, _sms(dev.index)).ints())
    up = torch.empty((n, h, wd, c), device=dev, dtype=dt)
    gated = torch.empty_like(up)
    hh = torch.empty((n, h, wd, cq), device=dev, dtype=dt)
    out = torch.empty((n, h, wd, ncls or cq), device=dev, dtype=dt)
    rc = lib_fn("up_level_launch", [INT] + [PTR] * 13 + [INT] + [PTR] * 4 + [INT] * 5
                + [PTR] * 2)(
        code, x.data_ptr(), e1.data_ptr(), g.data_ptr(),
        wup.data_ptr(), b_up.data_ptr(), wd2.data_ptr(), b_d2.data_ptr(),
        wpair.data_ptr(), b_pair.data_ptr(), wblk1.data_ptr(), b_blk1.data_ptr(),
        wout.data_ptr() if head else None, b_outc.data_ptr() if head else None, ncls,
        up.data_ptr(), gated.data_ptr(), hh.data_ptr(), out.data_ptr(),
        n, h, wd, c, cq, plan, stream(x))
    launched(name, rc)
    return out


def up_level(x: torch.Tensor, e1: torch.Tensor, gate1p: torch.Tensor,
             wts: KernelWeights) -> torch.Tensor:
    """One decoder level after its gate pass: (N, H, W, cq) as
    `up_level_ref` describes, with weights from `up_level_weights`; the op
    `ugt::up_level`."""
    return torch.ops.ugt.up_level(x, e1, gate1p, wts.args(x))


up_gate_dense.launches = 0
up_level.launches = 0
