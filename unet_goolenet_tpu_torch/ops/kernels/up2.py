"""The dense decoder levels up2, up3 and up4, on two CUDA kernels.

Replaces the JAX package's Pallas kernels of those levels:

  * `up_gate_dense` <- `unet_goolenet_tpu/ops/pallas/up2.py:fused_cbn_stats_dense`
    (the gate pass): e1 = relu(conv3x3(x, w) + b), plus the per-image,
    per-channel mean and max of e1 over (H, W) that feed CoordAtt3's 1x1
    squeeze-excite gate. C = 128, 256, 512 at the model's levels. up1's
    gate pass (`up1.up1_gate`, C = 64) launches the same kernel.
  * `up_level` <- `unet_goolenet_tpu/ops/pallas/up2.py:fused_up2` and
    `:fused_up_dense` (one Pallas kernel, `_up2_kernel`):
        up    = convT2x2(x) + b_up
        d2    = relu(conv3x3(up) + b_d2)
        gated = e1 + (1 + gate) * d2
        hh    = relu(conv3x3(concat[up, gated]) + b_pair)
        out   = relu(conv3x3(hh) + b_blk1)
    with a dense (N, H, W, cq) output at every level; `fused_up2`'s packed
    output is a TPU layout. (C, cq) = (128, 64), (256, 128), (512, 256).

Sources: `csrc/gate.cu`, `csrc/up_level.cu` on `csrc/dense_conv.cuh`
(notes on bounds, shared memory and launch split there). The kernels take
dense NHWC tensors, float32 or bfloat16, with channel counts that are
multiples of 64 and any even level size, and accumulate in float32. Stages
are rounded to the input dtype at the TPU kernel's points; biases stay
float32.

`up_gate_weights` / `up_level_weights` lay the folded weights out once (the
engine does it in `fold_unet`). Each wrapper takes its plain version
(`*_ref`) only for a tensor on the CPU. For a CUDA tensor it launches the
kernel or raises. Each counts its calls that launch in `.launches`.
"""

from __future__ import annotations

import torch

from unet_goolenet_tpu_torch.ops.conv import conv2d, conv_transpose2x2
from unet_goolenet_tpu_torch.ops.kernels._common import (
    BLOCK, INT, PTR, KernelWeights, bias, blocked_shape, blocked_taps, check, check_blocks,
    dense_channels, dtype_code, kernel_weights, launched, lib_fn, round_to, stream)


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


def up_gate_weights(w: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> KernelWeights:
    """Weights of a gate pass (`up_gate_dense`, `up1.up1_gate`) for
    activations of `dtype`: w (C, C, 3, 3) folded OIHW, b (C,)."""
    check_blocks(w)
    return kernel_weights(dtype, (w, b), lambda: (blocked_taps(w, dtype), bias(b)))


def deconv_as_conv1x1(w_up: torch.Tensor) -> torch.Tensor:
    """(Ci, Co, 2, 2) transposed-conv weights -> the (4*Co, Ci, 1, 1) 1x1
    conv whose output channel (di*2 + dj)*Co + o is output parity (di, dj),
    channel o."""
    ci, co = w_up.shape[:2]
    return w_up.permute(2, 3, 1, 0).reshape(4 * co, ci, 1, 1)


def up_level_weights(w_up, b_up, w_d2, b_d2, w_pair, b_pair, w_blk1, b_blk1,
                     dtype: torch.dtype) -> KernelWeights:
    """Weights of `up_level` for activations of `dtype`, in the layouts
    `up_level_ref` takes."""
    check_blocks(w_d2, w_pair, w_blk1)
    return kernel_weights(dtype, (w_up, b_up, w_d2, b_d2, w_pair, b_pair, w_blk1, b_blk1),
                          lambda: (blocked_taps(deconv_as_conv1x1(w_up), dtype), bias(b_up),
                                   blocked_taps(w_d2, dtype), bias(b_d2),
                                   blocked_taps(w_pair, dtype), bias(b_pair),
                                   blocked_taps(w_blk1, dtype), bias(b_blk1)))


def gate_launch(name: str, x: torch.Tensor, wts: KernelWeights):
    """One launch of the gate kernel (csrc/gate.cu) on a CUDA tensor x
    (N, H, W, C): (e1, mean, max). Checks every argument first."""
    code = dtype_code(name, x)
    n, h, wd, c = x.shape
    dense_channels(name, c)
    dev, dt = x.device, x.dtype
    check("x", x, (n, h, wd, c), dt)
    wk, bk = wts.kernel
    check("w", wk, blocked_shape(c, c, 3, dt), dt)
    check("b", bk, (c,), torch.float32)
    tiles = lib_fn("gate_tiles", [INT, INT])(h, wd)
    e1 = torch.empty_like(x)
    part = torch.empty((2, n, tiles, c), device=dev, dtype=torch.float32)
    stats = torch.empty((2, n, c), device=dev, dtype=torch.float32)
    rc = lib_fn("gate_launch", [INT] + [PTR] * 8 + [INT] * 4 + [PTR])(
        code, x.data_ptr(), wk.data_ptr(), bk.data_ptr(), e1.data_ptr(),
        part[0].data_ptr(), part[1].data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
        n, h, wd, c, stream(x))
    launched(name, rc)
    return e1, stats[0], stats[1]


def up_gate_dense(x: torch.Tensor, wts: KernelWeights):
    """Dense gate pass: (e1, mean, max) as `up_gate_dense_ref` describes,
    with weights from `up_gate_weights`."""
    if x.device.type == "cpu":
        return up_gate_dense_ref(x, *wts.plain)
    out = gate_launch("up_gate_dense", x, wts)
    up_gate_dense.launches += 1
    return out


def level_launch(name: str, x: torch.Tensor, e1: torch.Tensor, gate1p: torch.Tensor,
                 wts: KernelWeights) -> torch.Tensor:
    """One call of the level kernel (csrc/up_level.cu) on CUDA tensors:
    (N, H, W, cq) from weights laid out as `up_level_weights` lays them out,
    or the 1x1 head's (N, H, W, ncls) logits when the weights end with the
    head's (w_outc (cq, ncls), b_outc), as `up1.tail_weights` lays them out.
    Checks every argument first."""
    code = dtype_code(name, x)
    n, h2, w2, c = x.shape
    h, wd = 2 * h2, 2 * w2
    dev, dt = x.device, x.dtype
    wup, b_up, wd2, b_d2, wpair, b_pair, wblk1, b_blk1, *head = wts.kernel
    cq = b_pair.shape[0]
    dense_channels(name, c, cq)
    check("x", x, (n, h2, w2, c), dt)
    check("e1", e1, (n, h, wd, c), dt)
    g = gate1p.to(dt).contiguous()
    check("gate1p", g, (n, c), dt)
    for arg, t, shape in (("w_up", wup, blocked_shape(4 * c, c, 1, dt)),
                          ("w_d2", wd2, blocked_shape(c, c, 3, dt)),
                          ("w_pair", wpair, blocked_shape(cq, 2 * c, 3, dt)),
                          ("w_blk1", wblk1, blocked_shape(cq, cq, 3, dt))):
        check(arg, t, shape, dt)
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
    up = torch.empty((n, h, wd, c), device=dev, dtype=dt)
    gated = torch.empty_like(up)
    hh = torch.empty((n, h, wd, cq), device=dev, dtype=dt)
    out = torch.empty((n, h, wd, ncls or cq), device=dev, dtype=dt)
    rc = lib_fn("up_level_launch", [INT] + [PTR] * 13 + [INT] + [PTR] * 4 + [INT] * 5 + [PTR])(
        code, x.data_ptr(), e1.data_ptr(), g.data_ptr(),
        wup.data_ptr(), b_up.data_ptr(), wd2.data_ptr(), b_d2.data_ptr(),
        wpair.data_ptr(), b_pair.data_ptr(), wblk1.data_ptr(), b_blk1.data_ptr(),
        wout.data_ptr() if head else None, b_outc.data_ptr() if head else None, ncls,
        up.data_ptr(), gated.data_ptr(), hh.data_ptr(), out.data_ptr(),
        n, h, wd, c, cq, stream(x))
    launched(name, rc)
    return out


def up_level(x: torch.Tensor, e1: torch.Tensor, gate1p: torch.Tensor,
             wts: KernelWeights) -> torch.Tensor:
    """One decoder level after its gate pass: (N, H, W, cq) as
    `up_level_ref` describes, with weights from `up_level_weights`."""
    if x.device.type == "cpu":
        return up_level_ref(x, e1, gate1p, *wts.plain)
    out = level_launch("up_level", x, e1, gate1p, wts)
    up_level.launches += 1
    return out


up_gate_dense.launches = 0
up_level.launches = 0
