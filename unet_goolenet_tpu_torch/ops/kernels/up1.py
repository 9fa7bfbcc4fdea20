"""The UNet's last decoder level (up1) plus its 1x1 head, on two CUDA kernels.

Replaces the two Pallas TPU kernels of the JAX package's serving path:

  * `up1_gate` <- `unet_goolenet_tpu/ops/pallas/up1.py:fused_cbn_stats`
    (the gate pass): e1 = relu(conv3x3(x1, w) + b), plus the per-image,
    per-channel mean and max of e1 over (H, W) that feed CoordAtt3's 1x1
    squeeze-excite gate.
  * `up1_tail` <- `unet_goolenet_tpu/ops/pallas/up1.py:fused_up1_outc`:
        up     = convT2x2(y) + b_up
        d2     = relu(conv3x3(up) + b_d2)
        gated  = e1 + (1 + gate) * d2
        h      = relu(conv3x3(concat[up, gated]) + b_pair)
        y1     = relu(conv3x3(h) + b_blk1)
        logits = y1 @ w_outc + b_outc
    with y1 never written: the head runs in block1's epilogue.

Both launch the dense levels' kernels at C = 64 (`up2.gate_launch`,
`up2.level_launch`; sources `csrc/gate.cu`, `csrc/up_level.cu`, notes on
bounds and design there), each with its own launch counter. They take dense
NHWC tensors, float32 or bfloat16, with C = 64 channels, and accumulate in
float32. Between stages activations are rounded to the input dtype, and
biases stay float32, as in the TPU kernels.

`gate_weights` / `tail_weights` lay the folded weights out for the kernels
once (the engine does it in `fold_unet`), so the wrappers only check and
launch. Each wrapper takes its plain PyTorch version (`*_ref`) only for a
tensor on the CPU. For a CUDA tensor it launches the kernel or raises. Each
counts its calls that launch in `.launches`.
"""

from __future__ import annotations

import torch

from unet_goolenet_tpu_torch.ops.conv import conv2d
from unet_goolenet_tpu_torch.ops.kernels._common import (
    KernelWeights, bias, kernel_weights, round_to)
from unet_goolenet_tpu_torch.ops.kernels.up2 import (
    gate_launch, level_launch, up_gate_dense_ref, up_gate_weights, up_level_ref,
    up_level_weights)

KERNEL_CHANNELS = 64


# ------------------------------------------------------------ plain versions


# up1's gate pass is the dense levels' at C = 64: the same plain version and
# weight layout
up1_gate_ref = up_gate_dense_ref
gate_weights = up_gate_weights


def up1_tail_ref(y, e1, gate1p, w_up, b_up, w_d2, b_d2, w_pair, b_pair,
                 w_blk1, b_blk1, w_outc, b_outc):
    """Plain version of `up1_tail`. y (N, H/2, W/2, C); e1 (N, H, W, C);
    gate1p (N, C) = 1 + gate; w_up (C, C, 2, 2) ConvTranspose2d layout;
    w_d2, w_blk1 (C, C, 3, 3), w_pair (C, 2C, 3, 3) folded OIHW; w_outc
    (ncls, C, 1, 1). Returns logits (N, H, W, ncls) in y's dtype: the level
    as `up_level_ref` computes it, then the 1x1 head."""
    dt = y.dtype
    y1 = up_level_ref(y, e1, gate1p, w_up, b_up, w_d2, b_d2, w_pair, b_pair,
                      w_blk1, b_blk1).float()
    return conv2d(y1, round_to(w_outc, dt), b_outc.float()).to(dt)


# ------------------------------------------------------------ kernel wrappers


def _check_channels(t: torch.Tensor) -> None:
    if t.shape[-1] != KERNEL_CHANNELS:
        raise ValueError(f"up1 kernels take C={KERNEL_CHANNELS}, got {t.shape[-1]}")


def tail_weights(w_up, b_up, w_d2, b_d2, w_pair, b_pair, w_blk1, b_blk1, w_outc, b_outc,
                 dtype: torch.dtype) -> KernelWeights:
    """Weights of `up1_tail` for activations of `dtype`, in the layouts
    `up1_tail_ref` takes: the level's as `up_level_weights` lays them out,
    then the head's (w_outc (C, ncls), b_outc)."""
    ncls, c = w_outc.shape[:2]
    plain = (w_up, b_up, w_d2, b_d2, w_pair, b_pair, w_blk1, b_blk1, w_outc, b_outc)
    return kernel_weights(
        dtype, plain,
        lambda: (*up_level_weights(*plain[:8], dtype=dtype).kernel,
                 w_outc.to(dtype).reshape(ncls, c).t().contiguous(), bias(b_outc)))


def up1_gate(x1: torch.Tensor, wts: KernelWeights):
    """Gate pass of up1: (e1, mean, max) as `up1_gate_ref` describes, with
    weights from `gate_weights`."""
    if x1.device.type == "cpu":
        return up1_gate_ref(x1, *wts.plain)
    _check_channels(x1)
    out = gate_launch("up1_gate", x1, wts)
    up1_gate.launches += 1
    return out


def up1_tail(y: torch.Tensor, e1: torch.Tensor, gate1p: torch.Tensor,
             wts: KernelWeights) -> torch.Tensor:
    """up1 level + 1x1 head: logits as `up1_tail_ref` describes, with
    weights from `tail_weights`."""
    if y.device.type == "cpu":
        return up1_tail_ref(y, e1, gate1p, *wts.plain)
    _check_channels(y)
    out = level_launch("up1_tail", y, e1, gate1p, wts)
    up1_tail.launches += 1
    return out


up1_gate.launches = 0
up1_tail.launches = 0
