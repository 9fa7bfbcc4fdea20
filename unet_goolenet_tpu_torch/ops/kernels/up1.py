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
bounds and design there), each with its own launch counter. `up1_gate` is
two launches: in bfloat16 the conv on `csrc/conv3x3.cuh`'s TMA + wgmma
GEMM, whose STATS epilogue writes e1 and per-tile sum and max partials, in
float32 on `csrc/dense_conv.cuh`'s `conv_kernel`; then the partials'
reduce in tile order (bf16 bound: 0.061 ms at batch 16 and 224^2, set by
memory by a hair). `up1_tail` is four launches: in bfloat16 the transposed
conv on `csrc/deconv.cu`'s TMA + wgmma GEMM, d2 (with the gate), the pair
conv and block1 on `csrc/conv3x3.cuh`'s, the head in block1's epilogue
(the block's 64 channels are one 64-column tile, so only the logits are
written); in float32 on `csrc/dense_conv.cuh`'s `conv_kernel`. bf16 bound:
the tensor-core work, 0.246 ms at batch 16 and 224^2. They take dense NHWC
tensors, float32 or bfloat16, with C = 64 channels, and accumulate in
float32. Between stages activations are rounded to the input dtype, and
biases stay float32, as in the TPU kernels.

`gate_weights` / `tail_weights` lay the folded weights out for the kernels
once (the engine does it in `fold_unet`), so a call only checks and
launches. Each wrapper calls its custom op (`ugt::up1_gate`,
`ugt::up1_tail`; ops/kernels/library.py), which takes the plain PyTorch
version (`*_ref`) only for a tensor on the CPU; for a CUDA tensor it
launches the kernel or raises. The op's CUDA implementation counts the
calls that launch in the wrapper's `.launches`.
"""

from __future__ import annotations

import torch

from unet_goolenet_tpu_torch.ops.conv import conv2d
from unet_goolenet_tpu_torch.ops.kernels._common import (
    KernelWeights, bias, kernel_weights, round_to)
from unet_goolenet_tpu_torch.ops.kernels.up2 import (
    level_layout, up_gate_dense_ref, up_gate_weights, up_level_ref)

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


def check_channels(t: torch.Tensor) -> None:
    if t.shape[-1] != KERNEL_CHANNELS:
        raise ValueError(f"up1 kernels take C={KERNEL_CHANNELS}, got {t.shape[-1]}")


def tail_weights(w_up, b_up, w_d2, b_d2, w_pair, b_pair, w_blk1, b_blk1, w_outc, b_outc,
                 dtype: torch.dtype) -> KernelWeights:
    """Weights of `up1_tail` for activations of `dtype`: on the CPU in the
    layouts `up1_tail_ref` takes; on a card the level's as
    `up2.level_layout` lays them out, then the head's (w_outc (C, ncls) in
    `dtype`, b_outc)."""
    ncls, c = w_outc.shape[:2]
    plain = (w_up, b_up, w_d2, b_d2, w_pair, b_pair, w_blk1, b_blk1, w_outc, b_outc)
    return kernel_weights(
        dtype, plain,
        lambda: (*level_layout(*plain[:8], dtype=dtype),
                 w_outc.to(dtype).reshape(ncls, c).t().contiguous(), bias(b_outc)))


def up1_gate(x1: torch.Tensor, wts: KernelWeights):
    """Gate pass of up1: (e1, mean, max) as `up1_gate_ref` describes, with
    weights from `gate_weights`; the op `ugt::up1_gate`."""
    return torch.ops.ugt.up1_gate(x1, wts.args(x1))


def up1_tail(y: torch.Tensor, e1: torch.Tensor, gate1p: torch.Tensor,
             wts: KernelWeights) -> torch.Tensor:
    """up1 level + 1x1 head: logits as `up1_tail_ref` describes, with
    weights from `tail_weights`; the op `ugt::up1_tail`."""
    return torch.ops.ugt.up1_tail(y, e1, gate1p, wts.args(y))


up1_gate.launches = 0
up1_tail.launches = 0
