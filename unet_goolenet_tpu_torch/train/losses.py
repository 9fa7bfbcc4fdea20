"""The losses the reference trains with (分割/util/loss.py), on NHWC tensors.

Counterpart of `unet_goolenet_tpu/train/losses.py:33-89`: the seg loss
`dc_and_bce_loss` (dice weight 0.5, 分割/main.py:245) with its parts, and the
classifier's `cross_entropy`. Segmentation logits and targets are NHWC
(targets (N, H, W, 1) in {0, 1}); every loss is a float32 scalar (float64 for float64 inputs). The rest of
the JAX package's loss zoo is not ported yet (ROADMAP).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from unet_goolenet_tpu_torch.ops.kernels._common import wide


def sigmoid_binary_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Elementwise BCE with logits, max(x, 0) - x*y + log1p(exp(-|x|)); no
    reduction."""
    x, y = wide(logits), wide(labels)
    return x.clamp_min(0) - x * y + torch.log1p(torch.exp(-x.abs()))


def soft_dice_loss(logits: torch.Tensor, target: torch.Tensor, *, sigmoid: bool = True,
                   smooth_nr: float = 1e-5, smooth_dr: float = 1e-5) -> torch.Tensor:
    """monai DiceLoss(sigmoid=True): per (sample, channel) dice over the
    spatial dims, mean-reduced."""
    p = torch.sigmoid(wide(logits)) if sigmoid else wide(logits)
    t = wide(target)
    spatial = tuple(range(1, p.ndim - 1))
    inter = (p * t).sum(dim=spatial)
    denom = p.sum(dim=spatial) + t.sum(dim=spatial)
    return (1.0 - (2.0 * inter + smooth_nr) / (denom + smooth_dr)).mean()


def dc_and_bce_loss(logits: torch.Tensor, target: torch.Tensor, *,
                    dice_weight: float = 0.5) -> torch.Tensor:
    """(1 - w) * BCEWithLogits + w * DiceLoss(sigmoid): the seg training loss."""
    bce = sigmoid_binary_cross_entropy(logits, target).mean()
    return (1.0 - dice_weight) * bce + dice_weight * soft_dice_loss(logits, target)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """torch.nn.CrossEntropyLoss: (..., C) logits, integer labels, mean."""
    return F.cross_entropy(wide(logits).reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).long())
