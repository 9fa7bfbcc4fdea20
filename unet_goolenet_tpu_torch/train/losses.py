"""The losses the reference trains with (分割/util/loss.py), on NHWC tensors.

Counterpart of `unet_goolenet_tpu/train/losses.py:33-89,479-493`: the seg
loss `dc_and_bce_loss` (dice weight 0.5, 分割/main.py:245) with its parts,
and the classifier's `softmax_cross_entropy` (`cross_entropy`) and
`aux_weighted_cross_entropy`. Segmentation logits and targets are NHWC
(targets (N, H, W, 1) in {0, 1}); every loss is a float32 scalar (float64 for float64 inputs). The rest of
the JAX package's loss zoo is not ported yet (ROADMAP).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

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


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """torch.nn.CrossEntropyLoss: (..., C) logits widened to float32,
    integer labels, an optional per-class weight and the weighted mean
    (its denominator floored at 1e-12)."""
    logp = torch.log_softmax(wide(logits), dim=-1)
    nll = -logp.gather(-1, labels.long()[..., None])[..., 0]
    if weight is None:
        return nll.mean()
    w = weight.to(nll)[labels.long()]
    return (nll * w).sum() / (w.sum()).clamp_min(1e-12)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return softmax_cross_entropy(logits, labels)


def aux_weighted_cross_entropy(main_logits: torch.Tensor,
                               aux_logits: Sequence[Optional[torch.Tensor]],
                               labels: torch.Tensor, *, aux_weight: float = 0.3
                               ) -> torch.Tensor:
    """GoogLeNet's aux-head training loss: CE(main) + aux_weight * the sum
    of CE(aux_i) over the heads given (None skipped)."""
    loss = softmax_cross_entropy(main_logits, labels)
    for a in aux_logits:
        if a is not None:
            loss = loss + aux_weight * softmax_cross_entropy(a, labels)
    return loss
