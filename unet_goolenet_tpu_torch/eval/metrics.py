"""Segmentation validation metrics (reference 分割/main.py:110-144).

Counterpart of `unet_goolenet_tpu/eval/metrics.py:27-87,171-215`: monai's
DiceMetric(include_background=False), MeanIoU and
HausdorffDistanceMetric(euclidean) semantics, per-sample scores with NaN
where undefined and a nan-mean over the epoch. Dice and IoU of a batch run
as tensor ops on the masks' device; the accumulator and the Hausdorff
distance (a distance transform, val-only) run on the host in numpy. The
classifier's metrics are not ported yet (ROADMAP).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch


def dice_score(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-sample binary Dice of (N, H, W[, 1]) masks in {0, 1}; NaN where
    both are empty."""
    p = pred.reshape(pred.shape[0], -1).float()
    t = target.reshape(target.shape[0], -1).float()
    inter = (p * t).sum(1)
    denom = p.sum(1) + t.sum(1)
    return torch.where(denom > 0, 2.0 * inter / denom, torch.full_like(denom, float("nan")))


def iou_score(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-sample binary IoU; NaN where the union is empty."""
    p = pred.reshape(pred.shape[0], -1).float()
    t = target.reshape(target.shape[0], -1).float()
    inter = (p * t).sum(1)
    union = p.sum(1) + t.sum(1) - inter
    return torch.where(union > 0, inter / union, torch.full_like(union, float("nan")))


def _boundary(mask: np.ndarray) -> np.ndarray:
    """Edge pixels of a binary mask (the mask minus its erosion; pixels on the
    image border stay surface, as monai's get_mask_edges)."""
    m = mask.astype(bool)
    if not m.any():
        return np.zeros_like(m)
    from scipy.ndimage import binary_erosion

    return m & ~binary_erosion(m, border_value=0)


def hausdorff_distance(pred: np.ndarray, target: np.ndarray,
                       percentile: Optional[float] = None) -> float:
    """Symmetric euclidean Hausdorff distance between the masks' surfaces;
    NaN if either mask is empty."""
    from scipy.ndimage import distance_transform_edt

    pb = _boundary(np.asarray(pred).squeeze())
    tb = _boundary(np.asarray(target).squeeze())
    if not pb.any() or not tb.any():
        return float("nan")

    def directed(a_edges, b_edges):
        d = distance_transform_edt(~b_edges)[a_edges]
        return float(np.percentile(d, percentile)) if percentile is not None else float(d.max())

    return max(directed(pb, tb), directed(tb, pb))


@dataclass
class SegMetrics:
    """Streaming accumulator of the reference's val loop: update with each
    batch's thresholded masks, aggregate a nan-mean at the end. The
    reference's empty-prediction hack (an all-zero mask gets pixel [0, 0, 0]
    set, main.py:134-136) is the opt-in `empty_pred_hack`."""

    empty_pred_hack: bool = False
    compute_hausdorff: bool = True
    _dice: List[np.ndarray] = field(default_factory=list)
    _iou: List[np.ndarray] = field(default_factory=list)
    _hd: List[float] = field(default_factory=list)

    def update(self, pred_masks, targets) -> None:
        p = np.array(torch.as_tensor(pred_masks).detach().cpu(), np.float64)
        t = np.asarray(torch.as_tensor(targets).detach().cpu(), np.float64)
        if self.empty_pred_hack:
            for i in range(p.shape[0]):
                if not p[i].any():
                    p[i][np.unravel_index(0, p[i].shape)] = 1
        pf = p.reshape(p.shape[0], -1)
        tf = t.reshape(t.shape[0], -1)
        inter = (pf * tf).sum(1)
        denom = pf.sum(1) + tf.sum(1)
        union = denom - inter
        with np.errstate(invalid="ignore", divide="ignore"):
            self._dice.append(np.where(denom > 0, 2 * inter / denom, np.nan))
            self._iou.append(np.where(union > 0, inter / union, np.nan))
        if self.compute_hausdorff:
            for i in range(p.shape[0]):
                self._hd.append(hausdorff_distance(p[i], t[i]))

    def aggregate(self) -> dict:
        nanmean = lambda xs: float(np.nanmean(np.concatenate(xs))) if xs else float("nan")
        out = {"dice": nanmean(self._dice), "iou": nanmean(self._iou)}
        if self.compute_hausdorff:
            out["hausdorff"] = float(np.nanmean(self._hd)) if self._hd else float("nan")
        return out
