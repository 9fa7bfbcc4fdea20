"""Validation metrics of both stages (reference 分割/main.py:110-144,
分类/ROI_main.py:169-193).

Counterpart of `unet_goolenet_tpu/eval/metrics.py:27-231`.
Segmentation: monai's DiceMetric(include_background=False), MeanIoU and
HausdorffDistanceMetric(euclidean) semantics, per-sample scores with NaN
where undefined and a nan-mean over the epoch. Dice and IoU of a batch run
as tensor ops on the masks' device; the accumulator and the Hausdorff
distance (a distance transform, val-only) run on the host in numpy.
Classification, host numpy: the confusion matrix and torchmetrics' macro
F1, accuracy (mean recall) and one-vs-rest AUROC (task='multiclass'), each
averaged over the classes present in the targets or the predictions; AUROC
softmaxes the logits first, as torchmetrics does.
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


def confusion_matrix(preds, labels, num_classes: int) -> np.ndarray:
    """(num_classes, num_classes) counts, rows the true class, columns the
    predicted one."""
    cm = np.zeros((num_classes, num_classes), dtype=np.int64)
    np.add.at(cm, (np.asarray(labels, np.int64), np.asarray(preds, np.int64)), 1)
    return cm


def _present_classes(cm: np.ndarray) -> np.ndarray:
    """torchmetrics' macro average leaves out the classes absent from both
    the targets and the predictions."""
    return (cm.sum(1) > 0) | (cm.sum(0) > 0)


def macro_f1(cm: np.ndarray) -> float:
    """Per-class F1 (0 where undefined), mean over the present classes."""
    tp = np.diag(cm).astype(np.float64)
    fp = cm.sum(0) - tp
    fn = cm.sum(1) - tp
    denom = 2 * tp + fp + fn
    f1 = np.where(denom > 0, 2 * tp / np.maximum(denom, 1e-12), 0.0)
    present = _present_classes(cm)
    return float(f1[present].mean()) if present.any() else float("nan")


def macro_accuracy(cm: np.ndarray) -> float:
    """Per-class recall (0 without support), mean over the present classes."""
    tp = np.diag(cm).astype(np.float64)
    support = cm.sum(1)
    recall = np.where(support > 0, tp / np.maximum(support, 1e-12), 0.0)
    present = _present_classes(cm)
    return float(recall[present].mean()) if present.any() else float("nan")


def macro_auroc(scores, labels, num_classes: int) -> float:
    """One-vs-rest macro AUROC of the softmaxed scores: the Mann-Whitney
    statistic with average ranks over ties; classes absent from the labels,
    or covering all of them, are skipped."""
    scores = np.asarray(scores, np.float64)
    e = np.exp(scores - scores.max(axis=1, keepdims=True))
    scores = e / e.sum(axis=1, keepdims=True)
    labels = np.asarray(labels, np.int64)
    aucs = []
    for c in range(num_classes):
        pos = labels == c
        n_pos = int(pos.sum())
        n_neg = len(labels) - n_pos
        if n_pos == 0 or n_neg == 0:
            continue
        s = scores[:, c]
        order = np.argsort(s, kind="mergesort")
        sorted_s = s[order]
        ranks_sorted = np.arange(1, len(s) + 1, dtype=np.float64)
        i = 0
        while i < len(s):   # ties share their average rank
            j = i
            while j + 1 < len(s) and sorted_s[j + 1] == sorted_s[i]:
                j += 1
            ranks_sorted[i:j + 1] = 0.5 * (i + 1 + j + 1)
            i = j + 1
        ranks = np.empty(len(s), np.float64)
        ranks[order] = ranks_sorted
        aucs.append((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))
    return float(np.mean(aucs)) if aucs else float("nan")


def _host(t) -> np.ndarray:
    """A tensor (any dtype, any device; bf16 widened to float32) or array
    as numpy."""
    if isinstance(t, torch.Tensor):
        t = t.detach()
        return (t.float() if t.is_floating_point() else t).cpu().numpy()
    return np.asarray(t)


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


@dataclass
class ClsMetrics:
    """Streaming classification metrics of the reference's val loop: update
    with each batch's logits and labels, aggregate at the end."""

    num_classes: int = 6
    _scores: List[np.ndarray] = field(default_factory=list)
    _labels: List[np.ndarray] = field(default_factory=list)

    def update(self, logits, labels) -> None:
        self._scores.append(_host(logits))
        self._labels.append(_host(labels))

    def aggregate(self) -> dict:
        scores = np.concatenate(self._scores)
        labels = np.concatenate(self._labels)
        cm = confusion_matrix(scores.argmax(-1), labels, self.num_classes)
        return {"f1": macro_f1(cm), "accuracy": macro_accuracy(cm),
                "auroc": macro_auroc(scores, labels, self.num_classes), "confusion": cm}
