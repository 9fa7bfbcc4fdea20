"""Validation metrics of both stages: Dice, IoU, Hausdorff; confusion
matrix, macro F1, accuracy and AUROC."""

from unet_goolenet_tpu_torch.eval.metrics import (
    ClsMetrics, SegMetrics, confusion_matrix, dice_score, hausdorff_distance, iou_score,
    macro_accuracy, macro_auroc, macro_f1)

__all__ = ["ClsMetrics", "SegMetrics", "confusion_matrix", "dice_score", "hausdorff_distance",
           "iou_score", "macro_accuracy", "macro_auroc", "macro_f1"]
