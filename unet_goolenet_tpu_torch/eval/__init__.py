"""Validation metrics of stage-1 training (Dice, IoU, Hausdorff)."""

from unet_goolenet_tpu_torch.eval.metrics import (
    SegMetrics, dice_score, hausdorff_distance, iou_score)

__all__ = ["SegMetrics", "dice_score", "hausdorff_distance", "iou_score"]
