"""Seeding and metric logging."""

from unet_goolenet_tpu_torch.utils.logging import MetricLogger
from unet_goolenet_tpu_torch.utils.seed import seed_everything

__all__ = ["MetricLogger", "seed_everything"]
