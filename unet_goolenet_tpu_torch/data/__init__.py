"""Host-side data layer: the seg dataset, augmentation, the loader (numpy
in, numpy out; the train step moves batches to the device)."""

from unet_goolenet_tpu_torch.data.augment import AugmentConfig, Augmenter
from unet_goolenet_tpu_torch.data.datasets import SegDataset
from unet_goolenet_tpu_torch.data.loader import DataLoader

__all__ = ["AugmentConfig", "Augmenter", "DataLoader", "SegDataset"]
