"""Host-side data layer: the seg and image-folder datasets, augmentation,
the loader (numpy in, numpy out; the caller moves batches to the
device)."""

from unet_goolenet_tpu_torch.data.augment import AugmentConfig, Augmenter
from unet_goolenet_tpu_torch.data.datasets import ImageFolderDataset, SegDataset
from unet_goolenet_tpu_torch.data.loader import DataLoader

__all__ = ["AugmentConfig", "Augmenter", "DataLoader", "ImageFolderDataset", "SegDataset"]
