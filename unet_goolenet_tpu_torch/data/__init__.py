"""Data layer: the seg, classification and image-folder datasets, host
augmentation and the loader (numpy in, numpy out; the caller moves batches
to the device); the batched device augment is `augment_device`."""

from unet_goolenet_tpu_torch.data.augment import AugmentConfig, Augmenter
from unet_goolenet_tpu_torch.data.datasets import ClsDataset, ImageFolderDataset, SegDataset
from unet_goolenet_tpu_torch.data.loader import DataLoader

__all__ = ["AugmentConfig", "Augmenter", "ClsDataset", "DataLoader", "ImageFolderDataset",
           "SegDataset"]
