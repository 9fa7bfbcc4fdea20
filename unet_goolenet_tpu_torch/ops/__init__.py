"""Tensor ops of the port (NHWC at the interface, like the JAX package)."""

from unet_goolenet_tpu_torch.ops.bbox import crop_and_resize, mask_to_bbox, roi_from_mask
from unet_goolenet_tpu_torch.ops.conv import conv2d, conv_transpose2x2, fold_batchnorm
from unet_goolenet_tpu_torch.ops.pool import adaptive_avg_pool, max_pool2d, max_pool2d_nchw
from unet_goolenet_tpu_torch.ops.resize import (
    resize_bilinear, resize_bilinear_valid, resize_planes, weight_mat)
from unet_goolenet_tpu_torch.ops.wavelet import haar_dwt2, wavelet_enhance, wavelet_enhance_padded

__all__ = [
    "adaptive_avg_pool", "conv2d", "conv_transpose2x2", "crop_and_resize", "fold_batchnorm",
    "haar_dwt2", "mask_to_bbox", "max_pool2d", "max_pool2d_nchw", "resize_bilinear",
    "resize_bilinear_valid", "resize_planes", "roi_from_mask", "wavelet_enhance",
    "wavelet_enhance_padded", "weight_mat",
]
