"""Inference engine and the two-stage pipeline of the port."""

from unet_goolenet_tpu_torch.pipeline.two_stage import (
    TwoStagePipeline, extract_roi, preprocess_gray, preprocess_gray_padded, segment)

__all__ = ["TwoStagePipeline", "extract_roi", "preprocess_gray", "preprocess_gray_padded",
           "segment"]
