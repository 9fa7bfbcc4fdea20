"""Shared CLI plumbing: checkpoints -> TwoStagePipeline.

Counterpart of `unet_goolenet_tpu/apps/common.py`. The serving entry points
(infer_e2e, serve) restore the two trained stages the same way, as the
reference's 分类/test.py:139-152 loads its two torch models. A checkpoint is
a torch file with the reference's parameter names: the port trainer's
snapshot (`{'model': ...}`, train/checkpoint.py), `{'net': state_dict}` or a
bare state dict (models/convert.py:load_reference_state_dict).
"""

from __future__ import annotations

import torch

from unet_goolenet_tpu_torch.models import (
    GoogLeNetClassifier, UNetTaskAligWeight, load_reference_state_dict)
from unet_goolenet_tpu_torch.pipeline import TwoStagePipeline


def load_two_stage(unet_checkpoint: str, gnet_checkpoint: str, *, img_size: int = 224,
                   num_classes: int = 6, dtype: torch.dtype = torch.float32,
                   device="cuda", **pipe_kwargs) -> TwoStagePipeline:
    """Restore both stages' checkpoints and build the pipeline on `device`
    (raises without a card unless device="cpu"). pipe_kwargs forward to
    TwoStagePipeline (its fused-level knobs)."""
    unet = load_reference_state_dict(unet_checkpoint, UNetTaskAligWeight(1, img_size=img_size))
    gnet = load_reference_state_dict(gnet_checkpoint, GoogLeNetClassifier(num_classes))
    return TwoStagePipeline(unet, gnet, img_size=img_size, dtype=dtype, device=device,
                            **pipe_kwargs)


def visible_devices(device) -> int:
    """How many devices of `device`'s type a data-parallel run would use."""
    return torch.cuda.device_count() if torch.device(device).type == "cuda" else 1
