"""Stage-2 classifier training: the frozen-UNet ROI extractor.

Counterpart of `unet_goolenet_tpu/apps/train_cls.py:87-118`
(`make_roi_extractor`). Only the extractor is ported so far: the trainer's
`main`, its data loading and its training loop come with the training slice
of the port (ROADMAP queue 1, items 9-15).
"""

from __future__ import annotations

import torch

from unet_goolenet_tpu_torch.pipeline import engine as _engine
from unet_goolenet_tpu_torch.pipeline.two_stage import (
    check_device, check_fused, extract_roi, inference)


def make_roi_extractor(unet, img_size: int, *, engine: bool = True, fused: bool = False,
                       dtype: torch.dtype = torch.float32, device="cuda"):
    """The batched frozen-UNet -> masks -> (crops, full-image logits) step
    (the reference runs it per image inside its Dataset,
    分类/ROI_main.py:142-162 + util/roi.py:12-51).

    engine=True runs the BN-folded engine forward in `dtype`, and fused=True
    additionally puts pool + down1 and the up2-up4 levels on their kernels
    (all three of `engine.unet_forward`'s knobs), as the JAX extractor turns
    on all its fused levels. engine=False runs the `nn.Module` forward, in
    float32. Returns extract(imgs (N, S, S, 3) in [0, 1]) -> (crops
    (N, S, S, 3), logits (N, S, S, n_classes)), both in the compute dtype."""
    dev = check_device(device)
    if fused and not engine:
        raise ValueError("fused=True needs the engine forward (engine=True)")
    if not engine and dtype != torch.float32:
        raise ValueError("engine=False runs the module forward in float32 only")
    knobs = check_fused(img_size, fused_up2=fused, fused_up34=fused, fused_down1=fused)
    unet = unet.to(dev).eval()
    if engine:
        params = _engine.fold_unet(unet, dtype, **knobs)
        forward = lambda x: _engine.unet_forward(params, x, **knobs)
    else:
        forward = unet
    hw = (img_size, img_size)

    @inference
    def extract(imgs):
        imgs = torch.as_tensor(imgs).to(dev, dtype)
        logits = forward(imgs)
        masks = (torch.sigmoid(logits[..., 0]) > 0.5).float()
        crops, _ = extract_roi(imgs, masks, out_hw=hw)
        return crops, logits

    return extract
