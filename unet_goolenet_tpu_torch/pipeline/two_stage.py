"""The segment -> crop -> classify pipeline.

Counterpart of `unet_goolenet_tpu/pipeline/two_stage.py:35-108,111-339`:

    gray (N, H, W) --wavelet_enhance--> pseudo-RGB --resize 224--> UNet -->
    sigmoid > 0.5 --> bbox (+pad 30, centre fallback) --> crop-and-resize 224
    --> R/B channel swap (the reference's BGR2RGB, roi.py:44) --> GoogLeNet
    --> grades

Preprocessing runs in float32 at native resolution; both models run in the
pipeline's dtype (float32 or bfloat16, float32 accumulation). The crops are
taken from the same 224 pseudo-RGB tensor the UNet saw, then channel-swapped,
so the classifier sees (B, G, R) of the wavelet image, as in the reference.
`infer_grades_padded` takes images edge-padded into one bucket buffer with
their valid sizes (`preprocess_gray_padded`), so mixed native sizes share a
call.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from unet_goolenet_tpu_torch.ops.bbox import roi_from_mask
from unet_goolenet_tpu_torch.ops.resize import resize_bilinear_valid, resize_planes
from unet_goolenet_tpu_torch.ops.wavelet import wavelet_enhance, wavelet_enhance_padded
from unet_goolenet_tpu_torch.pipeline import engine
from unet_goolenet_tpu_torch.utils.device import check_device, inference


def preprocess_gray(gray: torch.Tensor, *, out_hw: Tuple[int, int] = (224, 224)
                    ) -> torch.Tensor:
    """(N, H, W) raw grayscale in [0, 255] -> (N, oh, ow, 3) wavelet
    pseudo-RGB in [0, 1], float32: wavelet at native resolution, then the
    antialiased (PIL-semantics) bilinear resize (分类/test.py:127-130)."""
    planes = wavelet_enhance(gray, channel_first=True)            # (N, 3, H, W)
    return resize_planes(planes, out_hw, antialias=True).permute(0, 2, 3, 1)


def preprocess_gray_padded(gray: torch.Tensor, valid_hw: Sequence[Sequence[int]], *,
                           out_hw: Tuple[int, int] = (224, 224)) -> torch.Tensor:
    """Size-bucket variant of preprocess_gray: gray (N, H, W) holds each
    image edge-padded (np.pad mode="edge") into the bucket buffer, and
    valid_hw (N, 2) each image's true size. The wavelet and its min-max run
    over the valid region, and the antialiased resize anchors its grid to
    it (ops.wavelet_enhance_padded, ops.resize_bilinear_valid)."""
    planes = wavelet_enhance_padded(gray, valid_hw, channel_first=True)  # (N, 3, H, W)
    return resize_bilinear_valid(planes, valid_hw, out_hw, antialias=True).permute(0, 2, 3, 1)


def segment(unet_params, imgs: torch.Tensor, **fused: bool
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The folded UNet forward (engine.unet_forward; up1 on its kernels,
    the knobs' levels on theirs) and the threshold: (N, S, S, 3) images ->
    (logits (N, S, S, 1), masks (N, S, S))."""
    logits = engine.unet_forward(unet_params, imgs, **fused)
    return logits, (torch.sigmoid(logits[..., 0]) > 0.5).float()


def extract_roi(imgs: torch.Tensor, masks: torch.Tensor, *, padding: int = 30,
                out_hw: Tuple[int, int] = (224, 224)
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched mask -> bbox -> crop with the reference's R/B swap. Returns
    (crops (N, oh, ow, 3), boxes (N, 4) [y0, y1, x0, x1])."""
    crops, boxes = roi_from_mask(imgs, masks, padding=padding, out_hw=out_hw)
    return crops.flip(-1), boxes


def check_fused(img_size: int, **knobs: bool) -> Dict[str, bool]:
    """The fused-level knobs as keyword arguments of engine.unet_forward;
    raises for an odd image size with a knob on (the kernels take even
    level sizes only)."""
    on = [k for k, v in knobs.items() if v]
    if on and img_size % 2:
        raise ValueError(f"{', '.join(on)} need an even img_size, got {img_size}")
    return {k: bool(v) for k, v in knobs.items()}


class TwoStagePipeline:
    """Both models, BN-folded once, behind the JAX pipeline's entry points.

        pipe = TwoStagePipeline(unet, gnet, dtype=torch.bfloat16, device="cuda")
        grades = pipe.infer_grades(gray_batch)        # (N,) int64
        out = pipe.infer_from_gray(gray_batch)        # dict of every stage

    The UNet's up1 level and head run on the CUDA kernels
    (engine.unet_forward). `fused_up2`, `fused_up34` and `fused_down1` (the
    JAX pipeline's names, off by default as there) move the up2 level, the
    up3 and up4 levels, and pool + down1 onto their kernels too. A knob that
    is on runs its kernel for every call on the card, or the call raises; it
    never takes a plain path, and an odd `img_size` with a knob on is refused
    here. Every call runs with TF32 off, so float32 work (preprocessing, and
    both models at dtype=float32) is float32 on the card.

    The pipeline runs on the card unless `device` says otherwise; without a
    CUDA device the default raises.
    """

    def __init__(self, unet, gnet, *, img_size: int = 224, padding: int = 30,
                 dtype: torch.dtype = torch.float32, device="cuda",
                 fused_up2: bool = False, fused_up34: bool = False,
                 fused_down1: bool = False):
        self.device = check_device(device)
        self.fused = check_fused(img_size, fused_up2=fused_up2, fused_up34=fused_up34,
                                 fused_down1=fused_down1)
        self.dtype = dtype
        self.hw = (img_size, img_size)
        self.padding = padding
        self.unet_params = engine.fold_unet(unet.to(self.device).eval(), dtype, **self.fused)
        self.gnet_params = engine.fold_gnet(gnet.to(self.device).eval(), dtype)

    def _input(self, t) -> torch.Tensor:
        return torch.as_tensor(t).to(self.device)

    def _seg(self, imgs: torch.Tensor):
        return segment(self.unet_params, imgs, **self.fused)

    def _from_imgs(self, imgs: torch.Tensor) -> Dict[str, torch.Tensor]:
        logits, masks = self._seg(imgs)
        crops, boxes = extract_roi(imgs, masks, padding=self.padding, out_hw=self.hw)
        cls_logits = engine.gnet_forward(self.gnet_params, crops)
        return {"grades": cls_logits.argmax(dim=-1), "cls_logits": cls_logits,
                "masks": masks, "boxes": boxes, "seg_logits": logits}

    @inference
    def infer_from_gray(self, gray) -> Dict[str, torch.Tensor]:
        """Full pipeline from raw grayscale (N, H, W) in [0, 255]."""
        imgs = preprocess_gray(self._input(gray), out_hw=self.hw).to(self.dtype)
        return self._from_imgs(imgs)

    def infer_grades(self, gray) -> torch.Tensor:
        """Raw grayscale (N, H, W) -> (N,) grades."""
        return self.infer_from_gray(gray)["grades"]

    @inference
    def infer_grades_padded(self, gray, valid_hw) -> torch.Tensor:
        """Size buckets: (N, H, W) edge-padded grays and their (N, 2) valid
        sizes -> (N,) grades."""
        imgs = preprocess_gray_padded(self._input(gray), valid_hw, out_hw=self.hw)
        return self._from_imgs(imgs.to(self.dtype))["grades"]

    @inference
    def infer_from_rgb(self, imgs) -> Dict[str, torch.Tensor]:
        """Pipeline from preprocessed (N, S, S, 3) images in [0, 1]."""
        return self._from_imgs(self._input(imgs).to(self.dtype))

    @inference
    def infer_masks(self, imgs) -> torch.Tensor:
        """Stage 1 only: (N, S, S, 3) images -> (N, S, S) masks."""
        return self._seg(self._input(imgs).to(self.dtype))[1]
