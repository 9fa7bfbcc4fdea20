"""The segment -> crop -> classify pipeline.

Counterpart of `unet_goolenet_tpu/pipeline/two_stage.py:35-62,94-108,111-339`:

    gray (N, H, W) --wavelet_enhance--> pseudo-RGB --resize 224--> UNet -->
    sigmoid > 0.5 --> bbox (+pad 30, centre fallback) --> crop-and-resize 224
    --> R/B channel swap (the reference's BGR2RGB, roi.py:44) --> GoogLeNet
    --> grades

Preprocessing runs in float32 at native resolution; both models run in the
pipeline's dtype (float32 or bfloat16, float32 accumulation). The crops are
taken from the same 224 pseudo-RGB tensor the UNet saw, then channel-swapped,
so the classifier sees (B, G, R) of the wavelet image, as in the reference.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

from unet_goolenet_tpu_torch.ops.bbox import roi_from_mask
from unet_goolenet_tpu_torch.ops.resize import resize_planes
from unet_goolenet_tpu_torch.ops.wavelet import wavelet_enhance
from unet_goolenet_tpu_torch.pipeline import engine


def _inference(fn):
    """Run fn in inference mode with TF32 off, and restore the TF32 flags
    after: PyTorch lets cuDNN convs use TF32 for float32 by default."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        try:
            with torch.inference_mode():
                return fn(*args, **kwargs)
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    return run


def preprocess_gray(gray: torch.Tensor, *, out_hw: Tuple[int, int] = (224, 224)
                    ) -> torch.Tensor:
    """(N, H, W) raw grayscale in [0, 255] -> (N, oh, ow, 3) wavelet
    pseudo-RGB in [0, 1], float32: wavelet at native resolution, then the
    antialiased (PIL-semantics) bilinear resize (分类/test.py:127-130)."""
    planes = wavelet_enhance(gray, channel_first=True)            # (N, 3, H, W)
    return resize_planes(planes, out_hw, antialias=True).permute(0, 2, 3, 1)


def extract_roi(imgs: torch.Tensor, masks: torch.Tensor, *, padding: int = 30,
                out_hw: Tuple[int, int] = (224, 224)
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched mask -> bbox -> crop with the reference's R/B swap. Returns
    (crops (N, oh, ow, 3), boxes (N, 4) [y0, y1, x0, x1])."""
    crops, boxes = roi_from_mask(imgs, masks, padding=padding, out_hw=out_hw)
    return crops.flip(-1), boxes


class TwoStagePipeline:
    """Both models, BN-folded once, behind the JAX pipeline's entry points.

        pipe = TwoStagePipeline(unet, gnet, dtype=torch.bfloat16, device="cuda")
        grades = pipe.infer_grades(gray_batch)        # (N,) int64
        out = pipe.infer_from_gray(gray_batch)        # dict of every stage

    The UNet's up1 level and head run on the CUDA kernels
    (engine.unet_forward). Every call runs with TF32 off, so float32 work
    (preprocessing, and both models at dtype=float32) is float32 on the card.
    """

    def __init__(self, unet, gnet, *, img_size: int = 224, padding: int = 30,
                 dtype: torch.dtype = torch.float32, device="cpu"):
        self.device = torch.device(device)
        self.dtype = dtype
        self.hw = (img_size, img_size)
        self.padding = padding
        self.unet_params = engine.fold_unet(unet.to(self.device).eval(), dtype)
        self.gnet_params = engine.fold_gnet(gnet.to(self.device).eval(), dtype)

    def _input(self, t) -> torch.Tensor:
        return torch.as_tensor(t).to(self.device)

    def _seg(self, imgs: torch.Tensor):
        logits = engine.unet_forward(self.unet_params, imgs)
        masks = (torch.sigmoid(logits[..., 0]) > 0.5).float()
        return logits, masks

    def _from_imgs(self, imgs: torch.Tensor) -> Dict[str, torch.Tensor]:
        logits, masks = self._seg(imgs)
        crops, boxes = extract_roi(imgs, masks, padding=self.padding, out_hw=self.hw)
        cls_logits = engine.gnet_forward(self.gnet_params, crops)
        return {"grades": cls_logits.argmax(dim=-1), "cls_logits": cls_logits,
                "masks": masks, "boxes": boxes, "seg_logits": logits}

    @_inference
    def infer_from_gray(self, gray) -> Dict[str, torch.Tensor]:
        """Full pipeline from raw grayscale (N, H, W) in [0, 255]."""
        imgs = preprocess_gray(self._input(gray), out_hw=self.hw).to(self.dtype)
        return self._from_imgs(imgs)

    def infer_grades(self, gray) -> torch.Tensor:
        """Raw grayscale (N, H, W) -> (N,) grades."""
        return self.infer_from_gray(gray)["grades"]

    @_inference
    def infer_from_rgb(self, imgs) -> Dict[str, torch.Tensor]:
        """Pipeline from preprocessed (N, S, S, 3) images in [0, 1]."""
        return self._from_imgs(self._input(imgs).to(self.dtype))

    @_inference
    def infer_masks(self, imgs) -> torch.Tensor:
        """Stage 1 only: (N, S, S, 3) images -> (N, S, S) masks."""
        return self._seg(self._input(imgs).to(self.dtype))[1]
