"""Mask -> bounding box -> ROI crop, batched over N.

Counterpart of `unet_goolenet_tpu/ops/bbox.py:23-105,150-164` (reference
分类/util/roi.py:12-51), written with a batch dimension instead of `vmap`:
  * box = [min - pad, max + pad] of the mask's true coordinates, clamped to
    [0, size] (exclusive end);
  * an empty mask falls back to a centre crop of side min(h, w) // 2;
  * the crop is resized with half-pixel bilinear sampling whose taps are
    clamped inside the box, so box edges replicate as slice-then-resize does.
"""

from __future__ import annotations

from typing import Tuple

import torch


def mask_to_bbox(mask: torch.Tensor, padding: int = 30) -> Tuple[torch.Tensor, ...]:
    """(N, H, W) binary masks -> (y0, y1, x0, x1, is_empty), each (N,)."""
    n, h, w = mask.shape
    m = mask.bool()
    rows = m.any(dim=2)
    cols = m.any(dim=1)
    nonempty = rows.any(dim=1)
    yidx = torch.arange(h, device=mask.device)
    xidx = torch.arange(w, device=mask.device)
    big = 1 << 30
    y_min = torch.where(rows, yidx, big).amin(dim=1)
    y_max = torch.where(rows, yidx, -1).amax(dim=1)
    x_min = torch.where(cols, xidx, big).amin(dim=1)
    x_max = torch.where(cols, xidx, -1).amax(dim=1)
    y0 = torch.clamp(y_min - padding, min=0)
    y1 = torch.clamp(y_max + padding, max=h)
    x0 = torch.clamp(x_min - padding, min=0)
    x1 = torch.clamp(x_max + padding, max=w)
    cy, cx = h // 2, w // 2
    half = (min(h, w) // 2) // 2
    y0 = torch.where(nonempty, y0, cy - half).int()
    y1 = torch.where(nonempty, y1, cy + half).int()
    x0 = torch.where(nonempty, x0, cx - half).int()
    x1 = torch.where(nonempty, x1, cx + half).int()
    return y0, y1, x0, x1, ~nonempty


def _sample_axis(lo: torch.Tensor, hi: torch.Tensor, n_out: int):
    """Half-pixel sample taps of n_out outputs over [lo, hi) per image:
    (i0, i1, t), each (N, n_out); taps are clamped inside the box."""
    lo = lo.float()[:, None]
    hi = hi.float()[:, None]
    step = (hi - lo) / n_out
    coords = (torch.arange(n_out, dtype=torch.float32, device=lo.device) + 0.5) * step - 0.5
    last = hi - lo - 1.0
    c0 = torch.clamp(torch.clamp(torch.floor(coords), min=0.0), max=last)
    c1 = torch.clamp(torch.clamp(c0 + 1.0, min=0.0), max=last)
    t = torch.clamp(coords - c0, 0.0, 1.0)
    return (c0 + lo).long(), (c1 + lo).long(), t


def crop_and_resize(images: torch.Tensor, boxes: Tuple[torch.Tensor, ...],
                    out_hw: Tuple[int, int]) -> torch.Tensor:
    """Crop (N, H, W, C) images to their exclusive-end boxes (y0, y1, x0, x1)
    and bilinearly resize each crop to out_hw. Returns the input dtype."""
    y0, y1, x0, x1 = boxes
    oh, ow = out_hw
    iy0, iy1, ty = _sample_axis(y0, y1, oh)
    ix0, ix1, tx = _sample_axis(x0, x1, ow)
    img = images.float()
    nidx = torch.arange(images.shape[0], device=images.device)[:, None]
    top = img[nidx, iy0]                                  # (N, oh, W, C)
    bot = img[nidx, iy1]
    rows = top + (bot - top) * ty[:, :, None, None]
    nidx3 = nidx[:, :, None]
    ridx = torch.arange(oh, device=images.device)[None, :, None]
    left = rows[nidx3, ridx, ix0[:, None, :]]             # (N, oh, ow, C)
    right = rows[nidx3, ridx, ix1[:, None, :]]
    out = left + (right - left) * tx[:, None, :, None]
    return out.to(images.dtype)


def roi_from_mask(images: torch.Tensor, masks: torch.Tensor, *,
                  padding: int = 30, out_hw: Tuple[int, int] = (224, 224)
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, H, W, C) images + (N, H, W) masks -> ((N, oh, ow, C) crops,
    (N, 4) int32 boxes [y0, y1, x0, x1])."""
    y0, y1, x0, x1, _ = mask_to_bbox(masks, padding)
    crops = crop_and_resize(images, (y0, y1, x0, x1), out_hw)
    return crops, torch.stack([y0, y1, x0, x1], dim=1)
