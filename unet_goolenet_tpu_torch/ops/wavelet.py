"""Haar-wavelet pseudo-RGB preprocessing, batched over leading dims.

Counterpart of `unet_goolenet_tpu/ops/wavelet.py:27-105` (reference
分类/ROI_main.py:37-83): R = min-max-normalised gray, G = normalised
low-frequency cA resized back to full size, B = normalised high-frequency
magnitude sqrt(cH^2 + cV^2 + cD^2) resized back. The resize back is cv2-style
bilinear without antialiasing, and each channel is quantised through uint8
levels as floor(y * 255) / 255.
"""

from __future__ import annotations

from typing import Tuple

import torch

from unet_goolenet_tpu_torch.ops.resize import resize_planes


def haar_dwt2(x: torch.Tensor) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Level-1 2D Haar DWT of (..., H, W) -> (cA, (cH, cV, cD)), each
    (..., ceil(H/2), ceil(W/2)). Odd sizes are edge-padded to even."""
    if x.shape[-2] % 2:
        x = torch.cat([x, x[..., -1:, :]], dim=-2)
    if x.shape[-1] % 2:
        x = torch.cat([x, x[..., :, -1:]], dim=-1)
    a = x[..., 0::2, 0::2]
    b = x[..., 0::2, 1::2]
    c = x[..., 1::2, 0::2]
    d = x[..., 1::2, 1::2]
    ca = (a + b + c + d) * 0.5
    ch = (a + b - c - d) * 0.5
    cv = (a - b + c - d) * 0.5
    cd = (a - b - c + d) * 0.5
    return ca, (ch, cv, cd)


def _minmax_u8(x: torch.Tensor, quantize: bool) -> torch.Tensor:
    """Per-image min-max normalise over the last two dims to [0, 1], then
    optionally floor through uint8 levels."""
    lo = x.amin(dim=(-2, -1), keepdim=True)
    rng = x.amax(dim=(-2, -1), keepdim=True) - lo
    y = torch.where(rng > 0, (x - lo) / torch.clamp(rng, min=1e-30),
                    torch.zeros_like(x))
    if quantize:
        return torch.floor(y * 255.0) / 255.0
    return y


def wavelet_enhance(gray: torch.Tensor, *, quantize_uint8: bool = True,
                    channel_first: bool = False) -> torch.Tensor:
    """(..., H, W) grayscale in [0, 255] -> (..., H, W, 3) pseudo-RGB in
    [0, 1], float32 ((..., 3, H, W) with channel_first=True)."""
    gray = gray.float()
    h, w = gray.shape[-2:]
    ca, (ch, cv, cd) = haar_dwt2(gray)
    high = torch.sqrt(ch * ch + cv * cv + cd * cd)
    low_up = resize_planes(ca, (h, w), antialias=False)
    high_up = resize_planes(high, (h, w), antialias=False)
    planes = [_minmax_u8(t, quantize_uint8) for t in (gray, low_up, high_up)]
    return torch.stack(planes, dim=-3 if channel_first else -1)
