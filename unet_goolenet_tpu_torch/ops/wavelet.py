"""Haar-wavelet pseudo-RGB preprocessing, batched over leading dims.

Counterpart of `unet_goolenet_tpu/ops/wavelet.py:27-180` (reference
分类/ROI_main.py:37-83): R = min-max-normalised gray, G = normalised
low-frequency cA resized back to full size, B = normalised high-frequency
magnitude sqrt(cH^2 + cV^2 + cD^2) resized back. The resize back is cv2-style
bilinear without antialiasing, and each channel is quantised through uint8
levels as floor(y * 255) / 255. `wavelet_enhance_padded` is the same for
images edge-padded into a shared bucket buffer (the size buckets).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from unet_goolenet_tpu_torch.ops.resize import resize_bilinear_valid, resize_planes


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


def _minmax_u8_valid(x: torch.Tensor, mask: torch.Tensor, quantize: bool) -> torch.Tensor:
    """_minmax_u8 with the min and max taken over the valid region (mask)
    only; the whole buffer is normalised, and clipped to [0, 1] before the
    uint8 floor, as the JAX package's padded path does."""
    lo = torch.where(mask, x, torch.inf).amin(dim=(-2, -1), keepdim=True)
    rng = torch.where(mask, x, -torch.inf).amax(dim=(-2, -1), keepdim=True) - lo
    y = torch.where(rng > 0, (x - lo) / torch.clamp(rng, min=1e-30), torch.zeros_like(x))
    if quantize:
        return torch.floor(torch.clamp(y, 0.0, 1.0) * 255.0) / 255.0
    return y


def _clamped(n: int, limit: np.ndarray, device) -> torch.Tensor:
    """(N, n) indices min(arange(n), limit - 1) per image."""
    return torch.from_numpy(np.minimum(np.arange(n)[None, :], limit[:, None] - 1)).to(device)


def _gather(x: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """x[i, rows[i]][:, cols[i]] for each image i of (N, H, W)."""
    n = torch.arange(x.shape[0], device=x.device)[:, None, None]
    return x[n, rows[:, :, None], cols[:, None, :]]


def wavelet_enhance_padded(gray: torch.Tensor, valid_hw: Sequence[Sequence[int]], *,
                           quantize_uint8: bool = True,
                           channel_first: bool = False) -> torch.Tensor:
    """`wavelet_enhance` for a batch of edge-padded buffers, as
    `unet_goolenet_tpu.ops.wavelet_enhance_padded` (vmapped over the
    batch). gray is (N, H, W) with H and W even; image i is the top-left
    valid_hw[i] = (h, w) of its buffer and the pixels past it repeat its
    edge (np.pad mode="edge"). As there:
      * the DWT bands are clamp-gathered to ceil(h/2) x ceil(w/2), so the
        upsample's boundary taps see the edge coefficients;
      * cA and the high-frequency magnitude are upsampled to the (h, w)
        grid inside the buffer (resize_bilinear_valid), then edge-replicated
        past (h, w);
      * min-max statistics cover the valid region only, and values are
        clipped to [0, 1] before the uint8 floor.
    Returns (N, H, W, 3) float32 ((N, 3, H, W) with channel_first=True)."""
    gray = gray.float()
    dev, (n, hh, ww) = gray.device, gray.shape
    if hh % 2 or ww % 2:
        raise ValueError(f"bucket buffers must be even-sized, got {hh}x{ww}")
    valid = np.asarray(valid_hw, np.int64).reshape(n, 2)
    half = (valid + 1) // 2                    # pywt's ceil for odd sizes
    ca, (ch, cv, cd) = haar_dwt2(gray)
    high = torch.sqrt(ch * ch + cv * cv + cd * cd)
    band_rc = _clamped(hh // 2, half[:, 0], dev), _clamped(ww // 2, half[:, 1], dev)
    edge_rc = _clamped(hh, valid[:, 0], dev), _clamped(ww, valid[:, 1], dev)
    planes = [gray]
    for band in (ca, high):
        up = resize_bilinear_valid(_gather(band, *band_rc), half, (hh, ww),
                                   out_valid_hw=valid, antialias=False)
        planes.append(_gather(up, *edge_rc))
    h, w = (torch.from_numpy(valid[:, i]).to(dev)[:, None, None] for i in (0, 1))
    mask = (torch.arange(hh, device=dev)[:, None] < h) & (torch.arange(ww, device=dev) < w)
    planes = [_minmax_u8_valid(t, mask, quantize_uint8) for t in planes]
    return torch.stack(planes, dim=-3 if channel_first else -1)
