"""Separable bilinear resize as two matmuls.

Counterpart of `unet_goolenet_tpu/ops/resize.py:20-76`. The per-axis
`(n_out, n_in)` weight matrices follow the formula `jax.image.resize` uses
(half-pixel centres, triangle kernel, kernel widened by the downscale factor
when antialiasing, columns renormalised, samples outside the input zeroed),
computed in float32 on the host in the same operation order (the sample
position as one fused multiply-add, as XLA's CPU compiler emits it). With
`antialias=True` this is PIL's BILINEAR resize; with `antialias=False` it is
cv2's INTER_LINEAR. `F.interpolate(antialias=True)` is not assumed to equal
these weights.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _weight_mat_np(n_in: int, n_out: int, antialias: bool) -> np.ndarray:
    if n_in == n_out:
        # jax.image.resize skips axes whose size does not change
        return np.eye(n_in, dtype=np.float32)
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0)) if antialias else f32(1.0)
    # (i + 0.5) * inv_scale - 0.5 rounded once: the float64 product of two
    # float32 values is exact, so this equals a float32 fused multiply-add
    centres = np.arange(n_out, dtype=f32) + f32(0.5)
    sample_f = (centres.astype(np.float64) * float(inv_scale) - 0.5).astype(f32)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))               # (n_in, n_out)
    total = np.sum(w, axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    w = np.where(inside[None, :], w, f32(0.0))
    return np.ascontiguousarray(w.T.astype(np.float32))          # (n_out, n_in)


@functools.lru_cache(maxsize=64)
def weight_mat(n_in: int, n_out: int, antialias: bool,
               device=None) -> torch.Tensor:
    """(n_out, n_in) float32 resize weights for one axis, built once per
    device (callers must not write to it). Made outside inference mode, so
    that the cached tensor also serves calls that track gradients."""
    with torch.inference_mode(False):
        return torch.from_numpy(_weight_mat_np(n_in, n_out, antialias)).to(device)


def resize_planes(x: torch.Tensor, out_hw: Tuple[int, int], *,
                  antialias: bool = True) -> torch.Tensor:
    """Resize the last two dims (..., H, W) -> (..., oh, ow) in float32."""
    h, w = x.shape[-2:]
    a = weight_mat(h, out_hw[0], antialias, x.device)
    b = weight_mat(w, out_hw[1], antialias, x.device)
    return torch.matmul(torch.matmul(a, x.float()), b.T)


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int], *,
                    antialias: bool = True) -> torch.Tensor:
    """Bilinear resize of NHWC (rank 4), HWC (rank 3) or HW (rank 2) images,
    as `unet_goolenet_tpu.ops.resize_bilinear`. Computes in float32 and
    returns the input dtype."""
    if x.ndim == 2:
        return resize_planes(x, out_hw, antialias=antialias).to(x.dtype)
    if x.ndim not in (3, 4):
        raise ValueError(f"unsupported rank {x.ndim}")
    planes = x.movedim(-1, -3)                      # channels ahead of (H, W)
    out = resize_planes(planes, out_hw, antialias=antialias)
    return out.movedim(-3, -1).to(x.dtype)
