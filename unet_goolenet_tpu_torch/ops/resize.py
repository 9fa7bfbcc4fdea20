"""Separable bilinear resize as two matmuls.

Counterpart of `unet_goolenet_tpu/ops/resize.py:20-133`. The per-axis
`(n_out, n_in)` weight matrices follow the formula `jax.image.resize` uses
(half-pixel centres, triangle kernel, kernel widened by the downscale factor
when antialiasing, columns renormalised, samples outside the input zeroed),
computed in float32 on the host in the same operation order (the sample
position as one fused multiply-add, as XLA's CPU compiler emits it). With
`antialias=True` this is PIL's BILINEAR resize; with `antialias=False` it is
cv2's INTER_LINEAR. `F.interpolate(antialias=True)` is not assumed to equal
these weights. `resize_bilinear_valid` resizes the top-left valid region of
each image of a padded batch (the size buckets).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _weight_mat_np(n_in: int, n_out: int, antialias: bool) -> np.ndarray:
    if n_in == n_out:
        # jax.image.resize skips axes whose size does not change
        return np.eye(n_in, dtype=np.float32)
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    # (i + 0.5) * inv_scale - 0.5 rounded once: the float64 product of two
    # float32 values is exact, so this equals a float32 fused multiply-add
    centres = np.arange(n_out, dtype=f32) + f32(0.5)
    sample_f = (centres.astype(np.float64) * float(inv_scale) - 0.5).astype(f32)
    return _weights_from_samples(sample_f, n_in, inv_scale, antialias)


def _weights_from_samples(sample_f: np.ndarray, n_in: int, inv_scale: np.float32,
                          antialias: bool) -> np.ndarray:
    """(n_out, n_in) float32 triangle weights of jax.image's resize at the
    float32 sample positions `sample_f`: the kernel widened by the downscale
    factor when antialiasing, columns renormalised, samples outside the
    input zeroed."""
    f32 = np.float32
    kernel_scale = max(inv_scale, f32(1.0)) if antialias else f32(1.0)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))               # (n_in, n_out)
    total = np.sum(w, axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    w = np.where(inside[None, :], w, f32(0.0))
    return np.ascontiguousarray(w.T.astype(np.float32))          # (n_out, n_in)


_WEIGHTS: dict = {}     # (n_in, n_out, antialias, device) -> weight_mat's tensor
_WEIGHTS_MAX = 64


def weight_mat(n_in: int, n_out: int, antialias: bool,
               device=None) -> torch.Tensor:
    """(n_out, n_in) float32 resize weights for one axis, built once per
    device (callers must not write to it). Made outside inference mode, so
    that the cached tensor also serves calls that track gradients. A trace
    (torch.export, pipeline/export.py) reads the cache but never fills it:
    what it builds is a traced value, which would poison later calls, and
    what it reads enters the traced graph as a constant on the device."""
    key = (n_in, n_out, antialias, device)
    w = _WEIGHTS.get(key)
    if w is None:
        with torch.inference_mode(False):
            w = torch.from_numpy(_weight_mat_np(n_in, n_out, antialias)).to(device)
        if not torch.compiler.is_compiling():
            if len(_WEIGHTS) >= _WEIGHTS_MAX:
                _WEIGHTS.clear()
            _WEIGHTS[key] = w
    return w


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


@functools.lru_cache(maxsize=256)
def _valid_mat_np(n_in: int, n_out: int, valid_in: int, valid_out: int,
                  antialias: bool) -> np.ndarray:
    """(n_out, n_in) weights of `jax.image.scale_and_translate` on one axis
    of a padded buffer: scale valid_out / valid_in, no translation, taps
    over the whole n_in buffer (past valid_in they read its padding). The
    inverse scale is valid_in / valid_out rounded once, which is what XLA
    computes for the reference's 1 / (valid_out / valid_in); the sample
    position rounds its product and its subtraction apart (no fused
    multiply-add), as XLA's CPU compile of that graph does."""
    f32 = np.float32
    inv_scale = f32(f32(valid_in) / f32(valid_out))
    sample_f = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    return _weights_from_samples(sample_f, n_in, inv_scale, antialias)


def _valid_mats(n_in: int, n_out: int, valid_in, valid_out, antialias: bool,
                device) -> torch.Tensor:
    """(N, n_out, n_in) float32: one axis's weights for each image."""
    mats = [_valid_mat_np(n_in, n_out, int(vi), int(vo), antialias)
            for vi, vo in zip(valid_in, valid_out)]
    return torch.from_numpy(np.stack(mats)).to(device)


def resize_bilinear_valid(x: torch.Tensor, in_valid_hw: Sequence[Sequence[int]],
                          out_hw: Tuple[int, int], *,
                          out_valid_hw: Optional[Sequence[Sequence[int]]] = None,
                          antialias: bool = True) -> torch.Tensor:
    """Bilinear resize of the top-left valid region of each image of a
    padded batch, as `unet_goolenet_tpu.ops.resize_bilinear_valid` (vmapped
    over the batch). x is (N, ..., H, W) planes; in_valid_hw (N, 2) holds
    each image's valid (h, w), which the host knows, so the weights are
    built on the host per image and applied as two batched matmuls.

    Sample position of output pixel i = (i + 0.5) * h_in / h_out - 0.5, the
    grid of an unpadded (h_in, w_in) image; taps past the valid region read
    the buffer's padding, which the caller edge-replicates. out_valid_hw
    (default: out_hw for every image) sets the grid's output extent; rows
    and columns past it are extrapolation the caller overwrites. Returns
    (N, ..., oh, ow) float32."""
    n, (h, w) = x.shape[0], x.shape[-2:]
    vin = np.asarray(in_valid_hw, np.int64).reshape(n, 2)
    vout = (np.tile(np.asarray(out_hw, np.int64), (n, 1)) if out_valid_hw is None
            else np.asarray(out_valid_hw, np.int64).reshape(n, 2))
    a = _valid_mats(h, out_hw[0], vin[:, 0], vout[:, 0], antialias, x.device)
    b = _valid_mats(w, out_hw[1], vin[:, 1], vout[:, 1], antialias, x.device)
    lead = (n,) + (1,) * (x.ndim - 3)
    a, b = a.reshape(*lead, *a.shape[1:]), b.reshape(*lead, *b.shape[1:])
    return torch.matmul(torch.matmul(a, x.float()), b.transpose(-1, -2))
