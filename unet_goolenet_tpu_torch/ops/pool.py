"""Max pooling with the JAX package's ceil-mode rule, and adaptive average
pooling.

Counterpart of `unet_goolenet_tpu/ops/pool.py:22-28,79-112,157-186`. Ceil
mode there adds trailing -inf padding so that ceil((size - k) / s) + 1
windows fit; torch's `ceil_mode=True` instead drops a last window that
would start in the right padding, so the two differ for some sizes. The
pad is applied explicitly with -inf and torch pools the padded tensor
without padding of its own. Where torch's own ceil mode yields the same
windows (its last window starts inside the input or the left padding),
torch pools directly and no padded copy is made.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F


def _ceil_pad(size: int, k: int, s: int) -> int:
    out = math.ceil((size - k) / s) + 1
    return max(0, (out - 1) * s + k - size)


def _pads(h: int, w: int, k: int, s: int, padding: int,
          ceil_mode: bool) -> Tuple[int, int, int, int]:
    """(left, right, top, bottom) as F.pad takes them."""
    top = bottom = left = right = padding
    if ceil_mode:
        bottom += _ceil_pad(h + 2 * padding, k, s)
        right += _ceil_pad(w + 2 * padding, k, s)
    return left, right, top, bottom


def max_pool2d_nchw(x: torch.Tensor, window: int = 2, stride: int = None, *,
                    padding: int = 0, ceil_mode: bool = False) -> torch.Tensor:
    """Max pool of an (N, C, H, W) tensor, -inf padded."""
    stride = window if stride is None else stride
    h, w = x.shape[2], x.shape[3]
    if ceil_mode and padding <= window // 2 and all(
            (math.ceil((size + 2 * padding - window) / stride)) * stride < size + padding
            for size in (h, w)):
        return F.max_pool2d(x, window, stride, padding=padding, ceil_mode=True)
    pads = _pads(h, w, window, stride, padding, ceil_mode)
    if any(pads):
        x = F.pad(x, pads, value=float("-inf"))
    return F.max_pool2d(x, window, stride)


def max_pool2d(x: torch.Tensor, window: int = 2, stride: int = None, *,
               padding: int = 0, ceil_mode: bool = False) -> torch.Tensor:
    """Max pool of an (N, H, W, C) tensor, as `unet_goolenet_tpu.ops.max_pool2d`."""
    y = max_pool2d_nchw(x.permute(0, 3, 1, 2), window, stride,
                        padding=padding, ceil_mode=ceil_mode)
    return y.permute(0, 2, 3, 1)


def adaptive_avg_pool(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Adaptive average pool of an (N, H, W, C) tensor to (N, oh, ow, C),
    as `unet_goolenet_tpu.ops.adaptive_avg_pool` (the GoogLeNet aux heads'
    4x4): output i averages the input window [floor(i*S/O), ceil((i+1)*S/O)),
    torch's rule, so windows overlap where O does not divide S and repeat
    where O > S."""
    def pool_axis(t: torch.Tensor, size: int, out: int, axis: int) -> torch.Tensor:
        if size == out:
            return t
        starts = [(i * size) // out for i in range(out)]
        ends = [-(-((i + 1) * size) // out) for i in range(out)]
        return torch.stack([t.narrow(axis, s, e - s).mean(dim=axis)
                            for s, e in zip(starts, ends)], dim=axis)

    y = pool_axis(x, x.shape[1], out_hw[0], 1)
    return pool_axis(y, y.shape[2], out_hw[1], 2)
