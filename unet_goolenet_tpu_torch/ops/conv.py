"""Convolution helpers on NHWC tensors with torch-layout weights.

Counterpart of `unet_goolenet_tpu/ops/conv.py:28-102`. Activations are NHWC at
the interface; `x.permute(0, 3, 1, 2)` of a contiguous NHWC tensor is an NCHW
view in channels_last memory, which is the layout cuDNN runs fastest, and its
output permutes back to contiguous NHWC for free. Weights keep torch's
layouts: conv OIHW, transposed conv (Cin, Cout, kh, kw).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           *, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """(N, H, W, Cin) x (Cout, Cin, kh, kw) -> (N, H', W', Cout)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w, b, stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def conv_transpose2x2(x: torch.Tensor, w: torch.Tensor,
                      b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ConvTranspose 2x2 / stride 2 as a per-pixel matmul + depth-to-space.

    x: (N, H, W, Cin); w: (Cin, Cout, 2, 2) (torch ConvTranspose2d layout);
    out[n, 2i+di, 2j+dj, o] = sum_c x[n, i, j, c] * w[c, o, di, dj] + b[o].
    With kernel == stride the outputs do not overlap, so there is no kernel
    flip and no scatter.
    """
    n, h, wi, cin = x.shape
    cout = w.shape[1]
    wmat = w.permute(0, 2, 3, 1).reshape(cin, 4 * cout)     # columns (di, dj, o)
    y = torch.matmul(x.reshape(-1, cin), wmat)
    y = y.reshape(n, h, wi, 2, 2, cout).permute(0, 1, 3, 2, 4, 5)
    y = y.reshape(n, 2 * h, 2 * wi, cout)
    if b is not None:
        y = y + b
    return y


def fold_batchnorm(w: torch.Tensor, b: Optional[torch.Tensor],
                   gamma: torch.Tensor, beta: torch.Tensor, mean: torch.Tensor,
                   var: torch.Tensor, eps: float = 1e-5
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold inference BatchNorm into an OIHW conv: returns (w', b') with
    conv(x, w') + b' == BN(conv(x, w) + b)."""
    inv = gamma * torch.rsqrt(var + eps)
    w_f = w * inv.reshape(-1, *([1] * (w.ndim - 1)))
    b0 = b if b is not None else torch.zeros_like(mean)
    return w_f, (b0 - mean) * inv + beta
