"""The UNet's first encoder level, maxpool + down1's two convs, on a CUDA kernel.

Replaces the JAX package's Pallas kernel
`unet_goolenet_tpu/ops/pallas/down1.py:fused_pool_down1`:

    pool = maxpool2x2(x1)                      (N, H, W, 64)
    h    = relu(conv3x3(pool) + b1)            (N, H, W, 128)
    out  = relu(conv3x3(h) + b2)

Source: `csrc/down1.cu` on `csrc/dense_conv.cuh` (bounds, shared memory and
launch split there). The kernel takes x1 (N, 2H, 2W, c) dense NHWC, float32
or bfloat16, c and co multiples of 64, and accumulates in float32; the
pooled map and h are rounded to the input dtype, biases stay float32, as in
the TPU kernel. Positions outside the image pool to zero whatever the sign of
x1.

`down1_weights` lays the folded weights out once (`fold_unet`). The wrapper
takes its plain version (`pool_down1_ref`) only for a tensor on the CPU. For
a CUDA tensor it launches the kernel or raises. It counts its calls that
launch in `.launches`.
"""

from __future__ import annotations

import torch

from unet_goolenet_tpu_torch.ops.conv import conv2d
from unet_goolenet_tpu_torch.ops.kernels._common import (
    INT, PTR, KernelWeights, bias, blocked_shape, blocked_taps, check, check_blocks,
    dense_channels, dtype_code, kernel_weights, launched, lib_fn, round_to, stream)
from unet_goolenet_tpu_torch.ops.pool import max_pool2d


def pool_down1_ref(x1, w1, b1, w2, b2) -> torch.Tensor:
    """Plain version of `pool_down1`: x1 (N, 2H, 2W, c); w1 (co, c, 3, 3),
    w2 (co, co, 3, 3) folded OIHW. Returns (N, H, W, co) in x1's dtype."""
    dt = x1.dtype
    pool = max_pool2d(x1, 2).float()
    h = round_to(conv2d(pool, round_to(w1, dt), b1.float(), padding=1).relu(), dt)
    return conv2d(h, round_to(w2, dt), b2.float(), padding=1).relu().to(dt)


def down1_weights(w1, b1, w2, b2, dtype: torch.dtype) -> KernelWeights:
    """Weights of `pool_down1` for activations of `dtype`, in the layouts
    `pool_down1_ref` takes."""
    check_blocks(w1, w2)
    return kernel_weights(dtype, (w1, b1, w2, b2),
                          lambda: (blocked_taps(w1, dtype), bias(b1), blocked_taps(w2, dtype),
                                   bias(b2)))


def pool_down1(x1: torch.Tensor, wts: KernelWeights) -> torch.Tensor:
    """maxpool2x2 + down1: (N, H, W, co) as `pool_down1_ref` describes, with
    weights from `down1_weights`. x1's height and width must be even."""
    if x1.device.type == "cpu":
        return pool_down1_ref(x1, *wts.plain)
    code = dtype_code("pool_down1", x1)
    n, h2, w2, c = x1.shape
    if h2 % 2 or w2 % 2:
        raise ValueError(f"pool_down1: x1's height and width must be even, got {h2}x{w2}")
    h, wd = h2 // 2, w2 // 2
    dev, dt = x1.device, x1.dtype
    wk1, bk1, wk2, bk2 = wts.kernel
    co = bk1.shape[0]
    dense_channels("pool_down1", c, co)
    check("x1", x1, (n, h2, w2, c), dt)
    check("w1", wk1, blocked_shape(co, c, 3, dt), dt)
    check("w2", wk2, blocked_shape(co, co, 3, dt), dt)
    check("b1", bk1, (co,), torch.float32)
    check("b2", bk2, (co,), torch.float32)
    mid = torch.empty((n, h, wd, co), device=dev, dtype=dt)
    out = torch.empty_like(mid)
    rc = lib_fn("pool_down1_launch", [INT] + [PTR] * 7 + [INT] * 5 + [PTR])(
        code, x1.data_ptr(), wk1.data_ptr(), bk1.data_ptr(), wk2.data_ptr(), bk2.data_ptr(),
        mid.data_ptr(), out.data_ptr(), n, h, wd, c, co, stream(x1))
    launched("pool_down1", rc)
    pool_down1.launches += 1
    return out


pool_down1.launches = 0
