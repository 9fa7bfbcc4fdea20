"""The UNet's first encoder level, maxpool + down1's two convs, on CUDA kernels.

Replaces the JAX package's Pallas kernel
`unet_goolenet_tpu/ops/pallas/down1.py:fused_pool_down1`:

    pool = maxpool2x2(x1)                      (N, H, W, 64)
    h    = relu(conv3x3(pool) + b1)            (N, H, W, 128)
    out  = relu(conv3x3(h) + b2)

Source: `csrc/down1.cu` (bounds, shared memory and launch split there). In
bfloat16 a call is three launches: `csrc/pool.cuh`'s streaming pool writes
the pooled map, then `csrc/conv3x3.cuh`'s TMA + wgmma GEMM runs each conv
(AFFINE epilogue with relu), tiled by `conv.conv_plan` (`down1_plans`). In
float32 it is two launches of `csrc/dense_conv.cuh`'s FMA `conv_kernel`, the
first staging the pool. The kernel takes x1 (N, 2H, 2W, c) dense NHWC,
float32 or bfloat16, c and co multiples of 64, and accumulates in float32;
the pooled map and h are rounded to the input dtype, biases stay float32, as
in the TPU kernel. Positions outside the image pool to zero whatever the sign
of x1.

`down1_weights` lays the folded weights out once (`fold_unet`): a call
launches no weight layout. The wrapper calls the custom op
`ugt::pool_down1` (ops/kernels/library.py), which takes the plain version
(`pool_down1_ref`) only for a tensor on the CPU; for a CUDA tensor it
launches the kernels (`pool_down1_launch`) or raises. Its CUDA
implementation counts the calls that launch in `pool_down1.launches`.
"""

from __future__ import annotations

import torch

from unet_goolenet_tpu_torch.ops.conv import conv2d
from unet_goolenet_tpu_torch.ops.kernels._common import (
    INT, PTR, KernelWeights, bias, blocked_shape, blocked_taps, check, check_blocks,
    dense_channels, dtype_code, gemm_taps, kernel_weights, launched, lib_fn, round_to, stream)
from unet_goolenet_tpu_torch.ops.kernels.conv import _sms, conv_plan
from unet_goolenet_tpu_torch.ops.pool import max_pool2d


def pool_down1_ref(x1, w1, b1, w2, b2) -> torch.Tensor:
    """Plain version of `pool_down1`: x1 (N, 2H, 2W, c); w1 (co, c, 3, 3),
    w2 (co, co, 3, 3) folded OIHW. Returns (N, H, W, co) in x1's dtype."""
    dt = x1.dtype
    pool = max_pool2d(x1, 2).float()
    h = round_to(conv2d(pool, round_to(w1, dt), b1.float(), padding=1).relu(), dt)
    return conv2d(h, round_to(w2, dt), b2.float(), padding=1).relu().to(dt)


def down1_layout(w1, b1, w2, b2, dtype: torch.dtype):
    """The kernel's weights in `dtype`'s layouts: bf16 each conv as
    `gemm_taps` (9, cout, cin), float32 `blocked_taps`; biases float32."""
    taps = gemm_taps if dtype == torch.bfloat16 else blocked_taps
    return taps(w1), bias(b1), taps(w2), bias(b2)


def down1_shapes(c: int, co: int, dtype) -> tuple:
    """Shapes of `down1_layout`'s w1 and w2."""
    if dtype == torch.bfloat16:
        return (9, co, c), (9, co, co)
    return blocked_shape(co, c, 3), blocked_shape(co, co, 3)


def down1_weights(w1, b1, w2, b2, dtype: torch.dtype) -> KernelWeights:
    """Weights of `pool_down1` for activations of `dtype`: on the CPU in
    the layouts `pool_down1_ref` takes, on a card as `down1_layout` lays
    them out."""
    check_blocks(w1, w2)
    return kernel_weights(dtype, (w1, b1, w2, b2), lambda: down1_layout(w1, b1, w2, b2, dtype))


def down1_plans(n: int, h: int, w: int, c: int, co: int, sms: int) -> tuple:
    """The two bf16 conv launches of `pool_down1` at pooled size h x w on a
    card of `sms` SMs: conv_plan's for c -> co, then co -> co."""
    return conv_plan(False, n, h, w, c, co, sms), conv_plan(False, n, h, w, co, co, sms)


def pool_down1_launch(x1: torch.Tensor, weights) -> torch.Tensor:
    """One call of the kernels (csrc/down1.cu) on a CUDA tensor x1 with
    weights laid out as `down1_layout` lays them out. Checks every argument
    first; raises on any failure. `library.pool_down1`'s CUDA
    implementation."""
    code = dtype_code("pool_down1", x1)
    n, h2, w2, c = x1.shape
    if h2 % 2 or w2 % 2:
        raise ValueError(f"pool_down1: x1's height and width must be even, got {h2}x{w2}")
    h, wd = h2 // 2, w2 // 2
    dev, dt = x1.device, x1.dtype
    wk1, bk1, wk2, bk2 = weights
    co = bk1.shape[0]
    dense_channels("pool_down1", c, co)
    check("x1", x1, (n, h2, w2, c), dt)
    for arg, t, shape in zip(("w1", "w2"), (wk1, wk2), down1_shapes(c, co, dt)):
        check(arg, t, shape, dt)
    check("b1", bk1, (co,), torch.float32)
    check("b2", bk2, (co,), torch.float32)
    pool = plan = None
    if dt == torch.bfloat16:
        pool = torch.empty((n, h, wd, c), device=dev, dtype=dt)
        plans = down1_plans(n, h, wd, c, co, _sms(dev.index))
        plan = (INT * 10)(*plans[0].ints(), *plans[1].ints())
    mid = torch.empty((n, h, wd, co), device=dev, dtype=dt)
    out = torch.empty_like(mid)
    rc = lib_fn("pool_down1_launch", [INT] + [PTR] * 8 + [INT] * 5 + [PTR] * 2)(
        code, x1.data_ptr(), wk1.data_ptr(), bk1.data_ptr(), wk2.data_ptr(), bk2.data_ptr(),
        None if pool is None else pool.data_ptr(), mid.data_ptr(), out.data_ptr(),
        n, h, wd, c, co, plan, stream(x1))
    launched("pool_down1", rc)
    return out


def pool_down1(x1: torch.Tensor, wts: KernelWeights) -> torch.Tensor:
    """maxpool2x2 + down1: (N, H, W, co) as `pool_down1_ref` describes, with
    weights from `down1_weights`. x1's height and width must be even. Calls
    the op `ugt::pool_down1` (ops/kernels/library.py)."""
    return torch.ops.ugt.pool_down1(x1, wts.args(x1))


pool_down1.launches = 0
