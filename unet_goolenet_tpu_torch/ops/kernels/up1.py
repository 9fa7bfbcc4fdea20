"""The UNet's last decoder level (up1) plus its 1x1 head, on two CUDA kernels.

Replaces the two Pallas TPU kernels of the JAX package's serving path:

  * `up1_gate` <- `unet_goolenet_tpu/ops/pallas/up1.py:fused_cbn_stats`
    (the gate pass): e1 = relu(conv3x3(x1, w) + b), plus the per-image,
    per-channel mean and max of e1 over (H, W) that feed CoordAtt3's 1x1
    squeeze-excite gate.
  * `up1_tail` <- `unet_goolenet_tpu/ops/pallas/up1.py:fused_up1_outc`:
        up     = convT2x2(y) + b_up
        d2     = relu(conv3x3(up) + b_d2)
        gated  = e1 + (1 + gate) * d2
        h      = relu(conv3x3(concat[up, gated]) + b_pair)
        y1     = relu(conv3x3(h) + b_blk1)
        logits = y1 @ w_outc + b_outc
    with only the logits written to device memory.

Sources: `csrc/up1_gate.cu`, `csrc/up1_tail.cu` (notes on bounds and design
there). Each kernel takes dense NHWC tensors, float32 or bfloat16, with
C = 64 channels, and accumulates in float32. Between stages activations are
rounded to the input dtype, and biases stay float32, as in the TPU kernels.

`gate_weights` / `tail_weights` lay the folded weights out for the kernels
once (the engine does it in `fold_unet`), so the wrappers only check and
launch. Each wrapper takes its plain PyTorch version (`*_ref`) only for a
tensor on the CPU. For a CUDA tensor it launches the kernel or raises. Each
counts its kernel launches in `.launches`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from unet_goolenet_tpu_torch.ops.conv import conv2d, conv_transpose2x2
from unet_goolenet_tpu_torch.ops.kernels import _build

KERNEL_CHANNELS = 64
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_argtypes_set = False


def _lib() -> ctypes.CDLL:
    global _argtypes_set
    lib = _build.load()
    if not _argtypes_set:
        lib.up1_gate_tiles.argtypes = [_I, _I]
        lib.up1_gate_tiles.restype = _I
        lib.up1_gate_launch.argtypes = [_I] + [_P] * 8 + [_I] * 3 + [_P]
        lib.up1_gate_launch.restype = _I
        lib.up1_tail_launch.argtypes = [_I] + [_P] * 14 + [_I] * 4 + [_P]
        lib.up1_tail_launch.restype = _I
        _argtypes_set = True
    return lib


def _round(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Round to `dtype` and compute on in float32."""
    return t.to(dtype).float()


# ------------------------------------------------------------ plain versions


def up1_gate_ref(x1: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Plain version of `up1_gate`: x1 (N, H, W, C); w (C, C, 3, 3) folded
    OIHW; b (C,). Returns (e1 (N, H, W, C) in x1's dtype, mean (N, C) f32,
    max (N, C) f32); the statistics are taken on e1 before rounding."""
    dt = x1.dtype
    e1 = conv2d(x1.float(), _round(w, dt), b.float(), padding=1).relu()
    return e1.to(dt), e1.mean(dim=(1, 2)), e1.amax(dim=(1, 2))


def up1_tail_ref(y, e1, gate1p, w_up, b_up, w_d2, b_d2, w_pair, b_pair,
                 w_blk1, b_blk1, w_outc, b_outc):
    """Plain version of `up1_tail`. y (N, H/2, W/2, C); e1 (N, H, W, C);
    gate1p (N, C) = 1 + gate; w_up (C, C, 2, 2) ConvTranspose2d layout;
    w_d2, w_blk1 (C, C, 3, 3), w_pair (C, 2C, 3, 3) folded OIHW; w_outc
    (ncls, C, 1, 1). Returns logits (N, H, W, ncls) in y's dtype."""
    dt = y.dtype
    up = _round(conv_transpose2x2(y.float(), _round(w_up, dt), b_up.float()), dt)
    d2 = _round(conv2d(up, _round(w_d2, dt), b_d2.float(), padding=1).relu(), dt)
    gate = _round(gate1p, dt)[:, None, None, :]
    gated = _round(e1.float() + _round(gate * d2, dt), dt)
    h = conv2d(torch.cat([up, gated], dim=-1), _round(w_pair, dt),
               b_pair.float(), padding=1).relu()
    h = _round(h, dt)
    y1 = _round(conv2d(h, _round(w_blk1, dt), b_blk1.float(), padding=1).relu(), dt)
    return conv2d(y1, _round(w_outc, dt), b_outc.float()).to(dt)


# ------------------------------------------------------------ kernel wrappers


def _check(name: str, t: torch.Tensor, shape, dtype) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: must be contiguous and 16-byte aligned")


def _kernel_dtype(t: torch.Tensor) -> int:
    if t.dtype not in _DTYPE_CODE:
        raise ValueError(f"up1 kernels take float32 or bfloat16, got {t.dtype}")
    if t.shape[-1] != KERNEL_CHANNELS:
        raise ValueError(f"up1 kernels take C={KERNEL_CHANNELS}, got {t.shape[-1]}")
    return _DTYPE_CODE[t.dtype]


def _taps(w: torch.Tensor, dtype) -> torch.Tensor:
    """OIHW (Co, Ci, k, k) -> per-tap blocks in the kernel's dtype and layout:
    (k*k, Co, Ci) for bf16 (tensor-core B operand), (k*k, Ci, Co) for
    float32 (FMA)."""
    co, ci, kh, kw = w.shape
    if dtype == torch.bfloat16:
        return w.to(dtype).permute(2, 3, 0, 1).reshape(kh * kw, co, ci).contiguous()
    return w.to(dtype).permute(2, 3, 1, 0).reshape(kh * kw, ci, co).contiguous()


def _bias(b: torch.Tensor) -> torch.Tensor:
    return b.detach().float().contiguous()


class KernelWeights(NamedTuple):
    """One kernel's weights, prepared once: `plain` as the plain version
    takes them, `kernel` laid out for the CUDA kernel in `dtype`."""
    dtype: torch.dtype
    plain: Tuple[torch.Tensor, ...]
    kernel: Tuple[torch.Tensor, ...]


def gate_weights(w: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> KernelWeights:
    """Weights of `up1_gate` for activations of `dtype`: w (C, C, 3, 3)
    folded OIHW, b (C,)."""
    return KernelWeights(dtype, (w, b), (_taps(w, dtype), _bias(b)))


def tail_weights(w_up, b_up, w_d2, b_d2, w_pair, b_pair, w_blk1, b_blk1, w_outc, b_outc,
                 dtype: torch.dtype) -> KernelWeights:
    """Weights of `up1_tail` for activations of `dtype`, in the layouts
    `up1_tail_ref` takes."""
    ncls, c = w_outc.shape[:2]
    # (Ci, Co, 2, 2) transposed-conv weights are OIHW-shaped with I and O
    # swapped, so _taps of the swapped view gives per-parity blocks
    kernel = (_taps(w_up.transpose(0, 1), dtype), _bias(b_up),
              _taps(w_d2, dtype), _bias(b_d2), _taps(w_pair, dtype), _bias(b_pair),
              _taps(w_blk1, dtype), _bias(b_blk1),
              w_outc.to(dtype).reshape(ncls, c).t().contiguous(), _bias(b_outc))
    return KernelWeights(dtype, (w_up, b_up, w_d2, b_d2, w_pair, b_pair, w_blk1, b_blk1,
                                 w_outc, b_outc), kernel)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def up1_gate(x1: torch.Tensor, wts: KernelWeights):
    """Gate pass of up1: (e1, mean, max) as `up1_gate_ref` describes, with
    weights from `gate_weights`."""
    if x1.device.type == "cpu":
        return up1_gate_ref(x1, *wts.plain)
    code = _kernel_dtype(x1)
    n, h, wd, c = x1.shape
    dev, dt = x1.device, x1.dtype
    _check("x1", x1, (n, h, wd, c), dt)
    wk, bk = wts.kernel
    _check("w", wk, (9, c, c), dt)
    _check("b", bk, (c,), torch.float32)
    lib = _lib()
    tiles = lib.up1_gate_tiles(h, wd)
    e1 = torch.empty_like(x1)
    part = torch.empty((2, n, tiles, c), device=dev, dtype=torch.float32)
    stats = torch.empty((2, n, c), device=dev, dtype=torch.float32)
    rc = lib.up1_gate_launch(code, x1.data_ptr(), wk.data_ptr(), bk.data_ptr(),
                             e1.data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
                             stats[0].data_ptr(), stats[1].data_ptr(),
                             n, h, wd, _stream(x1))
    if rc != 0:
        raise RuntimeError(f"up1_gate: kernel launch failed with CUDA error {rc}")
    up1_gate.launches += 1
    return e1, stats[0], stats[1]


def up1_tail(y: torch.Tensor, e1: torch.Tensor, gate1p: torch.Tensor,
             wts: KernelWeights) -> torch.Tensor:
    """up1 level + 1x1 head: logits as `up1_tail_ref` describes, with
    weights from `tail_weights`."""
    if y.device.type == "cpu":
        return up1_tail_ref(y, e1, gate1p, *wts.plain)
    code = _kernel_dtype(y)
    n, h2, w2, c = y.shape
    h, wd = 2 * h2, 2 * w2
    dev, dt = y.device, y.dtype
    _check("y", y, (n, h2, w2, c), dt)
    _check("e1", e1, (n, h, wd, c), dt)
    g = gate1p.to(dt).contiguous()
    _check("gate1p", g, (n, c), dt)
    wup, b_up, wd2, b_d2, wpair, b_pair, wblk1, b_blk1, wout, b_outc = wts.kernel
    ncls = wout.shape[1]
    for name, t, k in (("w_up", wup, 4), ("w_d2", wd2, 9), ("w_blk1", wblk1, 9)):
        _check(name, t, (k, c, c), dt)
    _check("w_pair", wpair, (9, c, 2 * c) if dt == torch.bfloat16 else (9, 2 * c, c), dt)
    _check("w_outc", wout, (c, ncls), dt)
    for name, t, k in (("b_up", b_up, c), ("b_d2", b_d2, c), ("b_pair", b_pair, c),
                       ("b_blk1", b_blk1, c), ("b_outc", b_outc, ncls)):
        _check(name, t, (k,), torch.float32)
    out = torch.empty((n, h, wd, ncls), device=dev, dtype=dt)
    rc = _lib().up1_tail_launch(
        code, y.data_ptr(), e1.data_ptr(), g.data_ptr(),
        wup.data_ptr(), b_up.data_ptr(), wd2.data_ptr(), b_d2.data_ptr(),
        wpair.data_ptr(), b_pair.data_ptr(), wblk1.data_ptr(), b_blk1.data_ptr(),
        wout.data_ptr(), b_outc.data_ptr(), out.data_ptr(),
        n, h, wd, ncls, _stream(y))
    if rc != 0:
        raise RuntimeError(f"up1_tail: kernel launch failed with CUDA error {rc}")
    up1_tail.launches += 1
    return out


up1_gate.launches = 0
up1_tail.launches = 0
