"""What the kernel wrappers share: argument checks, weight layouts, the
kernel library's C functions and the launch-error check."""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Sequence, Tuple

import torch

from unet_goolenet_tpu_torch.ops.kernels import _build

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
BLOCK = 64              # channels per block of the dense kernels' weights
PTR = ctypes.c_void_p
INT = ctypes.c_int
_declared = set()


def lib_fn(name: str, argtypes: Sequence, restype=INT):
    """A C function of the kernel library (built on first call) with its
    argument types declared: pointers and the stream as c_void_p, or ctypes
    would pass them as 32-bit ints."""
    fn = getattr(_build.load(), name)
    if name not in _declared:
        fn.argtypes, fn.restype = list(argtypes), restype
        _declared.add(name)
    return fn


def launched(name: str, rc: int) -> None:
    """Raise unless a launch function returned cudaSuccess."""
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def wide(t: torch.Tensor) -> torch.Tensor:
    """t in float32, or in its own dtype if that is wider (float64, which
    the CPU tests use to hold the plain versions against the JAX package
    beyond float32's rounding)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def round_to(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Round to `dtype` and compute on in float32 (or float64 for float64)."""
    return wide(t.to(dtype))


def check(name: str, t: torch.Tensor, shape, dtype) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: must be contiguous and 16-byte aligned")


def dtype_code(name: str, t: torch.Tensor) -> int:
    if t.dtype not in DTYPE_CODE:
        raise ValueError(f"{name} takes float32 or bfloat16, got {t.dtype}")
    return DTYPE_CODE[t.dtype]


def check_blocks(*ws: torch.Tensor) -> None:
    """The dense kernels take output channels in blocks of 64."""
    for w in ws:
        if w.shape[0] % BLOCK:
            raise ValueError(f"the dense kernels take output channels in blocks of {BLOCK}, "
                             f"got {w.shape[0]}")


def blocked_taps(w: torch.Tensor) -> torch.Tensor:
    """OIHW (Co, Ci, k, k), Co a multiple of 64 -> float32 per-tap blocks of
    64 output channels, (Co/64, k*k, Ci, 64): the FMA layout of
    csrc/dense_conv.cuh (float32 only; bf16 runs on `gemm_taps`)."""
    check_blocks(w)
    co, ci, kh, kw = w.shape
    v = w.detach().float().reshape(co // BLOCK, BLOCK, ci, kh * kw)
    return v.permute(0, 3, 2, 1).contiguous()


def gemm_taps(w: torch.Tensor) -> torch.Tensor:
    """OIHW (Co, Ci, 3, 3) -> (9, Co, Ci) bf16, wk[tap][co][ci] = w[co][ci]
    [tap] (tap = 3 ky + kx): the B operand of csrc/conv3x3.cuh's bf16 GEMM,
    which `conv.conv3x3_weight` lays out each training call; for fixed
    weights, once."""
    co, ci = w.shape[:2]
    return w.detach().to(torch.bfloat16).permute(2, 3, 0, 1).reshape(9, co, ci).contiguous()


def blocked_shape(co: int, ci: int, k: int) -> tuple:
    """Shape of `blocked_taps` of a (co, ci, k, k) weight."""
    return (co // BLOCK, k * k, ci, BLOCK)


def dense_channels(name: str, *channels: int) -> None:
    if any(c % BLOCK or c <= 0 for c in channels):
        raise ValueError(f"{name} takes channel counts in multiples of {BLOCK}, got {channels}")


def bias(b: torch.Tensor) -> torch.Tensor:
    return b.detach().float().contiguous()


class KernelWeights(NamedTuple):
    """One kernel's weights, prepared once for the device they lie on: on
    the CPU `plain`, as the plain version (which the wrapper runs there)
    takes them; on a card `kernel`, laid out for the CUDA kernel in `dtype`.
    The other is empty, so a card holds no plain copy."""
    dtype: torch.dtype
    plain: Tuple[torch.Tensor, ...]
    kernel: Tuple[torch.Tensor, ...]

    def args(self, t: torch.Tensor) -> list:
        """The flat weight list a custom op (ops/kernels/library.py) takes
        beside an activation t: `plain` on the CPU, `kernel` on a card."""
        return list(self.plain if t.device.type == "cpu" else self.kernel)


def kernel_weights(dtype: torch.dtype, plain: Sequence[torch.Tensor],
                   layout: Callable[[], Sequence[torch.Tensor]]) -> KernelWeights:
    """KernelWeights of the plain version's weights `plain`; `layout()`
    gives the kernel's, and runs only for weights on a card."""
    if plain[0].device.type == "cpu":
        return KernelWeights(dtype, tuple(plain), ())
    return KernelWeights(dtype, (), tuple(layout()))
