"""The pool + down1 kernel's plain version against the JAX package's Pallas
kernel, and (on a CUDA device) the kernel against its plain version.

The JAX side runs `fused_pool_down1` in Pallas interpret mode, as
tests/test_pallas.py does; it takes x1 in the pixel-packed layout, which is
the same memory as dense NHWC (ops/packed.py:pack is an exact reshape), so
x1 is packed on the JAX side only. Its halo relies on x1 >= 0 (the inc
output is post-relu), so those inputs are non-negative; the CUDA tests use
signed inputs, since the kernel writes zeros outside the image whatever the
sign. Tolerance 1e-4 in float32: only summation order differs.

On a GPU host without JAX: `python -m pytest --noconftest -m cuda
tests/test_torch_down1.py`.
"""

import numpy as np
import pytest
import torch

from unet_goolenet_tpu_torch.ops.kernels import down1 as K
from torch_threads import torch_threads  # noqa: F401  (autouse)

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def jax_down1():
    """The JAX pool + down1 kernel in interpret mode, plus the pack reshape."""
    pytest.importorskip("jax")
    from unet_goolenet_tpu.ops import pallas as pk
    from unet_goolenet_tpu.ops import packed as P
    from unet_goolenet_tpu.ops.pallas.down1 import fused_pool_down1

    pk.interpret_mode(True)
    return fused_pool_down1, P


def make_inputs(seed, n, h, w, c, co):
    """Seeded x1 (n, h, w, c) and HWIO weights as numpy arrays."""
    rng = np.random.default_rng(seed)
    r = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    return {"x1": r(n, h, w, c), "w1": r(3, 3, c, co, sc=1 / np.sqrt(9 * c)),
            "b1": r(co, sc=0.1), "w2": r(3, 3, co, co, sc=1 / np.sqrt(9 * co)),
            "b2": r(co, sc=0.1)}


def args(d, device="cpu", dtype=torch.float32):
    """Port-layout arguments of pool_down1_ref."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    oihw = lambda w: t(np.transpose(w, (3, 2, 0, 1)))
    return t(d["x1"]).to(dtype), oihw(d["w1"]), t(d["b1"]), oihw(d["w2"]), t(d["b2"])


# (n, h, w, c, co): tests/test_pallas.py's TestFusedDown1 shape (32x32
# logical, 8 -> 16 channels), and the model's 64 -> 128 on a small image
CASES = [(2, 32, 32, 8, 16), (1, 16, 16, 64, 128)]


@pytest.mark.parametrize("n,h,w,c,co", CASES)
def test_ref_matches_jax_fused_pool_down1(jax_down1, n, h, w, c, co):
    import jax.numpy as jnp

    fused_pool_down1, P = jax_down1
    d = make_inputs(1, n, h, w, c, co)
    d["x1"] = np.abs(d["x1"])
    ref = np.asarray(fused_pool_down1(P.pack(jnp.asarray(d["x1"])),
                                      *(jnp.asarray(d[k]) for k in ("w1", "b1", "w2", "b2"))))
    got = K.pool_down1_ref(*args(d)).numpy()
    assert got.shape == ref.shape == (n, h // 2, w // 2, co)
    np.testing.assert_allclose(got, ref, **TOL)


def test_cpu_wrapper_takes_the_plain_version():
    """On CPU tensors the wrapper returns the plain version's result and does
    not count a kernel launch."""
    a = args(make_inputs(2, 1, 12, 20, 64, 128))
    before = K.pool_down1.launches
    got = K.pool_down1(a[0], K.down1_weights(*a[1:], dtype=torch.float32))
    torch.testing.assert_close(got, K.pool_down1_ref(*a), rtol=0, atol=0)
    assert K.pool_down1.launches == before


# ------------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the pool + down1 kernel runs only on the GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


CUDA_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w", [(32, 64), (40, 56)])
def test_kernel_matches_plain(cuda, dtype, h, w):
    a = args(make_inputs(3, 2, h, w, 64, 128), cuda, dtype)
    n0 = K.pool_down1.launches
    got = K.pool_down1(a[0], K.down1_weights(*a[1:], dtype=dtype))
    torch.cuda.synchronize()
    assert K.pool_down1.launches == n0 + 1
    ref = K.pool_down1_ref(*a)
    err = ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()
    assert err <= CUDA_TOL[dtype]
