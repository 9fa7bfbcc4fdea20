"""The pool + down1 kernel's plain version against the JAX package's Pallas
kernel, and (on a CUDA device) the kernel against its plain version.

The JAX side runs `fused_pool_down1` in Pallas interpret mode, as
tests/test_pallas.py does; it takes x1 in the pixel-packed layout, which is
the same memory as dense NHWC (ops/packed.py:pack is an exact reshape), so
x1 is packed on the JAX side only. Its halo relies on x1 >= 0 (the inc
output is post-relu), so those inputs are non-negative; the CUDA tests use
signed inputs, since the kernel writes zeros outside the image whatever the
sign. Tolerance 1e-4 in float32: only summation order differs. The bf16
call's fold-time weight layout is held to F.conv2d on the CPU, and its two
conv launches' plans (`down1_plans`, conv_plan's) to covering every output
once.

On a GPU host without JAX: `python -m pytest --noconftest -m cuda
tests/test_torch_down1.py`.
"""

import re

import numpy as np
import pytest
import torch

from unet_goolenet_tpu_torch.ops.kernels import down1 as K
from test_torch_train_kernels import SMS, assert_plan_covers
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


def test_cpu_wrapper_takes_the_plain_version_in_bf16():
    """bf16 weights laid out for the CPU are the plain version's, as given
    (the kernel layout is made only for weights on a card); the wrapper
    returns the plain version's result and counts no launch. On a card each
    bf16 conv weight is `gemm_taps`' (9, co, cin): rebuilt to OIHW it is the
    folded weight rounded to bf16, and F.conv2d over it gives the plain
    version's conv."""
    from unet_goolenet_tpu_torch.ops.conv import conv2d

    a = args(make_inputs(4, 1, 8, 12, 64, 128), dtype=torch.bfloat16)
    wts = K.down1_weights(*a[1:], dtype=torch.bfloat16)
    assert wts.kernel == () and all(x is y for x, y in zip(wts.plain, a[1:]))
    n0 = K.pool_down1.launches
    got = K.pool_down1(a[0], wts)
    assert got.dtype == torch.bfloat16 and K.pool_down1.launches == n0
    torch.testing.assert_close(got, K.pool_down1_ref(*a), rtol=0, atol=0)
    lay = K.down1_layout(*a[1:], dtype=torch.bfloat16)
    assert all(b.dtype == torch.float32 and torch.equal(b, r) for r, b in zip(a[2::2], lay[1::2]))
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((1, 6, 10, 128)).astype(
        np.float32))
    for shape, wl, w in zip(K.down1_shapes(64, 128, torch.bfloat16), lay[::2], a[1::2]):
        assert tuple(wl.shape) == shape and wl.dtype == torch.bfloat16 and wl.is_contiguous()
        co, ci = w.shape[:2]
        oihw = wl.float().permute(1, 2, 0).reshape(co, ci, 3, 3)
        assert torch.equal(oihw, w.to(torch.bfloat16).float())
        torch.testing.assert_close(conv2d(x[..., :ci], oihw, padding=1),
                                   conv2d(x[..., :ci], w.to(torch.bfloat16).float(), padding=1),
                                   rtol=0, atol=0)
    for shape, wl in zip(K.down1_shapes(64, 128, torch.float32),
                         K.down1_layout(*a[1:], dtype=torch.float32)[::2]):
        assert tuple(wl.shape) == shape and wl.dtype == torch.float32


@pytest.mark.parametrize("n,h,w", [(16, 112, 112), (64, 112, 112), (2, 16, 32), (2, 20, 28)])
def test_pool_down1_plans_cover_every_output_once(n, h, w):
    """The bf16 call's two conv launches at pooled size h x w (64 -> 128,
    then 128 -> 128) are conv_plan's, and each covers every output pixel of
    every image once, every output channel and every K tile once, in one
    wave: at the model's 112^2 level at the serving batches 16 and 64, and
    at the cuda tests' pooled sizes (20x28 ragged)."""
    plans = K.down1_plans(n, h, w, 64, 128, SMS)
    for p, cin in zip(plans, (64, 128)):
        assert_plan_covers(p, n, h, w, cin, 128)


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


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(32, 64), (40, 56)])
def test_bf16_kernel_repeats_bit_for_bit(cuda, h, w):
    """Two calls on the same inputs give the same bits (K splits, where a
    plan has them, are summed in rank order)."""
    a = args(make_inputs(5, 2, h, w, 64, 128), cuda, torch.bfloat16)
    wts = K.down1_weights(*a[1:], dtype=torch.bfloat16)
    assert torch.equal(K.pool_down1(a[0], wts), K.pool_down1(a[0], wts))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_call_launches_the_pool_and_the_convs(cuda, dtype):
    """A bf16 call is three device launches, pool.cuh's pool_kernel once and
    conv3x3.cuh's conv3x3_gemm with the AFFINE epilogue (EPI 0) twice; a
    float32 call two of dense_conv.cuh's conv_kernel. No weight layout."""
    from test_torch_up2 import device_launches

    a = args(make_inputs(6, 2, 40, 56, 64, 128), cuda, dtype)
    wts = K.down1_weights(*a[1:], dtype=dtype)
    per = device_launches(lambda: K.pool_down1(a[0], wts))
    want = ({"pool_kernel<": 1, r"conv3x3_gemm<\d+, false, \d+, \d+, 0>": 2}
            if dtype == torch.bfloat16 else {"conv_kernel<": 2})
    assert sum(per.values()) == sum(want.values()), per
    for pattern, count in want.items():
        assert sum(v for k, v in per.items() if re.search(pattern, k)) == count, per
