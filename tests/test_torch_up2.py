"""The dense decoder-level kernels' plain versions against the JAX package's
Pallas kernels, and (on a CUDA device) the kernels against their plain
versions.

The JAX side runs `fused_cbn_stats_dense` / `fused_up_dense` in Pallas
interpret mode, as tests/test_pallas.py does. Inputs come from numpy seeds,
in JAX layouts, and are carried to the port's layouts here. Tolerance 1e-4
in float32: only summation order differs.

The CUDA tests need a card and nvcc; without them they skip. On a GPU host
without JAX they run with `python -m pytest --noconftest -m cuda
tests/test_torch_up2.py` (JAX is imported only inside the fixture of the JAX
comparisons).
"""

import numpy as np
import pytest
import torch

from unet_goolenet_tpu_torch.ops.kernels import up2 as K
from torch_threads import torch_threads  # noqa: F401  (autouse)

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def jax_up2():
    """The JAX dense decoder kernels in interpret mode."""
    pytest.importorskip("jax")
    from unet_goolenet_tpu.ops import pallas as pk
    from unet_goolenet_tpu.ops.pallas import up2 as PU2

    pk.interpret_mode(True)
    return PU2


def make_inputs(seed, n, h, w, c, cq):
    """Seeded inputs of one decoder level at output size (h, w), in JAX
    layouts (HWIO, deconv (2, 2, Ci, Co)), as numpy arrays."""
    rng = np.random.default_rng(seed)
    r = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    k = 1.0 / np.sqrt(9 * c)
    return {
        "skip": r(n, h, w, c), "w_e1": r(3, 3, c, c, sc=k), "b_e1": r(c, sc=0.1),
        "x": r(n, h // 2, w // 2, c), "e1": np.abs(r(n, h, w, c)),
        "gate": np.abs(r(n, c)) * 0.5,
        "w_up": r(2, 2, c, c, sc=1 / np.sqrt(c)), "b_up": r(c, sc=0.1),
        "w_d2": r(3, 3, c, c, sc=k), "b_d2": r(c, sc=0.1),
        "w_pair": r(3, 3, 2 * c, cq, sc=k / np.sqrt(2)), "b_pair": r(cq, sc=0.1),
        "w_blk1": r(3, 3, cq, cq, sc=1 / np.sqrt(9 * cq)), "b_blk1": r(cq, sc=0.1),
    }


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def oihw(w):
    return t(np.transpose(w, (3, 2, 0, 1)))


def gate_args(d, device="cpu", dtype=torch.float32):
    """Port-layout arguments of up_gate_dense_ref."""
    return t(d["skip"]).to(device, dtype), oihw(d["w_e1"]).to(device), t(d["b_e1"]).to(device)


def level_args(d, device="cpu", dtype=torch.float32):
    """Port-layout arguments of up_level_ref."""
    args = (t(d["x"]).to(dtype), t(d["e1"]).to(dtype), 1.0 + t(d["gate"]),
            t(np.transpose(d["w_up"], (2, 3, 0, 1))), t(d["b_up"]), oihw(d["w_d2"]),
            t(d["b_d2"]), oihw(d["w_pair"]), t(d["b_pair"]), oihw(d["w_blk1"]),
            t(d["b_blk1"]))
    return tuple(a.to(device) for a in args)


def level_call(args):
    """level_args split into up_level's (x, e1, gate1p, weights)."""
    return (*args[:3], K.up_level_weights(*args[3:], dtype=args[0].dtype))


# (n, h, w, c): the shape of tests/test_pallas.py's TestCbnStatsDense, and the
# model's up2 width on a small image whose width the TPU kernel pads
GATE_CASES = [(2, 24, 16, 8), (1, 8, 12, 128)]
# (h, w, c, cq): test_pallas.py's TestFusedUpDense geometries (w = 12 and 28
# are padded on the TPU side), and up2's (128, 64) on a small image
LEVEL_CASES = [(16, 8, 16, 8), (16, 12, 16, 8), (16, 28, 16, 8), (8, 8, 128, 64)]


@pytest.mark.parametrize("n,h,w,c", GATE_CASES)
def test_gate_ref_matches_jax_fused_cbn_stats_dense(jax_up2, n, h, w, c):
    import jax.numpy as jnp

    d = make_inputs(1, n, h, w, c, c)
    e1, mean, mx = jax_up2.fused_cbn_stats_dense(
        jnp.asarray(d["skip"]), jnp.asarray(d["w_e1"]), jnp.asarray(d["b_e1"]))
    got = K.up_gate_dense_ref(*gate_args(d))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(e1), **TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(mean)[:, 0, 0], **TOL)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(mx)[:, 0, 0], **TOL)


@pytest.mark.parametrize("h,w,c,cq", LEVEL_CASES)
def test_level_ref_matches_jax_fused_up_dense(jax_up2, h, w, c, cq):
    import jax.numpy as jnp

    d = make_inputs(2, 2, h, w, c, cq)
    ref = np.asarray(jax_up2.fused_up_dense(
        jnp.asarray(d["x"]), jnp.asarray(d["e1"]), jnp.asarray(1.0 + d["gate"]),
        *(jnp.asarray(d[k]) for k in ("w_up", "b_up", "w_d2", "b_d2", "w_pair", "b_pair",
                                      "w_blk1", "b_blk1"))))
    got = K.up_level_ref(*level_args(d)).numpy()
    assert got.shape == ref.shape == (2, h, w, cq)
    np.testing.assert_allclose(got, ref, **TOL)


def test_cpu_wrappers_take_the_plain_version():
    """On CPU tensors the wrappers return the plain versions' results and do
    not count a kernel launch."""
    d = make_inputs(3, 1, 12, 20, 64, 64)
    before = (K.up_gate_dense.launches, K.up_level.launches)
    x, w, b = gate_args(d)
    got = K.up_gate_dense(x, K.up_gate_weights(w, b, torch.float32))
    for g, r in zip(got, K.up_gate_dense_ref(x, w, b)):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    args = level_args(d)
    torch.testing.assert_close(K.up_level(*level_call(args)), K.up_level_ref(*args),
                               rtol=0, atol=0)
    assert (K.up_gate_dense.launches, K.up_level.launches) == before


def test_wrappers_refuse_channels_off_the_block():
    """The kernels take channel counts in blocks of 64; laying out weights
    for anything else raises instead of launching a wrong kernel."""
    with pytest.raises(ValueError, match="blocks of 64"):
        K.up_gate_weights(torch.zeros(96, 96, 3, 3), torch.zeros(96), torch.float32)


# ------------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the decoder-level kernels run only on the GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# float32: only summation order differs; bf16: stages round at the same points
# in both, so a different summation order can move a value by one bf16 step
CUDA_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def worst(got, ref) -> float:
    """Largest |got - ref| as a share of ref's largest |value|."""
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w,c", [(16, 32, 128), (20, 28, 256)])
def test_gate_kernel_matches_plain(cuda, dtype, h, w, c):
    d = make_inputs(5, 2, h, w, c, c)
    x, wt, b = gate_args(d, cuda, dtype)
    n0 = K.up_gate_dense.launches
    got = K.up_gate_dense(x, K.up_gate_weights(wt, b, dtype))
    torch.cuda.synchronize()
    assert K.up_gate_dense.launches == n0 + 1
    for g, r in zip(got, K.up_gate_dense_ref(x, wt, b)):
        assert worst(g, r) <= CUDA_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w,c,cq", [(16, 32, 128, 64), (20, 28, 256, 128)])
def test_level_kernel_matches_plain(cuda, dtype, h, w, c, cq):
    d = make_inputs(6, 2, h, w, c, cq)
    args = level_args(d, cuda, dtype)
    n0 = K.up_level.launches
    got = K.up_level(*level_call(args))
    torch.cuda.synchronize()
    assert K.up_level.launches == n0 + 1
    assert worst(got, K.up_level_ref(*args)) <= CUDA_TOL[dtype]
