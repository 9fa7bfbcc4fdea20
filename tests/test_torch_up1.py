"""The up1 kernels' plain versions against the JAX package's Pallas kernels,
and (on a CUDA device) the kernels against their plain versions.

The JAX side runs `fused_cbn_stats` / `fused_up1_outc` in Pallas interpret
mode, as tests/test_pallas.py does; those kernels take the packed
(N, H, W/2, 2C) layout, which is the same memory as dense NHWC
(ops/packed.py:pack is an exact reshape), so inputs are packed on the JAX
side only. Inputs come from numpy seeds. Tolerance 1e-4 (float32; only
summation order differs).

The CUDA tests need a card and nvcc; without them they skip. On a GPU host
without JAX they run with `python -m pytest --noconftest -m cuda
tests/test_torch_up1.py` (this file imports JAX only inside the fixture of
the JAX comparisons).
"""

import numpy as np
import pytest
import torch

from unet_goolenet_tpu_torch.ops.kernels import up1 as K
from torch_threads import torch_threads  # noqa: F401  (autouse)

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def jax_up1():
    """The JAX up1 kernels in interpret mode, plus the pack reshape."""
    pytest.importorskip("jax")
    from unet_goolenet_tpu.ops import pallas as pk
    from unet_goolenet_tpu.ops import packed as P
    from unet_goolenet_tpu.ops.pallas import up1 as PU

    pk.interpret_mode(True)
    return PU, P


def make_inputs(seed, n, h, w, c, ncls):
    """Seeded inputs of one up1 level at output size (h, w): JAX layouts
    (HWIO, deconv (2, 2, Ci, Co), outc (C, ncls)) as numpy arrays."""
    rng = np.random.default_rng(seed)
    r = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    k = 1.0 / np.sqrt(9 * c)
    return {
        "x1": r(n, h, w, c), "y": r(n, h // 2, w // 2, c), "e1": np.abs(r(n, h, w, c)),
        "gate": np.abs(r(n, c)) * 0.5,
        "w_e1": r(3, 3, c, c, sc=k), "b_e1": r(c, sc=0.1),
        "w_up": r(2, 2, c, c, sc=0.3), "b_up": r(c, sc=0.1),
        "w_d2": r(3, 3, c, c, sc=k), "b_d2": r(c, sc=0.1),
        "w_pair": r(3, 3, 2 * c, c, sc=k / np.sqrt(2)), "b_pair": r(c, sc=0.1),
        "w_blk1": r(3, 3, c, c, sc=k), "b_blk1": r(c, sc=0.1),
        "w_outc": r(c, ncls, sc=1 / np.sqrt(c)), "b_outc": r(ncls, sc=0.1),
    }


def oihw(w):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1))))


def tail_args(d, device="cpu", dtype=torch.float32):
    """Port-layout arguments of up1_tail_ref from make_inputs' dict."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    w_up = t(np.transpose(d["w_up"], (2, 3, 0, 1)))
    w_outc = t(d["w_outc"].T[:, :, None, None])
    args = (t(d["y"]).to(dtype), t(d["e1"]).to(dtype), 1.0 + t(d["gate"]),
            w_up, t(d["b_up"]), oihw(d["w_d2"]), t(d["b_d2"]),
            oihw(d["w_pair"]), t(d["b_pair"]), oihw(d["w_blk1"]), t(d["b_blk1"]),
            w_outc, t(d["b_outc"]))
    return tuple(a.to(device) for a in args)


def tail_call(args):
    """tail_args split into up1_tail's (y, e1, gate1p, weights)."""
    return (*args[:3], K.tail_weights(*args[3:], dtype=args[0].dtype))


def jax_tail(PU, P, d):
    import jax.numpy as jnp

    gate_p1 = np.tile(1.0 + d["gate"], (1, 2))
    out = PU.fused_up1_outc(
        P.pack(jnp.asarray(d["y"])), P.pack(jnp.asarray(d["e1"])), jnp.asarray(gate_p1),
        *(jnp.asarray(d[k]) for k in ("w_up", "b_up", "w_d2", "b_d2", "w_pair", "b_pair",
                                      "w_blk1", "b_blk1", "w_outc", "b_outc")))
    return np.asarray(P.unpack(out))


# (c, h, w): 8-channel cases as in tests/test_pallas.py; 64 channels (the
# model's width) at 16x16; and 20x36, which the kernels' 8x16 tile does not
# divide
GATE_CASES = [(8, 16, 12), (64, 16, 16), (64, 20, 36)]
TAIL_CASES = [(8, 32, 16, 1), (8, 16, 8, 3), (64, 16, 16, 1), (64, 20, 36, 3)]


@pytest.mark.parametrize("c,h,w", GATE_CASES)
def test_gate_ref_matches_jax_fused_cbn_stats(jax_up1, c, h, w):
    import jax.numpy as jnp

    PU, P = jax_up1
    d = make_inputs(1, 2, h, w, c, 1)
    e1_p, mean, mx = PU.fused_cbn_stats(P.pack(jnp.asarray(d["x1"])),
                                        jnp.asarray(d["w_e1"]), jnp.asarray(d["b_e1"]))
    e1, m, x = K.up1_gate_ref(torch.from_numpy(d["x1"]), oihw(d["w_e1"]),
                              torch.from_numpy(d["b_e1"]))
    np.testing.assert_allclose(e1.numpy(), np.asarray(P.unpack(e1_p)), **TOL)
    np.testing.assert_allclose(m.numpy(), np.asarray(mean)[:, 0, 0], **TOL)
    np.testing.assert_allclose(x.numpy(), np.asarray(mx)[:, 0, 0], **TOL)


@pytest.mark.parametrize("c,h,w,ncls", TAIL_CASES)
def test_tail_ref_matches_jax_fused_up1_outc(jax_up1, c, h, w, ncls):
    PU, P = jax_up1
    d = make_inputs(2, 2, h, w, c, ncls)
    ref = jax_tail(PU, P, d)
    got = K.up1_tail_ref(*tail_args(d)).numpy()
    assert got.shape == ref.shape == (2, h, w, ncls)
    np.testing.assert_allclose(got, ref, **TOL)


def test_cpu_wrappers_take_the_plain_version():
    """On CPU tensors the wrappers return the plain versions' results and do
    not count a kernel launch."""
    d = make_inputs(3, 1, 12, 20, 64, 2)
    before = (K.up1_gate.launches, K.up1_tail.launches)
    x1, w, b = torch.from_numpy(d["x1"]), oihw(d["w_e1"]), torch.from_numpy(d["b_e1"])
    got = K.up1_gate(x1, K.gate_weights(w, b, torch.float32))
    for g, ref in zip(got, K.up1_gate_ref(x1, w, b)):
        torch.testing.assert_close(g, ref, rtol=0, atol=0)
    args = tail_args(d)
    torch.testing.assert_close(K.up1_tail(*tail_call(args)), K.up1_tail_ref(*args),
                               rtol=0, atol=0)
    assert (K.up1_gate.launches, K.up1_tail.launches) == before


def test_cpu_tail_takes_the_plain_version_in_bf16():
    """bf16 tail weights laid out for the CPU are the plain version's, as
    given; the wrapper returns the plain version's logits, counts no
    launch."""
    args = tail_args(make_inputs(7, 1, 8, 12, 64, 2), dtype=torch.bfloat16)
    wts = K.tail_weights(*args[3:], dtype=torch.bfloat16)
    assert wts.kernel == () and len(wts.plain) == 10
    n0 = K.up1_tail.launches
    got = K.up1_tail(*args[:3], wts)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 8, 12, 2)
    assert K.up1_tail.launches == n0
    torch.testing.assert_close(got, K.up1_tail_ref(*args), rtol=0, atol=0)


def test_bf16_plain_version_rounds_between_stages():
    """In bf16 the plain tail keeps float32 sums but rounds each stage to
    bf16: it stays close to the float32 result and returns bf16."""
    d = make_inputs(4, 1, 16, 16, 8, 1)
    ref = K.up1_tail_ref(*tail_args(d)).numpy()
    got = K.up1_tail_ref(*tail_args(d, dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0.05,
                               atol=0.05 * np.abs(ref).max())


# ------------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the up1 kernels run only on the GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# float32: only summation order differs; bf16: stages round to bf16 at the
# same points in both, so a different summation order can move a value by one
# bf16 step (2^-8 relative), which later stages carry
CUDA_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w", [(16, 32), (20, 36), (14, 14), (26, 38)])
def test_gate_kernel_matches_plain(cuda, dtype, h, w):
    """Small levels, one tile an image at 14x14, and ragged ones (the bf16
    tiles of 16x32 and 26x38 reach past the image's last column)."""
    d = make_inputs(5, 2, h, w, 64, 1)
    x1 = torch.from_numpy(d["x1"]).to(cuda, dtype)
    wt, b = oihw(d["w_e1"]).to(cuda), torch.from_numpy(d["b_e1"]).to(cuda)
    n0 = K.up1_gate.launches
    got = K.up1_gate(x1, K.gate_weights(wt, b, dtype))
    torch.cuda.synchronize()
    assert K.up1_gate.launches == n0 + 1
    for g, r in zip(got, K.up1_gate_ref(x1, wt, b)):
        scale = r.float().abs().max().item()
        assert (g.float() - r.float()).abs().max().item() <= CUDA_TOL[dtype] * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w,ncls", [(16, 32, 1), (20, 36, 3), (36, 52, 1), (12, 20, 11)])
def test_tail_kernel_matches_plain(cuda, dtype, h, w, ncls):
    """Ragged levels (the bf16 head's shuffles at a tile's and the image's
    edge) and up to 11 classes (the head's classes over its 8 lanes)."""
    d = make_inputs(6, 2, h, w, 64, ncls)
    args = tail_args(d, cuda, dtype)
    n0 = K.up1_tail.launches
    got = K.up1_tail(*tail_call(args))
    torch.cuda.synchronize()
    assert K.up1_tail.launches == n0 + 1
    ref = K.up1_tail_ref(*args)
    scale = ref.float().abs().max().item()
    assert (got.float() - ref.float()).abs().max().item() <= CUDA_TOL[dtype] * scale


@pytest.mark.cuda
def test_bf16_tail_repeats_bit_for_bit(cuda):
    """Two calls on the same inputs give the same bits (the pair conv splits
    K at this size)."""
    args = tail_args(make_inputs(8, 2, 36, 52, 64, 3), cuda, torch.bfloat16)
    call = tail_call(args)
    assert torch.equal(K.up1_tail(*call), K.up1_tail(*call))
