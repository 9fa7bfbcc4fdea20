"""The dense decoder-level kernels' plain versions against the JAX package's
Pallas kernels, and (on a CUDA device) the kernels against their plain
versions.

The JAX side runs `fused_cbn_stats_dense` / `fused_up_dense` in Pallas
interpret mode, as tests/test_pallas.py does. Inputs come from numpy seeds,
in JAX layouts, and are carried to the port's layouts here. Tolerance 1e-4
in float32: only summation order differs. The bf16 level's and gate's
fold-time weight layouts are held to F.conv2d on the CPU, and the bf16
gate's statistics, as per-tile partials over `conv_plan`'s slots reduced
in slot order, to the plain version's.

The CUDA tests need a card and nvcc; without them they skip. On a GPU host
without JAX they run with `python -m pytest --noconftest -m cuda
tests/test_torch_up2.py` (JAX is imported only inside the fixture of the JAX
comparisons).
"""

import re

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


def test_cpu_wrappers_take_the_plain_version_in_bf16():
    """bf16 weights laid out for the CPU are the plain version's, as given
    (the kernel layouts are made only for weights on a card); the wrappers
    return the plain versions' results and count no launch. On a card the
    gate's bf16 weight is `gemm_taps`' (9, C, C), over which a conv is
    F.conv2d's over the weight rounded to bf16."""
    from unet_goolenet_tpu_torch.ops.conv import conv2d

    d = make_inputs(7, 1, 8, 12, 64, 64)
    args = level_args(d, dtype=torch.bfloat16)
    wts = K.up_level_weights(*args[3:], dtype=torch.bfloat16)
    assert wts.kernel == () and all(a is b for a, b in zip(wts.plain, args[3:]))
    n0 = K.up_level.launches
    got = K.up_level(*args[:3], wts)
    assert got.dtype == torch.bfloat16 and K.up_level.launches == n0
    torch.testing.assert_close(got, K.up_level_ref(*args), rtol=0, atol=0)

    x, w, b = gate_args(d, dtype=torch.bfloat16)
    gw = K.up_gate_weights(w, b, torch.bfloat16)
    assert gw.kernel == () and gw.plain[0] is w and gw.plain[1] is b
    n0 = K.up_gate_dense.launches
    for g, r in zip(K.up_gate_dense(x, gw), K.up_gate_dense_ref(x, w, b)):
        assert g.dtype == r.dtype
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    assert K.up_gate_dense.launches == n0
    wk, bk = K.gate_layout(w, b, torch.bfloat16)
    assert tuple(wk.shape) == K.gate_shape(64, torch.bfloat16) == (9, 64, 64)
    assert wk.dtype == torch.bfloat16 and wk.is_contiguous() and torch.equal(wk, K.gemm_taps(w))
    assert bk.dtype == torch.float32 and torch.equal(bk, b)
    xf = x.float()
    torch.testing.assert_close(conv_by_taps(xf, wk),
                               conv2d(xf, w.to(torch.bfloat16).float(), padding=1),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,h,w,c", [(2, 20, 28, 256), (2, 14, 14, 512)])
def test_gate_stats_partials_reduce_to_the_plain_statistics(n, h, w, c):
    """The bf16 gate's statistics as its kernels take them, in plain torch:
    each (M tile, rank) of `conv_plan` sums and maxes the float32 e1 of the
    pixels `slot_pixels` names into its slot (0 and 0 for none), and each
    image's slots are reduced in slot order. At these levels K splits (2
    and 3 ranks). The result is the plain version's mean and max."""
    from unet_goolenet_tpu_torch.ops.kernels.conv import conv_plan

    e1, mean, mx = K.up_gate_dense_ref(*gate_args(make_inputs(11, n, h, w, c, c)))
    p = conv_plan(False, n, h, w, c, c, 132)   # an H100 SXM's SMs
    assert p.splits > 1
    flat = e1.reshape(n * h * w, c)
    psum = torch.zeros(n, p.stats_slots, c)
    pmax = torch.zeros(n, p.stats_slots, c)
    for mt in range(p.mtiles):
        for rank in range(p.splits):
            img, slot = p.stats_slot(mt, rank)
            px = p.slot_pixels(mt, rank)
            if px:
                psum[img, slot], pmax[img, slot] = flat[px].sum(0), flat[px].amax(0)
    s, m = torch.zeros(n, c), torch.zeros(n, c)
    for slot in range(p.stats_slots):
        s, m = s + psum[:, slot], torch.maximum(m, pmax[:, slot])
    torch.testing.assert_close(s / (h * w), mean, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(m, mx, rtol=1e-6, atol=1e-6)


def conv_by_taps(x, wk):
    """A 3x3 pad-1 conv of x (N, H, W, Ci) over weights laid out (9, Co, Ci)
    as the bf16 GEMM reads them: tap (ky, kx) multiplies the input ky - 1
    rows and kx - 1 columns on."""
    n, h, w, _ = x.shape
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    return sum(xp[:, t // 3:t // 3 + h, t % 3:t % 3 + w, :] @ wk[t].float().T for t in range(9))


def test_bf16_level_layout_rebuilds_each_conv():
    """The fold-time bf16 layout of d2, the pair conv and block1 ((9, cout,
    cin) bf16): a conv over it equals F.conv2d over the OIHW weight rounded
    to bf16; w_up stays torch's float32 as it lies, the biases float32."""
    from unet_goolenet_tpu_torch.ops.conv import conv2d

    d = make_inputs(8, 1, 6, 10, 64, 64)
    args = level_args(d)
    lay = K.level_layout(*args[3:], dtype=torch.bfloat16)
    assert lay[0].dtype == torch.float32 and torch.equal(lay[0], args[3])
    for (shape, dt), wl in zip(K.level_shapes(64, 64, torch.bfloat16), lay[::2]):
        assert tuple(wl.shape) == shape and wl.dtype == dt and wl.is_contiguous()
    assert all(b.dtype == torch.float32 and torch.equal(b, a)
               for a, b in zip(args[4::2], lay[1::2]))
    rng = np.random.default_rng(9)
    for w, wk in zip(args[5::2], lay[2::2]):
        x = t(rng.standard_normal((1, 6, 10, w.shape[1])).astype(np.float32))
        ref = conv2d(x, w.to(torch.bfloat16).float(), padding=1)
        torch.testing.assert_close(conv_by_taps(x, wk), ref, rtol=1e-5, atol=1e-5)


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


# the gate's cuda cases (h, w, c) at batch 2: ragged and K split (2 ranks),
# K split at 28^2 and 14^2 (2 and 3 ranks), and a ragged level whose last
# tile row and column reach past the image
GATE_KERNEL_CASES = [(16, 32, 128), (20, 28, 256), (28, 28, 512), (14, 14, 512), (26, 38, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w,c", GATE_KERNEL_CASES)
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
@pytest.mark.parametrize("h,w,c", [(28, 28, 512), (14, 14, 512), (26, 38, 256)])
def test_bf16_gate_repeats_bit_for_bit(cuda, h, w, c):
    """Two calls on the same inputs give the same bits: e1 and the
    statistics, whose partials are summed in a fixed order (K split at
    these levels; no float atomics)."""
    x, wt, b = gate_args(make_inputs(12, 2, h, w, c, c), cuda, torch.bfloat16)
    wts = K.up_gate_weights(wt, b, torch.bfloat16)
    for g, r in zip(K.up_gate_dense(x, wts), K.up_gate_dense(x, wts)):
        assert torch.equal(g, r)


def device_launches(fn, calls: int = 4, tries: int = 3) -> dict:
    """Launches a call of fn by device kernel name, from a profiler trace of
    `calls` calls after a warm-up step (whose events, which a trace may
    lose, are dropped). A trace can still lose an event, which shows as a
    count that is not a whole number a call: it is then taken again, up to
    `tries` times."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for n in (1, calls):
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        per = {}
        for e in prof.key_averages():
            if str(e.device_type).endswith("CUDA"):
                per[e.key] = per.get(e.key, 0) + e.count / calls
        if per and all(v == round(v) for v in per.values()):
            break
    return per


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gate_call_launches_the_conv_and_the_reduce(cuda, dtype):
    """A gate call is two device launches, the conv with the statistics'
    partials (bf16: conv3x3_gemm's STATS epilogue, EPI 4; float32:
    dense_conv.cuh's conv_kernel) and gate_stats_kernel: no weight layout."""
    x, wt, b = gate_args(make_inputs(13, 2, 28, 28, 512, 512), cuda, dtype)
    wts = K.up_gate_weights(wt, b, dtype)
    per = device_launches(lambda: K.up_gate_dense(x, wts))
    conv = r"conv3x3_gemm<\d+, false, \d+, \d+, 4>" if dtype == torch.bfloat16 else "conv_kernel<"
    assert sum(per.values()) == 2, per
    assert sum(v for k, v in per.items() if re.search(conv, k)) == 1, per
    assert sum(v for k, v in per.items() if "gate_stats_kernel" in k) == 1, per


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w,c,cq", [(16, 32, 128, 64), (20, 28, 256, 128), (16, 28, 512, 256),
                                      (16, 32, 64, 64)])
def test_level_kernel_matches_plain(cuda, dtype, h, w, c, cq):
    """The model's (C, cq) on small and ragged levels; at batch 2 the pair
    conv and block1 split K (conv.level_plan)."""
    d = make_inputs(6, 2, h, w, c, cq)
    args = level_args(d, cuda, dtype)
    n0 = K.up_level.launches
    got = K.up_level(*level_call(args))
    torch.cuda.synchronize()
    assert K.up_level.launches == n0 + 1
    assert worst(got, K.up_level_ref(*args)) <= CUDA_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,c,cq", [(20, 28, 256, 128), (16, 28, 512, 256)])
def test_bf16_level_repeats_bit_for_bit(cuda, h, w, c, cq):
    """Two calls on the same inputs give the same bits, K splits included."""
    args = level_args(make_inputs(10, 2, h, w, c, cq), cuda, torch.bfloat16)
    call = level_call(args)
    assert torch.equal(K.up_level(*call), K.up_level(*call))


@pytest.mark.cuda
def test_level_deconv_keeps_the_float32_bias(cuda):
    """The level's transposed conv adds b_up in float32 (as up_level_ref and
    the TPU level kernel do), the trainer's deconv2x2 rounds it to bf16 (as
    its plain version does). With one input channel at 1, its weights 256
    and b_up = 1 + 2^-9, up = bf16(257.002) = 258 with the float32 bias and
    bf16(256 + 1) = 256 (a tie, to even) with the rounded one; d2 = 0, and
    the pair conv and block1 pass up's first cq channels through (centre tap
    1), so the level returns up there."""
    from unet_goolenet_tpu_torch.ops.kernels import conv as KC

    n, h, w, c, cq = 1, 8, 12, 128, 64
    x = torch.zeros(n, h // 2, w // 2, c)
    x[..., 0] = 1.0
    w_up = torch.zeros(c, c, 2, 2)
    w_up[0] = 256.0
    b_up = torch.full((c,), 1.0 + 2.0 ** -9)
    w_pair, w_blk1 = torch.zeros(cq, 2 * c, 3, 3), torch.zeros(cq, cq, 3, 3)
    w_pair[range(cq), range(cq), 1, 1] = 1.0
    w_blk1[range(cq), range(cq), 1, 1] = 1.0
    zc, zq = torch.zeros(c), torch.zeros(cq)
    e1 = torch.zeros(n, h, w, c).to(torch.bfloat16)
    args = [a.to(cuda) for a in (x.to(torch.bfloat16), e1, torch.ones(n, c), w_up, b_up,
                                 torch.zeros(c, c, 3, 3), zc, w_pair, zq, w_blk1, zq)]
    got = K.up_level(*level_call(args))
    assert torch.equal(got, K.up_level_ref(*args)) and (got.float() == 258.0).all()
    up = KC.deconv2x2(args[0], args[3], args[4])
    assert torch.equal(up, KC.deconv2x2_ref(args[0], args[3], args[4]))
    assert (up.float() == 256.0).all()
