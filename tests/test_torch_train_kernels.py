"""Kernels 6-9 of the port (ops/kernels/conv.py) against the JAX package's
Pallas kernels in `unet_goolenet_tpu/ops/pallas/conv.py`, and (on a CUDA
device) each kernel against its plain version.

On the CPU the wrappers and the autograd functions `conv3x3`, `deconv` and
`pool2x2` run the plain versions, forward and backward; the JAX side runs
`fused_conv3x3`, `fused_convstack2`, `conv_transpose2x2_pallas` and
`max_pool2x2_pallas` in Pallas interpret mode, as tests/test_pallas.py does,
with their custom VJPs. Shapes follow test_pallas.py's (a 3-channel input
for the conv, a multi-tile deconv, exact ties in the pool). Gradients are
taken of sum(f(x) * c) for a seeded cotangent c on both sides. Tolerance:
1e-4 of the reference's max |value| in float32, for values and gradients.

The weight-gradient kernels' plan (`wgrad_plan`) is plain Python, held here
at the trainer's 16 conv and 4 deconv shapes: every output tile of every
item is computed by exactly one block, the partial scratch is what the
blocks write, and one pass writes at most 0.5 GB of partials. So is the
transposed conv's tiling (`deconv_plan`), at the trainer's 4 levels and the
kernel tests' edges: every output element is written by one block, once.

On a GPU host without JAX: `python -m pytest --noconftest -m cuda
tests/test_torch_train_kernels.py`. There each kernel, forward and every
backward, is held to its plain version at 1e-4 (float32, TF32 off) and 2e-2
(bfloat16) of the plain result's max |value|, at ragged sizes, cin = 3 and
the plan's edges, and the weight gradients to a second call bit for bit.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from unet_goolenet_tpu_torch.ops.kernels import conv as K
from torch_threads import torch_threads  # noqa: F401  (autouse)

RTOL = 1e-4


def close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= RTOL * max(np.abs(want).max(), 1e-30), f"{what}: {err:.3e}"


@pytest.fixture(scope="module")
def pk():
    pytest.importorskip("jax")
    from unet_goolenet_tpu.ops import pallas

    pallas.interpret_mode(True)
    return pallas


def rand(rng, *shape, sc=1.0):
    return (rng.standard_normal(shape) * sc).astype(np.float32)


def grads(fn, args, cot):
    """Gradients of sum(fn(*args) * cot) with respect to every arg (torch)."""
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    (fn(*ts) * torch.from_numpy(cot)).sum().backward()
    return [t.grad.numpy() for t in ts]


def jax_grads(fn, args, cot):
    import jax
    import jax.numpy as jnp

    return [np.asarray(g) for g in jax.grad(
        lambda *a: jnp.sum(fn(*a) * cot), argnums=tuple(range(len(args))))(
            *(jnp.asarray(a) for a in args))]


def hwio(w):
    """OIHW numpy -> the JAX kernel's HWIO."""
    return np.transpose(w, (2, 3, 1, 0))


@pytest.mark.parametrize("n,h,w,cin,cout,relu", [(2, 16, 24, 3, 16, True)])
def test_fused_conv3x3_matches_pallas(pk, n, h, w, cin, cout, relu):
    """cin = 3 with relu; relu=False is the train path's call, which
    test_torch_train_step.py holds to the JAX step."""
    rng = np.random.default_rng(1)
    x, wt = rand(rng, n, h, w, cin), rand(rng, cout, cin, 3, 3, sc=(9 * cin) ** -0.5)
    scale, bias = np.abs(rand(rng, cout)) + 0.5, rand(rng, cout, sc=0.1)
    cot = rand(rng, n, h, w, cout)
    port = lambda x_, w_, s_, b_: K.conv3x3(x_, w_, s_, b_, relu)
    jfn = lambda x_, w_, s_, b_: pk.fused_conv3x3(x_, w_.transpose(2, 3, 1, 0), s_, b_, relu)
    args = (x, wt, scale, bias)
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in args)).numpy()
    close(got, np.asarray(jfn(*args)), "forward")
    for name, g, r in zip(("dx", "dw", "dscale", "dbias"), grads(port, args, cot),
                          jax_grads(jfn, args, cot)):
        close(g, r, name)


def test_fused_convstack2_matches_pallas(pk):
    rng = np.random.default_rng(2)
    x = rand(rng, 2, 8, 12, 16)
    w1, w2 = rand(rng, 32, 16, 3, 3, sc=0.1), rand(rng, 16, 32, 3, 3, sc=0.1)
    s1, b1 = np.abs(rand(rng, 32)) + 0.5, rand(rng, 32, sc=0.1)
    s2, b2 = np.abs(rand(rng, 16)) + 0.5, rand(rng, 16, sc=0.1)
    t = torch.from_numpy
    got = K.fused_convstack2(t(x), t(w1), t(s1), t(b1), t(w2), t(s2), t(b2)).numpy()
    close(got, np.asarray(pk.fused_convstack2(x, hwio(w1), s1, b1, hwio(w2), s2, b2)))


@pytest.mark.parametrize("n,h,w,cin,cout", [(2, 8, 12, 8, 4)])
def test_deconv_matches_pallas(pk, n, h, w, cin, cout):
    """(2, 8, 12) is test_pallas.py's multi-tile case: the JAX dW/db
    accumulator is revisited across grid steps."""
    rng = np.random.default_rng(3)
    x, wt, b = rand(rng, n, h, w, cin), rand(rng, cin, cout, 2, 2), rand(rng, cout)
    cot = rand(rng, n, 2 * h, 2 * w, cout)
    jfn = lambda x_, w_, b_: pk.conv_transpose2x2_pallas(x_, w_.transpose(2, 3, 0, 1), b_)
    args = (x, wt, b)
    with torch.no_grad():
        close(K.deconv(*(torch.from_numpy(a) for a in args)).numpy(), np.asarray(jfn(*args)))
    for name, g, r in zip(("dx", "dw", "db"), grads(K.deconv, args, cot),
                          jax_grads(jfn, args, cot)):
        close(g, r, name)


@pytest.mark.parametrize("ties", [True, False], ids=["ties", "distinct"])
def test_max_pool_matches_pallas(pk, ties):
    """Ties: integer values in {0, 1, 2}, so most windows hold several
    maxima; the gradient must go to the first in (r0c0, r0c1, r1c0, r1c1)
    order on both sides, exactly."""
    rng = np.random.default_rng(4)
    if ties:
        x = rng.integers(0, 3, (2, 8, 8, 4)).astype(np.float32)
    else:
        x = rng.permutation(16 * 16 * 4).reshape(1, 16, 16, 4).astype(np.float32)
    cot = rand(rng, x.shape[0], x.shape[1] // 2, x.shape[2] // 2, 4)
    with torch.no_grad():
        got = K.pool2x2(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(pk.max_pool2x2_pallas(x)))
    (g,), (r,) = grads(K.pool2x2, (x,), cot), jax_grads(pk.max_pool2x2_pallas, (x,), cot)
    np.testing.assert_array_equal(g, r)


def test_cpu_wrappers_take_the_plain_versions():
    """On CPU tensors every wrapper returns its plain version's result and
    counts no launch; the conv's dx is skipped when its input needs no
    gradient."""
    rng = np.random.default_rng(5)
    t = lambda *s: torch.from_numpy(rand(rng, *s))
    before = {fn.__name__: fn.launches for fn in K.WRAPPERS}
    x, w, s, b = t(1, 6, 10, 3), t(64, 3, 3, 3), t(64), t(64)
    torch.testing.assert_close(K.fused_conv3x3(x, w, s, b, True),
                               K.fused_conv3x3_ref(x, w, s, b, True), rtol=0, atol=0)
    g = t(1, 6, 10, 64)
    torch.testing.assert_close(K.conv3x3_dw(x, g), K.conv3x3_dw_ref(x, g), rtol=0, atol=0)
    xd, wd, bd = t(1, 3, 5, 64), t(64, 64, 2, 2), t(64)
    torch.testing.assert_close(K.deconv2x2(xd, wd, bd), K.deconv2x2_ref(xd, wd, bd))
    xp = t(1, 6, 10, 64)
    torch.testing.assert_close(K.max_pool2x2(xp), K.max_pool2x2_ref(xp), rtol=0, atol=0)
    assert {fn.__name__: fn.launches for fn in K.WRAPPERS} == before
    wg = w.clone().requires_grad_()
    K.conv3x3(x, wg, s, b, False).sum().backward()
    assert wg.grad is not None and x.grad is None


# ------------------------------------------------------------------ the weight-gradient plan

SMS = 132   # an H100 SXM's SMs
# the trainer's 3x3 convs (size, cin, cout, calls per pass) and transposed
# convs (input size, C) at batch 4 and 224^2, as chip_smoke.py drives them
TRAIN_CONVS = ((224, 3, 64, 1), (112, 64, 128, 1), (112, 128, 128, 3), (56, 128, 256, 1),
               (56, 256, 256, 3), (28, 256, 512, 1), (28, 512, 512, 3), (14, 512, 512, 4),
               (28, 1024, 256, 1), (28, 256, 256, 1), (56, 512, 128, 1), (56, 128, 128, 1),
               (112, 256, 64, 1), (112, 64, 64, 1), (224, 64, 64, 3), (224, 128, 64, 1))
TRAIN_DECONVS = ((14, 512), (28, 256), (56, 128), (112, 64))


def tile_floats(plan, mt: int, cin: int) -> int:
    """Floats the kernel's epilogue writes for an output tile in input-channel
    block mt (csrc/conv_dw.cuh): its dw rows, and for the deconv's first
    block its 32 db columns."""
    if plan.taps == 9:
        return min(64, cin - 64 * mt) * 9 * 64
    return 64 * 128 + (32 if mt == 0 else 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("taps,h,cin,cout", [(9, h, ci, co) for h, ci, co, _ in TRAIN_CONVS]
                         + [(1, h, c, c) for h, c in TRAIN_DECONVS])
def test_wgrad_plan_covers_every_tile_once(taps, h, cin, cout, dtype):
    n = 4
    plan = K.wgrad_plan(taps, n, h, h, cin, cout, dtype, SMS)
    if taps == 9:
        rows, cols = plan.tile
        assert plan.items == n * -(-h // rows) * -(-h // cols)
        assert plan.out_elems == 9 * cin * cout
    else:
        assert plan.items == -(-n * h * h // K.DW_STEP)
        assert plan.out_elems == 4 * cin * cout + cout
    seen, written = Counter(), 0
    for chunk, mt, nt, first, count in plan.blocks():
        assert 1 <= count <= plan.per_chunk
        seen.update((item, mt, nt) for item in range(first, first + count))
        written += tile_floats(plan, mt, cin)
    assert set(seen.values()) == {1}
    assert len(seen) == plan.items * plan.mtiles * plan.ntiles
    assert written == plan.chunks * plan.out_elems   # each chunk yields the whole result once
    # only a grid reduce puts the chunks' results in scratch; a cluster sums them on chip
    assert plan.partial_elems == (written if plan.reduce == "grid" else 0)
    assert plan.reduce == ("one" if plan.chunks == 1 else
                           "cluster" if plan.chunks <= K.MAX_CLUSTER else "grid")
    if plan.chunks > 1:   # the grid barrier needs every block resident: one per SM
        assert plan.grid <= SMS and plan.per_chunk >= K.DW_MIN_ITEMS


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_wgrad_plan_partials_of_a_pass(dtype):
    """One forward + backward pass's 27 conv dw calls write at most 0.5 GB
    of float32 partials (the single-buffered kernel's plan wrote 1.05 GB);
    each level gets the tile that wastes least."""
    total = sum(k * K.wgrad_plan(9, 4, h, h, ci, co, dtype, SMS).partial_bytes
                for h, ci, co, k in TRAIN_CONVS)
    assert total <= 0.5e9, total
    tiles = {torch.bfloat16: [(8, 16), (8, 16), (8, 16), (4, 32), (8, 16)],
             torch.float32: [(8, 16), (8, 16), (4, 28), (4, 28), (7, 14)]}[dtype]
    assert [K.dw_tile(h, h, dtype) for h in (224, 112, 56, 28, 14)] == tiles


# the kernel tests' edges for the transposed conv: (n, h, w, cin, cout) of x
# (n, h, w, cin) and w (cin, cout, 2, 2): fewer pixels than an M tile, one
# smaller than a tile, cin != cout, a ragged level
DECONV_EDGES = ((3, 5, 7, 64, 64), (1, 3, 3, 256, 256), (2, 7, 9, 512, 256), (2, 10, 14, 128, 128))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("dx", [False, True], ids=["forward", "dx"])
@pytest.mark.parametrize("n,h,w,cin,cout", [(4, h, h, c, c) for h, c in TRAIN_DECONVS]
                         + list(DECONV_EDGES))
def test_deconv_plan_covers_every_output_once(n, h, w, cin, cout, dx, dtype):
    """Every output element of the transposed conv's forward or dx lies in
    one M tile and one N tile; each tile's K splits cover the K tiles once
    and its cluster ranks share out its 16-byte output chunks, each summed
    over the splits by one rank: so each element is written once. A split
    plan stays in one wave of one block per SM."""
    plan = K.deconv_plan(dx, n, h, w, cin, cout, SMS)
    rows, width = (n * h, w) if dx else (1, n * h * w)
    assert (plan.rows, plan.width, plan.n) == (rows, width, cin if dx else 4 * cout)
    assert plan.R * plan.S <= K.DC_BM and plan.ktiles * K.DC_BK == (4 * cout if dx else cin)
    pixels = np.concatenate([plan.pixels(mt) for mt in range(plan.mtiles)])
    np.testing.assert_array_equal(np.bincount(pixels, minlength=rows * width), 1)
    assert plan.ntiles * plan.bn == plan.n
    ktiles = {}
    for split, mt, nt, first, count in plan.blocks():
        assert count >= 1 and (mt, nt, split) not in ktiles
        ktiles[mt, nt, split] = range(first, first + count)
    assert len(ktiles) == plan.grid == plan.mtiles * plan.ntiles * plan.splits
    for mt in range(plan.mtiles):
        for nt in range(plan.ntiles):
            assert sorted(k for z in range(plan.splits) for k in ktiles[mt, nt, z]) == \
                list(range(plan.ktiles))
    chunks = sorted(c for z in range(plan.splits) for c in plan.stores(z, dtype))
    assert chunks == list(range(plan.R * plan.S * plan.bn * torch.finfo(dtype).bits // 128))
    if plan.splits > 1:
        assert dx and plan.splits <= K.DC_MAX_SPLIT and plan.grid <= SMS
        assert plan.kper >= K.DC_MIN_KTILES


# ------------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the conv, deconv and pool kernels run only on the GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


CUDA_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def on_card(cuda, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return lambda *s, sc=1.0: (torch.randn(*s, generator=g) * sc).to(cuda)


def agrees(got, ref, dtype):
    got, ref = got.float(), ref.float()
    assert got.shape == ref.shape and torch.isfinite(got).all()
    err = ((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()
    assert err <= CUDA_TOL[dtype], err


def counted(fn, *args):
    n0 = fn.launches
    out = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,cin,cout", [(2, 20, 28, 64, 128), (2, 16, 24, 3, 64),
                                            (1, 9, 13, 128, 64), (4, 14, 14, 512, 512),
                                            (2, 28, 28, 1024, 256)])
def test_conv3x3_kernels_match_plain(cuda, dtype, n, h, w, cin, cout):
    """Ragged levels, cin = 3, and the weight-gradient plan's edges: 14x14
    512->512 in one chunk, 28x28 1024->256 with the most output tiles; the
    weight gradient repeats bit for bit."""
    r = on_card(cuda, dtype, 6)
    x, wt = r(n, h, w, cin).to(dtype), r(cout, cin, 3, 3, sc=(9 * cin) ** -0.5)
    s, b, g = r(cout).abs() + 0.5, r(cout, sc=0.1), r(n, h, w, cout).to(dtype)
    for relu in (True, False):
        agrees(counted(K.fused_conv3x3, x, wt, s, b, relu), K.fused_conv3x3_ref(x, wt, s, b, relu),
               dtype)
    dw = counted(K.conv3x3_dw, x, g)
    agrees(dw, K.conv3x3_dw_ref(x, g), dtype)
    assert torch.equal(dw, K.conv3x3_dw(x, g))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_convstack2_kernel_matches_plain(cuda, dtype):
    r = on_card(cuda, dtype, 7)
    x = r(2, 20, 28, 128).to(dtype)
    w1, w2 = r(64, 128, 3, 3, sc=(9 * 128) ** -0.5), r(128, 64, 3, 3, sc=(9 * 64) ** -0.5)
    vs = (r(64).abs() + 0.5, r(64, sc=0.1), r(128).abs() + 0.5, r(128, sc=0.1))
    agrees(counted(K.fused_convstack2, x, w1, vs[0], vs[1], w2, vs[2], vs[3]),
           K.fused_convstack2_ref(x, w1, vs[0], vs[1], w2, vs[2], vs[3]), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,c", [(2, 10, 14, 128), (1, 7, 9, 512), (3, 5, 7, 64),
                                     (1, 3, 3, 256),
                                     pytest.param(2, 7, 9, (512, 256), id="2-7-9-512-256")])
def test_deconv_kernels_match_plain(cuda, dtype, n, h, w, c):
    """A ragged level, levels of fewer pixels than an M tile (3x5x7, and
    1x3x3 smaller than a tile's row), and cin != cout (c = (cin, cout));
    the weight gradients repeat bit for bit."""
    cin, cout = c if isinstance(c, tuple) else (c, c)
    r = on_card(cuda, dtype, 8)
    x, wt, b = r(n, h, w, cin).to(dtype), r(cin, cout, 2, 2, sc=cin ** -0.5), r(cout, sc=0.1)
    g = r(n, 2 * h, 2 * w, cout).to(dtype)
    agrees(counted(K.deconv2x2, x, wt, b), K.deconv2x2_ref(x, wt, b), dtype)
    agrees(counted(K.deconv2x2_dx, g, wt), K.deconv2x2_dx_ref(g, wt), dtype)
    dwdb = counted(K.deconv2x2_dwdb, x, g)
    for got, ref, again in zip(dwdb, K.deconv2x2_dwdb_ref(x, g), K.deconv2x2_dwdb(x, g)):
        agrees(got, ref, dtype)
        assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pool_kernels_match_plain_with_ties(cuda, dtype):
    g = torch.Generator().manual_seed(9)
    x = torch.randint(0, 3, (2, 20, 28, 64), generator=g).to(cuda, dtype)
    gy = torch.randn(2, 10, 14, 64, generator=g).to(cuda, dtype)
    assert torch.equal(counted(K.max_pool2x2, x), K.max_pool2x2_ref(x))
    assert torch.equal(counted(K.max_pool2x2_bwd, x, gy), K.max_pool2x2_bwd_ref(x, gy))


@pytest.mark.cuda
def test_model_kernel_path_launches_or_raises(cuda):
    """With kernels=True a CUDA forward and backward launch every kernel of
    the train path; a shape a kernel cannot take raises, it does not fall
    back."""
    from unet_goolenet_tpu_torch.models import UNetTaskAligWeight

    model = UNetTaskAligWeight(1, img_size=32, kernels=True).to(cuda).train()
    before = {fn.__name__: fn.launches for fn in K.WRAPPERS}
    model(torch.rand(2, 32, 32, 3, device=cuda)).sum().backward()
    model.eval()
    with torch.no_grad():
        model(torch.rand(2, 32, 32, 3, device=cuda))
    torch.cuda.synchronize()
    assert all(fn.launches > before[fn.__name__] for fn in K.WRAPPERS)
    with pytest.raises(ValueError, match="multiples of 64"):
        K.fused_conv3x3(torch.rand(1, 8, 8, 64, device=cuda), torch.rand(32, 64, 3, 3),
                        torch.ones(32), torch.zeros(32), True)
