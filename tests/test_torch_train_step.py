"""The port's refinement train step against the JAX package's
`make_seg_train_step(forward="flax")`: the full-width UNetTaskAligWeight,
batch 2, n_refine 2, AdamW at lr 1e-4, from the same weights (the port's
default init from a seed, carried to JAX with `unet_to_jax` and back with
`unet_from_jax`), at 32x32: three JAX steps against three steps of the
port with the kernels on (on the CPU the kernels' plain versions, with
their backward composition: dx through the flipped weights, the split-K dw,
the deconv's inverse depth-to-space, first-max pool routing) and against
one step of the port with them off (stock torch ops), and one float32 step
with the kernels. test_torch_train_f32.py holds the float32 step against
the JAX package's own float32 step.

Why float64. This configuration is ill-conditioned in float32: train-mode
BatchNorm over 8 values a channel at the 2x2 bottleneck amplifies rounding,
so the JAX package's own float32 pass-0 gradients lie up to 4.3% (of a
leaf's max |value|) from its float64 ones, and AdamW's first update,
lr * sign(g), flips elements whose gradient is rounding noise (conv biases
ahead of BatchNorm are exactly zero analytically); a second float32 JAX run
from weights perturbed by 1e-7 ends its first step with batch statistics
3e-3 apart. So the two packages are held to each other in float64, where
both compute the same function: JAX under `enable_x64` with the flax model
in float64, the seg loss as JAX's `dc_and_bce_loss` formula without its
float32 cast, and two float32 accumulations of the JAX forward widened to
float64 for these tests (the attention einsums' preferred_element_type and
`conv_transpose2x2`'s accum_dtype, patched inside `jax_steps` only); the
port runs the model in float64 (its plain versions compute in float64 for
float64 inputs). Tolerances:
  * losses of every step (the mean of both passes, and their sum): 1e-9
    absolute;
  * pass-0 gradients: 1e-4 of each leaf's max |value|; leaves whose
    gradient is zero analytically (the conv biases ahead of train-mode
    BatchNorm, below 1e-12 of the largest gradient in the reference) must be
    below that floor on the port's side too;
  * batch_stats after step 1 (and 3): 1e-4 of each leaf's max |value|;
  * params after step 1 (and 3): 1e-6 absolute (1% of lr), which a flipped
    sign (2 lr) would break.
Float32, one step with the kernels against the float64 reference: loss
1e-4 (it reads 1.4e-5), and pass 0's gradients as a whole, the L2 norm of
the difference over that of the gradient (leaves zero analytically left
out), 0.05 (it reads 0.0136, for the stock path too). Single leaves are not
held to float64 here: rounding amplified by the train-mode BatchNorm moves
the worst leaf by several % of its max (the JAX package's own float32
gradients are 0.043 of a leaf's max off its float64 ones);
test_torch_train_f32.py holds each leaf against JAX's float32 step instead.
"""

import functools
import threading

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

from unet_goolenet_tpu_torch.models import UNetTaskAligWeight, unet_from_jax, unet_to_jax
from unet_goolenet_tpu_torch.train import optim, seg
from torch_threads import torch_threads  # noqa: F401  (autouse)

S, N, STEPS = 32, 2, 3


def weights() -> dict:
    """The port's default init (the reference's torch init) from a seed, as
    JAX variables."""
    torch.manual_seed(7)
    return unet_to_jax(UNetTaskAligWeight(1, img_size=S).state_dict())


def batch():
    rng = np.random.default_rng(3)
    imgs = rng.uniform(0.0, 1.0, (N, S, S, 3))
    labels = (rng.uniform(0.0, 1.0, (N, S, S, 1)) > 0.6).astype(np.float64)
    return imgs, labels


def jax_loss64(logits, target):
    """unet_goolenet_tpu/train/losses.py:dc_and_bce_loss, in the input's
    dtype (the package's version casts to float32)."""
    bce = jnp.mean(jnp.maximum(logits, 0) - logits * target
                   + jnp.log1p(jnp.exp(-jnp.abs(logits))))
    p = jax.nn.sigmoid(logits)
    inter = jnp.sum(p * target, axis=(1, 2))
    denom = jnp.sum(p, axis=(1, 2)) + jnp.sum(target, axis=(1, 2))
    return 0.5 * bce + 0.5 * jnp.mean(1.0 - (2.0 * inter + 1e-5) / (denom + 1e-5))


def attend64(q, k, v, scale, heads):
    """unet_goolenet_tpu/nn/transformer.py:_attend without its float32
    preferred_element_type."""
    b, n, hd = q.shape
    split = lambda t: t.reshape(b, n, heads, hd // heads).transpose(0, 2, 1, 3)
    q, k, v = split(q), split(k), split(v)
    attn = jax.nn.softmax(jnp.einsum("bhid,bhjd->bhij", q, k) * scale, axis=-1)
    return jnp.einsum("bhij,bhjd->bhid", attn, v).transpose(0, 2, 1, 3).reshape(b, n, hd)


def keep_first_grads():
    """An optax transformation that passes updates through and keeps the
    first ones it sees (pass 0's gradients) in its state."""
    def init(params):
        return {"count": jnp.zeros([], jnp.int32), "g0": jax.tree_util.tree_map(jnp.zeros_like,
                                                                               params)}

    def update(updates, state, params=None):
        first = state["count"] == 0
        g0 = jax.tree_util.tree_map(lambda g, k: jnp.where(first, g, k), updates, state["g0"])
        return updates, {"count": state["count"] + 1, "g0": g0}

    return optax.GradientTransformation(init, update)


def flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def jax_steps(uv, steps: int):
    """`steps` float64 JAX train steps from the weights uv on the test
    batch: each step's loss, params and batch_stats (flattened), and pass
    0's gradients."""
    import unet_goolenet_tpu.nn.blocks as jblocks
    import unet_goolenet_tpu.nn.transformer as jtransformer
    from unet_goolenet_tpu.models import UNetTaskAligWeight as JUNet
    from unet_goolenet_tpu.ops.conv import conv_transpose2x2
    from unet_goolenet_tpu.train import optim as joptim
    from unet_goolenet_tpu.train.seg import TrainState, make_seg_train_step

    imgs, labels = batch()
    out = []
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jtransformer, "_attend", attend64)
        mp.setattr(jblocks, "conv_transpose2x2",
                   functools.partial(conv_transpose2x2, accum_dtype=jnp.float64))
        model = JUNet(n_classes=1, dtype=jnp.float64)
        tx = optax.chain(keep_first_grads(), joptim.make_adamw(1e-4))
        as64 = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)
        params = as64(uv["params"])
        state = TrainState(params, as64(uv["batch_stats"]), tx.init(params))
        x, y = jnp.asarray(imgs), jnp.asarray(labels)
        step = jax.jit(make_seg_train_step(model, tx, loss_fn=jax_loss64, forward="flax"),
                       donate_argnums=0)
        for i in range(steps):
            state, metrics = step(state, x, y)
            out.append({"loss": float(metrics["loss"])})
            out[-1].update(params=flat(state.params), batch_stats=flat(state.batch_stats))
        out[0]["grads0"] = flat(state.opt_state[0]["g0"])
    return out


def snapshot(model) -> dict:
    """The model's params and batch_stats in flax layout, flattened."""
    v = unet_to_jax(model.state_dict())
    return {"params": flat(v["params"]), "batch_stats": flat(v["batch_stats"])}


def port_run(uv, kernels: bool, steps: int) -> dict:
    """`steps` float64 port train steps from uv: each step's loss and
    seg_loss, pass 0's gradients, and the state after the first step and
    the last."""
    imgs, labels = (torch.from_numpy(a).to(torch.float64) for a in batch())
    model = port_model(uv, kernels, torch.float64)
    states = {}
    metrics, grads0 = run_steps(
        model, imgs, labels, steps,
        after=lambda i: i in (0, steps - 1) and states.__setitem__(i + 1, snapshot(model)))
    return {"losses": [float(m["loss"]) for m in metrics],
            "seg_losses": [float(m["seg_loss"]) for m in metrics],
            "grads0": grads0, "states": states}


# the port's runs: kernels -> steps
PORT_STEPS = {False: 1, True: STEPS}


@pytest.fixture(scope="module")
def ref():
    """The JAX steps and the port's steps with the kernels off and on, from
    the same weights; the port's two runs go in threads beside JAX's trace,
    compile and steps (all release the GIL in their kernels), which cuts the
    wall time to about JAX's alone."""
    uv = weights()
    port = {False: {}, True: {}}
    threads = [threading.Thread(
        target=lambda k=k: port[k].update(port_run(uv, k, PORT_STEPS[k]))) for k in port]
    for t in threads:
        t.start()
    try:
        want = jax_steps(uv, STEPS)
    finally:
        for t in threads:
            t.join()
    return uv, want, port


def port_model(uv, kernels: bool, dtype=torch.float64):
    model = UNetTaskAligWeight(1, img_size=S, kernels=kernels).to(dtype)
    model.load_state_dict(unet_from_jax(uv))
    return model.train()


def run_steps(model, imgs, labels, steps, after=lambda i: None, n_refine=2):
    """The port's train step `steps` times, calling after(i) past step i;
    returns each step's metrics and pass 0's gradients (flax layout), read
    at the first optimizer step."""
    state = seg.SegState(model, optim.make_adamw(model.parameters(), 1e-4))
    grads0 = {}

    def keep(opt, *_):
        if not grads0:
            sd = dict(model.state_dict())
            sd.update({k: p.grad for k, p in model.named_parameters()})
            grads0.update(flat(unet_to_jax(sd)["params"]))

    state.opt.register_step_pre_hook(keep)
    step = seg.make_seg_train_step(state, n_refine=n_refine)
    metrics = []
    for i in range(steps):
        metrics.append(step(imgs, labels))
        after(i)
    return metrics, grads0


def check_grads(got, want, rel):
    floor = 1e-12 * max(np.abs(v).max() for v in want.values())
    for k, r in want.items():
        peak = np.abs(r).max()
        if peak <= floor:   # zero analytically: rounding noise on both sides
            assert np.abs(got[k]).max() <= floor, k
            continue
        err = np.abs(got[k] - r).max()
        assert err <= rel * peak, f"{k}: max|diff| {err:.3e} > {rel} x {peak:.3e}"


@pytest.mark.parametrize("kernels", [False, True], ids=["stock-1step", "kernels-3steps"])
def test_steps_match_jax(ref, kernels):
    """pass 0's gradients, every step's losses, and the state after the
    first step and the last (one step with the kernels off, three with them
    on)."""
    _, want, port = ref
    got, steps = port[kernels], PORT_STEPS[kernels]
    check_grads(got["grads0"], want[0]["grads0"], 1e-4)
    assert len(got["losses"]) == steps
    for i, r in enumerate(want[:steps]):
        assert abs(got["losses"][i] - r["loss"]) <= 1e-9, i
        assert abs(got["seg_losses"][i] - 2 * r["loss"]) <= 2e-9, i
    check_state(got["states"][1], want[0], "step 1 ")
    check_state(got["states"][steps], want[steps - 1], f"step {steps} ")


def check_state(got, want, what=""):
    """got: a `snapshot`; want: a JAX step's params and batch_stats."""
    stats, params = got["batch_stats"], got["params"]
    for k, r in want["batch_stats"].items():
        err = np.abs(stats[k] - r).max()
        assert err <= 1e-4 * np.abs(r).max(), f"{what}{k}: {err:.3e}"
    for k, r in want["params"].items():
        assert np.abs(params[k] - r).max() <= 1e-6, f"{what}{k}"


def test_float32_kernel_step_tracks_the_reference(ref):
    uv, want, _ = ref
    imgs, labels = (torch.from_numpy(a).float() for a in batch())
    model = port_model(uv, kernels=True, dtype=torch.float32)
    (metrics,), grads0 = run_steps(model, imgs, labels, 1)
    assert abs(float(metrics["loss"]) - want[0]["loss"]) <= 1e-4
    ref0 = want[0]["grads0"]
    big = max(np.abs(v).max() for v in ref0.values())
    live = [k for k, v in ref0.items() if np.abs(v).max() > 1e-12 * big]
    l2 = lambda arrays: np.sqrt(sum(float((a * a).sum()) for a in arrays))
    assert l2(grads0[k] - ref0[k] for k in live) <= 0.05 * l2(ref0[k] for k in live)
