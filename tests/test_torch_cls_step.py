"""The port's stage-2 train step, eval step and their parts against the JAX
package: `make_cls_train_step`, `make_cls_eval_step`, the aux heads'
`adaptive_avg_pool`, the classifier losses, and the epoch runner.

The weights are the port's default init from a seed (GoogLeNetClassifier,
6 classes, aux heads on where the case has them), carried to JAX by the JAX
package's own `convert_googlenet_classifier(aux=True)` and back by
`gnet_from_jax(aux=True)`.

The train step, as test_torch_train_step.py holds stage 1's: float64, 32^2,
batch 4, n_refine 2, AdamW at lr 1e-4, three steps, each setting of
`aux_weight` (0 and 0.3) one jitted JAX step shared by the module. At 32^2
the trunk's last levels are 1x1 and train-mode BatchNorm normalises over 4
values a channel, which amplifies float32 rounding beyond what two
implementations can be held to, so both sides run in float64: JAX under
`enable_x64` with the model in float64 and the classifier loss without its
float32 cast (patched in `unet_goolenet_tpu.train.cls` and `.losses`). The
JAX model's dropout rates are fixed in the model (0.2 on the main head, 0.7
in each aux head) and its masks come from threefry, which torch cannot
replay, so flax's `nn.Dropout` is patched to the identity for the JAX run
and the port's model is built with both rates at 0. Tolerances:
  * the losses of steps 1 and 2: 1e-9 absolute; of step 3: 1e-8. The
    step is chaotic at this size even in float64: multiplying the port's
    own weights by 1 +- 1e-15 moves its step-3 loss by 1.1e-9 to 2.9e-9
    (steps 1 and 2: below 2.2e-10), through the AdamW updates of elements
    whose gradient is near eps = 1e-8, so no two float64 implementations
    can agree at 1e-9 there;
  * pass 0's gradients: 1e-4 of each leaf's max |value|, aux leaves
    included;
  * batch statistics after steps 1 and 3: 1e-4 of each leaf's max |value|;
  * parameters after steps 1 and 3: 1e-6 absolute (1% of lr, which a
    flipped AdamW sign would break).
The eval step, float32 with non-trivial BatchNorm statistics: loss 1e-5,
logits 1e-4. The pool and the losses: 1e-6.
"""

import threading
from typing import Optional

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_train_step import check_grads, flat, keep_first_grads
from unet_goolenet_tpu_torch.models import GoogLeNetClassifier, gnet_from_jax
from unet_goolenet_tpu_torch.ops.pool import adaptive_avg_pool
from unet_goolenet_tpu_torch.train import losses, optim
from unet_goolenet_tpu_torch.train.cls import (
    ClsState, make_cls_eval_step, make_cls_train_step)
from unet_goolenet_tpu_torch.train.epoch import make_cls_epoch_runner
from torch_threads import torch_threads  # noqa: F401  (autouse)

S, N, STEPS, NCLS = 32, 4, 3, 6
AUX_WEIGHTS = (0.0, 0.3)
LOSS_TOL = (1e-9, 1e-9, 1e-8)   # by step (module docstring)


def to_jax(sd: dict, aux: bool) -> dict:
    """A port GoogLeNetClassifier state dict as JAX variables (numpy), by
    the JAX package's converter."""
    from unet_goolenet_tpu.models.convert import convert_googlenet_classifier

    params, stats, unused = convert_googlenet_classifier(
        {k: v.detach().cpu().double().numpy().copy() for k, v in sd.items()}, aux=aux)
    assert unused == set(), unused
    return {"params": params, "batch_stats": stats}


def weights(aux: bool) -> dict:
    torch.manual_seed(7)
    return to_jax(GoogLeNetClassifier(NCLS, aux_logits=aux).state_dict(), aux)


def batch():
    """Crops in [0, 1], one label a class but the last, and seg logits
    spread over +-6, so that the .long() cast truncates most of them to
    something other than 0."""
    rng = np.random.default_rng(3)
    crops = rng.uniform(0.0, 1.0, (N, S, S, 3))
    labels = np.array([0, 3, 5, 3])
    se_out = rng.normal(0.0, 3.0, (N, S, S, 1))
    return crops, labels, se_out


def ce64(logits, labels, weight=None):
    """unet_goolenet_tpu/train/losses.py:softmax_cross_entropy in the
    input's dtype (the package's version casts to float32)."""
    logp = jax.nn.log_softmax(logits, axis=-1)
    nll = -jnp.take_along_axis(logp, labels[..., None].astype(jnp.int32), axis=-1)[..., 0]
    return jnp.mean(nll)


class NoDropout(fnn.Module):
    """Stands in for flax's nn.Dropout in the JAX runs: the identity."""
    rate: float
    deterministic: Optional[bool] = None

    def __call__(self, x, deterministic=None, rng=None):
        return x


def jax_patched():
    """The patches of the JAX runs (module docstring): flax's Dropout as
    the identity, the classifier loss without its float32 cast."""
    import unet_goolenet_tpu.train.cls as jcls
    import unet_goolenet_tpu.train.losses as jlosses

    mp = pytest.MonkeyPatch()
    mp.setattr(fnn, "Dropout", NoDropout)
    mp.setattr(jcls, "softmax_cross_entropy", ce64)
    mp.setattr(jlosses, "softmax_cross_entropy", ce64)
    return mp


def jax_steps(variables, aux_weight: float, steps: int):
    """`steps` float64 JAX train steps from `variables` (under
    `jax_patched`): each step's loss, params and batch_stats (flattened),
    and pass 0's gradients."""
    from unet_goolenet_tpu.models import GoogLeNetClassifier as JGNet
    from unet_goolenet_tpu.train import optim as joptim
    from unet_goolenet_tpu.train.cls import make_cls_train_step as jax_train_step
    from unet_goolenet_tpu.train.seg import TrainState

    crops, labels, se_out = batch()
    out = []
    with jax.enable_x64(True):
        model = JGNet(num_classes=NCLS, aux_logits=aux_weight > 0, dtype=jnp.float64)
        tx = optax.chain(keep_first_grads(), joptim.make_adamw(1e-4))
        as64 = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)
        params = as64(variables["params"])
        state = TrainState(params, as64(variables["batch_stats"]), tx.init(params))
        # not donated: the states recorded are numpy views of its buffers
        step = jax.jit(jax_train_step(model, tx, aux_weight=aux_weight))
        args = (jnp.asarray(crops), jnp.asarray(labels), jnp.asarray(se_out),
                jax.random.PRNGKey(0))
        for _ in range(steps):
            state, metrics = step(state, *args)
            out.append({"loss": float(metrics["loss"]), "params": flat(state.params),
                        "batch_stats": flat(state.batch_stats)})
        out[0]["grads0"] = flat(state.opt_state[0]["g0"])
    return out


def port_model(variables, aux: bool, dtype=torch.float64, dropout: bool = False):
    """The port's classifier on `variables`, dropout at 0 unless `dropout`
    (then the model's rates: 0.2, and 0.7 in the aux heads)."""
    model = GoogLeNetClassifier(NCLS, aux_logits=aux)
    model.load_state_dict(gnet_from_jax(variables, aux=aux))
    if not dropout:
        no_dropout(model)
    return model.to(dtype).train()


def no_dropout(model):
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0


def snapshot(model, aux: bool) -> dict:
    v = to_jax(model.state_dict(), aux)
    return {"params": flat(v["params"]), "batch_stats": flat(v["batch_stats"])}


def run_steps(model, aux_weight, steps, inputs, after=lambda i: None, **kw):
    """The port's cls train step `steps` times (no generator: the test
    models have no dropout); returns each step's metrics and pass 0's
    gradients (flax layout), read at the first optimizer step."""
    state = ClsState(model, optim.make_adamw(model.parameters(), 1e-4))
    grads0 = {}

    def keep(opt, *_):
        if not grads0:
            sd = dict(model.state_dict())
            sd.update({k: p.grad for k, p in model.named_parameters()})
            grads0.update(flat(to_jax(sd, model.googlenet.aux1 is not None)["params"]))

    state.opt.register_step_pre_hook(keep)
    step = make_cls_train_step(state, aux_weight=aux_weight, **kw)
    metrics = []
    for i in range(steps):
        metrics.append(step(*inputs))
        after(i)
    return metrics, grads0


def port_run(variables, aux_weight: float) -> dict:
    aux = aux_weight > 0
    model = port_model(variables, aux)
    inputs = [torch.from_numpy(a) for a in batch()]
    states = {}
    metrics, grads0 = run_steps(
        model, aux_weight, STEPS, inputs,
        after=lambda i: i in (0, STEPS - 1) and states.__setitem__(i + 1, snapshot(model, aux)))
    return {"losses": [float(m["loss"]) for m in metrics], "grads0": grads0, "states": states}


@pytest.fixture(scope="module")
def ref():
    """For each aux_weight: the JAX steps and the port's from the same
    weights. The port's runs go in a thread beside JAX's, which run one
    after the other: each XLA compile already takes several cores, and two
    at once would crowd the other test workers."""
    variables = {w: weights(w > 0) for w in AUX_WEIGHTS}
    port = {}
    thread = threading.Thread(
        target=lambda: port.update({w: port_run(variables[w], w) for w in AUX_WEIGHTS}))
    thread.start()
    mp = jax_patched()
    try:
        want = {w: jax_steps(variables[w], w, STEPS) for w in AUX_WEIGHTS}
    finally:
        thread.join()
        mp.undo()
    assert set(port) == set(AUX_WEIGHTS), "a port run failed"
    return variables, want, port


def check_state(got, want, what=""):
    for k, r in want["batch_stats"].items():
        err = np.abs(got["batch_stats"][k] - r).max()
        assert err <= 1e-4 * np.abs(r).max(), f"{what}{k}: {err:.3e}"
    for k, r in want["params"].items():
        err = np.abs(got["params"][k] - r).max()
        assert err <= 1e-6, f"{what}{k}: {err:.3e}"


@pytest.mark.parametrize("aux_weight", AUX_WEIGHTS, ids=["main-head", "aux-0.3"])
def test_cls_steps_match_jax(ref, aux_weight):
    _, want, port = ref
    got, want = port[aux_weight], want[aux_weight]
    assert set(got["grads0"]) == set(want[0]["grads0"])
    assert any("aux1" in k for k in got["grads0"]) == (aux_weight > 0)
    check_grads(got["grads0"], want[0]["grads0"], 1e-4)
    for i, (r, tol) in enumerate(zip(want, LOSS_TOL)):
        assert abs(got["losses"][i] - r["loss"]) <= tol, i
    check_state(got["states"][1], want[0], "step 1 ")
    check_state(got["states"][STEPS], want[STEPS - 1], f"step {STEPS} ")


def test_long_cast_quirk():
    """se_out in (-1, 1): the .long() cast makes it 0, so pass 1 sees
    sigmoid(0) = 0.5 everywhere, whose confidence |0.5 - 0.5| * 2 is 0: the
    crops reach pass 1 unchanged. Without the quirk they do not; and with
    se_out spread wide, pass 1 sees crops + sigmoid(trunc(se_out)) * conf."""
    variables = weights(False)
    crops, labels, wide = (torch.from_numpy(a) for a in batch())
    small = torch.from_numpy(np.random.default_rng(4).uniform(-0.999, 0.999, (N, S, S, 1)))

    def pass_inputs(se_out, quirk):
        model = port_model(variables, aux=False)
        seen = []
        model.register_forward_pre_hook(lambda m, a: seen.append(a[0].clone()))
        run_steps(model, 0.0, 1, (crops, labels, se_out), long_cast_quirk=quirk)
        assert len(seen) == 2 and torch.equal(seen[0], crops)
        return seen[1]

    assert torch.equal(pass_inputs(small, True), crops)
    assert not torch.allclose(pass_inputs(small, False), crops)
    temp = torch.sigmoid(torch.trunc(wide))
    conf = ((0.5 - temp).abs() * 2.0).mean(dim=(1, 2, 3), keepdim=True)
    torch.testing.assert_close(pass_inputs(wide, True), crops + temp * conf, rtol=0, atol=1e-15)


def test_cls_eval_step_matches_jax():
    from unet_goolenet_tpu.models import GoogLeNetClassifier as JGNet
    from unet_goolenet_tpu.train.cls import make_cls_eval_step as jax_eval_step
    from unet_goolenet_tpu.train.seg import TrainState

    torch.manual_seed(11)
    model = GoogLeNetClassifier(NCLS)
    g = torch.Generator().manual_seed(12)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.randn(buf.shape, generator=g) * 0.2)
            elif name.endswith("running_var"):
                buf.copy_(torch.rand(buf.shape, generator=g) + 0.5)
    v = to_jax(model.state_dict(), False)
    crops, labels, _ = batch()
    crops = crops.astype(np.float32)
    step = jax.jit(jax_eval_step(JGNet(num_classes=NCLS)))
    jloss, jlogits = step(TrainState(v["params"], v["batch_stats"], None),
                          jnp.asarray(crops), jnp.asarray(labels))
    model.train()
    loss, logits = make_cls_eval_step(model)(torch.from_numpy(crops), torch.from_numpy(labels))
    assert model.training   # the eval step leaves the model's mode as it was
    assert logits.shape == (N, NCLS)
    assert abs(float(loss) - float(jloss)) <= 1e-5
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=1e-4)


@pytest.mark.parametrize("size", [14, 2, 8])
def test_adaptive_avg_pool_matches_jax(size):
    """The aux heads' pool to 4x4: 14 -> 4 (224^2, overlapping windows),
    2 -> 4 (32^2, repeated pixels), 8 -> 4 (an even split)."""
    from unet_goolenet_tpu.ops.pool import adaptive_avg_pool as jpool

    x = np.random.default_rng(size).standard_normal((2, size, size + 1, 5)).astype(np.float32)
    got = adaptive_avg_pool(torch.from_numpy(x), (4, 4)).numpy()
    want = np.asarray(jpool(jnp.asarray(x), (4, 4)))
    assert got.shape == want.shape == (2, 4, 4, 5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_cls_losses_match_jax():
    from unet_goolenet_tpu.train import losses as jl

    rng = np.random.default_rng(9)
    main, a1, a2 = (rng.standard_normal((7, NCLS)).astype(np.float32) * 3 for _ in range(3))
    labels = rng.integers(0, NCLS, 7)
    weight = rng.uniform(0.2, 2.0, NCLS).astype(np.float32)
    t, j = torch.from_numpy, jnp.asarray
    np.testing.assert_allclose(
        float(losses.softmax_cross_entropy(t(main), t(labels), t(weight))),
        float(jl.softmax_cross_entropy(j(main), j(labels), j(weight))), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        float(losses.aux_weighted_cross_entropy(t(main), [t(a1), None, t(a2)], t(labels),
                                                aux_weight=0.3)),
        float(jl.aux_weighted_cross_entropy(j(main), [j(a1), None, j(a2)], j(labels),
                                            aux_weight=0.3)), rtol=0, atol=1e-6)


def test_cls_epoch_runner_is_the_steps_in_order():
    """make_cls_epoch_runner against the same steps run by hand: the
    permutation drawn from the generator, the 5 crops cut to 2 batches of 2
    (drop-last), each step drawing its dropout masks (live, at the model's
    rates) from the generator in turn. Equal losses and parameters, bit for
    bit."""
    variables = weights(True)
    rng = np.random.default_rng(5)
    crops = torch.from_numpy(rng.uniform(0, 1, (5, S, S, 3))).float()
    labels = torch.from_numpy(rng.integers(0, NCLS, 5))
    se_out = torch.from_numpy(rng.normal(0, 3, (5, S, S, 1))).float()
    runs = []
    for by_hand in (False, True):
        model = port_model(variables, aux=True, dtype=torch.float32, dropout=True)
        state = ClsState(model, optim.make_adamw(model.parameters(), 1e-4))
        step = make_cls_train_step(state, aux_weight=0.3)
        g = torch.Generator().manual_seed(21)
        if by_hand:
            perm = torch.randperm(5, generator=g)[:4]
            loss = torch.stack([step(crops[i], labels[i], se_out[i], g)["loss"]
                                for i in (perm[:2], perm[2:])]).mean()
        else:
            loss = make_cls_epoch_runner(step, 2)(crops, labels, se_out, g)
        runs.append((float(loss), {k: v.clone() for k, v in model.state_dict().items()}))
    (loss_a, sd_a), (loss_b, sd_b) = runs
    assert loss_a == loss_b and np.isfinite(loss_a)
    for k in sd_a:
        assert torch.equal(sd_a[k], sd_b[k]), k
    with pytest.raises(ValueError, match="no batch"):
        make_cls_epoch_runner(step, 8)(crops, labels, se_out, g)
