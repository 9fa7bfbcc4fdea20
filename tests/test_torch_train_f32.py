"""The port's float32 train step against the JAX package's own float32
`make_seg_train_step(forward="flax")`, unpatched, with its own
`dc_and_bce_loss`: the full-width UNetTaskAligWeight at 32x32, batch 2,
AdamW at lr 1e-4, from the weights and batch of test_torch_train_step.py,
with the kernels off and on (on the CPU the kernels' plain versions and
their backward composition). Both steps run one pass (n_refine=1): pass 0,
whose loss and gradients a float32 comparison can hold; the second pass
starts from AdamW's sign-like first update, and test_torch_train_step.py
holds it in float64.

This configuration is ill-conditioned in float32 (test_torch_train_step.py
says why), so two float32 implementations are as far apart as either is
from float64, and the tolerances are set from the JAX package's own
float32-against-float64 readings on these weights and this batch. As the
L2 norm of a leaf's difference over the leaf's L2 norm, JAX's float32 pass-0
gradients lie 2.9% (median over the 135 leaves that are not zero
analytically) and at most 4.1% from its float64 ones; the port's float32
ones lie 1.3% / 1.9% from JAX's float64 and 3.1% / 4.5% from JAX's float32.
A leaf computed wrongly is off by about 1. Tolerances:
  * pass 0's loss: 1e-4 absolute (the port's reads 4.8e-7 from JAX's
    float32);
  * each live leaf of pass 0's gradients: 0.1 (about twice the worst of the
    readings above);
  * the 34 leaves that are zero analytically (conv biases ahead of
    train-mode BatchNorm: below 1e-12 of the largest gradient in float64;
    in JAX's float32 step at most 2.5e-6 of it, where the smallest live
    leaf reaches 4.9e-4, so the split is taken at 1e-4): below 1e-5 of the
    largest gradient on the port's side (it reads 4e-7).
"""

import threading

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

from test_torch_train_step import batch, flat, keep_first_grads, port_model, run_steps, weights
from torch_threads import torch_threads  # noqa: F401  (autouse)


def jax_step(uv) -> dict:
    """Pass 0 of the float32 JAX train step: its loss and gradients
    (flattened)."""
    from unet_goolenet_tpu.models import UNetTaskAligWeight as JUNet
    from unet_goolenet_tpu.train import optim as joptim
    from unet_goolenet_tpu.train.seg import TrainState, make_seg_train_step

    x, y = (jnp.asarray(a, jnp.float32) for a in batch())
    v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), uv)
    tx = optax.chain(keep_first_grads(), joptim.make_adamw(1e-4))
    state = TrainState(v["params"], v["batch_stats"], tx.init(v["params"]))
    step = make_seg_train_step(JUNet(n_classes=1), tx, n_refine=1, forward="flax")
    state, metrics = jax.jit(step)(state, x, y)
    return {"loss0": float(metrics["loss"]), "grads0": flat(state.opt_state[0]["g0"])}


def port_step(uv, kernels: bool) -> dict:
    imgs, labels = (torch.from_numpy(a).float() for a in batch())
    model = port_model(uv, kernels, torch.float32)
    (metrics,), grads0 = run_steps(model, imgs, labels, 1, n_refine=1)
    return {"loss0": float(metrics["loss"]), "grads0": grads0}


@pytest.fixture(scope="module")
def ref():
    """JAX's float32 step and the port's with the kernels off and on; the
    port's runs go in threads beside JAX's."""
    uv = weights()
    port = {False: {}, True: {}}
    threads = [threading.Thread(target=lambda k=k: port[k].update(port_step(uv, k)))
               for k in port]
    for t in threads:
        t.start()
    try:
        want = jax_step(uv)
    finally:
        for t in threads:
            t.join()
    return want, port


@pytest.mark.parametrize("kernels", [False, True], ids=["stock", "kernels"])
def test_float32_step_matches_jax_float32(ref, kernels):
    want, port = ref
    got = port[kernels]
    assert abs(got["loss0"] - want["loss0"]) <= 1e-4
    ref0 = want["grads0"]
    big = max(np.abs(v).max() for v in ref0.values())
    zero = [k for k, v in ref0.items() if np.abs(v).max() <= 1e-4 * big]
    assert len(zero) == 34
    for k, r in ref0.items():
        if k in zero:
            assert np.abs(got["grads0"][k]).max() <= 1e-5 * big, k
            continue
        err = np.linalg.norm(got["grads0"][k] - r) / np.linalg.norm(r)
        assert err <= 0.1, f"{k}: {err:.3e}"
