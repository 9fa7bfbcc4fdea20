"""The port's models and BN-folded engine against the JAX package's.

Weights are seeded random values under the reference's torch names with
non-trivial BatchNorm statistics, built into JAX variables by the JAX
package's converter and carried over to the port with `unet_from_jax` /
`gnet_from_jax`; inputs come from numpy seeds. Tolerance rtol 2e-3, atol 2e-4,
as in tests/test_engine.py. The JAX engine's up1 tail runs its Pallas kernels
in interpret mode.
"""

import copy
from functools import partial

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from unet_goolenet_tpu.models import GoogLeNetClassifier as JGNet
from unet_goolenet_tpu.models import UNetTaskAligWeight as JUNet
from unet_goolenet_tpu.ops import pallas as pk
from unet_goolenet_tpu.pipeline import engine as jengine
from unet_goolenet_tpu_torch.models import (
    GoogLeNetClassifier, UNetTaskAligWeight, gnet_from_jax, load_reference_state_dict,
    unet_from_jax)
from unet_goolenet_tpu_torch.pipeline import engine, preprocess_gray
from torch_threads import torch_threads  # noqa: F401  (autouse)

pk.interpret_mode(True)

TOL = dict(rtol=2e-3, atol=2e-4)
S = 32


def jax_variables(img_size=S, seed=7):
    """Seeded random UNet and GoogLeNet weights under the reference's torch
    names (non-trivial BN statistics), built into JAX variables by the JAX
    package's converter; returned as numpy trees."""
    from test_convert import synth_googlenet_state_dict, synth_unet_state_dict
    from test_torch_parity import randomize_state_dict
    from unet_goolenet_tpu.models.convert import (
        convert_googlenet_classifier, convert_unet_task_alig_weight)

    sd = synth_unet_state_dict()
    p = img_size // 16
    for k in ("task2.pos_embedding_decoder_cl", "task2.pos_embedding_decoder_seg"):
        sd[k] = np.zeros((1, 512, p, p), np.float32)
    params, stats, _ = convert_unet_task_alig_weight(randomize_state_dict(sd, seed))
    uv = {"params": params, "batch_stats": stats}
    params, stats, _ = convert_googlenet_classifier(
        randomize_state_dict(synth_googlenet_state_dict(), seed + 1))
    return uv, {"params": params, "batch_stats": stats}


def port_models(uv, gv, img_size=S):
    """The port's models with the JAX variables' weights."""
    unet = UNetTaskAligWeight(1, img_size=img_size)
    unet.load_state_dict(unet_from_jax(uv))
    gnet = GoogLeNetClassifier(6)
    gnet.load_state_dict(gnet_from_jax(gv))
    return unet.eval(), gnet.eval()


def centred_models(uv, gv, gray, img_size=S):
    """The port's models with the JAX variables' weights, after rescaling
    the UNet's 1x1 head (in uv too) to a logit spread of ~1.5 and moving
    the threshold into the widest gap between neighbouring logits among the
    30%..90% quantiles on the gray batch, so that no logit sits next to it
    and the masks are neither empty nor full."""
    unet, gnet = port_models(uv, gv, img_size)
    with torch.no_grad():
        lg = engine.unet_forward(engine.fold_unet(unet),
                                 preprocess_gray(gray, out_hw=(img_size, img_size)))
    v = np.sort(lg.numpy().ravel())
    mid = v[int(0.3 * v.size):int(0.9 * v.size)]
    i = int(np.argmax(np.diff(mid)))
    k = 1.5 / v.std()
    outc = uv["params"]["outc"]["conv"]
    outc["kernel"] = outc["kernel"] * k
    outc["bias"] = (outc["bias"] - 0.5 * (mid[i] + mid[i + 1])) * k
    unet.load_state_dict(unet_from_jax(uv))
    return unet, gnet


@pytest.fixture(scope="module")
def setup():
    x = np.random.default_rng(5).uniform(0.0, 1.0, (2, S, S, 3)).astype(np.float32)
    uv, gv = jax_variables()
    unet, gnet = port_models(uv, gv)
    return x, JUNet(n_classes=1), uv, JGNet(num_classes=6), gv, unet, gnet


_APPLY = {}


def apply_fn(model):
    """A jitted eval-mode apply, one per model configuration, so that calls
    with the same shapes reuse one compile."""
    key = repr(model)
    if key not in _APPLY:
        _APPLY[key] = jax.jit(lambda v, x: model.apply(v, x, train=False))
    return _APPLY[key]


def test_unet_module_matches_flax_apply(setup):
    x, ju, uv, *_ , unet, _ = setup
    ref = np.asarray(apply_fn(ju)(uv, jnp.asarray(x)))
    with torch.no_grad():
        got = unet(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, S, S, 1)
    np.testing.assert_allclose(got, ref, **TOL)


def test_gnet_module_matches_flax_apply(setup):
    x, _, _, jg, gv, _, gnet = setup
    ref = np.asarray(apply_fn(jg)(gv, jnp.asarray(x)))
    with torch.no_grad():
        got = gnet(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_unet_engine_matches_jax_fused_engine(setup):
    """Port engine (kernel path; plain versions on CPU) vs the JAX engine's
    hybrid forward with the Pallas up1 tail; the port's plain-ops up1
    composition (up1_plain) against the JAX dense forward."""
    x, _, uv, *_, unet, _ = setup
    P = engine.fold_unet(unet)
    with torch.no_grad():
        fused = engine.unet_forward(P, torch.from_numpy(x)).numpy()
        plain = engine.up1_plain(P, *engine.unet_trunk(P, torch.from_numpy(x))).numpy()
    ref = np.asarray(jax.jit(partial(jengine.unet_forward, fused_up1=True))(uv, jnp.asarray(x)))
    np.testing.assert_allclose(fused, ref, **TOL)
    ref_dense = np.asarray(jax.jit(jengine.unet_forward)(uv, jnp.asarray(x)))
    np.testing.assert_allclose(plain, ref_dense, **TOL)


def test_gnet_engine_matches_jax_engine(setup):
    x, _, _, _, gv, _, gnet = setup
    with torch.no_grad():
        got = engine.gnet_forward(engine.fold_gnet(gnet), torch.from_numpy(x)).numpy()
    ref = np.asarray(jax.jit(jengine.gnet_forward)(gv, jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, **TOL)


def test_bf16_engine_tracks_f32(setup):
    x, *_, unet, gnet = setup
    xt = torch.from_numpy(x)
    with torch.no_grad():
        ref = engine.unet_forward(engine.fold_unet(unet), xt)
        got = engine.unet_forward(engine.fold_unet(unet, torch.bfloat16), xt.bfloat16())
        gref = engine.gnet_forward(engine.fold_gnet(gnet), xt)
        ggot = engine.gnet_forward(engine.fold_gnet(gnet, torch.bfloat16), xt.bfloat16())
    assert got.dtype == ggot.dtype == torch.bfloat16
    for a, b in ((got, ref), (ggot, gref)):
        scale = b.abs().max().item()
        assert (a.float() - b).abs().max().item() <= 0.1 * scale


def test_load_reference_state_dict_drops_dead_keys(tmp_path):
    """A reference-named checkpoint with the dead fc1/fc2, deformabel and
    cross_attention_seg keys loads strictly into the port; its logits match
    the JAX converter's flax model on the same file's weights."""
    from test_convert import synth_googlenet_state_dict, synth_unet_state_dict
    from test_torch_parity import randomize_state_dict
    from unet_goolenet_tpu.models.convert import (
        as_variables, convert_googlenet_classifier, convert_unet_task_alig_weight)

    sd = randomize_state_dict(synth_unet_state_dict(), seed=3)
    assert any("deformabel" in k for k in sd) and "fc1.weight" in sd
    assert any("cross_attention_seg" in k for k in sd)
    path = tmp_path / "unet.pt"
    # the reference's 224^2 checkpoint into the default model: names and shapes
    torch.save({"net": {k: torch.as_tensor(v) for k, v in sd.items()}, "epoch": 3}, path)
    full = load_reference_state_dict(str(path), UNetTaskAligWeight(1)).state_dict()
    for k, v in full.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(sd[k]), err_msg=k)
    del full
    for k in ("task2.pos_embedding_decoder_cl", "task2.pos_embedding_decoder_seg"):
        assert sd[k].shape == (1, 512, 14, 14)   # the reference's 224^2 size
        sd[k] = sd[k][:, :, :S // 16, :S // 16]   # cut to the bottleneck of S x S
    torch.save({"net": {k: torch.as_tensor(v) for k, v in sd.items()}, "epoch": 3}, path)
    unet = load_reference_state_dict(str(path), UNetTaskAligWeight(1, img_size=S)).eval()
    for k, v in unet.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(sd[k]))
    x = np.random.default_rng(9).uniform(0.0, 1.0, (2, S, S, 3)).astype(np.float32)
    params, stats, _ = convert_unet_task_alig_weight(sd)
    ref = np.asarray(apply_fn(JUNet(n_classes=1))(as_variables(params, stats), jnp.asarray(x)))
    with torch.no_grad():
        got = unet(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)

    gsd = randomize_state_dict(synth_googlenet_state_dict(), seed=4)
    gpath = tmp_path / "gnet.pt"
    torch.save({k: torch.as_tensor(v) for k, v in gsd.items()}, gpath)    # bare form
    gnet = load_reference_state_dict(str(gpath), GoogLeNetClassifier(6)).eval()
    params, stats, _ = convert_googlenet_classifier(gsd)
    xg = x
    gref = np.asarray(apply_fn(JGNet(num_classes=6))(as_variables(params, stats),
                                                     jnp.asarray(xg)))
    with torch.no_grad():
        ggot = gnet(torch.from_numpy(np.ascontiguousarray(xg))).numpy()
    np.testing.assert_allclose(ggot, gref, rtol=1e-4, atol=1e-4)


def test_gnet_train_mode_matches_flax(setup):
    """One train-mode forward: BatchNorm normalises with the batch statistics
    and advances the running ones by flax's rule (momentum 0.9, biased
    variance, eps 1e-3), as the JAX classifier trains. The JAX side is the
    classifier's trunk (`googlenet`) with dropout 0, on its variables; aux
    heads are off in both. Both run in float64: at 32^2 the last levels are
    1x1, so batch statistics come from two values each, and float32
    rounding of the convs, through the fast variance E[y^2] - E[y]^2, moves
    the logits by ~1e-2. Logits and every running mean and variance at
    1e-4."""
    from unet_goolenet_tpu.models.googlenet import GoogLeNet as JTrunk

    x, _, _, _, gv, _, gnet = setup
    with jax.enable_x64(True):
        trunk = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                       {k: gv[k]["googlenet"] for k in ("params", "batch_stats")})
        model = JTrunk(num_classes=6, dropout=0.0, dtype=jnp.float64)
        ref, new = jax.jit(lambda v, a: model.apply(v, a, train=True, mutable=["batch_stats"]))(
            trunk, jnp.asarray(x, jnp.float64))
        ref, new = np.asarray(ref), jax.tree_util.tree_map(np.asarray, new["batch_stats"])
    stats = gnet_from_jax({"params": gv["params"], "batch_stats": {"googlenet": new}})
    net = copy.deepcopy(gnet).double().train()
    net.googlenet.dropout.p = 0.0
    with torch.no_grad():
        got = net(torch.from_numpy(x).double()).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    ran = [k for k in stats if k.endswith(("running_mean", "running_var"))]
    assert len(ran) == 2 * 57
    for k in ran:
        np.testing.assert_allclose(net.state_dict()[k].numpy(), stats[k].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
