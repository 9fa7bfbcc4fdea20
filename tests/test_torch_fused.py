"""The port's all-fused UNet configuration against the JAX package's.

With `fused_down1`, `fused_up34` and `fused_up2` on, the port's engine runs
pool + down1, up4-up2 and up1 through its kernels (plain versions on the
CPU); the JAX side runs `unet_forward_packed` with all four fused levels, in
Pallas interpret mode, through its own entry points: `apps.train_cls`'s
`make_roi_extractor(engine=True, fused=True)` and `TwoStagePipeline` with
every fused knob on, once each in a module fixture that every test shares.
The model is the full-width flagship at 32x32, where every fused level of
the JAX engine has a tile (asserted), so that no level quietly takes its
XLA path. Weights: seeded reference-named state dicts
through the JAX converter, with the UNet head rescaled so that no seg logit
lies near the mask threshold (as in test_torch_pipeline.py), so masks, boxes
and grades compare exactly. Tolerances: the UNet logits 1e-4 (float32, only
summation order differs); the pipeline's and extractor's outputs 1e-3, as
in test_torch_pipeline.py.
"""

import threading

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from test_torch_models import centred_models, jax_variables
from unet_goolenet_tpu.models import GoogLeNetClassifier as JGNet
from unet_goolenet_tpu.models import UNetTaskAligWeight as JUNet
from unet_goolenet_tpu.ops import pallas as pk
from unet_goolenet_tpu.pipeline import TwoStagePipeline as JPipeline
from unet_goolenet_tpu_torch.apps.train_cls import make_roi_extractor
from unet_goolenet_tpu_torch.pipeline import TwoStagePipeline, engine, preprocess_gray
from torch_threads import torch_threads  # noqa: F401  (autouse)

pk.interpret_mode(True)

S = 32
UNET_TOL = dict(rtol=1e-4, atol=1e-4)
TOL = dict(rtol=1e-3, atol=1e-3)
KNOBS = dict(fused_up2=True, fused_up34=True, fused_down1=True)


@pytest.fixture(scope="module")
def fused():
    """Port models, inputs, and the JAX extractor's and pipeline's outputs
    with every fused level on."""
    from unet_goolenet_tpu.apps.train_cls import make_roi_extractor as jax_extractor
    from unet_goolenet_tpu.ops.pallas.down1 import down1_supported
    from unet_goolenet_tpu.ops.pallas.up1 import up1_supported
    from unet_goolenet_tpu.ops.pallas.up2 import up_level_supported

    assert down1_supported(S // 2) and up1_supported(S)
    assert all(up_level_supported(h) for h in (S // 8, S // 4, S // 2))
    gray = torch.from_numpy(
        np.random.default_rng(23).uniform(0.0, 255.0, (2, 40, 48)).astype(np.float32))
    uv, gv = jax_variables(S, seed=17)
    unet, gnet = centred_models(uv, gv, gray)
    imgs = preprocess_gray(gray, out_hw=(S, S))
    juv = jax.tree_util.tree_map(jnp.asarray, uv)
    extract = jax_extractor(JUNet(n_classes=1), juv, S, engine=True, fused=True)
    jpipe = JPipeline(JUNet(n_classes=1), juv, JGNet(num_classes=6),
                      jax.tree_util.tree_map(jnp.asarray, gv), img_size=S, fused_up1=True,
                      **KNOBS)
    # the extractor's trace and compile overlap the pipeline's in a thread
    got = {}
    thread = threading.Thread(
        target=lambda: got.update(extractor=extract(jnp.asarray(imgs.numpy()))))
    thread.start()
    try:
        jout = jpipe.infer_from_gray(jnp.asarray(gray.numpy()))
    finally:
        thread.join()
    jout = {k: np.asarray(v) for k, v in jout.items()}
    jcrops, jlogits = got["extractor"]
    return {"gray": gray, "imgs": imgs, "unet": unet, "gnet": gnet,
            "jcrops": np.asarray(jcrops), "jlogits": np.asarray(jlogits), "jout": jout}


def test_unet_forward_all_fused_matches_jax(fused):
    """The slice: port unet_forward with its three knobs against JAX
    unet_forward_packed with all four fused levels."""
    P = engine.fold_unet(fused["unet"], **KNOBS)
    with torch.no_grad():
        got = engine.unet_forward(P, fused["imgs"], **KNOBS).numpy()
    assert got.shape == fused["jlogits"].shape == (2, S, S, 1)
    np.testing.assert_allclose(got, fused["jlogits"], **UNET_TOL)


@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_each_knob_matches_the_plain_composition(fused, knob):
    """Each knob alone against the all-plain graph (unet_trunk + up1_plain),
    the composition chip_smoke.py holds the kernels against."""
    P = engine.fold_unet(fused["unet"], **{knob: True})
    with torch.no_grad():
        got = engine.unet_forward(P, fused["imgs"], **{knob: True})
        ref = engine.up1_plain(P, *engine.unet_trunk(P, fused["imgs"]))
    torch.testing.assert_close(got, ref, **UNET_TOL)


def test_fold_unet_lays_out_only_the_levels_whose_knob_is_on(fused):
    """The default configuration keeps no dense-level kernel weights, a knob
    whose weights were not laid out raises, and on the CPU only the plain
    versions' weights are kept."""
    P = engine.fold_unet(fused["unet"])
    assert P["up_kernels"] == {} and "down1_kernels" not in P
    for knob in sorted(KNOBS):
        with pytest.raises(ValueError, match=f"fold_unet\\(\\.\\.\\., {knob}=True\\)"):
            engine.unet_forward(P, fused["imgs"], **{knob: True})
    P = engine.fold_unet(fused["unet"], fused_up34=True)
    assert sorted(P["up_kernels"]) == ["up3", "up4"] and "down1_kernels" not in P
    for kw in (*P["up_kernels"]["up3"], *P["up1_kernels"]):
        assert kw.plain and not kw.kernel


def test_roi_extractor_matches_jax(fused):
    crops, logits = make_roi_extractor(fused["unet"], S, fused=True, device="cpu")(
        fused["imgs"])
    assert np.abs(fused["jlogits"]).min() > 1e-3
    np.testing.assert_allclose(logits.numpy(), fused["jlogits"], **TOL)
    np.testing.assert_allclose(crops.numpy(), fused["jcrops"], **TOL)


def test_roi_extractor_module_forward_matches_engine(fused):
    """engine=False runs the nn.Module forward: same crops and logits as the
    engine forward, to the engine tests' float32 tolerance."""
    got = make_roi_extractor(fused["unet"], S, engine=False, device="cpu")(fused["imgs"])
    ref = make_roi_extractor(fused["unet"], S, device="cpu")(fused["imgs"])
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=2e-3, atol=2e-4)


def test_pipeline_all_fused_matches_jax(fused):
    pipe = TwoStagePipeline(fused["unet"], fused["gnet"], img_size=S, device="cpu", **KNOBS)
    got = {k: v.numpy() for k, v in pipe.infer_from_gray(fused["gray"]).items()}
    ref = fused["jout"]
    assert np.abs(ref["seg_logits"]).min() > 1e-3
    assert 0.05 < ref["masks"].mean() < 0.95
    np.testing.assert_allclose(got["seg_logits"], ref["seg_logits"], **TOL)
    np.testing.assert_allclose(got["cls_logits"], ref["cls_logits"], **TOL)
    for k in ("masks", "boxes", "grades"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_odd_img_size_with_a_knob_raises(fused):
    """The kernels take even level sizes; a knob that is on never falls back
    to a plain path, so an odd size is refused up front."""
    for knob in sorted(KNOBS):
        with pytest.raises(ValueError, match="even img_size"):
            TwoStagePipeline(fused["unet"], fused["gnet"], img_size=S + 1, device="cpu",
                             **{knob: True})
    with pytest.raises(ValueError, match="even img_size"):
        make_roi_extractor(fused["unet"], S + 1, fused=True, device="cpu")
