"""The port's two-stage pipeline and CLI against the JAX package's.

The JAX pipeline runs its accelerator graph on the CPU: the dense trunk with
the Pallas up1 tail (fused_up1, dense_fused_up1, dense_batch_min=1) in
interpret mode, once, from gray; that run is also the reference for the
port's entry points that start from preprocessed images (`infer_from_gray`
is the JAX package's preprocessing followed by `infer_from_rgb`'s graph).
Weights: seeded reference-named state dicts through the JAX
converter (test_torch_models.jax_variables), with the UNet head rescaled so
that the masks are neither empty nor full and no seg logit lies within 1e-3
of the 0 threshold (asserted), so masks, boxes and grades compare exactly.
Logits: rtol/atol 1e-3.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from PIL import Image

from test_torch_models import jax_variables, port_models
from unet_goolenet_tpu.models import GoogLeNetClassifier as JGNet
from unet_goolenet_tpu.models import UNetTaskAligWeight as JUNet
from unet_goolenet_tpu.ops import pallas as pk
from unet_goolenet_tpu.pipeline import TwoStagePipeline as JPipeline
from unet_goolenet_tpu_torch.apps import infer_e2e
from unet_goolenet_tpu_torch.pipeline import TwoStagePipeline, engine, preprocess_gray
from torch_threads import torch_threads  # noqa: F401  (autouse)

pk.interpret_mode(True)

S = 32
TOL = dict(rtol=1e-3, atol=1e-3)


@pytest.fixture(scope="module")
def pipes():
    gray = np.random.default_rng(21).uniform(0.0, 255.0, (2, 40, 48)).astype(np.float32)
    uv, gv = jax_variables(S, seed=11)
    unet, _ = port_models(uv, gv)
    with torch.no_grad():
        lg = engine.unet_forward(engine.fold_unet(unet),
                                 preprocess_gray(torch.from_numpy(gray), out_hw=(S, S)))
    # rescale the 1x1 head to a logit spread of ~1.5 and move the threshold to
    # the middle of the widest gap between neighbouring logits among the
    # 30%..90% quantiles, so no logit sits next to it
    v = np.sort(lg.numpy().ravel())
    mid = v[int(0.3 * v.size):int(0.9 * v.size)]
    i = int(np.argmax(np.diff(mid)))
    k = 1.5 / v.std()
    outc = uv["params"]["outc"]["conv"]
    outc["kernel"] = outc["kernel"] * k
    outc["bias"] = (outc["bias"] - 0.5 * (mid[i] + mid[i + 1])) * k
    unet, gnet = port_models(uv, gv)
    jpipe = JPipeline(JUNet(n_classes=1), jax.tree_util.tree_map(jnp.asarray, uv),
                      JGNet(num_classes=6), jax.tree_util.tree_map(jnp.asarray, gv),
                      img_size=S, fused_up1=True, dense_fused_up1=True, dense_batch_min=1)
    ref = {k: np.asarray(v) for k, v in jpipe.infer_from_gray(jnp.asarray(gray)).items()}
    return gray, TwoStagePipeline(unet, gnet, img_size=S, device="cpu"), ref


def test_infer_from_gray_matches_jax(pipes):
    gray, pipe, ref = pipes
    got = {k: v.numpy() for k, v in pipe.infer_from_gray(torch.from_numpy(gray)).items()}
    assert np.abs(ref["seg_logits"]).min() > 1e-3
    assert 0.05 < ref["masks"].mean() < 0.95
    np.testing.assert_allclose(got["seg_logits"], ref["seg_logits"], **TOL)
    np.testing.assert_allclose(got["cls_logits"], ref["cls_logits"], **TOL)
    for k in ("masks", "boxes", "grades"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    np.testing.assert_array_equal(pipe.infer_grades(torch.from_numpy(gray)).numpy(),
                                  ref["grades"])


def test_infer_from_rgb_and_masks_match_jax(pipes):
    gray, pipe, ref = pipes
    imgs = preprocess_gray(torch.from_numpy(gray), out_hw=(S, S)).numpy()
    got = pipe.infer_from_rgb(imgs)
    np.testing.assert_array_equal(got["masks"].numpy(), np.asarray(ref["masks"]))
    np.testing.assert_array_equal(got["grades"].numpy(), np.asarray(ref["grades"]))
    np.testing.assert_allclose(got["cls_logits"].numpy(), np.asarray(ref["cls_logits"]), **TOL)
    np.testing.assert_array_equal(pipe.infer_masks(imgs).numpy(), got["masks"].numpy())


def test_pipeline_runs_without_tf32(pipes, monkeypatch):
    """Each pipeline call runs its convs and matmuls with TF32 off (PyTorch's
    cuDNN default is on), and restores the caller's flags after."""
    gray, pipe, _ = pipes
    seen = []
    forward = engine.unet_forward

    def spy(P, x, **knobs):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        return forward(P, x, **knobs)

    monkeypatch.setattr(engine, "unet_forward", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    pipe.infer_grades(torch.from_numpy(gray))
    pipe.infer_masks(preprocess_gray(torch.from_numpy(gray), out_hw=(S, S)))
    assert seen == [(False, False)] * 2
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32


def write_fixture(tmp_path, pipe_models):
    """3 seeded gray PNGs of two native sizes and two reference-named
    checkpoints ({'net': ...} and bare)."""
    unet, gnet = pipe_models
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    rng = np.random.default_rng(33)
    for name, (h, w) in (("10.png", (35, 45)), ("2.png", (35, 45)), ("33.png", (30, 42))):
        Image.fromarray(rng.integers(0, 256, (h, w), dtype=np.uint8)).save(img_dir / name)
    torch.save({"net": unet.state_dict()}, tmp_path / "unet.pt")
    torch.save(gnet.state_dict(), tmp_path / "gnet.pt")
    return img_dir


def test_infer_e2e_cli_writes_result(tmp_path):
    uv, gv = jax_variables(S, seed=13)
    models = port_models(uv, gv)
    img_dir = write_fixture(tmp_path, models)
    out = infer_e2e.main(["--device", "cpu", "--image-dir", str(img_dir),
                          "--unet-checkpoint", str(tmp_path / "unet.pt"),
                          "--gnet-checkpoint", str(tmp_path / "gnet.pt"),
                          "--out-dir", str(tmp_path / "out"), "--img-size", str(S),
                          "--batch-size", "2"])
    lines = open(out).read().splitlines()
    pipe = TwoStagePipeline(*models, img_size=S, device="cpu")
    expected = []
    for stem in ("2", "10", "33"):
        gray = infer_e2e.read_gray(str(img_dir / f"{stem}.png")).astype(np.float32)
        expected.append(f"{stem} {int(pipe.infer_grades(torch.from_numpy(gray[None]))[0])}")
    assert lines == expected


def test_infer_e2e_cuda_without_device_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer_e2e.main(["--image-dir", str(tmp_path), "--unet-checkpoint", "u.pt",
                        "--gnet-checkpoint", "g.pt"])


def test_pipeline_defaults_to_cuda():
    """TwoStagePipeline runs on the card unless told otherwise: on a host
    without one, the default device raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    unet, gnet = port_models(*jax_variables(S, seed=11))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TwoStagePipeline(unet, gnet, img_size=S)
