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

from test_torch_models import centred_models, jax_variables
from unet_goolenet_tpu.data.datasets import _imread as jax_imread
from unet_goolenet_tpu.models import GoogLeNetClassifier as JGNet
from unet_goolenet_tpu.models import UNetTaskAligWeight as JUNet
from unet_goolenet_tpu.ops import pallas as pk
from unet_goolenet_tpu.pipeline import TwoStagePipeline as JPipeline
from unet_goolenet_tpu_torch.apps import infer_e2e
from unet_goolenet_tpu_torch.models import (
    GoogLeNetClassifier, UNetTaskAligWeight, load_reference_state_dict)
from unet_goolenet_tpu_torch.pipeline import TwoStagePipeline, engine, preprocess_gray
from unet_goolenet_tpu_torch.train.checkpoint import CheckpointManager
from unet_goolenet_tpu_torch.train.optim import make_adamw
from unet_goolenet_tpu_torch.train.seg import SegState
from torch_threads import torch_threads  # noqa: F401  (autouse)

pk.interpret_mode(True)

S = 32
TOL = dict(rtol=1e-3, atol=1e-3)


@pytest.fixture(scope="module")
def models():
    """Seeded JAX variables and the port's models with their weights, the
    UNet head rescaled on the test gray batch; shared by the pipeline and
    CLI tests."""
    gray = np.random.default_rng(21).uniform(0.0, 255.0, (2, 40, 48)).astype(np.float32)
    uv, gv = jax_variables(S, seed=11)
    return (gray, uv, gv, *centred_models(uv, gv, torch.from_numpy(gray)))


@pytest.fixture(scope="module")
def pipes(models):
    gray, uv, gv, unet, gnet = models
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
    """Seeded images of two native sizes: 3 gray PNGs, an RGB PNG and an RGB
    JPEG (whose gray images PIL's convert("L") and cv2 decode differently);
    and checkpoints with the reference's names: the UNet as the port's
    trainer saves it (CheckpointManager: {"model", "optimizer", "epoch"}),
    the classifier cut to 4 classes as {'net': ...} and bare. Returns the
    image directory, the UNet's snapshot and the 4-class classifier."""
    unet, gnet = pipe_models
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    rng = np.random.default_rng(33)
    for name, (h, w) in (("10.png", (35, 45)), ("2.png", (35, 45)), ("33.png", (30, 42))):
        Image.fromarray(rng.integers(0, 256, (h, w), dtype=np.uint8)).save(img_dir / name)
    Image.fromarray(rng.integers(0, 256, (35, 45, 3), dtype=np.uint8)).save(img_dir / "5.png")
    Image.fromarray(rng.integers(0, 256, (30, 42, 3), dtype=np.uint8)).save(img_dir / "7.jpg",
                                                                           quality=90)
    snapshot = CheckpointManager(str(tmp_path / "ckpt")).save_best_loss(
        SegState(unet, make_adamw(unet.parameters())), 3)
    gnet4 = GoogLeNetClassifier(4)
    gnet4.load_state_dict({k: v[:4] if k.startswith("googlenet.fc.") else v
                           for k, v in gnet.state_dict().items()})
    torch.save({"net": gnet4.state_dict()}, tmp_path / "gnet.pt")
    torch.save(gnet4.state_dict(), tmp_path / "gnet_bare.pt")
    return img_dir, snapshot, gnet4.eval()


def test_infer_e2e_cli_writes_result(tmp_path, models):
    """The CLI grades every image as the pipeline does, from the port
    trainer's own UNet snapshot and a 4-class classifier (--num-classes),
    with each image (gray, RGB PNG, JPEG) read exactly as the JAX app reads
    it; a bare state dict loads like the wrapped ones. The models are the
    pipeline tests' (written to checkpoints, so the CLI builds its own)."""
    unet, gnet = models[-2:]
    img_dir, snapshot, gnet4 = write_fixture(tmp_path, (unet, gnet))
    out = infer_e2e.main(["--device", "cpu", "--image-dir", str(img_dir),
                          "--unet-checkpoint", snapshot,
                          "--gnet-checkpoint", str(tmp_path / "gnet.pt"),
                          "--out-dir", str(tmp_path / "out"), "--img-size", str(S),
                          "--batch-size", "2", "--num-classes", "4"])
    lines = open(out).read().splitlines()
    pipe = TwoStagePipeline(unet, gnet4, img_size=S, device="cpu")
    expected = []
    for name in ("2.png", "5.png", "7.jpg", "10.png", "33.png"):
        gray = infer_e2e.read_gray(str(img_dir / name))
        np.testing.assert_array_equal(gray, jax_imread(str(img_dir / name), True), err_msg=name)
        grade = int(pipe.infer_grades(torch.from_numpy(gray[None].astype(np.float32)))[0])
        expected.append(f"{name.replace('.png', '')} {grade}")
    assert lines == expected
    bare = load_reference_state_dict(str(tmp_path / "gnet_bare.pt"), GoogLeNetClassifier(4))
    for k, v in bare.state_dict().items():
        torch.testing.assert_close(v, gnet4.state_dict()[k], rtol=0, atol=0)


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
    unet, gnet = UNetTaskAligWeight(1, img_size=S).eval(), GoogLeNetClassifier(6).eval()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TwoStagePipeline(unet, gnet, img_size=S)
