"""The port's stage-2 data, metrics and CLI against the JAX package: the
device augment (`data/augment_device.py`), `ClsDataset`, the classification
metrics, and `apps.train_cls` on the CPU.

The device augment draws with threefry in JAX and with torch's generator
in the port, so the two cannot draw alike. The test replays
`_augment_one`'s draws for JAX's key (the batch key split per image, each
image's key split in 20, the same calls) and hands them to the port's
`apply`; the output is compared with `make_device_augment(cfg)(key, imgs)`,
for `AugmentConfig.cls_train(32)` and for the same config with every
probability 1 (masks too). Where only smooth ops ran (gamma, flips, the
bilinear crop, blur, contrast, jitter) the images agree to 1e-5; where a
nearest-sampled op ran (rotation, shear, the mask's crop), a pixel whose
source coordinate lies within rounding of a pixel edge can take its
neighbour, so at most 0.5% of pixels may differ by more than 1e-5 (they
read 0 here). The rotation is held to JAX's `rotate_nearest`, not to PIL,
from which the JAX function itself differs on up to 8% of pixels
(tests/test_augment_device.py:27).

ClsDataset items: 1e-6. Metrics, with absent classes and tied scores: the
confusion matrix exactly, the scores 1e-12.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from unet_goolenet_tpu_torch.data import ClsDataset
from unet_goolenet_tpu_torch.data import augment_device as ad
from unet_goolenet_tpu_torch.data.augment import AugmentConfig
from unet_goolenet_tpu_torch.eval import metrics
from torch_threads import torch_threads  # noqa: F401  (autouse)

S = 32


def forced(cfg: AugmentConfig) -> AugmentConfig:
    """cfg with every probability 1."""
    return AugmentConfig(**{**cfg.__dict__, **{k: 1.0 for k in cfg.__dict__
                                               if k.startswith("p_")}})


def jax_draws(cfg: AugmentConfig, key, n: int) -> dict:
    """The draws `_augment_one` makes for each image of a batch of n under
    `key`, as the port's `draw` names them."""
    out = {}
    for k in jax.random.split(key, n):
        keys = jax.random.split(k, 20)
        gate = lambda i, p: jax.random.uniform(keys[i]) < p
        u = lambda i, lo, hi: jax.random.uniform(keys[i], (), minval=lo, maxval=hi)
        scale = u(6, 1.0, 1.3)
        max_off = S - S / scale
        d = dict(gamma=jax.random.randint(keys[0], (), 10, 25).astype(jnp.float32) / 10.0,
                 gamma_on=gate(1, cfg.p_gama), hflip=gate(2, cfg.p_hflip),
                 vflip=gate(3, cfg.p_vflip), angle=u(4, -30.0, 30.0), rotate=gate(5, cfg.p_rota),
                 scale=scale, oy=jax.random.uniform(keys[7], ()) * max_off,
                 ox=jax.random.uniform(keys[8], ()) * max_off, crop=gate(9, cfg.p_scale),
                 sigma=jax.random.uniform(keys[10], ()), blur=gate(11, cfg.p_gaussn),
                 contrast=u(12, 0.8, 2.0), contrast_on=gate(13, cfg.p_contr),
                 shear=u(14, 5.0, 30.0), shear_on=gate(15, cfg.p_distor))
        b, c, sat, h = cfg.color_jitter
        d.update(jitter_brightness=u(16, max(0, 1 - b), 1 + b),
                 jitter_contrast=u(17, max(0, 1 - c), 1 + c),
                 jitter_saturation=u(18, max(0, 1 - sat), 1 + sat), jitter_hue=u(19, -h, h))
        for name, v in d.items():
            out.setdefault(name, []).append(np.asarray(v))
    return {name: torch.from_numpy(np.stack(v)) for name, v in out.items()}


@pytest.mark.parametrize("cfg", [AugmentConfig.cls_train(S), forced(AugmentConfig.cls_train(S))],
                         ids=["cls_train", "all-on-masks"])
def test_device_augment_on_jax_draws(cfg):
    from unet_goolenet_tpu.data.augment_device import make_device_augment

    n = 16
    rng = np.random.default_rng(6)
    imgs = rng.uniform(0, 1, (n, S, S, 3)).astype(np.float32)
    masks = (rng.uniform(0, 1, (n, S, S)) > 0.5).astype(np.int32)
    key = jax.random.PRNGKey(17)
    draws = jax_draws(cfg, key, n)
    assert set(draws) == set(ad.draw(cfg, n, torch.Generator().manual_seed(0)))
    with_mask = cfg.p_rota == 1.0
    if with_mask:
        want, want_m = make_device_augment(cfg, with_mask=True)(key, jnp.asarray(imgs),
                                                                jnp.asarray(masks))
        got, got_m = ad.apply(cfg, draws, torch.from_numpy(imgs), torch.from_numpy(masks))
        assert got_m.dtype == torch.int32
        assert (got_m.numpy() != np.asarray(want_m)).mean() <= 0.005
    else:
        want = make_device_augment(cfg)(key, jnp.asarray(imgs))
        got = ad.apply(cfg, draws, torch.from_numpy(imgs))
    want, got = np.asarray(want), got.numpy()
    assert got.shape == want.shape == (n, S, S, 3)
    off = np.abs(got - want).max(-1) > 1e-5          # (n, S, S)
    nearest = (draws["rotate"] | draws["shear_on"]).numpy()
    assert nearest.any() and not nearest.all() or with_mask
    assert not off[~nearest].any(), "an image of smooth ops only is off by more than 1e-5"
    assert off[nearest].mean() <= 0.005


def test_make_device_augment_draws_from_the_generator():
    """Same generator seed, same output; the draws cover their ranges."""
    cfg = AugmentConfig.cls_train(S)
    imgs = torch.rand((64, S, S, 3), generator=torch.Generator().manual_seed(1))
    run = ad.make_device_augment(cfg)
    a = run(torch.Generator().manual_seed(5), imgs)
    b = run(torch.Generator().manual_seed(5), imgs)
    assert torch.equal(a, b) and not torch.equal(a, imgs)
    assert a.min() >= 0 and a.max() <= 1
    p = ad.draw(cfg, 4096, torch.Generator().manual_seed(2))
    assert (p["gamma"] * 10).round().unique().tolist() == list(range(10, 25))
    assert -30 <= p["angle"].min() < -29 and 29 < p["angle"].max() <= 30
    assert abs(p["rotate"].float().mean().item() - cfg.p_rota) < 0.03
    assert (p["oy"] >= 0).all() and (p["oy"] <= S - S / p["scale"]).all()


def write_cls_set(root, splits=("ctrain", "cval"), n=4, hw=(40, 48), seed=11):
    """Seeded gray PNGs with labels/label.txt, laid out as
    tests/test_apps.py's stage-2 fixture."""
    rng = np.random.default_rng(seed)
    for split in splits:
        (root / split / "images").mkdir(parents=True)
        (root / split / "labels").mkdir(parents=True)
        lines = []
        for i in range(n):
            g = (rng.random(hw) * 255).astype(np.uint8)
            Image.fromarray(g).save(root / split / "images" / f"{i}.png")
            lines.append(f"{i}.png {i % 6}")
        (root / split / "labels" / "label.txt").write_text("\n".join(lines))


def test_cls_dataset_matches_jax(tmp_path):
    from unet_goolenet_tpu.data.datasets import ClsDataset as JCls

    write_cls_set(tmp_path)
    for train in (True, False):
        ours = ClsDataset(str(tmp_path / "ctrain"), img_size=S, train=train,
                          rng=np.random.default_rng(3))
        theirs = JCls(str(tmp_path / "ctrain"), img_size=S, train=train,
                      rng=np.random.default_rng(3))
        assert len(ours) == len(theirs) == 4 and ours.labels == theirs.labels == [0, 1, 2, 3]
        assert ours.roi_augment.cfg.__dict__ == theirs.roi_augment.cfg.__dict__
        for i in range(len(ours)):
            a, b = ours[i], theirs[i]
            assert a["name"] == b["name"] and a["cl_label"] == b["cl_label"]
            assert a["image"].shape == (S, S, 3) and a["image"].dtype == np.float32
            np.testing.assert_allclose(a["image"], b["image"], rtol=0, atol=1e-6)


def test_cls_metrics_match_jax():
    """Class 4 never occurs (absent from targets and predictions), class 5
    only as a prediction; scores tie within and across images; bf16 logits
    widen to float32."""
    from unet_goolenet_tpu.eval import metrics as jm

    rng = np.random.default_rng(12)
    labels = np.array([0, 0, 1, 1, 2, 2, 3, 3, 0, 1, 2, 3])
    logits = np.round(rng.normal(0, 1, (12, 6)), 1)   # rounding makes ties
    logits[3] = logits[2]
    logits[:, 4:] = -9.0
    logits[5, 5] = 9.0
    preds = logits.argmax(-1)
    cm = metrics.confusion_matrix(preds, labels, 6)
    np.testing.assert_array_equal(cm, jm.confusion_matrix(preds, labels, 6))
    assert cm[:, 4].sum() == cm[4].sum() == 0 and cm[:, 5].sum() == 1 and cm[5].sum() == 0
    for name in ("macro_f1", "macro_accuracy"):
        assert abs(getattr(metrics, name)(cm) - getattr(jm, name)(cm)) <= 1e-12, name
    assert abs(metrics.macro_auroc(logits, labels, 6)
               - jm.macro_auroc(logits, labels, 6)) <= 1e-12
    ours, theirs = metrics.ClsMetrics(6), jm.ClsMetrics(6)
    bf = torch.from_numpy(logits).to(torch.bfloat16)
    for sl in (slice(0, 5), slice(5, 12)):
        ours.update(bf[sl], torch.from_numpy(labels[sl]))
        theirs.update(jnp.asarray(bf[sl].float().numpy()), labels[sl])
    a, b = ours.aggregate(), theirs.aggregate()
    np.testing.assert_array_equal(a["confusion"], b["confusion"])
    for k in ("f1", "accuracy", "auroc"):
        assert abs(a[k] - b[k]) <= 1e-12, k


# ------------------------------------------------------------------ the CLI


@pytest.fixture(scope="module")
def cli_root(tmp_path_factory):
    """Two classification splits, and a train_seg snapshot of a fresh
    stage-1 model (the trainer's format: {'model', 'optimizer', 'epoch'}),
    removed at the end (the full-width UNet is ~140 MB)."""
    from unet_goolenet_tpu_torch.train.checkpoint import CheckpointManager
    from unet_goolenet_tpu_torch.train.seg import init_seg_state

    root = tmp_path_factory.mktemp("cls_cli")
    write_cls_set(root, n=6, hw=(60, 72))
    torch.manual_seed(3)
    state = init_seg_state(img_size=S, device="cpu")
    unet_pt = CheckpointManager(str(root / "seg")).save_best_loss(state, 4)
    yield root, unet_pt
    shutil.rmtree(root, ignore_errors=True)


def run_cli(root, unet_pt, name, *flags):
    from unet_goolenet_tpu_torch.apps import train_cls

    return train_cls.main(["--train-dir", str(root / "ctrain"), "--val-dir", str(root / "cval"),
                           "--unet-checkpoint", unet_pt, "--img-size", str(S),
                           "--batch-size", "4", "--device", "cpu",
                           "--save-dir", str(root / name), "--log-dir", str(root / "log"),
                           *flags])


@pytest.mark.parametrize("flags, resume", [
    (("--crop-augment", "device", "--aux-weight", "0.3"), True),
    (("--crop-augment", "none", "--device-epoch"), False),
], ids=["device-augment-aux", "no-augment-device-epoch"])
def test_train_cls_cli_trains_and_resumes(cli_root, flags, resume, capsys):
    """Two epochs on the CPU: checkpoints written (best loss, best
    accuracy, the every-10-epochs one at epoch 0) and restored into a fresh
    state (an aux-trained one also into a classifier without aux heads, as
    the serving entry points load it), the done: line; then, in one case, --resume from the best-loss
    checkpoint for one more epoch (each checkpoint of the classifier with
    its AdamW moments is 70-130 MB, so the other case leaves it out)."""
    from unet_goolenet_tpu_torch.models import GoogLeNetClassifier, load_reference_state_dict
    from unet_goolenet_tpu_torch.train.checkpoint import CheckpointManager
    from unet_goolenet_tpu_torch.train.cls import init_cls_state

    root, unet_pt = cli_root
    name = "ckpt_" + "_".join(f.strip("-") for f in flags)
    try:
        out = run_cli(root, unet_pt, name, "--epochs", "2", *flags)
        text = capsys.readouterr().out
        assert f"done: best_val_loss={out['best_val_loss']:.4f} best_acc=" in text
        assert text.count("[step ") == 2
        assert np.isfinite(out["best_val_loss"]) and 0 <= out["best_acc"] <= 1
        files = os.listdir(root / name)
        assert "model_epoch0.pt" in files and os.path.basename(out["best_loss_checkpoint"]) in files
        aux = "--aux-weight" in flags
        state = init_cls_state(6, aux_logits=aux, device="cpu")
        best = out["best_loss_checkpoint"]
        _, epoch = CheckpointManager(str(root / name)).restore(best, state)
        assert (state.model.googlenet.aux1 is not None) == aux
        saved = torch.load(best, weights_only=True)["model"]
        for k, v in state.model.state_dict().items():
            assert torch.equal(v, saved[k]), k
        if aux:   # served without its aux heads, as infer_e2e loads it
            gnet = load_reference_state_dict(best, GoogLeNetClassifier(6))
            assert not any(".aux" in k for k in gnet.state_dict())
            assert torch.equal(gnet.googlenet.fc.weight, saved["googlenet.fc.weight"])
        if resume:
            run_cli(root, unet_pt, name, "--epochs", str(epoch + 1), "--resume", best, *flags)
            text = capsys.readouterr().out
            assert f"resumed from {best} at epoch {epoch}" in text
            assert text.count("[step ") == 1 and f"[step {epoch}]" in text and "done:" in text
    finally:
        shutil.rmtree(root / name, ignore_errors=True)


def test_train_cls_cli_refusals(cli_root):
    from unet_goolenet_tpu_torch.apps import train_cls

    root, unet_pt = cli_root
    with pytest.raises(SystemExit, match="even --img-size"):
        run_cli(root, unet_pt, "odd", "--engine-roi", "on", "--img-size", "33")
    with pytest.raises(SystemExit, match="item 6"):
        run_cli(root, unet_pt, "dp", "--data-parallel")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_cls.main(["--train-dir", str(root / "ctrain"), "--val-dir",
                            str(root / "cval"), "--unet-checkpoint", unet_pt])
