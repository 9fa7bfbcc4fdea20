"""The rest of the port's stage-1 trainer against the JAX package: the eval
step, losses, optimizer, schedule, early stopping; and checkpoints and the
`apps.train_seg` CLI (the train step itself: test_torch_train_step.py); and
`apps.predict_seg`, whose masks are held to the same JAX eval step.

Tolerances:
  * the eval step against the JAX package's `make_seg_eval_step`, float32,
    with non-trivial BatchNorm statistics, kernels off and on: loss 1e-5,
    masks equal wherever |logit| > 1e-3;
  * losses against the JAX package's, float32: 1e-6; AdamW against optax's
    `make_adamw` over three steps, float64: 1e-12; the plateau schedule and
    early stopping: equal decisions, step by step.
"""

import copy
import os
import shutil

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from PIL import Image

from test_torch_train_step import S, batch
from unet_goolenet_tpu_torch.apps import train_seg
from unet_goolenet_tpu_torch.models import UNetTaskAligWeight, unet_from_jax, unet_to_jax
from unet_goolenet_tpu_torch.train import losses, optim, seg
from unet_goolenet_tpu_torch.train.checkpoint import CheckpointManager
from torch_threads import torch_threads  # noqa: F401  (autouse)

def port_model(uv, kernels):
    model = UNetTaskAligWeight(1, img_size=S, kernels=kernels)
    model.load_state_dict(unet_from_jax(uv))
    return model.train()


# ------------------------------------------------------------ eval step


_JAX = {}


def jax_eval():
    """The JAX eval step and eval-mode forward, jitted once for the module,
    so that each compiles once at the (N, S, S, 3) batches of its tests."""
    if not _JAX:
        from unet_goolenet_tpu.models import UNetTaskAligWeight as JUNet
        from unet_goolenet_tpu.train.seg import make_seg_eval_step

        jm = JUNet(n_classes=1)
        _JAX["step"] = jax.jit(make_seg_eval_step(jm))
        _JAX["apply"] = jax.jit(lambda v, x: jm.apply(v, x, train=False))
    return _JAX["step"], _JAX["apply"]


@pytest.fixture(scope="module")
def eval_ref():
    """Weights with non-trivial BatchNorm statistics, a batch, and the JAX
    eval step's loss, masks and logits on them."""
    from unet_goolenet_tpu.train.seg import TrainState

    torch.manual_seed(11)
    model = UNetTaskAligWeight(1, img_size=S)
    g = torch.Generator().manual_seed(12)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.randn(buf.shape, generator=g) * 0.2)
            elif name.endswith("running_var"):
                buf.copy_(torch.rand(buf.shape, generator=g) + 0.5)
    uv = unet_to_jax(model.state_dict())
    imgs, labels = (a.astype(np.float32) for a in batch())
    step, forward = jax_eval()
    state = TrainState(uv["params"], uv["batch_stats"], None)
    loss, masks = step(state, jnp.asarray(imgs), jnp.asarray(labels))
    logits = forward(uv, jnp.asarray(imgs))
    return uv, imgs, labels, float(loss), np.asarray(masks), np.asarray(logits)


@pytest.mark.parametrize("kernels", [False, True], ids=["stock", "kernels"])
def test_eval_step_matches_jax(eval_ref, kernels):
    uv, imgs, labels, jloss, jmasks, jlogits = eval_ref
    model = port_model(uv, kernels)
    loss, masks = seg.make_seg_eval_step(model)(torch.from_numpy(imgs), torch.from_numpy(labels))
    assert model.training   # the eval step leaves the model's mode as it was
    assert abs(float(loss) - jloss) <= 1e-5
    assert masks.shape == jmasks.shape == (2, S, S, 1)
    sure = np.abs(jlogits) > 1e-3
    assert sure.mean() > 0.9
    np.testing.assert_array_equal(masks.numpy()[sure], jmasks[sure])


def test_predict_seg_matches_jax_eval_step(tmp_path, eval_ref):
    """apps.predict_seg writes red-on-black PNGs that hold the masks of the
    JAX package's make_seg_eval_step, from the same weights (eval_ref's, as
    a reference `{'net': ...}` checkpoint) on the same two RGB PNGs of two
    sizes as the JAX ImageFolderDataset reads them (batches of 1), with the
    head centred on them: equal wherever |logit| > 1e-3, and an
    empty csv workbook where no xlsx engine imports."""
    from unet_goolenet_tpu.data.datasets import ImageFolderDataset as JFolder
    from unet_goolenet_tpu.train.seg import TrainState

    from unet_goolenet_tpu_torch.apps import predict_seg

    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    rng = np.random.default_rng(8)
    for name, hw in (("12.png", (35, 45)), ("4.png", (40, 30))):
        Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)).save(img_dir / name)
    ds = JFolder(str(img_dir), img_size=S, wavelet=False)
    imgs = jnp.asarray(np.stack([ds[i]["image"] for i in range(len(ds))]))
    step, forward = jax_eval()
    # the head rescaled to a logit spread of 1.5 around the median logit, so
    # that the masks are neither empty nor full and few logits lie next to
    # the threshold (test_torch_models.centred_models does the same)
    uv = copy.deepcopy(eval_ref[0])
    logits = np.asarray(forward(uv, imgs))
    k = 1.5 / logits.std()
    outc = uv["params"]["outc"]["conv"]
    outc["kernel"], outc["bias"] = outc["kernel"] * k, (outc["bias"] - np.median(logits)) * k
    torch.save({"net": port_model(uv, False).state_dict()}, tmp_path / "unet.pt")
    seg_dir = predict_seg.main(["--device", "cpu", "--image-dir", str(img_dir),
                                "--checkpoint", str(tmp_path / "unet.pt"), "--img-size", str(S),
                                "--out-dir", str(tmp_path / "out"), "--batch-size", "1"])
    _, masks = step(TrainState(uv["params"], uv["batch_stats"], None), imgs,
                    jnp.zeros(imgs.shape[:3] + (1,)))
    masks, logits = np.asarray(masks)[..., 0], np.asarray(forward(uv, imgs))[..., 0]
    assert sorted(os.listdir(seg_dir)) == sorted(ds.names)
    assert 0.05 < masks.mean() < 0.95
    for name, mask, logit in zip(ds.names, masks, logits):
        png = np.asarray(Image.open(os.path.join(seg_dir, name)))
        assert png.shape == (S, S, 3) and not png[..., 1:].any()
        assert set(np.unique(png[..., 0])) <= {0, 255}
        sure = np.abs(logit) > 1e-3
        assert sure.mean() > 0.9
        np.testing.assert_array_equal((png[..., 0] > 0)[sure], mask[sure] > 0, err_msg=name)
    assert (os.path.exists(tmp_path / "out" / "Classification_Results.xlsx")
            or open(tmp_path / "out" / "Classification_Results.csv").read() == "\n")


# ------------------------------------------------------------ losses, optimizer


def test_losses_match_jax():
    from unet_goolenet_tpu.train import losses as jl

    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((2, 12, 10, 1)) * 3).astype(np.float32)
    target = (rng.uniform(size=(2, 12, 10, 1)) > 0.5).astype(np.float32)
    t = lambda a: torch.from_numpy(a)
    for name in ("sigmoid_binary_cross_entropy", "soft_dice_loss", "dc_and_bce_loss"):
        got = getattr(losses, name)(t(logits), t(target)).numpy()
        want = np.asarray(getattr(jl, name)(jnp.asarray(logits), jnp.asarray(target)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=name)
    cls_logits = rng.standard_normal((7, 6)).astype(np.float32)
    cls_labels = rng.integers(0, 6, 7)
    np.testing.assert_allclose(
        float(losses.cross_entropy(t(cls_logits), t(cls_labels))),
        float(jl.cross_entropy(jnp.asarray(cls_logits), jnp.asarray(cls_labels))), rtol=1e-6)


def test_adamw_matches_optax():
    from unet_goolenet_tpu.train import optim as jo
    import optax

    rng = np.random.default_rng(5)
    shapes = {"a": (3, 4), "b": (5,)}
    params = {k: rng.standard_normal(s) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s) * 10.0 ** -i for k, s in shapes.items()}
             for i in range(3)]
    with jax.enable_x64(True):
        tx = jo.make_adamw(1e-2)
        jp = {k: jnp.asarray(v) for k, v in params.items()}
        st = tx.init(jp)
        for g in grads:
            upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
            jp = optax.apply_updates(jp, upd)
        want = {k: np.asarray(v) for k, v in jp.items()}
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = optim.make_adamw(tp.values(), 1e-2)
    for g in grads:
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k in shapes:
        np.testing.assert_allclose(tp[k].detach().numpy(), want[k], rtol=0, atol=1e-12)
    optim.set_learning_rate(opt, 3e-5)
    assert [grp["lr"] for grp in opt.param_groups] == [3e-5]


def test_plateau_and_early_stop_match_jax():
    from unet_goolenet_tpu.train import optim as jo

    rng = np.random.default_rng(6)
    # long flat stretches so that the lr is cut twice and floors at min_lr
    losses_ = np.concatenate([np.linspace(1.0, 0.5, 5), 0.5 + rng.uniform(0, 5e-4, 40)])
    st, jst = optim.plateau_init(1e-4), jo.plateau_init(1e-4)
    for v in losses_:
        st, jst = optim.plateau_step(st, v), jo.plateau_step(jst, jnp.float32(v))
        assert (st.lr, st.best, st.num_bad) == (float(jst.lr), float(jst.best), int(jst.num_bad))
    assert st.lr == float(np.float32(1e-5))
    stop, jstop = optim.EarlyStopper(patience=3, lr_threshold=1e-4, extension=2), \
        jo.EarlyStopper(patience=3, lr_threshold=1e-4, extension=2)
    vals = [1.0, 0.9, 0.95, 0.96, 0.97, 0.98, 0.99, 1.0, 1.1]
    lrs = [1e-4] * 6 + [1e-5] * 3
    got = [stop.update(v, lr) for v, lr in zip(vals, lrs)]
    assert got == [jstop.update(v, lr) for v, lr in zip(vals, lrs)]
    assert got[-1] and not any(got[:5])   # the extension held it at lr >= threshold


# ------------------------------------------------------------ checkpoints, CLI


def small_state(seed):
    """A SegState of a small model (the manager takes any), after one AdamW
    step so that the optimizer has moments."""
    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Conv2d(3, 8, 3), torch.nn.BatchNorm2d(8))
    state = seg.SegState(model, optim.make_adamw(model.parameters(), 1e-4))
    for p in model.parameters():
        p.grad = torch.randn_like(p)
    state.opt.step()
    return state


def test_checkpoint_retention_and_restore(tmp_path):
    state = small_state(0)
    mgr = CheckpointManager(str(tmp_path), periodic_every=2)
    first = mgr.save_best_loss(state, 0)
    second = mgr.save_best_loss(state, 3)
    metric = mgr.save_best_metric(state, 3)
    mgr.save_periodic(state, 1)
    periodic = mgr.save_periodic(state, 2)
    assert mgr.latest_best() == second
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "best_model_epoch3.pt", "best_seg_model_epoch3.pt", "model_epoch2.pt"]
    assert not (tmp_path / first).exists() and metric and periodic

    fresh = small_state(1)
    restored, epoch = mgr.restore(second, fresh)
    assert epoch == 3 and restored.model is fresh.model
    for (k, a), b in zip(state.model.state_dict().items(), restored.model.state_dict().values()):
        assert torch.equal(a, b), k
    sa, sb = state.opt.state_dict(), restored.opt.state_dict()
    for k in sa["state"]:
        for name in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa["state"][k][name], sb["state"][k][name])


def write_seg_set(root, counts):
    """Seeded PNG sets: a bright disc on noise, its mask as 0/255."""
    rng = np.random.default_rng(8)
    for split, n in counts.items():
        for d in ("images", "labels"):
            (root / split / d).mkdir(parents=True)
        for i in range(n):
            h, w = 40, 48
            yy, xx = np.mgrid[0:h, 0:w]
            m = (yy - h * rng.uniform(0.3, 0.7)) ** 2 + (xx - w * rng.uniform(0.3, 0.7)) ** 2 \
                < rng.uniform(8, 14) ** 2
            img = np.clip(60 + 100 * m[..., None] + rng.normal(0, 20, (h, w, 3)), 0, 255)
            name = f"{i % 6 + 1}_{i}.png"
            Image.fromarray(img.astype(np.uint8)).save(root / split / "images" / name)
            Image.fromarray((m * 255).astype(np.uint8)).save(root / split / "labels" / name)


def test_train_seg_cli_trains_and_resumes(tmp_path, capsys):
    """Two epochs, then --resume from the best-loss checkpoint. A
    checkpoint of the full-width model with its AdamW moments is ~420 MB,
    so the directory is removed at the end, pass or fail."""
    write_seg_set(tmp_path, {"train": 2, "val": 1})
    ckpt = tmp_path / "ckpt"
    common = ["--train-dir", str(tmp_path / "train"), "--val-dir", str(tmp_path / "val"),
              "--batch-size", "2", "--img-size", str(S), "--device", "cpu",
              "--save-dir", str(ckpt), "--log-dir", str(tmp_path / "log"), "--kernels"]
    try:
        out = train_seg.main(["--epochs", "2", *common])
        log = (tmp_path / "log" / "train_seg.jsonl").read_text().splitlines()
        assert len(log) == 2 and np.isfinite(out["best_val_loss"])
        best = out["best_loss_checkpoint"]
        epoch = int(best.split("epoch")[-1].split(".")[0])
        train_seg.main(["--epochs", str(epoch + 1), "--resume", best, *common])
        text = capsys.readouterr().out
        assert f"resumed from {best} at epoch {epoch}" in text
        assert len((tmp_path / "log" / "train_seg.jsonl").read_text().splitlines()) == 3
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


def test_train_seg_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_seg.main(["--train-dir", str(tmp_path), "--val-dir", str(tmp_path)])
