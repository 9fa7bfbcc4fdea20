"""The port's copies of the seg data layer and validation metrics against
the JAX package's: `SegDataset` (train augmentation and eval), `DataLoader`
(shuffled batches) and `Augmenter` on a seeded temporary PNG set, with the
same numpy seeds on both sides, must give identical arrays; `SegMetrics`
(with and without the empty-prediction hack, with the Hausdorff distance),
`dice_score` and `iou_score` must give the same numbers to 1e-12 (float64
host math on both sides) and 1e-6 (float32 tensors)."""

import numpy as np
import pytest
import torch

from test_torch_train_loop import write_seg_set
from unet_goolenet_tpu_torch import data as D
from unet_goolenet_tpu_torch.data.datasets import _resize_bilinear_np, wavelet_enhance_host
from unet_goolenet_tpu_torch.eval import SegMetrics, dice_score, iou_score
from torch_threads import torch_threads  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def seg_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("seg")
    write_seg_set(root, {"train": 5})
    return root / "train"


def both(seg_root, train):
    """The port's and the JAX package's SegDataset on the same files and
    the same numpy seed."""
    from unet_goolenet_tpu.data import SegDataset as JSegDataset

    mk = lambda cls: cls(str(seg_root), img_size=32, train=train,
                         rng=np.random.default_rng(9))
    return mk(D.SegDataset), mk(JSegDataset)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_seg_dataset_matches_jax(seg_root, train):
    ds, jds = both(seg_root, train)
    assert ds.names == jds.names and len(ds) == 5
    for _ in range(2):   # two epochs: the augmentation stream advances alike
        for i in range(len(ds)):
            a, b = ds[i], jds[i]
            assert a.keys() == b.keys() and a["name"] == b["name"]
            for k in ("image", "se_label", "cl_label"):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert a["image"].shape == (32, 32, 3) and a["se_label"].shape == (32, 32, 1)


def test_loader_matches_jax(seg_root):
    from unet_goolenet_tpu.data import DataLoader as JDataLoader

    ds, jds = both(seg_root, True)
    # one worker: with more, the workers draw from the shared augmentation
    # stream in whatever order they run, in both packages
    loader = D.DataLoader(ds, 2, shuffle=True, seed=4, num_workers=1)
    jloader = JDataLoader(jds, 2, shuffle=True, seed=4, num_workers=1)
    assert len(loader) == len(jloader) == 3
    for _ in range(2):
        got, want = list(loader), list(jloader)
        assert len(got) == 3 and got[-1]["image"].shape[0] == 1
        for a, b in zip(got, want):
            assert a["name"] == b["name"]
            np.testing.assert_array_equal(a["image"], b["image"])
            np.testing.assert_array_equal(a["se_label"], b["se_label"])


def test_augmenter_and_host_preprocess_match_jax():
    from unet_goolenet_tpu.data import augment as ja
    from unet_goolenet_tpu.data import datasets as jd

    rng = np.random.default_rng(10)
    img = rng.integers(0, 256, (37, 45, 3), dtype=np.uint8)
    mask = (rng.uniform(size=(37, 45)) > 0.5).astype(np.int32)
    for cfg, jcfg in ((D.AugmentConfig.seg_train(24), ja.AugmentConfig.seg_train(24)),
                      (D.AugmentConfig(img_size=24, ori_size=24, p_contr=1.0, p_distor=1.0,
                                       color_jitter=(0.1, 0.1, 0.1, 0.1)),
                       ja.AugmentConfig(img_size=24, ori_size=24, p_contr=1.0, p_distor=1.0,
                                        color_jitter=(0.1, 0.1, 0.1, 0.1)))):
        aug, jaug = D.Augmenter(cfg, np.random.default_rng(2)), ja.Augmenter(
            jcfg, np.random.default_rng(2))
        for _ in range(4):
            (a, am), (b, bm) = aug(img, mask), jaug(img, mask)
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(am, bm)
    gray = img[..., 0]
    np.testing.assert_array_equal(wavelet_enhance_host(gray), jd.wavelet_enhance_host(gray))
    np.testing.assert_array_equal(_resize_bilinear_np(gray.astype(np.float32), (20, 30)),
                                  jd._resize_bilinear_np(gray.astype(np.float32), (20, 30)))


@pytest.mark.parametrize("hack", [False, True], ids=["plain", "empty_pred_hack"])
def test_seg_metrics_match_jax(hack):
    from unet_goolenet_tpu.eval import SegMetrics as JSegMetrics

    rng = np.random.default_rng(11)
    m, jm = SegMetrics(empty_pred_hack=hack), JSegMetrics(empty_pred_hack=hack)
    for _ in range(2):
        pred = (rng.uniform(size=(3, 20, 24, 1)) > 0.7).astype(np.float32)
        target = (rng.uniform(size=(3, 20, 24, 1)) > 0.6).astype(np.float32)
        pred[0] = 0   # an empty prediction
        target[1] = 0
        m.update(torch.from_numpy(pred), target)
        jm.update(pred, target)
    got, want = m.aggregate(), jm.aggregate()
    assert got.keys() == want.keys() == {"dice", "iou", "hausdorff"}
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)


def test_dice_and_iou_match_jax():
    import jax.numpy as jnp
    from unet_goolenet_tpu.eval import dice_score as jdice, iou_score as jiou

    rng = np.random.default_rng(12)
    pred = (rng.uniform(size=(4, 10, 12)) > 0.5).astype(np.float32)
    target = (rng.uniform(size=(4, 10, 12)) > 0.5).astype(np.float32)
    pred[2] = target[2] = 0   # undefined: NaN on both sides
    for fn, jfn in ((dice_score, jdice), (iou_score, jiou)):
        np.testing.assert_allclose(fn(torch.from_numpy(pred), torch.from_numpy(target)).numpy(),
                                   np.asarray(jfn(jnp.asarray(pred), jnp.asarray(target))),
                                   rtol=1e-6)
