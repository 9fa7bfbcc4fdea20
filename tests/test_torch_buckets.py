"""The port's size-bucket preprocessing and image-folder dataset against the
JAX package's.

Seeded gray images of mixed native sizes, each edge-padded (np.pad
mode="edge") into one even-sized bucket buffer with its valid size, go
through the JAX function (vmapped over the batch, jitted) and its
counterpart in the port. Resize at 1e-5; the wavelet and the padded
preprocess at 1e-5 with at most one uint8 level (1/255) on at most 1% of
values, the rule of test_torch_ops.py; ImageFolderDataset items bit for bit.
The grades of the padded pipeline, the CLI's routes and predict_seg are in
test_torch_pipeline.py, which has the models.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from PIL import Image

from unet_goolenet_tpu import ops as J
from unet_goolenet_tpu.apps.infer_e2e import bucket_shapes as jax_bucket_shapes
from unet_goolenet_tpu.data.datasets import ImageFolderDataset as JFolder
from unet_goolenet_tpu.pipeline.two_stage import preprocess_gray_padded as jax_preprocess_padded
from unet_goolenet_tpu_torch import ops as T
from unet_goolenet_tpu_torch.apps.infer_e2e import bucket_shapes
from unet_goolenet_tpu_torch.data import ImageFolderDataset
from unet_goolenet_tpu_torch.pipeline import preprocess_gray_padded
from torch_threads import torch_threads  # noqa: F401  (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)
BUF = (40, 48)
# even and odd valid sizes, the full buffer among them
SIZES = [(40, 48), (37, 45), (40, 47), (31, 48), (33, 38)]


def padded_batch(seed, sizes=SIZES, buf=BUF):
    """(N, H, W) float32 edge-padded grays in [0, 255] and (N, 2) valid sizes."""
    rng = np.random.default_rng(seed)
    bufs = [np.pad(rng.uniform(0.0, 255.0, hw).astype(np.float32),
                   ((0, buf[0] - hw[0]), (0, buf[1] - hw[1])), mode="edge") for hw in sizes]
    return np.stack(bufs), np.asarray(sizes, np.int32)


def within_one_level(got, ref):
    assert got.shape == ref.shape
    diff = np.abs(got - ref)
    assert diff.max() <= 1.0 / 255.0 + 1e-6
    assert (diff > 1e-5).mean() <= 0.01


@pytest.mark.parametrize("antialias", [True, False])
@pytest.mark.parametrize("out_hw,dynamic", [((32, 36), False), (BUF, True)])
def test_resize_bilinear_valid_matches_jax(antialias, out_hw, dynamic):
    """Valid regions inside a larger buffer, downscaled to a fixed grid, or
    (dynamic) upsampled onto each image's own out_valid_hw inside an output
    buffer, as the wavelet's band upsample does; the rows past it compare
    too."""
    x, valid = padded_batch(1)
    planes = np.stack([x, x[::-1], x * 0.5], axis=1)               # (N, 3, H, W)
    in_valid = (valid + 1) // 2 if dynamic else valid
    out_valid = valid if dynamic else np.tile(np.asarray(out_hw, np.int32), (len(valid), 1))
    got = T.resize_bilinear_valid(torch.from_numpy(planes), in_valid, out_hw,
                                  out_valid_hw=out_valid if dynamic else None,
                                  antialias=antialias).numpy()
    ref = jax.jit(jax.vmap(lambda a, vi, vo: J.resize_bilinear_valid(
        a, vi, out_hw, out_valid_hw=vo, antialias=antialias, channel_first=True)))(
        jnp.asarray(planes), jnp.asarray(in_valid), jnp.asarray(out_valid))
    assert got.shape == (len(valid), 3, *out_hw)
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)


@pytest.mark.parametrize("quantize", [True, False])
def test_wavelet_enhance_padded_matches_jax(quantize):
    """The whole buffer compares, the edge replication past (h, w) too."""
    x, valid = padded_batch(2)
    got = T.wavelet_enhance_padded(torch.from_numpy(x), valid, quantize_uint8=quantize).numpy()
    ref = np.asarray(jax.jit(jax.vmap(lambda g, v: J.wavelet_enhance_padded(
        g, v, quantize_uint8=quantize)))(jnp.asarray(x), jnp.asarray(valid)))
    if quantize:
        within_one_level(got, ref)
    else:
        np.testing.assert_allclose(got, ref, **TOL)
    # a constant valid region has zero range, whatever lies past it (rows
    # 4-7 here, outside its 2x2 DWT blocks): every channel normalises to 0
    flat = np.full((1, 8, 8), 7.0, np.float32)
    flat[0, 4:, :] = 200.0
    assert torch.count_nonzero(T.wavelet_enhance_padded(torch.from_numpy(flat), [(4, 8)])) == 0
    with pytest.raises(ValueError, match="even"):
        T.wavelet_enhance_padded(torch.zeros(1, 7, 8), [(7, 8)])


def test_preprocess_gray_padded_matches_jax():
    x, valid = padded_batch(3)
    got = preprocess_gray_padded(torch.from_numpy(x), valid, out_hw=(32, 32)).numpy()
    ref = np.asarray(jax.jit(lambda g, v: jax_preprocess_padded(g, v, out_hw=(32, 32)))(
        jnp.asarray(x), jnp.asarray(valid)))
    assert got.shape == (len(valid), 32, 32, 3)
    within_one_level(got, ref)


def test_bucket_shapes_match_jax():
    shapes = [(35, 45), (30, 42), (35, 45), (401, 499), (400, 500), (33, 60), (12, 7)]
    for n in (0, 1, 2, 3, 10):
        assert bucket_shapes(shapes, n) == jax_bucket_shapes(shapes, n)


@pytest.mark.parametrize("wavelet", [True, False])
def test_image_folder_dataset_matches_jax(tmp_path, wavelet):
    """Gray and RGB PNGs and an RGB JPEG of three sizes, read, enhanced (or
    not) and resized to 32^2 by both packages: equal items, in order."""
    rng = np.random.default_rng(4)
    for name, shape in (("3.png", (35, 45)), ("10.png", (30, 42, 3)), ("1.jpg", (41, 37, 3)),
                        ("b.png", (30, 42))):
        img = Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8))
        img.save(tmp_path / name, **({"quality": 90} if name.endswith(".jpg") else {}))
    got = ImageFolderDataset(str(tmp_path), img_size=32, wavelet=wavelet)
    ref = JFolder(str(tmp_path), img_size=32, wavelet=wavelet)
    assert len(got) == len(ref) == 4
    for i in range(4):
        g, r = got[i], ref[i]
        assert g["name"] == r["name"] and g["image"].dtype == r["image"].dtype == np.float32
        np.testing.assert_array_equal(g["image"], r["image"], err_msg=g["name"])
