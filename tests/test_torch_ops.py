"""The port's ops against the JAX package's, on the same numpy-seeded inputs.

Tolerance 1e-5 in float32. The wavelet output is quantised as floor(y * 255)
/ 255, and a different float32 summation order in its resize can move a value
across a level boundary, so there the rule is: at most one uint8 level (1/255)
anywhere, and on at most 1% of the values.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from unet_goolenet_tpu import ops as J
from unet_goolenet_tpu.ops.resize import _weight_mat as jax_weight_mat
from unet_goolenet_tpu_torch import ops as T
from unet_goolenet_tpu_torch.ops.pool import max_pool2d_nchw
from torch_threads import torch_threads  # noqa: F401  (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)
RNG = np.random.default_rng(2024)


def gray_batch(n, h, w):
    return RNG.uniform(0.0, 255.0, (n, h, w)).astype(np.float32)


@pytest.mark.parametrize("h,w", [(40, 48), (37, 53)])
def test_haar_dwt2(h, w):
    g = gray_batch(2, h, w)
    ca, details = T.haar_dwt2(torch.from_numpy(g))
    for i in range(2):
        jca, jdet = J.haar_dwt2(jnp.asarray(g[i]))
        np.testing.assert_allclose(ca[i].numpy(), np.asarray(jca), **TOL)
        for a, b in zip(details, jdet):
            np.testing.assert_allclose(a[i].numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("h,w", [(80, 96), (101, 75)])
def test_wavelet_enhance_within_one_level(h, w):
    g = gray_batch(2, h, w)
    got = T.wavelet_enhance(torch.from_numpy(g)).numpy()
    ref = np.stack([np.asarray(J.wavelet_enhance(jnp.asarray(x))) for x in g])
    assert got.shape == ref.shape == (2, h, w, 3)
    diff = np.abs(got - ref)
    assert diff.max() <= 1.0 / 255.0 + 1e-6
    assert (diff > 1e-5).mean() <= 0.01


def test_wavelet_enhance_continuous_and_constant():
    g = gray_batch(1, 40, 56)
    got = T.wavelet_enhance(torch.from_numpy(g), quantize_uint8=False).numpy()
    ref = np.asarray(J.wavelet_enhance(jnp.asarray(g[0]), quantize_uint8=False))
    np.testing.assert_allclose(got[0], ref, **TOL)
    # a constant image has zero range: every channel normalises to 0
    flat = T.wavelet_enhance(torch.full((1, 8, 8), 7.0))
    assert torch.count_nonzero(flat) == 0


@pytest.mark.parametrize("n_in,n_out", [(400, 224), (360, 224), (50, 64), (13, 13), (37, 11)])
@pytest.mark.parametrize("antialias", [True, False])
def test_weight_mat_matches_jax(n_in, n_out, antialias):
    got = T.weight_mat(n_in, n_out, antialias).numpy()
    ref = np.asarray(jax_weight_mat(n_in, n_out, antialias))
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("antialias", [True, False])
@pytest.mark.parametrize("shape,out_hw", [((2, 90, 70, 3), (48, 40)), ((2, 20, 30, 3), (64, 64)),
                                          ((33, 47), (24, 24))])
def test_resize_bilinear(shape, out_hw, antialias):
    x = RNG.uniform(0.0, 1.0, shape).astype(np.float32)
    got = T.resize_bilinear(torch.from_numpy(x), out_hw, antialias=antialias).numpy()
    ref = np.asarray(J.resize_bilinear(jnp.asarray(x), out_hw, antialias=antialias))
    np.testing.assert_allclose(got, ref, **TOL)


def masks_batch(h, w):
    """Random blobs, an empty mask (centre fallback) and an all-ones mask
    (box clamped to the image)."""
    m = np.zeros((4, h, w), np.float32)
    m[0, 10:25, 5:40] = 1.0
    m[1, 3, 50] = 1.0
    m[2] = 0.0
    m[3] = 1.0
    return m


def test_mask_to_bbox():
    m = masks_batch(64, 72)
    got = T.mask_to_bbox(torch.from_numpy(m), 30)
    ref = jax.vmap(lambda x: J.mask_to_bbox(x, 30))(jnp.asarray(m))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[4].tolist() == [False, False, True, False]


@pytest.mark.parametrize("out_hw", [(32, 32), (50, 40)])
def test_roi_crop_and_resize(out_hw):
    m = masks_batch(64, 72)
    imgs = RNG.uniform(0.0, 1.0, (4, 64, 72, 3)).astype(np.float32)
    crops, boxes = T.roi_from_mask(torch.from_numpy(imgs), torch.from_numpy(m),
                                   padding=5, out_hw=out_hw)
    jc, jb = jax.vmap(lambda i, k: J.roi_from_mask(i, k, padding=5, out_hw=out_hw))(
        jnp.asarray(imgs), jnp.asarray(m))
    np.testing.assert_array_equal(boxes.numpy(), np.asarray(jb))
    np.testing.assert_allclose(crops.numpy(), np.asarray(jc), **TOL)


def test_conv_transpose2x2_and_fold_batchnorm():
    x = RNG.standard_normal((2, 5, 7, 6)).astype(np.float32)
    w = RNG.standard_normal((2, 2, 6, 4)).astype(np.float32)        # JAX (kh, kw, Ci, Co)
    b = RNG.standard_normal(4).astype(np.float32)
    got = T.conv_transpose2x2(torch.from_numpy(x), torch.from_numpy(w.transpose(2, 3, 0, 1)),
                              torch.from_numpy(b)).numpy()
    ref = np.asarray(J.conv_transpose2x2(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    np.testing.assert_allclose(got, ref, **TOL)

    wc = RNG.standard_normal((3, 3, 6, 4)).astype(np.float32)       # HWIO
    gamma, beta, mean = (RNG.standard_normal(4).astype(np.float32) for _ in range(3))
    var = RNG.uniform(0.5, 1.5, 4).astype(np.float32)
    wf, bf = T.fold_batchnorm(torch.from_numpy(wc.transpose(3, 2, 0, 1)), torch.from_numpy(b),
                              *(torch.from_numpy(a) for a in (gamma, beta, mean, var)), 1e-3)
    jw, jb = J.fold_batchnorm(*(jnp.asarray(a) for a in (wc, b, gamma, beta, mean, var)), 1e-3)
    np.testing.assert_allclose(wf.numpy(), np.asarray(jw).transpose(3, 2, 0, 1), **TOL)
    np.testing.assert_allclose(bf.numpy(), np.asarray(jb), **TOL)


@pytest.mark.parametrize("size,window,stride,padding,ceil_mode", [
    (112, 3, 2, 0, True), (55, 3, 2, 0, True), (14, 2, 2, 0, True), (7, 2, 2, 0, True),
    (28, 3, 1, 1, True), (5, 2, 2, 1, True), (9, 3, 2, 1, True), (16, 2, 2, 0, False)])
def test_max_pool2d_ceil_rule(size, window, stride, padding, ceil_mode):
    """(5, 2, 2, 1) and (9, 3, 2, 1) are sizes where torch's own ceil mode
    would drop the last window; the port follows the JAX rule."""
    x = RNG.standard_normal((2, size, size + 1, 3)).astype(np.float32)
    got = T.max_pool2d(torch.from_numpy(x), window, stride, padding=padding,
                       ceil_mode=ceil_mode).numpy()
    ref = np.asarray(J.max_pool2d(jnp.asarray(x), window, stride, padding=padding,
                                  ceil_mode=ceil_mode))
    np.testing.assert_array_equal(got, ref)
    nchw = max_pool2d_nchw(torch.from_numpy(x).permute(0, 3, 1, 2), window, stride,
                           padding=padding, ceil_mode=ceil_mode)
    np.testing.assert_array_equal(nchw.permute(0, 2, 3, 1).numpy(), ref)


def test_port_imports_without_jax():
    """Every module of the port imports with jax and the JAX package blocked."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['unet_goolenet_tpu'] = None\n"
        "import unet_goolenet_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert not any(k.startswith(('jax', 'flax')) for k, v in sys.modules.items()"
        " if v is not None)\n"
        "print(len(names))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15
