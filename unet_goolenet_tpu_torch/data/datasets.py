"""Datasets mirroring the reference's disk conventions (SURVEY.md §4 fixtures).

The port's own copy of `unet_goolenet_tpu/data/datasets.py` (SegDataset,
ClsDataset, ImageFolderDataset, `_imread`, `wavelet_enhance_host`,
`_resize_bilinear_np`): numpy arrays out, the same files and random streams
as there. Conventions:

  * SegDataset (分割/main.py:53-103): `<root>/images/*.png` + `<root>/labels/<same
    name>`; masks are 0/255 PNGs divided by 255 (main.py:92); the class label is
    encoded in the FIRST CHARACTER of the filename minus one (main.py:93).
  * ClsDataset (分类/ROI_main.py:100-162): `<root>/images/*` +
    `<root>/labels/label.txt` of "name label" lines (labels as written); a
    gray read, the wavelet pseudo-RGB and the eval resize. The ROI crop and
    its augmentation run on the device in the trainer; `roi_augment` is the
    host Augmenter of the crops, kept as in the JAX package.
  * `wavelet_enhance_host`: the stage-2 pseudo-RGB preprocessing on the host.
  * ImageFolderDataset: a flat directory of test images, in sorted order,
    for the e2e CLI's host path (wavelet=True) and stage-1 prediction
    (wavelet=False, raw BGR).

Image decode uses cv2 (as the reference does) with PIL fallback.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from unet_goolenet_tpu_torch.data.augment import AugmentConfig, Augmenter


def _imread(path: str, grayscale: bool) -> np.ndarray:
    try:
        import cv2

        img = cv2.imread(path, 0 if grayscale else 1)
        if img is None:
            raise IOError(path)
        return img  # grayscale (H,W) or BGR (H,W,3) — BGR matches the reference
    except ImportError:
        from PIL import Image

        img = Image.open(path)
        img = img.convert("L" if grayscale else "RGB")
        arr = np.asarray(img)
        if not grayscale:
            arr = arr[..., ::-1]  # to BGR for cv2-parity
        return arr


def _resize_bilinear_np(x: np.ndarray, out_hw) -> np.ndarray:
    """numpy INTER_LINEAR twin (half-pixel bilinear, replicate-clamped) used
    when cv2 is absent — cv2 is only the `.[test]` oracle extra, so a clean
    `pip install .` must still run the wavelet preprocessing."""
    oh, ow = out_hw
    hh, ww = x.shape
    ys = np.clip((np.arange(oh) + 0.5) * (hh / oh) - 0.5, 0, hh - 1)
    xs = np.clip((np.arange(ow) + 0.5) * (ww / ow) - 0.5, 0, ww - 1)
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    y1 = np.minimum(y0 + 1, hh - 1)
    x1 = np.minimum(x0 + 1, ww - 1)
    fy = (ys - y0).astype(np.float32)[:, None]
    fx = (xs - x0).astype(np.float32)[None, :]
    top = x[np.ix_(y0, x0)] * (1 - fx) + x[np.ix_(y0, x1)] * fx
    bot = x[np.ix_(y1, x0)] * (1 - fx) + x[np.ix_(y1, x1)] * fx
    return top * (1 - fy) + bot * fy


def wavelet_enhance_host(gray: np.ndarray) -> np.ndarray:
    """Host-side counterpart of ops.wavelet_enhance (分类/ROI_main.py:37-83):
    (H, W) uint8 -> (H, W, 3) uint8 pseudo-RGB. numpy implementation of the Haar
    block transform + cv2-semantics resize."""
    try:
        import cv2

        def _up(a, hw):
            return cv2.resize(a, (hw[1], hw[0]), interpolation=cv2.INTER_LINEAR)
    except ImportError:
        _up = _resize_bilinear_np

    g = gray.astype(np.float32)
    if g.max() <= 1.0:
        g = g * 255.0
    h, w = g.shape
    gp = g
    if h % 2:
        gp = np.concatenate([gp, gp[-1:, :]], 0)
    if w % 2:
        gp = np.concatenate([gp, gp[:, -1:]], 1)
    b = gp.reshape(gp.shape[0] // 2, 2, gp.shape[1] // 2, 2)
    a_, b_, c_, d_ = b[:, 0, :, 0], b[:, 0, :, 1], b[:, 1, :, 0], b[:, 1, :, 1]
    cA = (a_ + b_ + c_ + d_) * 0.5
    cH = (a_ + b_ - c_ - d_) * 0.5
    cV = (a_ - b_ + c_ - d_) * 0.5
    cD = (a_ - b_ - c_ + d_) * 0.5
    high = np.sqrt(cH ** 2 + cV ** 2 + cD ** 2)
    low_up = _up(cA, (h, w))
    high_up = _up(high, (h, w))

    def norm(x):
        x = x - x.min()
        m = x.max()
        if m != 0:
            x = x / m
        return (x * 255).astype(np.uint8)

    return np.stack([norm(g), norm(low_up), norm(high_up)], axis=-1)


class SegDataset:
    def __init__(self, root: str, *, img_size: int = 224, train: bool = False,
                 rng: Optional[np.random.Generator] = None):
        self.image_dir = os.path.join(root, "images")
        self.label_dir = os.path.join(root, "labels")
        self.names: List[str] = sorted(os.listdir(self.image_dir))
        cfg = AugmentConfig.seg_train(img_size) if train else AugmentConfig.eval(img_size)
        self.augment = Augmenter(cfg, rng)

    def __len__(self) -> int:
        return len(self.names)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        name = self.names[idx]
        image = _imread(os.path.join(self.image_dir, name), grayscale=False)
        mask = _imread(os.path.join(self.label_dir, name), grayscale=True) // 255
        cl_label = int(name[0]) - 1  # filename-encoded grade (main.py:93)
        img, msk = self.augment(image, mask)
        return {
            "image": img.astype(np.float32),              # (S, S, 3) in [0,1]
            "se_label": msk[..., None].astype(np.float32),  # (S, S, 1) {0,1}
            "cl_label": np.int32(cl_label),
            "name": name,
        }


class ClsDataset:
    def __init__(self, root: str, *, img_size: int = 224, train: bool = False,
                 rng: Optional[np.random.Generator] = None):
        self.image_dir = os.path.join(root, "images")
        self.names: List[str] = []
        self.labels: List[int] = []
        with open(os.path.join(root, "labels", "label.txt")) as f:
            for line in f:
                if line.strip():
                    name, label = line.split()
                    self.names.append(name)
                    self.labels.append(int(label))
        self.img_size = img_size
        # the reference's augm1: the eval resize of the wavelet image
        self.pre = Augmenter(AugmentConfig.eval(img_size), rng)
        self.roi_augment = Augmenter(
            AugmentConfig.cls_train(img_size) if train else AugmentConfig.eval(img_size), rng)
        self.train = train

    def __len__(self) -> int:
        return len(self.names)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        name = self.names[idx]
        rgb = wavelet_enhance_host(_imread(os.path.join(self.image_dir, name), grayscale=True))
        img, _ = self.pre(rgb, None)
        return {
            "image": img.astype(np.float32),  # (S, S, 3) wavelet pseudo-RGB in [0, 1]
            "cl_label": np.int32(self.labels[idx]),
            "name": name,
        }


class ImageFolderDataset:
    """Flat directory of test images; `wavelet` selects the stage-2
    preprocessing (True: gray -> wavelet pseudo-RGB, the e2e path) or the
    raw image (False: stage-1 prediction). Items are the eval resize of
    either, (S, S, 3) float32 in [0, 1], and the file name."""

    def __init__(self, image_dir: str, *, img_size: int = 224, wavelet: bool = True):
        self.image_dir = image_dir
        self.names = sorted(os.listdir(image_dir))
        self.wavelet = wavelet
        self.pre = Augmenter(AugmentConfig.eval(img_size))

    def __len__(self) -> int:
        return len(self.names)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        name = self.names[idx]
        path = os.path.join(self.image_dir, name)
        if self.wavelet:
            rgb = wavelet_enhance_host(_imread(path, grayscale=True))
        else:
            rgb = _imread(path, grayscale=False)
        img, _ = self.pre(rgb, None)
        return {"image": img.astype(np.float32), "name": name}
