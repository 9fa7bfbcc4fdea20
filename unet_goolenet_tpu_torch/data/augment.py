"""Joint image+mask augmentation with the reference's exact op set and semantics
(分割/util/data_utils.py:46-241 `CDDataAugmentation`), PIL-backed.

The port's own copy of `unet_goolenet_tpu/data/augment.py` (which imports no
JAX either): the same ops and the same numpy random streams, so a seeded
Augmenter gives the same images and masks in both packages.

Pipeline order (each step gated by its probability):
  gamma -> hflip -> vflip -> rotate(+-30, nearest, no expand) -> scale(1..1.3)+
  random-crop -> gaussian BLUR (the flag is named p_gaussn but the reference applies
  blur, data_utils.py:199-201 — quirk preserved) -> contrast(0.8..2.0) ->
  shear distortion(5..30 deg) -> color jitter -> final resize (image bilinear to
  img_size, mask NEAREST to ori_size) -> to float arrays.

Outputs are NHWC-friendly: image (H, W, 3) float32 in [0, 1]; mask (H, W) int32
(long_mask) or float32/255.

Randomness comes from an explicit numpy Generator — no global state (the reference
mixes three RNGs: np.random, random, torch; we keep one, seeded per epoch).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
from PIL import Image, ImageEnhance, ImageFilter


@dataclasses.dataclass
class AugmentConfig:
    img_size: int = 224
    ori_size: int = 224
    p_gama: float = 0.0
    p_hflip: float = 0.0
    p_vflip: float = 0.0
    p_rota: float = 0.0
    p_scale: float = 0.0
    p_gaussn: float = 0.0  # gaussian BLUR probability (reference naming quirk)
    p_contr: float = 0.0
    p_distor: float = 0.0
    color_jitter: Optional[Tuple[float, float, float, float]] = None
    p_random_affine: float = 0.0
    long_mask: bool = True

    @classmethod
    def seg_train(cls, img_size: int = 224) -> "AugmentConfig":
        """分割/main.py:60-65."""
        return cls(img_size=img_size, ori_size=img_size, p_hflip=0.5, p_vflip=0.5,
                   p_rota=0.5, p_scale=0.6, p_gaussn=0.5, p_contr=0.0, p_gama=0.5,
                   p_distor=0.0, color_jitter=None, long_mask=True)

    @classmethod
    def cls_train(cls, img_size: int = 224) -> "AugmentConfig":
        """分类/ROI_main.py:117-122."""
        return cls(img_size=img_size, ori_size=img_size, p_hflip=0.6, p_vflip=0.5,
                   p_rota=0.6, p_scale=0.6, p_gaussn=0.6, p_contr=0.6, p_gama=0.6,
                   p_distor=0.6, color_jitter=(0.1, 0.1, 0.1, 0.1), long_mask=True)

    @classmethod
    def eval(cls, img_size: int = 224) -> "AugmentConfig":
        return cls(img_size=img_size, ori_size=img_size, long_mask=True)


class Augmenter:
    def __init__(self, config: AugmentConfig, rng: Optional[np.random.Generator] = None):
        self.cfg = config
        self.rng = rng or np.random.default_rng()

    # ----------------------------------------------------------------- pieces
    def _gamma(self, image: np.ndarray) -> np.ndarray:
        g = self.rng.integers(10, 25) / 10.0
        return (np.power(image / 255.0, 1.0 / g) * 255.0).astype(np.uint8)

    def _shear(self, img: Image.Image) -> Image.Image:
        # torchvision RandomAffine(0, shear=(5, 30)): shear_x in U(5, 30) degrees,
        # about the image centre, bilinear=False (nearest) by default
        deg = float(self.rng.uniform(5.0, 30.0))
        sx = np.tan(np.radians(deg))
        w, h = img.size
        cx, cy = w / 2, h / 2
        # inverse affine map for PIL: x_src = x + sx*(y) with recentering
        return img.transform(
            (w, h), Image.AFFINE, (1, sx, -sx * cy, 0, 1, 0), resample=Image.NEAREST
        )

    def _color_jitter(self, img: Image.Image) -> Image.Image:
        b, c, s, h = self.cfg.color_jitter
        order = self.rng.permutation(4)
        for op in order:
            if op == 0 and b > 0:
                img = ImageEnhance.Brightness(img).enhance(
                    float(self.rng.uniform(max(0, 1 - b), 1 + b)))
            elif op == 1 and c > 0:
                img = ImageEnhance.Contrast(img).enhance(
                    float(self.rng.uniform(max(0, 1 - c), 1 + c)))
            elif op == 2 and s > 0:
                img = ImageEnhance.Color(img).enhance(
                    float(self.rng.uniform(max(0, 1 - s), 1 + s)))
            elif op == 3 and h > 0:
                hue = float(self.rng.uniform(-h, h))
                hsv = np.array(img.convert("HSV"), dtype=np.int16)
                hsv[..., 0] = (hsv[..., 0] + int(hue * 255)) % 256
                img = Image.fromarray(hsv.astype(np.uint8), "HSV").convert("RGB")
        return img

    # ------------------------------------------------------------------- main
    def __call__(
        self, image: np.ndarray, mask: Optional[np.ndarray] = None
    ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """image: (H, W, 3) or (H, W) uint8; mask: (H, W) small ints or None."""
        cfg = self.cfg
        rng = self.rng
        if image.ndim == 2:
            image = image[..., None]
        if image.shape[-1] == 1:
            image = np.repeat(image, 3, axis=-1)
        image = image.astype(np.uint8)

        if rng.random() < cfg.p_gama:
            image = self._gamma(image)

        img = Image.fromarray(image)
        msk = Image.fromarray(mask.astype(np.uint8)) if mask is not None else None

        if rng.random() < cfg.p_hflip:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
            msk = msk.transpose(Image.FLIP_LEFT_RIGHT) if msk else None
        if rng.random() < cfg.p_vflip:
            img = img.transpose(Image.FLIP_TOP_BOTTOM)
            msk = msk.transpose(Image.FLIP_TOP_BOTTOM) if msk else None
        if rng.random() < cfg.p_rota:
            # torchvision F.rotate defaults: nearest resample, expand=False, fill 0
            angle = float(rng.uniform(-30.0, 30.0))
            img = img.rotate(angle, resample=Image.NEAREST)
            msk = msk.rotate(angle, resample=Image.NEAREST) if msk else None
        if rng.random() < cfg.p_scale:
            scale = float(rng.uniform(1.0, 1.3))
            nh = nw = int(cfg.img_size * scale)
            img = img.resize((nw, nh), Image.BILINEAR)
            msk = msk.resize((nw, nh), Image.NEAREST) if msk else None
            top = int(rng.integers(0, nh - cfg.img_size + 1))
            left = int(rng.integers(0, nw - cfg.img_size + 1))
            box = (left, top, left + cfg.img_size, top + cfg.img_size)
            img = img.crop(box)
            msk = msk.crop(box) if msk else None
        if rng.random() < cfg.p_gaussn:
            img = img.filter(ImageFilter.GaussianBlur(radius=float(rng.random())))
        if rng.random() < cfg.p_contr:
            img = ImageEnhance.Contrast(img).enhance(float(rng.uniform(0.8, 2.0)))
        if rng.random() < cfg.p_distor:
            img = self._shear(img)
        if cfg.color_jitter:
            img = self._color_jitter(img)

        # final resize: image bilinear to img_size, mask NEAREST to ori_size
        img = img.resize((cfg.img_size, cfg.img_size), Image.BILINEAR)
        out_img = np.asarray(img, np.float32) / 255.0
        out_msk = None
        if msk is not None:
            msk = msk.resize((cfg.ori_size, cfg.ori_size), Image.NEAREST)
            arr = np.asarray(msk, np.uint8)
            out_msk = arr.astype(np.int32) if cfg.long_mask else arr.astype(np.float32) / 255.0
        return out_img, out_msk
