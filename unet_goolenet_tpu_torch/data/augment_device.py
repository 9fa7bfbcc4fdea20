"""Batched augmentation on the device (the stage-2 trainer's ROI-crop
augment), in float32.

Counterpart of `unet_goolenet_tpu/data/augment_device.py:35-229`: the same
ops, order, gates, distributions and formulas as its `_augment_one`, split
in two so that randomness and arithmetic can be checked apart:
  * `draw(cfg, n, generator)`: each image's gates and values (the draws
    `_augment_one` takes from its keys 0-19), as (n,) tensors;
  * `apply(cfg, params, imgs, masks=None)`: the ops on the batch. As there,
    every op runs on every image and a gate selects the result (the JAX
    `jnp.where`), so the work is the same whatever the draws.
Ops, in order: gamma; h/v flip; rotation by +-30 degrees, nearest, sampled
at pixel centres about the image centre with floor, fill 0 outside (PIL's
rule as the JAX package writes it; it is not held to PIL, whose rotation
differs on up to 8% of pixels, tests/test_augment_device.py:27); scale
1..1.3 as a crop of side s / scale at a random offset resized back to s by
the package's own bilinear (floor and clip, the weight allowed to go
negative at the edge); a 9-tap gaussian blur with edge padding; contrast
about each image's luma mean; shear along x (nearest); colour jitter
(brightness, contrast, saturation, the YIQ hue rotation), ungated. Masks
take the flips, the rotation and the crop (nearest, round half to even).
No torch resampler (grid_sample, interpolate) is used: their edge and
rounding rules differ.

Images are (N, S, S, 3) float32 in [0, 1]; masks (N, S, S) integers.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from unet_goolenet_tpu_torch.data.augment import AugmentConfig

Params = Dict[str, torch.Tensor]

_LUMA = (0.299, 0.587, 0.114)
_YIQ_I = (0.596, -0.274, -0.322)
_YIQ_Q = (0.211, -0.523, 0.312)


def draw(cfg: AugmentConfig, n: int, generator: torch.Generator) -> Params:
    """Each of n images' gates (bool) and values (float32), from
    `generator` on its device: the distributions and ranges of
    `_augment_one`'s draws."""
    dev = generator.device
    u = lambda lo=0.0, hi=1.0: lo + (hi - lo) * torch.rand(n, generator=generator, device=dev)
    gate = lambda p: torch.rand(n, generator=generator, device=dev) < p
    s = cfg.img_size
    p = {"gamma": torch.randint(10, 25, (n,), generator=generator, device=dev).float() / 10.0,
         "gamma_on": gate(cfg.p_gama), "hflip": gate(cfg.p_hflip), "vflip": gate(cfg.p_vflip),
         "angle": u(-30.0, 30.0), "rotate": gate(cfg.p_rota), "scale": u(1.0, 1.3)}
    max_off = s - s / p["scale"]
    p.update(oy=u() * max_off, ox=u() * max_off, crop=gate(cfg.p_scale),
             sigma=u(), blur=gate(cfg.p_gaussn),
             contrast=u(0.8, 2.0), contrast_on=gate(cfg.p_contr),
             shear=u(5.0, 30.0), shear_on=gate(cfg.p_distor))
    if cfg.color_jitter:
        b, c, sat, h = cfg.color_jitter
        for name, v in (("jitter_brightness", b), ("jitter_contrast", c),
                        ("jitter_saturation", sat)):
            if v:
                p[name] = u(max(0, 1 - v), 1 + v)
        if h:
            p["jitter_hue"] = u(-h, h)
    return p


# ------------------------------------------------------------------ primitives
# Batched: x (N, H, W, C); per-image values (N,).


def _b(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """(N,) -> (N, 1, ..., 1) to broadcast over an ndim tensor."""
    return v.view(-1, *([1] * (ndim - 1)))


def _select(gate: torch.Tensor, on: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    return torch.where(_b(gate, on.ndim), on, off)


def _sample_nearest(x: torch.Tensor, m00, m01, m10, m11, fill: float = 0.0) -> torch.Tensor:
    """Inverse warp, nearest: output pixel centres, taken about the image
    centre, map through [[m00, m01], [m10, m11]] (each (N,)) to input
    coordinates, which are floored; out of range -> fill."""
    n, h, w, c = x.shape
    ys = torch.arange(h, dtype=torch.float32, device=x.device) + 0.5
    xs = torch.arange(w, dtype=torch.float32, device=x.device) + 0.5
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    cy, cx = h / 2.0, w / 2.0
    xo, yo = xx - cx, yy - cy
    xi = _b(m00, 3) * xo + _b(m01, 3) * yo + cx
    yi = _b(m10, 3) * xo + _b(m11, 3) * yo + cy
    ix, iy = torch.floor(xi).long(), torch.floor(yi).long()
    valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    flat = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).view(n, h * w, 1).expand(n, h * w, c)
    out = x.reshape(n, h * w, c).gather(1, flat).view(n, h, w, c)
    return torch.where(valid[..., None], out, torch.full_like(out, fill))


def rotate_nearest(x: torch.Tensor, angle_deg: torch.Tensor) -> torch.Tensor:
    """Counter-clockwise rotation by angle_deg (N,), nearest, no expand,
    fill 0."""
    a = torch.deg2rad(angle_deg)
    ca, sa = torch.cos(a), torch.sin(a)
    return _sample_nearest(x, ca, -sa, sa, ca)


def shear_x_nearest(x: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
    t = torch.tan(torch.deg2rad(deg))
    one, zero = torch.ones_like(t), torch.zeros_like(t)
    return _sample_nearest(x, one, t, zero, one)


def _rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t[i][idx[i]] along H for each image i; idx (N, K)."""
    n, _, w, c = t.shape
    return t.gather(1, idx[:, :, None, None].expand(n, idx.shape[1], w, c))


def _cols(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    n, h, _, c = t.shape
    return t.gather(2, idx[:, None, :, None].expand(n, h, idx.shape[1], c))


def crop_resize(x: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor, scale: torch.Tensor,
                method: str) -> torch.Tensor:
    """The window of side s / scale at (oy, ox) resized back to s, by the
    JAX package's bilinear or nearest sampling."""
    s = x.shape[1]
    ar = torch.arange(s, dtype=torch.float32, device=x.device) + 0.5
    step = (s / scale) / s
    ys = oy[:, None] + ar[None] * step[:, None] - 0.5
    xs = ox[:, None] + ar[None] * step[:, None] - 0.5
    if method == "nearest":
        iy = torch.round(ys).long().clamp(0, s - 1)
        ix = torch.round(xs).long().clamp(0, s - 1)
        return _cols(_rows(x, iy), ix)
    y0, x0 = torch.floor(ys).clamp(0, s - 1), torch.floor(xs).clamp(0, s - 1)
    ty, tx = (ys - y0)[:, :, None, None], (xs - x0)[:, None, :, None]
    iy0, ix0 = y0.long(), x0.long()
    iy1, ix1 = (iy0 + 1).clamp(0, s - 1), (ix0 + 1).clamp(0, s - 1)
    r0, r1 = _rows(x, iy0), _rows(x, iy1)
    top = _cols(r0, ix0) * (1 - tx) + _cols(r0, ix1) * tx
    bot = _cols(r1, ix0) * (1 - tx) + _cols(r1, ix1) * tx
    return top * (1 - ty) + bot * ty


def gaussian_blur(x: torch.Tensor, sigma: torch.Tensor, ksize: int = 9) -> torch.Tensor:
    """Separable gaussian of ksize taps with each image's sigma (floored at
    1e-3), edge padding, over H then W."""
    r = ksize // 2
    taps = torch.arange(-r, r + 1, dtype=torch.float32, device=x.device)
    k = torch.exp(-0.5 * (taps[None] / sigma.clamp_min(1e-3)[:, None]) ** 2)
    k = k / k.sum(dim=1, keepdim=True)

    def conv_axis(t: torch.Tensor, axis: int) -> torch.Tensor:
        size = t.shape[axis]
        base = torch.arange(size, device=t.device)
        out = None
        for j in range(ksize):
            term = _b(k[:, j], t.ndim) * t.index_select(axis, (base + j - r).clamp(0, size - 1))
            out = term if out is None else out + term
        return out

    return conv_axis(conv_axis(x, 1), 2)


def _dot(x: torch.Tensor, coef) -> torch.Tensor:
    return x @ torch.tensor(coef, dtype=x.dtype, device=x.device)


def adjust_contrast(x: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    mean = _b(_dot(x, _LUMA).mean(dim=(1, 2)), x.ndim)
    return ((x - mean) * _b(factor, x.ndim) + mean).clamp(0.0, 1.0)


def adjust_brightness(x: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    return (x * _b(factor, x.ndim)).clamp(0.0, 1.0)


def adjust_saturation(x: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    gray = _dot(x, _LUMA)[..., None]
    return (gray + (x - gray) * _b(factor, x.ndim)).clamp(0.0, 1.0)


def adjust_hue(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Hue rotation approximated as a rotation of the YIQ chroma by
    shift * 2 pi."""
    theta = _b(shift * 2.0 * math.pi, 3)
    y, i, q = _dot(x, _LUMA), _dot(x, _YIQ_I), _dot(x, _YIQ_Q)
    c, s = torch.cos(theta), torch.sin(theta)
    i2, q2 = i * c - q * s, i * s + q * c
    rgb = (y + 0.956 * i2 + 0.621 * q2, y - 0.272 * i2 - 0.647 * q2,
           y - 1.106 * i2 + 1.703 * q2)
    return torch.stack(rgb, dim=-1).clamp(0.0, 1.0)


# --------------------------------------------------------------- the augmenter


def apply(cfg: AugmentConfig, p: Params, imgs: torch.Tensor,
          masks: Optional[torch.Tensor] = None):
    """The ops of `_augment_one` on a batch with the draws p: imgs (N, S, S,
    3) -> same shape; with masks (N, S, S), (imgs, masks)."""
    p = {k: v.to(imgs.device) for k, v in p.items()}
    img = imgs
    img = _select(p["gamma_on"], img.clamp(0, 1) ** _b(1.0 / p["gamma"], 4), img)
    img = _select(p["hflip"], img.flip(2), img)
    img = _select(p["vflip"], img.flip(1), img)
    img = _select(p["rotate"], rotate_nearest(img, p["angle"]), img)
    img = _select(p["crop"], crop_resize(img, p["oy"], p["ox"], p["scale"], "bilinear"), img)
    img = _select(p["blur"], gaussian_blur(img, p["sigma"]), img)
    img = _select(p["contrast_on"], adjust_contrast(img, p["contrast"]), img)
    img = _select(p["shear_on"], shear_x_nearest(img, p["shear"]), img)
    for name, op in (("jitter_brightness", adjust_brightness),
                     ("jitter_contrast", adjust_contrast),
                     ("jitter_saturation", adjust_saturation), ("jitter_hue", adjust_hue)):
        if name in p:
            img = op(img, p[name])
    if masks is None:
        return img
    m = masks[..., None].float()
    m = _select(p["hflip"], m.flip(2), m)
    m = _select(p["vflip"], m.flip(1), m)
    m = _select(p["rotate"], rotate_nearest(m, p["angle"]), m)
    m = _select(p["crop"], crop_resize(m, p["oy"], p["ox"], p["scale"], "nearest"), m)
    return img, m[..., 0].to(masks.dtype)


def make_device_augment(cfg: AugmentConfig, with_mask: bool = False):
    """The batched augmenter: (generator, imgs[, masks]) -> the same shapes,
    fresh draws from the generator each call."""
    if with_mask:
        def run(generator: torch.Generator, imgs: torch.Tensor, masks: torch.Tensor):
            return apply(cfg, draw(cfg, imgs.shape[0], generator), imgs, masks)
    else:
        def run(generator: torch.Generator, imgs: torch.Tensor):
            return apply(cfg, draw(cfg, imgs.shape[0], generator), imgs)
    return run
