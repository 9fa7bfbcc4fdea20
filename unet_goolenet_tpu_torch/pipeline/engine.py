"""BN-folded inference forwards of the two models, on NHWC tensors.

Counterpart of `unet_goolenet_tpu/pipeline/engine.py` (`unet_forward`, the
dense path, and `gnet_forward` with the plain stem). `fold_unet` / `fold_gnet`
fold every inference BatchNorm into its conv once and cast the weights to the
compute dtype; the forwards are plain functions over that dict. Activations
stay in the compute dtype; convs and matmuls accumulate in float32.

`unet_forward` runs the UNet's last decoder level and its 1x1 head as the
JAX package's accelerator path runs them (`unet_forward_packed_tail_fused`,
engine.py:309-341), in dense layout: the gate-pass kernel (`up1_gate`), the
tiny 1x1 squeeze-excite gate in plain torch, then the tail kernel
(`up1_tail`). Its knobs `fused_down1`, `fused_up34` and `fused_up2` follow
the JAX engine's `unet_forward_packed` (engine.py:394-474) on the one dense
path: pool + down1 on `pool_down1`, and up4/up3 and up2 each on the dense
gate kernel, the squeeze-excite gate and the level kernel (`_up_fused`).
`unet_trunk` with every knob off plus `up1_plain` is the whole UNet as plain
ops, the composition the kernels are held against; only tests and
chip_smoke.py call `up1_plain`.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from unet_goolenet_tpu_torch.models.googlenet import (
    INCEPTION_CFG, GoogLeNetClassifier, transform_input)
from unet_goolenet_tpu_torch.models.unet import UNetTaskAligWeight
from unet_goolenet_tpu_torch.nn.blocks import ConvBatchNorm
from unet_goolenet_tpu_torch.ops.conv import conv2d, conv_transpose2x2, fold_batchnorm
from unet_goolenet_tpu_torch.ops.kernels.down1 import down1_weights, pool_down1
from unet_goolenet_tpu_torch.ops.kernels.up1 import (
    gate_weights, tail_weights, up1_gate, up1_tail)
from unet_goolenet_tpu_torch.ops.kernels.up2 import (
    up_gate_dense, up_gate_weights, up_level, up_level_weights)
from unet_goolenet_tpu_torch.ops.pool import max_pool2d
from unet_goolenet_tpu_torch.nn.transformer import attend

Params = Dict[str, Any]
WB = Tuple[torch.Tensor, torch.Tensor]


# ------------------------------------------------------------------ folding


def _fold(conv: torch.nn.Conv2d, bn: torch.nn.BatchNorm2d) -> WB:
    return fold_batchnorm(conv.weight, conv.bias, bn.weight, bn.bias,
                          bn.running_mean, bn.running_var, bn.eps)


def _cast(wb, dtype) -> Tuple[torch.Tensor, ...]:
    return tuple(t.detach().to(dtype) if t is not None else None for t in wb)


def _fold_cbn(m: ConvBatchNorm, dtype) -> WB:
    return _cast(_fold(m.conv, m.norm), dtype)


def _lin(layer, dtype) -> WB:
    """Linear or 1x1 conv -> (w (out, in), b) in dtype."""
    w = layer.weight.reshape(layer.weight.shape[0], -1)
    return _cast((w, layer.bias), dtype)


def _fold_up(up, dtype) -> Params:
    """One UpBlockAlig, folded. Weights in dtype, biases in dtype."""
    cca = up.cca
    return {
        "up": _cast((up.up.weight, up.up.bias), dtype),
        "e1": _fold_cbn(cca.conv1_e[0], dtype),
        "d2": _fold_cbn(cca.conv2_e[0], dtype),
        "fc_avg": _lin(cca.fc_avg, dtype),
        "fc_max": _lin(cca.fc_max, dtype),
        "fc_out": _lin(cca.fc_avg_max_sfot, dtype),
        "pair": _fold_cbn(up.nConvs[0], dtype),
        "blk1": _fold_cbn(up.nConvs[1], dtype),
    }


def _fold_layer(lyr, dtype) -> Params:
    """One MultiAttention block: linear weights and LayerNorm affines in dtype."""
    att = lambda a: {"to_qkv": _lin(a.to_qkv, dtype), "to_out": _lin(a.to_out[0], dtype)}
    ca = lyr.cross_attention_cl
    p = {"attention1": att(lyr.attention1), "attention2": att(lyr.attention2),
         "cross_attention_cl": {k: _lin(getattr(ca, k), dtype) for k in ("to_q", "to_k", "to_v")}}
    p["cross_attention_cl"]["to_out"] = _lin(ca.to_out[0], dtype)
    for nm in ("x_att_norm", "m_att_norm", "x_mlp_norm", "m_mlp_norm"):
        p[nm] = _cast((getattr(lyr, nm).weight, getattr(lyr, nm).bias), dtype)
    for ff in ("x_feed", "m_feed"):
        net = getattr(lyr, ff).net
        p[ff] = (_lin(net[0], dtype), _lin(net[3], dtype))
    return p


@torch.no_grad()
def fold_unet(model: UNetTaskAligWeight, dtype=torch.float32, *, fused_up2: bool = False,
              fused_up34: bool = False, fused_down1: bool = False) -> Params:
    """Folded, cast weights of a UNetTaskAligWeight (eval semantics). The
    levels that run on kernels are also folded in float32 and laid out once
    for them: up1 always (`up1_kernels`), and the levels whose knob is on
    (`up_kernels`, `down1_kernels`), the knobs of `unet_forward`. The
    kernels round weights to the activation dtype and keep biases in
    float32."""
    t = model.task2
    u = _fold_up(model.up1, torch.float32)
    outc = _cast((model.outc.weight, model.outc.bias), torch.float32)
    P = {
        "dtype": dtype,
        "inc": _fold_cbn(model.inc, dtype),
        "down": [[_fold_cbn(b, dtype) for b in getattr(model, f"down{i}").nConvs]
                 for i in range(1, 5)],
        "task2": {
            "conv_cl": _cast(_fold(t.conv_cl[0], t.conv_cl[1]), dtype),
            "conv_seg": _cast(_fold(t.conv_seg[0], t.conv_seg[1]), dtype),
            "pos_cl": t.pos_embedding_decoder_cl.detach().permute(0, 2, 3, 1).to(dtype),
            "pos_seg": t.pos_embedding_decoder_seg.detach().permute(0, 2, 3, 1).to(dtype),
            "layers": [_fold_layer(lyr, dtype) for lyr in t.layers],
        },
        "up4": _fold_up(model.up4, dtype),
        "up3": _fold_up(model.up3, dtype),
        "up2": _fold_up(model.up2, dtype),
        "up1": _fold_up(model.up1, dtype),
        "outc": _cast((model.outc.weight, model.outc.bias), dtype),
        "up1_kernels": (gate_weights(*u["e1"], dtype),
                        tail_weights(*u["up"], *u["d2"], *u["pair"], *u["blk1"], *outc,
                                     dtype)),
        "up_kernels": {},
    }
    for name, on in (("up4", fused_up34), ("up3", fused_up34), ("up2", fused_up2)):
        if on:
            f = _fold_up(getattr(model, name), torch.float32)
            P["up_kernels"][name] = (up_gate_weights(*f["e1"], dtype),
                                     up_level_weights(*f["up"], *f["d2"], *f["pair"],
                                                      *f["blk1"], dtype))
    if fused_down1:
        d1 = [_fold_cbn(b, torch.float32) for b in model.down1.nConvs]
        P["down1_kernels"] = down1_weights(*d1[0], *d1[1], dtype)
    return P


def _laid_out(P: Params, key: str, knob: str):
    """P[key] (a level's kernel weights), or a ValueError naming the knob
    that fold_unet needed."""
    if key not in P:
        raise ValueError(f"{knob}=True needs the kernel weights that "
                         f"fold_unet(..., {knob}=True) lays out")
    return P[key]


# ------------------------------------------------------------------ UNet


def _cbn(x: torch.Tensor, wb: WB, padding: int = 1) -> torch.Tensor:
    return torch.relu(conv2d(x, wb[0], wb[1], padding=padding))


def _se_gate(avg: torch.Tensor, mx: torch.Tensor, p: Params) -> torch.Tensor:
    """CoordAtt3's 1x1 squeeze-excite gate on (N, C) statistics."""
    s = torch.relu(F.linear(avg, *p["fc_avg"])) + torch.relu(F.linear(mx, *p["fc_max"]))
    return torch.sigmoid(F.linear(s, *p["fc_out"]))


def _coord_att3(e: torch.Tensor, d: torch.Tensor, p: Params) -> torch.Tensor:
    e1 = _cbn(e, p["e1"])
    gate = _se_gate(e1.mean(dim=(1, 2)), e1.amax(dim=(1, 2)), p)[:, None, None, :]
    d2 = _cbn(d, p["d2"])
    return e1 + gate * d2 + d2


def _up_alig(x: torch.Tensor, skip: torch.Tensor, p: Params) -> torch.Tensor:
    up = conv_transpose2x2(x, *p["up"])
    gated = _coord_att3(skip, up, p)
    return _cbn(_cbn(torch.cat([up, gated], dim=-1), p["pair"]), p["blk1"])


def _up_fused(y: torch.Tensor, skip: torch.Tensor, P: Params, name: str) -> torch.Tensor:
    """A decoder level (up2-up4) through the dense gate kernel, the 1x1
    squeeze-excite gate in plain torch, then the level kernel (plain
    versions on the CPU); counterpart of the JAX engine's `_up_fused`."""
    gw, lw = _laid_out(P["up_kernels"], name,
                       "fused_up2" if name == "up2" else "fused_up34")
    e1, avg, mx = up_gate_dense(skip.contiguous(), gw)
    gate = _se_gate(avg.to(skip.dtype), mx.to(skip.dtype), P[name])
    return up_level(y.contiguous(), e1, 1.0 + gate, lw)


def _up1_kernels(y: torch.Tensor, x1: torch.Tensor, P: Params) -> torch.Tensor:
    """up1 + outc through the two kernels (plain versions on the CPU)."""
    gw, tw = P["up1_kernels"]
    e1, avg, mx = up1_gate(x1, gw)
    gate = _se_gate(avg.to(x1.dtype), mx.to(x1.dtype), P["up1"])
    return up1_tail(y, e1, 1.0 + gate, tw)


def up1_plain(P: Params, y: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """up1 + outc as plain ops on `unet_trunk`'s outputs: the composition the
    kernel path is held against."""
    return conv2d(_up_alig(y, x1, P["up1"]), *P["outc"])


def _layernorm(x: torch.Tensor, wb: WB) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], wb[0], wb[1], 1e-5)


def _attention(x: torch.Tensor, p: Params, heads: int, scale: float) -> torch.Tensor:
    q, k, v = F.linear(x, *p["to_qkv"]).chunk(3, dim=-1)
    return F.linear(attend(q, k, v, heads, scale), *p["to_out"])


def _cross(x: torch.Tensor, m: torch.Tensor, p: Params, heads: int, scale: float):
    o = attend(F.linear(x, *p["to_q"]), F.linear(m, *p["to_k"]), F.linear(m, *p["to_v"]),
               heads, scale)
    return F.linear(o, *p["to_out"])


def _feed(x: torch.Tensor, ff) -> torch.Tensor:
    return F.linear(F.gelu(F.linear(x, *ff[0])), *ff[1])


def _transformer(x: torch.Tensor, p: Params, heads: int = 8) -> torch.Tensor:
    """Bottleneck with x = m = the deepest feature map (N, h, w, 512); returns
    the seg stream, the only one the decoder reads."""
    n, h, w, c = x.shape
    scale = c ** -0.5                       # the reference's dim**-0.5 quirk
    xs = (_cbn(x, p["conv_cl"]) + p["pos_cl"]).reshape(n, h * w, c)
    ms = (_cbn(x, p["conv_seg"]) + p["pos_seg"]).reshape(n, h * w, c)
    layers = p["layers"]
    for i, lp in enumerate(layers):
        xn, mn = _layernorm(xs, lp["x_att_norm"]), _layernorm(ms, lp["m_att_norm"])
        m_mid = (_attention(mn, lp["attention2"], heads, scale)
                 + _cross(mn, xn, lp["cross_attention_cl"], heads, scale) + ms)
        if i + 1 < len(layers):             # the last layer's x stream is unused
            x_mid = (_attention(xn, lp["attention1"], heads, scale)
                     + _cross(xn, mn, lp["cross_attention_cl"], heads, scale) + xs)
            xs = x_mid + _feed(_layernorm(x_mid, lp["x_mlp_norm"]), lp["x_feed"])
        ms = m_mid + _feed(_layernorm(m_mid, lp["m_mlp_norm"]), lp["m_feed"])
    return ms.reshape(n, h, w, c)


def unet_trunk(P: Params, x: torch.Tensor, *, fused_up2: bool = False,
               fused_up34: bool = False, fused_down1: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Everything before the up1 level: (N, H, W, 3) -> (up2's output
    (N, H/2, W/2, 64), the inc features x1 (N, H, W, 64)). With every knob
    off it is all plain ops; fused_down1 runs pool + down1 on its kernel,
    fused_up34 up4 and up3 on the gate and level kernels, fused_up2 up2."""
    x1 = _cbn(x, P["inc"])
    if fused_down1:
        h = pool_down1(x1.contiguous(), _laid_out(P, "down1_kernels", "fused_down1"))
    else:
        h = max_pool2d(x1, 2)
        for wb in P["down"][0]:
            h = _cbn(h, wb)
    feats = [x1, h]
    for blocks in P["down"][1:]:
        h = max_pool2d(h, 2)
        for wb in blocks:
            h = _cbn(h, wb)
        feats.append(h)
    y = _transformer(feats[4], P["task2"])
    for name, skip, fused in (("up4", feats[3], fused_up34), ("up3", feats[2], fused_up34),
                              ("up2", feats[1], fused_up2)):
        y = _up_fused(y, skip, P, name) if fused else _up_alig(y, skip, P[name])
    return y, x1


def unet_forward(P: Params, x: torch.Tensor, *, fused_up2: bool = False,
                 fused_up34: bool = False, fused_down1: bool = False) -> torch.Tensor:
    """(N, H, W, 3) in P's dtype -> (N, H, W, n_classes) logits; up1 and the
    head run on the kernels, and the knobs move more levels onto kernels
    (`unet_trunk`), as the JAX engine's `unet_forward_packed` does. A knob
    that is on needs P from fold_unet with the same knob on."""
    y, x1 = unet_trunk(P, x, fused_up2=fused_up2, fused_up34=fused_up34,
                       fused_down1=fused_down1)
    return _up1_kernels(y.contiguous(), x1.contiguous(), P)


# ------------------------------------------------------------------ GoogLeNet


@torch.no_grad()
def fold_gnet(model: GoogLeNetClassifier, dtype=torch.float32) -> Params:
    """Folded, cast weights of a GoogLeNetClassifier (BN eps 1e-3)."""
    g = model.googlenet
    basic = lambda b: _cast(_fold(b.conv, b.bn), dtype)
    P: Params = {"dtype": dtype, "conv1": basic(g.conv1), "conv2": basic(g.conv2),
                 "conv3": basic(g.conv3), "fc": _lin(g.fc, dtype)}
    for name in INCEPTION_CFG:
        m = getattr(g, name)
        P[name] = {"b1": basic(m.branch1), "b2_0": basic(m.branch2[0]),
                   "b2_1": basic(m.branch2[1]), "b3_0": basic(m.branch3[0]),
                   "b3_1": basic(m.branch3[1]), "b4_1": basic(m.branch4[1])}
    return P


def _inception(x: torch.Tensor, p: Params) -> torch.Tensor:
    b1 = _cbn(x, p["b1"], 0)
    b2 = _cbn(_cbn(x, p["b2_0"], 0), p["b2_1"], 1)
    b3 = _cbn(_cbn(x, p["b3_0"], 0), p["b3_1"], 1)
    b4 = _cbn(max_pool2d(x, 3, 1, padding=1, ceil_mode=True), p["b4_1"], 0)
    return torch.cat([b1, b2, b3, b4], dim=-1)


def gnet_forward(P: Params, x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) crops in [0, 1], P's dtype -> (N, num_classes) logits."""
    x = transform_input(x, dim=-1)
    x = torch.relu(conv2d(x, *P["conv1"], stride=2, padding=3))
    x = max_pool2d(x, 3, 2, ceil_mode=True)
    x = _cbn(_cbn(x, P["conv2"], 0), P["conv3"], 1)
    x = max_pool2d(x, 3, 2, ceil_mode=True)
    x = _inception(_inception(x, P["inception3a"]), P["inception3b"])
    x = max_pool2d(x, 3, 2, ceil_mode=True)
    for name in ("inception4a", "inception4b", "inception4c", "inception4d", "inception4e"):
        x = _inception(x, P[name])
    x = max_pool2d(x, 2, 2, ceil_mode=True)
    x = _inception(_inception(x, P["inception5a"]), P["inception5b"])
    return F.linear(x.mean(dim=(1, 2)), *P["fc"])
