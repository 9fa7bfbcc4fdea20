"""State dicts for the port's models.

* `load_reference_state_dict(path, model)` loads a reference checkpoint
  (`{'net': state_dict}` or a bare state dict, reference torch names) into a
  port model. The reference's declared-but-never-called parameters are
  dropped first (fc1/fc2 of UNetTaskAligWeight, CoordAtt3's `deformabel`,
  the transformer's `cross_attention_seg`); everything else loads strictly.
* `unet_from_jax(variables)` / `gnet_from_jax(variables)` invert the JAX
  package's converter (`unet_goolenet_tpu/models/convert.py`): its flax
  variables, given as nested dicts of numpy arrays, become a port state dict.
  HWIO -> OIHW, deconv (2, 2, Ci, Co) -> (Ci, Co, 2, 2), linear transposed,
  positional embeddings NHWC -> NCHW, `fc_out` -> `fc_avg_max_sfot`.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from unet_goolenet_tpu_torch.models.googlenet import INCEPTION_CFG

_DEAD = re.compile(r"^(fc1|fc2)\.|\.deformabel\.|\.cross_attention_seg\.")


def load_reference_state_dict(path: str, model: nn.Module) -> nn.Module:
    payload = torch.load(path, map_location="cpu", weights_only=True)
    sd = payload["net"] if isinstance(payload, dict) and "net" in payload else payload
    model.load_state_dict({k: v for k, v in sd.items() if not _DEAD.search(k)},
                          strict=True)
    return model


class _Out:
    """Collects torch-named tensors from a flax variables tree."""

    def __init__(self, variables: Dict[str, Any]):
        self.p, self.s = variables["params"], variables["batch_stats"]
        self.sd: Dict[str, torch.Tensor] = {}

    def put(self, key: str, arr) -> None:
        self.sd[key] = torch.tensor(np.asarray(arr, np.float32))

    def conv(self, key: str, node, bias: bool = True) -> None:
        self.put(f"{key}.weight", np.transpose(node["kernel"], (3, 2, 0, 1)))
        if bias:
            self.put(f"{key}.bias", node["bias"])

    def linear(self, key: str, node, bias: bool = True) -> None:
        self.put(f"{key}.weight", np.transpose(node["kernel"]))
        if bias:
            self.put(f"{key}.bias", node["bias"])

    def bn(self, key: str, p, s) -> None:
        self.put(f"{key}.weight", p["scale"])
        self.put(f"{key}.bias", p["bias"])
        self.put(f"{key}.running_mean", s["mean"])
        self.put(f"{key}.running_var", s["var"])
        self.sd[f"{key}.num_batches_tracked"] = torch.tensor(0)

    def cbn(self, key: str, p, s) -> None:
        self.conv(f"{key}.conv", p["conv"]["conv"])
        self.bn(f"{key}.norm", p["norm"], s["norm"])


def unet_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX UNetTaskAligWeight variables -> port UNetTaskAligWeight state dict."""
    o = _Out(variables)
    p, s = o.p, o.s
    o.cbn("inc", p["trunk"]["inc"], s["trunk"]["inc"])
    for i in range(1, 5):
        d, ds = p["trunk"][f"down{i}"]["nConvs"], s["trunk"][f"down{i}"]["nConvs"]
        for k in range(2):
            o.cbn(f"down{i}.nConvs.{k}", d[f"block{k}"], ds[f"block{k}"])
    t, ts = p["task2"], s["task2"]
    for stream in ("cl", "seg"):
        o.conv(f"task2.conv_{stream}.0", t[f"conv_{stream}_conv"]["conv"], bias=False)
        o.bn(f"task2.conv_{stream}.1", t[f"conv_{stream}_bn"], ts[f"conv_{stream}_bn"])
        o.put(f"task2.pos_embedding_decoder_{stream}",
              np.transpose(t[f"pos_embedding_{stream}"], (0, 3, 1, 2)))
    k = 0
    while f"layer{k}" in t:
        lp, pre = t[f"layer{k}"], f"task2.layers.{k}"
        for att in ("attention1", "attention2"):
            o.linear(f"{pre}.{att}.to_qkv", lp[att]["to_qkv"], bias=False)
            o.linear(f"{pre}.{att}.to_out.0", lp[att]["to_out"])
        for nm in ("to_q", "to_k", "to_v"):
            o.linear(f"{pre}.cross_attention_cl.{nm}", lp["cross_attention_cl"][nm], bias=False)
        o.linear(f"{pre}.cross_attention_cl.to_out.0", lp["cross_attention_cl"]["to_out"])
        for nm in ("x_att_norm", "m_att_norm", "x_mlp_norm", "m_mlp_norm"):
            o.put(f"{pre}.{nm}.weight", lp[nm]["scale"])
            o.put(f"{pre}.{nm}.bias", lp[nm]["bias"])
        for ff in ("x_feed", "m_feed"):
            o.linear(f"{pre}.{ff}.net.0", lp[ff]["fc1"])
            o.linear(f"{pre}.{ff}.net.3", lp[ff]["fc2"])
        k += 1
    for i in range(1, 5):
        u, us = p[f"up{i}"], s[f"up{i}"]
        o.put(f"up{i}.up.weight", np.transpose(u["up"]["kernel"], (2, 3, 0, 1)))
        o.put(f"up{i}.up.bias", u["up"]["bias"])
        c, cs = u["cca"], us["cca"]
        o.cbn(f"up{i}.cca.conv1_e.0", c["conv1_e"]["block0"], cs["conv1_e"]["block0"])
        o.cbn(f"up{i}.cca.conv2_e.0", c["conv2_e"]["block0"], cs["conv2_e"]["block0"])
        o.conv(f"up{i}.cca.fc_avg", c["fc_avg"]["conv"])
        o.conv(f"up{i}.cca.fc_max", c["fc_max"]["conv"])
        o.conv(f"up{i}.cca.fc_avg_max_sfot", c["fc_out"]["conv"])
        for k in range(2):
            o.cbn(f"up{i}.nConvs.{k}", u["nConvs"][f"block{k}"], us["nConvs"][f"block{k}"])
    o.conv("outc", p["outc"]["conv"])
    return o.sd


def gnet_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX GoogLeNetClassifier variables -> port GoogLeNetClassifier state dict."""
    o = _Out(variables)
    p, s = o.p["googlenet"], o.s["googlenet"]

    def basic(key, pp, ss):
        o.conv(f"googlenet.{key}.conv", pp["conv"]["conv"], bias=False)
        o.bn(f"googlenet.{key}.bn", pp["bn"], ss["bn"])

    for nm in ("conv1", "conv2", "conv3"):
        basic(nm, p[nm], s[nm])
    branches = {"branch1": "branch1", "branch2_0": "branch2.0", "branch2_1": "branch2.1",
                "branch3_0": "branch3.0", "branch3_1": "branch3.1", "branch4_1": "branch4.1"}
    for inc in INCEPTION_CFG:
        for jname, tname in branches.items():
            basic(f"{inc}.{tname}", p[inc][jname], s[inc][jname])
    o.linear("googlenet.fc", p["fc"])
    return o.sd
