"""State dicts for the port's models.

* `load_reference_state_dict(path, model)` loads a checkpoint with the
  reference's torch names into a port model: the port trainer's snapshot
  (`{'model': state_dict, ...}`, train/checkpoint.py), the reference's
  `{'net': state_dict}` or a bare state dict. The reference's
  declared-but-never-called parameters are dropped first (fc1/fc2 of
  UNetTaskAligWeight, CoordAtt3's `deformabel`, the transformer's
  `cross_attention_seg`), and so are GoogLeNet's aux heads when the model
  has none (they do not touch its eval output: a classifier trained with
  `--aux-weight` serves without them); everything else loads strictly.
* `unet_from_jax(variables)` / `gnet_from_jax(variables)` invert the JAX
  package's converter (`unet_goolenet_tpu/models/convert.py`): its flax
  variables, given as nested dicts of numpy arrays, become a port state dict.
  HWIO -> OIHW, deconv (2, 2, Ci, Co) -> (Ci, Co, 2, 2), linear transposed,
  positional embeddings NHWC -> NCHW, `fc_out` -> `fc_avg_max_sfot`.
* `unet_to_jax(state_dict)` maps the port's UNet state back to JAX variables
  (numpy), so that a trained state can be compared with the JAX package's
  leaf by leaf.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from unet_goolenet_tpu_torch.models.googlenet import INCEPTION_CFG

_DEAD = re.compile(r"^(fc1|fc2)\.|\.deformabel\.|\.cross_attention_seg\.")
_AUX = re.compile(r"^googlenet\.aux[12]\.")


def load_reference_state_dict(path: str, model: nn.Module) -> nn.Module:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("model", "net"):   # a trainer snapshot, a reference checkpoint
        if isinstance(sd.get(key), dict):
            sd = sd[key]
            break
    own = model.state_dict()
    model.load_state_dict({k: v for k, v in sd.items()
                           if not (_DEAD.search(k) or (_AUX.match(k) and k not in own))},
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


# how a torch tensor maps onto its flax leaf: (to torch, to flax)
_LAYOUTS = {
    "same": (lambda a: a, lambda a: a),
    "conv": (lambda a: np.transpose(a, (3, 2, 0, 1)), lambda a: np.transpose(a, (2, 3, 1, 0))),
    "linear": (np.transpose, np.transpose),
    "deconv": (lambda a: np.transpose(a, (2, 3, 0, 1)), lambda a: np.transpose(a, (2, 3, 0, 1))),
    "pos": (lambda a: np.transpose(a, (0, 3, 1, 2)), lambda a: np.transpose(a, (0, 2, 3, 1))),
}


def _unet_leaves(depth: int):
    """(torch key, flax collection, flax path, layout) of every UNet leaf."""
    out = []

    def conv(key, path, bias=True, layout="conv"):
        out.append((f"{key}.weight", "params", (*path, "kernel"), layout))
        if bias:
            out.append((f"{key}.bias", "params", (*path, "bias"), "same"))

    def bn(key, path):
        out.append((f"{key}.weight", "params", (*path, "scale"), "same"))
        out.append((f"{key}.bias", "params", (*path, "bias"), "same"))
        out.append((f"{key}.running_mean", "batch_stats", (*path, "mean"), "same"))
        out.append((f"{key}.running_var", "batch_stats", (*path, "var"), "same"))

    def cbn(key, path):
        conv(f"{key}.conv", (*path, "conv", "conv"))
        bn(f"{key}.norm", (*path, "norm"))

    cbn("inc", ("trunk", "inc"))
    for i in range(1, 5):
        for k in range(2):
            cbn(f"down{i}.nConvs.{k}", ("trunk", f"down{i}", "nConvs", f"block{k}"))
    for stream in ("cl", "seg"):
        conv(f"task2.conv_{stream}.0", ("task2", f"conv_{stream}_conv", "conv"), bias=False)
        bn(f"task2.conv_{stream}.1", ("task2", f"conv_{stream}_bn"))
        out.append((f"task2.pos_embedding_decoder_{stream}", "params",
                    ("task2", f"pos_embedding_{stream}"), "pos"))
    for k in range(depth):
        pre, lp = f"task2.layers.{k}", ("task2", f"layer{k}")
        for att in ("attention1", "attention2"):
            conv(f"{pre}.{att}.to_qkv", (*lp, att, "to_qkv"), bias=False, layout="linear")
            conv(f"{pre}.{att}.to_out.0", (*lp, att, "to_out"), layout="linear")
        for nm in ("to_q", "to_k", "to_v"):
            conv(f"{pre}.cross_attention_cl.{nm}", (*lp, "cross_attention_cl", nm), bias=False,
                 layout="linear")
        conv(f"{pre}.cross_attention_cl.to_out.0", (*lp, "cross_attention_cl", "to_out"),
             layout="linear")
        for nm in ("x_att_norm", "m_att_norm", "x_mlp_norm", "m_mlp_norm"):
            out.append((f"{pre}.{nm}.weight", "params", (*lp, nm, "scale"), "same"))
            out.append((f"{pre}.{nm}.bias", "params", (*lp, nm, "bias"), "same"))
        for ff in ("x_feed", "m_feed"):
            conv(f"{pre}.{ff}.net.0", (*lp, ff, "fc1"), layout="linear")
            conv(f"{pre}.{ff}.net.3", (*lp, ff, "fc2"), layout="linear")
    for i in range(1, 5):
        u = f"up{i}"
        conv(f"{u}.up", (u, "up"), layout="deconv")
        for e in ("conv1_e", "conv2_e"):
            cbn(f"{u}.cca.{e}.0", (u, "cca", e, "block0"))
        conv(f"{u}.cca.fc_avg", (u, "cca", "fc_avg", "conv"))
        conv(f"{u}.cca.fc_max", (u, "cca", "fc_max", "conv"))
        conv(f"{u}.cca.fc_avg_max_sfot", (u, "cca", "fc_out", "conv"))
        for k in range(2):
            cbn(f"{u}.nConvs.{k}", (u, "nConvs", f"block{k}"))
    conv("outc", ("outc", "conv"))
    return out


def unet_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX UNetTaskAligWeight variables -> port UNetTaskAligWeight state dict."""
    depth = 0
    while f"layer{depth}" in variables["params"]["task2"]:
        depth += 1
    sd: Dict[str, torch.Tensor] = {}
    for key, coll, path, layout in _unet_leaves(depth):
        node = variables[coll]
        for name in path:
            node = node[name]
        sd[key] = torch.tensor(_LAYOUTS[layout][0](np.asarray(node, np.float32)))
        if key.endswith(".running_var"):
            sd[key[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    return sd


def unet_to_jax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Port UNetTaskAligWeight state dict -> JAX variables {"params",
    "batch_stats"} as nested dicts of float32 numpy arrays (the inverse of
    `unet_from_jax`), so that a state can be compared leaf by leaf."""
    depth = len({k.split(".")[2] for k in state_dict if k.startswith("task2.layers.")})
    variables: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    for key, coll, path, layout in _unet_leaves(depth):
        node = variables[coll]
        for name in path[:-1]:
            node = node.setdefault(name, {})
        arr = state_dict[key].detach().cpu().float().numpy()
        node[path[-1]] = np.ascontiguousarray(_LAYOUTS[layout][1](arr))
    return variables


def gnet_from_jax(variables: Dict[str, Any], aux: bool = False) -> Dict[str, torch.Tensor]:
    """JAX GoogLeNetClassifier variables -> port GoogLeNetClassifier state
    dict; aux=True carries the aux heads across too, as
    `convert_googlenet_classifier(aux=True)` does the other way."""
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
    if aux:
        for head in ("aux1", "aux2"):
            basic(f"{head}.conv", p[head]["conv"], s[head]["conv"])
            o.linear(f"googlenet.{head}.fc1", p[head]["fc1"])
            o.linear(f"googlenet.{head}.fc2", p[head]["fc2"])
    o.linear("googlenet.fc", p["fc"])
    return o.sd
