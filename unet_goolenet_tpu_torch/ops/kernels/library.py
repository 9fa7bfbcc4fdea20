"""The five serving kernels as `torch.library` custom ops, namespace `ugt`.

    ugt::up1_gate(x, weights)              -> (e1, mean, max)   up1.up1_gate
    ugt::up1_tail(y, e1, gate1p, weights)  -> logits            up1.up1_tail
    ugt::up_gate_dense(x, weights)         -> (e1, mean, max)   up2.up_gate_dense
    ugt::up_level(x, e1, gate1p, weights)  -> out               up2.up_level
    ugt::pool_down1(x1, weights)           -> out               down1.pool_down1

An op is what `torch.export` keeps opaque: a traced graph holds one node a
call, whose fake implementation gives the outputs' shapes and dtypes from
the inputs' (the batch may be symbolic), and the loaded graph calls the op,
which launches the kernel. Nothing of a kernel's plan (`conv.conv_plan`,
`conv.level_plan`, `down1.down1_plans`) is chosen at trace time: the CUDA
implementation chooses it from each call's shapes.

  * CUDA: the kernel modules' launch (`up2.gate_launch`, `up2.level_launch`,
    `down1.pool_down1_launch`) with all its checks; it raises on any
    failure, and counts each call on the public wrapper's `.launches`.
  * CPU: the plain version (`*_ref`).

Which one runs is the dispatcher's choice by the tensors' device, as the
wrappers chose before: a CUDA tensor never reaches a plain version. Weights
cross the op boundary as a flat list: a `KernelWeights.kernel` tuple on a
card, `.plain` on the CPU (`KernelWeights.args`). The public wrappers call
these ops, so the live pipeline and an exported graph take one route. The
ops are functional (no argument is written, every output is new).

They are defined through `torch.library.Library` (`define`, `impl` for the
CPU and CUDA keys, `register_fake`) rather than the `custom_op` decorator,
whose first call in a process imports torch._dynamo (2.1 s on a CPU host)
and whose calls cost 31 us against 13 here (CPU, torch 2.13).

Importing the kernel package (`ops/kernels/__init__.py`) registers the
ops. This module imports torch and the kernel modules only: a loaded
artifact needs it, and no model code.
"""

from __future__ import annotations

import torch

from unet_goolenet_tpu_torch.ops.kernels import down1, up1, up2

NAMESPACE = "ugt"
STATS = torch.float32          # the gate's mean and max, whatever the input dtype

_LIB = torch.library.Library(NAMESPACE, "DEF")


def _define(name: str, schema: str, cuda, cpu, fake) -> None:
    """Define ugt::name(schema) with its CUDA, CPU and fake implementations."""
    _LIB.define(name + schema)
    _LIB.impl(name, cuda, "CUDA")
    _LIB.impl(name, cpu, "CPU")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)


def _gate_fake(x, weights):
    n, c = x.shape[0], x.shape[-1]
    return (torch.empty_like(x), x.new_empty((n, c), dtype=STATS),
            x.new_empty((n, c), dtype=STATS))


def _level_fake(x, cout):
    n, h2, w2 = x.shape[:3]
    return x.new_empty((n, 2 * h2, 2 * w2, cout))


# ------------------------------------------------------------------ up1


def _up1_gate(x1, weights):
    up1.check_channels(x1)
    out = up2.gate_launch("up1_gate", x1, weights)
    up1.up1_gate.launches += 1
    return out


def _up1_tail(y, e1, gate1p, weights):
    up1.check_channels(y)
    out = up2.level_launch("up1_tail", y, e1, gate1p, weights)
    up1.up1_tail.launches += 1
    return out


GATE = "(Tensor x, Tensor[] weights) -> (Tensor, Tensor, Tensor)"
LEVEL = "(Tensor x, Tensor e1, Tensor gate1p, Tensor[] weights) -> Tensor"

_define("up1_gate", GATE, _up1_gate, lambda x1, weights: up1.up1_gate_ref(x1, *weights),
        _gate_fake)
_define("up1_tail", LEVEL, _up1_tail,
        lambda y, e1, gate1p, weights: up1.up1_tail_ref(y, e1, gate1p, *weights),
        # b_outc, the last weight in both layouts, has ncls rows
        lambda y, e1, gate1p, weights: _level_fake(y, weights[9].shape[0]))


# ------------------------------------------------------------------ up2-up4


def _up_gate_dense(x, weights):
    out = up2.gate_launch("up_gate_dense", x, weights)
    up2.up_gate_dense.launches += 1
    return out


def _up_level(x, e1, gate1p, weights):
    out = up2.level_launch("up_level", x, e1, gate1p, weights)
    up2.up_level.launches += 1
    return out


_define("up_gate_dense", GATE, _up_gate_dense,
        lambda x, weights: up2.up_gate_dense_ref(x, *weights), _gate_fake)
_define("up_level", LEVEL, _up_level,
        lambda x, e1, gate1p, weights: up2.up_level_ref(x, e1, gate1p, *weights),
        # b_pair, the sixth weight in both layouts, has cq rows
        lambda x, e1, gate1p, weights: _level_fake(x, weights[5].shape[0]))


# ------------------------------------------------------------------ pool + down1


def _pool_down1(x1, weights):
    out = down1.pool_down1_launch(x1, weights)
    down1.pool_down1.launches += 1
    return out


def _pool_down1_fake(x1, weights):
    n, h2, w2 = x1.shape[:3]
    return x1.new_empty((n, h2 // 2, w2 // 2, weights[1].shape[0]))   # b1: co, both layouts


_define("pool_down1", "(Tensor x1, Tensor[] weights) -> Tensor", _pool_down1,
        lambda x1, weights: down1.pool_down1_ref(x1, *weights), _pool_down1_fake)
