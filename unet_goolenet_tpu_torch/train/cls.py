"""Stage-2 (classification) training: the refinement train step, the eval
step and the init.

Counterpart of `unet_goolenet_tpu/train/cls.py:28-116` (reference
分类/ROI_main.py:198-241) on one device. Each batch of ROI crops takes
n_refine = 2 AdamW updates, with the reference's classifier quirks:

  * the feedback is the frozen UNet's full-image logits (`se_out`, (N, S, S,
    1)), cast through int64 in the reference (`.long()`, ROI_main.py:207):
    truncated toward zero before pass 1's sigmoid (`long_cast_quirk`);
  * pass i > 0: temp = sigmoid(temp), re-applied every pass; conf_i =
    mean(|0.5 - temp_i| * 2) per image; crops = crops + temp * conf (the
    mask broadcasts over the 3 channels, and the crops compound). Unlike
    stage 1, temp is never replaced by the model's output;
  * the loss is a plain cross entropy (with `aux_weight > 0`, plus
    aux_weight times each aux head's, which needs the model built with aux
    heads);
  * dropout is live in train mode: its masks come from the generator the
    step is given, as the JAX step threads its dropout key.

Parameters whose gradient autograd leaves empty get a zero gradient, so
that AdamW decays them as optax does (as train/seg.py). `bf16=True` runs
each forward under CUDA autocast in bfloat16; parameters, optimizer state
and BatchNorm statistics stay float32.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch

from unet_goolenet_tpu_torch.models import GoogLeNetClassifier
from unet_goolenet_tpu_torch.train import optim
from unet_goolenet_tpu_torch.train.losses import (
    aux_weighted_cross_entropy, softmax_cross_entropy)
from unet_goolenet_tpu_torch.train.seg import _forward_ctx


class ClsState(NamedTuple):
    """The classifier trainer's state: the model (parameters and BatchNorm
    statistics) and its AdamW."""
    model: GoogLeNetClassifier
    opt: torch.optim.Optimizer


def init_cls_state(num_classes: int = 6, aux_logits: bool = False, lr: float = 1e-4,
                   device="cuda") -> ClsState:
    """A fresh GoogLeNetClassifier with torch's default init (from torch's
    global RNG: `seed_everything` seeds it), on `device`, in train mode, and
    its AdamW."""
    model = GoogLeNetClassifier(num_classes, aux_logits).to(device).train()
    return ClsState(model, optim.make_adamw(model.parameters(), lr))


def make_cls_train_step(state: ClsState, *, n_refine: int = 2, long_cast_quirk: bool = True,
                        aux_weight: float = 0.0, bf16: bool = False) -> Callable:
    """(crops (N, S, S, 3), labels (N,), se_out (N, S, S, 1), generator) ->
    {"loss": the mean of the passes' losses, a 0-d float32 tensor}; updates
    `state` in place."""
    model, opt = state
    if aux_weight > 0.0 and model.googlenet.aux1 is None:
        raise ValueError("aux_weight > 0 needs the model built with aux_logits=True")
    params = [p for p in model.parameters() if p.requires_grad]

    def one_pass(imgs: torch.Tensor, labels: torch.Tensor,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
        opt.zero_grad(set_to_none=True)
        with _forward_ctx(imgs.device, bf16):
            out = model(imgs, generator)
        if aux_weight > 0.0:
            main, aux2, aux1 = out
            loss = aux_weighted_cross_entropy(main, [aux1, aux2], labels,
                                              aux_weight=aux_weight)
        else:
            loss = softmax_cross_entropy(out, labels)
        loss.backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        opt.step()
        return loss.detach()

    def train_step(crops: torch.Tensor, labels: torch.Tensor, se_out: torch.Tensor,
                   generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        model.train()
        total = torch.zeros((), device=crops.device)
        temp = se_out.detach()
        if long_cast_quirk:
            temp = torch.trunc(temp)
        cur = crops
        for i in range(n_refine):
            if i > 0:
                temp = torch.sigmoid(temp)
                conf = ((0.5 - temp).abs() * 2.0).mean(dim=tuple(range(1, temp.ndim)),
                                                       keepdim=True)
                cur = cur + temp * conf
            total = total + one_pass(cur, labels, generator)
        return {"loss": total / n_refine}

    return train_step


def make_cls_eval_step(model: GoogLeNetClassifier, *, bf16: bool = False) -> Callable:
    """(crops, labels) -> (cross-entropy loss, logits (N, num_classes)): the
    model in eval mode (running statistics, no dropout, no aux heads), no
    gradients; the model's mode is restored after."""

    @torch.no_grad()
    def eval_step(crops: torch.Tensor, labels: torch.Tensor):
        was_training = model.training
        model.eval()
        with _forward_ctx(crops.device, bf16):
            out = model(crops)
        model.train(was_training)
        return softmax_cross_entropy(out, labels), out

    return eval_step
