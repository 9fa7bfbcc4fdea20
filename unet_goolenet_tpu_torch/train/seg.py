"""Stage-1 (segmentation) training: the iterative-refinement train step.

Counterpart of `unet_goolenet_tpu/train/seg.py:34-171` (reference
分割/main.py:149-189) with the flax forward, on one device. Each batch takes
n_refine = 2 optimizer updates:

  pass 0: out0 = model(imgs); loss; AdamW update        (params p0 -> p1)
  pass 1: temp = sigmoid(out0.detach())                  (re-sigmoided every
          conf_i = mean(|0.5 - temp_i| * 2) per image     later pass)
          imgs = imgs + temp * conf                      (compounds)
          out1 = model_p1(imgs); loss; AdamW update      (p1 -> p2)

BatchNorm's running statistics advance through both passes (flax's update,
nn/blocks.py). The step returns {"loss": mean of the passes' losses,
"seg_loss": their sum}, as the reference prints them. Parameters whose
gradient autograd leaves empty (the cl stream's last layers, which never
reach the seg logits) get a zero gradient, so that AdamW decays them as
optax does. `bf16=True` runs each forward under CUDA autocast in bfloat16:
parameters, optimizer state and BatchNorm statistics stay float32.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, NamedTuple, Tuple

import torch

from unet_goolenet_tpu_torch.models import UNetTaskAligWeight
from unet_goolenet_tpu_torch.train import optim
from unet_goolenet_tpu_torch.train.losses import dc_and_bce_loss


class SegState(NamedTuple):
    """The trainer's state: the model (parameters and BatchNorm statistics)
    and its optimizer (AdamW moments and step count)."""
    model: UNetTaskAligWeight
    opt: torch.optim.Optimizer


def init_seg_state(*, img_size: int = 224, lr: float = 1e-4, kernels: bool = False,
                   device="cuda") -> SegState:
    """A fresh UNetTaskAligWeight(n_classes=1) with torch's default init
    (the reference's, from torch's global RNG: `seed_everything` seeds it),
    on `device`, in train mode, and its AdamW."""
    model = UNetTaskAligWeight(1, img_size=img_size, kernels=kernels).to(device).train()
    return SegState(model, optim.make_adamw(model.parameters(), lr))


def _forward_ctx(device: torch.device, bf16: bool):
    if bf16 and device.type == "cuda":
        return torch.autocast("cuda", dtype=torch.bfloat16)
    return contextlib.nullcontext()


def make_seg_train_step(state: SegState, *, loss_fn: Callable = dc_and_bce_loss,
                        n_refine: int = 2, bf16: bool = False) -> Callable:
    """(imgs (N, H, W, 3), labels (N, H, W, 1)) -> metrics dict of 0-d
    float32 tensors; updates `state` in place."""
    model, opt = state
    params = [p for p in model.parameters() if p.requires_grad]

    def one_pass(imgs: torch.Tensor, labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        opt.zero_grad(set_to_none=True)
        with _forward_ctx(imgs.device, bf16):
            out = model(imgs)
        loss = loss_fn(out, labels)
        loss.backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        opt.step()
        return loss.detach(), out.detach()

    def train_step(imgs: torch.Tensor, labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        model.train()
        total = torch.zeros((), device=imgs.device)
        temp, cur = None, imgs
        for i in range(n_refine):
            if i > 0:
                temp = torch.sigmoid(temp)
                conf = ((0.5 - temp).abs() * 2.0).mean(dim=tuple(range(1, temp.ndim)),
                                                       keepdim=True)
                cur = cur + temp * conf
            loss, out = one_pass(cur, labels)
            if i == 0:
                temp = out
            total = total + loss
        return {"loss": total / n_refine, "seg_loss": total}

    return train_step


def make_seg_eval_step(model: UNetTaskAligWeight, *, loss_fn: Callable = dc_and_bce_loss,
                       bf16: bool = False) -> Callable:
    """(imgs, labels) -> (loss 0-d tensor, masks (N, H, W, 1) float32 in
    {0, 1}): the model in eval mode (running statistics), no gradients."""

    @torch.no_grad()
    def eval_step(imgs: torch.Tensor, labels: torch.Tensor):
        was_training = model.training
        model.eval()
        with _forward_ctx(imgs.device, bf16):
            out = model(imgs)
        model.train(was_training)
        return loss_fn(out, labels), (torch.sigmoid(out.float()) > 0.5).float()

    return eval_step
