"""Device-resident stage-2 epoch runner.

Counterpart of `unet_goolenet_tpu/train/epoch.py:23-52`
(`make_cls_epoch_runner`). The JAX package scans the train step over the
epoch in one compiled program; here it is a Python loop over tensors that
already lie on the device, so no batch crosses from the host during the
epoch: a permutation drawn from the generator, truncated to whole batches
(drop-last), then the steps in order, each drawing its dropout masks from
the same generator in turn.
"""

from __future__ import annotations

from typing import Callable

import torch


def make_cls_epoch_runner(train_step: Callable, batch_size: int) -> Callable:
    """run_epoch(crops (M, S, S, 3), labels (M,), se_out (M, S, S, 1),
    generator) -> the mean of the steps' losses (0-d tensor). train_step is
    a `make_cls_train_step` step, which updates its state in place."""

    def run_epoch(crops: torch.Tensor, labels: torch.Tensor, se_out: torch.Tensor,
                  generator: torch.Generator) -> torch.Tensor:
        n_batches = crops.shape[0] // batch_size
        if n_batches == 0:
            raise ValueError(f"{crops.shape[0]} crops make no batch of {batch_size}")
        perm = torch.randperm(crops.shape[0], generator=generator, device=generator.device)
        perm = perm[: n_batches * batch_size].to(crops.device)
        losses = [train_step(crops[idx], labels[idx], se_out[idx], generator)["loss"]
                  for idx in perm.view(n_batches, batch_size)]
        return torch.stack(losses).mean()

    return run_epoch
