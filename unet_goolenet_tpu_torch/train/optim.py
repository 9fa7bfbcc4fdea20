"""Optimizer, plateau schedule and early stopping of the reference recipe.

Counterpart of `unet_goolenet_tpu/train/optim.py` (reference 分割/main.py:
240-243, 252-290):
  * AdamW(lr 1e-4, betas (0.9, 0.999), eps 1e-8, weight decay 0.01): torch's
    AdamW has optax.adamw's update rule (bias-corrected moments, decoupled
    decay on every parameter);
  * ReduceLROnPlateau(mode min, factor 0.1, patience 10, threshold 1e-3
    absolute, min_lr 1e-5), stepped on the epoch's TRAIN loss (a reference
    quirk), as a plain state (`plateau_init` / `plateau_step`);
  * early stopping with the reference's patience extension.
"""

from __future__ import annotations

from typing import Iterable, NamedTuple

import torch


def make_adamw(params: Iterable[torch.nn.Parameter], learning_rate: float = 1e-4,
               weight_decay: float = 0.01) -> torch.optim.AdamW:
    return torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


class PlateauState(NamedTuple):
    lr: float       # current learning rate
    best: float     # lowest loss seen
    num_bad: int    # epochs since an improvement


def _f32(v: float) -> float:
    return float(torch.tensor(v, dtype=torch.float32))


def plateau_init(base_lr: float) -> PlateauState:
    return PlateauState(lr=_f32(base_lr), best=float("inf"), num_bad=0)


def plateau_step(state: PlateauState, loss: float, *, factor: float = 0.1, patience: int = 10,
                 threshold: float = 1e-3, min_lr: float = 1e-5) -> PlateauState:
    """One scheduler step (torch ReduceLROnPlateau, mode 'min', threshold_mode
    'abs'), in float32 as the JAX state keeps it."""
    loss = _f32(loss)
    improved = loss < _f32(state.best - threshold)
    best = loss if improved else state.best
    num_bad = 0 if improved else state.num_bad + 1
    lr = state.lr
    if num_bad > patience:
        lr, num_bad = max(_f32(state.lr * factor), _f32(min_lr)), 0
    return PlateauState(lr=lr, best=best, num_bad=num_bad)


def set_learning_rate(opt: torch.optim.Optimizer, lr: float) -> None:
    """Write the (possibly plateau-reduced) lr into every parameter group."""
    for group in opt.param_groups:
        group["lr"] = float(lr)


class EarlyStopper:
    """Early stopping with the reference's patience-extension quirk
    (main.py:269-290): the counter runs on best-val-loss improvements; past
    `patience`, stop only if lr < lr_threshold, else roll the counter back by
    `extension` ("My patience ended, but I believe I need more time")."""

    def __init__(self, patience: int = 50, lr_threshold: float = 1e-4, extension: int = 20):
        self.patience = patience
        self.lr_threshold = lr_threshold
        self.extension = extension
        self.counter = 0
        self.best_loss = float("inf")

    def update(self, val_loss: float, current_lr: float) -> bool:
        """True when training should stop."""
        if val_loss < self.best_loss:
            self.best_loss = val_loss
            self.counter = 0
            return False
        self.counter += 1
        if self.counter > self.patience:
            if current_lr >= self.lr_threshold:
                self.counter -= self.extension
                return False
            return True
        return False
