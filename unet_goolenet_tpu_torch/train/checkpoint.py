"""Checkpoints with the reference's retention policy (分割/main.py:269-300).

Counterpart of `unet_goolenet_tpu/train/checkpoint.py`: a best-val-loss
snapshot and a best-metric snapshot, each replacing the previous one (its
file is deleted), an optional every-N-epochs snapshot kept for good, and
`restore`, which the reference lacks, for `--resume` and `--warm-start`. A
snapshot is one `torch.save` file (the port's own format, not orbax's):
{"model": state dict, "optimizer": AdamW state dict, "epoch": int}. A state
is any (model, opt) pair: the seg trainer's SegState or the classifier's
ClsState.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple, TypeVar

import torch

# SegState, ClsState: what the manager reads and writes, .model and .opt
State = TypeVar("State", bound=Tuple[torch.nn.Module, torch.optim.Optimizer])


class CheckpointManager:
    def __init__(self, directory: str, *, periodic_every: Optional[int] = None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.periodic_every = periodic_every
        self._best_loss_path: Optional[str] = None
        self._best_metric_path: Optional[str] = None

    def _save(self, path: str, state: State, epoch: int) -> str:
        tmp = f"{path}.tmp"
        torch.save({"model": state.model.state_dict(), "optimizer": state.opt.state_dict(),
                    "epoch": int(epoch)}, tmp)
        os.replace(tmp, path)
        return path

    @staticmethod
    def _remove(path: Optional[str]) -> None:
        if path and os.path.exists(path):
            os.remove(path)

    def save_best_loss(self, state: State, epoch: int) -> str:
        """A new best-val-loss snapshot; the previous one is deleted."""
        path = os.path.join(self.directory, f"best_model_epoch{epoch}.pt")
        self._remove(self._best_loss_path)
        self._best_loss_path = self._save(path, state, epoch)
        return path

    def save_best_metric(self, state: State, epoch: int, tag: str = "seg") -> str:
        """A new best-metric snapshot (dice for seg); the previous one is
        deleted."""
        path = os.path.join(self.directory, f"best_{tag}_model_epoch{epoch}.pt")
        self._remove(self._best_metric_path)
        self._best_metric_path = self._save(path, state, epoch)
        return path

    def save_periodic(self, state: State, epoch: int) -> Optional[str]:
        """An every-N-epochs snapshot, kept for good."""
        if self.periodic_every and epoch % self.periodic_every == 0:
            return self._save(os.path.join(self.directory, f"model_epoch{epoch}.pt"), state,
                              epoch)
        return None

    def restore(self, path: str, state: State) -> Tuple[State, int]:
        """Load a snapshot into `state` (in place, onto its model's device);
        returns (state, the snapshot's epoch)."""
        dev = next(state.model.parameters()).device
        payload = torch.load(path, map_location=dev, weights_only=True)
        state.model.load_state_dict(payload["model"])
        state.opt.load_state_dict(payload["optimizer"])
        return state, int(payload["epoch"])

    def latest_best(self) -> Optional[str]:
        return self._best_loss_path
