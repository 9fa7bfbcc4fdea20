"""Determinism helpers (reference: seed_everything, 分割/main.py:194-202).

Counterpart of `unet_goolenet_tpu/utils/seed.py`: seeds Python's random,
numpy's global RNG and torch's (CPU and every card), and returns a
torch.Generator seeded the same, where the JAX package returns its root
PRNG key.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def seed_everything(seed: int = 1234) -> torch.Generator:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)
