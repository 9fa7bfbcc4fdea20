"""Structured metric logging: a human-readable line per step on stdout and,
with a log dir, one JSON object per step in `<log_dir>/<run_name>.jsonl`.

Counterpart of `unet_goolenet_tpu/utils/logging.py` (without its optional
TensorBoard writer)."""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricLogger:
    def __init__(self, log_dir: Optional[str] = None, run_name: str = "run"):
        self.path = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self.path = os.path.join(log_dir, f"{run_name}.jsonl")
        self._t0 = time.time()

    def log(self, step: int, **metrics) -> None:
        scalars = {k: (float(v) if hasattr(v, "__float__") else v) for k, v in metrics.items()
                   if getattr(v, "ndim", 0) == 0}
        msg = " ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                       for k, v in scalars.items())
        print(f"[step {step}] {msg}", flush=True)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps({"step": step, "time": time.time() - self._t0, **scalars})
                        + "\n")
