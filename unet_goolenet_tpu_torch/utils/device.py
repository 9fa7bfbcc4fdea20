"""Where and how the serving calls run: `check_device` refuses a CUDA
device on a host without one (nothing falls back to the CPU), and
`inference` runs a call in inference mode with TF32 off. The pipeline
(pipeline/two_stage.py) and a loaded serving artifact (pipeline/export.py)
both use them; they live here so that the artifact's loader needs no
model code.
"""

from __future__ import annotations

import functools

import torch


def inference(fn):
    """Run fn in inference mode with TF32 off, and restore the TF32 flags
    after: PyTorch lets cuDNN convs use TF32 for float32 by default."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        try:
            with torch.inference_mode():
                return fn(*args, **kwargs)
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    return run


def check_device(device) -> torch.device:
    """torch.device(device); raises for a CUDA device when there is none,
    so that nothing falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r}: no CUDA device is available; "
                           "pass device='cpu' to run on the CPU")
    return dev
