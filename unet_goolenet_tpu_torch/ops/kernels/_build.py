"""Build the port's CUDA kernels with nvcc and load them with ctypes.

All `csrc/*.cu` files compile into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds). Each source is
compiled by its own nvcc process, all started together, and the objects are
linked into one library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas=-v -c -o <obj> csrc/<name>.cu     (each)
    nvcc ... -shared -o build/kernels/libugt_<hash>.so <objs>

The build runs at first use, into `build/kernels/` beside the package, keyed
by a hash of the sources and flags; ptxas's register and shared-memory report
is kept next to the library as `<name>.log`. A failed build raises with
nvcc's stderr. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path() -> Path:
    """Path of the library for the current sources (built or not)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    return BUILD_DIR / f"libugt_{digest.hexdigest()[:16]}.so"


def _check(proc: subprocess.Popen, cmd, stderr: str) -> None:
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                           f"{' '.join(cmd)}\n{stderr}")


def build() -> Path:
    """Compile csrc/*.cu unless the library for these sources exists: one
    nvcc per source, all started together, then one link."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        cmd = [nvcc, *compile_flags, "-c", "-o", str(BUILD_DIR / f"{tag}.{src.stem}.o"), str(src)]
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE, text=True)))
    logs = [proc.communicate()[1] for _, proc in jobs]   # every nvcc has ended
    for (cmd, proc), stderr in zip(jobs, logs):
        _check(proc, cmd, stderr)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *(cmd[cmd.index("-o") + 1] for cmd, _ in jobs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    _check(proc, cmd, proc.stderr)
    for cmd, _ in jobs:
        os.remove(cmd[cmd.index("-o") + 1])
    out.with_suffix(".log").write_text("".join(logs))
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
        return _lib
