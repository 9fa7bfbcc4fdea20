"""Deployment export and load of the serving graph (`torch.export`).

Counterpart of `unet_goolenet_tpu/pipeline/export.py`. The reference's
"deployment" is re-running the training repo (分类/test.py:139-152: both
torch models loaded at import, eager Python per batch). Here the whole
serving graph (wavelet preprocess -> UNet -> bbox -> crop -> GoogLeNet ->
argmax), with the pipeline's folded weights, is traced once into a
directory that a serving host loads and runs without the model code:

    export_serving(pipe, "artifact/", raw_hw=(400, 500))   # build box
    runner = load_serving("artifact/")                     # serving box
    grades = runner(gray_batch)     # (N, H, W) any N -> (N,) int64 grades

Artifact layout:
    serving.pt2   torch.export.save of the ExportedProgram; its weights
                  inside, each its own contiguous tensor
    meta.json     source / raw_hw / img_size / dtype / device / versions

The hand-written kernels stay in the graph as the custom ops of
`ops/kernels/library.py` (`ugt::up1_gate`, `ugt::up1_tail`, and with the
fused-level knobs `ugt::up_gate_dense`, `ugt::up_level`,
`ugt::pool_down1`): the trace records one node a call, and the loaded
graph launches the kernel, so loading needs the op registry and the kernel
library, and no model code. `torch.export` lowers to no other device: an
artifact runs on the device type it was exported on (meta.json says which).
A pipeline with a fused-level knob on is exported only with
keep_fused=True, as in the JAX package; up1's two kernels are in every
artifact, since the port keeps one dense path.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import torch

from unet_goolenet_tpu_torch.ops.kernels import library  # noqa: F401  (registers ugt::*)
from unet_goolenet_tpu_torch.utils.device import check_device, inference

PROGRAM = "serving.pt2"
META = "meta.json"
EXAMPLE_BATCH = 2          # the traced example's batch when the batch is symbolic


class _Graph(torch.nn.Module):
    """The pipeline's grades graph from one input, as torch.export traces
    a module: the pipeline's weights enter as constants."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x)


def _own_storage(program: torch.export.ExportedProgram) -> None:
    """Give every weight of `program` a contiguous storage of its own, in
    place: the kernels take contiguous, 16-byte-aligned weights, and a
    saved program groups tensors by storage, so a view that shares one
    would come back from a load at an offset."""
    for tensors in (program.state_dict, program.constants):
        for name, t in list(tensors.items()):
            if isinstance(t, torch.Tensor):
                own = t.detach().clone(memory_format=torch.contiguous_format)
                tensors[name] = torch.nn.Parameter(own, t.requires_grad) if isinstance(
                    t, torch.nn.Parameter) else own


def export_serving(pipe, out_dir: str, *, source: str = "gray",
                   raw_hw: Optional[Tuple[int, int]] = None, keep_fused: bool = False,
                   static_batch: Optional[int] = None) -> dict:
    """Trace `pipe`'s (a TwoStagePipeline's) grades graph into `out_dir`.
    Returns the meta dict.

    source="gray": the input is raw (N, H, W) grayscale in [0, 255],
    float32; raw_hw fixes (H, W) (the preprocess is traced at that size).
    source="rgb": the input is preprocessed (N, S, S, 3) in [0, 1], float32
    (the body of `infer_from_rgb`). N is a torch.export.Dim unless
    static_batch fixes it; a loaded static_batch artifact serves any N by
    padding and chunking (ServingArtifact). The trace runs the pipeline's
    undecorated body: the inference mode and the TF32 flags of its calls
    are the loaded artifact's to set, not the graph's.
    """
    fused = [k for k, on in pipe.fused.items() if on]
    if fused and not keep_fused:
        raise ValueError(
            f"the pipeline has fused levels on ({', '.join(fused)}); an artifact of "
            "them needs this port's kernel library and op registry of the same build "
            "on the serving host. Build the pipeline with the knobs off for export, or "
            "pass keep_fused=True to export them anyway")
    if static_batch is not None and static_batch < 1:
        raise ValueError(f"static_batch must be >= 1, got {static_batch}")
    size = pipe.hw[0]
    if source == "gray":
        if raw_hw is None:
            raise ValueError("source='gray' needs raw_hw=(H, W)")
        body, shape = pipe.infer_from_gray.__wrapped__, tuple(raw_hw)
    elif source == "rgb":
        body, shape = pipe.infer_from_rgb.__wrapped__, (*pipe.hw, 3)
        raw_hw = pipe.hw
    else:
        raise ValueError(f"unknown source {source!r} (use 'gray' or 'rgb')")

    example = torch.zeros((static_batch or EXAMPLE_BATCH, *shape), device=pipe.device)
    dynamic = None if static_batch else {"x": {0: torch.export.Dim("batch")}}
    with torch.no_grad():
        # a real call first: what the graph builds on the host and caches (the
        # resize weights, ops/resize.py:weight_mat) then enters the trace as
        # constants on the device, not as a host copy made on every call
        body(pipe, example)
        program = torch.export.export(_Graph(lambda x: body(pipe, x)["grades"]), (example,),
                                      dynamic_shapes=dynamic, strict=False)
    _own_storage(program)
    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(program, os.path.join(out_dir, PROGRAM))
    meta = {
        "source": source,
        "raw_hw": list(raw_hw),
        "img_size": size,
        "dtype": str(pipe.dtype).split(".")[1],
        "device": pipe.device.type,
        "torch_version": torch.__version__,
        "fused_levels": ["up1", *fused],
        "static_batch": static_batch,
    }
    with open(os.path.join(out_dir, META), "w") as f:
        json.dump(meta, f, indent=1)
    return meta


class ServingArtifact:
    """A loaded serving artifact: `artifact(batch)` -> (N,) int64 grades on
    its device. `infer_grades` is the same call, and `device` the device it
    runs on, so `pipeline.serving.PipelineGrader` serves an artifact as it
    serves a pipeline.

    Each call runs as the pipeline's calls do, in inference mode with TF32
    off (utils/device.py:inference). A batch-polymorphic artifact runs any
    N at once; a static_batch one runs any N in chunks of static_batch,
    the last padded with zero images (the pipeline's empty-mask centre
    crop grades them harmlessly, reference 分类/ROI_main.py:70-74), and
    the grades are sliced back to N.
    """

    def __init__(self, program: torch.export.ExportedProgram, meta: dict,
                 device: torch.device):
        self.meta = meta
        self.device = device
        self.static_batch = meta.get("static_batch")
        self._module = program.module()        # once, not on every call

    @inference
    def __call__(self, batch) -> torch.Tensor:
        x = torch.as_tensor(batch).to(self.device, torch.float32)
        sb = self.static_batch
        if not sb or x.shape[0] == sb:
            return self._module(x)
        n = x.shape[0]
        chunks = list(x.split(sb))
        if chunks[-1].shape[0] < sb:
            pad = x.new_zeros((sb - chunks[-1].shape[0], *x.shape[1:]))
            chunks[-1] = torch.cat([chunks[-1], pad])
        return torch.cat([self._module(c) for c in chunks])[:n]

    def infer_grades(self, batch) -> torch.Tensor:
        return self(batch)


def load_serving(out_dir: str, device=None) -> ServingArtifact:
    """Load an export_serving artifact onto `device` (default: the device
    type it was exported on). Needs torch, this module and the kernel
    library's op registry, and no model code. Raises when the device is
    not present (a CUDA artifact on a host without a card does not move to
    the CPU) or is of another type than the artifact's."""
    with open(os.path.join(out_dir, META)) as f:
        meta = json.load(f)
    dev = check_device(meta["device"] if device is None else device)
    if dev.type != meta["device"]:
        raise ValueError(f"the artifact in {out_dir} was exported for {meta['device']}; "
                         f"it does not run on {dev}")
    program = torch.export.load(os.path.join(out_dir, PROGRAM))
    if dev.index is not None:      # a card named by index: its weights and device arguments
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, dev)
    _own_storage(program)
    return ServingArtifact(program, meta, dev)
