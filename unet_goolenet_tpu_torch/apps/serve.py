"""Serve the two-stage grader over HTTP with micro-batching on the card.

Counterpart of the JAX package's `apps/serve.py`, with its flags and
defaults plus `--device`. The reference's serving story is 分类/test.py, a
script re-run per dataset; this is a grading endpoint, in two modes:

  artifact: serve an export_serving directory (apps/export_serving.py,
  pipeline/export.py: a torch.export program with the serving kernels as
  custom ops, and its weights); no model code is imported:

      python -m unet_goolenet_tpu_torch.apps.serve --artifact artifact/ --port 8000

  live (--live): build the pipeline from checkpoints
  (apps/common.py:load_two_stage) and serve it:

      python -m unet_goolenet_tpu_torch.apps.serve --live \\
          --unet-checkpoint unet.pt --gnet-checkpoint gnet.pt \\
          --raw-hw 400 500 [--bf16] [--warmup] --port 8000

    curl -X POST --data-binary @img.npy localhost:8000/v1/grade
    curl localhost:8000/healthz

Concurrent requests are coalesced into padded device batches
(pipeline/serving.py): the card sees power-of-two batches <= --max-batch,
and a request waits at most --max-wait-ms for peers. Both modes grade
through `PipelineGrader` (pinned staging, non-blocking copies, CUDA-event
call times). An artifact runs on the device type it was exported on.
`--data-parallel` is accepted with one visible device in live mode;
sharding over several is ROADMAP.md queue 1, item 6.
"""

from __future__ import annotations

import argparse
import os

import torch

from unet_goolenet_tpu_torch.pipeline.export import META, load_serving
from unet_goolenet_tpu_torch.pipeline.serving import GradingServer, PipelineGrader
from unet_goolenet_tpu_torch.utils.device import check_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--artifact",
                   help="export_serving output directory (artifact mode)")
    p.add_argument("--live", action="store_true",
                   help="serve the live pipeline built from checkpoints")
    p.add_argument("--unet-checkpoint", help="(--live) stage-1 checkpoint")
    p.add_argument("--gnet-checkpoint", help="(--live) stage-2 checkpoint")
    p.add_argument("--raw-hw", type=int, nargs=2, metavar=("H", "W"),
                   help="(--live) raw grayscale input size requests must have")
    p.add_argument("--img-size", type=int, default=224)
    p.add_argument("--num-classes", type=int, default=6)
    p.add_argument("--bf16", action="store_true",
                   help="(--live) bf16 compute (float32 in, int grades out)")
    p.add_argument("--data-parallel", action="store_true",
                   help="(--live) one visible device only")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--max-batch", type=int, default=64,
                   help="device batch cap; batches are padded to powers of two "
                        "up to it")
    p.add_argument("--max-wait-ms", type=float, default=5.0,
                   help="micro-batching window after the first request")
    p.add_argument("--grade-timeout-s", type=float, default=600.0,
                   help="per-request wait bound")
    p.add_argument("--warmup", action="store_true",
                   help="run every batch bucket once before accepting traffic "
                        "(no request pays a size's first call)")
    p.add_argument("--no-overlap", action="store_true",
                   help="disable the double-buffered dispatcher (dispatch batch "
                        "k+1 before fetching batch k's grades; default on)")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return p.parse_args(argv)


def _live(args):
    """The live pipeline from checkpoints, and the server's meta. The model
    code is imported here, so that artifact mode imports none."""
    from unet_goolenet_tpu_torch.apps.common import load_two_stage, visible_devices

    for flag in ("unet_checkpoint", "gnet_checkpoint", "raw_hw"):
        if getattr(args, flag) is None:
            raise SystemExit(f"--live requires --{flag.replace('_', '-')}")
    check_device(args.device)
    if args.data_parallel and visible_devices(args.device) > 1:
        raise SystemExit("--data-parallel over more than one device is not ported yet "
                         "(ROADMAP.md queue 1, item 6); make one device visible")
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    pipe = load_two_stage(args.unet_checkpoint, args.gnet_checkpoint, img_size=args.img_size,
                          num_classes=args.num_classes, dtype=dtype, device=args.device)
    meta = {"mode": "live", "source": "gray", "raw_hw": list(args.raw_hw),
            "img_size": args.img_size, "dtype": str(dtype).split(".")[1],
            "device": str(pipe.device), "data_parallel": args.data_parallel}
    return pipe, meta


def _artifact(args):
    """The loaded artifact on --device, and its meta as the server's."""
    if not os.path.isfile(os.path.join(args.artifact, META)):
        raise SystemExit(f"--artifact {args.artifact}: no export_serving artifact there "
                         f"(no {META})")
    artifact = load_serving(args.artifact, args.device)
    if artifact.meta["source"] != "gray":
        raise SystemExit(f"--artifact {args.artifact}: the server takes (H, W) gray images; "
                         f"this artifact's source is {artifact.meta['source']!r}")
    return artifact, dict(artifact.meta)


def build_server(args) -> GradingServer:
    """A GradingServer over the live pipeline (--live) or a loaded artifact
    (--artifact), built from parsed args."""
    if args.live == (args.artifact is not None):
        raise SystemExit("pass exactly one of --artifact or --live")
    graded, meta = _live(args) if args.live else _artifact(args)
    return GradingServer(PipelineGrader(graded), max_batch=args.max_batch,
                         max_wait_ms=args.max_wait_ms,
                         grade_timeout_s=args.grade_timeout_s, meta=meta,
                         overlap=not args.no_overlap)


def main(argv=None):
    args = parse_args(argv)
    server = build_server(args)
    try:
        if args.warmup:
            print("warming batch buckets...", flush=True)
            print(f"warmed buckets {server.warmup()}", flush=True)
        print(f"serving {'live pipeline' if args.live else args.artifact} "
              f"(raw_hw={server.meta['raw_hw']}, device={server.meta['device']}) "
              f"on {args.host}:{args.port}", flush=True)
        server.serve(port=args.port, host=args.host)
    except KeyboardInterrupt:
        pass
    finally:
        server.close()


if __name__ == "__main__":
    main()
