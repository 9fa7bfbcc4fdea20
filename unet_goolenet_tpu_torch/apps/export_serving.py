"""Export the two-stage serving graph as a deployment artifact.

Counterpart of the JAX package's `apps/export_serving.py`, with its flags
and `--device` in place of `--platforms`. The reference's "deployment" is
re-running the training repo (分类/test.py:139-152: both torch models
loaded at import, eager Python per batch). This CLI freezes the trained
checkpoints and the whole serving graph into a directory
(`torch.export`, pipeline/export.py) that a serving host runs with
`load_serving()` (or `serve --artifact`): no model code, no re-trace, any
batch size:

    python -m unet_goolenet_tpu_torch.apps.export_serving \\
        --unet-checkpoint unet.pt --gnet-checkpoint gnet.pt \\
        --raw-hw 400 500 --out-dir artifact/ [--bf16] --check

The graph keeps up1's two hand-written kernels as custom ops
(ops/kernels/library.py), so the artifact runs on the device type it was
exported on (`--device`, default cuda; without a card it raises).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from unet_goolenet_tpu_torch.apps.common import load_two_stage
from unet_goolenet_tpu_torch.pipeline.export import export_serving, load_serving


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--unet-checkpoint", required=True)
    p.add_argument("--gnet-checkpoint", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--img-size", type=int, default=224)
    p.add_argument("--num-classes", type=int, default=6)
    p.add_argument("--raw-hw", type=int, nargs=2, default=None, metavar=("H", "W"),
                   help="raw grayscale input size fixed into the graph (source=gray); "
                        "required unless --source rgb")
    p.add_argument("--source", choices=["gray", "rgb"], default="gray")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 compute inside the graph (float32 in, int grades out)")
    p.add_argument("--check", action="store_true",
                   help="reload the artifact and check that its grades equal the live "
                        "pipeline's on a random batch of 2")
    p.add_argument("--static-batch", type=int, default=0,
                   help="fix the batch at export instead of a symbolic N (0 = any N); "
                        "the loaded runner serves any N by padding and chunking")
    p.add_argument("--keep-fused", action="store_true",
                   help="build the pipeline with its production defaults and export "
                        "them (here: up1 on its kernels and the fused-level knobs off, "
                        "the same graph as without the flag)")
    p.add_argument("--device", default="cuda",
                   help="torch device the graph is traced and will run on (default cuda)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.source == "gray" and args.raw_hw is None:
        raise SystemExit("--raw-hw H W is required with --source gray")
    # the production defaults, with or without --keep-fused: the knobs off
    pipe = load_two_stage(args.unet_checkpoint, args.gnet_checkpoint, img_size=args.img_size,
                          num_classes=args.num_classes,
                          dtype=torch.bfloat16 if args.bf16 else torch.float32,
                          device=args.device)
    meta = export_serving(pipe, args.out_dir, source=args.source,
                          raw_hw=tuple(args.raw_hw) if args.raw_hw else None,
                          keep_fused=args.keep_fused, static_batch=args.static_batch or None)
    print(f"exported {meta['source']} serving graph (raw_hw={meta['raw_hw']}, "
          f"img_size={meta['img_size']}, dtype={meta['dtype']}, device={meta['device']}, "
          f"static_batch={meta['static_batch']}, fused={meta['fused_levels']}) "
          f"to {args.out_dir}", flush=True)

    if args.check:
        runner = load_serving(args.out_dir, args.device)
        rng = np.random.default_rng(0)
        if args.source == "gray":
            batch = rng.uniform(0, 255, (2, *meta["raw_hw"])).astype(np.float32)
            want = pipe.infer_grades(batch)
        else:
            batch = rng.uniform(0, 1, (2, *meta["raw_hw"], 3)).astype(np.float32)
            want = pipe.infer_from_rgb(batch)["grades"]
        got = runner(batch)
        if not torch.equal(got.cpu(), want.cpu()):
            raise SystemExit(f"check failed: artifact grades {got.tolist()} != live "
                             f"pipeline {want.tolist()}")
        print(f"check ok: artifact grades == live pipeline {got.tolist()}", flush=True)
    return meta


if __name__ == "__main__":
    main()
