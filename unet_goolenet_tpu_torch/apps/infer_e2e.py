"""End-to-end two-stage inference CLI (reference 分类/test.py).

Counterpart of the JAX package's `apps/infer_e2e.py --device-preprocess`
exact-shape path: gray images are read at native resolution, grouped by
shape, and each batch runs the whole flow (wavelet at native resolution ->
resize -> UNet -> bbox -> crop -> GoogLeNet) on the device. The last batch of
a group is padded by repeating its last image and trimmed after grading.
Writes `<out-dir>/result.txt` with "name grade" lines sorted numerically by
file stem (test.py:90-96).

    python -m unet_goolenet_tpu_torch.apps.infer_e2e --image-dir imgs \
        --unet-checkpoint unet.pt --gnet-checkpoint gnet.pt --bf16

Images are read as the JAX app reads them (`data/datasets.py:_imread`, cv2's
grayscale decode where cv2 imports). Checkpoints are torch files with the
reference's parameter names: the port trainer's snapshots (`{'model': ...}`,
train/checkpoint.py), `{'net': state_dict}` or a bare state dict.
`--num-classes` sizes the classifier (default 6), as in the JAX CLI. With
`--device cuda` (the default) and no CUDA device, the run fails; it never
falls back to the CPU.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from unet_goolenet_tpu_torch.data.datasets import _imread
from unet_goolenet_tpu_torch.models import (
    GoogLeNetClassifier, UNetTaskAligWeight, load_reference_state_dict)
from unet_goolenet_tpu_torch.pipeline import TwoStagePipeline


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Two-stage segment->crop->classify")
    p.add_argument("--image-dir", required=True)
    p.add_argument("--unet-checkpoint", required=True)
    p.add_argument("--gnet-checkpoint", required=True)
    p.add_argument("--out-dir", default="test_results")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--img-size", type=int, default=224)
    p.add_argument("--num-classes", type=int, default=6)
    p.add_argument("--bf16", action="store_true", help="bfloat16 inference")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return p.parse_args(argv)


def numeric_stem(name: str) -> int:
    stem = name.replace(".jpg", "").replace(".png", "")
    try:
        return int(stem)
    except ValueError:
        return 0


def read_gray(path: str) -> np.ndarray:
    """(H, W) uint8 grayscale at native resolution, decoded as the JAX app
    decodes it."""
    return _imread(path, True)


def grade_dir(pipe: TwoStagePipeline, image_dir: str, batch_size: int) -> list:
    """Grade every image of image_dir; returns "stem grade" records."""
    groups: dict = {}
    for name in sorted(os.listdir(image_dir)):
        gray = read_gray(os.path.join(image_dir, name))
        groups.setdefault(gray.shape, []).append((name, gray))
    records = []
    for shape in sorted(groups):
        items = groups[shape]
        for i in range(0, len(items), batch_size):
            chunk = items[i:i + batch_size]
            batch = np.stack([g for _, g in chunk]).astype(np.float32)
            if len(chunk) < batch_size:
                pad = np.repeat(batch[-1:], batch_size - len(chunk), axis=0)
                batch = np.concatenate([batch, pad])
            grades = pipe.infer_grades(torch.from_numpy(batch)).cpu().numpy()
            for (name, _), grade in zip(chunk, grades[:len(chunk)]):
                records.append(f"{name.replace('.png', '')} {int(grade)}")
    return records


def main(argv=None):
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    unet = load_reference_state_dict(
        args.unet_checkpoint, UNetTaskAligWeight(1, img_size=args.img_size))
    gnet = load_reference_state_dict(args.gnet_checkpoint, GoogLeNetClassifier(args.num_classes))
    pipe = TwoStagePipeline(unet, gnet, img_size=args.img_size, device=device,
                            dtype=torch.bfloat16 if args.bf16 else torch.float32)
    os.makedirs(args.out_dir, exist_ok=True)
    t0 = time.perf_counter()
    records = grade_dir(pipe, args.image_dir, args.batch_size)
    dt = time.perf_counter() - t0
    records.sort(key=lambda r: numeric_stem(r.split()[0]))
    out_path = os.path.join(args.out_dir, "result.txt")
    with open(out_path, "w") as f:
        f.write("\n".join(records) + ("\n" if records else ""))
    print(f"wrote {len(records)} predictions to {out_path} "
          f"({len(records) / dt:.2f} images/sec incl. host IO)", flush=True)
    return out_path


if __name__ == "__main__":
    main()
