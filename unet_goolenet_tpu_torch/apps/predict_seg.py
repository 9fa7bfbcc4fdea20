"""Stage-1 batch mask prediction CLI (reference: 分割/predict.py).

Counterpart of the JAX package's `apps/predict_seg.py`, with its flags plus
`--device`. Writes the same artefacts: red-on-black mask PNGs under
`<out>/Segmentation_Results/<stem>.png` and an empty
`Classification_Results.xlsx` workbook (`.csv` where no xlsx engine
imports). Images are read raw (`ImageFolderDataset(wavelet=False)`) and
resized to --img-size; the masks are the BN-folded UNet forward thresholded
at 0.5 (`pipeline.segment`, what `TwoStagePipeline.infer_masks` runs, with
the up1 level on its kernels), in float32 with TF32 off.

    python -m unet_goolenet_tpu_torch.apps.predict_seg --image-dir imgs \
        --checkpoint unet.pt --out-dir out

The checkpoint is a torch file with the reference's parameter names (the port
trainer's snapshot, `{'net': ...}` or a bare state dict). With `--device
cuda` (the default) and no CUDA device, the run fails.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
from PIL import Image

from unet_goolenet_tpu_torch.data import DataLoader, ImageFolderDataset
from unet_goolenet_tpu_torch.models import UNetTaskAligWeight, load_reference_state_dict
from unet_goolenet_tpu_torch.pipeline import engine, segment
from unet_goolenet_tpu_torch.utils.device import check_device, inference


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Predict segmentation masks")
    p.add_argument("--image-dir", required=True)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--out-dir", default="test_results")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--img-size", type=int, default=224)
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return p.parse_args(argv)


def write_mask_png(mask: np.ndarray, path: str) -> None:
    """(H, W) {0,1} -> red-on-black RGB PNG, one vectorised write."""
    h, w = mask.shape
    rgb = np.zeros((h, w, 3), np.uint8)
    rgb[..., 0] = (mask > 0).astype(np.uint8) * 255
    Image.fromarray(rgb).save(path)


def write_workbook(out_dir: str) -> None:
    """The reference's empty classification workbook (predict.py:50-51); an
    empty csv where pandas or its xlsx engine does not import."""
    try:
        import pandas as pd

        pd.DataFrame([]).to_excel(os.path.join(out_dir, "Classification_Results.xlsx"),
                                  index=False)
    except ImportError:
        with open(os.path.join(out_dir, "Classification_Results.csv"), "w") as f:
            f.write("\n")   # what pandas' to_csv writes for an empty frame


def main(argv=None):
    args = parse_args(argv)
    dev = check_device(args.device)
    seg_dir = os.path.join(args.out_dir, "Segmentation_Results")
    os.makedirs(seg_dir, exist_ok=True)
    unet = load_reference_state_dict(args.checkpoint, UNetTaskAligWeight(1, img_size=args.img_size))
    params = engine.fold_unet(unet.to(dev).eval())
    masks_of = inference(lambda imgs: segment(params, imgs.to(dev))[1].cpu().numpy())

    ds = ImageFolderDataset(args.image_dir, img_size=args.img_size, wavelet=False)
    for batch in DataLoader(ds, args.batch_size):
        masks = masks_of(torch.from_numpy(batch["image"]))
        for mask, name in zip(masks, batch["name"]):
            write_mask_png(mask, os.path.join(seg_dir, f"{os.path.splitext(name)[0]}.png"))
    write_workbook(args.out_dir)
    print(f"wrote {len(ds)} masks to {seg_dir}", flush=True)
    return seg_dir


if __name__ == "__main__":
    main()
