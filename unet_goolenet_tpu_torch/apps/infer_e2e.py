"""End-to-end two-stage inference CLI (reference 分类/test.py).

Counterpart of the JAX package's `apps/infer_e2e.py`, with its flags and
defaults. Writes `<out-dir>/result.txt` with "name grade" lines sorted
numerically by file stem (test.py:90-96). Three routes:

  * host preprocessing (the default): `ImageFolderDataset(wavelet=True)`
    reads each image as gray, wavelet-enhances and resizes it on the host
    (test.py:127-130), the port's DataLoader batches the results, and
    `infer_from_rgb` runs the UNet -> bbox -> crop -> GoogLeNet graph;
  * `--device-preprocess`: gray images at native resolution, grouped by
    shape; each batch runs the whole flow (wavelet at native resolution ->
    resize -> UNet -> bbox -> crop -> GoogLeNet) on the device
    (`infer_grades`);
  * `--device-preprocess --size-buckets N`: each image is edge-padded into
    one of at most N bucket shapes and graded with its valid size
    (`infer_grades_padded`: mask-aware wavelet and min-max, valid-region
    resize), so mixed native sizes share a batch.

On the device routes the last batch of a group is padded by repeating its
last image and trimmed after grading.

    python -m unet_goolenet_tpu_torch.apps.infer_e2e --image-dir imgs \
        --unet-checkpoint unet.pt --gnet-checkpoint gnet.pt --bf16 \
        [--device-preprocess [--size-buckets 4]]

Images are read as the JAX app reads them (`data/datasets.py:_imread`, cv2's
decode where cv2 imports). Checkpoints are torch files with the reference's
parameter names (apps/common.py). `--num-classes` sizes the classifier
(default 6). With `--device cuda` (the default) and no CUDA device, the run
fails; it never falls back to the CPU. `--data-parallel` is accepted with one
visible device, where the host route pads its short last batch to
`--batch-size` and trims it, as the JAX app does; sharding over several
devices is not ported (ROADMAP.md queue 1, item 6).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from unet_goolenet_tpu_torch.apps.common import load_two_stage, visible_devices
from unet_goolenet_tpu_torch.data import DataLoader, ImageFolderDataset
from unet_goolenet_tpu_torch.data.datasets import _imread
from unet_goolenet_tpu_torch.pipeline import TwoStagePipeline
from unet_goolenet_tpu_torch.pipeline.two_stage import check_device

# --device-preprocess without buckets runs at least one batch per distinct raw
# size, the last of each padded up to --batch-size: past this many sizes the
# short batches cost more than the buckets' padding
COMPILE_GUARD = 8


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
    p.add_argument("--data-parallel", action="store_true",
                   help="one visible device only: the host route pads its short "
                        "final batch by repeating the last image and trims it")
    p.add_argument("--device-preprocess", action="store_true",
                   help="run wavelet + resize on the device too: the whole "
                        "gray->wavelet->resize->UNet->bbox->crop->GoogLeNet flow "
                        "(分类/test.py:122-134) per batch of one raw size")
    p.add_argument("--size-buckets", type=int, default=0, metavar="N",
                   help="with --device-preprocess: edge-pad each raw image into "
                        "one of at most N bucket shapes (mask-aware wavelet and "
                        "normalisation, valid-region resize), so mixed sizes "
                        "share batches. 0 (default) batches each exact raw "
                        "(H, W) apart; a warning suggests buckets past "
                        f"{COMPILE_GUARD} distinct shapes")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return p.parse_args(argv)


def bucket_shapes(shapes, n_buckets: int) -> dict:
    """Map each raw (H, W) to one of <= n_buckets even-sized bucket shapes.

    Greedy: unique shapes sorted by area are split into contiguous groups and
    each group's bucket is the elementwise max (rounded up to even), so every
    image fits its bucket."""
    uniq = sorted(set(shapes), key=lambda s: (s[0] * s[1], s))
    n = max(1, min(n_buckets, len(uniq)))
    per = (len(uniq) + n - 1) // n
    mapping = {}
    for i in range(0, len(uniq), per):
        group = uniq[i:i + per]
        bh = max(s[0] for s in group)
        bw = max(s[1] for s in group)
        bucket = (bh + bh % 2, bw + bw % 2)
        for s in group:
            mapping[s] = bucket
    return mapping


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


def record(name: str, grade) -> str:
    return f"{name.replace('.png', '')} {int(grade)}"


def pad_rows(batch: np.ndarray, n: int) -> np.ndarray:
    """batch with its last row repeated up to n rows."""
    return np.concatenate([batch, np.repeat(batch[-1:], n - len(batch), axis=0)])


def grade_dir(pipe: TwoStagePipeline, image_dir: str, batch_size: int,
              size_buckets: int = 0) -> list:
    """The device-preprocess routes: grade every image of image_dir from its
    raw gray, batched by exact shape, or by bucket with size_buckets > 0;
    returns "stem grade" records."""
    loaded = [(name, read_gray(os.path.join(image_dir, name)))
              for name in sorted(os.listdir(image_dir))]
    bucket = (bucket_shapes([g.shape for _, g in loaded], size_buckets) if size_buckets
              else {g.shape: g.shape for _, g in loaded})
    groups: dict = {}
    for name, gray in loaded:
        groups.setdefault(bucket[gray.shape], []).append((name, gray))
    if not size_buckets and len(groups) > COMPILE_GUARD:
        print(f"warning: {len(groups)} distinct raw sizes -> at least {len(groups)} "
              "device calls, each size's last batch padded up to --batch-size; "
              f"consider --size-buckets {COMPILE_GUARD} (mixed sizes share "
              "batches, grade-parity padded path)", flush=True)
    records = []
    for (bh, bw) in sorted(groups):
        items = groups[(bh, bw)]
        for i in range(0, len(items), batch_size):
            chunk = items[i:i + batch_size]
            batch = np.stack([np.pad(g.astype(np.float32),
                                     ((0, bh - g.shape[0]), (0, bw - g.shape[1])),
                                     mode="edge") for _, g in chunk])
            valid = np.asarray([g.shape for _, g in chunk], np.int32)
            if len(chunk) < batch_size:
                batch, valid = pad_rows(batch, batch_size), pad_rows(valid, batch_size)
            if size_buckets:
                grades = pipe.infer_grades_padded(torch.from_numpy(batch), valid)
            else:
                grades = pipe.infer_grades(torch.from_numpy(batch))
            records += [record(name, g) for (name, _), g in zip(chunk, grades.cpu().numpy())]
    return records


def grade_host(pipe: TwoStagePipeline, image_dir: str, batch_size: int, img_size: int,
               pad_last: bool = False) -> list:
    """The host-preprocess route: ImageFolderDataset(wavelet=True) batches
    through infer_from_rgb; pad_last pads a short last batch to batch_size
    and trims it. Returns "stem grade" records."""
    ds = ImageFolderDataset(image_dir, img_size=img_size, wavelet=True)
    records = []
    for batch in DataLoader(ds, batch_size):
        imgs, k = batch["image"], len(batch["name"])
        if pad_last and k < batch_size:
            imgs = pad_rows(imgs, batch_size)
        grades = pipe.infer_from_rgb(torch.from_numpy(imgs))["grades"].cpu().numpy()[:k]
        records += [record(name, g) for name, g in zip(batch["name"], grades)]
    return records


def main(argv=None):
    args = parse_args(argv)
    if args.size_buckets and not args.device_preprocess:
        # the host route resizes each image on the host; accepting the flag
        # there would silently do nothing
        raise SystemExit("--size-buckets only applies with --device-preprocess")
    check_device(args.device)
    if args.data_parallel and visible_devices(args.device) > 1:
        raise SystemExit("--data-parallel over more than one device is not ported yet "
                         "(ROADMAP.md queue 1, item 6); make one device visible")
    pipe = load_two_stage(args.unet_checkpoint, args.gnet_checkpoint, img_size=args.img_size,
                          num_classes=args.num_classes, device=args.device,
                          dtype=torch.bfloat16 if args.bf16 else torch.float32)
    os.makedirs(args.out_dir, exist_ok=True)
    t0 = time.perf_counter()
    if args.device_preprocess:
        records = grade_dir(pipe, args.image_dir, args.batch_size, args.size_buckets)
    else:
        records = grade_host(pipe, args.image_dir, args.batch_size, args.img_size,
                             pad_last=args.data_parallel)
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
