"""Stage-1 UNet training CLI (reference: 分割/main.py).

Counterpart of `unet_goolenet_tpu/apps/train_seg.py:91-277` on one device:

    python -m unet_goolenet_tpu_torch.apps.train_seg \
        --train-dir BUSI_1/train --val-dir BUSI_1/val \
        --epochs 250 --batch-size 4 --img-size 224 --save-dir checkpoint/seg

Each epoch runs the refinement train step (two AdamW updates a batch,
train/seg.py) over the shuffled, augmented training set, then the eval step
over the validation set with the reference's empty-prediction hack; the
plateau schedule steps on the epoch's train loss, early stopping on the val
loss, and the best-val-loss and best-dice checkpoints are kept.

`--device` defaults to `cuda`; without a card the run fails unless it is
given `--device cpu`. `--kernels` runs the UNet's 3x3 convs, transposed
convs and pools on the CUDA kernels of ops/kernels/conv.py (on the CPU,
their plain versions); a kernel that cannot launch raises. `--bf16` trains
in bfloat16 autocast with float32 parameters, optimizer state and
BatchNorm statistics. The JAX CLI's `--data-parallel`, `--multihost`,
`--device-epoch`, `--engine-forward`, `--remat` and `--flat-opt` are not
ported (ROADMAP).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from unet_goolenet_tpu_torch.data import DataLoader, SegDataset
from unet_goolenet_tpu_torch.eval import SegMetrics
from unet_goolenet_tpu_torch.pipeline.two_stage import check_device
from unet_goolenet_tpu_torch.train import optim
from unet_goolenet_tpu_torch.train.checkpoint import CheckpointManager
from unet_goolenet_tpu_torch.train.seg import (
    init_seg_state, make_seg_eval_step, make_seg_train_step)
from unet_goolenet_tpu_torch.utils import MetricLogger, seed_everything


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train the stage-1 segmentation UNet")
    p.add_argument("--train-dir", required=True)
    p.add_argument("--val-dir", required=True)
    p.add_argument("--epochs", type=int, default=250)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--img-size", type=int, default=224)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--save-dir", default="checkpoint/seg")
    p.add_argument("--resume", default=None, help="checkpoint file to resume from")
    p.add_argument("--warm-start", default=None, help="checkpoint file to load weights from")
    p.add_argument("--log-dir", default=None)
    p.add_argument("--hausdorff", action="store_true",
                   help="compute the (host-side) Hausdorff val metric")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 autocast; float32 parameters, optimizer state and "
                        "BatchNorm statistics")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument("--kernels", action="store_true",
                   help="run the UNet's 3x3 convs, transposed convs and pools on the "
                        "CUDA kernels (ops/kernels/conv.py)")
    return p.parse_args(argv)


def to_device(batch, dev):
    return (torch.from_numpy(batch["image"]).to(dev, non_blocking=True),
            torch.from_numpy(batch["se_label"]).to(dev, non_blocking=True))


def main(argv=None):
    args = parse_args(argv)
    dev = check_device(args.device)
    seed_everything(args.seed)
    logger = MetricLogger(args.log_dir, "train_seg")

    rng_np = np.random.default_rng(args.seed)
    train_ds = SegDataset(args.train_dir, img_size=args.img_size, train=True, rng=rng_np)
    val_ds = SegDataset(args.val_dir, img_size=args.img_size, train=False)
    train_loader = DataLoader(train_ds, args.batch_size, shuffle=True, seed=args.seed)
    val_loader = DataLoader(val_ds, args.batch_size)

    state = init_seg_state(img_size=args.img_size, lr=args.lr, kernels=args.kernels, device=dev)
    mgr = CheckpointManager(args.save_dir)
    start_epoch = 0
    if args.resume:
        state, start_epoch = mgr.restore(args.resume, state)
        print(f"resumed from {args.resume} at epoch {start_epoch}", flush=True)
    elif args.warm_start:
        state, _ = mgr.restore(args.warm_start, state)
        print(f"warm start from {args.warm_start}", flush=True)
    train_step = make_seg_train_step(state, bf16=args.bf16)
    eval_step = make_seg_eval_step(state.model, bf16=args.bf16)

    plateau = optim.plateau_init(args.lr)
    stopper = optim.EarlyStopper(patience=50, lr_threshold=args.lr, extension=20)
    best_val_loss, best_dice = float("inf"), 0.0
    for epoch in range(start_epoch, args.epochs):
        t0 = time.time()
        optim.set_learning_rate(state.opt, plateau.lr)
        losses = [train_step(*to_device(b, dev))["loss"] for b in train_loader]
        train_loss = float(torch.stack(losses).mean())

        seg_metrics = SegMetrics(empty_pred_hack=True, compute_hausdorff=args.hausdorff)
        val_losses = []
        for batch in val_loader:
            loss, masks = eval_step(*to_device(batch, dev))
            val_losses.append(float(loss))
            seg_metrics.update(masks, batch["se_label"])
        val_loss = float(np.mean(val_losses))
        scores = seg_metrics.aggregate()

        plateau = optim.plateau_step(plateau, train_loss)
        logger.log(epoch, train_loss=train_loss, val_loss=val_loss, lr=float(plateau.lr),
                   secs=time.time() - t0, **{k: v for k, v in scores.items() if not np.isnan(v)})
        if val_loss < best_val_loss:
            best_val_loss = val_loss
            mgr.save_best_loss(state, epoch)
        if scores["dice"] > best_dice:
            best_dice = scores["dice"]
            mgr.save_best_metric(state, epoch, tag="seg")
        if stopper.update(val_loss, float(plateau.lr)):
            print(f"early stop at epoch {epoch}", flush=True)
            break
    print(f"done: best_val_loss={best_val_loss:.4f} best_dice={best_dice:.4f}", flush=True)
    return {"best_val_loss": best_val_loss, "best_dice": best_dice,
            "best_loss_checkpoint": mgr.latest_best()}


if __name__ == "__main__":
    main()
