"""Stage-2 GoogLeNet training CLI (reference: 分类/ROI_main.py).

Counterpart of `unet_goolenet_tpu/apps/train_cls.py:36-381` on one device:

    python -m unet_goolenet_tpu_torch.apps.train_cls \
        --train-dir BUSI_cls/train --val-dir BUSI_cls/val \
        --unet-checkpoint checkpoint/seg/best_model_epoch42.pt \
        --epochs 250 --batch-size 16 --img-size 224 --save-dir checkpoint/cls

The reference runs the frozen UNet inside its Dataset, one image at a time.
Here the loader yields batches of wavelet pseudo-RGB images, and the frozen
UNet -> mask -> bbox -> crop runs on the whole batch on the device
(`make_roi_extractor`), in float32 whatever `--bf16` says (only GoogLeNet
takes bf16 autocast). Its crops, augmented on the device (`--crop-augment
device`, the default: data/augment_device.py), and its full-image logits
(the refinement feedback) feed the classifier's train step (train/cls.py:
two AdamW updates a batch). Each epoch then runs the eval step over the
validation set and the classification metrics; the plateau schedule steps
on the train loss, early stopping on the val loss; the best-val-loss,
best-accuracy and every-10-epochs checkpoints are kept.

`--unet-checkpoint` takes the port's train_seg snapshot or a reference-named
file (models/convert.py:load_reference_state_dict). `--engine-roi auto`
runs the extraction through the BN-folded engine on the card when
`--img-size` is even, with all three fused-level knobs on: pool + down1 and
up2-up4 on their kernels, up1 on its own pair (five kernels in all); `on`
asks for the engine (an odd size is refused; on the CPU its plain
versions), `off` runs the UNet module. `--device-epoch` stages the
training images on the device once; each epoch extracts them (in chunks of
`--batch-size`), augments the crops and runs the steps as one loop over
device tensors (train/epoch.py). `--device` defaults to `cuda`; without a
card the run fails unless it is given `--device cpu`. `--data-parallel` and
`--multihost` are not ported (ROADMAP queue 1 item 6).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from unet_goolenet_tpu_torch.data import AugmentConfig, ClsDataset, DataLoader
from unet_goolenet_tpu_torch.data.augment_device import make_device_augment
from unet_goolenet_tpu_torch.eval import ClsMetrics
from unet_goolenet_tpu_torch.models import UNetTaskAligWeight, load_reference_state_dict
from unet_goolenet_tpu_torch.pipeline import engine as _engine
from unet_goolenet_tpu_torch.pipeline.two_stage import check_fused, extract_roi
from unet_goolenet_tpu_torch.train import optim
from unet_goolenet_tpu_torch.train.checkpoint import CheckpointManager
from unet_goolenet_tpu_torch.train.cls import (
    init_cls_state, make_cls_eval_step, make_cls_train_step)
from unet_goolenet_tpu_torch.train.epoch import make_cls_epoch_runner
from unet_goolenet_tpu_torch.utils import MetricLogger, seed_everything
from unet_goolenet_tpu_torch.utils.device import check_device, inference


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train the stage-2 GoogLeNet grader")
    p.add_argument("--train-dir", required=True)
    p.add_argument("--val-dir", required=True)
    p.add_argument("--unet-checkpoint", required=True,
                   help="frozen stage-1 checkpoint used for ROI extraction")
    p.add_argument("--epochs", type=int, default=250)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--img-size", type=int, default=224)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--save-dir", default="checkpoint/cls")
    p.add_argument("--resume", default=None, help="checkpoint file to resume from")
    p.add_argument("--warm-start", default=None, help="checkpoint file to load weights from")
    p.add_argument("--log-dir", default=None)
    p.add_argument("--num-classes", type=int, default=6)
    p.add_argument("--crop-augment", choices=["device", "none"], default="device",
                   help="augment the ROI crops on the device (flips, rotation, blur, "
                        "jitter)")
    p.add_argument("--aux-weight", type=float, default=0.0,
                   help=">0 enables GoogLeNet's aux heads and the aux cross entropy")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 autocast for GoogLeNet; float32 parameters, optimizer "
                        "state and BatchNorm statistics; the frozen UNet stays float32")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument("--device-epoch", action="store_true",
                   help="stage the training images on the device once; each epoch "
                        "extracts, augments and trains on device tensors")
    p.add_argument("--engine-roi", choices=["auto", "on", "off"], default="auto",
                   help="ROI extraction through the folded engine forward ('auto': on "
                        "the card with an even --img-size, with the fused kernels)")
    p.add_argument("--data-parallel", action="store_true", help="not ported")
    p.add_argument("--multihost", action="store_true", help="not ported")
    return p.parse_args(argv)


def make_roi_extractor(unet, img_size: int, *, engine: bool = True, fused: bool = False,
                       dtype: torch.dtype = torch.float32, device="cuda"):
    """The batched frozen-UNet -> masks -> (crops, full-image logits) step
    (the reference runs it per image inside its Dataset,
    分类/ROI_main.py:142-162 + util/roi.py:12-51).

    engine=True runs the BN-folded engine forward in `dtype`, and fused=True
    additionally puts pool + down1 and the up2-up4 levels on their kernels
    (all three of `engine.unet_forward`'s knobs), as the JAX extractor turns
    on all its fused levels. engine=False runs the `nn.Module` forward, in
    float32. Returns extract(imgs (N, S, S, 3) in [0, 1]) -> (crops
    (N, S, S, 3), logits (N, S, S, n_classes)), both in the compute dtype.
    They are inference-mode tensors: a train step takes clones."""
    dev = check_device(device)
    if fused and not engine:
        raise ValueError("fused=True needs the engine forward (engine=True)")
    if not engine and dtype != torch.float32:
        raise ValueError("engine=False runs the module forward in float32 only")
    knobs = check_fused(img_size, fused_up2=fused, fused_up34=fused, fused_down1=fused)
    unet = unet.to(dev).eval()
    if engine:
        params = _engine.fold_unet(unet, dtype, **knobs)
        forward = lambda x: _engine.unet_forward(params, x, **knobs)
    else:
        forward = unet
    hw = (img_size, img_size)

    @inference
    def extract(imgs):
        imgs = torch.as_tensor(imgs).to(dev, dtype)
        logits = forward(imgs)
        masks = (torch.sigmoid(logits[..., 0]) > 0.5).float()
        crops, _ = extract_roi(imgs, masks, out_hw=hw)
        return crops, logits

    return extract


def trainable(extract, imgs):
    """extract(imgs) cloned out of inference mode, which a training forward
    cannot save for backward."""
    return tuple(t.clone() for t in extract(imgs))


def main(argv=None):
    args = parse_args(argv)
    if args.data_parallel or args.multihost:
        raise SystemExit("--data-parallel and --multihost are not ported yet "
                         "(ROADMAP queue 1 item 6)")
    if args.engine_roi == "on" and args.img_size % 2:
        raise SystemExit("--engine-roi on requires an even --img-size "
                         f"(got {args.img_size}); use --engine-roi auto/off")
    dev = check_device(args.device)
    seed_everything(args.seed)
    logger = MetricLogger(args.log_dir, "train_cls")

    rng_np = np.random.default_rng(args.seed)
    train_ds = ClsDataset(args.train_dir, img_size=args.img_size, train=True, rng=rng_np)
    val_ds = ClsDataset(args.val_dir, img_size=args.img_size, train=False)
    train_loader = DataLoader(train_ds, args.batch_size, shuffle=True, seed=args.seed)
    val_loader = DataLoader(val_ds, args.batch_size)

    unet = load_reference_state_dict(args.unet_checkpoint,
                                     UNetTaskAligWeight(1, img_size=args.img_size))
    use_engine = args.img_size % 2 == 0 and (
        args.engine_roi == "on" or (args.engine_roi == "auto" and dev.type == "cuda"))
    extract = make_roi_extractor(unet, args.img_size, engine=use_engine,
                                 fused=use_engine and dev.type == "cuda", device=dev)

    crop_augment = None
    if args.crop_augment == "device":
        crop_augment = make_device_augment(AugmentConfig.cls_train(args.img_size))

    state = init_cls_state(args.num_classes, aux_logits=args.aux_weight > 0, lr=args.lr,
                           device=dev)
    mgr = CheckpointManager(args.save_dir, periodic_every=10)
    start_epoch = 0
    if args.resume:
        state, start_epoch = mgr.restore(args.resume, state)
        print(f"resumed from {args.resume} at epoch {start_epoch}", flush=True)
    elif args.warm_start:
        state, _ = mgr.restore(args.warm_start, state)
        print(f"warm start from {args.warm_start}", flush=True)
    train_step = make_cls_train_step(state, aux_weight=args.aux_weight, bf16=args.bf16)
    eval_step = make_cls_eval_step(state.model, bf16=args.bf16)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def labels_of(batch):
        return torch.from_numpy(np.asarray(batch["cl_label"])).to(dev).long()

    def loader_epoch() -> float:
        losses = []
        for batch in train_loader:
            crops, se_out = trainable(extract, torch.from_numpy(batch["image"]))
            if crop_augment is not None:
                crops = crop_augment(gen, crops)
            losses.append(train_step(crops, labels_of(batch), se_out, gen)["loss"])
        return float(torch.stack(losses).mean())

    train_epoch = loader_epoch
    if args.device_epoch:
        staged = torch.from_numpy(np.stack([train_ds[i]["image"]
                                            for i in range(len(train_ds))])).to(dev)
        staged_labels = torch.tensor(train_ds.labels, device=dev).long()
        run_epoch = make_cls_epoch_runner(train_step, args.batch_size)

        def train_epoch() -> float:
            parts = [trainable(extract, staged[i:i + args.batch_size])
                     for i in range(0, len(staged), args.batch_size)]
            crops = torch.cat([c for c, _ in parts])
            se_out = torch.cat([s for _, s in parts])
            if crop_augment is not None:
                crops = crop_augment(gen, crops)
            return float(run_epoch(crops, staged_labels, se_out, gen))

    plateau = optim.plateau_init(args.lr)
    stopper = optim.EarlyStopper(patience=300, lr_threshold=args.lr, extension=20)
    best_val_loss, best_acc = float("inf"), 0.0
    for epoch in range(start_epoch, args.epochs):
        t0 = time.time()
        optim.set_learning_rate(state.opt, plateau.lr)
        train_loss = train_epoch()

        cls_metrics = ClsMetrics(num_classes=args.num_classes)
        val_losses = []
        for batch in val_loader:
            crops, _ = extract(torch.from_numpy(batch["image"]))
            loss, logits = eval_step(crops, labels_of(batch))
            val_losses.append(float(loss))
            cls_metrics.update(logits, batch["cl_label"])
        val_loss = float(np.mean(val_losses))
        scores = cls_metrics.aggregate()

        plateau = optim.plateau_step(plateau, train_loss)
        logger.log(epoch, train_loss=train_loss, val_loss=val_loss, f1=scores["f1"],
                   acc=scores["accuracy"], auroc=scores["auroc"], lr=float(plateau.lr),
                   secs=time.time() - t0)
        if val_loss < best_val_loss:
            best_val_loss = val_loss
            mgr.save_best_loss(state, epoch)
        if scores["accuracy"] > best_acc:
            best_acc = scores["accuracy"]
            mgr.save_best_metric(state, epoch, tag="acc")
        mgr.save_periodic(state, epoch)
        if stopper.update(val_loss, float(plateau.lr)):
            print(f"early stop at epoch {epoch}", flush=True)
            break
    print(f"done: best_val_loss={best_val_loss:.4f} best_acc={best_acc:.4f}", flush=True)
    return {"best_val_loss": best_val_loss, "best_acc": best_acc,
            "best_loss_checkpoint": mgr.latest_best()}


if __name__ == "__main__":
    main()
