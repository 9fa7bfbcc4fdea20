"""Drive the PyTorch/CUDA port's serving path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (the first failure exits non-zero):
  1. device: CUDA must be available; the card's name and power limit.
  2. build: compile the CUDA kernels from unet_goolenet_tpu_torch/csrc.
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the main path's shapes (N=4, x1 4x224x224x64, y 4x112x112x64) in float32
     (TF32 off) and bfloat16, and at a ragged 36x52 level.
  4. e2e: 8 seeded gray PNGs (400x500 and 360x480) and two seeded
     reference-named checkpoints through `apps.infer_e2e.main`, bf16 then
     float32; result.txt must hold 8 grades in [0, 6) and both kernels must
     have launched. Then, in float32, the pipeline (kernel path) against the
     plain composition (engine.up1_plain) on 4 images, with the classifier's
     fc bias centred on them so that they get at least 2 distinct grades:
     equal grades, seg logits within SEG_TOL of the largest |logit|, masks
     differing only where |logit| < 1e-3.
  5. timing (CUDA events, after warm-up): infer_grades images/s at batch 16
     and 64 in bf16 and float32 (median of 7 rounds); each kernel against its
     plain version at batch 16; a per-layer split of one bf16 batch-64 call;
     host time per bf16 call at batch 16 and 64, and one profiler trace of
     each (device busy vs wall, host syncs, top kernels).
Then a JSON line of the kernels, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Weights and images are random, made from seeds; nothing is downloaded.
Scratch files go to build/chip_smoke/ beside this script.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
SEED = 0
# kernel vs plain, as a fraction of the plain result's max |value|: float32
# differs only in summation order; bf16 rounds every stage at the same points
# in both, so one summation-order flip moves a value by a bf16 step (2^-8)
KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# float32 kernel path vs plain composition, seg logits as a fraction of the
# largest |logit|: the same bound as the kernels' own float32 check
SEG_TOL = 1e-4
KERNELS = {
    "up1_gate": ("unet_goolenet_tpu_torch/csrc/up1_gate.cu",
                 "unet_goolenet_tpu/ops/pallas/up1.py:480"),
    "up1_tail": ("unet_goolenet_tpu_torch/csrc/up1_tail.cu",
                 "unet_goolenet_tpu/ops/pallas/up1.py:521"),
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_spread(fn, rounds: int = 7, reps: int = 3):
    """(median, min, max) over rounds of cuda_ms: the e2e path launches
    hundreds of small kernels from Python, so host timing noise shows."""
    samples = sorted(cuda_ms(fn, reps) for _ in range(rounds))
    return samples[len(samples) // 2], samples[0], samples[-1]


def set_tf32(on: bool) -> None:
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


# ------------------------------------------------------------------ inputs


def up1_inputs(n, h, w, dtype, dev, seed):
    """Seeded inputs of one up1 level at output size (h, w), C = 64, as the
    plain versions take them."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, sc=1.0: (torch.randn(*s, generator=g) * sc).to(dev)
    c = 64
    k = (9 * c) ** -0.5
    gate = dict(x1=r(n, h, w, c).to(dtype), w=r(c, c, 3, 3, sc=k), b=r(c, sc=0.1))
    tail = dict(y=r(n, h // 2, w // 2, c).to(dtype), e1=r(n, h, w, c).abs().to(dtype),
                gate1p=(1 + torch.rand(n, c, generator=g)).to(dev),
                w_up=r(c, c, 2, 2, sc=0.12), b_up=r(c, sc=0.1),
                w_d2=r(c, c, 3, 3, sc=k), b_d2=r(c, sc=0.1),
                w_pair=r(c, 2 * c, 3, 3, sc=k / 1.4142), b_pair=r(c, sc=0.1),
                w_blk1=r(c, c, 3, 3, sc=k), b_blk1=r(c, sc=0.1),
                w_outc=r(1, c, 1, 1, sc=c ** -0.5), b_outc=r(1, sc=0.1))
    return gate, tail


def kernel_calls(n, h, w, dtype, dev, seed) -> dict:
    """{kernel name: (kernel call, plain call)} on up1_inputs; the kernels'
    weights are laid out before, as fold_unet does."""
    from unet_goolenet_tpu_torch.ops.kernels import up1 as K

    gi, ti = up1_inputs(n, h, w, dtype, dev, seed)
    gw = K.gate_weights(gi["w"], gi["b"], dtype)
    tw = K.tail_weights(*list(ti.values())[3:], dtype=dtype)
    return {"up1_gate": (lambda: K.up1_gate(gi["x1"], gw), lambda: K.up1_gate_ref(**gi)),
            "up1_tail": (lambda: K.up1_tail(ti["y"], ti["e1"], ti["gate1p"], tw),
                         lambda: K.up1_tail_ref(**ti))}


def random_state_dict(model: torch.nn.Module, seed: int) -> dict:
    """Reference-named state dict with seeded values: He-scaled weights,
    non-trivial BatchNorm running statistics."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = v.clone()
        elif k.endswith("running_mean"):
            sd[k] = torch.randn(v.shape, generator=g) * 0.2
        elif k.endswith("running_var"):
            sd[k] = torch.rand(v.shape, generator=g) + 0.5
        elif "pos_embedding" in k:
            sd[k] = torch.randn(v.shape, generator=g) * 0.1
        elif v.ndim >= 2:
            sd[k] = torch.randn(v.shape, generator=g) * float(np.prod(v.shape[1:])) ** -0.5
        elif k.endswith(".weight"):
            sd[k] = torch.rand(v.shape, generator=g) + 0.5
        else:
            sd[k] = torch.randn(v.shape, generator=g) * 0.1
    return sd


def write_fixture(models) -> tuple:
    """8 gray PNGs in two native sizes, and the two checkpoints."""
    from PIL import Image

    img_dir = os.path.join(WORK, "images")
    os.makedirs(img_dir, exist_ok=True)
    for f in os.listdir(img_dir):
        os.remove(os.path.join(img_dir, f))
    rng = np.random.default_rng(SEED)
    for i in range(8):
        h, w = (400, 500) if i % 2 == 0 else (360, 480)
        yy, xx = np.mgrid[0:h, 0:w]
        blob = 120.0 * np.exp(-((yy - h * rng.uniform(0.3, 0.7)) ** 2
                                + (xx - w * rng.uniform(0.3, 0.7)) ** 2) / (2 * 50.0 ** 2))
        img = np.clip(60 + blob + rng.normal(0, 20, (h, w)), 0, 255).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(img_dir, f"{i + 1}.png"))
    unet, gnet = models
    unet_sd = random_state_dict(unet, SEED + 1)
    # the reference's dead keys, which loading must drop
    unet_sd["fc1.weight"] = torch.zeros(256, 512)
    unet_sd["fc2.weight"] = torch.zeros(1, 256)
    paths = (os.path.join(WORK, "unet.pt"), os.path.join(WORK, "gnet.pt"))
    torch.save({"net": unet_sd}, paths[0])
    torch.save({"net": random_state_dict(gnet, SEED + 2)}, paths[1])
    return img_dir, paths


# ------------------------------------------------------------------ phases


def phase_device() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    print(card, flush=True)
    say("device", name=repr(torch.cuda.get_device_name(0)), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    return card


def phase_build() -> None:
    from unet_goolenet_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.load()
    regs = [ln.split(":", 1)[1].strip() for ln in path.with_suffix(".log").read_text().splitlines()
            if "registers" in ln]
    say("build", seconds=f"{time.perf_counter() - t0:.2f}", library=os.path.relpath(path, ROOT),
        ptxas=repr("; ".join(regs)))


def phase_kernels(dev) -> dict:
    """Each kernel against its plain version; returns the bf16 main-shape
    max |error| per kernel."""
    errs = {}
    for n, h, w in ((4, 224, 224), (2, 36, 52)):
        for dtype in (torch.float32, torch.bfloat16):
            calls = kernel_calls(n, h, w, dtype, dev, SEED + h)
            got = {name: kern() for name, (kern, _) in calls.items()}
            torch.cuda.synchronize()
            ref = {name: plain() for name, (_, plain) in calls.items()}
            for name in KERNELS:
                worst_abs = worst_rel = 0.0
                for g, r in zip(*(t if isinstance(t, tuple) else (t,)
                                  for t in (got[name], ref[name]))):
                    g, r = g.float(), r.float()
                    if g.shape != r.shape or not torch.isfinite(g).all():
                        fail(f"{name} {dtype} {n}x{h}x{w}: shape {tuple(g.shape)} "
                             f"or non-finite values")
                    err = (g - r).abs().max().item()
                    scale = r.abs().max().item()
                    worst_abs = max(worst_abs, err)
                    worst_rel = max(worst_rel, err / max(scale, 1e-30))
                ok = worst_rel <= KERNEL_TOL[dtype]
                say("kernel", name=name, dtype=str(dtype).split(".")[1], shape=f"{n}x{h}x{w}",
                    max_abs_err=f"{worst_abs:.3e}", max_rel_err=f"{worst_rel:.3e}",
                    tol=f"{KERNEL_TOL[dtype]:.0e}", ok=ok)
                if not ok:
                    fail(f"{name} disagrees with its plain version")
                if (n, dtype) == (4, torch.bfloat16):
                    errs[name] = worst_abs
    return errs


def phase_e2e(dev) -> dict:
    from unet_goolenet_tpu_torch.apps import infer_e2e
    from unet_goolenet_tpu_torch.models import (
        GoogLeNetClassifier, UNetTaskAligWeight, load_reference_state_dict)
    from unet_goolenet_tpu_torch.ops.kernels import up1 as K

    img_dir, (unet_pt, gnet_pt) = write_fixture((UNetTaskAligWeight(1), GoogLeNetClassifier(6)))
    K.up1_gate.launches = K.up1_tail.launches = 0
    for flags in (["--bf16"], []):
        out = infer_e2e.main(["--image-dir", img_dir, "--unet-checkpoint", unet_pt,
                              "--gnet-checkpoint", gnet_pt, "--out-dir",
                              os.path.join(WORK, "out"), "--batch-size", "4",
                              "--device", str(dev), *flags])
        lines = open(out).read().splitlines()
        grades = [int(ln.split()[1]) for ln in lines]
        if len(lines) != 8 or not all(0 <= g < 6 for g in grades):
            fail(f"result.txt: expected 8 grades in [0, 6), got {lines}")
        say("e2e", dtype="bf16" if flags else "f32", graded=len(lines), grades=grades)
    launches = {"up1_gate": K.up1_gate.launches, "up1_tail": K.up1_tail.launches}
    say("e2e", launches=launches)
    if min(launches.values()) == 0:
        fail(f"a kernel of the main path never launched: {launches}")

    gray = torch.from_numpy(np.stack([infer_e2e.read_gray(os.path.join(img_dir, f"{i}.png"))
                                      for i in (1, 3, 5, 7)]).astype(np.float32))
    check_kernel_path(dev, load_reference_state_dict(unet_pt, UNetTaskAligWeight(1)),
                      load_reference_state_dict(gnet_pt, GoogLeNetClassifier(6)), gray)
    return launches


def check_kernel_path(dev, unet, gnet, gray, img_size: int = 224) -> None:
    """float32: the pipeline (kernel path) against the same graph with the
    up1 level as plain ops. With random weights every image tends to get the
    same grade, which would let the grade check pass whatever the kernels
    return; so the fc bias is first centred on these images' logits. Centred
    logits sum to 0 over the images in every class, so unless they tie, no
    one class can win on every image."""
    from unet_goolenet_tpu_torch.pipeline import TwoStagePipeline, engine, extract_roi
    from unet_goolenet_tpu_torch.pipeline.two_stage import preprocess_gray

    pipe = TwoStagePipeline(unet, gnet, device=dev, img_size=img_size)
    with torch.no_grad():
        gnet.googlenet.fc.bias -= pipe.infer_from_gray(gray)["cls_logits"].mean(dim=0)
    pipe = TwoStagePipeline(unet, gnet, device=dev, img_size=img_size)
    k = pipe.infer_from_gray(gray)
    with torch.inference_mode():
        imgs = preprocess_gray(gray.to(dev), out_hw=pipe.hw)
        P = pipe.unet_params
        seg = engine.up1_plain(P, *engine.unet_trunk(P, imgs))
        masks = (torch.sigmoid(seg[..., 0]) > 0.5).float()
        cls = engine.gnet_forward(pipe.gnet_params, extract_roi(imgs, masks, out_hw=pipe.hw)[0])
    if k["seg_logits"].shape != (len(gray), *pipe.hw, 1) or not (
            torch.isfinite(k["seg_logits"]).all() and torch.isfinite(k["cls_logits"]).all()):
        fail("kernel path: seg/cls logits of the wrong shape or not finite")
    flips = int(((k["masks"] != masks) & (seg[..., 0].abs() >= 1e-3)).sum())
    seg_err = (k["seg_logits"] - seg).abs().max().item()
    seg_bound = SEG_TOL * seg.abs().max().item()
    grades, plain_grades = k["grades"].tolist(), cls.argmax(dim=-1).tolist()
    say("e2e", check="f32 kernel path vs plain", grades=grades, plain_grades=plain_grades,
        distinct_grades=len(set(plain_grades)), mask_flips_beyond_1e_3=flips,
        seg_logit_max_abs_err=f"{seg_err:.3e}", seg_logit_bound=f"{seg_bound:.3e}",
        cls_logit_max_abs_err=f"{(k['cls_logits'] - cls).abs().max().item():.3e}",
        mask_share=f"{masks.mean().item():.3f}")
    if len(set(plain_grades)) < 2:
        fail("the fixture graded every image alike: the grade check would have no teeth")
    if grades != plain_grades or flips or not seg_err <= seg_bound:
        fail("the kernel path and the plain composition disagree")


def phase_timing(dev, errs, launches) -> list:
    from unet_goolenet_tpu_torch.models import GoogLeNetClassifier, UNetTaskAligWeight
    from unet_goolenet_tpu_torch.pipeline import TwoStagePipeline, engine, extract_roi
    from unet_goolenet_tpu_torch.pipeline.two_stage import preprocess_gray

    unet, gnet = UNetTaskAligWeight(1), GoogLeNetClassifier(6)
    unet.load_state_dict(random_state_dict(unet, SEED + 1))
    gnet.load_state_dict(random_state_dict(gnet, SEED + 2))
    g = torch.Generator(device=dev).manual_seed(SEED)
    for dtype in (torch.bfloat16, torch.float32):
        pipe = TwoStagePipeline(unet, gnet, device=dev, dtype=dtype)
        for n in (16, 64):
            gray = torch.rand((n, 400, 500), generator=g, device=dev) * 255.0
            ms, lo, hi = cuda_ms_spread(lambda: pipe.infer_grades(gray))
            say("timing", what="infer_grades", dtype=str(dtype).split(".")[1], batch=n,
                median_ms=f"{ms:.3f}", min_ms=f"{lo:.3f}", max_ms=f"{hi:.3f}",
                images_per_s=f"{n * 1000.0 / ms:.1f}", rounds=7, calls_per_round=3)

    kernel_ms = {}
    for dtype in (torch.bfloat16, torch.float32):
        for name, (kern, plain) in kernel_calls(16, 224, 224, dtype, dev, SEED + 7).items():
            # plain, kernel, kernel, plain
            p1, k1, k2, p2 = (cuda_ms(f, 10) for f in (plain, kern, kern, plain))
            km, pm = (k1 + k2) / 2, (p1 + p2) / 2
            say("timing", what=name, dtype=str(dtype).split(".")[1], batch=16,
                kernel_ms=f"{km:.3f}", plain_ms=f"{pm:.3f}", kernel_runs=f"{k1:.3f},{k2:.3f}",
                plain_runs=f"{p1:.3f},{p2:.3f}")
            if dtype == torch.bfloat16:
                kernel_ms[name] = (km, pm)

    # per-layer split of one bf16 batch-64 call (events between the stages)
    pipe = TwoStagePipeline(unet, gnet, device=dev, dtype=torch.bfloat16)
    gray = torch.rand((64, 400, 500), generator=g, device=dev) * 255.0
    P = pipe.unet_params
    stages = {}

    def run():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        imgs = preprocess_gray(gray).to(torch.bfloat16)
        ev[1].record()
        logits = engine.unet_forward(P, imgs)
        ev[2].record()
        crops, _ = extract_roi(imgs, (torch.sigmoid(logits[..., 0]) > 0.5).float())
        ev[3].record()
        engine.gnet_forward(pipe.gnet_params, crops).argmax(-1)
        ev[4].record()
        torch.cuda.synchronize()
        for i, name in enumerate(("preprocess", "unet", "roi", "googlenet")):
            stages[name] = ev[i].elapsed_time(ev[i + 1])

    with torch.inference_mode():
        run()
        run()
        for name, (kern, _) in kernel_calls(64, 224, 224, torch.bfloat16, dev,
                                            SEED + 9).items():
            stages[name] = cuda_ms(kern, 3)
    stages["unet_trunk_rest"] = stages["unet"] - stages["up1_gate"] - stages["up1_tail"]
    say("timing", what="layers_bf16_b64_ms",
        **{k: f"{v:.3f}" for k, v in stages.items()})
    for n in (16, 64):
        batch = gray[:n].contiguous()
        profile_call(lambda: pipe.infer_grades(batch), f"infer_grades_bf16_b{n}")

    return [{"name": name, "route": "cuda", "source": src, "replaces": rep,
             "launches": launches[name], "max_abs_err": errs[name],
             "ms": kernel_ms[name][0], "plain_ms": kernel_ms[name][1]}
            for name, (src, rep) in KERNELS.items()]


def host_ms(fn, calls: int = 7):
    """Median (host ms, wall ms) per call: host is until fn returns (Python
    and launch work, unless the call waits on the device), wall until the
    device is done. The device is idle at the start of each call."""
    host, wall = [], []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        host.append((t1 - t0) * 1e3)
        wall.append((time.perf_counter() - t0) * 1e3)
    return sorted(host)[calls // 2], sorted(wall)[calls // 2]


def profile_call(fn, what: str) -> None:
    """Host time per call, then one traced call: device busy time against
    wall time, the CUDA runtime calls that make the host wait, and the
    kernels that take most of the device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    host, wall = host_ms(fn)
    say("host", what=what, host_ms=f"{host:.3f}", wall_ms=f"{wall:.3f}", calls=7,
        stat="median")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_us = lambda e: getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
    events = prof.key_averages()
    # device-side events only (kernels, copies), so nothing is counted twice
    kernels = sorted((e for e in events if str(e.device_type).endswith("CUDA") and dev_us(e) > 0),
                     key=dev_us, reverse=True)
    # runtime calls that can hold the host until the device catches up; the
    # last cudaDeviceSynchronize is this function's own
    waits = {e.key: e.count for e in events
             if "Synchronize" in e.key or e.key in ("cudaMemcpy", "cudaMemcpyAsync")}
    if not kernels:
        say("profile", what=what, device_time="not measured (the trace holds no device time)")
        return
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    say("profile", what=what, wall_ms=f"{wall_ms:.3f}", device_busy_ms=f"{busy_ms:.3f}",
        idle_share=f"{max(0.0, 1 - busy_ms / wall_ms):.3f}",
        launches=sum(e.count for e in kernels), host_waits=repr(waits))
    for e in kernels[:12]:
        say("profile", what=what, kernel=repr(e.key[:90]), calls=e.count,
            ms=f"{dev_us(e) / 1e3:.3f}")


def main() -> None:
    card = phase_device()
    dev = torch.device("cuda", 0)
    set_tf32(False)         # the plain versions' float32 convs stay float32
    os.makedirs(WORK, exist_ok=True)
    phase_build()
    errs = phase_kernels(dev)
    launches = phase_e2e(dev)
    kernels = phase_timing(dev, errs, launches)
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main()
