"""Time the live bf16 serving call of one checkout of this repo on one
NVIDIA GPU, to compare two commits within one chip call.

    python3 chip_ab_serving.py <checkout> <label>

`TwoStagePipeline.infer_grades` of `<checkout>`'s port (its own
chip_smoke.py seeds the weights and gives the timer), default and
all-fused configurations, at batch 16 and 64 of 400x500 grays: two
medians of 7 rounds of 3 calls each (CUDA events, after warm-up), the
configurations in turns. Prints one JSON line. Run it for the parent and
the change in turns (parent, change, change, parent) in one call, with the
parent unpacked from `git archive` into a directory .gitignore lists.
"""

import json
import os
import sys

import torch


def main() -> None:
    root, label = os.path.abspath(sys.argv[1]), sys.argv[2]
    if not torch.cuda.is_available():
        sys.exit("chip_ab_serving.py needs an NVIDIA GPU")
    sys.path.insert(0, root)
    import chip_smoke as cs
    from unet_goolenet_tpu_torch.models import GoogLeNetClassifier, UNetTaskAligWeight
    from unet_goolenet_tpu_torch.pipeline import TwoStagePipeline

    dev = torch.device("cuda", 0)
    unet, gnet = UNetTaskAligWeight(1), GoogLeNetClassifier(6)
    unet.load_state_dict(cs.random_state_dict(unet, cs.SEED + 1))
    gnet.load_state_dict(cs.random_state_dict(gnet, cs.SEED + 2))
    pipes = {cfg: TwoStagePipeline(unet, gnet, device=dev, dtype=torch.bfloat16, **knobs)
             for cfg, knobs in (("default", {}), ("fused", cs.FUSED))}
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    out = {"tree": label, "card": torch.cuda.get_device_name(0)}
    for n in (16, 64):
        gray = torch.rand((n, 400, 500), generator=g, device=dev) * 255.0
        runs = {cfg: [] for cfg in pipes}
        for cfg in list(pipes) + list(pipes)[::-1]:
            runs[cfg].append(cs.cuda_ms_spread(lambda: pipes[cfg].infer_grades(gray))[0])
        for cfg, rs in runs.items():
            out[f"{cfg}_b{n}_ms"] = [round(r, 3) for r in rs]
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
