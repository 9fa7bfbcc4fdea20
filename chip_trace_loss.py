"""Which device events a profiler trace loses at its start, on the card, and
how that changes as the process ages.

Every ~16 s for SECONDS, with the card kept busy in between, it takes
traces of ten bf16 up1_gate calls (batch 16, 224^2) in four ways:

- "step": CUDA activity only, one call in the profiler's warm-up step, then
  the recorded step, which starts with four 5 ms spin kernels
  (torch.cuda._sleep), waited for;
- "step+sleep": the same with the host asleep for 0.5 s before the spins;
- "host": CPU and CUDA activity, no schedule, the same spins, so that each
  device event can be paired with the runtime call that launched it (they
  share a correlation id): `skew_ms` is the least (device start - launch
  start) over the pairs, which is negative only if the trace's device clock
  runs behind its host clock;
- "primer": as chip_smoke.level_stages takes them: "step" with its primer
  (chip_smoke.prime: PRIMER_LAUNCHES short spins) in place of the four,
  and its seal (one spin after the calls). `whole` says whether the first
  device event is a primer's spin and the last the seal, the test
  level_stages reads a trace by.

Per trace: the spins it holds (of 4; of `of` in "primer") and the calls'
device events (of 20: the conv and the reduce a call). One JSON line a
round.

    python3 chip_trace_loss.py        # one card, ~6 min; builds the kernels first
"""
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CALLS, SPINS, SPIN_CYCLES, SECONDS = 10, 4, 10_000_000, 300.0


def main() -> None:
    t_start = time.perf_counter()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile, schedule

    cs.phase_device()
    dev = torch.device("cuda", 0)
    cs.set_tf32(False)
    os.makedirs(cs.WORK, exist_ok=True)
    cs.phase_build()
    case = next(c for c in cs.up1_cases(16, 224, 224, torch.bfloat16, dev, cs.SEED + 7)
                if c.name == "up1_gate")
    case.kern()
    torch.cuda.synchronize()

    def recorded(sleep_s: float) -> None:
        time.sleep(sleep_s)
        for _ in range(SPINS):
            torch.cuda._sleep(SPIN_CYCLES)
        torch.cuda.synchronize()
        for _ in range(CALLS):
            case.kern()
        torch.cuda.synchronize()

    def counts(names) -> dict:
        names = list(names)
        spins = sum(cs.PRIMER_KERNEL in n for n in names)
        return dict(spins=spins, events=len(names) - spins)

    while True:
        row = dict(age_s=round(time.perf_counter() - t_start, 1))
        for way, sleep_s in (("step", 0.0), ("step+sleep", 0.5)):
            with profile(activities=[ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
                case.kern()
                torch.cuda.synchronize()
                prof.step()
                recorded(sleep_s)
                prof.step()
            row[way] = counts(e.key for e in prof.events()
                              if cs.device_us(e) > 0 and str(e.device_type).endswith("CUDA"))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            recorded(0.0)
        events = prof.profiler.kineto_results.events()
        on_dev = [str(k.device_type()).endswith("CUDA") for k in events]
        launched = {k.correlation_id(): k.start_ns() for k, d in zip(events, on_dev)
                    if not d and k.name().startswith("cu")}
        gaps = [k.start_ns() - launched[k.correlation_id()] for k, d in zip(events, on_dev)
                if d and k.correlation_id() in launched]
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            case.kern()
            torch.cuda.synchronize()
            prof.step()
            cs.prime()
            for _ in range(CALLS):
                case.kern()
            cs.seal()
            torch.cuda.synchronize()
            prof.step()
        order = sorted((e.time_range.start, e.key) for e in prof.events()
                       if cs.device_us(e) > 0 and str(e.device_type).endswith("CUDA"))
        row["primer"] = dict(counts(k for _, k in order), of=cs.PRIMER_LAUNCHES + 1,
                             whole=bool(order) and cs.PRIMER_KERNEL in order[0][1]
                             and cs.PRIMER_KERNEL in order[-1][1])
        row["host"] = dict(counts(k.name() for k, d in zip(events, on_dev) if d),
                           paired=len(gaps), skew_ms=min(gaps) / 1e6 if gaps else None)
        print(json.dumps(row), flush=True)
        if time.perf_counter() - t_start > SECONDS:
            break
        t_busy = time.perf_counter()
        while time.perf_counter() - t_busy < 15.0:   # the card busy, as in a long script
            for _ in range(20):
                case.kern()
            torch.cuda.synchronize()


if __name__ == "__main__":
    main()
