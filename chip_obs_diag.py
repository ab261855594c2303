#!/usr/bin/env python3
"""Observed against unobserved serving on one card: where the `obs`
phase's serving gap comes from.

    python3 chip_obs_diag.py

Serves the `chip_smoke.py` serve cell (base bf16, page 16, 8 slots, its
16 requests) through a Scheduler under `chip_smoke.py`'s
synchronization counter, as its `obs` phase times it, in turns: no
observer twice (an A/A pair that shows the noise) and the full observer
and exporter; first with the main thread free to move between cores,
then pinned to one core beside the card.  Prints each kind's tokens/s
by run and the cores each run started and ended on, the card's CPU
affinity, then profiles two runs with and two without the observer and
prints the host time each function adds a run.  It needs a CUDA device.

    python3 chip_obs_diag.py --step-pairs N [--out FILE]

Instead: N pairs of the `obs` (b) gate's toggled runs (observer and
exporter at the even steps in one run, the odd in the next) in turns
with N pairs of the same runs toggling between no observer and no
observer (A/A: what the gate reads when there is nothing to read).
Writes every run's step seconds to FILE (default
`chiprun_out/obs_steps.json`), prints each pair's reading by the gate's
estimator (adjacent even/odd steps) and by the one it replaced (the
two parities' medians), then, for each kind and estimator, the spread
of the pairs' readings and of the gate's reading over the gate's pairs
drawn from them (a seeded bootstrap, OBS_SERVE_PAIRS at a time).
"""

import argparse
import cProfile
import json
import math
import os
import pstats
import random
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def this_cpu() -> int:
    """The core the calling thread runs on (field 39 of its stat)."""
    with open("/proc/thread-self/stat") as f:
        return int(f.read().rsplit(")", 1)[1].split()[36])


def table(run, kinds, head: str, rounds: int = 10) -> None:
    """``rounds`` rounds of ``kinds`` in turns; each kind's tokens/s and
    the cores each run started and ended on."""
    res, cpus = {}, {}
    for i in range(rounds):
        for k in (kinds if i % 2 == 0 else kinds[::-1]):
            c0 = this_cpu()
            res.setdefault(k, []).append(run(k.split()[0], counted=True))
            cpus.setdefault(k, []).append((c0, this_cpu()))
    for k, v in res.items():
        print(f"{head}{k} median tokens/s {sorted(v)[len(v) // 2]:.1f} "
              f"{[round(x) for x in v]} cores {cpus[k]}", flush=True)


def step_pairs(torch, cs, model, traffic, series, n: int, out: str) -> None:
    """N observed toggled pairs and N A/A toggled pairs, in turns; the
    step seconds of every run go to ``out``."""
    from dtdl_tpu_torch.obs import JsonlSeriesSink, MetricsExporter, Observer
    from dtdl_tpu_torch.serve.engine import InferenceEngine
    from dtdl_tpu_torch.serve.scheduler import Request, Scheduler

    def run(observed: bool, phase: int) -> list:
        eng = InferenceEngine(model, n_slots=8, page_size=16, device="cuda")
        obs = Observer(trace=True, sentinel="warn") if observed else None
        ex = MetricsExporter([JsonlSeriesSink(series)]) if observed \
            else None
        sched = Scheduler(eng, harvest_lag=4, observer=obs, exporter=ex,
                          device="cuda")
        reqs = [Request(list(p), m) for p, m in traffic]
        step_s: list = []
        torch.cuda.synchronize()
        cs.sync_count(torch, lambda: cs.obs_toggled(sched, reqs, phase,
                                                    step_s))
        torch.cuda.synchronize()
        if ex:
            ex.close()
        return step_s

    runs: dict = {"ab": [], "aa": []}
    for i in range(n):
        for kind in (("ab", "aa") if i % 2 == 0 else ("aa", "ab")):
            pair = [run(kind == "ab", 0), run(kind == "ab", 1)]
            runs[kind].append(pair)
            print(f"pair {i} {kind}: {100 * adjacent(pair):+.3f}% "
                  f"(adjacent steps) {100 * parity_medians(pair):+.3f}% "
                  f"(parity medians), run seconds "
                  f"{[round(sum(x), 4) for x in pair]}", flush=True)
    for kind in ("ab", "aa"):
        print(f"{kind}: " + "; ".join(
            f"{name}: pair sd "
            f"{100 * statistics.stdev(map(fn, runs[kind])):.3f}%, gate over "
            f"{cs.OBS_SERVE_PAIRS} pairs (bootstrap of {BOOT}) mean "
            f"{100 * statistics.mean(g):+.3f}% sd "
            f"{100 * statistics.stdev(g):.3f}%, above "
            f"{100 * cs.OBS_LIMIT:.0f}% in {sum(x > cs.OBS_LIMIT for x in g)}"
            for name, fn, g in gates(cs, runs[kind])), flush=True)
    runs["card"] = cs.card_identity()
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(runs, f)
    print(f"step seconds of {4 * n} runs -> {out}", flush=True)


BOOT = 2000


def adjacent(pair) -> float:
    """The `obs` (b) gate's reading of one pair (chip_smoke.py's
    ``obs_step_overhead``, median of its samples)."""
    import chip_smoke as cs
    return math.exp(cs.median(cs.obs_step_overhead(*pair))) - 1.0


def parity_medians(pair) -> float:
    """The reading the gate took before: the even steps' median log a/b
    ratio less the odd steps' median, halved."""
    import chip_smoke as cs
    a, b = pair
    r = [math.log(x / y) for x, y in zip(a, b)]
    return math.exp((cs.median(r[0::2]) - cs.median(r[1::2])) / 2) - 1.0


def gates(cs, pairs) -> list:
    """Each estimator's gate over OBS_SERVE_PAIRS pairs drawn (seeded, with
    replacement) BOOT times from ``pairs``: the adjacent-step samples
    pooled over the drawn pairs, and the median of the pairs' parity
    readings."""
    rng = random.Random(0)
    draws = [[rng.choice(pairs) for _ in range(cs.OBS_SERVE_PAIRS)]
             for _ in range(BOOT)]
    pooled = [math.exp(cs.median([x for p in d for x in
                                  cs.obs_step_overhead(*p)])) - 1.0
              for d in draws]
    medians = [cs.median([parity_medians(p) for p in d]) for d in draws]
    return [("adjacent steps", adjacent, pooled),
            ("parity medians", parity_medians, medians)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--step-pairs", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                   "obs_steps.json"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_obs_diag: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from dtdl_tpu_torch.models.transformer import transformer_lm
    from dtdl_tpu_torch.obs import JsonlSeriesSink, MetricsExporter, Observer
    from dtdl_tpu_torch.serve.engine import InferenceEngine
    from dtdl_tpu_torch.serve.scheduler import Request, Scheduler
    torch.backends.cuda.matmul.allow_tf32 = False
    model = transformer_lm("base", seed=0, dtype=torch.bfloat16,
                           device="cuda")
    traffic = cs.make_traffic(0, model.cfg.vocab_size)
    series = os.path.join(ROOT, "build", "obs_diag.jsonl")
    os.makedirs(os.path.dirname(series), exist_ok=True)

    def run(kind, prof=None, counted=False):
        eng = InferenceEngine(model, n_slots=8, page_size=16, device="cuda")
        obs = Observer(trace=True, sentinel="warn") \
            if kind in ("both", "obs") else None
        ex = MetricsExporter([JsonlSeriesSink(series)]) \
            if kind in ("both", "ex") else None
        sched = Scheduler(eng, harvest_lag=4, observer=obs, exporter=ex,
                          device="cuda")
        reqs = [Request(list(p), m) for p, m in traffic]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if prof:
            prof.enable()
        if counted:
            cs.sync_count(torch, lambda: sched.run(reqs))
        else:
            sched.run(reqs)
        if prof:
            prof.disable()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if ex:
            ex.close()
        return sum(len(r.tokens) for r in reqs) / wall

    run("none")
    if args.step_pairs:
        step_pairs(torch, cs, model, traffic, series, args.step_pairs,
                   args.out)
        print(cs.card_identity())
        return 0
    bus = subprocess.run(["nvidia-smi", "--query-gpu=pci.bus_id",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().lower()
    local = f"/sys/bus/pci/devices/{bus[4:] if len(bus) > 12 else bus}/" \
        "local_cpulist"
    near = open(local).read().strip() if os.path.exists(local) else None
    allowed = sorted(os.sched_getaffinity(0))
    print(f"card {bus}: local cpus {near}; allowed {allowed}", flush=True)
    kinds = ["none", "none again", "both"]
    table(run, kinds, "free: ")
    core = int(near.split(",")[0].split("-")[0]) if near else allowed[0]
    core = core if core in allowed else allowed[0]
    os.sched_setaffinity(0, {core})
    table(run, kinds, f"pinned to core {core}: ")
    os.sched_setaffinity(0, allowed)
    tot = {}
    for k in ("both", "none", "both", "none"):
        p = cProfile.Profile()
        run(k, p, counted=True)
        for (f, line, fn), v in pstats.Stats(p).stats.items():
            key = (f.split(ROOT + "/")[-1], line, fn)
            tot.setdefault(k, {}).setdefault(key, 0.0)
            tot[k][key] += v[2] / 2
    print(f"profiled host s a run: observed {sum(tot['both'].values()):.4f}"
          f" unobserved {sum(tot['none'].values()):.4f}")
    diff = sorted(((tot["both"].get(x, 0) - tot["none"].get(x, 0), x)
                   for x in set(tot["both"]) | set(tot["none"])),
                  reverse=True)
    for d, x in diff[:25]:
        print(f"{d:.4f} s a run added  {x}")
    print(cs.card_identity())
    return 0


if __name__ == "__main__":
    sys.exit(main())
