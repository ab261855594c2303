#!/usr/bin/env python3
"""K4's prefill body against another tree's, on one card, in turns.

    python3 scripts/k4_prefill_ab.py --other DIR [--rounds 1]
    python3 scripts/k4_prefill_ab.py --sweep 1,2,3,4,6,8

``DIR`` is a checkout of another commit beside this one (for example one
unpacked by ``git archive`` into a git-ignored directory).  Each tree's
own ``chip_smoke.time_paged`` (its kernel, its split rule, its plain
version and its bound) runs in a child process, in the order other,
this, this, other for each round, at the shapes where the main path
gives K4 more than 16 query rows: the S = 512 prefill and chunked
prefill's windows (S = 257 with a bf16 and an int8 pool, S = 33) and
speculate=16's verify window (S = 17).  Every child builds its tree's
kernels into that tree's ``build/``.  One JSON line a child, then a
table of each case's times by tree; the card's name and power limit
come first.  ``--sweep`` times this tree alone at each case (and at the
S = 2048 prefill and an S = 257 window at B = 2) with the split count
forced to each value given, beside the count ``kv_splits`` picks: the
measurement behind the split rule.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK_POS = [0, 16, 250, 700, 1000, 1500, 30, 1790]
DECODE_POS = [100, 250, 400, 550, 700, 850, 1000, 1050]
CASES = {
    "prefill S=512 pos=256 bf16": dict(b=1, s_new=512, pos=[256]),
    "chunk S=257 B=8 bf16": dict(b=8, s_new=257, pos=CHUNK_POS),
    "chunk S=257 B=8 int8 pool": dict(b=8, s_new=257, pos=CHUNK_POS,
                                      quant="int8"),
    "chunk S=33 B=8 bf16": dict(b=8, s_new=33, pos=CHUNK_POS),
    "verify S=17 B=8 bf16": dict(b=8, s_new=17, pos=DECODE_POS),
}


SWEEP_CASES = {**CASES,
               "prefill S=2048 pos=0 bf16": dict(b=1, s_new=2048, pos=[0]),
               "chunk S=257 B=2 bf16": dict(b=2, s_new=257,
                                            pos=[100, 1500])}


def sweep(counts: list[int]) -> int:
    """Each sweep case at each forced split count, and at the rule's."""
    sys.path.insert(0, HERE)
    import torch
    import chip_smoke
    from dtdl_tpu_torch import kernels
    from dtdl_tpu_torch.ops import paged_attention as pa
    if not torch.cuda.is_available():
        print("k4_prefill_ab: no CUDA device visible", file=sys.stderr)
        return 2
    kernels.lib()
    rule = pa.kv_splits
    sms = pa._sm_count(torch.device("cuda"))
    try:
        for name, kw in SWEEP_CASES.items():
            row = {"case": name,
                   "rule": rule(kw["b"], 4, kw["s_new"], 128, sms)}
            for n in counts:
                pa.kv_splits = lambda *_, n=n: n
                row[str(n)] = chip_smoke.time_paged(torch, **kw)["ms"]
            pa.kv_splits = rule
            row["rule_ms"] = chip_smoke.time_paged(torch, **kw)["ms"]
            print(json.dumps(row), flush=True)
    finally:
        pa.kv_splits = rule
    return 0


def child(root: str) -> int:
    """Time every case with ``root``'s chip_smoke and kernels."""
    sys.path.insert(0, root)
    import torch
    import chip_smoke
    from dtdl_tpu_torch import kernels
    if not torch.cuda.is_available():
        print("k4_prefill_ab: no CUDA device visible", file=sys.stderr)
        return 2
    kernels.lib()
    for name, kw in CASES.items():
        t = chip_smoke.time_paged(torch, **kw)
        print(json.dumps({"root": root, "case": name,
                          **{k: t[k] for k in ("ms", "plain_ms", "bound_ms",
                                               "bound_by")}}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="the other tree's root")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--sweep", help="comma-separated split counts")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.child)
    if not args.other and not args.sweep:
        ap.error("--other or --sweep is required")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    if args.sweep:
        return sweep([int(x) for x in args.sweep.split(",")])
    other = os.path.abspath(args.other)
    times: dict = {}
    for _ in range(args.rounds):
        for root, label in ((other, "other"), (HERE, "this"),
                            (HERE, "this"), (other, "other")):
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child", root],
                cwd=root, capture_output=True, text=True, timeout=900)
            if out.returncode != 0:
                print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
                return out.returncode
            for line in out.stdout.splitlines():
                r = json.loads(line)
                print(json.dumps({"tree": label, **r}), flush=True)
                times.setdefault(r["case"], {}).setdefault(label, []).append(
                    r)
    print(f"{'case':30s} {'other ms':>22s} {'this ms':>22s} {'bound ms':>9s}")
    for name, by in times.items():
        cell = {k: " ".join(f"{r['ms']:.4f}" for r in v)
                for k, v in by.items()}
        med = {k: statistics.median(r["ms"] for r in v)
               for k, v in by.items()}
        print(f"{name:30s} {cell['other']:>22s} {cell['this']:>22s} "
              f"{by['this'][0]['bound_ms']:9.5f}  median this/other "
              f"{med['this'] / med['other']:.3f}")
    print(f"card: {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
