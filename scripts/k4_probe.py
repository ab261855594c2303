"""Where K4's prefill body spends a call, on the card.

    python3 scripts/k4_probe.py ROOT

ROOT is a tree of this repository (this one, or a variant of it built
beside it).  Its kernels are built into ROOT/build and each case is timed
with ROOT's ``chip_smoke.cuda_ms`` (50 calls behind a spin kernel), the
split count forced where a case names one: a lone block (one head, one
64-row tile) at 1, 16 and 32 key tiles (the slope is a block's time a
tile); a launch whose rows are all inactive (the floor of a call); the
chunk window S = 257 at B = 8 (bf16 and int8 pools); the S = 512 prefill
and the S = 17 verify window.  One JSON line of microseconds.
"""
import json, math, sys
root = sys.argv[1]
sys.path.insert(0, root)
import torch
import chip_smoke as cs
from dtdl_tpu_torch import kernels
from dtdl_tpu_torch.ops import paged_attention as pa
from dtdl_tpu_torch.ops.paged_attention import paged_attention
kernels.lib()
rule = pa.kv_splits
gen = torch.Generator(device="cuda").manual_seed(3)
def run(name, b, s_new, pos, n, inactive=(), quant=None, h=4):
    q, pk, pv, ks, vs, table, pos_t, active, _ = cs.paged_case(
        torch, gen, b=b, h=h, s_new=s_new, d=128, page=16, n_ptab=128,
        dtype=torch.bfloat16, pos=pos, inactive=inactive, quant=quant)
    pa.kv_splits = (lambda *a: n) if n else rule
    ms = cs.cuda_ms(torch, lambda: paged_attention(q, pk, pv, table, pos_t, active, scale=0.088, key_scale=ks, value_scale=vs), iters=50)
    pa.kv_splits = rule
    return round(ms * 1000, 2)
out = {"root": root}
for p in (0, 960, 1984):
    out[f"lone S=64 pos={p} h=1"] = run("lone", 1, 64, [p], 1, h=1)
for n in (1, 2):
    out[f"inactive S=257 B=8 n={n}"] = run("inact", 8, 257, cs.CHUNK_POS, n, inactive=tuple(range(8)))
for n in (2, 4):
    out[f"chunk S=257 B=8 n={n}"] = run("chunk", 8, 257, cs.CHUNK_POS, n)
    out[f"chunk S=257 B=8 int8 n={n}"] = run("chunk", 8, 257, cs.CHUNK_POS, n, quant="int8")
for n in (1, 4):
    out[f"prefill S=512 n={n}"] = run("pre", 1, 512, [256], n)
out["verify S=17 n=4"] = run("v", 8, 17, [100, 250, 400, 550, 700, 850, 1000, 1050], 4)
print(json.dumps(out), flush=True)
