#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dtdl_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py [--seed N] [--phases build,kernels,serve,...]

Phases, each of which raises on failure (the script then exits non-zero):

1. build     - compile the hand-written kernels (csrc/*.cu, nvcc, sm_90a)
               into build/kernels/ and print the compiler's register and
               spill summary;
2. identity  - the card's name and power limit, as nvidia-smi reports them;
3. kernels   - each kernel against its plain PyTorch version on the card,
               on the cases of tests/test_paged_kernel.py and
               tests/test_attention.py (K1, K2, K3 also at the training
               shape), max abs error beside the tolerance;
4. serve     - the serving path: transformer_lm("base") in bf16 with
               weights from --seed, a paged InferenceEngine (page 16, 8
               slots) and a Scheduler (harvest_lag 4) answering 16 greedy
               requests (prompts 64-1024 tokens, half sharing a 256-token
               prefix, 32 new tokens each), with kernel launch counts taken
               over it;
5. crosscheck - at base width and 2 layers in f32, the same requests
               through a kernel engine and a paged_kernel=False engine
               (identical greedy tokens), then one finished request scored
               by the cacheless forward (flash kernel), its logits held
               against the engine's prefill logits;
6. train     - the training path: transformer_lm("base", max_seq=4096),
               bf16 compute with f32 parameters, init_state(..., adamw(3e-4))
               and make_lm_train_step(), batches of 8 x 4096 synthetic
               Markov tokens (vocab 32000) through the DataLoader: 3
               warm-up and 10 timed steps, with kernel launch counts taken
               over the timed steps (K1, K2, K3 each once per layer and
               step), finite and falling loss, tokens/s and analytic MFU;
7. traincheck - one step at base width, 2 layers, batch 2 x 512, sgd(0.1),
               attn_impl='flash' (K1, K2, K3) against attn_impl='dense'
               (plain autograd) from the same weights and batch: loss,
               every gradient and every updated parameter, in f32 and bf16;
8. timing    - each kernel, its plain version and one library call at the
               main paths' shapes, with CUDA events.

``--phases profile`` (not in the default set) adds a serving run and two
training steps under torch.profiler (and host timers for serving): where
the main paths' time goes.  ``--phases train,traincheck`` drives the
training path alone.

It prints one ``{"kernels": [...]}`` line and, last, the
``{"ok": true, "device": {...}}`` line.  Without a CUDA device, or without
the dtdl_tpu_torch package beside it, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PHASES = ("build", "identity", "kernels", "serve", "crosscheck", "train",
          "traincheck", "timing")
DEV = "cuda"   # every phase runs on the card

# tolerances of the kernel-vs-plain checks, |got - want| <= atol + rtol·|want|
# on O(1) outputs: f32 differs by summation order and the online vs one-shot
# softmax only; bf16 also rounds the softmax weights to bf16 before P·V at a
# different normalization (running max vs final sum) and rounds the output
# to bf16, whose unit in the last place is 2^-7 relative
TOL = {"float32": (2e-5, 0.0), "bfloat16": (1e-2, 1e-2)}
LSE_TOL = 2e-4
CROSS_LOGIT_TOL = 2e-3     # f32 engine prefill vs cacheless forward logits
# the backward kernels against their plain versions on the same residuals,
# |got - want| <= atol + share·median|want| + rtol·|want|, per tensor, as
# (atol, share, rtol): f32 differs by summation order over up to 4096 keys.
# bf16 also rounds ds and p to bf16 before their products, where a score
# that differs in its last f32 bits can round the other way, and rounds the
# outputs to bf16 (one ulp is at most 2^-7 of the value).  The gradients'
# scale falls with the row (median |dq| ~0.025 at S = 4096), so a fixed
# atol of that size would pass a kernel that wrote zeros there: the bf16
# absolute term is a share of each tensor's median |want|, about 4 ulps
BWD_TOL = {"float32": (1e-4, 0.0, 1e-4), "bfloat16": (0.0, 2**-5, 2e-2)}
# traincheck, flash (K1-K3) vs dense (plain autograd) step: the loss within
# an absolute bound; each gradient, and each parameter's update, within a
# share of that tensor's largest dense value.  f32: summation order only;
# bf16: the two attentions round at different places (normalized weights
# vs unnormalized p and a normalized output), ~2^-8 relative per rounding,
# compounded over two layers and the tied head
TRAINCHECK_TOL = {"float32": dict(loss=1e-5, grad=1e-4),
                  "bfloat16": dict(loss=2e-2, grad=5e-2)}
TRAINCHECK_LR = 0.1

H100_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, no sparsity


def log(msg: str) -> None:
    print(msg, flush=True)


def card_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def paged_case(torch, gen, *, b, h, s_new, d, page, n_ptab, dtype, pos,
               inactive=(), quant=None, nan_dead=False):
    """Random pools, tables and queries on the card.  ``quant`` is None,
    'int8' (f32 scales) or 'fp8' (bf16 scales); with ``nan_dead`` every
    page no active row can see holds NaN (payload and scales) and a clean
    copy of the pools is returned beside it."""
    dev = DEV
    n_pages = b * n_ptab + 1
    kf = torch.randn(n_pages, h, page, d, generator=gen, device=dev)
    vf = torch.randn(n_pages, h, page, d, generator=gen, device=dev)
    table = (1 + torch.randperm(b * n_ptab, generator=gen, device=dev)
             ).reshape(b, n_ptab).to(torch.int32)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
    active = torch.ones(b, dtype=torch.bool, device=dev)
    for i in inactive:
        active[i] = False
    q = torch.randn(b, h, s_new, d, generator=gen, device=dev).to(dtype)
    ks = vs = None
    if quant is None:
        pk, pv = kf.to(dtype), vf.to(dtype)
    else:
        def quantize(x):
            amax = x.abs().amax(-1).clamp(min=1e-6)
            if quant == "int8":
                sc = amax / 127.0
                return (x / sc[..., None]).round().clamp(-127, 127).to(
                    torch.int8), sc
            sc = (amax / 448.0).to(torch.bfloat16)
            return (x / sc.float()[..., None]).clamp(-448, 448).to(
                torch.float8_e4m3fn), sc
        pk, ks = quantize(kf)
        pv, vs = quantize(vf)
    clean = (pk, pv, ks, vs)
    if nan_dead:
        live = {0}
        for i in range(b):
            if active[i]:
                last = (pos[i] + s_new - 1) // page
                live.update(int(p) for p in table[i, :last + 1].tolist())
        dead = torch.tensor([p for p in range(n_pages) if p not in live],
                            device=dev)

        def poison(x):
            if x is None or x.dtype in (torch.int8, torch.float8_e4m3fn):
                return x           # quantized pools: NaN goes in the scales
            y = x.clone()
            y[dead] = float("nan")
            return y
        pk, pv, ks, vs = (poison(x) for x in clean)
    return q, pk, pv, ks, vs, table, pos_t, active, clean


def sync(torch) -> None:
    if DEV == "cuda":
        torch.cuda.synchronize()


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def within(got, want, dtype) -> tuple[bool, str]:
    atol, rtol = TOL[str(dtype).split(".")[1]]
    diff = (got.float() - want.float()).abs()
    ok = bool((diff <= atol + rtol * want.float().abs()).all())
    return ok, f"tol=atol {atol:.0e} + rtol {rtol:.0e}"


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_paged(torch, results):
    from dtdl_tpu_torch.ops.paged_attention import (paged_attention,
                                                    paged_attention_reference)
    gen = torch.Generator(device=DEV).manual_seed(1)
    b, h, d, page, n_ptab = 8, 4, 128, 16, 128
    pos8 = [5, 70, 300, 511, 1000, 1500, 2000, 17]
    cases = [
        ("decode S=1 bf16", dict(b=b, s_new=1, dtype=torch.bfloat16,
                                 pos=pos8, inactive=(7,))),
        ("decode S=1 f32", dict(b=b, s_new=1, dtype=torch.float32,
                                pos=pos8, inactive=(7,))),
        ("verify S=5 bf16", dict(b=b, s_new=5, dtype=torch.bfloat16,
                                 pos=[p - 4 for p in pos8[:7]] + [0],
                                 inactive=(7,))),
        ("verify S=5 f32", dict(b=b, s_new=5, dtype=torch.float32,
                                pos=[p - 4 for p in pos8[:7]] + [0],
                                inactive=(7,))),
        ("prefill S=1024 pos=512 bf16", dict(b=1, s_new=1024,
                                              dtype=torch.bfloat16,
                                              pos=[512])),
        ("prefill S=1024 pos=512 f32", dict(b=1, s_new=1024,
                                             dtype=torch.float32,
                                             pos=[512])),
        ("prefill S=40 B=2 bf16 (split pages)", dict(
            b=2, s_new=40, dtype=torch.bfloat16, pos=[0, 700])),
        ("prefill S=300 pos=64 int8 pool", dict(
            b=1, s_new=300, dtype=torch.bfloat16, pos=[64], quant="int8")),
        ("prefill S=200 pos=16 fp8 pool NaN dead pages", dict(
            b=2, s_new=200, dtype=torch.bfloat16, pos=[16, 0],
            inactive=(1,), quant="fp8", nan_dead=True)),
        ("decode S=1 int8 pool", dict(b=b, s_new=1, dtype=torch.bfloat16,
                                      pos=pos8, inactive=(7,),
                                      quant="int8")),
        ("verify S=5 fp8 pool", dict(b=b, s_new=5, dtype=torch.bfloat16,
                                     pos=[p - 4 for p in pos8[:7]] + [0],
                                     inactive=(7,), quant="fp8")),
        ("decode S=1 NaN dead pages bf16", dict(
            b=b, s_new=1, dtype=torch.bfloat16, pos=pos8, inactive=(7,),
            nan_dead=True)),
        ("decode S=1 NaN dead pages fp8", dict(
            b=b, s_new=1, dtype=torch.bfloat16, pos=pos8, inactive=(7,),
            quant="fp8", nan_dead=True)),
    ]
    for dd in (16, 32, 64):
        cases.append((f"verify S=5 f32 head_dim={dd}", dict(
            b=4, s_new=5, dtype=torch.float32, pos=[3, 40, 100, 0],
            inactive=(3,), d=dd)))
        cases.append((f"prefill S=40 bf16 head_dim={dd}", dict(
            b=2, s_new=40, dtype=torch.bfloat16, pos=[0, 90], d=dd)))
    for name, kw in cases:
        kw = dict(kw)
        q, pk, pv, ks, vs, table, pos, active, clean = paged_case(
            torch, gen, h=h, d=kw.pop("d", d), page=page, n_ptab=n_ptab,
            **kw)
        scale = 1.0 / math.sqrt(q.shape[-1])
        got = paged_attention(q, pk, pv, table, pos, active, scale=scale,
                              key_scale=ks, value_scale=vs)
        ck, cv, cks, cvs = clean
        want = paged_attention_reference(q, ck, cv, table, pos, active,
                                         scale=scale, key_scale=cks,
                                         value_scale=cvs)
        sync(torch)
        err = max_err(got, want)
        close, tol = within(got, want, q.dtype)
        finite = bool(torch.isfinite(got).all())
        dead_rows_zero = bool((got[~active] == 0).all())
        ok = close and finite and dead_rows_zero
        log(f"K4 paged_attention {name}: max_abs_err={err:.3e} {tol}"
            f" finite={finite} inactive_rows_zero={dead_rows_zero}"
            f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K4 {name} disagrees with its plain version")
        results[name] = err


def check_flash(torch, results):
    from dtdl_tpu_torch.ops.attention import (flash_attention_reference,
                                              flash_fwd)
    gen = torch.Generator(device=DEV).manual_seed(2)
    cases = [
        ("train 8x4x4096 hd128 causal rope bf16", 8, 4, 4096, 4096, 128,
         torch.bfloat16, True, "rope"),
        ("self 2048 hd128 causal rope bf16", 2, 4, 2048, 2048, 128,
         torch.bfloat16, True, "rope"),
        ("self 2048 hd128 non-causal rope bf16", 2, 4, 2048, 2048, 128,
         torch.bfloat16, False, "rope"),
        ("self 2048 hd128 causal rope f32", 1, 4, 2048, 2048, 128,
         torch.float32, True, "rope"),
        ("cross 160/320 causal f32", 2, 2, 160, 320, 64, torch.float32,
         True, None),
        ("cross 160/320 non-causal f32", 2, 2, 160, 320, 64, torch.float32,
         False, None),
        ("ragged 200 causal f32", 2, 2, 200, 200, 64, torch.float32, True,
         None),
        ("ragged 200 non-causal rope bf16", 2, 2, 200, 200, 128,
         torch.bfloat16, False, "rope"),
        ("explicit rope positions causal f32", 2, 2, 256, 256, 128,
         torch.float32, True, "positions"),
        ("explicit rope positions causal bf16", 2, 2, 256, 256, 128,
         torch.bfloat16, True, "positions"),
        ("self 96 hd16 causal rope f32", 2, 4, 96, 96, 16, torch.float32,
         True, "rope"),
        ("self 96 hd32 causal f32", 2, 4, 96, 96, 32, torch.float32, True,
         None),
        ("self 96 hd16 causal rope bf16", 2, 4, 96, 96, 16, torch.bfloat16,
         True, "rope"),
        ("cross 100/260 hd32 causal bf16", 2, 2, 100, 260, 32,
         torch.bfloat16, True, None),
        ("ragged 200 hd64 non-causal rope bf16", 2, 2, 200, 200, 64,
         torch.bfloat16, False, "rope"),
    ]
    for name, b, h, sq, sk, d, dtype, causal, rope in cases:
        q = torch.randn(b, h, sq, d, generator=gen, device=DEV).to(dtype)
        k = torch.randn(b, h, sk, d, generator=gen, device=DEV).to(dtype)
        v = torch.randn(b, h, sk, d, generator=gen, device=DEV).to(dtype)
        scale = 1.0 / math.sqrt(d)
        ropet, positions, tabs = rope_tables(torch, gen, d, sq, sk, rope)
        o, lse = flash_fwd(q.reshape(b * h, sq, d), k.reshape(b * h, sk, d),
                           v.reshape(b * h, sk, d), tabs, scale=scale,
                           causal=causal)
        want_o, want_lse = flash_attention_reference(
            q, k, v, causal=causal, scale=scale, rope=ropet,
            rope_positions=positions)
        sync(torch)
        err = max_err(o.reshape(b, h, sq, d), want_o)
        lse_err = max_err(lse.reshape(b, h, sq), want_lse)
        close, tol = within(o.reshape(b, h, sq, d), want_o, dtype)
        ok = close and lse_err <= LSE_TOL
        log(f"K1 flash_fwd {name}: max_abs_err={err:.3e} {tol} "
            f"lse_err={lse_err:.3e} tol={LSE_TOL:.0e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K1 {name} disagrees with its plain version")
        results[name] = err


def rope_tables(torch, gen, d, sq, sk, rope):
    """(rope=(cos, sin), rope_positions, the kernels' rope rows) for a
    case: default positions (keys from 0, queries bottom-aligned) or
    sorted random explicit ones."""
    from dtdl_tpu_torch.ops.rope import rope_frequencies, rope_rows
    if rope is None:
        return None, None, None
    cos, sin = rope_frequencies(d, 4096, device=DEV)
    positions = None
    if rope == "positions":
        pos_q = torch.randperm(4096, generator=gen, device=DEV)[:sq].sort().values
        pos_k = torch.randperm(4096, generator=gen, device=DEV)[:sk].sort().values
        positions = (pos_q, pos_k)
    else:
        pos_k = torch.arange(sk, device=DEV)
        pos_q = (torch.arange(sq, device=DEV) + sk - sq).clamp(min=0)
    return (cos, sin), positions, rope_rows(cos, sin, pos_q) + rope_rows(
        cos, sin, pos_k)


# (name, b, h, sq, sk, head_dim, dtype, causal, rope) of the K2/K3 checks:
# the training shape, f32 at S = 1024, cross 160/320, ragged 200, explicit
# rope positions, rows that see no key (causal, sq > sk), head dims 16-64
BWD_CASES = [
    ("train 8x4x4096 hd128 causal rope bf16", 8, 4, 4096, 4096, 128, "bf16",
     True, "rope"),
    ("self 8x4x4096 hd128 non-causal rope bf16", 8, 4, 4096, 4096, 128,
     "bf16", False, "rope"),
    ("self 8x4x1024 hd128 causal rope f32", 8, 4, 1024, 1024, 128, "f32",
     True, "rope"),
    ("self 8x4x1024 hd128 non-causal rope f32", 8, 4, 1024, 1024, 128, "f32",
     False, "rope"),
    ("cross 160/320 causal f32", 2, 2, 160, 320, 64, "f32", True, None),
    ("cross 160/320 non-causal f32", 2, 2, 160, 320, 64, "f32", False, None),
    ("cross 160/320 causal bf16", 2, 2, 160, 320, 64, "bf16", True, None),
    ("cross 160/320 non-causal rope bf16", 2, 2, 160, 320, 128, "bf16",
     False, "rope"),
    ("ragged 200 causal f32", 2, 2, 200, 200, 64, "f32", True, None),
    ("ragged 200 causal rope bf16", 2, 2, 200, 200, 128, "bf16", True,
     "rope"),
    ("ragged 200 non-causal rope bf16", 2, 2, 200, 200, 128, "bf16", False,
     "rope"),
    ("explicit rope positions causal f32", 2, 2, 256, 256, 128, "f32", True,
     "positions"),
    ("explicit rope positions causal bf16", 2, 2, 256, 256, 128, "bf16",
     True, "positions"),
    ("causal sq>sk 320/160 f32 (rows that see no key)", 2, 2, 320, 160, 64,
     "f32", True, None),
    ("causal sq>sk 320/160 bf16 (rows that see no key)", 2, 2, 320, 160, 64,
     "bf16", True, None),
] + [case for dd in (16, 32, 64) for case in (
    (f"self 96 hd{dd} causal rope f32", 2, 4, 96, 96, dd, "f32", True,
     "rope"),
    (f"self 200 hd{dd} causal rope bf16", 2, 4, 200, 200, dd, "bf16", True,
     "rope"))]


def check_flash_bwd(torch, results):
    """K2 and K3 against their plain versions on the same residuals: the
    plain forward's o and lse, delta = rowsum(dO∘O)."""
    from dtdl_tpu_torch.ops.attention import (flash_attention_reference,
                                              flash_bwd_dkv,
                                              flash_bwd_dkv_reference,
                                              flash_bwd_dq,
                                              flash_bwd_dq_reference)
    gen = torch.Generator(device=DEV).manual_seed(5)
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    for name, b, h, sq, sk, d, dtype, causal, rope in BWD_CASES:
        dtype = dtypes[dtype]
        q, do = (torch.randn(b, h, sq, d, generator=gen, device=DEV).to(dtype)
                 for _ in range(2))
        k, v = (torch.randn(b, h, sk, d, generator=gen, device=DEV).to(dtype)
                for _ in range(2))
        scale = 1.0 / math.sqrt(d)
        ropet, positions, tabs = rope_tables(torch, gen, d, sq, sk, rope)
        with torch.no_grad():
            o, lse = flash_attention_reference(q, k, v, causal=causal,
                                               scale=scale, rope=ropet,
                                               rope_positions=positions)
        flat = [x.reshape(b * h, x.shape[2], d) for x in (q, k, v, do)]
        lse = lse.reshape(b * h, sq)
        delta = (do.float() * o.float()).sum(-1).reshape(b * h, sq)
        args = (*flat, lse, delta, tabs)
        kw = dict(scale=scale, causal=causal)
        got = (flash_bwd_dq(*args, **kw), *flash_bwd_dkv(*args, **kw))
        sync(torch)
        want = (flash_bwd_dq_reference(*args, **kw),)
        want += flash_bwd_dkv_reference(*args, **kw)
        sync(torch)
        atol0, share, rtol = BWD_TOL[str(dtype).split(".")[1]]
        errs, parts, ok = [], [], True
        for label, g, w in zip(("dq", "dk", "dv"), got, want):
            w = w.float()
            diff = (g.float() - w).abs()
            med = float(w.abs().median())
            atol = atol0 + share * med
            # the worst element's share of its tolerance
            used = float((diff / (atol + rtol * w.abs()).clamp(
                min=1e-30)).max())
            ok &= used <= 1.0 and bool(torch.isfinite(g).all())
            errs.append(float(diff.max()))
            parts.append(f"{label}={errs[-1]:.3e} (median |want| {med:.3e}, "
                         f"atol {atol:.2e}, worst {used:.3f} of tol)")
        del got, want
        log(f"K2/K3 flash_bwd {name}: max_abs_err " + " ".join(parts)
            + f" tol=atol {atol0:.0e} + {share:.4g}·median|want| + rtol "
            f"{rtol:.0e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K2/K3 {name} disagree with their plain "
                                 f"versions")
        results["bwd " + name] = errs


# ---------------------------------------------------------------------------
# phases 4 and 5: serving
# ---------------------------------------------------------------------------

def make_traffic(seed: int, vocab: int, n: int = 16, new_tokens: int = 32):
    import numpy as np
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, 256).tolist()
    lens = rng.integers(64, 1025, n)
    out = []
    for i, length in enumerate(lens):
        if i % 2 == 0:
            tail = max(int(length) - 256, 1)
            prompt = prefix + rng.integers(0, vocab, tail).tolist()
        else:
            prompt = rng.integers(0, vocab, int(length)).tolist()
        out.append((prompt, new_tokens))
    return out


def serve(torch, model, traffic, *, paged_kernel="auto"):
    from dtdl_tpu_torch.serve.engine import InferenceEngine
    from dtdl_tpu_torch.serve.scheduler import Request, Scheduler
    eng = InferenceEngine(model, n_slots=8, page_size=16,
                          paged_kernel=paged_kernel, device=DEV)
    sched = Scheduler(eng, harvest_lag=4, device=DEV)
    reqs = [Request(p, m) for p, m in traffic]
    sync(torch)
    t0 = time.perf_counter()
    sched.run(reqs)
    sync(torch)
    wall = time.perf_counter() - t0
    return eng, sched, reqs, wall


def phase_serve(torch, seed):
    from dtdl_tpu_torch import kernels
    from dtdl_tpu_torch.models.transformer import transformer_lm
    model = transformer_lm("base", seed=seed, dtype=torch.bfloat16,
                           device=DEV)
    traffic = make_traffic(seed, model.cfg.vocab_size)
    serve(torch, model, traffic[:2])            # warm-up: cuBLAS, allocator
    kernels.reset_launches()
    eng, sched, reqs, wall = serve(torch, model, traffic)
    launches = dict(kernels.LAUNCHES)
    bad = [r for r in reqs if not r.done or r.error or len(r.tokens) != 32]
    if bad:
        raise AssertionError(f"serving left unfinished requests: {bad}")
    if launches["paged_attention"] <= 0:
        raise AssertionError("the main path never launched K4")
    s = sched.metrics.summary()
    n_tok = sum(len(r.tokens) for r in reqs)
    log(f"serve base bf16: requests={len(reqs)} tokens={n_tok} "
        f"prompt_tokens={sum(len(p) for p, _ in traffic)} wall_s={wall:.4f} "
        f"tokens_per_s={n_tok / wall:.2f} "
        f"decode_tokens_per_s={s['decode_tokens_per_sec']:.2f} "
        f"ttft_p50_s={s['ttft_s_p50']:.4f} ttft_p99_s={s['ttft_s_p99']:.4f} "
        f"prefix_hit_pages={s['prefix_hit_pages']} "
        f"prefill_tokens_saved={s['prefill_tokens_saved']} "
        f"decode_steps={s['decode_steps']} launches={launches}")
    return launches, traffic


def phase_crosscheck(torch, seed, traffic):
    import numpy as np
    from dtdl_tpu_torch import kernels
    from dtdl_tpu_torch.models.transformer import transformer_lm
    from dtdl_tpu_torch.serve.engine import InferenceEngine
    model = transformer_lm("base", n_layers=2, seed=seed,
                           dtype=torch.float32, device=DEV)
    _, _, with_kernel, _ = serve(torch, model, traffic)
    _, _, plain, _ = serve(torch, model, traffic, paged_kernel=False)
    a = [r.tokens for r in with_kernel]
    b = [r.tokens for r in plain]
    if a != b:
        diff = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
        raise AssertionError(f"kernel and plain engines disagree on "
                             f"requests {diff}")
    log(f"crosscheck base 2-layer f32: kernel and plain engines gave "
        f"identical greedy tokens for {len(a)} requests")
    # score the longest request without the shared prefix with the
    # cacheless forward
    req = max(with_kernel[1::2], key=lambda r: len(r.prompt))
    prompt = list(req.prompt)
    eng = InferenceEngine(model, n_slots=8, page_size=16, device=DEV)
    arena, last = eng.init_arena(), eng.init_last_tokens()
    n_pg = -(-len(prompt) // eng.page_size)
    row = np.zeros(eng.n_ptab, np.int32)
    row[:n_pg] = np.arange(1, n_pg + 1)
    _, _, engine_logits = eng.prefill(arena, last, 0, prompt, page_row=row)
    kernels.reset_launches()
    with torch.no_grad():
        full = model(torch.tensor([prompt + req.tokens[:-1]],
                                  device=DEV))[0]
    sync(torch)
    flash_launches = kernels.LAUNCHES["flash_fwd"]
    if flash_launches < model.cfg.n_layers:
        raise AssertionError("the cacheless forward did not run K1")
    err = max_err(full[len(prompt) - 1], engine_logits)
    greedy = full[len(prompt) - 1:].argmax(-1).tolist()
    agree = sum(int(x == y) for x, y in zip(greedy, req.tokens))
    ok = err <= CROSS_LOGIT_TOL and greedy[0] == req.tokens[0]
    log(f"crosscheck cacheless forward (K1) vs engine prefill logits: "
        f"max_abs_err={err:.3e} tol={CROSS_LOGIT_TOL:.0e}; greedy agreement "
        f"{agree}/{len(req.tokens)} tokens; flash launches={flash_launches} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("cacheless forward disagrees with the engine")
    return flash_launches, len(prompt) + len(req.tokens) - 1


# ---------------------------------------------------------------------------
# phases 6 and 7: training
# ---------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ = 8, 4096


def train_setup(torch, seed, n_batches, batch, seq):
    """The training path's pieces, as a user builds them: synthetic Markov
    tokens (vocab 32000) through the DataLoader, transformer_lm("base",
    max_seq=seq) with bf16 compute and f32 weights from ``seed``, an
    adamw(3e-4) state and the step."""
    from dtdl_tpu_torch.data.loader import DataLoader
    from dtdl_tpu_torch.data.sharding import ShardedSampler
    from dtdl_tpu_torch.data.synthetic import synthetic_lm
    from dtdl_tpu_torch.models.transformer import transformer_lm
    from dtdl_tpu_torch.train.optim import adamw
    from dtdl_tpu_torch.train.state import init_state
    from dtdl_tpu_torch.train.step import make_lm_train_step
    tokens, _ = synthetic_lm(n_train=batch * n_batches, n_test=batch,
                             seq_len=seq, vocab_size=32000, seed=seed)
    loader = DataLoader({"tokens": tokens}, batch,
                        sampler=ShardedSampler(len(tokens), seed=seed),
                        device=DEV)
    model = transformer_lm("base", max_seq=seq, seed=None, device=DEV)
    state = init_state(model, seed, adamw(3e-4), device=DEV)
    return state, make_lm_train_step(), iter(loader)


def phase_train(torch, seed, warmup: int = 3, steps: int = 10):
    from dtdl_tpu_torch import kernels
    from dtdl_tpu_torch.obs.goodput import lm_train_flops, peak_flops_per_chip
    state, step, batches = train_setup(torch, seed, warmup + steps,
                                       TRAIN_BATCH, TRAIN_SEQ)
    cfg = state.model.cfg
    losses = []
    for _ in range(warmup):
        state, metrics = step(state, next(batches))
        losses.append(metrics["loss"])
    sync(torch)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = step(state, next(batches))
        losses.append(metrics["loss"])
    sync(torch)
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    losses = [float(x) for x in losses]
    peak_mem = torch.cuda.max_memory_allocated() / 2**30
    flops = lm_train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    peak = peak_flops_per_chip()
    step_ms = 1e3 * wall / steps
    tokens_per_s = TRAIN_BATCH * (TRAIN_SEQ - 1) * steps / wall
    mfu = flops * steps / wall / peak if peak else None
    log(f"train base bf16 (f32 weights) adamw(3e-4) batch {TRAIN_BATCH}x"
        f"{TRAIN_SEQ}: steps={steps} (after {warmup} warm-up) wall_s="
        f"{wall:.4f} step_ms={step_ms:.2f} tokens_per_s={tokens_per_s:.1f} "
        f"flops_per_step={flops:.4e} mfu={mfu if mfu is None else round(mfu, 5)} "
        f"peak_mem_gib={peak_mem:.2f} loss_first={losses[0]:.5f} "
        f"loss_last={losses[-1]:.5f} launches={launches}")
    log("train losses: " + " ".join(f"{x:.5f}" for x in losses))
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    want = cfg.n_layers * steps
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        if launches[name] != want:
            raise AssertionError(f"{name} launched {launches[name]} times in "
                                 f"{steps} steps, want {want} (one per layer "
                                 f"and step)")
    del state, step, batches
    torch.cuda.empty_cache()
    return launches, dict(step_ms=step_ms, tokens_per_s=tokens_per_s,
                          mfu=mfu)


def phase_traincheck(torch, seed):
    """One make_lm_train_step step through the flash kernels and one
    through dense attention (plain autograd), same weights and batch."""
    from dtdl_tpu_torch import kernels
    from dtdl_tpu_torch.data.synthetic import markov_tokens
    from dtdl_tpu_torch.models.transformer import transformer_lm
    from dtdl_tpu_torch.train.optim import sgd
    from dtdl_tpu_torch.train.state import init_state
    from dtdl_tpu_torch.train.step import make_lm_train_step
    tokens = markov_tokens(2, 512, 32000, seed=seed + 1)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        tol = TRAINCHECK_TOL[name]
        out = {}
        for impl in ("flash", "dense"):
            model = transformer_lm("base", n_layers=2, max_seq=512,
                                   dtype=dtype, attn_impl=impl, seed=None,
                                   device=DEV)
            state = init_state(model, seed, sgd(TRAINCHECK_LR), device=DEV)
            kernels.reset_launches()
            state, metrics = make_lm_train_step()(state, {"tokens": tokens})
            sync(torch)
            out[impl] = (float(metrics["loss"]), dict(kernels.LAUNCHES),
                         {n: p.grad.detach().clone()
                          for n, p in model.named_parameters()},
                         {n: p.detach().clone()
                          for n, p in model.named_parameters()})
            del state, model
        (lf, launches, gf, pf), (ld, launches_d, gd, pd) = (out["flash"],
                                                            out["dense"])
        # sgd is linear in the gradient: an updated parameter may differ by
        # the gradient tolerance times the learning rate, plus the f32
        # rounding of p - lr·g itself (two units in the last place)
        eps = torch.finfo(torch.float32).eps
        grad_err = upd_err = 0.0
        for n in gd:
            gmax = float(gd[n].abs().max())
            grad_err = max(grad_err, float((gf[n] - gd[n]).abs().max())
                           / max(gmax, 1e-30))
            bound = (TRAINCHECK_LR * tol["grad"] * gmax
                     + 2 * eps * float(pd[n].abs().max()))
            upd_err = max(upd_err, float((pf[n] - pd[n]).abs().max())
                          / max(bound, 1e-30))
        ok = (abs(lf - ld) <= tol["loss"] and grad_err <= tol["grad"]
              and upd_err <= 1.0 and math.isfinite(lf))
        kernels_ran = all(launches[k] == 2 for k in
                          ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
        dense_plain = launches_d["flash_fwd"] == 0 == launches_d[
            "flash_bwd_dq"]
        log(f"traincheck base 2-layer {name} flash (K1-K3) vs dense step: "
            f"loss {lf:.6f} vs {ld:.6f} (|d|={abs(lf - ld):.3e} tol "
            f"{tol['loss']:.0e}); worst gradient err {grad_err:.3e} of the "
            f"tensor's max (tol {tol['grad']:.0e}); worst updated-parameter "
            f"err {upd_err:.3f} of its bound; {len(gd)} tensors; flash launches "
            f"{launches} {'ok' if ok and kernels_ran else 'FAIL'}")
        if not (ok and kernels_ran and dense_plain):
            raise AssertionError(f"traincheck {name}: the flash step disagrees "
                                 f"with the dense step")


def phase_profile_train(torch, seed, steps: int = 2):
    """Device time of training steps by kernel (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    state, step, batches = train_setup(torch, seed, steps + 2, TRAIN_BATCH,
                                       TRAIN_SEQ)
    for _ in range(2):
        state, _ = step(state, next(batches))
    sync(torch)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state, metrics = step(state, next(batches))
        sync(torch)
    wall = time.perf_counter() - t0
    kernel_rows = [e for e in prof.key_averages()
                   if "CUDA" in str(e.device_type)]
    dev_total = sum(e.self_device_time_total for e in kernel_rows) / 1e3
    log(f"profile train {steps} steps: wall {wall:.4f}s (traced), device "
        f"kernel time {dev_total / steps:.2f} ms per step")
    # the step's parts, by kernel name
    groups = {"K1 flash_fwd": ("flash_fwd",), "K2 bwd_dq": ("bwd_dq",),
              "K3 bwd_dkv": ("bwd_dkv",),
              "GEMM (cuBLAS)": ("nvjet", "gemm", "xmma", "cutlass"),
              "optimizer": ("multi_tensor",)}
    spent = dict.fromkeys([*groups, "other (elementwise, reductions, "
                           "copies)"], 0.0)
    for e in kernel_rows:
        name = next((g for g, keys in groups.items()
                     if any(k in e.key for k in keys)),
                    "other (elementwise, reductions, copies)")
        spent[name] += e.self_device_time_total / 1e3
    for name, ms in spent.items():
        log(f"  {ms / steps:9.2f} ms/step  {100 * ms / dev_total:5.1f}%  "
            f"{name}")
    for e in sorted(kernel_rows, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  {e.self_device_time_total / 1e3 / steps:9.2f} ms/step "
            f"{e.count // steps:5d}x/step  {e.key[:70]}")
    del state, step, batches
    torch.cuda.empty_cache()


def phase_profile(torch, seed):
    """Where a serving run's time goes: host seconds inside prefill,
    decode dispatch and the harvest wait (wrapped timers), and device
    time by kernel from torch.profiler, over the main path's traffic."""
    from torch.profiler import ProfilerActivity, profile
    from dtdl_tpu_torch.models.transformer import transformer_lm
    from dtdl_tpu_torch.serve import engine as eng_mod
    from dtdl_tpu_torch.serve import scheduler as sched_mod
    model = transformer_lm("base", seed=seed, dtype=torch.bfloat16,
                           device=DEV)
    traffic = make_traffic(seed, model.cfg.vocab_size)
    serve(torch, model, traffic[:2])
    spent = {"prefill": [0.0, 0], "decode": [0.0, 0], "harvest": [0.0, 0]}

    def timed(name, fn):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[name][0] += time.perf_counter() - t0
                spent[name][1] += 1
        return wrapper
    E, S = eng_mod.InferenceEngine, sched_mod.Scheduler
    originals = (E.prefill, E.decode, S._harvest_one)
    E.prefill = timed("prefill", E.prefill)
    E.decode = timed("decode", E.decode)
    S._harvest_one = timed("harvest", S._harvest_one)
    try:
        _, _, _, wall = serve(torch, model, traffic)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            serve(torch, model, traffic)
    finally:
        E.prefill, E.decode, S._harvest_one = originals
    log(f"profile host (untraced run, wall {wall:.4f}s): " + ", ".join(
        f"{k} {v[0]:.4f}s/{v[1]} calls (both runs)"
        for k, v in spent.items()))
    events = prof.key_averages()
    dev_total = sum(e.self_device_time_total for e in events) / 1e6
    log(f"profile device busy {dev_total:.4f}s (sum of kernel self time, "
        f"traced run)")
    rows = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    for e in rows:
        log(f"  {e.self_device_time_total / 1e3:9.2f} ms  {e.count:6d}x  "
            f"{e.key[:70]}")


# ---------------------------------------------------------------------------
# phase 6: timing
# ---------------------------------------------------------------------------

def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Device milliseconds per call: the calls are queued behind a ~0.1 s
    spin kernel, so the events time the card's work back to back and not
    the host's launch overhead between calls."""
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_paged(torch, *, b, s_new, pos, dtype=None):
    """K4, its plain version, bound: at the engine's pool geometry."""
    from dtdl_tpu_torch.ops.paged_attention import (paged_attention,
                                                    paged_attention_reference)
    dtype = dtype or torch.bfloat16
    gen = torch.Generator(device=DEV).manual_seed(3)
    h, d, page, n_ptab = 4, 128, 16, 128
    q, pk, pv, _, _, table, pos_t, active, _ = paged_case(
        torch, gen, b=b, h=h, s_new=s_new, d=d, page=page, n_ptab=n_ptab,
        dtype=dtype, pos=pos)
    scale = 1.0 / math.sqrt(d)
    run = lambda: paged_attention(q, pk, pv, table, pos_t, active,  # noqa: E731
                                  scale=scale)
    plain = lambda: paged_attention_reference(  # noqa: E731
        q, pk, pv, table, pos_t, active, scale=scale)
    ms = cuda_ms(torch, run)
    plain_ms = cuda_ms(torch, plain, iters=5)
    el = pk.element_size()
    live_pages = sum((p + s_new - 1) // page + 1 for p in pos)
    nbytes = (2 * live_pages * page * h * d * el          # live K and V
              + 2 * q.numel() * q.element_size()          # q in, o out
              + b * n_ptab * 4 + 2 * b * 4)               # table, pos, active
    visible = sum((p + i + 1) for p in pos for i in range(s_new))
    ops = 4 * visible * h * d
    name = str(dtype).split(".")[1]
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[name] * 1e3
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=None, bytes=nbytes, ops=ops)


def time_flash(torch, *, b, h, s, d, dtype, causal=True):
    """K1, its plain version, SDPA on pre-roped inputs, bound."""
    import torch.nn.functional as F
    from dtdl_tpu_torch.ops.attention import (flash_attention_reference,
                                              flash_fwd)
    from dtdl_tpu_torch.ops.rope import (apply_rope, rope_frequencies,
                                         rope_rows)
    gen = torch.Generator(device=DEV).manual_seed(4)
    q, k, v = (torch.randn(b, h, s, d, generator=gen, device=DEV).to(dtype)
               for _ in range(3))
    cos, sin = rope_frequencies(d, s, device=DEV)
    rows = rope_rows(cos, sin, torch.arange(s, device=DEV))
    flat = [x.reshape(b * h, s, d) for x in (q, k, v)]
    with torch.no_grad():
        run = lambda: flash_fwd(*flat, rows + rows,  # noqa: E731
                                scale=1 / math.sqrt(d), causal=causal)
        ms = cuda_ms(torch, run)
        plain_ms = cuda_ms(torch, lambda: flash_attention_reference(
            q, k, v, causal=causal, rope=(cos, sin)), iters=5)
        qr, kr = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qr, kr, v, is_causal=causal))
    el = q.element_size()
    nbytes = 4 * b * h * s * d * el + b * h * s * 4 + 4 * s * d * 4
    ops = 4 * b * h * s * s * d // (2 if causal else 1)
    name = str(dtype).split(".")[1]
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[name] * 1e3
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=library_ms, bytes=nbytes, ops=ops)


def time_flash_bwd(torch):
    """K2 and K3 at the training path's shape (bf16, causal, fused rope,
    8 x 4 heads x 4096 x 128): each kernel, its plain version, the bound,
    and torch.autograd.grad through SDPA (pre-roped inputs), one figure
    for the pair."""
    import torch.nn.functional as F
    from dtdl_tpu_torch.ops.attention import (flash_bwd_dkv,
                                              flash_bwd_dkv_reference,
                                              flash_bwd_dq,
                                              flash_bwd_dq_reference,
                                              flash_fwd)
    from dtdl_tpu_torch.ops.rope import (apply_rope, rope_frequencies,
                                         rope_rows)
    b, h, s, d = TRAIN_BATCH, 4, TRAIN_SEQ, 128
    bh = b * h
    gen = torch.Generator(device=DEV).manual_seed(6)
    q, k, v, do = (torch.randn(b, h, s, d, generator=gen, device=DEV).to(
        torch.bfloat16) for _ in range(4))
    cos, sin = rope_frequencies(d, s, device=DEV)
    rows = rope_rows(cos, sin, torch.arange(s, device=DEV))
    tabs = rows + rows
    scale = 1 / math.sqrt(d)
    flat = [x.reshape(bh, s, d) for x in (q, k, v, do)]
    out = {}
    with torch.no_grad():
        o, lse = flash_fwd(*flat[:3], tabs, scale=scale, causal=True)
        delta = (flat[3].float() * o.float()).sum(-1)
        args = (*flat, lse, delta, tabs)
        kw = dict(scale=scale, causal=True)
        runs = {
            "K2": (lambda: flash_bwd_dq(*args, **kw),
                   lambda: flash_bwd_dq_reference(*args, **kw)),
            "K3": (lambda: flash_bwd_dkv(*args, **kw),
                   lambda: flash_bwd_dkv_reference(*args, **kw)),
        }
        for name, (run, plain) in runs.items():
            out[name] = dict(ms=cuda_ms(torch, run),
                             plain_ms=cuda_ms(torch, plain, iters=3,
                                              warmup=1))
    qr, kr, vr = (x.detach().requires_grad_()
                  for x in (apply_rope(q, cos, sin), apply_rope(k, cos, sin),
                            v))
    o_lib = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)
    pair_ms = cuda_ms(torch, lambda: torch.autograd.grad(
        o_lib, (qr, kr, vr), do, retain_graph=True))
    out["K2"]["library_ms"] = out["K3"]["library_ms"] = pair_ms
    el, half = 2, bh * s * s * d // 2
    tensor, rowf, tab = bh * s * d * el, bh * s * 4, 4 * s * d * 4
    # K2 reads q, k, v, dO, lse, delta and writes dq; K3 writes dk and dv
    work = {"K2": (5 * tensor + 2 * rowf + tab, 6 * half),
            "K3": (6 * tensor + 2 * rowf + tab, 8 * half)}
    for name, (nbytes, ops) in work.items():
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS["bfloat16"] * 1e3
        out[name].update(bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops else
                         "operations", bytes=nbytes, ops=ops)
    return out


def fmt_timing(name, t):
    return (f"{name}: ms={t['ms']:.4f} plain_ms={t['plain_ms']:.4f} "
            f"library_ms={t['library_ms'] if t['library_ms'] is None else round(t['library_ms'], 4)} "
            f"bound_ms={t['bound_ms']:.5f} ({t['bound_by']}; "
            f"bytes={t['bytes']} ops={t['ops']}) "
            f"share_of_bound={t['bound_ms'] / t['ms']:.3f}")


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)}")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES) - {"profile"}
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; nothing was run",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "dtdl_tpu_torch")):
        print("chip_smoke: the dtdl_tpu_torch package is not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from dtdl_tpu_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False    # f32 references in f32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_identity()

    if "build" in phases:
        t0 = time.perf_counter()
        kernels.build(verbose=True)
        log_path = kernels.BUILD_DIR / "build.log"
        log_path.write_text("\n".join(kernels.BUILD_LOG))
        lines = "\n".join(kernels.BUILD_LOG).splitlines()
        regs = [int(m[1]) for m in (re.search(r"Used (\d+) registers", x)
                                    for x in lines) if m]
        spills = [x.strip() for x in lines
                  if (m := re.search(r"(\d+) bytes spill stores, (\d+) "
                                     r"bytes spill loads", x))
                  and (int(m[1]) or int(m[2]))]
        log(f"build: {len(regs)} kernels in {time.perf_counter() - t0:.1f}s, "
            f"registers max {max(regs) if regs else 'n/a'}, spilling "
            f"entries {len(spills)} (log {log_path})")
        for s in spills[:8]:
            log(f"  ptxas: {s}")
        kernels.lib()
    if "identity" in phases:
        log(f"card: {card} (torch {torch.__version__}, CUDA "
            f"{torch.version.cuda}, {torch.cuda.get_device_name(0)})")

    errors = {}
    if "kernels" in phases:
        check_paged(torch, errors)
        check_flash(torch, errors)
        check_flash_bwd(torch, errors)

    k4_launches = None
    train_launches = {}
    traffic = None
    scoring_len = 1024
    if "serve" in phases:
        launches, traffic = phase_serve(torch, args.seed)
        k4_launches = launches["paged_attention"]
    if "crosscheck" in phases:
        if traffic is None:
            traffic = make_traffic(args.seed, 32000)
        _, scoring_len = phase_crosscheck(torch, args.seed, traffic)
    if "train" in phases:
        train_launches, _ = phase_train(torch, args.seed)
    if "traincheck" in phases:
        phase_traincheck(torch, args.seed)

    if "profile" in phases:
        phase_profile(torch, args.seed)
        phase_profile_train(torch, args.seed)
    if "timing" in phases:
        # K4 at the main path's decode shape: 8 slots, pool of the engine
        # (page 16, 128 pages per slot), positions spread as the traffic's
        pos = [100, 250, 400, 550, 700, 850, 1000, 1050]
        k4 = time_paged(torch, b=8, s_new=1, pos=pos)
        log(fmt_timing("time K4 decode S=1 B=8 bf16", k4))
        k4p = time_paged(torch, b=1, s_new=512, pos=[256])
        log(fmt_timing("time K4 prefill S=512 pos=256 bf16", k4p))
        # K1 at the scoring forward's shape (f32, one sequence, 4 heads)
        k1 = time_flash(torch, b=1, h=4, s=scoring_len, d=128,
                        dtype=torch.float32)
        log(fmt_timing(f"time K1 causal S={scoring_len} f32", k1))
        k1b = time_flash(torch, b=2, h=4, s=2048, d=128, dtype=torch.bfloat16)
        log(fmt_timing("time K1 causal S=2048 B=2 bf16", k1b))
        # K1, K2, K3 at the training path's shape
        tr = time_flash_bwd(torch)
        tr["K1"] = time_flash(torch, b=TRAIN_BATCH, h=4, s=TRAIN_SEQ, d=128,
                              dtype=torch.bfloat16)
        for name in ("K1", "K2", "K3"):
            log(fmt_timing(f"time {name} train shape 8x4x4096 hd128 causal "
                           f"rope bf16", tr[name]))
        main_case = "train 8x4x4096 hd128 causal rope bf16"
        bwd_errs = errors.get("bwd " + main_case)
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        line = {"kernels": [
            {"name": "flash_fwd", "route": "cuda",
             "source": "dtdl_tpu_torch/csrc/flash_fwd.cu",
             "replaces": "dtdl_tpu/ops/attention.py:271",
             "launches": train_launches.get("flash_fwd"),
             "max_abs_err": errors.get(main_case),
             **{k: tr["K1"][k] for k in keys}},
            {"name": "flash_bwd_dq", "route": "cuda",
             "source": "dtdl_tpu_torch/csrc/flash_bwd.cu",
             "replaces": "dtdl_tpu/ops/attention.py:408",
             "launches": train_launches.get("flash_bwd_dq"),
             "max_abs_err": bwd_errs and bwd_errs[0],
             **{k: tr["K2"][k] for k in keys}},
            {"name": "flash_bwd_dkv", "route": "cuda",
             "source": "dtdl_tpu_torch/csrc/flash_bwd.cu",
             "replaces": "dtdl_tpu/ops/attention.py:475",
             "launches": train_launches.get("flash_bwd_dkv"),
             "max_abs_err": bwd_errs and max(bwd_errs[1:]),
             **{k: tr["K3"][k] for k in keys}},
            {"name": "paged_attention", "route": "cuda",
             "source": "dtdl_tpu_torch/csrc/paged_attention.cu",
             "replaces": "dtdl_tpu/ops/paged_attention.py:88",
             "launches": k4_launches,
             "max_abs_err": errors.get("decode S=1 bf16"),
             **{k: k4[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")}},
        ]}
        log(json.dumps(line))

    log(f"total {time.perf_counter() - t_start:.1f}s")
    log(card)
    if set(PHASES) <= set(phases):
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
