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
               tests/test_attention.py, max abs error beside the tolerance;
4. serve     - the main path: transformer_lm("base") in bf16 with weights
               from --seed, a paged InferenceEngine (page 16, 8 slots) and a
               Scheduler (harvest_lag 4) answering 16 greedy requests
               (prompts 64-1024 tokens, half sharing a 256-token prefix, 32
               new tokens each), with kernel launch counts taken over it;
5. crosscheck - at base width and 2 layers in f32, the same requests
               through a kernel engine and a paged_kernel=False engine
               (identical greedy tokens), then one finished request scored
               by the cacheless forward (flash kernel), its logits held
               against the engine's prefill logits;
6. timing    - each kernel, its plain version and one library call at the
               main path's shapes, with CUDA events.

``--phases profile`` (not in the default set) adds a serving run under
torch.profiler and host timers: where the main path's time goes.

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
PHASES = ("build", "identity", "kernels", "serve", "crosscheck", "timing")
DEV = "cuda"   # every phase runs on the card

# tolerances of the kernel-vs-plain checks, |got - want| <= atol + rtol·|want|
# on O(1) outputs: f32 differs by summation order and the online vs one-shot
# softmax only; bf16 also rounds the softmax weights to bf16 before P·V at a
# different normalization (running max vs final sum) and rounds the output
# to bf16, whose unit in the last place is 2^-7 relative
TOL = {"float32": (2e-5, 0.0), "bfloat16": (1e-2, 1e-2)}
LSE_TOL = 2e-4
CROSS_LOGIT_TOL = 2e-3     # f32 engine prefill vs cacheless forward logits

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
    from dtdl_tpu_torch.ops.rope import rope_frequencies, rope_rows
    gen = torch.Generator(device=DEV).manual_seed(2)
    cases = [
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
        tabs = positions = ropet = None
        if rope is not None:
            cos, sin = rope_frequencies(d, 4096, device=DEV)
            ropet = (cos, sin)
            if rope == "positions":
                pos_q = torch.randperm(4096, generator=gen,
                                       device=DEV)[:sq].sort().values
                pos_k = pos_q.clone()
                positions = (pos_q, pos_k)
            else:
                pos_k = torch.arange(sk, device=DEV)
                pos_q = (torch.arange(sq, device=DEV) + sk - sq).clamp(
                    min=0)
            tabs = rope_rows(cos, sin, pos_q) + rope_rows(cos, sin, pos_k)
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
    cos, sin = rope_frequencies(d, 2048, device=DEV)
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

    k4_launches = k1_launches = None
    traffic = None
    scoring_len = 1024
    if "serve" in phases:
        launches, traffic = phase_serve(torch, args.seed)
        k4_launches = launches["paged_attention"]
    if "crosscheck" in phases:
        if traffic is None:
            traffic = make_traffic(args.seed, 32000)
        k1_launches, scoring_len = phase_crosscheck(torch, args.seed,
                                                    traffic)

    if "profile" in phases:
        phase_profile(torch, args.seed)
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
        line = {"kernels": [
            {"name": "flash_fwd", "route": "cuda",
             "source": "dtdl_tpu_torch/csrc/flash_fwd.cu",
             "replaces": "dtdl_tpu/ops/attention.py:271",
             "launches": k1_launches,
             "max_abs_err": errors.get("self 2048 hd128 causal rope f32"),
             **{k: k1[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")}},
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
