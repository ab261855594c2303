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
               shape, and the bf16 bodies at the edges of their tiles; K1's
               f32 body on rows that see no key), max abs error beside the
               tolerance; the rope pre-pass bitwise, K2 and K3 bitwise from
               run to run; K4's split-KV decode called three times in a row,
               bitwise equal each time, with splits of which many are empty
               and with one split;
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
5b. spec     - speculative decoding on the serving engine (n-gram and
               model drafts, verify steps through K4's window body, each
               launching K4 once per layer): f32 spec tokens identical to
               plain decode but at near-ties, bf16 serving of the serve
               phase's requests plain and with speculate=4 (tokens/s, TTFT,
               acceptance, identity up to each request's first near-tie),
               a random 2-layer draft model lossless, and K4 timed at the
               verify geometry;
5c. chunked  - chunked prefill (chunk_tokens=256, prompt windows of up to
               257 through K4's prefill body at B = 8): at 2 layers in f32
               tokens identical to whole-prompt prefill (chunked, and with
               speculate=4) but at near-ties; the serve phase's bf16
               requests chunked and whole-prompt in alternating pairs
               (tokens/s, TTFT, decode steps delayed by prefill, verify
               steps by width, K4 launches, 8 in every step), identity up
               to each request's first near-tie;
5d. quant    - the same requests on bf16, int8 (weights and KV) and fp8
               engines: prefill logits of 4 prompts through K4 against the
               plain attend, and against the bf16 engine's within the
               stated share of the logit range (at 2 layers), tokens/s,
               TTFT, pages per kv_pool_bytes budget, K4 launches with
               quantized pools;
5e. contain  - at base width, 2 layers: a raise injected into one engine's
               decode fails the requests in flight, the queued ones are
               served with a clean run's tokens and the pages come back;
               cancel, shutdown with and without drain, the accounting
               invariant;
5f. dense    - the dense arena (page_size=0) at base width, 2 layers, f32:
               tokens identical to the paged engine's, plain and chunked;
5g. moe_serve - transformer_lm("base-moe8") (MoE every second block,
               8 experts, routed top-1, capacity 1.25): the serve phase's
               requests in bf16 and on an int8 engine (experts quantized,
               int8 KV) through K4 (tokens/s, TTFT, K4 launches, prefill
               logit drift); K4 vs plain attend at 2 layers in f32
               (identical tokens) and at full depth in bf16 (requests
               served alone, each parting explained by a router or logit
               near-tie); at capacity factor 8 (nothing drops), 2 layers,
               f32, chunked and speculative tokens equal to whole-prompt
               and plain ones;
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
7b. moe_train - the train phase on transformer_lm("base-moe8",
               max_seq=4096): step ms, tokens/s, MFU (activated experts
               only), peak memory, loss and the Switch aux loss, K1, K2, K3
               once per layer and step;
7c. moe_traincheck - traincheck at base-moe8 width, 2 layers (one MoE
               block): routing identical in f32; in bf16 every token the
               two steps route apart is a router near-tie;
7d. classify - the classifier path (no kernel of K1-K4: cuDNN convs,
               cuBLAS Dense layers): train-step throughput cells timed as
               bench.py times them, bf16 compute with f32 weights and BN
               statistics, sgd(0.1, momentum 0.9): pyramidnet() (110
               layers, alpha 270) at batch 64 and 256 (and at 256 with
               channel_align=8), resnet50() at batch 256 (samples/s, step
               ms, analytic MFU, peak memory, first and last loss); then
               train_epoch over synthetic CIFAR-10 through the DataLoader
               and the train transform at batch 64, and evaluate over 1000
               test images (a ragged last batch);
7e. classifycheck - (1) one f32 SGD step of a small PyramidNet and a small
               ResNet on the card against the CPU from the same bridged
               weights and batch (loss, accuracy, every parameter and BN
               statistic, eval logits); (3) PyramidNet-110 bf16 learns the
               synthetic task in 90 steps through the loop; (2) its eval
               logits in bf16 within the stated budget of f32;
7f. ddp      - data-parallel training through the port's launcher
               (python -m dtdl_tpu_torch.launch.local; each rank is this
               script with --ddp-worker): (1) an NCCL world of one, the
               base LM in bf16 at 8 x 4096 with adamw: the DDP step's
               parameters after 3 steps bitwise equal to the single-device
               step's, K1-K3 once per layer and DDP step, step ms and
               tokens/s of both in turns, the bucketed allreduce alone;
               (2) two gloo ranks on the one card, f32: the small LM and
               the MLP against the single-device step on the global batch,
               the ranks' parameter digests equal; what NCCL says for two
               ranks on one card (recorded); (3) the DDP twin
               (examples.distributed_data_parallel: PyramidNet-110, global
               batch 64, 24 steps and one evaluate over synthetic CIFAR-10)
               at world 1 over NCCL and 2 over gloo: leader-only log and
               weights, the weights loading back to every rank's digest,
               BatchNorm statistics equal across ranks, samples/s; (4) a
               launch in which one rank exits 3 returns 3 within 20 s;
7g. resume   - snapshot and resume through the Trainer: (a) the train
               phase's base LM recipe (8 x 4096, bf16, adamw) uninterrupted
               to 8 iterations against a run that snapshots at 3 and stops
               at 5, then a fresh Trainer and Checkpointer that resume
               mid-epoch (12 batches an epoch) and run to 8: params, Adam
               moments, step and LogReport records bitwise equal, K1, K2,
               K3 once per layer and step in every run; (c) on the resumed
               state, save() and at once a step: the restored snapshot is
               bitwise the pre-step state; snapshot bytes, save() ms until
               it returns, seconds until durable and committed, restore
               seconds, the step overlapping the write against steps
               without; (b) PyramidNet-110 bf16 at batch 64 with SGD +
               momentum + StepLR the same at 6/3/4 iterations, bitwise
               under cuDNN's deterministic algorithms (set for that check
               only); (d) the mnist_single twin (2 epochs, load_latest,
               evaluate) and the train_mnist twin (2 epochs, then --resume
               of its snapshot) as subprocesses;
7h. faces    - the last example twins, each as a user runs it: (a)
               serve_lm on base at full width, bf16, page 16 (16 requests
               with a 256-token shared prefix, 32 new tokens, greedy):
               tokens/s, TTFT, K4 launches (one per layer and attend),
               greedy tokens identical to the same requests through the
               serve phase's engine path with the plain attend (a parting
               only at a bf16 near-tie, reported); (b) imagenet_resnet50
               at 224 px, 1000 classes, batch 256, 40 steps over a
               1024-image pool:
               samples/s, ms/step and MFU, the train-pool accuracy; (c)
               caffe_train on examples/caffe/lenet_solver.prototxt to 600
               iterations, then --snapshot latest to 800 (the resume starts
               at 600): iterations/s and MFU by netspec_flops; (d)
               tf_estimator to 400 steps, then again (it restores 400 and
               trains nothing); (e) mxnet_kvstore --kv-store device, one
               epoch; (f) single_device and data_parallel, one epoch of 2560
               images each; each twin's output in build/faces/<twin>.log;
8. timing    - each kernel (and the rope pre-pass that K1 and K3 run
               first), its plain version and one library call at the main
               paths' shapes (K4 also at the chunk window S = 257 and at
               decode with int8 and fp8 pools), and the quantized
               projections against the bf16 one, with CUDA events.

``--phases profile`` (not in the default set) adds a serving run, two
training steps of base and of base-moe8, and one PyramidNet-110 batch-256
step under torch.profiler (and host timers for serving and the
classifier step): where the main paths' time goes.  ``--phases
train,traincheck`` drives the training path alone.

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
PHASES = ("build", "identity", "kernels", "serve", "crosscheck", "spec",
          "chunked", "quant", "contain", "dense", "moe_serve", "train",
          "traincheck", "moe_train", "moe_traincheck", "classify",
          "classifycheck", "ddp", "resume", "faces", "timing")
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
# MoE routing: two computations of one router input that differ by
# rounding (flash vs dense attention, K4 vs the plain attend, in bf16)
# may send a token to different experts only where its first and second
# experts' probs lie within this gap.  bf16 rounds at 2^-8 relative; over
# up to 8 layers the router's input moves by a few such units, its
# logits (of size ~1) by ~1e-2, and its probs (~0.1-0.5) by less than
# 0.03
ROUTER_TAU = 0.03
# spec, the near-tie rule: a speculative run may part from the plain run
# only at a position where the plain run's top two logits lie within tau,
# since there the verify pass (k+1 rows in each product, K4's window body
# and split count) and the decode step (1 row) can round to another
# argmax.  In f32 the two passes differ by summation order only, ~1e-5 on
# these logits; TAU_F32 leaves 100x room and is still a tie at any logit
# scale that matters.  The bf16 tau is measured in the phase, with no
# kernel in the measurement: twice the largest |logit of one forward of
# width k+1 - logit of k+1 single-token forwards| over the same positions
# through the plain attend (each of the two leading logits can move by
# that much).  The logits are bf16 values (the head's product rounds to
# bf16), so that delta is whole units in the last place (ulp, 2^-7 of the
# largest logit's power of two).  Rounding alone moves them by a few
# ulps; an attend that drops or misplaces keys moves a logit by a fair
# share of itself.  A delta past SPEC_DELTA_ULPS of them (2^-4 of the
# largest logit's power of two) fails the phase, K4's own wide-vs-narrow
# delta as well as the plain one
SPEC_K = 4
TAU_F32 = 1e-3
SPEC_DELTA_ULPS = 8

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
    # chunked prefill's windows (S = k_prog + 1: 33, and 257 at
    # chunk_tokens=256) at the engine batch B = 8 with per-row positions
    # and two rows inactive, through the prefill body; int8 and fp8 pools
    chunk_pos = [0, 16, 250, 700, 1000, 1500, 30, 1790]
    cases += [
        ("chunk S=33 B=8 bf16", dict(b=b, s_new=33, dtype=torch.bfloat16,
                                     pos=chunk_pos, inactive=(2, 6))),
        ("chunk S=257 B=8 bf16", dict(b=b, s_new=257, dtype=torch.bfloat16,
                                      pos=chunk_pos, inactive=(2, 6))),
        ("chunk S=257 B=8 int8 pool", dict(
            b=b, s_new=257, dtype=torch.bfloat16, pos=chunk_pos,
            inactive=(2, 6), quant="int8")),
        ("chunk S=33 B=8 fp8 pool NaN dead pages", dict(
            b=b, s_new=33, dtype=torch.bfloat16, pos=chunk_pos,
            inactive=(2, 6), quant="fp8", nan_dead=True)),
    ]
    # the widths the speculative path gives K4 (S = k+1 for k = 1, 2, 8
    # through the window body, k = 16 through the prefill body) at the
    # engine's geometry: each live window straddles a page boundary
    for s_new in (2, 3, 9, 17):
        spec_pos = [x - s_new // 2 for x in
                    (16, 80, 304, 512, 1008, 1504, 2016)] + [0]
        for dt in (torch.bfloat16, torch.float32):
            cases.append((f"verify S={s_new} {str(dt).split('.')[1]} "
                          f"(windows across a page)",
                          dict(b=b, s_new=s_new, dtype=dt, pos=spec_pos,
                               inactive=(7,))))
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
    check_paged_splits(torch, results)


def check_paged_splits(torch, results):
    """K4's bf16 decode with its split-KV merge inside the launch: a
    geometry with n_splits > 1 called three times in a row (the arrival
    counters come back to zero: bitwise equal each time), one where most
    splits are empty (small positions, many splits), and one with
    n_splits == 1 (enough rows to fill the card), each held to the plain
    version."""
    from dtdl_tpu_torch.ops.paged_attention import (_sm_count, kv_splits,
                                                    paged_attention,
                                                    paged_attention_reference)
    gen = torch.Generator(device=DEV).manual_seed(10)
    h, d, page = 4, 128, 16
    sms = _sm_count(torch.device(DEV)) if DEV == "cuda" else 132
    cases = [
        ("split decode S=1 repeated", 8, 128, 1,
         [100, 250, 400, 550, 700, 850, 1000, 1050], "many"),
        ("split decode S=1 empty splits", 8, 128, 1,
         [0, 1, 2, 3, 5, 8, 15, 16], "many"),
        ("split verify S=5 empty splits", 8, 128, 5,
         [0, 1, 2, 30, 50, 80, 150, 160], "many"),
        ("split decode S=1 one split", 80, 64, 1, list(range(0, 1000, 12)),
         "one"),
    ]
    for name, b, n_ptab, s_new, pos, want_splits in cases:
        q, pk, pv, _, _, table, pos_t, active, _ = paged_case(
            torch, gen, b=b, h=h, s_new=s_new, d=d, page=page, n_ptab=n_ptab,
            dtype=torch.bfloat16, pos=pos[:b])
        n_splits = kv_splits(b, h, s_new, n_ptab, sms)
        if (n_splits == 1) != (want_splits == "one"):
            raise AssertionError(f"K4 {name}: {n_splits} splits")
        scale = 1.0 / math.sqrt(d)
        outs = [paged_attention(q, pk, pv, table, pos_t, active, scale=scale)
                for _ in range(3)]
        want = paged_attention_reference(q, pk, pv, table, pos_t, active,
                                         scale=scale)
        sync(torch)
        err = max_err(outs[0], want)
        close, tol = within(outs[0], want, q.dtype)
        repeat = all(bool(torch.equal(outs[0], o)) for o in outs[1:])
        ok = close and repeat and bool(torch.isfinite(outs[0]).all())
        log(f"K4 paged_attention {name}: n_splits={n_splits} "
            f"max_abs_err={err:.3e} {tol} bitwise_over_3_calls={repeat} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K4 {name} disagrees with its plain version "
                                 f"or with itself")
        results[name] = err


# the edges of the bf16 bodies' tiles (K1: 128 q rows x 128 keys; K2: 128
# q rows x 128 keys; K3: 128 keys x 64 q rows) at every head dim, with and
# without rope, causal and not: exact multiples (128, 256), ragged (200),
# cross (160/320) and rows that see no key (causal 320/160)
EDGE_CASES = [(sq, sk, d, causal, rope)
              for sq, sk in ((128, 128), (256, 256), (200, 200), (160, 320),
                             (320, 160))
              for d in (16, 32, 64, 128) for causal in (True, False)
              for rope in (None, "rope")]
# K2's own edges: ragged rows and keys (130/70), one 128-row tile holding
# rows that see no key beside rows that do (causal 200/100), few rows over
# many keys (64/192)
DQ_EDGE_CASES = [(sq, sk, d, causal, rope)
                 for sq, sk in ((130, 70), (200, 100), (64, 192))
                 for d in (16, 32, 64, 128) for causal in (True, False)
                 for rope in (None, "rope")]


def check_rope(torch, results):
    """The rope pre-pass of K1 and K3 against its plain version (_rotate):
    bitwise, at the training shape and at default and explicit positions."""
    from dtdl_tpu_torch.ops.attention import _rotate, rope_rotate
    from dtdl_tpu_torch.ops.rope import rope_frequencies, rope_rows
    gen = torch.Generator(device=DEV).manual_seed(8)
    cases = [("train 32x4096 hd128 bf16", 32, 4096, 128, torch.bfloat16,
              False)]
    cases += [(f"200 hd{d} {str(dt).split('.')[1]} "
               f"{'explicit' if ex else 'default'} positions", 4, 200, d, dt,
               ex) for d in (16, 32, 64, 128)
              for dt in (torch.bfloat16, torch.float32) for ex in (False, True)]
    for name, bh, s, d, dtype, explicit in cases:
        x = torch.randn(bh, s, d, generator=gen, device=DEV).to(dtype)
        cos, sin = rope_frequencies(d, 4096, device=DEV)
        pos = (torch.randperm(4096, generator=gen, device=DEV)[:s].sort().values
               if explicit else torch.arange(s, device=DEV))
        c, sn = rope_rows(cos, sin, pos)
        got, want = rope_rotate(x, c, sn), _rotate(x, c, sn)
        sync(torch)
        same = bool(torch.equal(got, want))
        err = max_err(got, want)
        log(f"rope pre-pass {name}: bitwise_equal={same} max_abs_err="
            f"{err:.3e} {'ok' if same else 'FAIL'}")
        if not same:
            raise AssertionError(f"rope pre-pass {name} differs from _rotate")
        results["rope " + name] = err


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
        ("causal sq>sk 100/40 f32 (rows that see no key)", 2, 2, 100, 40, 64,
         torch.float32, True, None),
        ("causal sq>sk 320/160 hd128 rope f32 (rows that see no key)", 2, 2,
         320, 160, 128, torch.float32, True, "rope"),
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
    ] + [(f"edge {sq}/{sk} hd{d} {'causal' if causal else 'non-causal'}"
          f"{' rope' if rope else ''} bf16", 1, 2, sq, sk, d, torch.bfloat16,
          causal, rope) for sq, sk, d, causal, rope in EDGE_CASES]
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
     "rope"))] + [
    (f"edge {sq}/{sk} hd{d} {'causal' if causal else 'non-causal'}"
     f"{' rope' if rope else ''} bf16", 1, 2, sq, sk, d, "bf16", causal, rope)
    for sq, sk, d, causal, rope in EDGE_CASES + DQ_EDGE_CASES]


def check_flash_bwd(torch, results):
    """K2 and K3 (through flash_bwd, one rope pre-pass for the pair)
    against their plain versions on the same residuals: the plain
    forward's o and lse, delta = rowsum(dO∘O); each again on its own,
    bitwise equal."""
    from dtdl_tpu_torch.ops.attention import (flash_attention_reference,
                                              flash_bwd, flash_bwd_dkv,
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
        if dtype == torch.bfloat16 and causal and sq > sk:
            # rows that see no key weight every key with p = 1, so their ds
            # is of dp's size; dO and v on a grid of 1/8 make dp = dO·vᵀ
            # exact in the kernels and the plain versions alike, so no
            # one-ulp bf16 flip of ds, from dp's last f32 bit, decides
            do, v = (((x.float() * 8).round() / 8).to(dtype) for x in (do, v))
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
        got = flash_bwd(*args, **kw)
        again = (flash_bwd_dq(*args, **kw), *flash_bwd_dkv(*args, **kw))
        sync(torch)
        # no atomics: K2 and K3 give the same bits from run to run
        repro = all(bool(torch.equal(x, y)) for x, y in zip(got, again))
        del again
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
            ok &= used <= 1.0 and bool(torch.isfinite(g).all()) and repro
            errs.append(float(diff.max()))
            parts.append(f"{label}={errs[-1]:.3e} (median |want| {med:.3e}, "
                         f"atol {atol:.2e}, worst {used:.3f} of tol)")
        del got, want
        log(f"K2/K3 flash_bwd {name}: max_abs_err " + " ".join(parts)
            + f" tol=atol {atol0:.0e} + {share:.4g}·median|want| + rtol "
            f"{rtol:.0e} K2_K3_bitwise_repeatable={repro} "
            f"{'ok' if ok else 'FAIL'}")
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


def serve(torch, model, traffic, *, paged_kernel="auto", speculate=0,
          draft=None, verify_launches=None, step_launches=None,
          verify_widths=None, chunk_tokens=None, page_size=16,
          **engine_kw):
    """Serve ``traffic`` through a fresh engine (page 16 unless
    ``page_size`` says otherwise, 0 the dense arena; 8 slots) and
    scheduler (harvest lag 4).  ``verify_launches`` and ``step_launches``,
    lists, receive the K4 launches of each verify step and of each step
    (decode or verify); ``verify_widths`` each verify step's draft width
    k.  ``engine_kw`` goes to the engine (``quantize_weights``,
    ``kv_dtype``, ...)."""
    from dtdl_tpu_torch import kernels
    from dtdl_tpu_torch.serve.engine import InferenceEngine
    from dtdl_tpu_torch.serve.scheduler import Request, Scheduler
    eng = InferenceEngine(model, n_slots=8, page_size=page_size,
                          paged_kernel=paged_kernel, device=DEV, **engine_kw)

    def counted(fn, is_verify):
        def wrapper(*args, **kwargs):
            before = kernels.LAUNCHES["paged_attention"]
            out = fn(*args, **kwargs)
            n = kernels.LAUNCHES["paged_attention"] - before
            if is_verify and verify_launches is not None:
                verify_launches.append(n)
            if is_verify and verify_widths is not None:
                verify_widths.append(args[2].shape[1])
            if step_launches is not None:
                step_launches.append(n)
            return out
        return wrapper
    if verify_launches is not None or verify_widths is not None \
            or step_launches is not None:
        eng.verify = counted(eng.verify, True)
    if step_launches is not None:
        eng.decode = counted(eng.decode, False)
    sched = Scheduler(eng, harvest_lag=4, device=DEV, draft=draft,
                      chunk_tokens=chunk_tokens)
    reqs = [Request(p, m, speculate=speculate) for p, m in traffic]
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
# phase 5b: speculative decoding
# ---------------------------------------------------------------------------

def prefill_logits(torch, model, seq):
    """The last position's logits of an engine prefill of ``seq``."""
    import numpy as np
    from dtdl_tpu_torch.serve.engine import InferenceEngine
    eng = InferenceEngine(model, n_slots=1, page_size=16, device=DEV)
    row = np.zeros(eng.n_ptab, np.int32)
    n_pg = -(-len(seq) // eng.page_size)
    row[:n_pg] = np.arange(1, n_pg + 1)
    _, _, logits = eng.prefill(eng.init_arena(), eng.init_last_tokens(), 0,
                               list(seq), page_row=row)
    return logits


def logit_gap(torch, model, prompt, tokens, j) -> float:
    """The top-two logit gap where the plain run emitted ``tokens[j]``:
    the last position's logits of an engine prefill of prompt +
    tokens[:j] (a prefill, not the decode step itself, so it carries the
    same rounding differences as the thing it judges)."""
    top = torch.topk(prefill_logits(torch, model,
                                    list(prompt) + list(tokens[:j])), 2).values
    return float(top[0] - top[1])


def near_tie_divergences(torch, model, plain, spec, tau):
    """Each request's first position where the speculative (or other)
    tokens part from the plain ones, with the plain run's top-two gap
    there; raises unless every such gap is within ``tau``."""
    out = []
    for a, b in zip(plain, spec):
        j = next((i for i, (x, y) in enumerate(zip(a.tokens, b.tokens))
                  if x != y), None)
        if j is None and len(a.tokens) == len(b.tokens):
            continue
        if j is None:
            raise AssertionError(f"request {a.rid}: lengths "
                                 f"{len(a.tokens)} vs {len(b.tokens)}")
        out.append((j, logit_gap(torch, model, a.prompt, a.tokens, j)))
    far = [(j, g) for j, g in out if g > tau]
    if far:
        raise AssertionError(f"tokens part from plain decode "
                             f"at (position, top-two gap) {far}, beyond "
                             f"the near-tie tau {tau:.3e}")
    return out


def verify_vs_decode_delta(torch, model, traffic, plain_reqs, k=SPEC_K):
    """max |logit of one forward of width k+1 - logit of the k+1 single-
    token forwards| over the same positions, through the plain attend and
    through K4: 8 slots prefilled with the requests' prompts, the plain
    run's next k+1 tokens fed both ways on copies of the arena.  Returns
    (plain delta, K4 delta, max |logit| of the plain wide forward)."""
    import copy
    import numpy as np
    from dtdl_tpu_torch.serve.engine import InferenceEngine
    eng = InferenceEngine(model, n_slots=8, page_size=16, device=DEV)
    pg, B = eng.page_size, eng.n_slots
    arena, last = eng.init_arena(), eng.init_last_tokens()
    tables = np.zeros((B, eng.n_ptab), np.int32)
    nxt = 1
    for slot, ((prompt, _), req) in enumerate(zip(traffic, plain_reqs)):
        n_pg = -(-(len(prompt) + k + 1) // pg)
        tables[slot, :n_pg] = np.arange(nxt, nxt + n_pg)
        nxt += n_pg
        arena, last, _ = eng.prefill(arena, last, slot, prompt,
                                     page_row=tables[slot])
    x = torch.tensor([r.tokens[:k + 1] for r in plain_reqs], device=DEV)
    pos = arena["index"].clone()
    act = torch.ones(B, dtype=torch.bool, device=DEV)
    tab = torch.tensor(tables, device=DEV)
    out = []
    for kernel in (False, True):
        wide_arena, narrow_arena = copy.deepcopy(arena), copy.deepcopy(arena)
        with torch.no_grad():
            wide = eng.model(x, pos=pos, cache=wide_arena, page_table=tab,
                             active=act, paged_kernel=kernel)
            narrow = torch.stack([
                eng.model(x[:, i:i + 1], pos=pos + i, cache=narrow_arena,
                          page_table=tab, active=act,
                          paged_kernel=kernel)[:, 0]
                for i in range(k + 1)], dim=1)
        out.append((max_err(wide, narrow), float(wide.abs().max())))
    (plain, scale), (k4, _) = out
    return plain, k4, scale


class OracleDraft:
    """Drafts the plain run's own continuation while the context still
    follows it, and nothing once it has parted: the perfect source."""

    def __init__(self, traffic, plain_reqs):
        self.seqs = [list(p) + list(r.tokens)
                     for (p, _), r in zip(traffic, plain_reqs)]

    def propose(self, ctx, k):
        import numpy as np
        ctx = [int(t) for t in ctx]
        for full in self.seqs:
            if ctx == full[:len(ctx)]:
                return np.asarray(full[len(ctx):len(ctx) + k], np.int32)
        return np.zeros((0,), np.int32)


def oracle_run(torch, model, traffic, plain_reqs, tau, label, lag=4):
    """Serve ``traffic`` at speculate=SPEC_K with drafts from the plain
    run's own tokens: multi-token commits at width SPEC_K, rollbacks,
    page growth over accepted windows.  Only a near-tie parting (tau)
    rejects a draft: that window and those dispatched before it is
    harvested (at most ``lag`` more, each of at most SPEC_K drafts),
    after which the oracle drafts nothing for the request.  Raises
    unless every verify step launched K4 once per layer, width SPEC_K
    ran, and the rejections are within what the partings explain."""
    n_layers = model.cfg.n_layers
    launches = []
    _, sched, reqs, wall = serve(torch, model, traffic, speculate=SPEC_K,
                                 draft=OracleDraft(traffic, plain_reqs),
                                 verify_launches=launches)
    if not launches or set(launches) != {n_layers}:
        raise AssertionError(f"{label} oracle verify steps launched K4 "
                             f"{launches} times, want {n_layers} each")
    ties = near_tie_divergences(torch, model, plain_reqs, reqs, tau)
    bad = [r for r, (_, n) in zip(reqs, traffic)
           if not r.done or r.error or len(r.tokens) != n]
    if bad:
        raise AssertionError(f"{label} oracle speculative serving left {bad}")
    O = sched.metrics.summary()
    rejected = O["spec_drafted_tokens"] - O["spec_accepted_tokens"]
    most = (lag + 1) * SPEC_K * len(ties)
    n_tok = sum(len(r.tokens) for r in reqs)
    log(f"spec oracle {label} speculate={SPEC_K}: {len(reqs)} requests "
        f"tokens_per_s={n_tok / wall:.2f} spec_steps_by_k="
        f"{O['spec_steps_by_k']} decode_steps={O['decode_steps']} "
        f"acceptance={O['spec_acceptance_rate']:.4f} drafted="
        f"{O['spec_drafted_tokens']} rejected={rejected} (at most {most}: "
        f"{len(ties)} near-tie partings {ties}) K4 launches {n_layers} in "
        f"each of {len(launches)} verify steps")
    if SPEC_K not in O["spec_steps_by_k"]:
        raise AssertionError(f"the {label} oracle run never verified at "
                             f"width {SPEC_K}: {O['spec_steps_by_k']}")
    if rejected > most:
        raise AssertionError(f"the {label} oracle run rejected {rejected} "
                             f"drafts, more than the {most} its partings "
                             f"explain")
    return O


def phase_spec(torch, seed):
    from dtdl_tpu_torch import kernels
    from dtdl_tpu_torch.models.transformer import transformer_lm
    from dtdl_tpu_torch.serve.draft import ModelDraft, NGramDraft
    vocab = 32000
    traffic = make_traffic(seed, vocab)
    out = {}

    # (a) f32: identity but at near-ties
    m32 = transformer_lm("base", seed=seed, dtype=torch.float32, device=DEV)
    n_layers = m32.cfg.n_layers
    t8 = traffic[:8]
    _, _, plain32, _ = serve(torch, m32, t8)
    launches = []
    _, s32, spec32, _ = serve(torch, m32, t8, speculate=SPEC_K,
                              draft=NGramDraft(), verify_launches=launches)
    if not launches or set(launches) != {n_layers}:
        raise AssertionError(f"f32 verify steps launched K4 {launches} "
                             f"times, want {n_layers} each")
    ties = near_tie_divergences(torch, m32, plain32, spec32, TAU_F32)
    a = s32.metrics.summary()
    log(f"spec (a) base f32 ngram speculate={SPEC_K}: {len(t8)} requests, "
        f"near-tie divergences={len(ties)} {ties} (tau {TAU_F32:.0e}); "
        f"spec_steps_by_k={a['spec_steps_by_k']} acceptance="
        f"{a['spec_acceptance_rate']:.4f} K4 per verify step={n_layers} "
        f"over {len(launches)} steps")
    oracle_run(torch, m32, t8, plain32, TAU_F32, "f32")

    # (c) a random 2-layer draft model at vocab 32000, lossless by (a)'s rule
    draft_model = transformer_lm("tiny", vocab_size=vocab, seed=seed + 1,
                                 device=DEV)
    md = ModelDraft(draft_model, window=32, warmup=SPEC_K)
    mlaunch = []
    _, smd, specmd, _ = serve(torch, m32, t8[:4], speculate=SPEC_K,
                              draft=md, verify_launches=mlaunch)
    if not mlaunch or set(mlaunch) != {n_layers}:
        raise AssertionError(f"model-draft verify steps launched K4 "
                             f"{mlaunch} times, want {n_layers} each")
    ties_md = near_tie_divergences(torch, m32, plain32[:4], specmd, TAU_F32)
    c = smd.metrics.summary()
    log(f"spec (c) ModelDraft (tiny width, 2 layers, vocab {vocab}, random "
        f"weights) on base f32: 4 requests, near-tie divergences="
        f"{len(ties_md)} {ties_md}; spec_steps={c['spec_steps']} "
        f"acceptance={c['spec_acceptance_rate']:.4f} "
        f"draft_s={c['draft_s']:.4f}")
    del m32

    # (b) bf16 serving, plain and speculate=4, the serve phase's requests
    m16 = transformer_lm("base", seed=seed, dtype=torch.bfloat16,
                         device=DEV)
    serve(torch, m16, traffic[:2], speculate=SPEC_K)       # warm-up
    _, sp, plain16, wall_p = serve(torch, m16, traffic)
    launches = []
    kernels.reset_launches()
    _, ss, spec16, wall_s = serve(torch, m16, traffic, speculate=SPEC_K,
                                  draft=NGramDraft(),
                                  verify_launches=launches)
    k4 = kernels.LAUNCHES["paged_attention"]
    if not launches or set(launches) != {n_layers}:
        raise AssertionError(f"bf16 verify steps launched K4 {launches} "
                             f"times, want {n_layers} each")
    delta, delta_k4, scale = verify_vs_decode_delta(torch, m16, traffic[:8],
                                                    plain16[:8])
    ulp = 2.0 ** (math.floor(math.log2(scale)) - 7)
    ceiling = SPEC_DELTA_ULPS * ulp
    if delta > ceiling or delta_k4 > ceiling:
        raise AssertionError(
            f"bf16 wide-vs-narrow logit delta {delta:.4e} (plain attend), "
            f"{delta_k4:.4e} (K4) beyond {SPEC_DELTA_ULPS} ulps "
            f"({ceiling:.4e}) of the largest logit {scale:.4e}")
    tau16 = 2 * delta
    ties16 = near_tie_divergences(torch, m16, plain16, spec16, tau16)
    bad = [r for r in spec16 if not r.done or r.error or len(r.tokens) != 32]
    if bad:
        raise AssertionError(f"speculative serving left {bad}")
    P, S = sp.metrics.summary(), ss.metrics.summary()
    n_tok = sum(len(r.tokens) for r in spec16)
    log(f"spec (b) base bf16 ngram speculate={SPEC_K}: requests="
        f"{len(spec16)} tokens={n_tok} wall_s={wall_s:.4f} tokens_per_s="
        f"{n_tok / wall_s:.2f} (plain in the same call: {n_tok / wall_p:.2f}"
        f", wall_s={wall_p:.4f}) ttft_p50_s={S['ttft_s_p50']:.4f} "
        f"ttft_p99_s={S['ttft_s_p99']:.4f} (plain {P['ttft_s_p50']:.4f}/"
        f"{P['ttft_s_p99']:.4f}) decode_steps={S['decode_steps']} (plain "
        f"{P['decode_steps']}) spec_steps_by_k={S['spec_steps_by_k']} "
        f"acceptance={S['spec_acceptance_rate']:.4f} drafted="
        f"{S['spec_drafted_tokens']} accepted={S['spec_accepted_tokens']} "
        f"draft_s={S['draft_s']:.4f} K4 launches={k4} ({n_layers} in each "
        f"of {len(launches)} verify steps)")
    log(f"spec (b) identity: max |wide - narrow logit| over 8 slots x "
        f"{SPEC_K + 1} positions = {delta:.4e} through the plain attend, "
        f"{delta_k4:.4e} through K4 (ceiling {SPEC_DELTA_ULPS} ulps = "
        f"{ceiling:.4e} at the largest logit {scale:.4e}), tau_bf16 = "
        f"{tau16:.4e}; requests parting at a near-tie: {len(ties16)} of "
        f"{len(spec16)} {ties16}")

    # (b') the same requests with the perfect draft source
    O = oracle_run(torch, m16, traffic, plain16, tau16, "bf16")
    by_k = {kk: S["spec_steps_by_k"].get(kk, 0)
            + O["spec_steps_by_k"].get(kk, 0)
            for kk in set(S["spec_steps_by_k"]) | set(O["spec_steps_by_k"])}

    # (d) K4 at the verify geometry of speculate=4 (S = 5), and at every
    # width the two bf16 runs dispatched, with their launches there
    pos = [100, 250, 400, 550, 700, 850, 1000, 1050]
    for k in sorted(set(by_k) | {SPEC_K}):
        t = time_paged(torch, b=8, s_new=k + 1, pos=pos)
        n = by_k.get(k, 0) * n_layers
        out[k + 1] = dict(t, launches=n)
        log(fmt_timing(f"time K4 verify S={k + 1} B=8 bf16 (launches in "
                       f"the two bf16 spec runs: {n})", t))
    return out


# ---------------------------------------------------------------------------
# phases 5c-5f: chunked prefill, quantized serving, containment, dense arena
# ---------------------------------------------------------------------------

CHUNK_TOKENS = 256
# the engine positions of K4's chunk-window cases and timing (B = 8, each
# row's window of up to 257 inside max_seq 2048)
CHUNK_POS = [0, 16, 250, 700, 1000, 1500, 30, 1790]
# quant, the stated parity budget of tests/test_quant.py (a 2-layer model):
# the quantized engines' prefill logits within this share of the bf16
# engine's logit range (int8 weights and KV 5%, fp8 3x that), held at 2
# layers; at full depth the drift is reported (fp8's relative rounding
# grows with depth past the budget)
QUANT_REL_TOL = {"int8": 0.05, "fp8": 0.15}
QUANT_MODES = {"bf16": {},
               "int8": dict(quantize_weights=True, kv_dtype="int8"),
               "fp8": dict(quantize_weights="w8f", kv_dtype="fp8")}


def chunk_vs_whole_delta(torch, model, traffic, width=CHUNK_TOKENS + 1):
    """max |last prompt position's logit of a whole-prompt prefill - that
    of the same prompt fed in windows of ``width`` tokens| over the
    requests, through the plain attend and through K4: the rounding that
    chunked prefill adds (other matmul shapes, other attend tiles)."""
    import numpy as np
    from dtdl_tpu_torch.serve.engine import InferenceEngine
    out = []
    for kernel in (False, True):
        eng = InferenceEngine(model, n_slots=1, page_size=16,
                              paged_kernel=kernel, device=DEV)
        worst = 0.0
        for prompt, _ in traffic:
            row = np.zeros(eng.n_ptab, np.int32)
            n_pg = -(-len(prompt) // eng.page_size)
            row[:n_pg] = np.arange(1, n_pg + 1)
            _, _, whole = eng.prefill(eng.init_arena(),
                                      eng.init_last_tokens(), 0, prompt,
                                      page_row=row)
            arena = eng.init_arena()
            tab = torch.tensor(row[None], device=DEV)
            act = torch.ones(1, dtype=torch.bool, device=DEV)
            with torch.no_grad():
                for c0 in range(0, len(prompt), width):
                    logits = eng.model(
                        torch.tensor([prompt[c0:c0 + width]], device=DEV),
                        pos=torch.tensor([c0], dtype=torch.int32,
                                         device=DEV),
                        cache=arena, page_table=tab, active=act,
                        paged_kernel=kernel)
            worst = max(worst, max_err(logits[0, -1], whole))
        out.append(worst)
    return out


def phase_chunked(torch, seed):
    """Chunked prefill (chunk_tokens=256) against whole-prompt prefill:
    f32 identity at 2 layers (chunked, and chunked with speculate=4), then
    the serve phase's bf16 traffic in alternating pairs with tokens/s,
    TTFT, the decode steps a whole-prompt prefill delays, verify steps by
    width and K4 launches (8 in every step of a chunked run), identical
    tokens up to each request's first near-tie."""
    import collections
    from dtdl_tpu_torch import kernels
    from dtdl_tpu_torch.models.transformer import transformer_lm
    from dtdl_tpu_torch.serve.draft import NGramDraft
    traffic = make_traffic(seed, 32000)
    m32 = transformer_lm("base", n_layers=2, seed=seed, dtype=torch.float32,
                         device=DEV)
    _, _, whole32, _ = serve(torch, m32, traffic)
    _, _, chunk32, _ = serve(torch, m32, traffic, chunk_tokens=CHUNK_TOKENS)
    _, cs, spec32, _ = serve(torch, m32, traffic, chunk_tokens=CHUNK_TOKENS,
                             speculate=SPEC_K, draft=NGramDraft())
    ties_c = near_tie_divergences(torch, m32, whole32, chunk32, TAU_F32)
    ties_s = near_tie_divergences(torch, m32, whole32, spec32, TAU_F32)
    log(f"chunked base 2-layer f32: {len(traffic)} requests chunked vs "
        f"whole-prompt near-tie partings {len(ties_c)} {ties_c}, chunked + "
        f"speculate={SPEC_K} {len(ties_s)} {ties_s} (tau {TAU_F32:.0e}); "
        f"spec steps {cs.metrics.summary()['spec_steps_by_k']}")
    del m32

    m16 = transformer_lm("base", seed=seed, dtype=torch.bfloat16, device=DEV)
    n_layers = m16.cfg.n_layers
    serve(torch, m16, traffic[:2])                              # warm-up
    serve(torch, m16, traffic[:2], chunk_tokens=CHUNK_TOKENS)
    runs = {"whole": [], "chunked": []}
    for mode in ("whole", "chunked", "chunked", "whole"):
        steps, widths = [], []
        kernels.reset_launches()
        _, sched, reqs, wall = serve(
            torch, m16, traffic,
            chunk_tokens=CHUNK_TOKENS if mode == "chunked" else None,
            step_launches=steps, verify_widths=widths)
        k4 = kernels.LAUNCHES["paged_attention"]
        bad = [r for r in reqs if not r.done or r.error or len(r.tokens) != 32]
        if bad:
            raise AssertionError(f"chunked phase ({mode}) left {bad}")
        if set(steps) != {n_layers}:
            raise AssertionError(f"{mode} steps launched K4 "
                                 f"{sorted(set(steps))} times, want "
                                 f"{n_layers} each")
        S = sched.metrics.summary()
        n_tok = sum(len(r.tokens) for r in reqs)
        by_k = dict(sorted(collections.Counter(widths).items()))
        log(f"chunked base bf16 {mode}: tokens_per_s={n_tok / wall:.2f} "
            f"wall_s={wall:.4f} ttft_p50_s={S['ttft_s_p50']:.4f} "
            f"ttft_p99_s={S['ttft_s_p99']:.4f} decode_steps_delayed_by_"
            f"prefill={S['decode_steps_delayed_by_prefill']} "
            f"prefill_chunks={S['prefill_chunks']} chunk_tokens="
            f"{S['chunk_tokens']} decode_steps={S['decode_steps']} "
            f"verify_steps_by_k={by_k} K4 launches={k4} "
            f"({n_layers} in each of {len(steps)} steps)")
        runs[mode].append(dict(reqs=reqs, k4=k4, by_k=by_k))
    whole16 = runs["whole"][0]["reqs"]
    chunk16 = runs["chunked"][0]["reqs"]
    if [r.tokens for r in chunk16] != \
            [r.tokens for r in runs["chunked"][1]["reqs"]]:
        raise AssertionError("two chunked runs of one traffic disagree")
    delta_v, delta_v_k4, scale = verify_vs_decode_delta(torch, m16,
                                                        traffic[:8],
                                                        whole16[:8])
    delta_c, delta_c_k4 = chunk_vs_whole_delta(torch, m16, traffic[:8])
    ulp = 2.0 ** (math.floor(math.log2(scale)) - 7)
    ceiling = SPEC_DELTA_ULPS * ulp
    if max(delta_v, delta_v_k4, delta_c, delta_c_k4) > ceiling:
        raise AssertionError(
            f"bf16 logit deltas verify {delta_v:.4e}/{delta_v_k4:.4e}, chunk "
            f"{delta_c:.4e}/{delta_c_k4:.4e} (plain/K4) beyond "
            f"{SPEC_DELTA_ULPS} ulps ({ceiling:.4e})")
    tau = 2 * max(delta_v, delta_c)
    ties = near_tie_divergences(torch, m16, whole16, chunk16, tau)
    log(f"chunked bf16 identity: wide-vs-narrow delta {delta_v:.4e} (plain) "
        f"{delta_v_k4:.4e} (K4), chunk-vs-whole delta {delta_c:.4e} (plain) "
        f"{delta_c_k4:.4e} (K4), ceiling {ceiling:.4e}, tau {tau:.4e}; "
        f"requests parting at a near-tie {len(ties)} of {len(chunk16)} "
        f"{ties}")
    n257 = runs["chunked"][0]["by_k"].get(CHUNK_TOKENS, 0) * n_layers
    return dict(k4=runs["chunked"][0]["k4"], launches_257=n257)


def quant_prefill_logits(torch, eng, prompts):
    """The engine's prefill logits of each prompt, alone in slot 0."""
    import numpy as np
    out = []
    for prompt in prompts:
        row = np.zeros(eng.n_ptab, np.int32)
        n_pg = -(-len(prompt) // eng.page_size)
        row[:n_pg] = np.arange(1, n_pg + 1)
        _, _, logits = eng.prefill(eng.init_arena(), eng.init_last_tokens(),
                                   0, prompt, page_row=row)
        out.append(logits)
    return out


def phase_quant(torch, seed):
    """The serve phase's traffic on a bf16 engine, int8 weights + int8 KV
    and fp8 weights + fp8 KV (full depth): tokens/s, TTFT, the pages one
    kv_pool_bytes budget buys, K4 launches with quantized pools (8 in
    every decode step), and each engine's prefill logits of 4 prompts
    through K4 against its plain version (within SPEC_DELTA_ULPS bf16 ulps
    of the largest logit) and against the bf16 engine's (reported).  The
    stated parity budget of tests/test_quant.py (QUANT_REL_TOL) is held at
    the depth it was stated for, 2 layers, at base width."""
    from dtdl_tpu_torch import kernels
    from dtdl_tpu_torch.models.transformer import transformer_lm
    from dtdl_tpu_torch.serve.engine import InferenceEngine
    traffic = make_traffic(seed, 32000)
    probes = [p for p, _ in traffic[:4]]

    def drift(model, name, **kw):
        eng = InferenceEngine(model, n_slots=1, page_size=16, device=DEV,
                              **kw, **QUANT_MODES[name])
        return quant_prefill_logits(torch, eng, probes)

    m2 = transformer_lm("base", n_layers=2, seed=seed, dtype=torch.bfloat16,
                        device=DEV)
    ref2 = drift(m2, "bf16")
    for name in ("int8", "fp8"):
        d = max(max_err(g, w) / float(w.abs().max())
                for g, w in zip(drift(m2, name), ref2))
        ok = d <= QUANT_REL_TOL[name]
        log(f"quant base 2-layer {name}: prefill logit drift {d:.4f} of the "
            f"bf16 range (tol {QUANT_REL_TOL[name]}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} prefill logits drift beyond the "
                                 f"stated budget")
    del m2

    m16 = transformer_lm("base", seed=seed, dtype=torch.bfloat16, device=DEV)
    n_layers = m16.cfg.n_layers
    ref = drift(m16, "bf16")
    budget = 1 << 30
    out = {}
    for name, kw in QUANT_MODES.items():
        got, plain = drift(m16, name), drift(m16, name, paged_kernel=False)
        scale = max(float(w.abs().max()) for w in plain)
        ceiling = SPEC_DELTA_ULPS * 2.0 ** (math.floor(math.log2(scale)) - 7)
        k4_err = max(max_err(g, w) for g, w in zip(got, plain))
        d = max(max_err(g, w) / float(w.abs().max())
                for g, w in zip(got, ref))
        if k4_err > ceiling:
            raise AssertionError(f"{name} prefill logits through K4 differ "
                                 f"from the plain attend's by {k4_err:.4e}, "
                                 f"beyond {ceiling:.4e}")
        pages = InferenceEngine(m16, n_slots=8, page_size=16, device=DEV,
                                kv_pool_bytes=budget,
                                kv_dtype=kw.get("kv_dtype")).n_pages
        serve(torch, m16, traffic[:2], **kw)                    # warm-up
        steps = []
        kernels.reset_launches()
        eng, sched, reqs, wall = serve(torch, m16, traffic,
                                       step_launches=steps, **kw)
        k4 = kernels.LAUNCHES["paged_attention"]
        bad = [r for r in reqs if not r.done or r.error or len(r.tokens) != 32]
        if bad:
            raise AssertionError(f"quant phase ({name}) left {bad}")
        if set(steps) != {n_layers}:
            raise AssertionError(f"{name} steps launched K4 "
                                 f"{sorted(set(steps))} times")
        S = sched.metrics.summary()
        Q = eng.compile_stats()["quant"]
        n_tok = sum(len(r.tokens) for r in reqs)
        out[name] = dict(reqs=reqs, k4=k4)
        same = ""
        if name != "bf16":
            agree = [next((i for i, (a, b) in enumerate(zip(
                r.tokens, q.tokens)) if a != b), len(r.tokens))
                for r, q in zip(out["bf16"]["reqs"], reqs)]
            same = (f" tokens equal to bf16's before the first difference: "
                    f"{sum(agree)}/{n_tok}")
        log(f"quant base {name}: prefill logits K4 vs plain {k4_err:.4e} "
            f"(ceiling {ceiling:.4e}), drift {d:.4f} of the bf16 range; "
            f"tokens_per_s={n_tok / wall:.2f} wall_s={wall:.4f} ttft_p50_s="
            f"{S['ttft_s_p50']:.4f} ttft_p99_s={S['ttft_s_p99']:.4f} "
            f"param_bytes={Q['param_bytes']} kv_arena_bytes="
            f"{Q['kv_arena_bytes']} page_bytes={eng.page_bytes} pages per "
            f"{budget} B kv_pool_bytes={pages} K4 launches={k4} "
            f"({n_layers} in each of {len(steps)} steps){same}")
    return {name: v["k4"] for name, v in out.items()}


def phase_contain(torch, seed):
    """Containment at base width, 2 layers, f32, 4 slots: a raise injected
    into one engine's decode at its third call fails the 4 requests in
    flight, the 4 queued ones are then served with a clean run's tokens
    and the pages come back; cancel of a queued and a slotted request;
    shutdown with and without drain; the accounting invariant."""
    from dtdl_tpu_torch.models.transformer import transformer_lm
    from dtdl_tpu_torch.serve.engine import InferenceEngine
    from dtdl_tpu_torch.serve.scheduler import Request, Scheduler
    m = transformer_lm("base", n_layers=2, seed=seed, dtype=torch.float32,
                       device=DEV)
    traffic = make_traffic(seed, m.cfg.vocab_size, n=8, new_tokens=16)
    eng = InferenceEngine(m, n_slots=4, page_size=16, device=DEV)
    clean = [Request(p, n) for p, n in traffic[4:]]
    Scheduler(eng, harvest_lag=4, device=DEV).run(clean)

    def accounted(s):
        return s["requests_submitted"] == (
            s["requests_finished"] + s["requests_rejected"]
            + s["requests_expired"] + s["requests_failed"]
            + s["requests_aborted"] + s["requests_shed"])

    faulty = InferenceEngine(m, n_slots=4, page_size=16, device=DEV)
    decode, calls = faulty.decode, []

    def failing(*args, **kwargs):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("fault injected at decode call 3")
        return decode(*args, **kwargs)
    faulty.decode = failing
    sched = Scheduler(faulty, harvest_lag=4, device=DEV)
    reqs = [sched.submit(Request(p, n)) for p, n in traffic]
    sched.run()
    s = sched.metrics.summary()
    failed = [r for r in reqs if (r.error or "").startswith("failed:")]
    ok = (failed == reqs[:4] and s["requests_failed"] == 4
          and [r.tokens for r in reqs[4:]] == [r.tokens for r in clean]
          and sched.pages.pages_in_use == 0 and accounted(s))
    log(f"contain base 2-layer f32: fault at decode call 3 -> failed "
        f"{len(failed)} ({sched.last_engine_error}), queued served "
        f"{sum(r.error is None for r in reqs[4:])}/{len(reqs) - 4} with the "
        f"clean run's "
        f"tokens {[r.tokens for r in reqs[4:]] == [r.tokens for r in clean]}, "
        f"pages in use after {sched.pages.pages_in_use}, accounting "
        f"{accounted(s)} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("containment did not hold")

    sched = Scheduler(eng, harvest_lag=4, device=DEV)
    reqs = [sched.submit(Request(p, n)) for p, n in traffic[:6]]
    sched.step()
    queued, slotted = reqs[5], reqs[1]
    done = [sched.cancel(queued.rid), sched.cancel(slotted.rid),
            sched.cancel(slotted.rid)]
    sched.run()
    s = sched.metrics.summary()
    ok = (done == [True, True, False] and s["requests_aborted"] == 2
          and queued.error.startswith("aborted:")
          and slotted.error.startswith("aborted:")
          and sched.pages.pages_in_use == 0 and accounted(s))
    log(f"contain cancel: queued {queued.error!r}, slotted "
        f"{slotted.error!r}, second cancel {done[2]}, pages in use after "
        f"{sched.pages.pages_in_use} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("cancel did not hold")

    for drain in (True, False):
        sched = Scheduler(eng, harvest_lag=4, device=DEV)
        reqs = [sched.submit(Request(p, n)) for p, n in traffic[:6]]
        sched.step()
        sched.step()
        sched.shutdown(drain=drain)
        late = sched.submit(Request(traffic[0][0], 2))
        kinds = [(r.error or "ok").split(":")[0] for r in reqs]
        want = (["ok"] * 4 if drain else ["aborted"] * 4) + ["aborted"] * 2
        s = sched.metrics.summary()
        ok = (kinds == want and late.error.startswith("rejected:")
              and sched.pages.pages_in_use == 0 and accounted(s)
              and not sched._pending)
        log(f"contain shutdown(drain={drain}): request kinds {kinds}, late "
            f"submit {late.error!r} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"shutdown(drain={drain}) did not hold")


def phase_dense(torch, seed):
    """The dense arena (page_size=0) at base width, 2 layers, f32: greedy
    tokens identical to the paged engine's, plain and chunked (near-tie
    rule at TAU_F32), with no K4 launch (the dense attend is plain
    torch)."""
    from dtdl_tpu_torch import kernels
    from dtdl_tpu_torch.models.transformer import transformer_lm
    m = transformer_lm("base", n_layers=2, seed=seed, dtype=torch.float32,
                       device=DEV)
    traffic = make_traffic(seed, m.cfg.vocab_size)[:8]
    _, _, paged, _ = serve(torch, m, traffic)
    kernels.reset_launches()
    _, _, dense, wall = serve(torch, m, traffic, page_size=0)
    _, _, dense_c, _ = serve(torch, m, traffic, page_size=0,
                             chunk_tokens=CHUNK_TOKENS)
    k4 = kernels.LAUNCHES["paged_attention"]
    ties = near_tie_divergences(torch, m, paged, dense, TAU_F32)
    ties_c = near_tie_divergences(torch, m, paged, dense_c, TAU_F32)
    n_tok = sum(len(r.tokens) for r in dense)
    log(f"dense base 2-layer f32: {len(traffic)} requests, dense vs paged "
        f"near-tie partings {len(ties)} {ties}, dense chunked vs paged "
        f"{len(ties_c)} {ties_c} (tau {TAU_F32:.0e}); dense tokens_per_s="
        f"{n_tok / wall:.2f}; K4 launches in the dense runs {k4}")
    if k4:
        raise AssertionError("the dense arena launched K4")


def time_quant_linear(torch, m_rows):
    """One projection of the base model's MLP (512 -> 1408) for ``m_rows``
    rows: the bf16 weight, and the int8 and fp8 QuantLinear (the payload
    converted to bf16 before torch.matmul, the scale on the output)."""
    from dtdl_tpu_torch.quant import QuantLinear, quantize_tensor
    gen = torch.Generator(device=DEV).manual_seed(12)
    x = torch.randn(m_rows, 512, generator=gen, device=DEV).to(torch.bfloat16)
    w = torch.randn(512, 1408, generator=gen, device=DEV) / 512 ** 0.5
    wb = w.to(torch.bfloat16)
    out = {"bf16": cuda_ms(torch, lambda: torch.matmul(x, wb))}
    for name, mode, dt in (("int8", True, torch.int8),
                           ("fp8", "w8f", torch.float8_e4m3fn)):
        layer = QuantLinear(512, 1408, mode=mode, device=DEV)
        q, sc = quantize_tensor(w, (1, 1408), dtype=dt)
        layer.kernel.data, layer.kernel_scale.data = q, sc
        with torch.no_grad():
            out[name] = cuda_ms(torch, lambda: layer(x, torch.bfloat16))
    return out


# ---------------------------------------------------------------------------
# phase 5g: serving the mixture-of-experts model
# ---------------------------------------------------------------------------

def lone_request_log(torch, model, prompt, n_new, kernel):
    """Serve one request alone (8 slots, page 16) and log, step by step,
    what the MoE routers saw of its tokens and the logits it was sampled
    from: (tokens, [(step, layer, probs [n, E])], [logits [V]]).  Step 0
    is the prefill (its prompt rows), step t > 0 the decode that emits
    token t."""
    from dtdl_tpu_torch.serve.engine import InferenceEngine
    from dtdl_tpu_torch.serve.scheduler import Request, Scheduler
    eng = InferenceEngine(model, n_slots=8, page_size=16,
                          paged_kernel=kernel, device=DEV)
    calls, routed, logits = [], [], []
    hooks = router_logits(torch, eng.model, calls)
    prefill, decode = eng.prefill, eng.decode

    def on_prefill(*a, **k):
        calls.clear()
        out = prefill(*a, **k)
        routed.extend((0, n, torch.softmax(x[0, :len(prompt)], -1))
                      for n, x in calls)
        logits.append(out[2])
        return out

    def on_decode(arena, last, active, *a, **k):
        calls.clear()
        out = decode(arena, last, active, *a, **k)
        slots = [i for i, x in enumerate(active) if x]
        if slots:
            step = len(logits)
            routed.extend((step, n, torch.softmax(x[slots[0]], -1))
                          for n, x in calls)
            logits.append(out[2][slots[0]])
        return out
    eng.prefill, eng.decode = on_prefill, on_decode
    req = Request(prompt, n_new)
    Scheduler(eng, harvest_lag=4, device=DEV).run([req])
    for h in hooks:
        h.remove()
    if req.error or len(req.tokens) != n_new:
        raise AssertionError(f"lone request failed: {req.error}")
    return req.tokens, routed, logits


def explain_moe_partings(torch, model, traffic, tau_logit):
    """K4 against the plain attend, each request served alone: where the
    two runs' tokens part, the parting must be explained by a router
    near-tie at or before the step that emitted it (the first token the
    two runs route apart, with the plain run's first-vs-second prob gap
    within ROUTER_TAU) or by a logit near-tie (the plain run's top-two
    logit gap there within ``tau_logit``).  Returns the partings as
    (request, position, 'router' gap or 'logit' gap)."""
    out = []
    for i, (prompt, n_new) in enumerate(traffic):
        tok_k, route_k, _ = lone_request_log(torch, model, prompt, n_new,
                                             True)
        tok_p, route_p, logit_p = lone_request_log(torch, model, prompt,
                                                   n_new, False)
        j = next((t for t, (a, b) in enumerate(zip(tok_k, tok_p)) if a != b),
                 None)
        # the first router call where the two runs route a token apart:
        # every token parted there is a rounding effect (no earlier
        # routing differs), so the largest gap among them is judged
        first = None
        for (step, _, pk), (_, _, pp) in zip(route_k, route_p):
            apart = pk.argmax(-1) != pp.argmax(-1)
            if bool(apart.any()):
                top = torch.topk(pp, 2, dim=-1).values
                first = (step, float((top[..., 0] - top[..., 1])[apart].max()))
                break
        if first is not None and first[1] > ROUTER_TAU:
            raise AssertionError(
                f"request {i}: K4 and plain route a token apart at step "
                f"{first[0]} with a prob gap {first[1]:.4e} beyond the "
                f"router near-tie tau {ROUTER_TAU}")
        if j is None:
            if first is not None:
                out.append((i, None, "router", first[1]))
            continue
        if first is not None and first[0] <= j:
            kind, gap, ok = "router", first[1], True
        else:
            top = torch.topk(logit_p[j], 2).values
            kind, gap = "logit", float(top[0] - top[1])
            ok = gap <= tau_logit
        out.append((i, j, kind, gap))
        if not ok:
            raise AssertionError(
                f"request {i}: K4 and plain tokens part at {j}, explained by "
                f"no near-tie ({kind} gap {gap:.4e}; router tau {ROUTER_TAU}, "
                f"logit tau {tau_logit:.4e})")
    return out


def phase_moe_serve(torch, seed):
    """base-moe8 served: (a) the serving cell in bf16 through K4 (tokens/s,
    TTFT, K4 launches, 8 in every decode step); (b) the same cell on an
    int8 engine (weights, experts included, and KV), prefill logits
    against bf16's; (c) 2 layers, f32: K4 and plain engines give identical
    tokens; (d) full depth, bf16, 8 requests each served alone through K4
    and through the plain attend: every parting explained by a router or
    logit near-tie; (e) 2 layers, f32, capacity factor 8 (= E / top_k,
    nothing drops): chunked (chunk_tokens=256) and speculate=4 give
    whole-prompt and plain tokens (near-tie rule at TAU_F32)."""
    from dtdl_tpu_torch import kernels
    from dtdl_tpu_torch.models.transformer import transformer_lm
    from dtdl_tpu_torch.serve.draft import NGramDraft
    from dtdl_tpu_torch.serve.engine import InferenceEngine
    traffic = make_traffic(seed, 32000)
    probes = [p for p, _ in traffic[:4]]

    # (a), (b) the serving cell at full depth, bf16 and int8
    m16 = transformer_lm("base-moe8", seed=seed, dtype=torch.bfloat16,
                         device=DEV)
    n_layers = m16.cfg.n_layers
    ref = quant_prefill_logits(torch, InferenceEngine(
        m16, n_slots=1, page_size=16, device=DEV), probes)
    for name in ("bf16", "int8"):
        kw = QUANT_MODES[name]
        serve(torch, m16, traffic[:2], **kw)                    # warm-up
        steps = []
        kernels.reset_launches()
        eng, sched, reqs, wall = serve(torch, m16, traffic,
                                       step_launches=steps, **kw)
        k4 = kernels.LAUNCHES["paged_attention"]
        bad = [r for r, (_, n) in zip(reqs, traffic)
               if not r.done or r.error or len(r.tokens) != n]
        if bad:
            raise AssertionError(f"moe_serve ({name}) left {bad}")
        if set(steps) != {n_layers} or k4 <= 0:
            raise AssertionError(f"moe_serve {name} steps launched K4 "
                                 f"{sorted(set(steps))} times")
        drift = ""
        if name != "bf16":
            got = quant_prefill_logits(torch, InferenceEngine(
                m16, n_slots=1, page_size=16, device=DEV, **kw), probes)
            d = max(max_err(g, w) / float(w.abs().max())
                    for g, w in zip(got, ref))
            drift = f" prefill logit drift {d:.4f} of the bf16 range;"
        S = sched.metrics.summary()
        n_tok = sum(len(r.tokens) for r in reqs)
        log(f"moe_serve base-moe8 {name}:{drift} requests={len(reqs)} "
            f"tokens={n_tok} wall_s={wall:.4f} tokens_per_s="
            f"{n_tok / wall:.2f} decode_tokens_per_s="
            f"{S['decode_tokens_per_sec']:.2f} ttft_p50_s={S['ttft_s_p50']:.4f}"
            f" ttft_p99_s={S['ttft_s_p99']:.4f} prefix_hit_pages="
            f"{S['prefix_hit_pages']} decode_steps={S['decode_steps']} "
            f"param_bytes={eng.compile_stats()['quant']['param_bytes']} "
            f"K4 launches={k4} ({n_layers} in each of {len(steps)} steps)")

    # (d) K4 vs the plain attend at full depth in bf16, partings explained
    scale = max(float(w.abs().max()) for w in ref)
    tau = 2 * SPEC_DELTA_ULPS * 2.0 ** (math.floor(math.log2(scale)) - 7)
    parts = explain_moe_partings(torch, m16, traffic[:8], tau)
    log(f"moe_serve base-moe8 bf16 K4 vs plain attend, 8 requests each "
        f"alone: partings (request, position, cause, gap) {parts} (router "
        f"tau {ROUTER_TAU}, logit tau {tau:.4e})")
    del m16

    # (c) K4 vs the plain attend, f32, 2 layers: identical tokens
    m32 = transformer_lm("base-moe8", n_layers=2, seed=seed,
                         dtype=torch.float32, device=DEV)
    _, _, with_kernel, _ = serve(torch, m32, traffic)
    _, _, plain, _ = serve(torch, m32, traffic, paged_kernel=False)
    diff = [i for i, (a, b) in enumerate(zip(with_kernel, plain))
            if a.tokens != b.tokens]
    log(f"moe_serve base-moe8 2-layer f32: K4 and plain engines "
        f"{'identical' if not diff else 'DIFFER on ' + str(diff)} for "
        f"{len(plain)} requests")
    if diff:
        raise AssertionError(f"K4 and plain MoE engines disagree on {diff}")
    del m32

    # (e) nothing droppable: chunked and speculative equal whole and plain
    m8 = transformer_lm("base-moe8", n_layers=2, seed=seed,
                        dtype=torch.float32, capacity_factor=8.0, device=DEV)
    _, _, whole, _ = serve(torch, m8, traffic)
    kernels.reset_launches()
    steps = []
    _, cs, chunk, _ = serve(torch, m8, traffic, chunk_tokens=CHUNK_TOKENS,
                            step_launches=steps)
    k4c = kernels.LAUNCHES["paged_attention"]
    _, ss, spec, _ = serve(torch, m8, traffic, speculate=SPEC_K,
                           draft=NGramDraft())
    # drafts from the whole run's own tokens: verify steps of full width
    _, so, oracle, _ = serve(torch, m8, traffic, speculate=SPEC_K,
                             draft=OracleDraft(traffic, whole))
    ties_c = near_tie_divergences(torch, m8, whole, chunk, TAU_F32)
    ties_s = near_tie_divergences(torch, m8, whole, spec, TAU_F32)
    ties_o = near_tie_divergences(torch, m8, whole, oracle, TAU_F32)
    if set(steps) != {2}:
        raise AssertionError(f"chunked MoE steps launched K4 "
                             f"{sorted(set(steps))} times")
    O = so.metrics.summary()
    if not O["spec_steps"]:
        raise AssertionError("the oracle MoE run never verified")
    log(f"moe_serve base-moe8 2-layer f32 capacity_factor=8: chunked "
        f"(chunk_tokens={CHUNK_TOKENS}) vs whole-prompt near-tie partings "
        f"{len(ties_c)} {ties_c}, speculate={SPEC_K} vs plain: n-gram "
        f"{len(ties_s)} {ties_s} (spec_steps "
        f"{ss.metrics.summary()['spec_steps']}), oracle drafts "
        f"{len(ties_o)} {ties_o} (spec_steps_by_k {O['spec_steps_by_k']}, "
        f"acceptance {O['spec_acceptance_rate']:.4f}) (tau {TAU_F32:.0e}); "
        f"prefill_chunks={cs.metrics.summary()['prefill_chunks']} K4 "
        f"launches chunked={k4c} (2 in each of {len(steps)} steps)")


# ---------------------------------------------------------------------------
# phases 6 and 7: training
# ---------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ = 8, 4096


def train_setup(torch, seed, n_batches, batch, seq, size="base",
                strategy=None):
    """The training path's pieces, as a user builds them: synthetic Markov
    tokens (vocab 32000) through the DataLoader, transformer_lm(size,
    max_seq=seq) with bf16 compute and f32 weights from ``seed``, an
    adamw(3e-4) state (replicated by ``strategy``) and the step under
    ``strategy``."""
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
    model = transformer_lm(size, max_seq=seq, seed=None, device=DEV)
    state = init_state(model, seed, adamw(3e-4), device=DEV)
    if strategy is not None:
        state = strategy.replicate(state)
    return state, make_lm_train_step(strategy), iter(loader)


def phase_train(torch, seed, warmup: int = 3, steps: int = 10,
                size: str = "base"):
    """``size`` "base" (the train phase) or "base-moe8" (moe_train: MoE
    blocks every second layer, routed top-1 at capacity 1.25, groups of
    1024; the loss carries the Switch aux, reported beside it)."""
    from dtdl_tpu_torch import kernels
    from dtdl_tpu_torch.obs.goodput import lm_train_flops, peak_flops_per_chip
    state, step, batches = train_setup(torch, seed, warmup + steps,
                                       TRAIN_BATCH, TRAIN_SEQ, size)
    cfg = state.model.cfg
    losses, auxes = [], []
    for _ in range(warmup):
        state, metrics = step(state, next(batches))
        losses.append(metrics["loss"])
        auxes.append(metrics.get("moe_aux_loss"))
    sync(torch)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = step(state, next(batches))
        losses.append(metrics["loss"])
        auxes.append(metrics.get("moe_aux_loss"))
    sync(torch)
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    losses = [float(x) for x in losses]
    moe = cfg.n_experts > 0
    auxes = [float(x) for x in auxes] if moe else []
    peak_mem = torch.cuda.max_memory_allocated() / 2**30
    flops = lm_train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    peak = peak_flops_per_chip()
    step_ms = 1e3 * wall / steps
    tokens_per_s = TRAIN_BATCH * (TRAIN_SEQ - 1) * steps / wall
    mfu = flops * steps / wall / peak if peak else None
    aux_txt = (f" moe_aux_loss_first={auxes[0]:.5f} moe_aux_loss_last="
               f"{auxes[-1]:.5f}" if moe else "")
    log(f"{'moe_' if moe else ''}train {size} bf16 (f32 weights) adamw(3e-4) "
        f"batch {TRAIN_BATCH}x"
        f"{TRAIN_SEQ}: steps={steps} (after {warmup} warm-up) wall_s="
        f"{wall:.4f} step_ms={step_ms:.2f} tokens_per_s={tokens_per_s:.1f} "
        f"flops_per_step={flops:.4e} mfu={mfu if mfu is None else round(mfu, 5)} "
        f"peak_mem_gib={peak_mem:.2f} loss_first={losses[0]:.5f} "
        f"loss_last={losses[-1]:.5f}{aux_txt} launches={launches}")
    log(f"{size} train losses: " + " ".join(f"{x:.5f}" for x in losses))
    if moe:
        log(f"{size} moe_aux_loss: " + " ".join(f"{x:.5f}" for x in auxes))
    if not all(math.isfinite(x) for x in losses + auxes):
        raise AssertionError(f"non-finite training loss: {losses} {auxes}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    if moe and not min(auxes) > 0:
        raise AssertionError(f"the MoE aux loss is not positive: {auxes}")
    want = cfg.n_layers * steps
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        if launches[name] != want:
            raise AssertionError(f"{name} launched {launches[name]} times in "
                                 f"{steps} steps, want {want} (one per layer "
                                 f"and step)")
    # the rope pre-pass rotates q and k for K1, and once more for the K2/K3
    # pair
    if launches["rope_rows"] != 4 * want:
        raise AssertionError(f"rope_rows launched {launches['rope_rows']} "
                             f"times in {steps} steps, want {4 * want}")
    del state, step, batches
    torch.cuda.empty_cache()
    return launches, dict(step_ms=step_ms, tokens_per_s=tokens_per_s,
                          mfu=mfu)


def router_logits(torch, model, store, substitute=None):
    """Hooks that append each MoE router's logits (detached, f32) to
    ``store`` as the model runs; returns the hook handles.  With
    ``substitute`` (logits, one tensor per call in call order) each
    router's output takes those values instead, straight through:
    ``out + (substitute - out).detach()``, so the router's own gradient
    still flows."""
    from dtdl_tpu_torch.models.transformer import MoE

    def hook(out, name):
        store.append((name, out.detach().float()))
        if substitute is not None:
            return out + (substitute[len(store) - 1] - out).detach()
        return None
    return [m.router.register_forward_hook(
                lambda mod, args, out, name=name: hook(out, name))
            for name, m in model.named_modules() if isinstance(m, MoE)]


def router_partings(torch, got, want):
    """Compare two runs' router logits, call for call: the tokens whose
    first choice differs, with ``want``'s gap between its first and second
    choice's prob there (a near-tie when small).  Returns (n_tokens,
    [gaps])."""
    n, gaps = 0, []
    for (name_g, lg), (name_w, lw) in zip(got, want):
        if name_g != name_w or lg.shape != lw.shape:
            raise AssertionError(f"router calls differ: {name_g} "
                                 f"{tuple(lg.shape)} vs {name_w} "
                                 f"{tuple(lw.shape)}")
        pg, pw = torch.softmax(lg, -1), torch.softmax(lw, -1)
        n += pg.shape[:-1].numel()
        top = torch.topk(pw, 2, dim=-1).values
        differ = pg.argmax(-1) != pw.argmax(-1)
        gaps += (top[..., 0] - top[..., 1])[differ].tolist()
    return n, gaps


def phase_traincheck(torch, seed, size: str = "base"):
    """One make_lm_train_step step through the flash kernels and one
    through dense attention (plain autograd), same weights and batch.
    ``size`` "base-moe8" (moe_traincheck): the MoE width at 2 layers, one
    MoE block, whose routing the two steps must share in f32 (gate
    identity).  In bf16 a token that the two steps' own router logits
    route apart must be a router near-tie (first-minus-second prob gap
    within ROUTER_TAU); the flash step then routes on the dense step's
    logits, so the loss and gradients are held as for the dense model."""
    from dtdl_tpu_torch import kernels
    from dtdl_tpu_torch.data.synthetic import markov_tokens
    from dtdl_tpu_torch.models.transformer import transformer_lm
    from dtdl_tpu_torch.train.optim import sgd
    from dtdl_tpu_torch.train.state import init_state
    from dtdl_tpu_torch.train.step import make_lm_train_step
    tokens = markov_tokens(2, 512, 32000, seed=seed + 1)
    label = "moe_traincheck" if size != "base" else "traincheck"
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        tol = TRAINCHECK_TOL[name]
        out, logits = {}, {}
        for impl in ("dense", "flash"):
            model = transformer_lm(size, n_layers=2, max_seq=512,
                                   dtype=dtype, attn_impl=impl, seed=None,
                                   device=DEV)
            state = init_state(model, seed, sgd(TRAINCHECK_LR), device=DEV)
            logits[impl] = []
            # bf16: the flash step routes on the dense step's router logits
            # (straight through), so rounding cannot route the two steps
            # apart and their gradients stay comparable; where its own
            # logits would have routed a token elsewhere is counted below
            substitute = ([o for _, o in logits["dense"]] if impl == "flash"
                          and dtype == torch.bfloat16 else None)
            hooks = router_logits(torch, model, logits[impl], substitute)
            kernels.reset_launches()
            state, metrics = make_lm_train_step()(state, {"tokens": tokens})
            sync(torch)
            for h in hooks:
                h.remove()
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
        route = ""
        parted = []
        if logits["dense"]:
            n_routed, parted = router_partings(torch, logits["flash"],
                                               logits["dense"])
            route = (f"; routing: {len(parted)} of {n_routed} tokens routed "
                     f"apart, first-vs-second prob gaps there "
                     f"{[round(g, 6) for g in parted]} (router near-tie tau "
                     f"{ROUTER_TAU})")
            if parted and (dtype == torch.float32
                           or max(parted) > ROUTER_TAU):
                raise AssertionError(f"{label} {name}: the flash and dense "
                                     f"steps route apart beyond a near-tie"
                                     f"{route}")
            if dtype == torch.bfloat16:
                route += "; the flash step routed on the dense step's logits"
        log(f"{label} {size} 2-layer {name} flash (K1-K3) vs dense step: "
            f"loss {lf:.6f} vs {ld:.6f} (|d|={abs(lf - ld):.3e} tol "
            f"{tol['loss']:.0e}); worst gradient err {grad_err:.3e} of the "
            f"tensor's max (tol {tol['grad']:.0e}); worst updated-parameter "
            f"err {upd_err:.3f} of its bound; {len(gd)} tensors; flash launches "
            f"{launches}{route} {'ok' if ok else 'FAIL'}")
        if not (ok and kernels_ran and dense_plain):
            raise AssertionError(f"{label} {name}: the flash step disagrees "
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
              "K3 bwd_dkv": ("bwd_dkv",), "rope pre-pass": ("rope_rows",),
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


def phase_profile_moe(torch, seed, steps: int = 2):
    """Where a base-moe8 training step's device time goes (torch.profiler):
    the forward by part (the MoE's router, routing, dispatch/combine and
    expert GEMMs, and the head's matmul, each wrapped in a record_function
    range here), the backward by autograd node, and the whole step by
    kernel family."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile
    from dtdl_tpu_torch.models import transformer as tr
    parts = {"fwd router": (tr._Router, "forward"),
             "fwd routing (top-k, slots)": (tr.MoE, "_route"),
             "fwd expert GEMMs": (tr.MoE, "_experts"),
             "fwd MoE dispatch/combine": (tr.MoE, "_routed"),
             "fwd head matmul": (tr.TransformerLM, "head")}
    saved = {name: getattr(cls, attr) for name, (cls, attr) in parts.items()}

    def ranged(name, fn):
        def wrapper(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return wrapper
    state, step, batches = train_setup(torch, seed, steps + 2, TRAIN_BATCH,
                                       TRAIN_SEQ, "base-moe8")
    for _ in range(2):
        state, _ = step(state, next(batches))
    sync(torch)
    try:
        for name, (cls, attr) in parts.items():
            setattr(cls, attr, ranged(name, saved[name]))
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                state, _ = step(state, next(batches))
            sync(torch)
        wall = time.perf_counter() - t0
    finally:
        for name, (cls, attr) in parts.items():
            setattr(cls, attr, saved[name])
    rows = prof.key_averages()
    # the ranges show on the device timeline too: not kernels
    kernel_rows = [e for e in rows if "CUDA" in str(e.device_type)
                   and e.key not in parts]
    dev_total = sum(e.self_device_time_total for e in kernel_rows) / 1e3
    log(f"profile moe_train base-moe8 {steps} steps: wall {wall:.4f}s "
        f"(traced), device kernel time {dev_total / steps:.2f} ms per step")
    dev_total = max(dev_total, 1e-9)
    by_key = {e.key: e.device_time_total / 1e3 / steps for e in rows}
    missing = [name for name in parts if name not in by_key]
    if missing:
        raise AssertionError(f"the profile has no range {missing}")
    fwd = {name: by_key.get(name, 0.0) for name in parts}
    # the dispatch/combine range holds the routing and expert ranges
    fwd["fwd MoE dispatch/combine"] -= (fwd["fwd routing (top-k, slots)"]
                                        + fwd["fwd expert GEMMs"])
    for name, ms in fwd.items():
        log(f"  {ms:9.2f} ms/step  {100 * ms * steps / dev_total:5.1f}%  "
            f"{name}")
    bwd_groups = {"bwd expert GEMMs": ("BmmBackward",),
                  "bwd MoE dispatch/combine/routing": (
                      "IndexPutBackward", "IndexBackward", "CatBackward",
                      "SortBackward", "GatherBackward", "SoftmaxBackward",
                      "ToCopyBackward"),
                  "bwd dense GEMMs (projections, router, head)": (
                      "MmBackward", "MatmulBackward"),
                  "bwd flash (K2, K3)": ("Flash",)}
    bwd = dict.fromkeys(bwd_groups, 0.0)
    for e in rows:
        if not e.key.startswith("autograd::engine::evaluate_function"):
            continue
        name = next((g for g, keys in bwd_groups.items()
                     if any(k in e.key for k in keys)), None)
        if name:
            bwd[name] += e.device_time_total / 1e3 / steps
    for name, ms in bwd.items():
        log(f"  {ms:9.2f} ms/step  {100 * ms * steps / dev_total:5.1f}%  "
            f"{name}")
    for e in sorted(kernel_rows, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  {e.self_device_time_total / 1e3 / steps:9.2f} ms/step "
            f"{e.count // steps:5d}x/step  {e.key[:70]}")
    del state, step, batches
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the classifier path: PyramidNet-110 and ResNet-50
# ---------------------------------------------------------------------------

# (model, batch, channel_align) of the throughput cells: the JAX package's
# bench row (bench.py:bench_one: PyramidNet at the reference's batch 64 and
# at 256, ResNet-50 at 256), and PyramidNet at 256 with its widths rounded
# up to multiples of 8 (the JAX option) once, for the record
CLASSIFY_CELLS = (("pyramidnet", 64, 1), ("pyramidnet", 256, 1),
                  ("pyramidnet", 256, 8), ("resnet50", 256, 1))
# warm-up and timed steps of each cell (bench.py takes max(20, its sample
# budget / batch) after 10; these keep the phase short).  The cells, the
# loop and the profile run with cudnn.benchmark on, as a user training
# these models would: cuDNN's heuristic algorithms are far slower on
# PyramidNet's odd widths, and the search falls inside the warm-up
CLASSIFY_WARMUP, CLASSIFY_ITERS = 5, 30
CLASSIFY_INPUT = {"pyramidnet": ((32, 32, 3), 10),
                  "resnet50": ((224, 224, 3), 1000)}
# the end-to-end loop (classify) and the learnability run (classifycheck):
# PyramidNet-110 bf16 at batch 64 over the JAX package's synthetic CIFAR-10
# through DataLoader + cifar10_train_transform, train_epoch and evaluate
LOOP_BATCH = 64
E2E_STEPS, E2E_TEST = 40, 1000          # 1000 = 15 x 64 + a ragged 40
LEARN_EPOCHS, LEARN_STEPS = 3, 30       # 90 steps
# learnability: the reference's SGD + StepLR (examples/common.py:sgd_steplr:
# lr 0.1, a tenfold drop every 2 epochs, momentum 0.9, weight decay 1e-4);
# chance is 0.1; the last epoch's mean train accuracy must reach LEARN_ACC,
# and the test split's accuracy (eval mode, the running statistics)
# LEARN_ACC as well
LEARN_ACC = 0.5
# classifycheck (1): one f32 SGD step (momentum 0.9, weight decay 5e-4) on
# the card against the same step on the CPU, same bridged weights and
# batch.  Loss within 1e-5 relative, accuracy equal, every BN statistic
# within 1e-5 of its BN's scale, eval logits within 1e-5 of the largest.
# A parameter: f32 cuDNN picks its own algorithms for the convolutions'
# weight gradients, which round otherwise than the CPU's, and a ReLU input
# within rounding of 0 can land on the other side of the kink, switching
# its gradient.  On an H100 80GB HBM3 the small PyramidNet put 0.88% of
# its elements past 1e-4 of their tensor's largest update, the worst at
# 4.1e-3 of it; a wrong rule (weight decay, momentum, a BN gradient) moves
# elements by a share of the update itself.
# So: at least STEP_WITHIN of the elements within STEP_ATOL + STEP_SHARE of
# their tensor's largest update, every element within STEP_SHARE_ALL of it
STEP_LR, STEP_ATOL, STEP_SHARE, STEP_SHARE_ALL = 0.1, 1e-6, 1e-4, 2e-2
STEP_WITHIN = 0.97
# classifycheck (2): PyramidNet-110 in bf16 against the same weights and
# statistics in f32 (the learnability run's trained model), eval logits of
# the test images: max |bf16 - f32| within BF16_LOGIT_BUDGET of the f32
# logits' range (max - min).  bf16 rounds each conv's and BN's output at
# 2^-9 relative; over 110 layers on a residual stream that is ~3% of the
# activations' size, a few % of the logits' spread
BF16_LOGIT_BUDGET = 0.1


def classifier(name, **kw):
    """The JAX package's factories, ported (``pyramidnet``,
    ``resnet50``)."""
    from dtdl_tpu_torch.models import get_model
    return get_model(name, **kw)


def classifier_train_flops(torch, model, shape) -> float:
    """Analytic train-step FLOPs per image: 2·MAC of every conv and Dense
    in one forward (from a batch-1 forward's output shapes), x3 for the
    backward at twice the forward.  Not XLA's cost analysis, which
    bench.py read."""
    from dtdl_tpu_torch.models.layers import Conv, Dense
    macs = [0]

    def count(m, args, out):
        w = m.weight
        macs[0] += out.numel() * (w.shape[1] * w.shape[2] * w.shape[3]
                                  if isinstance(m, Conv) else w.shape[1])
    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, (Conv, Dense))]
    was = model.training
    model.eval()
    with torch.no_grad():
        model(torch.zeros((1,) + shape, device=model.device))
    model.train(was)
    for h in hooks:
        h.remove()
    return 3.0 * 2.0 * macs[0]


def classify_cell(torch, seed, name, batch, align=1):
    """One throughput cell, timed as bench.py times it: sgd(0.1,
    momentum 0.9), 4 distinct device-resident batches from ``seed``,
    CLASSIFY_WARMUP steps, then the timed steps ending in
    float(loss)."""
    from dtdl_tpu_torch.train.optim import sgd
    from dtdl_tpu_torch.train.state import init_state
    from dtdl_tpu_torch.train.step import make_train_step
    t_setup = time.perf_counter()
    shape, classes = CLASSIFY_INPUT[name]
    kw = dict(channel_align=align) if align > 1 else {}
    model = classifier(name, dtype=torch.bfloat16, device=DEV, seed=None,
                       **kw)
    state = init_state(model, seed, sgd(0.1, momentum=0.9), device=DEV)
    step = make_train_step()
    gen = torch.Generator(device=DEV).manual_seed(seed)
    batches = [{"image": torch.randn((batch,) + shape, generator=gen,
                                     device=DEV),
                "label": torch.randint(0, classes, (batch,), generator=gen,
                                       device=DEV)} for _ in range(4)]
    iters = CLASSIFY_ITERS
    losses = []
    for i in range(CLASSIFY_WARMUP):
        state, metrics = step(state, batches[i % 4])
        losses.append(metrics["loss"])
    sync(torch)
    t_setup = time.perf_counter() - t_setup
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i in range(iters):
        state, metrics = step(state, batches[i % 4])
    last = float(metrics["loss"])
    wall = time.perf_counter() - t0
    first = float(losses[0])
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    flops = classifier_train_flops(torch, model, shape) * batch
    step_ms = 1e3 * wall / iters
    out = dict(samples_per_s=batch * iters / wall, step_ms=step_ms,
               mfu=flops / (step_ms / 1e3) / PEAK_OPS["bfloat16"],
               bound_ms=1e3 * flops / PEAK_OPS["bfloat16"], peak_gib=peak_gib,
               loss_first=first, loss_last=last, iters=iters)
    log(f"classify {name}{f' channel_align={align}' if align > 1 else ''} "
        f"bf16 (f32 weights and BN stats) sgd(0.1, momentum 0.9) batch "
        f"{batch} {shape}: {iters} timed steps after {CLASSIFY_WARMUP} "
        f"warm-up (cudnn.benchmark on, its search inside the warm-up; "
        f"init and warm-up {t_setup:.2f}s) "
        f"samples_per_s={out['samples_per_s']:.2f} step_ms={step_ms:.3f} "
        f"mfu={out['mfu']:.5f} (analytic conv+Dense FLOPs, 2 per MAC, x3 "
        f"for a train step: {flops:.4e} a step, over 989 TFLOP/s; not XLA's "
        f"cost analysis) bound_ms={out['bound_ms']:.3f} peak_mem_gib="
        f"{peak_gib:.2f} loss_first={first:.5f} loss_last={last:.5f}")
    if not (math.isfinite(first) and math.isfinite(last)):
        raise AssertionError(f"classify {name}: non-finite loss {first} "
                             f"{last}")
    del state, step, batches, model
    torch.cuda.empty_cache()
    return out


def loop_data(n_train, n_test):
    """The JAX package's synthetic CIFAR-10 (its own seed), train split
    through DataLoader + cifar10_train_transform, test split normalized,
    batch LOOP_BATCH, on the card."""
    from dtdl_tpu_torch.data.datasets import CIFAR10_MEAN, CIFAR10_STD
    from dtdl_tpu_torch.data.loader import (DataLoader,
                                            cifar10_train_transform,
                                            normalize_transform)
    from dtdl_tpu_torch.data.synthetic import synthetic_cifar10
    (xtr, ytr), (xte, yte) = synthetic_cifar10(n_train=n_train,
                                               n_test=n_test)
    train = DataLoader({"image": xtr, "label": ytr}, LOOP_BATCH,
                       transform=cifar10_train_transform(CIFAR10_MEAN,
                                                         CIFAR10_STD),
                       device=DEV)
    val = DataLoader({"image": xte, "label": yte}, LOOP_BATCH, shuffle=False,
                     drop_last=False,
                     transform=normalize_transform(CIFAR10_MEAN, CIFAR10_STD),
                     device=DEV)
    return train, val


class ListSink:
    """A reporter sink that keeps the payloads."""

    def __init__(self):
        self.payloads = []

    def write(self, payload):
        self.payloads.append(dict(payload))

    def close(self):
        pass


def phase_classify(torch, seed):
    """The throughput cells, then one end-to-end loop: train_epoch over
    E2E_STEPS batches and evaluate over the E2E_TEST test images."""
    from dtdl_tpu_torch.metrics.report import Reporter
    from dtdl_tpu_torch.train.loop import evaluate, train_epoch
    from dtdl_tpu_torch.train.optim import sgd
    from dtdl_tpu_torch.train.state import init_state
    from dtdl_tpu_torch.train.step import make_eval_step, make_train_step
    torch.backends.cudnn.benchmark = True
    cells = {(name, batch, align): classify_cell(torch, seed, name, batch,
                                                 align)
             for name, batch, align in CLASSIFY_CELLS}
    train, val = loop_data(LOOP_BATCH * E2E_STEPS, E2E_TEST)
    model = classifier("pyramidnet", dtype=torch.bfloat16, device=DEV,
                       seed=None)
    state = init_state(model, seed, sgd(0.1, momentum=0.9,
                                        weight_decay=1e-4), device=DEV)
    sink = ListSink()
    sync(torch)
    t0 = time.perf_counter()
    state, means = train_epoch(make_train_step(), state, train,
                               reporter=Reporter([sink]), log_interval=20)
    sync(torch)
    t_train = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = evaluate(make_eval_step(), state, val)
    t_eval = time.perf_counter() - t0
    torch.backends.cudnn.benchmark = False
    step_alone = cells.get(("pyramidnet", LOOP_BATCH, 1))
    loop_sps = LOOP_BATCH * E2E_STEPS / t_train
    log(f"classify loop pyramidnet bf16 batch {LOOP_BATCH}: train_epoch "
        f"over {E2E_STEPS} batches of synthetic CIFAR-10 (DataLoader + "
        f"cifar10_train_transform, first steps included) {t_train:.3f}s "
        f"samples_per_s={loop_sps:.2f} (the step alone: "
        f"{step_alone and round(step_alone['samples_per_s'], 2)}); "
        f"evaluate over {E2E_TEST} test images {t_eval:.3f}s "
        f"samples_per_s={E2E_TEST / t_eval:.2f} (eval mode reads the "
        f"running statistics, which after {E2E_STEPS} steps at lr 0.1 lag "
        f"the weights); train means {means}; eval {res}; reports "
        f"{[p.get('step') for p in sink.payloads]}")
    if not all(math.isfinite(v) for v in [*means.values(), *res.values()]):
        raise AssertionError(f"classify loop: non-finite metrics {means} "
                             f"{res}")
    return cells


def step_pair(torch, make_model, shape, batch, seed):
    """One f32 SGD step on the card and on the CPU from the same bridged
    weights and batch: (card state, CPU state, metrics each, eval logits
    each, the params before)."""
    from dtdl_tpu_torch import bridge
    from dtdl_tpu_torch.train.optim import sgd
    from dtdl_tpu_torch.train.state import init_state
    from dtdl_tpu_torch.train.step import make_train_step
    import numpy as np
    src = make_model("cpu").init_weights(seed)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():   # statistics off their init, so eval reads them
        for name, buf in src.named_buffers():
            buf.copy_(torch.rand(buf.shape, generator=gen) * 0.5
                      + (0.75 if name.endswith("var") else -0.25))
    params = bridge.state_dict_to_flax(src)
    stats = bridge.state_dict_to_flax(src, "batch_stats")
    rng = np.random.default_rng(seed)
    batch_np = {"image": rng.normal(size=(batch,) + shape).astype(np.float32),
                "label": rng.integers(0, 10, batch).astype(np.int32)}
    out = {}
    for dev in (DEV, "cpu"):
        model = bridge.load_flax_params(make_model(dev), params, stats,
                                        device=dev)
        state = init_state(model, None, sgd(STEP_LR, momentum=0.9,
                                            weight_decay=5e-4), device=dev)
        state, metrics = make_train_step()(state, batch_np)
        model.eval()
        with torch.no_grad():
            logits = model(torch.from_numpy(batch_np["image"]).to(dev))
        out[dev] = (state, {k: float(v) for k, v in metrics.items()},
                    logits.cpu())
    return out[DEV], out["cpu"], bridge.flatten(params)


def check_step_pair(torch, label, card, cpu, before):
    """classifycheck (1)'s comparisons."""
    import numpy as np
    from dtdl_tpu_torch import bridge
    (cs, cm, cl), (ps, pm, pl) = card, cpu
    loss_err = abs(cm["loss"] - pm["loss"]) / abs(pm["loss"])
    logit_err = float((cl - pl).abs().max() / pl.abs().max())
    got = bridge.flatten(bridge.state_dict_to_flax(cs.model))
    want = bridge.flatten(bridge.state_dict_to_flax(ps.model))
    shares, n_el = [], 0
    for path, w in want.items():
        moved = float(abs(w - before[path]).max())
        err = abs(got[path] - w) - STEP_ATOL
        shares.append((err / max(moved, 1e-30)).ravel())
        n_el += w.size
    shares = np.concatenate(shares)
    beyond = int((shares > STEP_SHARE).sum())
    worst = float(shares.max())
    gs = bridge.flatten(bridge.state_dict_to_flax(cs.model, "batch_stats"))
    ws = bridge.flatten(bridge.state_dict_to_flax(ps.model, "batch_stats"))
    stats_err = 0.0
    for path, w in ws.items():
        var = ws[path.rsplit("/", 1)[0] + "/var"]
        scale = (abs(var).max() if path.endswith("var")
                 else max(abs(w).max(), np.sqrt(var).max()))
        stats_err = max(stats_err, float(abs(gs[path] - w).max() / scale))
    ok = (loss_err <= 1e-5 and cm["accuracy"] == pm["accuracy"]
          and logit_err <= 1e-5 and stats_err <= 1e-5
          and beyond <= (1 - STEP_WITHIN) * n_el and worst <= STEP_SHARE_ALL)
    log(f"classifycheck {label} f32 card vs CPU, one sgd({STEP_LR}, "
        f"momentum 0.9, wd 5e-4) step: loss {cm['loss']:.6f} vs "
        f"{pm['loss']:.6f} (rel {loss_err:.2e}, tol 1e-5), accuracy "
        f"{cm['accuracy']} vs {pm['accuracy']}; eval logits err "
        f"{logit_err:.2e} of max (tol 1e-5); BN stats err {stats_err:.2e} "
        f"of scale (tol 1e-5); params: {beyond} of {n_el} elements beyond "
        f"{STEP_ATOL} + {STEP_SHARE} of their tensor's largest update "
        f"(allowed {1 - STEP_WITHIN:.0%}), worst {worst:.2e} of it (tol "
        f"{STEP_SHARE_ALL}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"classifycheck {label}: the card's f32 step "
                             f"disagrees with the CPU's")


def phase_classifycheck(torch, seed):
    """(1) f32 card vs CPU steps, (3) learnability, (2) bf16 vs f32."""
    from dtdl_tpu_torch.data.datasets import normalize_cifar10
    from dtdl_tpu_torch.data.synthetic import synthetic_cifar10
    from dtdl_tpu_torch.metrics.report import Reporter
    from dtdl_tpu_torch.models import PyramidNet, ResNet
    from dtdl_tpu_torch.train.loop import evaluate, train_epoch
    from dtdl_tpu_torch.train.optim import exponential_decay, sgd
    from dtdl_tpu_torch.train.state import init_state
    from dtdl_tpu_torch.train.step import make_eval_step, make_train_step
    for label, make, shape, batch in (
            ("PyramidNet(num_layers=3, alpha=48)",
             lambda dev: PyramidNet(num_layers=3, alpha=48, device=dev,
                                    seed=None), (32, 32, 3), 8),
            ("ResNet(stage_sizes=(1, 1, 1, 1))",
             lambda dev: ResNet(stage_sizes=(1, 1, 1, 1), device=dev,
                                seed=None), (64, 64, 3), 4)):
        card, cpu, before = step_pair(torch, make, shape, batch, seed)
        check_step_pair(torch, label, card, cpu, before)
    # (3) learnability: PyramidNet-110 bf16 through the loop
    train, val = loop_data(LOOP_BATCH * LEARN_STEPS, E2E_TEST)
    model = classifier("pyramidnet", dtype=torch.bfloat16, device=DEV,
                       seed=None)
    tx = sgd(exponential_decay(0.1, 2 * LEARN_STEPS, 0.1, staircase=True),
             momentum=0.9, weight_decay=1e-4)
    state = init_state(model, seed, tx, device=DEV)
    step, sink, epochs = make_train_step(), ListSink(), []
    t0 = time.perf_counter()
    for epoch in range(LEARN_EPOCHS):
        state, means = train_epoch(step, state, train, epoch=epoch,
                                   reporter=Reporter([sink]),
                                   log_interval=25)
        epochs.append(means)
    res = evaluate(make_eval_step(), state, val)
    wall = time.perf_counter() - t0
    ok = (epochs[-1]["loss"] < epochs[0]["loss"]
          and epochs[-1]["accuracy"] >= LEARN_ACC
          and res["accuracy"] >= LEARN_ACC)
    log(f"classifycheck learnability pyramidnet bf16 batch {LOOP_BATCH}, "
        f"{LEARN_EPOCHS} epochs x {LEARN_STEPS} steps of synthetic CIFAR-10 "
        f"with augmentation, sgd_steplr (0.1, x0.1 every 2 epochs) "
        f"({wall:.2f}s): epoch means "
        f"{[{k: round(v, 5) for k, v in e.items()} for e in epochs]}; "
        f"test {res}; threshold {LEARN_ACC} (chance 0.1) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("classifycheck: PyramidNet-110 did not learn "
                             "the synthetic task")
    # (2) the trained model's eval logits, bf16 against f32
    f32 = classifier("pyramidnet", dtype=torch.float32, device=DEV,
                     seed=None)
    f32.load_state_dict(model.state_dict())
    (_, _), (xte, _) = synthetic_cifar10(n_train=1, n_test=256)
    x = torch.from_numpy(normalize_cifar10(xte)).to(DEV)
    model.eval()
    f32.eval()
    with torch.no_grad():
        lb, lf = model(x), f32(x)
    spread = float(lf.max() - lf.min())
    err = float((lb - lf).abs().max())
    agree = float((lb.argmax(-1) == lf.argmax(-1)).float().mean())
    ok = err <= BF16_LOGIT_BUDGET * spread and math.isfinite(err)
    log(f"classifycheck pyramidnet-110 bf16 vs f32 eval logits (trained "
        f"weights, 256 test images): max |d| {err:.5f} = "
        f"{err / spread:.5f} of the f32 range {spread:.4f} (budget "
        f"{BF16_LOGIT_BUDGET}); argmax agreement {agree:.4f} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("classifycheck: bf16 logits outside their "
                             "budget of f32")


def phase_profile_classify(torch, seed, batch: int = 256):
    """Where a PyramidNet-110 bf16 step's time goes (torch.profiler):
    device time by group and host wall time per step."""
    from torch.profiler import ProfilerActivity, profile
    from dtdl_tpu_torch.train.optim import sgd
    from dtdl_tpu_torch.train.state import init_state
    from dtdl_tpu_torch.train.step import make_train_step
    torch.backends.cudnn.benchmark = True
    model = classifier("pyramidnet", dtype=torch.bfloat16, device=DEV,
                       seed=None)
    state = init_state(model, seed, sgd(0.1, momentum=0.9), device=DEV)
    step = make_train_step()
    gen = torch.Generator(device=DEV).manual_seed(seed)
    b = {"image": torch.randn((batch, 32, 32, 3), generator=gen, device=DEV),
         "label": torch.randint(0, 10, (batch,), generator=gen, device=DEV)}
    for _ in range(5):
        state, _ = step(state, b)
    sync(torch)
    t0 = time.perf_counter()
    for _ in range(5):
        state, _ = step(state, b)
    sync(torch)
    untraced = (time.perf_counter() - t0) / 5
    t0 = time.perf_counter()
    state, _ = step(state, b)
    host = time.perf_counter() - t0      # the step's return: dispatch only
    sync(torch)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, b)
        sync(torch)
    traced = time.perf_counter() - t0
    torch.backends.cudnn.benchmark = False
    kernels = [e for e in prof.key_averages()
               if "CUDA" in str(e.device_type)]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    n_launch = sum(e.count for e in kernels)
    log(f"profile classify pyramidnet-110 bf16 batch {batch}, one step: "
        f"untraced {1e3 * untraced:.3f} ms, traced {1e3 * traced:.3f} ms, "
        f"host dispatch of one untraced step (until it returns, before the "
        f"synchronize) {1e3 * host:.3f} ms, device kernel time "
        f"{dev_ms:.3f} ms over {n_launch} kernel launches (device busy "
        f"{dev_ms / (1e3 * traced):.3f} of the traced wall)")
    groups = {"conv wgrad": ("wgrad",), "conv dgrad": ("dgrad",),
              "cuDNN pads of channel counts (nhwcAddPadding)": (
                  "addpadding",),
              "conv forward": ("fprop", "implicit_convolve", "convolve",
                               "implicit_gemm", "cutlass"),
              "batch norm": ("batch_norm", "bn_"),
              "weight casts and copies": ("copy", "to_copy"),
              "memset": ("memset",),
              "optimizer": ("multi_tensor",),
              "elementwise, reductions, pads, pools": ()}
    spent = {g: [0.0, 0] for g in groups}
    for e in kernels:
        name = e.key.lower()
        g = next((g for g, keys in groups.items()
                  if any(k in name for k in keys)),
                 "elementwise, reductions, pads, pools")
        spent[g][0] += e.self_device_time_total / 1e3
        spent[g][1] += e.count
    for g, (ms, n) in spent.items():
        log(f"  {ms:9.3f} ms {n:6d} launches {100 * ms / max(dev_ms, 1e-9):5.1f}%"
            f"  {g}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x  "
            f"{e.key[:80]}")
    del state, step, model
    torch.cuda.empty_cache()


# ---- ddp: data-parallel training through the port's launcher ----------------

DDP_STEPS = 3        # steps whose parameters are held to the single-device
DDP_TIMED = 3        # steps in each timed block (single, ddp, ddp, single)
# (2) two gloo ranks on the one card, f32: the small LM at 8 x 257 tokens
# with a ragged mask and adamw, the MLP at 64 images with sgd + momentum,
# against the single-device step on the global batch.  The LM bound is
# tests/test_torch_train.py's for three adamw steps (atol 1e-5 on all but
# 0.1% of the elements, 2·lr a step on all: adam divides by the root of
# the second moment, so a near-zero gradient's sign, and a whole lr-sized
# step with it, can flip on last-bit differences); the MLP's is
# tests/test_torch_ddp.py's (rtol 1e-4, atol 1e-5)
DDP_PAIR_BATCH, DDP_PAIR_SEQ, DDP_PAIR_LR = 8, 256, 3e-4
DDP_PAIR_ATOL, DDP_PAIR_SHARE = 1e-5, 1e-3
DDP_MLP_TOL = (1e-4, 1e-5)
# (3) the DDP twin: PyramidNet-110 at the reference's global batch
TWIN_BATCH, TWIN_STEPS, TWIN_TEST = 64, 24, 1000
FAILFAST_BOUND_S = 5.0


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(args, nproc, timeout, label, env=None):
    """``python -m dtdl_tpu_torch.launch.local --nproc N -- args`` from
    the checkout's root: (exit code, output, seconds).  The whole output
    goes to build/ddp/<label>.log."""
    cmd = [sys.executable, "-m", "dtdl_tpu_torch.launch.local", "--nproc",
           str(nproc), "--port", str(free_port()), "--timeout", str(timeout),
           "--", *args]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": ROOT,
                               **(env or {})}, timeout=timeout + 60)
    seconds = time.perf_counter() - t0
    out = proc.stdout + proc.stderr
    logdir = os.path.join(ROOT, "build", "ddp")
    os.makedirs(logdir, exist_ok=True)
    with open(os.path.join(logdir, f"{label}.log"), "w") as f:
        f.write(out)
    return proc.returncode, out, seconds


def rank_lines(out, key="ddp_result "):
    """The JSON each rank printed after ``key``, by rank."""
    got = {}
    for line in out.splitlines():
        m = re.match(r"\[rank (\d+)\] " + re.escape(key) + r"(.*)", line)
        if m:
            got[int(m[1])] = json.loads(m[2])
    return got


def launched_ok(rc, out, label, ranks):
    if rc != 0:
        raise AssertionError(f"ddp {label}: the launch exited {rc}:\n"
                             f"{out[-4000:]}")
    got = rank_lines(out)
    if sorted(got) != list(range(ranks)):
        raise AssertionError(f"ddp {label}: results from ranks "
                             f"{sorted(got)}, want {ranks}:\n{out[-4000:]}")
    return got


def ddp_nccl_lm(torch, seed):
    """Rank 0 of an NCCL world of one: the base LM step single-device and
    under DataParallel from one seed and one batch stream."""
    from dtdl_tpu_torch import kernels
    from dtdl_tpu_torch.parallel import DataParallel
    from dtdl_tpu_torch.runtime import build_mesh
    dp = DataParallel(build_mesh())
    n = DDP_STEPS + 2 * DDP_TIMED
    runs = {"single": train_setup(torch, seed, n, TRAIN_BATCH, TRAIN_SEQ),
            "ddp": train_setup(torch, seed, n, TRAIN_BATCH, TRAIN_SEQ,
                               strategy=dp)}

    def run(name, k):
        state, step, batches = runs[name]
        losses = []
        for _ in range(k):
            state, metrics = step(state, next(batches))
            losses.append(metrics["loss"])
        return [float(x) for x in losses]

    losses = {"single": run("single", DDP_STEPS)}
    sync(torch)
    kernels.reset_launches()
    losses["ddp"] = run("ddp", DDP_STEPS)
    sync(torch)
    launches = dict(kernels.LAUNCHES)
    single = dict(runs["single"][0].model.named_parameters())
    ddp = dict(runs["ddp"][0].model.named_parameters())
    differ = [k for k in single if not torch.equal(single[k], ddp[k])]
    step_s = {"single": [], "ddp": []}
    for name in ("single", "ddp", "ddp", "single"):
        sync(torch)
        t0 = time.perf_counter()
        run(name, DDP_TIMED)
        step_s[name].append((time.perf_counter() - t0) / DDP_TIMED)
    grads = [p.grad for p in runs["ddp"][0].model.parameters()]
    grad_bytes = sum(g.numel() * g.element_size() for g in grads)
    sync_ms = cuda_ms(torch, lambda: dp.grad_sync(grads), iters=10,
                      warmup=2)
    tokens = TRAIN_BATCH * (TRAIN_SEQ - 1)
    out = {"bitwise_equal": not differ and losses["single"] == losses["ddp"],
           "differ": differ[:8], "losses": losses, "launches": launches,
           "n_layers": runs["ddp"][0].model.cfg.n_layers,
           "grad_bytes": grad_bytes, "grad_sync_ms": sync_ms}
    for name, ts in step_s.items():
        ms = 1e3 * sum(ts) / len(ts)
        out[f"{name}_step_ms"] = ms
        out[f"{name}_tokens_per_s"] = tokens / ms * 1e3
    return out


def ddp_gloo_pair(torch, seed):
    """Each of two gloo ranks on the one card: the small LM and the MLP
    under DataParallel on its half of each global batch; rank 0 also
    runs the single-device steps on the global batches and compares."""
    import numpy as np
    from dtdl_tpu_torch import kernels
    from dtdl_tpu_torch.bridge import flatten, state_dict_to_flax
    from dtdl_tpu_torch.models import MLP
    from dtdl_tpu_torch.models.transformer import transformer_lm
    from dtdl_tpu_torch.parallel import DataParallel
    from dtdl_tpu_torch.parallel.collectives import tree_digest
    from dtdl_tpu_torch.runtime import build_mesh, process_index
    from dtdl_tpu_torch.train.optim import adamw, sgd
    from dtdl_tpu_torch.train.state import init_state
    from dtdl_tpu_torch.train.step import make_lm_train_step, make_train_step
    rank = process_index()
    dp = DataParallel(build_mesh())
    rng = np.random.default_rng(seed)
    b, s = DDP_PAIR_BATCH, DDP_PAIR_SEQ
    data = {"lm": [{"tokens": rng.integers(0, 8192, (b, s + 1)),
                    "mask": (rng.random((b, s)) > 0.2).astype(np.float32)}
                   for _ in range(DDP_STEPS)],
            "mlp": [{"image": rng.normal(size=(64, 784)).astype(np.float32),
                     "label": rng.integers(0, 10, 64)}
                    for _ in range(DDP_STEPS)]}

    def half(batch):
        n = len(next(iter(batch.values()))) // 2
        return {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}

    def train(kind, strategy):
        if kind == "lm":
            model = transformer_lm("small", max_seq=s, seed=seed,
                                   dtype=torch.float32, device=DEV)
            tx, make = adamw(DDP_PAIR_LR), make_lm_train_step
        else:
            model = MLP(device=DEV, seed=seed)
            tx, make = sgd(0.1, momentum=0.9), make_train_step
        state = init_state(model, None, tx, device=DEV)
        if strategy is not None:
            state = strategy.replicate(state)
        step = make(strategy)
        for batch in data[kind]:
            state, metrics = step(state, half(batch) if strategy else batch)
        return float(metrics["loss"]), flatten(state_dict_to_flax(model))

    out = {}
    for kind in ("lm", "mlp"):
        kernels.reset_launches()
        loss, got = train(kind, dp)
        out[kind] = {"loss": loss, "digest": tree_digest(got)}
        if kind == "lm":
            out[kind]["launches"] = dict(kernels.LAUNCHES)
        if rank == 0:
            want_loss, want = train(kind, None)
            err = {k: np.abs(got[k] - want[k]) for k in want}
            scale = {k: np.abs(want[k]) for k in want}
            n_el = sum(e.size for e in err.values())
            if kind == "lm":
                past = sum(int((e > DDP_PAIR_ATOL).sum())
                           for e in err.values())
                out[kind].update(
                    past_atol=past, elements=n_el,
                    max_err=max(float(e.max()) for e in err.values()),
                    ok=past <= DDP_PAIR_SHARE * n_el and all(
                        float(e.max()) <= 2 * DDP_PAIR_LR * DDP_STEPS
                        for e in err.values()))
            else:
                rtol, atol = DDP_MLP_TOL
                worst = max(float((err[k] - rtol * scale[k]).max())
                            for k in err)
                out[kind].update(max_err=max(float(e.max())
                                             for e in err.values()),
                                 ok=worst <= atol)
            out[kind]["single_loss"] = want_loss
    # the bucketed gloo allreduce at the base LM's gradient set (42M f32)
    grads = [p.detach() for p in transformer_lm(
        "base", max_seq=TRAIN_SEQ, seed=None, dtype=torch.float32,
        device=DEV).parameters()]
    dp.grad_sync(grads)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        dp.grad_sync(grads)
    torch.cuda.synchronize()
    out["gloo_base_grad_sync_ms"] = (time.perf_counter() - t0) / 3 * 1e3
    out["gloo_base_grad_bytes"] = sum(g.numel() * 4 for g in grads)
    return out


def ddp_nccl_dup(torch, seed):
    """Two NCCL ranks on one card: what NCCL says (recorded, not gated)."""
    import torch.distributed as dist
    t = torch.ones(1, device=DEV)
    dist.all_reduce(t)
    torch.cuda.synchronize()
    return {"message": f"no error: all_reduce gave {float(t)}"}


DDP_WORKERS = {"nccl_lm": ddp_nccl_lm, "gloo_pair": ddp_gloo_pair,
               "nccl_dup": ddp_nccl_dup}


def ddp_worker(args) -> int:
    """One rank of a ddp-phase world, as ``launch.local`` starts it."""
    import torch
    sys.path.insert(0, ROOT)
    from dtdl_tpu_torch.runtime import initialize
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    backend = "gloo" if args.ddp_worker == "gloo_pair" else "nccl"
    try:
        initialize(args.coordinator, args.num_processes, args.process_id,
                   backend=backend, timeout_s=120)
        result = DDP_WORKERS[args.ddp_worker](torch, args.seed)
    except Exception as e:
        if args.ddp_worker != "nccl_dup":
            raise
        result = {"message": f"{type(e).__name__}: {e}"[:1500]}
        print("ddp_result " + json.dumps(result), flush=True)
        os._exit(0)      # no teardown of a refused communicator
    print("ddp_result " + json.dumps(result), flush=True)
    return 0


def phase_ddp(torch, seed, card):
    """(1) NCCL world 1, the base LM: DDP step bitwise the single-device
    step's, and their times; (2) two gloo ranks on the one card against
    the single-device step on the global batch, and what NCCL says for
    two ranks on one card; (3) the PyramidNet-110 DDP twin at world 1
    (NCCL) and 2 (gloo): leader-only log and weights, digests; (4) a
    launch in which one rank exits 3 returns 3."""
    import shutil
    from dtdl_tpu_torch.bridge import state_dict_to_flax
    from dtdl_tpu_torch.ckpt import load_weights
    from dtdl_tpu_torch.launch.local import launch_local
    from dtdl_tpu_torch.models import pyramidnet
    from dtdl_tpu_torch.parallel.collectives import tree_digest
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    me = os.path.join(ROOT, "chip_smoke.py")

    # (1)
    rc, out, secs = launch([me, "--ddp-worker", "nccl_lm", "--seed",
                            str(seed)], 1, 600, "nccl_lm")
    r = launched_ok(rc, out, "nccl_lm", 1)[0]
    want = r["n_layers"] * DDP_STEPS
    for name, k in (("flash_fwd", 1), ("flash_bwd_dq", 1),
                    ("flash_bwd_dkv", 1), ("rope_rows", 4)):
        if r["launches"][name] != k * want:
            raise AssertionError(f"ddp nccl_lm: {name} launched "
                                 f"{r['launches'][name]} times in "
                                 f"{DDP_STEPS} DDP steps, want {k * want}")
    if not r["bitwise_equal"]:
        raise AssertionError(f"ddp nccl_lm: the DDP step's parameters or "
                             f"losses differ from the single-device "
                             f"step's: {r['differ']} {r['losses']}")
    log(f"ddp nccl world 1 base bf16 (f32 weights) adamw(3e-4) "
        f"{TRAIN_BATCH}x{TRAIN_SEQ}: params after {DDP_STEPS} steps bitwise "
        f"equal to the single-device step's: True; single step_ms="
        f"{r['single_step_ms']:.3f} tokens_per_s="
        f"{r['single_tokens_per_s']:.1f}; ddp step_ms={r['ddp_step_ms']:.3f}"
        f" tokens_per_s={r['ddp_tokens_per_s']:.1f}; grad_sync ms="
        f"{r['grad_sync_ms']:.4f} over {r['grad_bytes']} bytes; launches "
        f"{r['launches']}; launch s={secs:.1f} | {card}")

    # (2)
    rc, out, secs = launch([me, "--ddp-worker", "gloo_pair", "--seed",
                            str(seed)], 2, 600, "gloo_pair")
    r = launched_ok(rc, out, "gloo_pair", 2)
    for kind in ("lm", "mlp"):
        if r[0][kind]["digest"] != r[1][kind]["digest"]:
            raise AssertionError(f"ddp gloo_pair {kind}: the ranks' "
                                 f"parameters differ")
        if not r[0][kind]["ok"]:
            raise AssertionError(f"ddp gloo_pair {kind}: DDP against the "
                                 f"single-device step: {r[0][kind]}")
    lm = r[0]["lm"]
    if not all(lm["launches"][k] for k in ("flash_fwd", "flash_bwd_dq",
                                           "flash_bwd_dkv")):
        raise AssertionError(f"ddp gloo_pair: K1-K3 not launched: "
                             f"{lm['launches']}")
    log(f"ddp gloo 2 ranks on one card f32: small LM {DDP_PAIR_BATCH}x"
        f"{DDP_PAIR_SEQ + 1} adamw({DDP_PAIR_LR}) {DDP_STEPS} steps: "
        f"{lm['past_atol']} of {lm['elements']} elements past "
        f"{DDP_PAIR_ATOL} of the single-device step, max {lm['max_err']:.3e}"
        f", loss {lm['loss']:.6f} vs {lm['single_loss']:.6f}; MLP sgd: "
        f"max {r[0]['mlp']['max_err']:.3e}; digests equal across ranks; "
        f"K1-K3 launches {lm['launches']}; gloo grad_sync of the base LM's "
        f"{r[0]['gloo_base_grad_bytes']} bytes: "
        f"{r[0]['gloo_base_grad_sync_ms']:.2f} ms (host clock); launch "
        f"s={secs:.1f} | {card}")
    rc, out, secs = launch([me, "--ddp-worker", "nccl_dup", "--seed",
                            str(seed)], 2, 150, "nccl_dup")
    dup = rank_lines(out)
    log(f"ddp nccl 2 ranks on one card: launch rc={rc} in {secs:.1f}s; "
        f"rank 0 says: {dup.get(0, {}).get('message', out[-300:])!r} | "
        f"{card}")

    # (3)
    like = state_dict_to_flax(pyramidnet(device="cpu", seed=None))
    for world, backend in ((1, "nccl"), (2, "gloo")):
        outdir = os.path.join(ROOT, "build", "ddp_twin", f"world{world}")
        shutil.rmtree(outdir, ignore_errors=True)
        args = ["-m", "dtdl_tpu_torch.examples.distributed_data_parallel",
                "--batch-size", str(TWIN_BATCH), "--limit-train",
                str(TWIN_BATCH * TWIN_STEPS), "--limit-test", str(TWIN_TEST),
                "--epochs", "1", "--log-interval", "8", "--seed", str(seed),
                "--out", outdir, "--dataset-dir",
                os.path.join(ROOT, "build", "ddp_twin", "datasets")]
        if backend == "gloo":
            args += ["--dist-backend", "gloo"]
        label = f"twin_world{world}"
        rc, out, secs = launch(args, world, 900, label,
                               env={"DTDL_OFFLINE": "1"})
        if rc != 0:
            raise AssertionError(f"ddp {label}: exited {rc}:\n{out[-4000:]}")
        summ = rank_lines(out, "ddp_summary ")
        if sorted(summ) != list(range(world)):
            raise AssertionError(f"ddp {label}: summaries from {sorted(summ)}")
        for key in ("params_digest", "batch_stats_digest"):
            if len({x[key] for x in summ.values()}) != 1:
                raise AssertionError(f"ddp {label}: {key} differs across "
                                     f"ranks: {summ}")
        files = sorted(os.listdir(outdir))
        if files != ["final.pt", "final.pt.manifest.json", "log.jsonl"]:
            raise AssertionError(f"ddp {label}: the run wrote {files}")
        rows = [json.loads(x) for x in open(os.path.join(outdir,
                                                         "log.jsonl"))]
        val = [x for x in rows if x.get("split") == "val"]
        if len(val) != 1 or "[p1]" in out:
            raise AssertionError(f"ddp {label}: log rows {len(rows)}, val "
                                 f"rows {len(val)}, a rank other than the "
                                 f"leader reported: {'[p1]' in out}")
        back = load_weights(os.path.join(outdir, "final.pt"), like)
        if tree_digest(back) != summ[0]["params_digest"]:
            raise AssertionError(f"ddp {label}: the saved weights' digest "
                                 f"differs from the ranks'")
        s0 = summ[0]
        # after the first window (the first step's warm-up): the loop's
        # per-step time at each later log boundary
        later = [x["batch_time"] for x in rows if x.get("step", 0) > 0
                 and "batch_time" in x]
        steady = TWIN_BATCH * len(later) / sum(later) if later else math.nan
        log(f"ddp twin pyramidnet-110 bf16 world {world} ({backend}) global "
            f"batch {TWIN_BATCH}: steps={s0['steps']} samples_per_s="
            f"{s0['samples_per_s']:.2f} (epoch, first step included; after "
            f"it {steady:.2f}) train_s={s0['train_s']:.3f} "
            f"val_accuracy={val[0]['val_accuracy']:.4f} over {TWIN_TEST} "
            f"images; log rows {len(rows)} by the leader, weights "
            f"{os.path.getsize(os.path.join(outdir, 'final.pt'))} bytes load "
            f"back to every rank's digest; BN statistics equal across ranks;"
            f" launch s={secs:.1f} | {card}")
        shutil.rmtree(outdir, ignore_errors=True)

    # (4) launch_local in this process: the time is the two children's
    # start, rank 1's exit and rank 0's termination, not the launcher's
    # own interpreter start
    code = ("import sys, time\nif sys.argv[-1] == '1':\n    sys.exit(3)\n"
            "time.sleep(300)\n")
    t0 = time.perf_counter()
    rc = launch_local(["-c", code], nproc=2, port=free_port(), timeout=120)
    secs = time.perf_counter() - t0
    if rc != 3 or secs > FAILFAST_BOUND_S:
        raise AssertionError(f"ddp fail-fast: rc {rc} after {secs:.1f}s, "
                             f"want 3 within {FAILFAST_BOUND_S}s")
    log(f"ddp fail-fast: rank 1 exits 3 while rank 0 sleeps, launch_local "
        f"returned {rc} in {secs:.3f}s (bound {FAILFAST_BOUND_S}s) | {card}")
    log(f"ddp phase: {time.perf_counter() - t_phase:.1f}s")


# ---- resume: snapshot and resume through the Trainer -------------------------

# (a) the base LM at the train phase's recipe: run A uninterrupted to
# RESUME_LM[0] iterations; run B snapshots at RESUME_LM[1] and stops at
# RESUME_LM[2]; a fresh Trainer and Checkpointer resume from the latest
# snapshot (mid-epoch: RESUME_LM_BATCHES batches an epoch) and run to A's
# end.  (b) PyramidNet-110 the same at RESUME_PYR.  Final params,
# optimizer state, step and LogReport records must be bitwise equal.
RESUME_LM, RESUME_LM_BATCHES = (8, 3, 5), 12
RESUME_PYR, RESUME_PYR_BATCHES = (6, 3, 4), 8
RESUME_TIMED = 3     # steps timed without a write in flight
# (d) the MNIST twins, as a user runs them
TWIN_MNIST_EPOCHS = 2


def host_tree(torch, state) -> dict:
    """A state's snapshot tree (flat) as host copies."""
    from dtdl_tpu_torch.bridge import flatten
    from dtdl_tpu_torch.train.state import state_to_tree
    return {k: (v.detach().cpu().clone() if isinstance(v, torch.Tensor)
                else v) for k, v in flatten(state_to_tree(state)).items()}


def tree_diff(torch, a: dict, b: dict) -> list:
    """Leaves of two flat trees that are not bitwise equal."""
    if a.keys() != b.keys():
        return sorted(set(a) ^ set(b))
    return [k for k in a if not (
        torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor)
        else a[k] == b[k])]


def log_records(log_ext) -> list:
    return [{k: v for k, v in r.items() if k != "elapsed_time"}
            for r in log_ext.records]


def lm_trainer(torch, seed, out, stop, snap=None, tokens=None):
    """The train phase's recipe under a Trainer: transformer_lm("base",
    max_seq=TRAIN_SEQ) in bf16 with f32 weights from ``seed``,
    adamw(3e-4), batches of TRAIN_BATCH sequences through the DataLoader,
    a LogReport every iteration, a snapshot every ``snap``."""
    from dtdl_tpu_torch.data.loader import DataLoader
    from dtdl_tpu_torch.data.sharding import ShardedSampler
    from dtdl_tpu_torch.models.transformer import transformer_lm
    from dtdl_tpu_torch.parallel import SingleDevice
    from dtdl_tpu_torch.train import (LogReport, Trainer, init_state,
                                      make_lm_train_step, snapshot)
    from dtdl_tpu_torch.train.optim import adamw
    loader = DataLoader({"tokens": tokens}, TRAIN_BATCH,
                        sampler=ShardedSampler(len(tokens), seed=seed),
                        device=DEV)
    model = transformer_lm("base", max_seq=TRAIN_SEQ, seed=None, device=DEV)
    tr = Trainer(init_state(model, seed, adamw(3e-4), device=DEV),
                 make_lm_train_step(), loader, SingleDevice(),
                 stop_trigger=(stop, "iteration"), out=out)
    log_ext = LogReport()
    tr.extend(log_ext, trigger=(1, "iteration"))
    if snap:
        tr.extend(snapshot(), trigger=(snap, "iteration"))
    return tr, log_ext


def pyr_trainer(torch, seed, out, stop, snap=None):
    """PyramidNet-110 (alpha 270) in bf16 with f32 weights, batch
    LOOP_BATCH of synthetic CIFAR-10 through the train transform, the
    reference's SGD + momentum + StepLR with a drop every 2 updates (so
    the resumed run crosses one), a LogReport every iteration."""
    from dtdl_tpu_torch.examples.common import sgd_steplr
    from dtdl_tpu_torch.parallel import SingleDevice
    from dtdl_tpu_torch.train import (LogReport, Trainer, init_state,
                                      make_train_step, snapshot)
    train, _ = loop_data(LOOP_BATCH * RESUME_PYR_BATCHES, LOOP_BATCH)
    model = classifier("pyramidnet", dtype=torch.bfloat16, device=DEV,
                       seed=None)
    tx, _ = sgd_steplr(0.1, 0.9, 1e-4, steps_per_epoch=1, step_epochs=2)
    tr = Trainer(init_state(model, seed, tx, device=DEV), make_train_step(),
                 train, SingleDevice(), stop_trigger=(stop, "iteration"),
                 out=out)
    log_ext = LogReport()
    tr.extend(log_ext, trigger=(1, "iteration"))
    if snap:
        tr.extend(snapshot(), trigger=(snap, "iteration"))
    return tr, log_ext


def ab_resume(torch, make, label, iters, batches_per_epoch, root, kernels,
              per_step=lambda state: {}):
    """Run A to iters[0]; run B with a snapshot at iters[1], stopped at
    iters[2]; a fresh Trainer resumes B's latest snapshot and runs to
    iters[0].  Bitwise gate, and each run's kernel launches against
    ``per_step(state)`` launches a step; returns (the resumed trainer,
    restore seconds, launches by run, leaves compared)."""
    total, snap, stop = iters
    launches = {}

    def run(tag, tr):
        kernels.reset_launches()
        tr.run()
        sync(torch)
        launches[tag] = dict(kernels.LAUNCHES)

    a, a_log = make(os.path.join(root, f"{label}_a"), total)
    want_launches = per_step(a.state)
    run("A", a)
    want, want_log = host_tree(torch, a.state), log_records(a_log)
    del a
    b, _ = make(os.path.join(root, f"{label}_b"), stop, snap)
    run("B", b)
    del b
    torch.cuda.empty_cache()
    c, c_log = make(os.path.join(root, f"{label}_b"), total)
    t0 = time.perf_counter()
    if not c.resume():
        raise AssertionError(f"resume {label}: no snapshot to resume")
    sync(torch)
    restore_s = time.perf_counter() - t0
    if (c.iteration, c._skip_batches) != (snap, snap % batches_per_epoch):
        raise AssertionError(f"resume {label}: resumed at iteration "
                             f"{c.iteration}, skipping {c._skip_batches}")
    run("resumed", c)
    got = host_tree(torch, c.state)
    bad = tree_diff(torch, want, got)
    if bad or log_records(c_log) != want_log:
        raise AssertionError(
            f"resume {label}: {len(bad)} of {len(want)} leaves differ from "
            f"the uninterrupted run ({bad[:8]}); LogReport records equal: "
            f"{log_records(c_log) == want_log}")
    for tag, steps in (("A", total), ("B", stop), ("resumed", total - snap)):
        for name, per_step in want_launches.items():
            if launches[tag][name] != per_step * steps:
                raise AssertionError(
                    f"resume {label} run {tag}: {name} launched "
                    f"{launches[tag][name]} times in {steps} steps, want "
                    f"{per_step * steps}")
    return c, restore_s, launches, len(want)


def resume_lm(torch, seed, card, root, kernels):
    """(a) the base LM A/B resume, then (c) the async hazard and the
    snapshot's costs on the resumed state."""
    from dtdl_tpu_torch.ckpt import Checkpointer
    from dtdl_tpu_torch.data.synthetic import synthetic_lm
    from dtdl_tpu_torch.train.step import make_lm_train_step
    tokens, _ = synthetic_lm(n_train=TRAIN_BATCH * RESUME_LM_BATCHES,
                             n_test=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                             vocab_size=32000, seed=seed)

    def make(out, stop, snap=None):
        return lm_trainer(torch, seed, out, stop, snap, tokens)

    def per_step(state):      # K1, K2, K3 once per layer and step
        n = state.model.cfg.n_layers
        return {"flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n}

    c, restore_s, launches, n_leaves = ab_resume(
        torch, make, "lm", RESUME_LM, RESUME_LM_BATCHES, root, kernels,
        per_step)
    log(f"resume lm base bf16 (f32 weights) adamw(3e-4) {TRAIN_BATCH}x"
        f"{TRAIN_SEQ}, {RESUME_LM_BATCHES} batches an epoch: A to "
        f"{RESUME_LM[0]}, B snapshot at {RESUME_LM[1]} stopped at "
        f"{RESUME_LM[2]}, a fresh Trainer resumed mid-epoch and ran to "
        f"{RESUME_LM[0]}: params, Adam moments, step and LogReport records "
        f"bitwise equal ({n_leaves} leaves); launches {launches} | {card}")

    # (c) the async hazard and the snapshot's costs, on the resumed state
    state, step = c.state, make_lm_train_step()
    batches = iter(c.train_loader)
    plain = []
    for _ in range(RESUME_TIMED):
        batch = next(batches)
        sync(torch)
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        sync(torch)
        plain.append(1e3 * (time.perf_counter() - t0))
    pre = host_tree(torch, state)
    nbytes = sum(v.numel() * v.element_size() for v in pre.values()
                 if isinstance(v, torch.Tensor))
    ck = Checkpointer(os.path.join(root, "hazard"))
    batch = next(batches)
    sync(torch)
    t0 = time.perf_counter()
    ck.save(state.step, state)
    save_ms = 1e3 * (time.perf_counter() - t0)
    state, _ = step(state, batch)          # at once: the hazard
    sync(torch)
    overlap_ms = 1e3 * (time.perf_counter() - t0) - save_ms
    ck.wait_until_finished()
    durable_s = time.perf_counter() - t0
    moved = tree_diff(torch, pre, host_tree(torch, state))
    del c, state
    torch.cuda.empty_cache()
    fresh, _ = make(os.path.join(root, "fresh"), 1)
    t0 = time.perf_counter()
    restored, at = Checkpointer(os.path.join(root, "hazard")).restore(
        fresh.state)
    sync(torch)
    restore2_s = time.perf_counter() - t0
    bad = tree_diff(torch, pre, host_tree(torch, restored))
    if at != pre["step"] or bad or not moved:
        raise AssertionError(f"resume hazard: restored step {at}, "
                             f"{len(bad)} leaves differ from the state "
                             f"save() saw ({bad[:8]}); the step after save "
                             f"moved {len(moved)} leaves")
    log(f"resume lm hazard: a step issued right after save() left the "
        f"snapshot bitwise the pre-step state ({len(pre)} leaves; the step "
        f"moved {len(moved)}) | {card}")
    log(f"resume lm snapshot: bytes={nbytes} save_ms={save_ms:.3f} "
        f"durable_committed_s={durable_s:.3f} restore_s={restore2_s:.3f} "
        f"(Trainer.resume {restore_s:.3f}) step_ms_overlapping_write="
        f"{overlap_ms:.3f} step_ms_without="
        f"{' '.join(f'{x:.3f}' for x in plain)} | {card}")
    del fresh, restored
    torch.cuda.empty_cache()


def resume_pyramidnet(torch, seed, card, root, kernels):
    """(b) PyramidNet-110 A/B resume under cuDNN's deterministic
    algorithms (set for this check only: cudnn.benchmark may pick
    algorithms whose weight gradients add in a run-dependent order)."""
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        c, restore_s, _, n_leaves = ab_resume(
            torch, lambda out, stop, snap=None: pyr_trainer(
                torch, seed, out, stop, snap),
            "pyramidnet", RESUME_PYR, RESUME_PYR_BATCHES, root, kernels)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = det
    group = c.state.optimizer.param_groups[0]
    log(f"resume pyramidnet-110 bf16 (f32 weights) batch {LOOP_BATCH} sgd "
        f"momentum 0.9 + StepLR (x0.1 every 2 updates), cudnn "
        f"deterministic: A to {RESUME_PYR[0]}, B snapshot at "
        f"{RESUME_PYR[1]} stopped at {RESUME_PYR[2]}, resumed to "
        f"{RESUME_PYR[0]}: params, BN statistics, momentum buffers, count "
        f"and LogReport records bitwise equal ({n_leaves} leaves), lr "
        f"{group['lr']:.6g} at count {group['count']}; restore "
        f"{restore_s:.3f}s | {card}")
    del c
    torch.cuda.empty_cache()


def twin_run(name, args, cwd, log_path, timeout=600):
    """``python -m dtdl_tpu_torch.examples.<name> args`` from ``cwd``
    (no dataset files there: the synthetic sets, no download); (output,
    seconds).  The output is appended to ``log_path``; a non-zero exit
    raises."""
    cmd = [sys.executable, "-m", f"dtdl_tpu_torch.examples.{name}", *args]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                       timeout=timeout, env={**os.environ, "PYTHONPATH": ROOT,
                                             "DTDL_OFFLINE": "1"})
    out = p.stdout + p.stderr
    with open(log_path, "a") as f:
        f.write(out)
    if p.returncode != 0:
        raise AssertionError(f"twin {name} exited {p.returncode}:\n"
                             f"{out[-4000:]}")
    return out, time.perf_counter() - t0


def resume_twins(torch, card, root):
    """(d) the Keras and Chainer MNIST twins as a user runs them."""
    data = ["--dataset-dir", os.path.join(root, "datasets")]

    def twin(name, *args):
        return twin_run(name, [*data, *args], root, os.path.join(
            ROOT, "build", f"resume_{name}.log"))

    out, secs = twin("mnist_single", "--epochs", str(TWIN_MNIST_EPOCHS),
                     "--train_dir", os.path.join(root, "keras"))
    ev = re.findall(r"Eval loss: \S+, Eval Accuracy: \S+", out)
    if not ev or f"Epoch [{TWIN_MNIST_EPOCHS - 1}]" not in out:
        raise AssertionError(f"mnist_single printed no report:\n"
                             f"{out[-4000:]}")
    log(f"resume twin mnist_single: {TWIN_MNIST_EPOCHS} epochs, "
        f"ModelCheckpoint, load_latest, evaluate: {ev[-1]} ({secs:.1f} s) "
        f"| {card}")
    out_dir = os.path.join(root, "chainer")
    out, secs = twin("train_mnist", "-e", str(TWIN_MNIST_EPOCHS), "-o",
                     out_dir)
    snaps = sorted(int(n.split("_")[1]) for n in os.listdir(out_dir)
                   if re.fullmatch(r"snapshot_\d+", n))
    if not snaps:
        raise AssertionError(f"train_mnist left no snapshot:\n{out[-4000:]}")
    out2, secs2 = twin("train_mnist", "-e", str(TWIN_MNIST_EPOCHS + 1), "-o",
                       out_dir, "--resume",
                       os.path.join(out_dir, f"snapshot_{snaps[-1]}"))
    rows = [x for x in out2.splitlines()
            if re.match(rf"\s+{TWIN_MNIST_EPOCHS + 1}\s+\d+\s", x)]
    if not rows:
        raise AssertionError(f"train_mnist --resume printed no epoch "
                             f"{TWIN_MNIST_EPOCHS + 1} row:\n{out2[-4000:]}")
    log(f"resume twin train_mnist: {TWIN_MNIST_EPOCHS} epochs ({secs:.1f} "
        f"s), then --resume snapshot_{snaps[-1]} to epoch "
        f"{TWIN_MNIST_EPOCHS + 1} ({secs2:.1f} s): {rows[-1].split()} "
        f"| {card}")


def phase_resume(torch, seed, card):
    """Snapshot and resume: (a) the base LM through K1-K3 and (b)
    PyramidNet-110, each A/B bitwise; (c) the async hazard and the
    snapshot's costs; (d) the MNIST twins."""
    import shutil
    from dtdl_tpu_torch import kernels
    root = os.path.join(ROOT, "build", "resume")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        resume_lm(torch, seed, card, root, kernels)
        resume_pyramidnet(torch, seed, card, root, kernels)
        resume_twins(torch, card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# faces: the last example twins, each as a user runs it
# ---------------------------------------------------------------------------

FACES_SERVE = ["--model-size", "base", "--page-size", "16", "--n-slots", "8",
               "--n-requests", "16", "--max-new-tokens", "32",
               "--shared-prefix", "256", "--dtype", "bfloat16"]
FACES_RESNET = ["--batch-size", "256", "--steps", "40", "--train-examples",
                "1024", "--log-interval", "20", "--image-size", "224",
                "--num-classes", "1000"]
# the classify phase's ResNet-50 cell (bf16, batch 256, cudnn.benchmark
# on), as PERF.md records it
RESNET50_CLASSIFY_MS = 64.612
FACES_CAFFE_ITERS = (600, 800)
FACES_EST_STEPS = 400


def faces_log(name) -> str:
    return os.path.join(ROOT, "build", "faces", f"{name}.log")


def in_process(main, argv, log_name):
    """``main(argv)`` of a twin in this process, its standard output
    appended to build/faces/<log_name>.log; (return value, output)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = main(argv)
    out = buf.getvalue()
    with open(faces_log(log_name), "a") as f:
        f.write(out)
    return ret, out


def faces_serve(torch, seed, card):
    """(a) the serve_lm twin on base at full width, bf16, page 16: K4
    launches, tokens/s, TTFT, and greedy tokens equal to the same
    requests through phase_serve's engine path with the plain attend
    (paged_kernel=False), any parting only at a bf16 near-tie."""
    from dtdl_tpu_torch import kernels
    from dtdl_tpu_torch.examples import serve_lm
    from dtdl_tpu_torch.models.transformer import transformer_lm
    argv = [*FACES_SERVE, "--seed", str(seed)]
    in_process(serve_lm.main, argv + ["--n-requests", "2"],
               "serve_lm_warmup")
    sync(torch)
    kernels.reset_launches()
    (reqs, s, wall), _ = in_process(serve_lm.main, argv, "serve_lm")
    sync(torch)
    k4 = kernels.LAUNCHES["paged_attention"]
    bad = [r for r in reqs if not r.done or r.error or len(r.tokens) != 32]
    if bad:
        raise AssertionError(f"faces serve_lm left unfinished requests: {bad}")
    opt = dict(zip(FACES_SERVE[::2], FACES_SERVE[1::2]))
    model = transformer_lm(opt["--model-size"], attn_impl="dense", seed=seed,
                           dtype=getattr(torch, opt["--dtype"]), device=DEV)
    n_layers = model.cfg.n_layers
    if k4 <= 0 or k4 % n_layers:
        raise AssertionError(f"faces serve_lm: K4 launched {k4} times, want "
                             f"> 0 and {n_layers} a step")
    _, _, plain, _ = serve(torch, model, [(list(r.prompt), r.max_new_tokens)
                                          for r in reqs], paged_kernel=False)
    # a parting is let pass only at a bf16 near-tie, as moe_serve's (d)
    scale = float(prefill_logits(torch, model, reqs[0].prompt).abs().max())
    tau = 2 * SPEC_DELTA_ULPS * 2.0 ** (math.floor(math.log2(scale)) - 7)
    parts = near_tie_divergences(torch, model, plain, reqs, tau)
    n_tok = sum(len(r.tokens) for r in reqs)
    lens = [len(r.prompt) for r in reqs]
    log(f"faces serve_lm twin base bf16 page 16 (8 slots, 16 requests of "
        f"{min(lens)}-{max(lens)} prompt tokens, shared prefix 256, 32 "
        f"new, greedy): served {s['requests_finished']} requests wall_s={wall:.4f} tokens_per_s="
        f"{n_tok / wall:.2f} decode_tokens_per_s="
        f"{s['decode_tokens_per_sec']:.2f} ttft_p50_s={s['ttft_s_p50']:.4f} "
        f"ttft_p99_s={s['ttft_s_p99']:.4f} prefix_hit_rate="
        f"{s['prefix_hit_rate']:.4f} K4 launches={k4} ({k4 // n_layers} "
        f"attends x {n_layers} layers) tokens identical to the plain "
        f"attend's engine path: {len(reqs) - len(parts)}/{len(reqs)}, "
        f"near-tie partings (position, top-two gap) {parts} (tau "
        f"{tau:.4e}) | {card}")
    del model
    torch.cuda.empty_cache()


def faces_resnet(torch, seed, card, root):
    """(b) imagenet_resnet50 at 224 px, 1000 classes, batch 256, bf16:
    samples/s and ms/step of the second log window (steps 21-40), MFU by
    classifier_train_flops, the closing train-pool accuracy."""
    out, secs = twin_run("imagenet_resnet50", [
        *FACES_RESNET, "--seed", str(seed), "--dataset-dir",
        os.path.join(root, "datasets")], root,
        faces_log("imagenet_resnet50"))
    rows = re.findall(r"step (\d+)/\d+ loss ([\d.]+) acc ([\d.]+) \| "
                      r"([\d,]+) samples/sec .*\| ([\d.]+) ms/step", out)
    final = re.search(r"final: train-pool acc ([\d.]+)", out)
    if len(rows) < 2 or not final:
        raise AssertionError(f"faces imagenet_resnet50 printed no report:\n"
                             f"{out[-4000:]}")
    step, loss, acc, sps, ms = rows[-1]
    model = classifier("resnet50", dtype=torch.bfloat16, device=DEV,
                       seed=None)
    flops = classifier_train_flops(torch, model, (224, 224, 3)) * 256
    del model
    torch.cuda.empty_cache()
    mfu = flops / (float(ms) / 1e3) / PEAK_OPS["bfloat16"]
    if not math.isfinite(float(loss)):
        raise AssertionError(f"faces imagenet_resnet50: loss {loss}")
    log(f"faces imagenet_resnet50 twin bf16 batch 256 224px 1000 classes "
        f"(choose_strategy auto = single, warm-up cosine, Nesterov SGD "
        f"0.9 + decay 1e-4; 40 steps over a 1024-image pool): steps 21-{step}"
        f" samples/sec={sps.replace(',', '')} ms/step={ms} (the classify "
        f"phase's cell in PERF.md: {RESNET50_CLASSIFY_MS} ms, cudnn.benchmark"
        f" on there) "
        f"mfu={mfu:.5f} (classifier_train_flops {flops:.4e} a step over "
        f"989 TFLOP/s) first window {rows[0][3].replace(',', '')} samples/sec"
        f" loss={loss} acc={acc} final train-pool acc={final[1]} "
        f"({secs:.1f} s) | {card}")


def faces_caffe(torch, card, root):
    """(c) caffe_train on the LeNet solver to 600 iterations, then
    --snapshot latest to 800: iterations/s of solve() with its test passes
    taken out, MFU by netspec_flops (f32 peak: the net is f32)."""
    from dtdl_tpu_torch.examples import caffe_train
    from dtdl_tpu_torch.obs.goodput import netspec_flops
    from dtdl_tpu_torch.train import solver as solver_mod
    from dtdl_tpu_torch.utils.prototxt import parse_file
    solver_path = os.path.join(ROOT, "examples", "caffe",
                               "lenet_solver.prototxt")
    out_dir = os.path.join(root, "caffe")
    clock = {"solve": 0.0, "test": 0.0, "iters": 0, "inside": False}
    solve, test = solver_mod.Solver.solve, solver_mod.Solver.test

    def timed_test(self):
        t0 = time.perf_counter()
        res = test(self)
        if clock["inside"]:
            clock["test"] += time.perf_counter() - t0
        return res

    def timed_solve(self):
        it0, t0 = self.iteration, time.perf_counter()
        clock["inside"] = True
        try:
            res = solve(self)
            sync(torch)
        finally:
            clock["inside"] = False
        clock["solve"] += time.perf_counter() - t0
        clock["iters"] += self.iteration - it0
        return res

    solver_mod.Solver.solve, solver_mod.Solver.test = timed_solve, timed_test
    try:
        outs = []
        for n, extra in ((FACES_CAFFE_ITERS[0], []),
                         (FACES_CAFFE_ITERS[1], ["--snapshot", "latest"])):
            clock.update(solve=0.0, test=0.0, iters=0)
            _, out = in_process(caffe_train.main, [
                "--solver", solver_path, "--max-iter", str(n), "--out",
                out_dir, "--dataset-dir", os.path.join(root, "datasets"),
                "--no-download", *extra], f"caffe_train_{n}")
            outs.append((out, dict(clock)))
    finally:
        solver_mod.Solver.solve, solver_mod.Solver.test = solve, test
    first, resumed = outs
    want = FACES_CAFFE_ITERS[0]
    interval = int(parse_file(solver_path).get_scalar("test_interval"))
    if f"resume: ok (iter {want})" not in resumed[0] or \
            not re.search(rf"iter: {want} \| test_loss", resumed[0]):
        raise AssertionError(f"faces caffe_train did not resume at {want}:\n"
                             f"{resumed[0][-4000:]}")
    tests = re.findall(r"iter: (\d+) \| test_loss: ([\d.]+) \| "
                       r"test_accuracy: ([\d.]+)", first[0])
    if [int(t[0]) for t in tests] != list(range(0, want + 1, interval)):
        raise AssertionError(f"faces caffe_train tested at "
                             f"{[t[0] for t in tests]}, want 0 and every "
                             f"test_interval ({interval}):\n"
                             f"{first[0][-4000:]}")
    final = re.findall(r"test: \{'test_loss': ([\d.]+), 'test_accuracy': "
                       r"([\d.]+)\}", resumed[0])
    flops = netspec_flops(os.path.join(ROOT, "examples", "caffe",
                                       "lenet_train_test.prototxt"),
                          (28, 28, 1), backward=True) * 64
    rates = []
    for out, c in outs:
        train_s = c["solve"] - c["test"]
        rates.append((c["iters"] / train_s,
                      flops * c["iters"] / train_s / PEAK_OPS["float32"]))
    log(f"faces caffe_train twin LeNet f32 batch 64 (solver inv lr, SGD "
        f"0.9, decay 5e-4): to {want} iterations {rates[0][0]:.2f} "
        f"iterations/s mfu={rates[0][1]:.6f} (netspec_flops x3 {flops:.4e}"
        f" a step over 67 TFLOP/s f32; test passes {outs[0][1]['test']:.2f}"
        f" s taken out) tests at iterations {[int(t[0]) for t in tests]}: "
        f"{tests[-1][2]}; --snapshot latest resumed at {want} (tested "
        f"there) to {FACES_CAFFE_ITERS[1]}: {rates[1][0]:.2f} iterations/s"
        f" final test accuracy {final[-1][1] if final else '?'} | {card}")


def faces_estimator(torch, card, root):
    """(d) tf_estimator to 400 steps checkpointing every 200, then the
    same command again: it restores 400 and runs no train step (the
    steps counted in this process)."""
    from dtdl_tpu_torch.examples import tf_estimator
    from dtdl_tpu_torch.train import estimator as est_mod
    model_dir = os.path.join(root, "estimator")
    args = ["--train_steps", str(FACES_EST_STEPS),
            "--save_checkpoints_steps", str(FACES_EST_STEPS // 2),
            "--model_dir", model_dir,
            "--dataset-dir", os.path.join(root, "datasets")]
    steps = [0]
    make = est_mod.make_train_step

    def counting(*a, **k):
        step = make(*a, **k)

        def run(state, batch):
            steps[0] += 1
            return step(state, batch)
        return run

    est_mod.make_train_step = counting
    try:
        runs = []
        for label in ("tf_estimator", "tf_estimator_again"):
            steps[0], t0 = 0, time.perf_counter()
            _, out = in_process(tf_estimator.main, args, label)
            runs.append((out, steps[0], time.perf_counter() - t0))
    finally:
        est_mod.make_train_step = make
    (out, n1, secs), (again, n2, secs2) = runs
    evals = re.findall(r"final eval: \{'loss': ([\d.]+), 'accuracy': "
                       r"([\d.]+), 'global_step': ([\d.]+)\}", out)
    rates = re.findall(r"global_step/sec: ([\d.]+)", out)
    if n1 != FACES_EST_STEPS or not evals or \
            float(evals[-1][2]) != FACES_EST_STEPS:
        raise AssertionError(f"faces tf_estimator ran {n1} steps, want "
                             f"{FACES_EST_STEPS}:\n{out[-4000:]}")
    snaps = sorted(int(n.split("_")[1]) for n in os.listdir(model_dir)
                   if re.fullmatch(r"snapshot_\d+", n))
    if n2 or "final eval: {}" not in again or snaps[-1] != FACES_EST_STEPS:
        raise AssertionError(f"faces tf_estimator ran {n2} steps after "
                             f"restoring {snaps}:\n{again[-4000:]}")
    preds = re.search(r"predictions: (\[[\d, ]+\])", again)
    log(f"faces tf_estimator twin MnistCNN f32 batch 128 adam(1e-3): "
        f"{n1} steps in legs of {FACES_EST_STEPS // 2} ({secs:.1f} s), "
        f"global_step/sec {rates}, final eval loss={evals[-1][0]} accuracy="
        f"{evals[-1][1]}; the second run restored {snaps[-1]} (snapshots "
        f"{snaps}) and ran {n2} train steps ({secs2:.1f} s), predictions "
        f"{preds and preds[1]} | {card}")


def faces_mxnet(torch, card, root):
    """(e) mxnet_kvstore --kv-store device (width 1, SingleDevice), one
    epoch of synthetic MNIST."""
    out, secs = twin_run("mxnet_kvstore", [
        "--kv-store", "device", "--num-epochs", "1", "--out",
        os.path.join(root, "mx"), "--dataset-dir",
        os.path.join(root, "datasets")], root, faces_log("mxnet_kvstore"))
    speeds = re.findall(r"Speed: ([\d.]+) samples/sec", out)
    val = re.search(r"Validation-accuracy=([\d.]+)", out)
    head = re.search(r"kvstore: kind=device rank=0 num_workers=1 width=1",
                     out)
    if not (speeds and val and head):
        raise AssertionError(f"faces mxnet_kvstore printed no report:\n"
                             f"{out[-4000:]}")
    log(f"faces mxnet_kvstore twin --kv-store device (width 1: "
        f"SingleDevice) MnistCNN f32 batch 64 sgd(0.05, 0.9), 1 epoch "
        f"(prefetch_to_device, a sync each step as Module.fit reads its "
        f"metrics): Speedometer samples/sec median "
        f"{sorted(float(s) for s in speeds)[len(speeds) // 2]:.2f} (last "
        f"{speeds[-1]}) validation accuracy {val[1]} ({secs:.1f} s) | {card}")


def faces_pyramidnet(torch, card, root):
    """(f) single_device and data_parallel (world 1), one epoch over 2560
    synthetic CIFAR-10 images, evaluate over 1000."""
    for name in ("single_device", "data_parallel"):
        out, secs = twin_run(name, [
            "--epochs", "1", "--limit-train", "2560", "--limit-test", "1000",
            "--out", os.path.join(root, name), "--no-download",
            "--dataset-dir", os.path.join(root, "datasets")], root,
            faces_log(name))
        epoch = re.search(r"Epoch \[0\] \| loss: ([\d.]+) \| accuracy: "
                          r"([\d.]+) \| epoch_time: ([\d.]+) \| "
                          r"avg_batch_time: ([\d.]+)", out)
        val = re.search(r"val_loss: ([\d.]+) \| val_accuracy: ([\d.]+)", out)
        if not (epoch and val and os.path.exists(
                os.path.join(root, name, "final.pt"))):
            raise AssertionError(f"faces {name} printed no report:\n"
                                 f"{out[-4000:]}")
        strategy = {"single_device": "SingleDevice",
                    "data_parallel": "DataParallel, world 1"}[name]
        log(f"faces {name} twin PyramidNet-110 bf16 batch 64 (SGD + StepLR,"
            f" {strategy}), 1 epoch of 40 steps: loss={epoch[1]} accuracy={epoch[2]} "
            f"epoch_time_s={epoch[3]} avg_batch_time_s={epoch[4]} "
            f"({64 / float(epoch[4]):.2f} samples/s, first step included), "
            f"val_loss={val[1]} val_accuracy={val[2]}, final weights saved "
            f"({secs:.1f} s) | {card}")


def phase_faces(torch, seed, card):
    """The last example twins on the card: (a) serve_lm through K4, (b)
    imagenet_resnet50, (c) caffe_train and its resume, (d) tf_estimator
    twice, (e) mxnet_kvstore, (f) single_device and data_parallel."""
    import shutil
    root = os.path.join(ROOT, "build", "faces", "work")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(root, "datasets"))
    t0 = time.perf_counter()
    try:
        faces_serve(torch, seed, card)
        faces_resnet(torch, seed, card, root)
        faces_caffe(torch, card, root)
        faces_estimator(torch, card, root)
        faces_mxnet(torch, card, root)
        faces_pyramidnet(torch, card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"faces: {time.perf_counter() - t0:.1f} s | {card}")


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


def time_paged(torch, *, b, s_new, pos, dtype=None, quant=None):
    """K4, its plain version, bound: at the engine's pool geometry
    (``quant`` 'int8' or 'fp8': quantized pools with their scales)."""
    from dtdl_tpu_torch.ops.paged_attention import (paged_attention,
                                                    paged_attention_reference)
    dtype = dtype or torch.bfloat16
    gen = torch.Generator(device=DEV).manual_seed(3)
    h, d, page, n_ptab = 4, 128, 16, 128
    q, pk, pv, ks, vs, table, pos_t, active, _ = paged_case(
        torch, gen, b=b, h=h, s_new=s_new, d=d, page=page, n_ptab=n_ptab,
        dtype=dtype, pos=pos, quant=quant)
    scale = 1.0 / math.sqrt(d)
    run = lambda: paged_attention(q, pk, pv, table, pos_t, active,  # noqa: E731
                                  scale=scale, key_scale=ks, value_scale=vs)
    plain = lambda: paged_attention_reference(  # noqa: E731
        q, pk, pv, table, pos_t, active, scale=scale, key_scale=ks,
        value_scale=vs)
    ms = cuda_ms(torch, run)
    plain_ms = cuda_ms(torch, plain, iters=5)
    el = pk.element_size() + (0 if ks is None else ks.element_size() / d)
    live_pages = sum((p + s_new - 1) // page + 1 for p in pos)
    nbytes = int(2 * live_pages * page * h * d * el       # live K, V, scales
                 + 2 * q.numel() * q.element_size()       # q in, o out
                 + b * n_ptab * 4 + 2 * b * 4)            # table, pos, active
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
    for the pair; and the pair as the training step runs it (flash_bwd:
    one rope pre-pass, K2, K3)."""
    import torch.nn.functional as F
    from dtdl_tpu_torch.ops.attention import (flash_bwd, flash_bwd_dkv,
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
        out["pair_ms"] = cuda_ms(torch, lambda: flash_bwd(*args, **kw))
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


def time_rope(torch):
    """The rope pre-pass at the training shape (q or k of one layer, bf16
    8 x 4 heads x 4096 x 128): kernel, plain version, bound.  No single
    PyTorch call computes it."""
    from dtdl_tpu_torch.ops.attention import _rotate, rope_rotate
    from dtdl_tpu_torch.ops.rope import rope_frequencies, rope_rows
    bh, s, d = TRAIN_BATCH * 4, TRAIN_SEQ, 128
    gen = torch.Generator(device=DEV).manual_seed(9)
    x = torch.randn(bh, s, d, generator=gen, device=DEV).to(torch.bfloat16)
    cos, sin = rope_frequencies(d, s, device=DEV)
    c, sn = rope_rows(cos, sin, torch.arange(s, device=DEV))
    ms = cuda_ms(torch, lambda: rope_rotate(x, c, sn))
    plain_ms = cuda_ms(torch, lambda: _rotate(x, c, sn), iters=5)
    nbytes = 2 * x.numel() * x.element_size() + 2 * s * d * 4
    ops = 3 * x.numel()          # two products and a sum per element
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS["float32"] * 1e3
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=None, bytes=nbytes, ops=ops)


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
    # one rank of the ddp phase's worlds, as launch.local starts it
    for name, kind in (("--ddp-worker", str), ("--coordinator", str),
                       ("--num-processes", int), ("--process-id", int)):
        ap.add_argument(name, type=kind, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.ddp_worker:
        return ddp_worker(args)
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
        spills, entry = [], "?"
        for x in lines:   # each spill line under its kernel's entry line
            if m := re.search(r"entry function '(\w+)'", x):
                entry = m[1]
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", x)
            if m and (int(m[1]) or int(m[2])):
                spills.append(f"{entry[:90]}: {x.strip()}")
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
        check_rope(torch, errors)
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
    if "spec" in phases:
        phase_spec(torch, args.seed)
    chunked = quant_launches = None
    if "chunked" in phases:
        chunked = phase_chunked(torch, args.seed)
    if "quant" in phases:
        quant_launches = phase_quant(torch, args.seed)
    if "contain" in phases:
        phase_contain(torch, args.seed)
    if "dense" in phases:
        phase_dense(torch, args.seed)
    if "moe_serve" in phases:
        phase_moe_serve(torch, args.seed)
    if "train" in phases:
        train_launches, _ = phase_train(torch, args.seed)
    if "traincheck" in phases:
        phase_traincheck(torch, args.seed)
    if "moe_train" in phases:
        phase_train(torch, args.seed, size="base-moe8")
    if "moe_traincheck" in phases:
        phase_traincheck(torch, args.seed, size="base-moe8")
    if "classify" in phases:
        phase_classify(torch, args.seed)
    if "classifycheck" in phases:
        phase_classifycheck(torch, args.seed)
    if "ddp" in phases:
        phase_ddp(torch, args.seed, card)
    if "resume" in phases:
        phase_resume(torch, args.seed, card)
    if "faces" in phases:
        phase_faces(torch, args.seed, card)

    if "profile" in phases:
        phase_profile(torch, args.seed)
        phase_profile_train(torch, args.seed)
        phase_profile_moe(torch, args.seed)
        phase_profile_classify(torch, args.seed)
    if "timing" in phases:
        # K4 at the main path's decode shape: 8 slots, pool of the engine
        # (page 16, 128 pages per slot), positions spread as the traffic's
        pos = [100, 250, 400, 550, 700, 850, 1000, 1050]
        k4 = time_paged(torch, b=8, s_new=1, pos=pos)
        log(fmt_timing("time K4 decode S=1 B=8 bf16", k4))
        k4p = time_paged(torch, b=1, s_new=512, pos=[256])
        log(fmt_timing("time K4 prefill S=512 pos=256 bf16", k4p))
        # K4 at chunked prefill's widest window (S = 257, B = 8) and at the
        # decode geometry with int8 and fp8 pools, each with its launches
        # on the chunked and quant phases' runs
        k4c = time_paged(torch, b=8, s_new=CHUNK_TOKENS + 1, pos=CHUNK_POS)
        log(fmt_timing(f"time K4 chunk S={CHUNK_TOKENS + 1} B=8 bf16 "
                       f"(launches at that width in a chunked run: "
                       f"{chunked and chunked['launches_257']})", k4c))
        for name in ("int8", "fp8"):
            t = time_paged(torch, b=8, s_new=1, pos=pos, quant=name)
            log(fmt_timing(f"time K4 decode S=1 B=8 {name} pool (launches in "
                           f"the quant phase's {name} run: "
                           f"{quant_launches and quant_launches[name]})", t))
        for rows in (8, 2048):
            ql = time_quant_linear(torch, rows)
            log(f"time projection 512->1408 x {rows} rows: bf16 "
                f"ms={ql['bf16']:.4f} int8 QuantLinear ms={ql['int8']:.4f} "
                f"fp8 QuantLinear ms={ql['fp8']:.4f}")
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
        log(f"time K2+K3 pair as the step runs it (flash_bwd: one rope "
            f"pre-pass, K2, K3): ms={tr['pair_ms']:.4f} library_ms="
            f"{tr['K2']['library_ms']:.4f}")
        rope_t = time_rope(torch)
        log(fmt_timing("time rope pre-pass train shape 32x4096 hd128 bf16 "
                       "(one of q, k; K1 and the K2/K3 pair each run two)",
                       rope_t))
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
            {"name": "rope_rows", "route": "cuda",
             "source": "dtdl_tpu_torch/csrc/rope_rows.cu",
             "replaces": "dtdl_tpu/ops/attention.py:118",
             "launches": train_launches.get("rope_rows"),
             "max_abs_err": errors.get("rope train 32x4096 hd128 bf16"),
             **{k: rope_t[k] for k in keys}},
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
