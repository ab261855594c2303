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
               ranks on one card (an NCCL group in that world, recorded);
               caffe_train --gpu 1 in that world (LeNet to 40 iterations,
               then --snapshot latest to 60, cuDNN deterministic): rank 1
               sits out, rank 0's parameters bitwise a world of one's;
               (3) the DDP twin (examples.distributed_data_parallel:
               PyramidNet-110, global batch 64, 8 steps and one evaluate
               of 500 synthetic CIFAR-10 images, the only ones generated)
               inside (1)'s world and (2)'s: leader-only log and weights,
               the weights loading back to every rank's digest, BatchNorm
               statistics equal across ranks, samples/s; (4) a launch in
               which one rank exits 3 returns 3 within 5 s;
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
               of its snapshot), 6000 images an epoch, each main() in this
               process; (e) the JAX package's files: the train_lm twin at
               base (64 x 128, one epoch, K1-K3) writes lm_final.msgpack,
               read back bitwise; bytes, save and load seconds of f32 and
               bf16 blobs; serve_lm --restore of it on faces (a)'s traffic
               token-identical to the same engine and scheduler serving
               the in-memory params, K4 once per layer and attend, tokens/s
               and TTFT, then without and with --restore in turns; an
               orbax snapshot refused by name where tensorstore does not
               import;
7h. faces    - the last example twins, each as a user runs it: (a)
               serve_lm on base at full width, bf16, page 16 (16 requests
               with a 256-token shared prefix, 32 new tokens, greedy):
               tokens/s, TTFT, K4 launches (one per layer and attend),
               greedy tokens identical to the same requests through the
               serve phase's engine path with the plain attend (a parting
               only at a bf16 near-tie, reported); (b) imagenet_resnet50
               at 224 px, 1000 classes, batch 256, 20 steps over a
               1024-image pool:
               samples/s, ms/step and MFU, the train-pool accuracy; (c)
               caffe_train on examples/caffe/lenet_solver.prototxt to 600
               iterations, then --snapshot latest to 800 (the resume starts
               at 600): iterations/s and MFU by netspec_flops; (d)
               tf_estimator to 200 steps, then again (it restores 200 and
               trains nothing); (e) mxnet_kvstore --kv-store device, one
               epoch of 6400 images; (f) single_device and data_parallel,
               one epoch of 1280 images each, evaluating 500; (b), (e) and
               (f) as main() in this process (c and d already were); each
               twin's output in build/faces/<twin>.log;
7i. fourd    - the 4D-parallel step (parallel/megatron.py) on the one-card
               mesh (1, 1, 1, 1) through K1-K3: (a) base widths, bf16 on
               f32 weights, adamw(3e-4), 8 x 4096, 1F1B over 2
               microbatches, 3 + 10 steps (tokens/s, step ms, MFU; K1
               2·M·L and K2, K3 M·L launches a step, the chunk forward
               recomputed at its backward tick); (b) against the
               single-device make_lm_train_step on to_flax_model with the
               weights to_flax_params converts: one f32 sgd step at 2
               layers and seq 512 (loss, every parameter) and (a)'s bf16
               trajectory; (c) fuse_rope True (K1-K3) against False
               (apply_rope, plain attend); (d) GPipe, interleaved 1F1B
               (v=2) and a routed top-2 MoE (8 experts, capacity 1.25),
               3 steps each, and ulysses_attention at axis size 1 against
               plain attention; (e) the train_lm_4d twin at the base widths
               (vocab 256) interrupted at 2 steps and resumed to 4 (final
               loss and every snapshot leaf bitwise the uninterrupted
               run's), then --generate-tokens 16;
7j. gspmd    - the GSPMD rule sets over two gloo ranks on the one card
               (this script's --ddp-worker gspmd through the launcher):
               (a) base bf16 and int8 served tensor-parallel (rules tp,
               mesh (data 1, model 2), page 16, 8 slots, the serve phase's
               16 prompts, 16 new tokens each) through K4 on each rank's
               pool of 2 of 4 heads, against the single-placement engine
               under the near-tie rule, KV bytes a rank (half), tokens/s;
               (b) the tp, tp_fsdp (1, 2) and fsdp (2, 1) steps at base
               widths, bf16 on f32 weights, adamw(3e-4), 8 x 1024 (the
               sequence cut from 4096 for the host staging), 2 steps each
               against the single-device step, K1-K3 launches and ms a
               step a rank; (c) ep on base-moe8 at capacity 8; (d) AutoSharded
               PyramidNet-110 f32 at a global batch of 64 against the
               single-device step, DataParallel's difference beside it;
               (e) the train_lm_gspmd twin's main with --rules tp and ep;
               (h) the Router over TP replicas on (a)'s engine, the serve
               phase's 16 requests at 32 new tokens, prefix cache off:
               (h1) two replicas sharing the TP engine against a
               single-placement Router on rank 0 (near-tie rule), both
               ranks' tokens identical, K4 launches by replica equal on
               both ranks; (h2) the same under a loop-site and an
               engine-site raise with auto_restart: 0 lost, tokens as
               (h1)'s, every evicted replica refilled, seconds from fault
               to HEALTHY; (h3) a TP prefill replica and a single-placement
               decode replica on rank 0 against (h1) (near-tie rule), the
               handoff's pages and seconds;
7k. fleet    - the serving fleet (serve/fleet.py) on the serve phase's
               engine (base bf16, page 16, 8 slots; its 16 requests), all
               replicas one engine in this process: (a) three replicas
               token-identical to the single scheduler (prefix cache off
               in (a)-(c); with it on, partings only at bf16 near-ties),
               tokens/s of both, K4 launches by replica; (b) replica 0's
               worker killed at
               loop iteration 5 and replica 1's engine raising at its
               call 20: every request as (a), evictions, retries,
               restarts, seconds from each fault to HEALTHY; (c) a rolling
               restart under the traffic, zero failures, memory before and
               after; (d) roles [prefill, decode, decode] at a chunk budget
               of 256 token-identical to the two halves through single
               schedulers with that budget (prefill_only, then kv_inject),
               and to one mixed chunked scheduler but at bf16 near-ties,
               pages handed over, kv_handoff_s p50 and max, K4 launches on
               each side; (e) two passes on a pool cut to 200 pages, evicted
               pages spilled to a host tier of half the shared prefix and a
               disk tier, token-identical to the two passes on the full
               pool, restored pages, spill and restore bytes and seconds,
               then one corrupt disk record quarantined and recomputed; (f)
               the serve_fleet twin with --disagg --kill-replica-after 5,
               zero requests lost;
7l. tenant   - tenancy (serve/tenant/): (a) base bf16, page 16, 8 slots,
               a LoRA bank of rank 16 with 3 loadable rows, five adapters
               saved through save_weights (each delta ~10% of its
               projection's output RMS, measured), the serve phase's 16
               requests round-robin over [base, A-E] in two waves: paired
               with an engine without a bank (plain, lora, lora, plain:
               tokens/s, TTFT p50/p99), bank loads and evictions (>= 2),
               K4 launches, prefix-hit pages by adapter (hits only within
               one adapter), every request against a plain engine serving
               merge_adapter(model, its adapter) under the near-tie rule;
               (b) at 2 layers in f32 the same traffic exactly the merged
               oracle, paged and dense, plain, chunked (256) and
               speculate=4; (c) a JSON schema over byte_vocab(32000): 8
               constrained and 8 free requests at base bf16 (every token
               legal, every EOS-ended output parsing), constrained against
               free tokens/s, mask bytes packed and dense, and at 2 layers
               f32 the eager masked argmax exactly, plain, speculate=4 and
               chunked, K4 once per layer in every step; (d) every request
               streamed (closed, not divergent, equal to its tokens), then
               a Router of 3 replicas of the LoRA engine with the fleet
               phase's faults: 0 lost, 0 divergent streams; (e) the
               serve_lm and serve_fleet twins with --lora/--stream
               (serve_lm with --json-schema) at their default watchdog,
               the fleet twin traced for its longest worker iteration;
7m. obs      - observability (obs/): (a) the train cell (base bf16,
               8 x 4096, adamw) through train_epoch, 3 warm-up and 10
               timed steps a run, runs with the full Observer (Tracer,
               GoodputMeter, a MetricsExporter with a JSONL sink) and
               without in five pairs, in turns: step ms and the overhead
               (the median of the pairs, limit 2%), the synchronizations
               of each run (equal, by site), span
               counts, the device track, the meter's MFU within 1% of the
               train line's, K1-K3 launches; (b) the serve cell through
               Scheduler(observer=, exporter=), one run observed and
               one not, then 16 pairs of runs observing every other
               step (even steps in one, odd in the other): tokens
               identical, tokens/s at most 2% below (the median, over
               every pair's adjacent even/odd steps, of half the
               difference of their log step ratios), TTFT p50/p99,
               synchronizations equal, every rid admitted -> first token
               -> finished with its flow closed, JSONL points, K4; (c) the
               fleet's three replicas with a killed worker and hedging at
               the twin's 0.25 s watchdog under the Observer, an exporter
               (JSONL, serve_http(0) scraped twice) and default_fleet_slos:
               0 lost, one terminal per rid, no dangling flow, only the
               killed replica evicted; then a loop-site stall breaks a TTFT
               objective and waves of short requests restore it
               (slo_breach, then slo_recovered, in the trace and the
               series); (d) serve_fleet at base and its default watchdog
               with every observability flag (32/32 served, no eviction,
               the longest worker iteration from its trace), serve_lm and
               train_lm with --trace;
7n. resil    - resilience (resil/, parallel/tcpstore.py): (a) the train
               cell (base bf16, 8 x 4096, adamw) under
               make_lm_train_step(guard=StepGuard("skip")), 10 steps a
               run: guarded without a fault bitwise the unguarded run, a
               NaN batch at step 4 skipped bitwise as if dropped (state
               step 9), the same waits on and off, K1-K3 80 each and rope
               320 a run, the guard's overhead (median of five pairs); (b)
               Trainer(guard=StepGuard("rollback")) at base width: a NaN
               burst restores the last good snapshot, bitwise the stream
               without its first batch, and a second burst past
               max_rollbacks escalates by name; (c) run_workers: four
               elastic workers (the elastic_train twin's MLP) on the card,
               rank 2 crashed: the survivors bitwise a fault-free world of
               3 from the same snapshot, no sample lost or doubled, detect,
               re-form and first-step seconds; (d) a coordinator process
               with a WAL and the twin's four worker processes through
               launch_local(store_port=, elastic=True): rank 2 SIGKILLed,
               then the coordinator SIGKILLed and restarted from its WAL,
               the survivors bitwise the in-process world of 3, then an
               amnesiac restart refused by name; (e) meanwhile a
               StepWatchdog on a two-rank gloo world on the card with one
               rank stalled raises PeerLostError within its timeout;
7o. audit    - the port's audit (dtdl_tpu_torch/analysis/): (a) the
               train cell (base bf16, 8 x 4096, adamw(3e-4)) through
               train_epoch(unroll=4) over 10 batches (bundles of 4, 4, 2)
               against unroll=1 from the same weights: every per-step
               metric and the final f32 weights bitwise equal, K1-K3 80
               each and rope 320 a run, step ms of each; (b) the program
               audit at full width, each program after one warm-up call,
               under the TorchDispatchMode census and
               set_sync_debug_mode("error"): the serve cell's base bf16
               paged engine's decode, verify (k = 2) and LoRA decode
               (nonzero adapter ids; K4 8 a call) and the train cell's
               step (K1-K3 8 each): 0 host syncs, 0 copies to the host,
               storages kept; then the contracts' four single-process
               programs at their tiny geometry against baselines.json;
               (c) the linter over dtdl_tpu_torch/ and this script: 0
               unsuppressed findings;
8. timing    - each kernel (and the rope pre-pass that K1 and K3 run
               first), its plain version and one library call at the main
               paths' shapes (K4 also at the chunk window S = 257 and at
               decode with int8 and fp8 pools), and the quantized
               projections against the bf16 one, with CUDA events.

``--phases profile`` (not in the default set) adds a serving run, two
training steps of base and of base-moe8, one PyramidNet-110 batch-256
step, and two 4D steps (dense and routed MoE) under torch.profiler (and
host timers for serving and the classifier step): where the main paths'
time goes.  ``--phases
train,traincheck`` drives the training path alone.

It prints one ``{"kernels": [...]}`` line and, last, the
``{"ok": true, "device": {...}}`` line.  Without a CUDA device, or without
the dtdl_tpu_torch package beside it, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import gc
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
          "classifycheck", "ddp", "resume", "faces", "fourd", "gspmd",
          "fleet", "timing", "tenant", "obs", "resil", "audit")
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

def prefill_logits(torch, model, seq, **engine_kw):
    """The last position's logits of an engine prefill of ``seq``
    (``engine_kw`` to the engine: ``quantize_weights``, ...)."""
    import numpy as np
    from dtdl_tpu_torch.serve.engine import InferenceEngine
    eng = InferenceEngine(model, n_slots=1, page_size=16, device=DEV,
                          **engine_kw)
    row = np.zeros(eng.n_ptab, np.int32)
    n_pg = -(-len(seq) // eng.page_size)
    row[:n_pg] = np.arange(1, n_pg + 1)
    _, _, logits = eng.prefill(eng.init_arena(), eng.init_last_tokens(), 0,
                               list(seq), page_row=row)
    return logits


def logit_gap(torch, model, prompt, tokens, j, **engine_kw) -> float:
    """The top-two logit gap where the plain run emitted ``tokens[j]``:
    the last position's logits of an engine prefill of prompt +
    tokens[:j] (a prefill, not the decode step itself, so it carries the
    same rounding differences as the thing it judges)."""
    top = torch.topk(prefill_logits(torch, model,
                                    list(prompt) + list(tokens[:j]),
                                    **engine_kw), 2).values
    return float(top[0] - top[1])


def near_tie_divergences(torch, model, plain, spec, tau, **engine_kw):
    """Each request's first position where the speculative (or other)
    tokens part from the plain ones, with the plain run's top-two gap
    there (the gap through an engine of ``engine_kw``); raises unless
    every such gap is within ``tau``."""
    out = []
    for a, b in zip(plain, spec):
        j = next((i for i, (x, y) in enumerate(zip(a.tokens, b.tokens))
                  if x != y), None)
        if j is None and len(a.tokens) == len(b.tokens):
            continue
        if j is None:
            raise AssertionError(f"request {a.rid}: lengths "
                                 f"{len(a.tokens)} vs {len(b.tokens)}")
        out.append((j, logit_gap(torch, model, a.prompt, a.tokens, j,
                                 **engine_kw)))
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
CLASSIFY_WARMUP, CLASSIFY_ITERS = 5, 20   # cut for the default run's time
CLASSIFY_INPUT = {"pyramidnet": ((32, 32, 3), 10),
                  "resnet50": ((224, 224, 3), 1000)}
# the end-to-end loop (classify) and the learnability run (classifycheck):
# PyramidNet-110 bf16 at batch 64 over the JAX package's synthetic CIFAR-10
# through DataLoader + cifar10_train_transform, train_epoch and evaluate
LOOP_BATCH = 64
LOOP_WORKERS = 4                        # the native loader's threads
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


def loop_data(n_train, n_test, workers=0):
    """The JAX package's synthetic CIFAR-10 (its own seed), train split
    through DataLoader + cifar10_train_transform (or, with ``workers``,
    the native loader's C++ augmentation on that many threads, as
    ``--num-workers`` takes it), test split normalized, batch LOOP_BATCH,
    on the card."""
    from dtdl_tpu_torch.data.datasets import CIFAR10_MEAN, CIFAR10_STD
    from dtdl_tpu_torch.data.loader import (DataLoader,
                                            cifar10_train_transform,
                                            normalize_transform)
    from dtdl_tpu_torch.data.native_loader import NativeDataLoader
    from dtdl_tpu_torch.data.synthetic import synthetic_cifar10
    (xtr, ytr), (xte, yte) = synthetic_cifar10(n_train=n_train,
                                               n_test=n_test)
    if workers:
        train = NativeDataLoader.or_python(
            xtr, ytr, LOOP_BATCH, augment=True, mean=CIFAR10_MEAN,
            std=CIFAR10_STD, n_threads=workers, device=DEV)
    else:
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
    # the same loop at the same depth through the native loader
    # (--num-workers 4): its C++ threads crop, flip and normalize
    torch.backends.cudnn.benchmark = True
    native, _ = loop_data(LOOP_BATCH * E2E_STEPS, LOOP_BATCH,
                          workers=LOOP_WORKERS)
    kind = type(native).__name__
    state = init_state(model, seed, sgd(0.1, momentum=0.9,
                                        weight_decay=1e-4), device=DEV)
    sync(torch)
    t0 = time.perf_counter()
    state, nmeans = train_epoch(make_train_step(), state, native)
    sync(torch)
    t_native = time.perf_counter() - t0
    torch.backends.cudnn.benchmark = False
    log(f"classify loop native: train_epoch over {E2E_STEPS} batches "
        f"through {kind} ({LOOP_WORKERS} threads, build/native) "
        f"{t_native:.3f}s samples_per_s="
        f"{LOOP_BATCH * E2E_STEPS / t_native:.2f} against the Python "
        f"loader's {loop_sps:.2f} above; train means {nmeans}")
    if kind != "NativeDataLoader" or not all(
            math.isfinite(v) for v in nmeans.values()):
        raise AssertionError(f"classify loop native: loader {kind} (the "
                             f"native library did not build?), means "
                             f"{nmeans}")
    native.close()
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
TWIN_BATCH, TWIN_STEPS, TWIN_TEST = 64, 8, 500
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


def slurm_launch(args, ntasks, timeout, label, env=None):
    """``args`` started as the tasks of a one-node SLURM step would start
    them: one process a task, each with SLURM_PROCID, SLURM_NTASKS,
    SLURM_JOB_NODELIST (localhost), SLURM_JOB_ID (one whose coordinator
    port is free), SLURM_NTASKS_PER_NODE and SLURM_LOCALID set, through
    ``python -m dtdl_tpu_torch.launch.slurm --``, which appends the
    rendezvous flags.  (exit code, output with each line prefixed
    ``[rank i]`` as the local launcher prefixes it, seconds); the whole
    output goes to build/ddp/<label>.log, and a task still running at
    ``timeout`` is killed."""
    import socket
    from dtdl_tpu_torch.launch.slurm import job_port
    for job in range(os.getpid() % 4096, os.getpid() % 4096 + 4096):
        with socket.socket() as sock:
            try:
                sock.bind(("127.0.0.1", job_port({"SLURM_JOB_ID": str(job)})))
            except OSError:
                continue
        break
    t0 = time.perf_counter()
    procs = []
    for rank in range(ntasks):
        task_env = {**os.environ, "PYTHONPATH": ROOT,
                    "OMP_NUM_THREADS": str(max(1, (os.cpu_count() or 1)
                                               // ntasks)),
                    "SLURM_PROCID": str(rank), "SLURM_NTASKS": str(ntasks),
                    "SLURM_JOB_NODELIST": "localhost",
                    "SLURM_JOB_ID": str(job),
                    "SLURM_NTASKS_PER_NODE": str(ntasks),
                    "SLURM_LOCALID": str(rank), **(env or {})}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "dtdl_tpu_torch.launch.slurm", "--",
             *args], cwd=ROOT, env=task_env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs, rcs = [], []
    try:
        for p in procs:
            remaining = max(1.0, timeout - (time.perf_counter() - t0))
            outs.append(p.communicate(timeout=remaining)[0])
            rcs.append(p.returncode)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.perf_counter() - t0
    out = "".join(f"[rank {r}] {line}\n" for r, text in enumerate(outs)
                  for line in text.splitlines())
    logdir = os.path.join(ROOT, "build", "ddp")
    os.makedirs(logdir, exist_ok=True)
    with open(os.path.join(logdir, f"{label}.log"), "w") as f:
        f.write(out)
    return next((rc for rc in rcs if rc), 0), out, seconds


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
    for _ in range(2):
        dp.grad_sync(grads)
    torch.cuda.synchronize()
    out["gloo_base_grad_sync_ms"] = (time.perf_counter() - t0) / 2 * 1e3
    out["gloo_base_grad_bytes"] = sum(g.numel() * 4 for g in grads)
    return out


def ddp_nccl_dup(torch):
    """Two ranks on one card, an NCCL group inside their gloo world: what
    NCCL says (recorded, not gated), under a watchdog so that a hang is
    named rather than waited out."""
    import torch.distributed as dist
    from dtdl_tpu_torch.resil import StepWatchdog

    def probe():
        group = dist.new_group(backend="nccl")
        t = torch.ones(1, device=DEV)
        dist.all_reduce(t, group=group)
        torch.cuda.synchronize()
        return f"no error: all_reduce gave {float(t)}"
    try:
        return {"message": StepWatchdog(20.0, name="nccl_dup").run(probe)}
    except Exception as e:
        return {"message": f"{type(e).__name__}: {e}"[:1500]}


def ddp_twin(args, world) -> dict:
    """The DDP twin's main() inside this rank's world (its rendezvous
    finds the world already joined): (seconds, the output directory)."""
    from dtdl_tpu_torch.examples import distributed_data_parallel as twin
    outdir = os.path.join(ROOT, "build", "ddp_twin", f"world{world}")
    if args.process_id == 0:
        import shutil
        shutil.rmtree(outdir, ignore_errors=True)
    argv = ["--batch-size", str(TWIN_BATCH), "--limit-train",
            str(TWIN_BATCH * TWIN_STEPS), "--limit-test", str(TWIN_TEST),
            "--epochs", "1", "--log-interval", "4", "--seed",
            str(args.seed), "--out", outdir, "--dataset-dir",
            os.path.join(ROOT, "build", "ddp_twin", "datasets"),
            "--coordinator", args.coordinator, "--num-processes",
            str(args.num_processes), "--process-id", str(args.process_id)]
    if world > 1:
        argv += ["--dist-backend", "gloo"]
    t0 = time.perf_counter()
    twin.main(argv)
    return {"twin_s": time.perf_counter() - t0, "outdir": outdir}


# caffe_train --gpu 1: LeNet to CAFFE_SUB_ITERS[0], then --snapshot latest
# to CAFFE_SUB_ITERS[1], on synthetic MNIST
CAFFE_SUB_ITERS = (40, 60)
CAFFE_SUB_DIR = os.path.join(ROOT, "build", "ddp_caffe")


def caffe_submesh(torch, out, topo=()) -> list:
    """``caffe_train --gpu 1`` as ``main()`` in this process (in a world,
    ``topo`` its rendezvous flags): each run's iteration and parameter
    digest, ``None`` where this process sat it out.  cuDNN's
    deterministic algorithms (and no TF32) for this check only, so that
    the run is bitwise repeatable."""
    from dtdl_tpu_torch.bridge import flatten
    from dtdl_tpu_torch.examples import caffe_train
    from dtdl_tpu_torch.parallel.collectives import tree_digest
    from dtdl_tpu_torch.train.state import params_tree
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ["DTDL_OFFLINE"] = "1"
    solver_path = os.path.join(ROOT, "examples", "caffe",
                               "lenet_solver.prototxt")
    runs = []
    try:
        for extra in (["--max-iter", str(CAFFE_SUB_ITERS[0])],
                      ["--max-iter", str(CAFFE_SUB_ITERS[1]),
                       "--snapshot", "latest"]):
            solver = caffe_train.main([
                "--solver", solver_path, "--gpu", "1", "--out", out,
                "--dataset-dir", os.path.join(CAFFE_SUB_DIR, "datasets"),
                "--limit-train", "2048", "--limit-test", "512", *extra,
                *topo])
            runs.append(None if solver is None else {
                "iteration": solver.iteration,
                "digest": tree_digest(flatten(params_tree(solver.net)))})
            del solver
    finally:
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    return runs


DDP_WORKERS = {"nccl_lm": ddp_nccl_lm, "gloo_pair": ddp_gloo_pair,
               "gspmd": lambda torch, seed: gspmd_worker(torch, seed)}


def ddp_worker(args) -> int:
    """One rank of a ddp-phase world, as ``launch.local`` starts it."""
    import torch
    sys.path.insert(0, ROOT)
    from dtdl_tpu_torch.runtime import initialize
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.ddp_worker.startswith("resil_"):
        return resil_worker(args)
    backend = "gloo" if args.ddp_worker in ("gloo_pair", "gspmd") \
        else "nccl"
    t0 = time.perf_counter()
    initialize(args.coordinator, args.num_processes, args.process_id,
               backend=backend,
               timeout_s=600 if args.ddp_worker == "gspmd" else 120)
    result = DDP_WORKERS[args.ddp_worker](torch, args.seed)
    result["world_s"] = time.perf_counter() - t0
    print("ddp_result " + json.dumps(result), flush=True)
    if args.ddp_worker in ("nccl_lm", "gloo_pair"):
        # one world answers two checks: the DDP twin runs in it
        gc.collect()
        torch.cuda.empty_cache()
        print("ddp_twin " + json.dumps(ddp_twin(args, args.num_processes)),
              flush=True)
    if args.ddp_worker == "gloo_pair":
        t1 = time.perf_counter()
        caffe = caffe_submesh(torch, os.path.join(CAFFE_SUB_DIR, "world"), [
            "--coordinator", args.coordinator, "--num-processes",
            str(args.num_processes), "--process-id", str(args.process_id)])
        caffe_s = time.perf_counter() - t1
        print("ddp_caffe " + json.dumps({"runs": caffe, "s": caffe_s}),
              flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        dup = ddp_nccl_dup(torch)
        dup["probe_s"] = time.perf_counter() - t1
        print("ddp_nccl_dup " + json.dumps(dup), flush=True)
        os._exit(0)      # no teardown of a refused communicator
    return 0


def ddp_twin_check(torch, out, world, backend, like, secs, card):
    """The DDP twin's run inside a ddp world: leader-only log and weights,
    the weights loading back to every rank's digest, BatchNorm statistics
    equal across ranks."""
    import shutil
    from dtdl_tpu_torch.ckpt import load_weights
    from dtdl_tpu_torch.parallel.collectives import tree_digest
    label = f"twin_world{world}"
    summ = rank_lines(out, "ddp_summary ")
    twin = rank_lines(out, "ddp_twin ")
    if sorted(summ) != list(range(world)) or 0 not in twin:
        raise AssertionError(f"ddp {label}: summaries from {sorted(summ)}")
    for key in ("params_digest", "batch_stats_digest"):
        if len({x[key] for x in summ.values()}) != 1:
            raise AssertionError(f"ddp {label}: {key} differs across "
                                 f"ranks: {summ}")
    outdir = twin[0]["outdir"]
    files = sorted(os.listdir(outdir))
    if files != ["final.msgpack", "final.msgpack.manifest.json",
                 "log.jsonl"]:
        raise AssertionError(f"ddp {label}: the run wrote {files}")
    rows = [json.loads(x) for x in open(os.path.join(outdir, "log.jsonl"))]
    val = [x for x in rows if x.get("split") == "val"]
    if len(val) != 1 or "[p1]" in out:
        raise AssertionError(f"ddp {label}: log rows {len(rows)}, val "
                             f"rows {len(val)}, a rank other than the "
                             f"leader reported: {'[p1]' in out}")
    back = load_weights(os.path.join(outdir, "final.msgpack"), like)
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
        f"{os.path.getsize(os.path.join(outdir, 'final.msgpack'))} bytes "
        f"(flax msgpack) load "
        f"back to every rank's digest; BN statistics equal across ranks;"
        f" twin s={twin[0]['twin_s']:.1f} in the launch of {secs:.1f} s | "
        f"{card}")
    shutil.rmtree(outdir, ignore_errors=True)


def phase_ddp(torch, seed, card):
    """(1) NCCL world 1, the base LM: DDP step bitwise the single-device
    step's, and their times, then the PyramidNet-110 DDP twin in the same
    world; (2) two gloo ranks on the one card, started as the tasks of a
    SLURM step (``slurm_launch``), against the single-device step on the
    global batch, the twin at world 2 in the same world, and what NCCL
    says for two ranks on one card (an NCCL group inside that world); (3)
    a launch in which one rank exits 3 returns 3."""
    from dtdl_tpu_torch.bridge import state_dict_to_flax
    from dtdl_tpu_torch.launch.local import launch_local
    from dtdl_tpu_torch.models import pyramidnet
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    me = os.path.join(ROOT, "chip_smoke.py")
    like = state_dict_to_flax(pyramidnet(device="cpu", seed=None))
    offline = {"DTDL_OFFLINE": "1"}
    sub_s = {}

    # (1)
    rc, out, secs = launch([me, "--ddp-worker", "nccl_lm", "--seed",
                            str(seed)], 1, 600, "nccl_lm", env=offline)
    sub_s["nccl_lm+twin_world1"] = round(secs, 1)
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
        f"{r['launches']}; world up to result s={r['world_s']:.1f} in the "
        f"launch of {secs:.1f} s | {card}")
    ddp_twin_check(torch, out, 1, "nccl", like, secs, card)

    # (2), its two ranks started as the tasks of a SLURM step
    import shutil
    shutil.rmtree(CAFFE_SUB_DIR, ignore_errors=True)
    rc, out, secs = slurm_launch([me, "--ddp-worker", "gloo_pair", "--seed",
                                  str(seed)], 2, 600, "gloo_pair",
                                 env=offline)
    sub_s["gloo_pair+twin_world2+nccl_dup"] = round(secs, 1)
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
    log(f"ddp gloo 2 ranks on one card, started as SLURM tasks "
        f"(SLURM_PROCID/NTASKS/JOB_NODELIST/JOB_ID, python -m "
        f"dtdl_tpu_torch.launch.slurm --) f32: small LM {DDP_PAIR_BATCH}x"
        f"{DDP_PAIR_SEQ + 1} adamw({DDP_PAIR_LR}) {DDP_STEPS} steps: "
        f"{lm['past_atol']} of {lm['elements']} elements past "
        f"{DDP_PAIR_ATOL} of the single-device step, max {lm['max_err']:.3e}"
        f", loss {lm['loss']:.6f} vs {lm['single_loss']:.6f}; MLP sgd: "
        f"max {r[0]['mlp']['max_err']:.3e}; digests equal across ranks; "
        f"K1-K3 launches {lm['launches']}; gloo grad_sync of the base LM's "
        f"{r[0]['gloo_base_grad_bytes']} bytes: "
        f"{r[0]['gloo_base_grad_sync_ms']:.2f} ms (host clock); world up to "
        f"result s={r[0]['world_s']:.1f} in the launch of {secs:.1f} s | "
        f"{card}")
    ddp_twin_check(torch, out, 2, "gloo", like, secs, card)
    caffe = rank_lines(out, "ddp_caffe ")
    t0 = time.perf_counter()
    one = caffe_submesh(torch, os.path.join(CAFFE_SUB_DIR, "one"))
    one_s = time.perf_counter() - t0
    sat = out.count("process 1 sits out: --gpu 1 trains over the first 1 "
                    "of 2")
    if (sorted(caffe) != [0, 1] or caffe[1]["runs"] != [None, None]
            or sat != 2 or caffe[0]["runs"] != one
            or [x["iteration"] for x in one] != list(CAFFE_SUB_ITERS)):
        raise AssertionError(f"ddp caffe_train --gpu 1 in the gloo world: "
                             f"ranks {caffe}, sat out {sat} times; a world "
                             f"of one {one}")
    shutil.rmtree(CAFFE_SUB_DIR, ignore_errors=True)
    log(f"ddp caffe_train --gpu 1 in the gloo world of 2 (a sub-mesh of "
        f"rank 0; rank 1 sat out both runs): LeNet f32 to "
        f"{CAFFE_SUB_ITERS[0]} iterations, then --snapshot latest to "
        f"{CAFFE_SUB_ITERS[1]}, cuDNN deterministic: rank 0's parameters "
        f"bitwise a world of one's after each run (digests "
        f"{[x['digest'][:12] for x in one]}); {caffe[0]['s']:.1f} s in "
        f"the world, {one_s:.1f} s alone | {card}")
    dup = rank_lines(out, "ddp_nccl_dup ")
    log(f"ddp nccl 2 ranks on one card (an NCCL group in the gloo world): "
        f"rank 0 says: {dup.get(0, {}).get('message', out[-300:])!r} in "
        f"{dup.get(0, {}).get('probe_s', math.nan):.1f}s | {card}")

    # (3) launch_local in this process: the time is the two children's
    # start, rank 1's exit and rank 0's termination, not the launcher's
    # own interpreter start
    code = ("import sys, time\nif sys.argv[-1] == '1':\n    sys.exit(3)\n"
            "time.sleep(300)\n")
    t0 = time.perf_counter()
    rc = launch_local(["-c", code], nproc=2, port=free_port(), timeout=120)
    secs = time.perf_counter() - t0
    sub_s["fail_fast"] = round(secs, 3)
    if rc != 3 or secs > FAILFAST_BOUND_S:
        raise AssertionError(f"ddp fail-fast: rc {rc} after {secs:.1f}s, "
                             f"want 3 within {FAILFAST_BOUND_S}s")
    log(f"ddp fail-fast: rank 1 exits 3 while rank 0 sleeps, launch_local "
        f"returned {rc} in {secs:.3f}s (bound {FAILFAST_BOUND_S}s) | {card}")
    log(f"ddp phase: {time.perf_counter() - t_phase:.1f}s, by launch "
        f"{sub_s}")


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
# the MNIST twins' epochs cut to 6000 of the 60000 images, and run in this
# process (the subprocess set-ups were most of their time), which keeps
# the default run's time with the obs phase in it
TWIN_MNIST_IMAGES = 6000
TWIN_MNIST_LIMIT = ["--limit-train", str(TWIN_MNIST_IMAGES)]


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


def resume_twins(torch, card, root):
    """(d) the Keras and Chainer MNIST twins as a user runs them."""
    data = ["--dataset-dir", os.path.join(root, "datasets")]

    def twin(name, *args):
        return twin_main(name, [*data, *TWIN_MNIST_LIMIT, *args],
                         os.path.join(ROOT, "build", f"resume_{name}.log"))

    out, secs = twin("mnist_single", "--epochs", str(TWIN_MNIST_EPOCHS),
                     "--train_dir", os.path.join(root, "keras"))
    ev = re.findall(r"Eval loss: \S+, Eval Accuracy: \S+", out)
    if not ev or f"Epoch [{TWIN_MNIST_EPOCHS - 1}]" not in out:
        raise AssertionError(f"mnist_single printed no report:\n"
                             f"{out[-4000:]}")
    log(f"resume twin mnist_single: {TWIN_MNIST_EPOCHS} epochs of "
        f"{TWIN_MNIST_IMAGES} images, "
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


# (e) the train_lm twin at base (its default bf16), one epoch of the
# synthetic LM set at batch 64 x 128 (64 steps), writing lm_final.msgpack
RESUME_TWIN_LM = ["--model-size", "base", "--seq-len", "128",
                  "--batch-size", "64", "--epochs", "1", "--log-interval",
                  "32"]


def weights_costs(torch, params, root):
    """Bytes, save_weights and load_weights seconds (the manifest's sha256
    included, the page cache warm) of ``params`` (live CUDA tensors) as an
    f32 and a bf16 blob."""
    from dtdl_tpu_torch.bridge import flatten, weights_tree
    from dtdl_tpu_torch.ckpt import load_weights, save_weights
    out = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        tree = weights_tree({k: v.to(dtype) for k, v in
                             flatten(params).items()})
        path = os.path.join(root, f"lm_{name}.msgpack")
        sync(torch)
        t0 = time.perf_counter()
        save_weights(path, tree)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = load_weights(path, tree)
        load_s = time.perf_counter() - t0
        bad = [k for k, v in flatten(tree).items()
               if not torch.equal(flatten(back)[k], v.cpu())]
        if bad:
            raise AssertionError(f"resume weights {name}: {bad[:5]} differ "
                                 f"after a save and load")
        out[name] = (os.path.getsize(path), save_s, load_s)
        os.remove(path)
    return out


def orbax_refusal(torch, root):
    """A JAX (orbax) snapshot directory restored where tensorstore does
    not import raises the named NotImplementedError; where it imports, the
    reader rejects this empty one as corrupt."""
    import importlib.util
    from dtdl_tpu_torch.ckpt import CheckpointCorruptError, Checkpointer
    snap = os.path.join(root, "orbax", "snapshot_1")
    os.makedirs(snap)
    for name, text in (("_METADATA", "{}"), ("_DTDL_COMMIT", "{}")):
        with open(os.path.join(snap, name), "w") as f:
            f.write(text)
    from dtdl_tpu_torch.models import MLP
    from dtdl_tpu_torch.train.optim import sgd
    from dtdl_tpu_torch.train.state import init_state
    like = init_state(MLP(device=DEV, seed=0), None, sgd(0.1), device=DEV)
    has_ts = importlib.util.find_spec("tensorstore") is not None
    try:
        Checkpointer(os.path.join(root, "orbax_own")).restore_path(like, snap)
    except NotImplementedError as e:
        if has_ts or "tensorstore" not in str(e) or "A8b" not in str(e):
            raise
        return f"NotImplementedError: {e}"
    except CheckpointCorruptError as e:
        if not has_ts:
            raise
        return f"tensorstore imports here; CheckpointCorruptError: {e}"
    raise AssertionError("an orbax snapshot restored without tensorstore")


def resume_weights(torch, seed, card, root):
    """(e) the JAX package's files: the train_lm twin writes
    lm_final.msgpack, read back bitwise; its bytes and costs as f32 and
    bf16 blobs; serve_lm --restore of it (faces (a)'s traffic) token-
    identical to the same engine and scheduler serving the in-memory
    params, K4 once per layer and attend; the orbax reader's refusal."""
    from dtdl_tpu_torch import kernels
    from dtdl_tpu_torch.bridge import (flatten, load_flax_params,
                                       state_dict_to_flax)
    from dtdl_tpu_torch.ckpt import load_weights
    from dtdl_tpu_torch.examples import serve_lm, train_lm
    from dtdl_tpu_torch.models.transformer import transformer_lm
    from dtdl_tpu_torch.serve import InferenceEngine, Scheduler
    from dtdl_tpu_torch.train.state import params_tree
    import numpy as np
    out = os.path.join(root, "lm_twin")
    log_path = os.path.join(ROOT, "build", "resume_weights.log")
    kernels.reset_launches()
    t0 = time.perf_counter()
    state, text = in_process(train_lm.main, [
        *RESUME_TWIN_LM, "--seed", str(seed), "--out", out], "train_lm",
        log_path)
    sync(torch)
    train_s = time.perf_counter() - t0
    trained = dict(kernels.LAUNCHES)
    n_layers = state.model.cfg.n_layers
    if not all(trained.get(k) for k in ("flash_fwd", "flash_bwd_dq",
                                        "flash_bwd_dkv", "rope_rows")):
        raise AssertionError(f"resume (e): the train_lm twin launched "
                             f"{trained}")
    path = os.path.join(out, "lm_final.msgpack")
    live = params_tree(state.model)
    t0 = time.perf_counter()
    back = load_weights(path, state_dict_to_flax(state.model))
    twin_load_s = time.perf_counter() - t0
    bad = [k for k, v in flatten(live).items()
           if not torch.equal(flatten(back)[k], v.cpu())]
    if bad:
        raise AssertionError(f"resume (e): lm_final.msgpack read back "
                             f"differs at {bad[:5]}")
    costs = weights_costs(torch, live, root)

    argv = [*FACES_SERVE, "--seed", str(seed), "--restore", path]
    in_process(serve_lm.main, argv + ["--n-requests", "2"],
               "serve_lm_restore_warmup", log_path)
    sync(torch)
    kernels.reset_launches()
    (reqs, s, wall), _ = in_process(serve_lm.main, argv, "serve_lm", log_path)
    sync(torch)
    k4 = kernels.LAUNCHES["paged_attention"]
    if k4 <= 0 or k4 % n_layers:
        raise AssertionError(f"resume (e) serve_lm --restore: K4 launched "
                             f"{k4} times, want > 0 and {n_layers} an attend")
    # the same engine and scheduler (as serve_lm builds them for argv)
    # over the trained params taken from memory, not from the file
    a = serve_lm.parser().parse_args(argv)
    model = transformer_lm(a.model_size, attn_impl="dense",
                           dtype=getattr(torch, a.dtype), device=DEV,
                           seed=None)
    load_flax_params(model, state_dict_to_flax(state.model), device=DEV)
    del state
    eng = InferenceEngine(model, n_slots=a.n_slots, page_size=a.page_size,
                          device=DEV)
    want = serve_lm.traffic(model, a, np.random.default_rng(a.seed))
    Scheduler(eng, seed=a.seed, harvest_lag=a.harvest_lag,
              prefix_cache=a.prefix_cache, device=DEV).run(want)
    differ = [i for i, (r, w) in enumerate(zip(reqs, want))
              if r.tokens != w.tokens or r.prompt != w.prompt]
    if differ or len(reqs) != len(want) or any(
            r.error or len(r.tokens) != a.max_new_tokens for r in reqs):
        raise AssertionError(f"resume (e) serve_lm --restore: requests "
                             f"{differ} differ from the in-memory params' "
                             f"tokens")
    refusal = orbax_refusal(torch, root)
    n_tok = sum(len(r.tokens) for r in reqs)
    # beside it in turns (without, without, with): the twin without
    # --restore, timed only, so that the file's cost is read inside one
    # stretch of the script (faces (a) runs much later)
    turns = {"restore": [n_tok / wall], "random": []}
    for kind in ("random", "random", "restore"):
        (got, _, w), _ = in_process(
            serve_lm.main, argv if kind == "restore" else argv[:-2],
            f"serve_lm_{kind}", log_path)
        turns[kind].append(sum(len(r.tokens) for r in got) / w)
    log(f"resume (e) train_lm twin base bf16 64x128, 1 epoch "
        f"({train_s:.1f} s): lm_final.msgpack {os.path.getsize(path)} bytes"
        f" read back bitwise ({len(flatten(live))} leaves, "
        f"{twin_load_s:.3f} s); launches {trained} | {card}")
    log(f"resume (e) weights blobs (flax msgpack, save_weights/load_weights "
        f"with the manifest's sha256, page cache warm): " + "; ".join(
            f"{k} bytes={b} save_s={sv:.4f} load_s={ld:.4f}"
            for k, (b, sv, ld) in costs.items()) + f" | {card}")
    log(f"resume (e) serve_lm --restore lm_final.msgpack base bf16 page 16 "
        f"(faces (a)'s 16 requests, 32 new, greedy): wall_s={wall:.4f} "
        f"tokens_per_s={n_tok / wall:.2f} decode_tokens_per_s="
        f"{s['decode_tokens_per_sec']:.2f} ttft_p50_s={s['ttft_s_p50']:.4f} "
        f"ttft_p99_s={s['ttft_s_p99']:.4f} K4 launches={k4} "
        f"({k4 // n_layers} attends x {n_layers} layers); tokens identical "
        f"to the in-memory params': {len(reqs)}/{len(reqs)}; in turns "
        f"(with, without, without, with) tokens_per_s with --restore "
        f"{[round(x, 2) for x in turns['restore']]} without "
        f"{[round(x, 2) for x in turns['random']]} | {card}")
    log(f"resume (e) orbax snapshot on this machine: {refusal[:300]} "
        f"| {card}")
    del model, eng
    gc.collect()
    torch.cuda.empty_cache()


def phase_resume(torch, seed, card):
    """Snapshot and resume: (a) the base LM through K1-K3 and (b)
    PyramidNet-110, each A/B bitwise; (c) the async hazard and the
    snapshot's costs; (d) the MNIST twins; (e) the JAX package's weights
    files through the train_lm and serve_lm twins."""
    import shutil
    from dtdl_tpu_torch import kernels
    root = os.path.join(ROOT, "build", "resume")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        resume_lm(torch, seed, card, root, kernels)
        resume_pyramidnet(torch, seed, card, root, kernels)
        resume_twins(torch, card, root)
        resume_weights(torch, seed, card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# faces: the last example twins, each as a user runs it
# ---------------------------------------------------------------------------

FACES_SERVE = ["--model-size", "base", "--page-size", "16", "--n-slots", "8",
               "--n-requests", "16", "--max-new-tokens", "32",
               "--shared-prefix", "256", "--dtype", "bfloat16"]
# the twins below serve_lm run in this process and cut to fewer steps
# (the subprocess set-ups and the epochs were most of the phase's time);
# widths, batch sizes and image sizes stay the reference's
FACES_RESNET = ["--batch-size", "256", "--steps", "20", "--train-examples",
                "1024", "--log-interval", "10", "--image-size", "224",
                "--num-classes", "1000"]
FACES_MX_IMAGES = 6400
FACES_PYR_TRAIN, FACES_PYR_TEST = 1280, 500
# the classify phase's ResNet-50 cell (bf16, batch 256, cudnn.benchmark
# on), as PERF.md records it
RESNET50_CLASSIFY_MS = 64.612
FACES_CAFFE_ITERS = (600, 800)
FACES_EST_STEPS = 200


def faces_log(name) -> str:
    return os.path.join(ROOT, "build", "faces", f"{name}.log")


def in_process(main, argv, log_name, log_path=None):
    """``main(argv)`` of a twin in this process, as a user's script calls
    it (no interpreter start, import and CUDA set-up of its own), its
    standard output appended to build/faces/<log_name>.log (or
    ``log_path``); (return value, output)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = main(argv)
    out = buf.getvalue()
    with open(log_path or faces_log(log_name), "a") as f:
        f.write(out)
    return ret, out


def twin_main(name, args, log_path):
    """The twin ``name``'s ``main(args)`` in this process (in_process);
    (output, seconds), its memory released after it."""
    import importlib
    import torch
    # no dataset file here: the synthetic sets, never a download
    os.environ["DTDL_OFFLINE"] = "1"
    mod = importlib.import_module(f"dtdl_tpu_torch.examples.{name}")
    t0 = time.perf_counter()
    _, out = in_process(mod.main, list(args), name, log_path)
    secs = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    return out, secs


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
    samples/s and ms/step of the second log window (steps 11-20), MFU by
    classifier_train_flops, the closing train-pool accuracy."""
    out, secs = twin_main("imagenet_resnet50", [
        *FACES_RESNET, "--seed", str(seed), "--dataset-dir",
        os.path.join(root, "datasets")], faces_log("imagenet_resnet50"))
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
        f"0.9 + decay 1e-4; 20 steps over a 1024-image pool): steps 11-{step}"
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
    """(d) tf_estimator to FACES_EST_STEPS steps checkpointing every
    half of them, then the same command again: it restores the last and
    runs no train step (the steps counted in this process)."""
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
    epoch of FACES_MX_IMAGES synthetic MNIST images (of 60000: cut for the
    default run's time)."""
    out, secs = twin_main("mxnet_kvstore", [
        "--kv-store", "device", "--num-epochs", "1", "--limit-train",
        str(FACES_MX_IMAGES), "--out",
        os.path.join(root, "mx"), "--dataset-dir",
        os.path.join(root, "datasets")], faces_log("mxnet_kvstore"))
    speeds = re.findall(r"Speed: ([\d.]+) samples/sec", out)
    val = re.search(r"Validation-accuracy=([\d.]+)", out)
    head = re.search(r"kvstore: kind=device rank=0 num_workers=1 width=1",
                     out)
    if not (speeds and val and head):
        raise AssertionError(f"faces mxnet_kvstore printed no report:\n"
                             f"{out[-4000:]}")
    log(f"faces mxnet_kvstore twin --kv-store device (width 1: "
        f"SingleDevice) MnistCNN f32 batch 64 sgd(0.05, 0.9), 1 epoch of "
        f"{FACES_MX_IMAGES} images "
        f"(prefetch_to_device, a sync each step as Module.fit reads its "
        f"metrics): Speedometer samples/sec median "
        f"{sorted(float(s) for s in speeds)[len(speeds) // 2]:.2f} (last "
        f"{speeds[-1]}) validation accuracy {val[1]} ({secs:.1f} s) | {card}")


def faces_pyramidnet(torch, card, root):
    """(f) single_device and data_parallel (world 1), one epoch over
    FACES_PYR_TRAIN synthetic CIFAR-10 images, evaluate over
    FACES_PYR_TEST."""
    for name in ("single_device", "data_parallel"):
        out, secs = twin_main(name, [
            "--epochs", "1", "--limit-train", str(FACES_PYR_TRAIN),
            "--limit-test", str(FACES_PYR_TEST),
            "--out", os.path.join(root, name), "--no-download",
            "--dataset-dir", os.path.join(root, "datasets")],
            faces_log(name))
        epoch = re.search(r"Epoch \[0\] \| loss: ([\d.]+) \| accuracy: "
                          r"([\d.]+) \| epoch_time: ([\d.]+) \| "
                          r"avg_batch_time: ([\d.]+)", out)
        val = re.search(r"val_loss: ([\d.]+) \| val_accuracy: ([\d.]+)", out)
        if not (epoch and val and os.path.exists(
                os.path.join(root, name, "pyramidnet_final.msgpack"))):
            raise AssertionError(f"faces {name} printed no report:\n"
                                 f"{out[-4000:]}")
        strategy = {"single_device": "SingleDevice",
                    "data_parallel": "DataParallel, world 1"}[name]
        log(f"faces {name} twin PyramidNet-110 bf16 batch 64 (SGD + StepLR,"
            f" {strategy}), 1 epoch of {FACES_PYR_TRAIN // 64} steps: "
            f"loss={epoch[1]} accuracy={epoch[2]} "
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
# phase 7i: fourd, the 4D-parallel step on the one-card mesh
# ---------------------------------------------------------------------------

# the 4D config at the base widths (vocab 32000, d_model 512, 4 heads of
# 128, d_ff 1408, 8 layers), max_seq 4096, the train phase's batch
FOURD_WIDTHS = dict(vocab_size=32000, d_model=512, n_heads=4, d_ff=1408,
                    n_stages=1, layers_per_stage=8, max_seq=TRAIN_SEQ,
                    n_microbatches=2)
FOURD_CHECK_LAYERS, FOURD_CHECK_SEQ = 2, 512
# (b) f32, the 4D step against the single-device step (summation order
# only: the 4D step adds two microbatches' gradients, rounds the head in
# another order): tests/test_megatron.py's loss bound and PARAM_TOL.
# bf16, the 13-step trajectory: the 4D head takes f32 logits of the
# bf16 hidden state where the single-device head rounds its logits to
# bf16 (2^-8 of logits ~ 1 each), so each loss may differ by rounding of
# that size, as traincheck's bf16 loss bound
FOURD_TOL = dict(loss=(1e-5, 1e-5), param=(2e-4, 2e-4), bf16_loss=2e-2)
# (e) the twin: the script's own vocab (256) at the base widths
FOURD_TWIN = ["--mesh", "1,1,1,1", "--d-model", "512", "--n-heads", "4",
              "--d-ff", "1408", "--layers-per-stage", "8", "--seq-len",
              str(TRAIN_SEQ), "--batch-size", str(TRAIN_BATCH),
              "--microbatches", "2", "--log-interval", "1"]
FOURD_TWIN_STEPS = (2, 4)          # interrupted at 2, resumed to 4


def fourd_cfg(torch, **kw):
    from dtdl_tpu_torch.parallel import megatron as M
    return M.MegatronConfig(**{**FOURD_WIDTHS, "dtype": torch.bfloat16,
                               **kw})


def fourd_batches(seed, n, batch, seq, vocab):
    """``n`` host batches of synthetic Markov sequences of ``seq + 1``
    tokens: (token rows, the 4D step's tokens/targets/mask)."""
    import numpy as np

    from dtdl_tpu_torch.data.synthetic import markov_tokens
    toks = markov_tokens(n * batch, seq + 1, vocab, seed=seed + 3)
    out = []
    for i in range(n):
        t = toks[i * batch:(i + 1) * batch]
        out.append((t, {"tokens": t[:, :-1], "targets": t[:, 1:],
                        "mask": np.ones((batch, seq), np.float32)}))
    return out


def fourd_run(torch, cfg, params, batches, tx, warmup=0, label=""):
    """The 4D step on the one-card mesh from the global ``params``: the
    losses and metrics of every batch, the launches and wall seconds of
    the steps after ``warmup`` (counts set to 0 just before them), the
    final shards."""
    from dtdl_tpu_torch import kernels
    from dtdl_tpu_torch.parallel import megatron as M
    mesh = M.build_4d_mesh()
    if mesh.size != 1:
        raise AssertionError(f"fourd runs on one card, mesh {mesh.shape}")
    p = M.place_params(mesh, cfg, params, device=DEV)
    opt = M.init_optimizer(cfg, mesh, tx, p)
    step = M.make_megatron_train_step(cfg, mesh, tx)
    losses, metrics = [], []
    for i, (_, host) in enumerate(batches):
        if i == warmup:
            sync(torch)
            kernels.reset_launches()
            t0 = time.perf_counter()
        b = M.shard_lm_batch(mesh, host, device=DEV)
        p, opt, loss, m = step(p, opt, b["tokens"], b["targets"], b["mask"])
        losses.append(loss)
        metrics.append(m)
    sync(torch)
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    losses = [float(x) for x in losses]
    metrics = [{k: float(v) for k, v in m.items()} for m in metrics]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"fourd {label}: non-finite loss {losses}")
    return dict(losses=losses, metrics=metrics, launches=launches,
                wall=wall, steps=len(batches) - warmup, params=p)


def single_device_run(torch, cfg, params, batches, tx, attn="flash"):
    """The port's single-device LM step (make_lm_train_step) on
    to_flax_model with the weights to_flax_params converts: losses and
    the final flax tree."""
    from dtdl_tpu_torch.bridge import load_flax_params, state_dict_to_flax
    from dtdl_tpu_torch.parallel import megatron as M
    from dtdl_tpu_torch.train.state import init_state
    from dtdl_tpu_torch.train.step import make_lm_train_step
    lm = M.to_flax_model(cfg, device=DEV, attn_impl=attn, dtype=cfg.dtype)
    load_flax_params(lm, M.to_flax_params(cfg, params), device=DEV)
    state = init_state(lm, None, tx, device=DEV)
    step = make_lm_train_step()
    losses = []
    for toks, _ in batches:
        state, m = step(state, {"tokens": toks})
        losses.append(m["loss"])
    sync(torch)
    tree = dict(M._leaves(state_dict_to_flax(lm)))
    del state, lm
    return [float(x) for x in losses], tree


def param_errs(torch, cfg, shards, want_flax, atol, rtol):
    """(worst |got - want| / (atol + rtol·|want|), its path) over the
    4D shards converted to the flax tree against ``want_flax``."""
    import numpy as np

    from dtdl_tpu_torch.parallel import megatron as M
    worst, at = 0.0, ""
    for path, got in M._leaves(M.to_flax_params(cfg, shards)):
        want = want_flax[path]
        r = float(np.max(np.abs(got - want) / (atol + rtol * np.abs(want))))
        if r > worst:
            worst, at = r, path
    return worst, at


def phase_fourd(torch, seed, card):
    """The 4D-parallel step (parallel/megatron.py) on the one-card mesh
    (1, 1, 1, 1) through K1-K3: (a) the base widths, bf16 on f32 weights,
    adamw(3e-4), 8 x 4096, 1F1B over 2 microbatches, 3 + 10 steps;
    (b) against the single-device step (f32 at 2 layers and seq 512, one
    sgd step; the (a) trajectory in bf16); (c) fused (K1-K3) against
    unfused rope (plain attend); (d) GPipe, interleaved 1F1B (v=2) and a
    routed top-2 MoE (8 experts, capacity 1.25), 3 steps each, and
    Ulysses at axis size 1 against plain attention; (e) the train_lm_4d
    twin interrupted, resumed (the final loss and snapshot bitwise) and
    decoding 16 tokens."""
    import contextlib
    import dataclasses
    import io
    import shutil

    import numpy as np

    from dtdl_tpu_torch import kernels
    from dtdl_tpu_torch.examples import train_lm_4d
    from dtdl_tpu_torch.models.transformer import LMConfig
    from dtdl_tpu_torch.obs.goodput import lm_train_flops, peak_flops_per_chip
    from dtdl_tpu_torch.ops.attention import flash_attention_reference
    from dtdl_tpu_torch.parallel import megatron as M
    from dtdl_tpu_torch.parallel.sequence import ulysses_attention
    from dtdl_tpu_torch.train.optim import adamw, sgd
    t_phase = time.perf_counter()
    B, S = TRAIN_BATCH, TRAIN_SEQ
    out = {}

    # (a) the run
    cfg = fourd_cfg(torch)
    params = M.init_params(cfg, seed)
    batches = fourd_batches(seed, 13, B, S, cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    a = fourd_run(torch, cfg, params, batches, adamw(3e-4), warmup=3,
                  label="(a)")
    L, Mb = cfg.n_layers, cfg.n_microbatches
    want = {"flash_fwd": 2 * Mb * L, "flash_bwd_dq": Mb * L,
            "flash_bwd_dkv": Mb * L}
    per_step = {k: v / a["steps"] for k, v in a["launches"].items()}
    lmcfg = LMConfig(vocab_size=cfg.vocab_size, d_model=cfg.d_model,
                     n_layers=L, n_heads=cfg.n_heads, d_ff=cfg.d_ff)
    flops = lm_train_flops(lmcfg, B, S + 1)
    step_ms = 1e3 * a["wall"] / a["steps"]
    peak = peak_flops_per_chip()
    mfu = flops * a["steps"] / a["wall"] / peak if peak else None
    out["a"] = dict(step_ms=step_ms, tokens_per_s=B * S * a["steps"]
                    / a["wall"], mfu=mfu, launches_per_step=per_step)
    log(f"fourd (a) 1F1B mesh (1,1,1,1) base widths bf16 (f32 weights) "
        f"adamw(3e-4) {B}x{S}, {Mb} microbatches: steps={a['steps']} (after "
        f"3 warm-up) step_ms={step_ms:.2f} tokens_per_s="
        f"{out['a']['tokens_per_s']:.1f} flops_per_step={flops:.4e} mfu="
        f"{mfu if mfu is None else round(mfu, 5)} peak_mem_gib="
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} loss_first="
        f"{a['losses'][0]:.5f} loss_last={a['losses'][-1]:.5f}; launches per "
        f"step {per_step} (predicted K1 2*M*L={want['flash_fwd']}, K2 and K3 "
        f"M*L={want['flash_bwd_dq']})")
    for name, n in want.items():
        if a["launches"][name] != n * a["steps"]:
            raise AssertionError(f"fourd (a): {name} launched "
                                 f"{a['launches'][name]} times in "
                                 f"{a['steps']} steps, want {n} a step")
    if not a["losses"][-1] < a["losses"][0]:
        raise AssertionError(f"fourd (a): the loss did not fall: "
                             f"{a['losses']}")

    # (b) against the single-device step: bf16, the (a) trajectory
    sd_losses, _ = single_device_run(torch, cfg, params, batches,
                                     adamw(3e-4))
    d = [abs(x - y) for x, y in zip(a["losses"], sd_losses)]
    ok = max(d) <= FOURD_TOL["bf16_loss"]
    log(f"fourd (b) bf16 13-step trajectory, 4D vs single-device "
        f"make_lm_train_step on to_flax_model: 4D "
        f"{[round(x, 5) for x in a['losses']]} single "
        f"{[round(x, 5) for x in sd_losses]} max |d|={max(d):.3e} (tol "
        f"{FOURD_TOL['bf16_loss']}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("fourd (b): the bf16 trajectories part")
    del a
    torch.cuda.empty_cache()

    # (b) f32 at 2 layers, seq 512, and (c) fused against unfused rope
    small = dict(layers_per_stage=FOURD_CHECK_LAYERS,
                 max_seq=FOURD_CHECK_SEQ, dtype=torch.float32)
    cfg32 = fourd_cfg(torch, **small)
    p32 = M.init_params(cfg32, seed + 1)
    b32 = fourd_batches(seed + 1, 1, B, FOURD_CHECK_SEQ, cfg32.vocab_size)
    fused = fourd_run(torch, cfg32, p32, b32, sgd(0.1), label="(b) f32")
    sd_loss, sd_tree = single_device_run(torch, cfg32, p32, b32, sgd(0.1))
    atol, rtol = FOURD_TOL["loss"]
    ok_loss = abs(fused["losses"][0] - sd_loss[0]) <= \
        atol + rtol * abs(sd_loss[0])
    worst, at = param_errs(torch, cfg32, fused["params"], sd_tree,
                           *FOURD_TOL["param"])
    fl = fused["launches"]
    ok = ok_loss and worst <= 1.0
    log(f"fourd (b) f32 2-layer seq {FOURD_CHECK_SEQ} one sgd(0.1) step, 4D "
        f"(K1-K3) vs single-device (K1-K3): loss {fused['losses'][0]:.6f} vs "
        f"{sd_loss[0]:.6f} (atol {atol} rtol {rtol}); worst parameter "
        f"{worst:.3f} of its bound (atol/rtol {FOURD_TOL['param']}) at {at}; "
        f"4D launches {fl} {'ok' if ok else 'FAIL'}")
    if not ok or fl["flash_fwd"] != 2 * Mb * FOURD_CHECK_LAYERS:
        raise AssertionError("fourd (b): the f32 4D step disagrees with the "
                             "single-device step")
    unfused = fourd_run(torch, dataclasses.replace(cfg32, fuse_rope=False),
                        p32, b32, sgd(0.1), label="(c) unfused")
    shards = dict(M._leaves(unfused["params"]))
    worst_c, at_c = 0.0, ""
    for path, x in M._leaves(fused["params"]):
        w = shards[path].detach().float().cpu().numpy()
        r = float(np.max(np.abs(x.detach().float().cpu().numpy() - w)
                         / (FOURD_TOL["param"][0] + FOURD_TOL["param"][1]
                            * np.abs(w))))
        if r > worst_c:
            worst_c, at_c = r, path
    ok = worst_c <= 1.0 and unfused["launches"]["flash_fwd"] == 0
    log(f"fourd (c) f32 2-layer one step fuse_rope=True (K1-K3) vs False "
        f"(apply_rope + plain attend): loss {fused['losses'][0]:.6f} vs "
        f"{unfused['losses'][0]:.6f}; worst parameter {worst_c:.3f} of its "
        f"bound at {at_c}; unfused launches {unfused['launches']} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("fourd (c): fused and unfused steps disagree")
    del fused, unfused, shards
    torch.cuda.empty_cache()

    # (d) other schedules and the MoE at full width, 3 steps each
    three = batches[:3]
    for label, kw in (("gpipe", dict(schedule="gpipe")),
                      ("1f1b v=2", dict(virtual_stages=2)),
                      ("moe routed top-2 E=8 cf=1.25",
                       dict(n_experts=8, moe_dispatch="routed",
                            moe_top_k=2, capacity_factor=1.25))):
        c = fourd_cfg(torch, **kw)
        p = params if not c.n_experts else M.init_params(c, seed)
        r = fourd_run(torch, c, p, three, adamw(3e-4), warmup=1,
                      label=label)
        moe = ""
        if c.n_experts:
            moe = " " + " ".join(
                f"moe_dropped_frac={m['moe_dropped_frac']:.5f} "
                f"moe_aux_loss={m['moe_aux_loss']:.5f}"
                for m in r["metrics"])
        log(f"fourd (d) {label}: losses {[round(x, 5) for x in r['losses']]} "
            f"step_ms {1e3 * r['wall'] / r['steps']:.2f} (2 steps after 1) "
            f"launches {r['launches']}{moe}")
        if r["launches"]["flash_fwd"] == 0:
            raise AssertionError(f"fourd (d) {label}: no K1 launch")
        del r
        torch.cuda.empty_cache()
    mesh = M.build_4d_mesh()
    gen = torch.Generator(device=DEV).manual_seed(seed)
    q, k, v = (torch.randn(B, cfg.n_heads, S, cfg.head_dim, generator=gen,
                           device=DEV).to(torch.bfloat16) for _ in range(3))
    kernels.reset_launches()
    with torch.no_grad():
        o = ulysses_attention(q, k, v, mesh=mesh, axis_name="seq",
                              causal=True)
        n_k1 = kernels.LAUNCHES["flash_fwd"]
        want_o, _ = flash_attention_reference(q, k, v, causal=True)
    err = max_err(o, want_o)
    ok_u, msg = within(o, want_o, torch.bfloat16)
    log(f"fourd (d) ulysses_attention axis size 1 bf16 {B}x{cfg.n_heads}x"
        f"{S}x{cfg.head_dim} causal vs plain attention: max_abs_err "
        f"{err:.3e} ({msg}); K1 launches {n_k1} {'ok' if ok_u else 'FAIL'}")
    if not ok_u or n_k1 != 1:
        raise AssertionError("fourd (d): ulysses disagrees with plain "
                             "attention or skipped K1")
    del q, k, v, o, want_o

    # (e) the twin as a user runs it: uninterrupted, then interrupted and
    # resumed from its snapshot, then --generate-tokens 16
    root = os.path.join(ROOT, "build", "fourd_twin")
    shutil.rmtree(root, ignore_errors=True)
    mid, end = FOURD_TWIN_STEPS

    def twin(*extra):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            loss, val = train_lm_4d.main(FOURD_TWIN + list(extra))
        text = buf.getvalue()
        with open(os.path.join(root, "twin.log"), "a") as f:
            f.write(text)
        return loss, val, text, time.perf_counter() - t0

    os.makedirs(root, exist_ok=True)
    kernels.reset_launches()
    la, va, _, sa = twin("--steps", str(end), "--out",
                         os.path.join(root, "a"))
    launches_twin = dict(kernels.LAUNCHES)
    twin("--steps", str(mid), "--out", os.path.join(root, "b"))
    lb, vb, text, sb = twin("--steps", str(end), "--out",
                            os.path.join(root, "b"), "--resume",
                            "--generate-tokens", "16")
    snap = [torch.load(os.path.join(root, r, "process_0",
                                    f"snapshot_{end}", "state.pt"),
                       weights_only=True) for r in ("a", "b")]
    same = [p for p, x in M._leaves(snap[0]) if isinstance(x, torch.Tensor)
            and torch.equal(x, dict(M._leaves(snap[1]))[p])]
    n_leaves = sum(isinstance(x, torch.Tensor) for _, x in
                   M._leaves(snap[0]))
    gen_line = [ln for ln in text.splitlines() if ln.startswith("generated:")]
    tokens = eval(gen_line[0].split(":", 1)[1]) if gen_line else []
    ok = (la == lb and len(same) == n_leaves and va == vb
          and f"resumed from snapshot at step {mid}" in text
          and len(tokens) == 8 + 16 and all(0 <= t < 256 for t in tokens))
    log(f"fourd (e) train_lm_4d twin --mesh 1,1,1,1 base widths vocab 256: "
        f"{end} steps in {sa:.1f}s (final loss {la!r}, launches {launches_twin})"
        f"; {mid} steps, then --resume to {end} in {sb:.1f}s (final loss "
        f"{lb!r}); final loss bitwise {la == lb}, snapshot leaves bitwise "
        f"{len(same)}/{n_leaves}, validation equal {va == vb}; generated "
        f"{tokens} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("fourd (e): the twin's resume is not bitwise or "
                             "its decode failed")
    log(f"fourd phase {time.perf_counter() - t_phase:.1f}s on {card}")
    return out


# ---------------------------------------------------------------------------
# phase 7j: the GSPMD rule sets (parallel/tensor.py, AutoSharded) over two
# gloo ranks on the one card
# ---------------------------------------------------------------------------

# (b), (c) the sequence, cut from the train phase's 4096 for the gloo host
# staging of every activation collective (16 MiB a psum at 8 x 1024 x 512
# f32, through the CPU)
GSPMD_SEQ = 1024
GSPMD_STEPS = 2                   # cut for the default run's time
# (a) new tokens a request (the serve phase's 32, cut for the default
# run's time: each is a gloo-staged decode step)
GSPMD_NEW_TOKENS = 16
GSPMD_TRAIN = (("tp", (1, 2)), ("tp_fsdp", (1, 2)), ("fsdp", (2, 1)))
# (b), (c) bf16 trajectories against the single-device step: the sharded
# step sums each row-parallel product's bf16 partials in f32 where the
# single-device product rounds once, and combines the vocab-parallel
# head's logsumexp from two f32 halves: rounding of the size fourd's
# bf16 bound holds
GSPMD_LOSS_TOL = FOURD_TOL["bf16_loss"]
# (d) AutoSharded PyramidNet-110 f32, one SGD step, against the
# single-device step at the same global batch: the statistics come from
# E[x^2] - E[x]^2 over the whole batch (flax's formula) where the
# single-device kernel takes the variance about the mean (Welford), an
# f32 rounding of ~1e-7 relative a layer over 110 layers; the bounds are
# absolute, on the loss, every parameter and every BatchNorm statistic
GSPMD_AUTO_TOL = dict(loss=1e-4, param=1e-4, stats=1e-4)
GSPMD_AUTO_BATCH = 64
# (e) in the worker's world of two, as a user calls its main
GSPMD_TWIN = ["--model-size", "base", "--seq-len", str(GSPMD_SEQ),
              "--batch-size", "8", "--steps", "4", "--log-interval", "1",
              "--eval-batches", "1"]
GSPMD_TWINS = {"tp": ["--rules", "tp", "--mesh", "1,2"],
               "ep": ["--rules", "ep", "--mesh", "1,2", "--n-experts", "4"]}


def gspmd_serve(torch, seed, rank, mesh):
    """(a) the base engine (bf16, page 16, 8 slots) tensor-parallel over
    'model' and, on rank 0, the single-placement engine in turn, with
    bf16 and int8 weights."""
    from dtdl_tpu_torch import kernels
    from dtdl_tpu_torch.models.transformer import transformer_lm
    from dtdl_tpu_torch.parallel.collectives import tree_digest
    host = transformer_lm("base", seed=seed, dtype=torch.bfloat16,
                          device="cpu")
    traffic = make_traffic(seed, host.cfg.vocab_size,
                           new_tokens=GSPMD_NEW_TOKENS)
    out = {}
    for label, kw in (("bf16", {}), ("int8", {"quantize_weights": True})):
        serve(torch, host, traffic[:2], mesh=mesh, rules="tp", **kw)
        sync(torch)
        kernels.reset_launches()
        eng, sched, reqs, wall = serve(torch, host, traffic, mesh=mesh,
                                       rules="tp", **kw)
        k4 = kernels.LAUNCHES["paged_attention"]
        kv = [v for blk in sched.arena.values() if isinstance(blk, dict)
              for v in blk["attn"].values()]
        n_tok = sum(len(r.tokens) for r in reqs)
        r = {"k4": k4, "n_layers": host.cfg.n_layers,
             "pool_heads": sched.arena["block_0"]["attn"]["pages_key"]
             .shape[1], "heads": host.cfg.n_heads,
             "kv_bytes": sum(v.numel() * v.element_size() for v in kv),
             "tokens_per_s": n_tok / wall, "wall_s": wall,
             "digest": tree_digest([x.tokens for x in reqs]),
             "done": all(x.done and not x.error
                         and len(x.tokens) == GSPMD_NEW_TOKENS
                         for x in reqs)}
        if rank == 0:
            model = transformer_lm("base", seed=seed, dtype=torch.bfloat16,
                                   device=DEV)
            serve(torch, model, traffic[:2], **kw)
            _, one, plain, wall1 = serve(torch, model, traffic, **kw)
            scale = float(prefill_logits(torch, model, traffic[0][0],
                                         **kw).abs().max())
            tau = 2 * SPEC_DELTA_ULPS * 2.0 ** (math.floor(math.log2(scale))
                                                - 7)
            parts = near_tie_divergences(torch, model, plain, reqs, tau, **kw)
            r.update(single_tokens_per_s=n_tok / wall1, tau=tau,
                     partings=parts, identical=len(reqs) - len(parts),
                     single_kv_bytes=sum(
                         v.numel() * v.element_size()
                         for blk in one.arena.values()
                         if isinstance(blk, dict)
                         for v in blk["attn"].values()))
            del model, one, plain
        out[label] = r
        del eng, sched
        torch.cuda.empty_cache()
    return out


def gspmd_train_run(torch, mesh, rules, host, toks, label):
    """One sharded trajectory: losses, launches of the timed steps (all
    but the first), ms a step."""
    from dtdl_tpu_torch import kernels
    from dtdl_tpu_torch.parallel import tensor as T
    from dtdl_tpu_torch.runtime.mesh import batch_sharded
    from dtdl_tpu_torch.train.optim import adamw
    params, opt, sh = T.init_sharded_lm(host, mesh, adamw(3e-4),
                                        rules=rules, device=DEV)
    step = T.make_sharded_lm_train_step(host, mesh, None, sh, rules)
    losses = []
    for i, t in enumerate(toks):
        if i == 1:
            sync(torch)
            kernels.reset_launches()
            t0 = time.perf_counter()
        params, opt, loss = step(params, opt,
                                 batch_sharded(mesh, t, device=DEV))
        losses.append(float(loss))
    sync(torch)
    n = len(toks) - 1
    out = {"losses": losses, "ms": 1e3 * (time.perf_counter() - t0) / n,
           "launches": {k: v / n for k, v in kernels.LAUNCHES.items()},
           "heads": host.cfg.n_heads // params.shard.heads_split,
           "remat": params.cfg.remat, "mesh": list(mesh.dims)}
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"gspmd {label}: non-finite loss {losses}")
    del params, opt
    torch.cuda.empty_cache()
    return out


def gspmd_single(torch, model, toks, **step_kw):
    """The single-device make_lm_train_step's losses on ``toks``."""
    from dtdl_tpu_torch.train.optim import adamw
    from dtdl_tpu_torch.train.state import init_state
    from dtdl_tpu_torch.train.step import make_lm_train_step
    state = init_state(model, None, adamw(3e-4), device=DEV)
    step = make_lm_train_step(**step_kw)
    losses = []
    for t in toks:
        state, m = step(state, {"tokens": t})
        losses.append(float(m["loss"]))
    del state
    return losses


def gspmd_auto(torch, seed, rank, mesh):
    """(d) PyramidNet-110 f32 at a global batch of 64: one SGD step under
    AutoSharded (global-batch BatchNorm) and under DataParallel
    (per-replica BatchNorm), and on rank 0 the single-device step."""
    import numpy as np
    from dtdl_tpu_torch.bridge import flatten, state_dict_to_flax
    from dtdl_tpu_torch.parallel import AutoSharded, DataParallel
    from dtdl_tpu_torch.runtime.mesh import batch_sharded
    from dtdl_tpu_torch.train.optim import sgd
    from dtdl_tpu_torch.train.state import init_state
    from dtdl_tpu_torch.train.step import make_train_step
    rng = np.random.default_rng(seed)
    batch = {"image": rng.normal(size=(GSPMD_AUTO_BATCH, 32, 32, 3))
             .astype(np.float32),
             "label": rng.integers(0, 10, GSPMD_AUTO_BATCH)}

    def run(strategy):
        model = classifier("pyramidnet", dtype=torch.float32, device=DEV,
                           seed=seed)
        state = init_state(model, None, sgd(0.1, momentum=0.9), device=DEV)
        b = batch
        if strategy is not None:
            state = strategy.replicate(state)
            b = {k: batch_sharded(mesh, v, device=DEV) for k, v in b.items()}
        sync(torch)
        t0 = time.perf_counter()
        state, m = make_train_step(strategy)(state, b)
        loss = float(m["loss"])
        ms = 1e3 * (time.perf_counter() - t0)
        return (loss, flatten(state_dict_to_flax(model)),
                flatten(state_dict_to_flax(model, "batch_stats")), ms)

    out = {}
    got = {"auto": run(AutoSharded(mesh)), "dp": run(DataParallel(mesh))}
    if rank == 0:
        want = run(None)
        for k, (loss, params, stats, ms) in got.items():
            out[k] = {"loss_err": abs(loss - want[0]), "ms": ms,
                      "param_err": max(float(np.abs(params[p] - want[1][p])
                                             .max()) for p in want[1]),
                      "stats_err": max(float(np.abs(stats[p] - want[2][p])
                                             .max()) for p in want[2])}
        out["single_ms"] = want[3]
    torch.cuda.empty_cache()
    return out


def gspmd_twin(seed, rank):
    """(e) the train_lm_gspmd twin's main in this world, as a user calls
    it: {label: (its last line on the leader, seconds)}; its output in
    build/ddp/gspmd_twin_<label>_<rank>.log."""
    import contextlib
    import io

    from dtdl_tpu_torch.examples import train_lm_gspmd
    out = {}
    for label, extra in GSPMD_TWINS.items():
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            train_lm_gspmd.main(GSPMD_TWIN + extra + ["--seed", str(seed)])
        text = buf.getvalue()
        # the phase may run before any other has made build/ddp
        os.makedirs(os.path.join(ROOT, "build", "ddp"), exist_ok=True)
        with open(os.path.join(ROOT, "build", "ddp",
                               f"gspmd_twin_{label}_{rank}.log"), "w") as f:
            f.write(text)
        last = [ln for ln in text.splitlines() if ln.startswith("final loss")]
        out[label] = (last[0] if last else None, time.perf_counter() - t0)
    return out


def gspmd_lora(torch, seed, rank, mesh):
    """(f) the tenant phase's rank-16 bank (4 rows, five adapters in two
    waves) on the base engine (bf16, page 16, 8 slots) tensor-parallel
    over 'model': each rank holds its heads' rows of the head leaves;
    rank 0 also serves the traffic on the single-placement LoRA engine
    and holds the TP tokens to it (near-tie rule, per tenant's merged
    model)."""
    from dtdl_tpu_torch import kernels
    from dtdl_tpu_torch.models.transformer import transformer_lm
    from dtdl_tpu_torch.parallel.collectives import tree_digest
    from dtdl_tpu_torch.serve import InferenceEngine, merge_adapter
    from dtdl_tpu_torch.serve.tenant import bank_nbytes
    host = transformer_lm("base", seed=seed, dtype=torch.bfloat16,
                          device="cpu")
    traffic = make_traffic(seed, host.cfg.vocab_size,
                           new_tokens=GSPMD_NEW_TOKENS)
    tenants, waves = tenant_waves(len(traffic))
    # the tenant phase's calibrated adapters; save_weights is collective
    # (the leader writes, every rank returns after the write), so every
    # rank calibrates and the files are the leader's.  An adapter file is
    # whole-heads whatever the TP size
    model = transformer_lm("base", seed=seed, dtype=torch.bfloat16,
                           device=DEV)
    adapters, _ = tenant_adapters(torch, model, seed, traffic[1][0][:512],
                                  traffic[3][0][:512], "adapters_tp")
    if rank != 0:
        model = None
    kw = dict(n_slots=8, page_size=16, device=DEV, lora_rank=TENANT_RANK,
              lora_adapters=TENANT_ROWS)

    def head_bytes(eng):
        return sum(bank_nbytes(sub["attn"][n])
                   for sub in eng.adapter_bank.bank.values()
                   for n in ("q_b", "k_b", "v_b", "out_a"))
    eng = InferenceEngine(host, mesh=mesh, rules="tp", **kw)
    tenant_serve(torch, eng, traffic[:2], tenants, [[0, 1]], adapters)
    sync(torch)
    kernels.reset_launches()
    reqs, _, wall = tenant_serve(torch, eng, traffic, tenants, waves,
                                 adapters)
    tenant_streams_ok("gspmd (f)", reqs)
    n_tok = sum(len(r.tokens) for r in reqs)
    bank = eng.adapter_bank
    r = {"k4": kernels.LAUNCHES["paged_attention"],
         "n_layers": host.cfg.n_layers, "head_bytes": head_bytes(eng),
         "bank_bytes": eng.compile_stats()["lora"]["bank_bytes"],
         "loads": bank.n_loads, "evictions": bank.n_evictions,
         "tokens_per_s": n_tok / wall,
         "digest": tree_digest([x.tokens for x in reqs]),
         "done": all(len(x.tokens) == GSPMD_NEW_TOKENS for x in reqs)}
    del eng, bank
    if rank == 0:
        one = InferenceEngine(model, **kw)
        tenant_serve(torch, one, traffic[:2], tenants, [[0, 1]], adapters)
        single, _, wall1 = tenant_serve(torch, one, traffic, tenants, waves,
                                        adapters)
        tau = fleet_tau(torch, model, traffic[0][0])
        parts = []
        for tenant in (None,) + TENANT_NAMES:
            idx = [i for i, t in enumerate(tenants) if t == tenant]
            m = (model if tenant is None
                 else merge_adapter(model, adapters[tenant][1]))
            parts += near_tie_divergences(torch, m, [single[i] for i in idx],
                                          [reqs[i] for i in idx], tau)
            del m
        r.update(single_head_bytes=head_bytes(one),
                 single_tokens_per_s=n_tok / wall1, tau=tau,
                 partings=parts, identical=len(reqs) - len(parts))
        del one, model
    torch.cuda.empty_cache()
    return r


def gspmd_handoff(torch, seed, rank, mesh):
    """(g) the TP handoff on the base engine (bf16, page 16, 8 slots):
    one prompt's whole-heads payload against this rank's pool pages, then
    the traffic through a prefill_only Scheduler and a kv_inject
    Scheduler over the TP engine against the same engine
    undisaggregated."""
    import numpy as np
    from dtdl_tpu_torch import kernels
    from dtdl_tpu_torch.models.transformer import transformer_lm
    from dtdl_tpu_torch.parallel.collectives import tree_digest
    from dtdl_tpu_torch.serve import InferenceEngine, Request, Scheduler
    host = transformer_lm("base", seed=seed, dtype=torch.bfloat16,
                          device="cpu")
    traffic = make_traffic(seed, host.cfg.vocab_size,
                           new_tokens=GSPMD_NEW_TOKENS)
    eng = InferenceEngine(host, n_slots=8, page_size=16, device=DEV,
                          mesh=mesh, rules="tp")
    prompt = traffic[0][0]
    n_pg = -(-len(prompt) // eng.page_size)
    ids = list(range(1, n_pg + 1))
    row = np.zeros(eng.n_ptab, np.int32)
    row[:n_pg] = ids
    arena, _, _ = eng.prefill(eng.init_arena(), eng.init_last_tokens(), 0,
                              prompt, page_row=row)
    data = eng.extract_pages(arena, ids)
    per = eng.model.kv_heads
    c = mesh.axis_index("model")
    heads, cut = set(), True
    for path, pool in eng._pool_leaves(arena):
        leaf = data
        for k in path:
            leaf = leaf[k]
        heads.add(leaf.shape[1])
        mine = eng._bits_view(pool)[1:n_pg + 1].cpu().numpy()
        cut &= bool(np.array_equal(leaf[:, c * per:(c + 1) * per],
                                   mine.view(leaf.dtype)))
    del arena, data

    def run(reqs, **sched_kw):
        s = Scheduler(eng, harvest_lag=4, device=DEV, **sched_kw)
        sync(torch)
        t0 = time.perf_counter()
        s.run(reqs)
        sync(torch)
        return s, time.perf_counter() - t0
    run([Request(p, m) for p, m in traffic[:2]])          # warm-up
    plain = [Request(p, m) for p, m in traffic]
    run(plain)
    kernels.reset_launches()
    pre = [Request(p, m, prefill_only=True) for p, m in traffic]
    ps, pre_s = run(pre)
    k4_pre = kernels.LAUNCHES["paged_attention"]
    dec = []
    for r0 in pre:
        r = Request(list(r0.prompt), r0.max_new_tokens,
                    kv_inject=r0.kv_handoff)
        r.tokens = [r0.kv_handoff["first_token"]]
        dec.append(r)
    ds, dec_s = run(dec)
    k4_dec = kernels.LAUNCHES["paged_attention"] - k4_pre
    sp, sd = ps.metrics.summary(), ds.metrics.summary()
    out = {"heads": sorted(heads), "n_heads": host.cfg.n_heads,
           "cut_bitwise": cut, "k4_prefill": k4_pre, "k4_decode": k4_dec,
           "n_layers": host.cfg.n_layers,
           "errors": [r.error for r in pre + dec if r.error],
           "identical": sum(a.tokens == b.tokens for a, b in zip(plain, dec)),
           "digest": tree_digest([r.tokens for r in dec]),
           "handoff_s": {k: (s.get("kv_handoff_s_p50"),
                             s.get("kv_handoff_s_max"),
                             s.get("kv_handoff_pages"))
                         for k, s in (("extract", sp), ("inject", sd))},
           "prefill_s": pre_s, "decode_s": dec_s}
    del eng
    torch.cuda.empty_cache()
    return out


# (h) the Router over TP replicas: the serve cell's traffic (32 new tokens
# a request), prefix cache off as the fleet phase's (a)-(c)
GSPMD_FLEET_NEW_TOKENS = 32


def gspmd_fleet_run(torch, engines, traffic, **router_kw):
    """The traffic through a Router over ``engines`` that every rank builds
    (rank 0's the front door, rank 1's replaying it): (requests, router,
    summary, wall s, K4 launches by replica on this rank).  The counts
    are reset before the Router starts its threads (rank 1's follower may
    replay the first record at once); its warm-up runs on the calling
    thread, which ``fleet_k4`` does not read."""
    from dtdl_tpu_torch import kernels
    from dtdl_tpu_torch.serve.fleet import Router
    kernels.reset_launches()
    router = Router(engines, device=DEV, sched_kwargs={
        "harvest_lag": 4, "prefix_cache": False},
        **{**FLEET_KNOBS, **router_kw})
    with router:
        sync(torch)
        t0 = time.perf_counter()
        reqs = router.run(fleet_requests(traffic), timeout_s=600)
        sync(torch)
        wall = time.perf_counter() - t0
    s = router.summary()
    if not s["fleet_accounting_ok"] or router.pump_error is not None:
        raise AssertionError(f"gspmd (h): accounting broken or pump failed: "
                             f"{router.pump_error}")
    return reqs, router, s, wall, fleet_k4(len(router.replicas))


def gspmd_fleet(torch, seed, rank, mesh):
    """(h) the Router over tensor-parallel replicas on the base engine
    (bf16, page 16, 8 slots, rules tp over 'model'): (h1) two replicas
    sharing the TP engine, (h2) the same under a loop-site and an
    engine-site raise with auto_restart, (h3) a TP prefill replica and a
    single-placement decode replica on rank 0.  Rank 0 also serves the
    traffic through a single-placement Router and holds (h1) to it, and
    (h3) to (h1), by the near-tie rule; (h2) is held to (h1) exactly."""
    from dtdl_tpu_torch.models.transformer import transformer_lm
    from dtdl_tpu_torch.parallel.collectives import tree_digest
    from dtdl_tpu_torch.resil.faults import FaultPlan, replica_site
    from dtdl_tpu_torch.serve import InferenceEngine
    host = transformer_lm("base", seed=seed, dtype=torch.bfloat16,
                          device="cpu")
    traffic = make_traffic(seed, host.cfg.vocab_size,
                           new_tokens=GSPMD_FLEET_NEW_TOKENS)
    n_tok = sum(m for _, m in traffic)
    kw = dict(n_slots=8, page_size=16, device=DEV)
    eng = InferenceEngine(host, mesh=mesh, rules="tp", **kw)
    model = single = None
    out, secs = {"n_layers": host.cfg.n_layers}, {}

    def part(label, reqs, router, s, wall, k4, t0):
        secs[label] = round(time.perf_counter() - t0, 1)
        out[label] = {
            "k4": k4, "tokens_per_s": n_tok / wall, "wall_s": wall,
            "digest": tree_digest([r.tokens for r in reqs]),
            "lost": [i for i, r in enumerate(reqs)
                     if not r.done or r.error],
            "submitted": s["fleet_requests_submitted"],
            "finished": s["fleet_requests_finished"],
            "leader": router.is_leader}
        if router.is_leader:
            out[label].update(
                served=sorted({e[1] for e in router.dispatch_log}),
                evictions=s["fleet_evictions"], restarts=s["fleet_restarts"],
                retries=s["fleet_retries"], health=s["replica_health"],
                recovery_s=[fleet_recovery_s(router, i)
                            for i in range(len(router.replicas))],
                migrations=s["fleet_migrations"],
                handoff_pages=s["fleet_kv_handoff_pages"],
                handoff_s=[(r.get("kv_handoff_s_p50"),
                            r.get("kv_handoff_s_max"))
                           for r in s["replicas"]],
                records=s.get("control_records"))
        return reqs

    t0 = time.perf_counter()
    if rank == 0:
        # the reference: a single-placement Router (two replicas)
        model = transformer_lm("base", seed=seed, dtype=torch.bfloat16,
                               device=DEV)
        single = InferenceEngine(model, **kw)
        ref, _, _, ref_wall, _ = gspmd_fleet_run(torch, single, traffic,
                                                 n_replicas=2)
        out["single_tokens_per_s"] = n_tok / ref_wall
    secs["reference"] = round(time.perf_counter() - t0, 1)
    t0 = time.perf_counter()
    h1 = part("h1", *gspmd_fleet_run(torch, eng, traffic, n_replicas=2),
              t0)
    t0 = time.perf_counter()
    plan = (FaultPlan().at(replica_site(0, "loop"), 5)
            .at(replica_site(1, "engine"), 20))
    h2 = part("h2", *gspmd_fleet_run(torch, eng, traffic, n_replicas=2,
                                     plan=plan), t0)
    if rank == 0:
        out["h2"]["fired"] = [site for site, _, _ in plan.log]
    t0 = time.perf_counter()
    h3 = part("h3", *gspmd_fleet_run(
        torch, [eng, single], traffic, roles=["prefill", "decode"]), t0)
    if rank == 0:
        tau = fleet_tau(torch, model, traffic[0][0])
        out.update(tau=tau,
                   h1_partings=near_tie_divergences(torch, model, ref, h1,
                                                    tau),
                   h2_identical=sum(a.tokens == b.tokens
                                    for a, b in zip(h1, h2)),
                   h3_partings=near_tie_divergences(torch, model, h1, h3,
                                                    tau))
    out["seconds"] = secs
    del eng, model, single
    torch.cuda.empty_cache()
    return out


def gspmd_worker(torch, seed):
    """Each of two gloo ranks on the one card: (a) TP serving, (f) TP
    LoRA, (g) the TP handoff, (h) the Router over TP replicas, (b) the
    sharded LM steps, (c) ep on
    base-moe8, (d) AutoSharded, (e) the twin; rank 0 also runs the
    single-placement references and compares."""
    from dtdl_tpu_torch.data.synthetic import markov_tokens
    from dtdl_tpu_torch.models.transformer import transformer_lm
    from dtdl_tpu_torch.runtime import build_mesh, process_index
    rank = process_index()
    secs = {}
    t0 = time.perf_counter()
    tp = build_mesh((1, 2), ("data", "model"))
    out = {"serve": gspmd_serve(torch, seed, rank, tp)}
    secs["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["lora"] = gspmd_lora(torch, seed, rank, tp)
    secs["f"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["handoff"] = gspmd_handoff(torch, seed, rank, tp)
    secs["g"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["fleet"] = gspmd_fleet(torch, seed, rank, tp)
    secs["h"] = time.perf_counter() - t0
    toks = list(markov_tokens(GSPMD_STEPS * TRAIN_BATCH, GSPMD_SEQ + 1,
                              32000, seed=seed + 3).reshape(
        GSPMD_STEPS, TRAIN_BATCH, GSPMD_SEQ + 1))
    out["train"] = {}
    t0 = time.perf_counter()
    for rules, shape in GSPMD_TRAIN:
        host = transformer_lm("base", max_seq=GSPMD_SEQ, seed=seed,
                              device="cpu")
        out["train"][rules] = gspmd_train_run(
            torch, build_mesh(shape, ("data", "model")), rules, host, toks,
            rules)
    moe = dict(max_seq=GSPMD_SEQ, seed=seed, capacity_factor=8.0)
    out["ep"] = gspmd_train_run(
        torch, build_mesh((1, 2), ("data", "model")), "ep",
        transformer_lm("base-moe8", device="cpu", **moe), toks, "ep")
    secs["b, c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if rank == 0:
        out["single"] = gspmd_single(
            torch, transformer_lm("base", max_seq=GSPMD_SEQ, seed=seed,
                                  device=DEV), toks)
        out["single_moe"] = gspmd_single(
            torch, transformer_lm("base-moe8", device=DEV, **moe), toks,
            moe_aux_weight=0.0)
        torch.cuda.empty_cache()
    secs["references"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["auto"] = gspmd_auto(torch, seed, rank, build_mesh())
    secs["d"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["twin"] = gspmd_twin(seed, rank)
    secs["e"] = time.perf_counter() - t0
    out["seconds"] = {k: round(v, 1) for k, v in secs.items()}
    return out


def phase_gspmd(torch, seed, card):
    """The GSPMD face over two gloo ranks on the one card (this script's
    --ddp-worker gspmd through the launcher, one world for every part):
    (a) tensor-parallel serving
    through K4 on head-sharded pools, bf16 and int8, against the
    single-placement engine; (b) tp, tp_fsdp and fsdp LM steps through
    K1-K3 against the single-device step; (c) ep on base-moe8; (d)
    AutoSharded's global-batch BatchNorm against the single-device step,
    DataParallel's per-replica one beside it; (e) the train_lm_gspmd
    twin's main with --rules tp and --rules ep in that world; (f) the
    tenant phase's LoRA bank on the TP engine against the
    single-placement LoRA engine; (g) the TP handoff (whole-heads
    payloads) through prefill_only and kv_inject Schedulers against the
    TP engine undisaggregated; (h) the Router over TP replicas (rank 0 its
    front door, rank 1 replaying it).  Returns (h)'s K4 launches by part,
    rank and replica."""
    t_phase = time.perf_counter()
    # rank 1 waits in its next collective while rank 0 runs the
    # references: the worker's gloo timeout is 600 s
    rc, out, worker_s = launch([os.path.join(ROOT, "chip_smoke.py"),
                                "--ddp-worker", "gspmd", "--seed",
                                str(seed)], 2, 900, "gspmd")
    got = launched_ok(rc, out, "gspmd", 2)
    r0, r1 = got[0], got[1]
    fails = []
    for label in ("bf16", "int8"):
        a = [r[label] for r in (r0["serve"], r1["serve"])]
        x = a[0]
        ok = (all(r["done"] and r["k4"] > 0 and r["k4"] % r["n_layers"] == 0
                  and r["pool_heads"] * 2 == r["heads"] for r in a)
              and a[0]["digest"] == a[1]["digest"]
              and 2 * a[0]["kv_bytes"] == x["single_kv_bytes"])
        log(f"gspmd (a) TP serving base {label} weights, page 16, 8 slots, "
            f"rules tp mesh (data 1, model 2), two gloo ranks on the card: "
            f"K4 launches per rank {[r['k4'] for r in a]} ({a[0]['k4'] // x['n_layers']} "
            f"attends x {x['n_layers']} layers) over pools of "
            f"{x['pool_heads']} of {x['heads']} heads; KV bytes per rank "
            f"{[r['kv_bytes'] for r in a]} vs the single engine's "
            f"{x['single_kv_bytes']}; tokens_per_s per rank "
            f"{[round(r['tokens_per_s'], 2) for r in a]} (gloo-staged "
            f"collectives) vs single {x['single_tokens_per_s']:.2f}; ranks "
            f"token-identical {a[0]['digest'] == a[1]['digest']}; tokens "
            f"identical to the single engine {x['identical']}/16, near-tie "
            f"partings (position, top-two gap) {x['partings']} (tau "
            f"{x['tau']:.4e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fails.append(f"(a) {label}")
    a = [r0["lora"], r1["lora"]]
    x = a[0]
    ok = (all(r["done"] and r["k4"] > 0 and r["k4"] % r["n_layers"] == 0
              and r["evictions"] >= 2 for r in a)
          and a[0]["digest"] == a[1]["digest"]
          and all(2 * r["head_bytes"] == x["single_head_bytes"] for r in a))
    log(f"gspmd (f) TP LoRA base bf16, page 16, 8 slots, rules tp mesh "
        f"(data 1, model 2), two gloo ranks on the card, rank "
        f"{TENANT_RANK} bank of {TENANT_ROWS} rows ({x['bank_bytes']} bytes "
        f"whole), tenants [base, A-E] over the 16 requests in two waves: "
        f"K4 launches per rank {[r['k4'] for r in a]}; head-leaf bank bytes "
        f"per rank {[r['head_bytes'] for r in a]} vs the single engine's "
        f"{x['single_head_bytes']}; bank loads/evictions per rank "
        f"{[(r['loads'], r['evictions']) for r in a]}; tokens_per_s per "
        f"rank {[round(r['tokens_per_s'], 2) for r in a]} vs single "
        f"{x['single_tokens_per_s']:.2f}; ranks token-identical "
        f"{a[0]['digest'] == a[1]['digest']}; tokens identical to the "
        f"single LoRA engine {x['identical']}/16, near-tie partings "
        f"(position, top-two gap) {x['partings']} (tau {x['tau']:.4e}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fails.append("(f)")
    a = [r0["handoff"], r1["handoff"]]
    x = a[0]
    ok = (all(not r["errors"] and r["cut_bitwise"]
              and r["heads"] == [r["n_heads"]] and r["identical"] == 16
              and r["k4_prefill"] > 0 and r["k4_decode"] > 0
              and r["k4_prefill"] % r["n_layers"] == 0 for r in a)
          and a[0]["digest"] == a[1]["digest"])
    log(f"gspmd (g) TP handoff base bf16, page 16, 8 slots, rules tp mesh "
        f"(data 1, model 2): a prefill_only and a kv_inject Scheduler on "
        f"each rank over the 16 requests; payload leaves of "
        f"{x['heads']} heads (every head), each rank's cut bitwise its "
        f"pool pages {[r['cut_bitwise'] for r in a]}; tokens identical to "
        f"the same TP engine undisaggregated {[r['identical'] for r in a]}"
        f"/16, ranks identical {a[0]['digest'] == a[1]['digest']}; "
        f"kv_handoff_s (p50, max, pages) per rank "
        f"{[r['handoff_s'] for r in a]}; K4 launches per rank prefill "
        f"{[r['k4_prefill'] for r in a]} decode "
        f"{[r['k4_decode'] for r in a]}; prefill/decode s "
        f"{round(x['prefill_s'], 2)}/{round(x['decode_s'], 2)} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fails.append("(g)")
    a = [r0["fleet"], r1["fleet"]]
    f0 = a[0]
    nl = f0["n_layers"]
    fleet_k4s = {}
    for label in ("h1", "h2", "h3"):
        x, y = a[0][label], a[1][label]
        fleet_k4s[label] = [x["k4"], y["k4"]]
        held = [n for r in (x, y) for n in r["k4"] if n]
        ok = (not x["lost"] and not y["lost"] and x["digest"] == y["digest"]
              and x["submitted"] == x["finished"] == 16
              and y["submitted"] == y["finished"] == 16
              and held and all(n % nl == 0 for n in held)
              and x["leader"] and not y["leader"])
        if label == "h1":
            # the follower replays every engine call of both replicas
            ok = ok and x["served"] == [0, 1] and x["k4"] == y["k4"] \
                and min(x["k4"]) > 0
            what = ("(h1) Router(tp_engine, n_replicas=2): tokens against "
                    f"a single-placement Router on rank 0: "
                    f"{16 - len(f0['h1_partings'])}/16 identical, near-tie "
                    f"partings (position, top-two gap) "
                    f"{f0['h1_partings']} (tau {f0['tau']:.4e}); "
                    f"single tokens_per_s "
                    f"{f0['single_tokens_per_s']:.2f}")
        elif label == "h2":
            ok = ok and f0["h2_identical"] == 16 and x["evictions"] >= 1 \
                and x["restarts"] >= x["evictions"] \
                and x["health"] == ["healthy", "healthy"] \
                and len(x["fired"]) == 2
            what = (f"(h2) the same under replica 0's worker killed at loop "
                    f"iteration 5 and replica 1's engine raising at its "
                    f"call 20 (fired {x['fired']}), auto_restart: lost "
                    f"{[len(r['lost']) for r in (x, y)]}, tokens identical "
                    f"to (h1) {f0['h2_identical']}/16, evictions "
                    f"{x['evictions']} restarts {x['restarts']} retries "
                    f"{x['retries']}, seconds from fault to HEALTHY by "
                    f"replica {x['recovery_s']}, health {x['health']}")
        else:
            ok = ok and x["migrations"] == 16 and x["handoff_pages"] > 0 \
                and y["k4"][1] == 0 and x["k4"][0] == y["k4"][0]
            what = (f"(h3) a TP prefill replica and a single-placement "
                    f"decode replica on rank 0: tokens against (h1) "
                    f"{16 - len(f0['h3_partings'])}/16 identical, near-tie "
                    f"partings {f0['h3_partings']}; migrations "
                    f"{x['migrations']}, handoff pages {x['handoff_pages']}, "
                    f"kv_handoff_s (p50, max) extract/inject "
                    f"{x['handoff_s']}")
        log(f"gspmd {what}; both ranks' tokens identical "
            f"{x['digest'] == y['digest']}, each user request counted once "
            f"(submitted/finished per rank "
            f"{[(r['submitted'], r['finished']) for r in (x, y)]}); K4 "
            f"launches by replica per rank {fleet_k4s[label]}; tokens_per_s "
            f"per rank {[round(r['tokens_per_s'], 2) for r in (x, y)]} "
            f"(gloo-staged); control records {x['records']}; seconds per "
            f"rank {[r['seconds'].get(label) for r in a]} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fails.append(f"({label[0]}{label[1]})")
    single = r0["single"]
    for rules, _ in GSPMD_TRAIN + (("ep", None),):
        a = [r["train"][rules] if rules != "ep" else r["ep"]
             for r in (r0, r1)]
        want = single if rules != "ep" else r0["single_moe"]
        d = max(abs(x - y) for x, y in zip(a[0]["losses"], want))
        k = a[0]["launches"]
        ok = (d <= GSPMD_LOSS_TOL and a[0]["losses"] == a[1]["losses"]
              and all(r["launches"].get(n, 0) > 0 for r in a
                      for n in ("flash_fwd", "flash_bwd_dq",
                                "flash_bwd_dkv")))
        what = "(c) ep base-moe8 (8 experts, 4 a rank, capacity 8: none " \
            "drops)" if rules == "ep" else f"(b) {rules}"
        log(f"gspmd {what} mesh (data, model) {tuple(a[0]['mesh'])} base "
            f"widths bf16 (f32 weights) adamw(3e-4) {TRAIN_BATCH}x"
            f"{GSPMD_SEQ} (seq cut from {TRAIN_SEQ} for the gloo staging), "
            f"{a[0]['heads']} heads a rank, remat {a[0]['remat']}: losses "
            f"{[round(x, 5) for x in a[0]['losses']]} vs single-device "
            f"{[round(x, 5) for x in want]} max |d|={d:.3e} (tol "
            f"{GSPMD_LOSS_TOL}); launches per step per rank "
            f"{[{n: r['launches'].get(n, 0) for n in ('flash_fwd', 'flash_bwd_dq', 'flash_bwd_dkv', 'rope_rows')} for r in a]}; "
            f"ms per step (gloo-staged) {[round(r['ms'], 2) for r in a]} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fails.append(what)
    auto, dp = r0["auto"]["auto"], r0["auto"]["dp"]
    ok = (auto["loss_err"] <= GSPMD_AUTO_TOL["loss"]
          and auto["param_err"] <= GSPMD_AUTO_TOL["param"]
          and auto["stats_err"] <= GSPMD_AUTO_TOL["stats"]
          and dp["stats_err"] > auto["stats_err"])
    log(f"gspmd (d) AutoSharded PyramidNet-110 f32 global batch "
        f"{GSPMD_AUTO_BATCH} over two gloo ranks, one sgd(0.1, 0.9) step "
        f"vs the single-device step at {GSPMD_AUTO_BATCH}: |d loss| "
        f"{auto['loss_err']:.3e}, max |d param| {auto['param_err']:.3e}, "
        f"max |d BN statistic| {auto['stats_err']:.3e} (tol "
        f"{GSPMD_AUTO_TOL}); DataParallel (per-replica BatchNorm): |d loss| "
        f"{dp['loss_err']:.3e}, max |d param| {dp['param_err']:.3e}, max "
        f"|d BN statistic| {dp['stats_err']:.3e}; step ms auto "
        f"{auto['ms']:.1f} dp {dp['ms']:.1f} single "
        f"{r0['auto']['single_ms']:.1f} (first steps, cuDNN warm-up "
        f"included) {'ok' if ok else 'FAIL'}")
    if not ok:
        fails.append("(d)")
    for label, extra in GSPMD_TWINS.items():
        last, secs = r0["twin"][label]
        ok = (last is not None and math.isfinite(float(last.split()[2]))
              and r1["twin"][label][0] is None)   # the leader's line only
        log(f"gspmd (e) train_lm_gspmd twin {' '.join(extra)} base widths "
            f"vocab 256, main() in the two gloo ranks' world: {secs:.1f}s, "
            f"last line {last!r} {'ok' if ok else 'FAIL'}")
        if not ok:
            fails.append(f"(e) {label}")
    log(f"gspmd phase {time.perf_counter() - t_phase:.1f}s (worker "
        f"{worker_s:.1f}s, its parts on rank 0 {r0['seconds']}, (h)'s "
        f"{r0['fleet']['seconds']}) on {card}")
    if fails:
        raise AssertionError(f"gspmd: {fails} failed")
    return fleet_k4s


# ---------------------------------------------------------------------------
# phase 7k: the serving fleet and the KV tiers
# ---------------------------------------------------------------------------

FLEET_REPLICAS = 3
FLEET_CHUNK = 256                 # (d)'s chunk budget
FLEET_CUT_PAGES = 201             # (e)'s pool: 200 usable pages of 16
FLEET_DISK_BYTES = 1 << 30
FLEET_TWIN = ["--model-size", "base", "--disagg", "--kill-replica-after",
              "5"]
# the Router's knobs of the fleet phase, kept at its 2 s watchdog so that
# its records ((b)'s seconds from a fault to HEALTHY) compare with PRs
# 14-15; the fleet at the twin's default of 0.25 s is held by the obs
# phase's (c) and (d) and the tenant phase's fleet twin (ROADMAP C7)
FLEET_KNOBS = dict(probe_interval_s=0.02, watchdog_s=2.0, retry_budget=3)


def fleet_requests(traffic):
    from dtdl_tpu_torch.serve.scheduler import Request
    return [Request(list(p), m) for p, m in traffic]


def fleet_single(torch, eng, traffic, **sched_kw):
    """The traffic through one Scheduler (harvest lag 4) on ``eng``:
    (requests, scheduler, wall s)."""
    from dtdl_tpu_torch.serve.scheduler import Scheduler
    sched = Scheduler(eng, harvest_lag=4, device=DEV, **sched_kw)
    reqs = fleet_requests(traffic)
    sync(torch)
    t0 = time.perf_counter()
    sched.run(reqs)
    sync(torch)
    return reqs, sched, time.perf_counter() - t0


def fleet_identical(label, got, want):
    """Every request finished, with exactly the reference's tokens."""
    bad = [(i, r.error) for i, r in enumerate(got) if not r.done or r.error]
    if bad:
        raise AssertionError(f"fleet {label}: requests lost or failed {bad}")
    diff = [i for i, (a, b) in enumerate(zip(got, want))
            if a.tokens != b.tokens]
    if diff:
        raise AssertionError(f"fleet {label}: tokens differ from the single "
                             f"scheduler's on requests {diff}")


def fleet_two_stage(torch, eng, traffic, chunk):
    """The traffic's two halves through two single schedulers (chunk
    budget ``chunk``): every request ``prefill_only`` through one, each
    payload adopted (``kv_inject``) by the other.  The disaggregated
    fleet computes each request as this does."""
    from dtdl_tpu_torch.serve.scheduler import Request, Scheduler
    first = Scheduler(eng, harvest_lag=4, device=DEV, chunk_tokens=chunk)
    halves = [Request(list(p), m, prefill_only=True) for p, m in traffic]
    first.run(halves)
    second = Scheduler(eng, harvest_lag=4, device=DEV, chunk_tokens=chunk)
    out = []
    for h in halves:
        r = Request(list(h.prompt), h.max_new_tokens, kv_inject=h.kv_handoff)
        r.tokens = [h.kv_handoff["first_token"]]
        out.append(r)
    second.run(out)
    return out


def fleet_tau(torch, model, prompt):
    """The near-tie rule's tau: SPEC_DELTA_ULPS bf16 ulps of the largest
    prefill logit, twice (as faces (a) and moe_serve (d))."""
    scale = float(prefill_logits(torch, model, prompt).abs().max())
    return 2 * SPEC_DELTA_ULPS * 2.0 ** (math.floor(math.log2(scale)) - 7)


def fleet_k4(n):
    """K4 launches of each of the first ``n`` replicas' threads since the
    last reset (a replica's restarts keep its thread name)."""
    from dtdl_tpu_torch import kernels
    return [kernels.LAUNCHES_BY_THREAD.get(f"serve-replica{i}", {}).get(
        "paged_attention", 0) for i in range(n)]


def fleet_run(torch, eng, traffic, *, during=None, settled=None, waves=1,
              **router_kw):
    """The traffic through a Router on ``eng`` (the Router's warm-up
    first, then the launch counts reset), ``waves`` times one after the
    other: (requests, router, summary, wall s, K4 launches by replica).
    ``during(router, reqs)`` runs after the first wave's submits, before
    the wait; ``settled(router)`` once every request is done, before the
    Router shuts down."""
    from dtdl_tpu_torch import kernels
    from dtdl_tpu_torch.serve.fleet import Router
    kw = {**FLEET_KNOBS, **router_kw}
    sched_kwargs = {"harvest_lag": 4, **kw.pop("sched_kwargs", {})}
    router = Router(eng, device=DEV, sched_kwargs=sched_kwargs, **kw)
    reqs = []
    with router:
        sync(torch)
        kernels.reset_launches()
        t0 = time.perf_counter()
        for wave in range(waves):
            if wave:
                time.sleep(0.05)     # the last receipts reach the directory
            batch = fleet_requests(traffic)
            for r in batch:
                router.submit(r)
            if during is not None and not wave:
                during(router, batch)
            if not router.wait(batch, timeout_s=300):
                raise AssertionError(f"fleet did not settle (pump_error="
                                     f"{router.pump_error})")
            reqs += batch
        sync(torch)
        wall = time.perf_counter() - t0
        if settled is not None:
            settled(router)
    s = router.summary()
    if not s["fleet_accounting_ok"] or router.pump_error is not None:
        raise AssertionError(f"fleet accounting broken or pump failed: "
                             f"{router.pump_error}")
    return reqs, router, s, wall, fleet_k4(len(router.replicas))


def fleet_recovery_s(router, i):
    """Seconds from replica ``i``'s first fault to its last HEALTHY edge:
    the worker's death instant when the eviction log has it, else its
    first SUSPECT edge."""
    h = router.health[i]
    t_ok = [t for t, _, b, _ in h.transitions if b == "healthy"]
    ev = [e for e in router.evict_log if e["replica"] == i]
    if ev and ev[0]["detect_latency_s"] is not None:
        t0 = ev[0]["t"] - ev[0]["detect_latency_s"]
    else:
        t0 = next((t for t, _, b, _ in h.transitions if b == "suspect"),
                  None)
    if t0 is None or not t_ok:
        return None
    return round(t_ok[-1] - t0, 6)


def fleet_tiers(torch, model, traffic, card):
    """(e): two passes of the traffic on a pool cut to FLEET_CUT_PAGES,
    evicted pages spilled to a host tier holding half the shared prefix's
    pages and a disk tier, against the same two passes on the full pool
    (every page stays resident: the run without spill).  Then one disk
    record corrupted: its request recomputes, one quarantine."""
    import mmap
    import tempfile
    from dtdl_tpu_torch.serve.engine import InferenceEngine
    from dtdl_tpu_torch.serve.paged import page_chain_hashes
    from dtdl_tpu_torch.serve.scheduler import Request, Scheduler
    roomy = InferenceEngine(model, n_slots=8, page_size=16, device=DEV)
    cut = InferenceEngine(model, n_slots=8, page_size=16,
                          n_pages=FLEET_CUT_PAGES, device=DEV)
    ref = Scheduler(roomy, harvest_lag=4, device=DEV)
    want = []
    for _ in range(2):
        reqs = fleet_requests(traffic)
        ref.run(reqs)
        want.append(reqs)
    shared_pages = 256 // 16
    host_bytes = (shared_pages // 2) * cut.page_bytes
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        sched = Scheduler(cut, harvest_lag=4, device=DEV,
                          spill_host_bytes=host_bytes, spill_dir=d,
                          spill_disk_bytes=FLEET_DISK_BYTES)
        got, walls = [], []
        for _ in range(2):
            reqs = fleet_requests(traffic)
            sync(torch)
            t0 = time.perf_counter()
            sched.run(reqs)
            sync(torch)
            walls.append(time.perf_counter() - t0)
            got.append(reqs)
        s = sched.metrics.summary()
        for k in range(2):
            fleet_identical(f"(e) pass {k + 1} with spill", got[k], want[k])
        if s["pages_restored"] < shared_pages or s["spill_disk_hits"] < 1:
            raise AssertionError(f"fleet (e): the second pass restored "
                                 f"{s['pages_restored']} pages "
                                 f"({s['spill_disk_hits']} from disk); the "
                                 f"cut pool must evict the shared prefix")
        # corrupt one disk record that a prompt's chain walk will reach
        disk = sched.spill.disk
        pick = None
        for p, _ in traffic:
            hashes = page_chain_hashes(p, 16)[:(len(p) - 1) // 16]
            if hashes and not sched.pages.match_prefix(p) \
                    and sched.spill.holds(hashes[0]) == "disk":
                pick = (p, hashes[0])
                break
        if pick is None:
            raise AssertionError("fleet (e): no prompt's first page lies on "
                                 "the disk tier only")
        slot = disk._slots[pick[1]]
        disk._mm[slot * disk.record_bytes + 5] ^= 0xFF
        disk._mm.flush()
        q0 = s["spill_quarantined"]
        one = Request(list(pick[0]), 32)
        sched.run([one])
        s2 = sched.metrics.summary()
        if one.error or len(one.tokens) != 32 \
                or s2["spill_quarantined"] - q0 != 1 \
                or disk.corrupt_entries != 1:
            raise AssertionError(f"fleet (e): the corrupt record was not "
                                 f"quarantined once and recomputed: "
                                 f"{one!r}, quarantined "
                                 f"{s2['spill_quarantined'] - q0}")
        corrupt_log = str(disk.quarantine_log[0])
    log(f"fleet (e) tiers base bf16 page 16, pool {FLEET_CUT_PAGES - 1} "
        f"pages of {cut.page_bytes} bytes, host tier {host_bytes} bytes "
        f"(half the shared prefix's {shared_pages} pages), disk tier: two "
        f"passes token-identical to the same passes on the full pool "
        f"(no eviction, no spill): pages_spilled={s['pages_spilled']} "
        f"spill_bytes={s['spill_bytes']} spill_s={s['spill_s']:.6f} "
        f"pages_restored={s['pages_restored']} restore_bytes="
        f"{s['restore_bytes']} restore_s={s['restore_s']:.6f} "
        f"host_hits={s['spill_host_hits']} disk_hits={s['spill_disk_hits']} "
        f"pass_walls_s={[round(w, 4) for w in walls]}; one corrupt disk "
        f"record: request recomputed ({len(one.tokens)} tokens), "
        f"quarantined=1 ({corrupt_log[:120]}) | {card}")
    return s


def phase_fleet(torch, seed, card):
    """The serving fleet and the KV tiers at base width (bf16, page 16, 8
    slots, the serve phase's 16 requests), all replicas one engine on the
    card: (a) three replicas against the single scheduler, (b) failover,
    (c) a rolling restart, (d) disaggregation, (e) the tiers, (f) the
    serve_fleet twin."""
    from dtdl_tpu_torch.models.transformer import transformer_lm
    from dtdl_tpu_torch.resil.faults import FaultPlan, replica_site
    from dtdl_tpu_torch.serve.engine import InferenceEngine
    model = transformer_lm("base", seed=seed, dtype=torch.bfloat16,
                           device=DEV)
    traffic = make_traffic(seed, model.cfg.vocab_size)
    eng = InferenceEngine(model, n_slots=8, page_size=16, device=DEV)
    n_layers = model.cfg.n_layers
    n_tok = sum(m for _, m in traffic)
    tau = fleet_tau(torch, model, traffic[0][0])
    # (a)-(c) serve without the prefix cache: a hit maps the pages that
    # the first request of a prefix prefilled on that replica, and in
    # bf16 a page computed inside another prompt can differ in its last
    # bits, so a fleet that splits the traffic hits other pages than one
    # scheduler does (held below under the near-tie rule instead)
    nocache = {"prefix_cache": False}
    fleet_single(torch, eng, traffic[:2])           # warm-up
    single, _, single_wall = fleet_single(torch, eng, traffic, **nocache)
    out = {}

    # (a) three replicas
    reqs, router, s, wall, k4 = fleet_run(torch, eng, traffic,
                                          n_replicas=FLEET_REPLICAS,
                                          sched_kwargs=nocache)
    fleet_identical("(a) three replicas", reqs, single)
    if min(k4) <= 0 or any(n % n_layers for n in k4):
        raise AssertionError(f"fleet (a): K4 launches by replica {k4}")
    out["three_replicas"] = k4
    # prefix cache on, two waves: the second follows the directory
    cached, _, _ = fleet_single(torch, eng, traffic + traffic)
    creqs, _, c_sum, cwall, ck4 = fleet_run(torch, eng, traffic, waves=2,
                                            n_replicas=FLEET_REPLICAS)
    parts = near_tie_divergences(torch, model, cached, creqs, tau)
    if c_sum["fleet_directory_hits"] < 1:
        raise AssertionError("fleet (a): the second wave never followed "
                             "the prefix directory")
    log(f"fleet (a) {FLEET_REPLICAS} replicas base bf16 page 16 (8 slots "
        f"each, one engine), prefix cache off: 16 requests token-identical "
        f"to the single scheduler; fleet tokens_per_s={n_tok / wall:.2f} "
        f"(wall_s={wall:.4f}) single tokens_per_s="
        f"{n_tok / single_wall:.2f} (wall_s={single_wall:.4f}); K4 "
        f"launches by replica {k4}.  Prefix cache on, two waves: "
        f"{len(creqs) - len(parts)}/32 identical to one scheduler's two "
        f"waves, partings (position, top-two gap) {parts} within tau "
        f"{tau:.4e}; tokens_per_s={2 * n_tok / cwall:.2f}, directory hits "
        f"{c_sum['fleet_directory_hits']} (tokens saved "
        f"{c_sum['fleet_directory_tokens_saved']}), K4 by replica {ck4} | "
        f"{card}")

    # (b) failover: replica 0's worker dies, replica 1's engine raises
    plan = (FaultPlan().at(replica_site(0, "loop"), 5)
            .at(replica_site(1, "engine"), 20))
    reqs, router, s, wall, k4 = fleet_run(torch, eng, traffic, plan=plan,
                                          n_replicas=FLEET_REPLICAS,
                                          sched_kwargs=nocache)
    fleet_identical("(b) failover", reqs, single)
    fired = [site for site, _, _ in plan.log]
    if len(fired) != 2 or s["fleet_evictions"] < 1:
        raise AssertionError(f"fleet (b): faults fired {plan.log}, "
                             f"evictions {s['fleet_evictions']}")
    log(f"fleet (b) failover (replica 0's worker killed at loop iteration "
        f"5, replica 1's engine raising at its call 20; fired {fired}): 16 "
        f"requests token-identical to (a), lost 0; evictions="
        f"{s['fleet_evictions']} failovers={s['fleet_failovers']} retries="
        f"{s['fleet_retries']} restarts={s['fleet_restarts']}; seconds "
        f"from fault to HEALTHY: replica 0 {fleet_recovery_s(router, 0)}, "
        f"replica 1 {fleet_recovery_s(router, 1)}; health "
        f"{s['replica_health']} wall_s={wall:.4f} | {card}")

    # (c) a rolling restart under the same traffic; the memory the
    # Router's replicas hold before it and once the traffic is served
    mem = []

    def held(router):
        gc.collect()         # the Router and its replicas form cycles
        sync(torch)
        mem.append(torch.cuda.memory_allocated())

    def restart(router, _):
        held(router)
        router.rolling_restart(timeout_s=120)
    reqs, router, s, wall, k4 = fleet_run(
        torch, eng, traffic, n_replicas=FLEET_REPLICAS, sched_kwargs=nocache,
        during=restart, settled=held)
    mem0, mem1 = mem
    fleet_identical("(c) rolling restart", reqs, single)
    if s["fleet_requests_failed"] or s["fleet_requests_aborted"] \
            or s["fleet_restarts"] != FLEET_REPLICAS:
        raise AssertionError(f"fleet (c): failed {s['fleet_requests_failed']}"
                             f" aborted {s['fleet_requests_aborted']} "
                             f"restarts {s['fleet_restarts']}")
    log(f"fleet (c) rolling restart of {FLEET_REPLICAS} replicas under the "
        f"traffic: failures 0, restarts {s['fleet_restarts']}, tokens as "
        f"(a); memory_allocated with the traffic submitted, before the "
        f"restarts {mem0}, once it is served {mem1} bytes (an arena "
        f"{eng.page_bytes * eng.n_pages} bytes a replica) wall_s="
        f"{wall:.4f} | {card}")

    # (d) disaggregation, held exactly to the two halves through single
    # schedulers, and by the near-tie rule to one mixed chunked scheduler
    # (whose decode rows ride the chunk windows, and whose chunk
    # boundaries follow its own admissions)
    halves = fleet_two_stage(torch, eng, traffic, FLEET_CHUNK)
    chunked, _, _ = fleet_single(torch, eng, traffic,
                                 chunk_tokens=FLEET_CHUNK)
    reqs, router, s, wall, k4 = fleet_run(
        torch, eng, traffic, roles=["prefill", "decode", "decode"],
        sched_kwargs={"chunk_tokens": FLEET_CHUNK})
    fleet_identical("(d) disaggregation", reqs, halves)
    parts = near_tie_divergences(torch, model, chunked, reqs, tau)
    pre = s["replicas"][0]
    if s["fleet_migrations"] != len(traffic) or k4[0] <= 0 \
            or sum(k4[1:]) <= 0 or pre["decode_tokens"] \
            or any(r["prefill_tokens"] for r in s["replicas"][1:]):
        raise AssertionError(f"fleet (d): migrations {s['fleet_migrations']}"
                             f", K4 by replica {k4}")
    out["disagg_prefill"], out["disagg_decode"] = k4[0], k4[1:]
    log(f"fleet (d) disaggregation [prefill, decode, decode], chunk budget "
        f"{FLEET_CHUNK}: 16 requests token-identical to the two halves "
        f"through single schedulers with that budget; against one mixed "
        f"chunked scheduler {len(reqs) - len(parts)}/16 identical, "
        f"partings (position, top-two gap) {parts} within tau {tau:.4e}; "
        f"migrations {s['fleet_migrations']}, pages "
        f"handed over {s['fleet_kv_handoff_pages']}, kv_handoff_s on the "
        f"prefill replica p50 {pre.get('kv_handoff_s_p50')} max "
        f"{pre.get('kv_handoff_s_max')} (count {pre.get('kv_handoff_s_count')}"
        f"), K4 launches prefill replica {k4[0]} decode replicas {k4[1:]}; "
        f"tokens_per_s={n_tok / wall:.2f} | {card}")

    # (e) the tiers
    fleet_tiers(torch, model, traffic, card)
    del eng, router
    torch.cuda.empty_cache()

    # (f) the twin
    path = os.path.join(ROOT, "build", "fleet", "serve_fleet.log")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    text, secs = twin_main("serve_fleet", [*FLEET_TWIN, "--seed", str(seed)],
                           path)
    lost = re.search(r"requests lost: (\d+)", text)
    evict = re.search(r"evicted replica 0 \(([\d.]+)ms", text)
    if lost is None or int(lost[1]) != 0 or evict is None \
            or "[OK]" not in text:
        raise AssertionError(f"fleet (f): serve_fleet twin:\n{text[-3000:]}")
    served = re.search(r"served .*", text)
    log(f"fleet (f) twin serve_fleet {' '.join(FLEET_TWIN)} (main() in this "
        f"process): requests lost 0, eviction {evict[1]} ms after the "
        f"worker's death; "
        f"{served[0] if served else ''} ({secs:.1f} s, log {path}) | {card}")
    return out


TENANT_RANK = 16
TENANT_ROWS = 4                   # row 0 the base, 3 loadable rows
TENANT_NAMES = ("A", "B", "C", "D", "E")
# each adapter's delta as a share of its projection's output RMS
TENANT_SHARE = 0.1
TENANT_CHUNK = 256
TENANT_EOS = 31999
TENANT_SCHEMA = {"type": "object", "properties": {
    "id": {"type": "integer"}, "name": {"type": "string"},
    "ok": {"type": "boolean"}}}
# the fleet twin at its default watchdog (0.25 s): a worker beats after
# each admission's prefill, so a LoRA admission step of four prefills
# (~0.3-0.4 s of host time at base width) is not a wedge (ROADMAP C7)
TENANT_TWINS = (
    ("serve_lm", ["--model-size", "base", "--dtype", "bfloat16",
                  "--page-size", "16", "--n-slots", "8", "--n-requests",
                  "12", "--stream"]),
    ("serve_fleet", ["--model-size", "base", "--dtype", "bfloat16",
                     "--stream", "--kill-replica-after", "3"]),
)


def tenant_dir(*parts) -> str:
    path = os.path.join(ROOT, "build", "tenant", *parts)
    os.makedirs(path, exist_ok=True)
    return path


def tenant_activations(torch, model, prompt) -> dict:
    """The inputs of every attention's q and out projections over one
    cacheless forward of ``prompt``: ``{(block, "q" | "out"): [S, in]}``
    f32 (k and v read q's input)."""
    acts, hooks = {}, []
    for i, block in enumerate(model.blocks):
        for name in ("q", "out"):
            def grab(mod, args, key=(i, name)):
                acts[key] = args[0].reshape(-1, args[0].shape[-1]).float()
            hooks.append(getattr(block.attn, name)
                         .register_forward_pre_hook(grab))
    with torch.no_grad():
        model(torch.tensor([prompt], device=DEV))
    for h in hooks:
        h.remove()
    return acts


def tenant_ratio(torch, model, acts, tree, i, proj) -> float:
    """RMS of adapter ``tree``'s delta over RMS of the projection's output
    on the captured inputs of block ``i``'s ``proj``."""
    x = acts[(i, "out" if proj == "out" else "q")]
    w = getattr(model.blocks[i].attn, proj).kernel.detach().reshape(
        x.shape[1], -1).float()
    leaves = tree[f"block_{i}"]["attn"]
    a = torch.as_tensor(leaves[f"{proj}_a"], device=DEV).reshape(
        x.shape[1], -1)
    b = torch.as_tensor(leaves[f"{proj}_b"], device=DEV).reshape(
        a.shape[1], -1)
    return float(((x @ a) @ b).pow(2).mean().sqrt()
                 / (x @ w).pow(2).mean().sqrt())


def tenant_adapters(torch, model, seed, calib, probe, folder="adapters"):
    """Five rank-16 adapters from ``seed``: A ~ N(0, 1/fan_in), B ~
    N(0, 1/r), each B then scaled so that its delta is TENANT_SHARE of its
    projection's output RMS on the activations of the prompt ``calib``;
    saved through the port's save_weights into build/tenant/<folder>.
    Returns ({name: (path, tree)}, the ratios measured on another prompt,
    ``probe``)."""
    import numpy as np
    from dtdl_tpu_torch.ckpt.checkpoint import save_weights
    from dtdl_tpu_torch.serve.tenant import adapter_template
    rng = np.random.default_rng(seed + 17)
    tpl = adapter_template(model, TENANT_RANK)
    cal = tenant_activations(torch, model, calib)
    out = {}
    for name in TENANT_NAMES:
        tree = {b: {"attn": {n: (rng.normal(0, 1, z.shape)
                                 / math.sqrt(z.size / z.shape[-1]
                                             if n.endswith("_a")
                                             else TENANT_RANK))
                             .astype(np.float32)
                             for n, z in sub["attn"].items()}}
                for b, sub in tpl.items()}
        for i in range(model.cfg.n_layers):
            for proj in ("q", "k", "v", "out"):
                r = tenant_ratio(torch, model, cal, tree, i, proj)
                tree[f"block_{i}"]["attn"][f"{proj}_b"] *= np.float32(
                    TENANT_SHARE / r)
        path = os.path.join(tenant_dir(folder), f"{name}.msgpack")
        save_weights(path, tree)
        out[name] = (path, tree)
    pro = tenant_activations(torch, model, probe)
    ratios = [tenant_ratio(torch, model, pro, tree, i, proj)
              for _, tree in out.values()
              for i in range(model.cfg.n_layers)
              for proj in ("q", "k", "v", "out")]
    return out, ratios


def tenant_shallow(adapters, n_layers):
    """The first ``n_layers`` blocks of each adapter, saved beside the
    full ones (build/tenant/adapters_<n>)."""
    from dtdl_tpu_torch.ckpt.checkpoint import save_weights
    out = {}
    for name, (_, tree) in adapters.items():
        sub = {f"block_{i}": tree[f"block_{i}"] for i in range(n_layers)}
        path = os.path.join(tenant_dir(f"adapters_{n_layers}"),
                            f"{name}.msgpack")
        save_weights(path, sub)
        out[name] = (path, sub)
    return out


def tenant_waves(n):
    """Tenants round-robin over [base, A, B, C, D, E] (None the base) and
    two waves that keep at most 3 adapters in flight, as the bank's 3
    loadable rows hold them (a full bank sheds): the second wave's D and
    E evict two of A-C."""
    tenants = [((None,) + TENANT_NAMES)[i % 6] for i in range(n)]
    return tenants, [[i for i in range(n) if i % 6 < 4],
                     [i for i in range(n) if i % 6 >= 4]]


def tenant_serve(torch, eng, traffic, tenants, waves, adapters=None,
                 grammar=None, constrained=(), record=None, speculate=0,
                 **sched_kw):
    """The traffic through one Scheduler (harvest lag 4) on ``eng``, wave
    after wave: request i under adapter ``adapters[tenants[i]]`` (the
    base for None, or for every request when ``adapters`` is None),
    under ``grammar`` when i is in ``constrained``, each with a
    TokenStream.  ``record`` receives (adapter, prompt, prefix-hit pages)
    of every admission's prefix match.  (requests, scheduler, wall s)."""
    from dtdl_tpu_torch.serve import Request, Scheduler, TokenStream
    sched = Scheduler(eng, harvest_lag=4, device=DEV, **sched_kw)
    if record is not None:
        match = sched.pages.match_prefix

        def spy(prompt, adapter=None):
            hits = match(prompt, adapter)
            record.append((adapter, list(prompt), len(hits)))
            return hits
        sched.pages.match_prefix = spy
    reqs = []
    for i, (p, m) in enumerate(traffic):
        g = grammar if i in constrained else None
        reqs.append(Request(
            list(p), m, speculate=speculate,
            adapter=(None if adapters is None or tenants[i] is None
                     else adapters[tenants[i]][0]),
            grammar=g, eos_id=TENANT_EOS if g is not None else None,
            stream=TokenStream()))
    sync(torch)
    t0 = time.perf_counter()
    for wave in waves:
        sched.run([reqs[i] for i in wave])
    sync(torch)
    return reqs, sched, time.perf_counter() - t0


def tenant_streams_ok(label, reqs):
    """Every request finished without error, its stream closed, not
    divergent and equal to its tokens."""
    bad = [(r.rid, r.error) for r in reqs if not r.done or r.error]
    div = [(r.rid, r.stream.closed, r.stream.divergent,
            len(r.stream.tokens), len(r.tokens)) for r in reqs
           if not r.stream.closed or r.stream.divergent
           or r.stream.tokens != r.tokens]
    if bad or div:
        raise AssertionError(f"tenant {label}: failed {bad}, streams open "
                             f"or parted (rid, closed, divergent, streamed,"
                             f" tokens) {div}")


def tenant_oracle(torch, model, traffic, tenants, adapters, **engine_kw):
    """The merged-weights oracle: each tenant's requests on a plain engine
    (8 slots, no bank) serving ``merge_adapter(model, its adapter)``, the
    base's on ``model``.  (requests in traffic order, {tenant: model})."""
    from dtdl_tpu_torch.serve import (InferenceEngine, Request, Scheduler,
                                      merge_adapter)
    out, models = [None] * len(traffic), {}
    for tenant in (None,) + TENANT_NAMES:
        idx = [i for i, t in enumerate(tenants) if t == tenant]
        if not idx:
            continue
        m = model if tenant is None else merge_adapter(model,
                                                       adapters[tenant][1])
        models[tenant] = m
        eng = InferenceEngine(m, n_slots=8, device=DEV, **engine_kw)
        reqs = [Request(list(traffic[i][0]), traffic[i][1]) for i in idx]
        Scheduler(eng, harvest_lag=4, device=DEV).run(reqs)
        for i, r in zip(idx, reqs):
            out[i] = r
    return out, models


def tenant_exact(label, got, want, idx=None):
    """``got[i]`` carries exactly ``want[i]``'s tokens for every i (of
    ``idx``)."""
    idx = range(len(got)) if idx is None else idx
    diff = [i for i in idx if got[i].error or got[i].tokens != want[i]]
    if diff:
        first = [(got[i].tokens, want[i]) for i in diff[:2]]
        raise AssertionError(f"tenant {label}: requests {diff} differ from "
                             f"the oracle: {first}")


def tenant_step_launches(eng):
    """Wrap ``eng.decode``/``eng.verify``: each call's K4 launches are
    appended to the returned list."""
    from dtdl_tpu_torch import kernels
    sink = []

    def counted(fn):
        def wrapper(*args, **kwargs):
            before = kernels.LAUNCHES["paged_attention"]
            out = fn(*args, **kwargs)
            sink.append(kernels.LAUNCHES["paged_attention"] - before)
            return out
        return wrapper
    eng.decode, eng.verify = counted(eng.decode), counted(eng.verify)
    return sink


def masked_oracle(torch, model, prompt, n_new, dfa):
    """Eager masked argmax: the cacheless forward's last logits masked
    by the automaton's state, one token at a time, to EOS or
    ``n_new``."""
    import numpy as np
    q, out, seq = dfa.start, [], list(prompt)
    with torch.no_grad():
        for _ in range(n_new):
            lg = model(torch.tensor([seq], device=DEV))[0, -1]
            keep = torch.from_numpy(dfa.mask(q)).to(DEV)
            t = int(torch.where(keep, lg, torch.full_like(lg, -np.inf))
                    .argmax())
            out.append(t)
            q = dfa.step(q, t)
            seq.append(t)
            if t == dfa.eos_id:
                break
    return out


def json_ok(tokens) -> bool:
    """``tokens`` (EOS last) spell a JSON object of TENANT_SCHEMA."""
    try:
        obj = json.loads("".join(chr(t) for t in tokens[:-1]))
    except ValueError:
        return False
    return (isinstance(obj, dict) and list(obj) == ["id", "name", "ok"]
            and type(obj["id"]) is int and isinstance(obj["name"], str)
            and isinstance(obj["ok"], bool))


def phase_tenant(torch, seed, card):
    """Tenancy at base width: (a) LoRA in bf16 against a bank-free engine
    and the merged oracle, (b) LoRA at 2 layers in f32 exactly, (c)
    grammars, (d) streams and a faulted fleet, (e) the twins."""
    import numpy as np
    from dtdl_tpu_torch import kernels
    from dtdl_tpu_torch.models.transformer import transformer_lm
    from dtdl_tpu_torch.resil.faults import FaultPlan, replica_site
    from dtdl_tpu_torch.serve import (InferenceEngine, Request, Router,
                                      TokenStream, byte_vocab,
                                      compile_json_schema, mask_words)
    import shutil
    shutil.rmtree(os.path.join(ROOT, "build", "tenant"), ignore_errors=True)
    model = transformer_lm("base", seed=seed, dtype=torch.bfloat16,
                           device=DEV)
    n_layers, vocab = model.cfg.n_layers, model.cfg.vocab_size
    traffic = make_traffic(seed, vocab)
    n_tok = sum(m for _, m in traffic)
    adapters, ratios = tenant_adapters(torch, model, seed,
                                       traffic[1][0][:512],
                                       traffic[3][0][:512])
    tenants, waves = tenant_waves(len(traffic))
    out = {}

    # (a) LoRA at full width in bf16, paired with the same requests on an
    # engine without a bank (plain, lora, lora, plain)
    lora_eng = InferenceEngine(model, n_slots=8, page_size=16, device=DEV,
                               lora_rank=TENANT_RANK,
                               lora_adapters=TENANT_ROWS)
    plain_eng = InferenceEngine(model, n_slots=8, page_size=16, device=DEV)
    tenant_serve(torch, lora_eng, traffic[:2], tenants, [[0, 1]],
                 adapters)                                        # warm-up
    bank = lora_eng.adapter_bank
    runs, record = {"plain": [], "lora": []}, []
    for kind in ("plain", "lora", "lora", "plain"):
        first = kind == "lora" and not runs["lora"]
        if first:
            kernels.reset_launches()
            counts0 = (bank.n_loads, bank.n_evictions)
        runs[kind].append(tenant_serve(
            torch, lora_eng if kind == "lora" else plain_eng, traffic,
            tenants, waves, adapters if kind == "lora" else None,
            record=record if first else None))
        if first:
            k4 = kernels.LAUNCHES["paged_attention"]
            loads, evictions = (bank.n_loads - counts0[0],
                                bank.n_evictions - counts0[1])
    for kind, got in runs.items():
        for reqs, _, _ in got:
            tenant_streams_ok(f"(a) {kind}", reqs)
    if k4 <= 0 or k4 % n_layers or evictions < 2:
        raise AssertionError(f"tenant (a): K4 launches {k4}, evictions "
                             f"{evictions}")
    out["lora"] = k4
    # prefix hits only between requests of one adapter; a prefix shared
    # with another adapter's earlier request maps nothing
    hits_by, cross = {}, 0
    for j, (adapter, prompt, n) in enumerate(record):
        seen = record[:j]
        if n and not any(a == adapter and p[:16 * n] == prompt[:16 * n]
                         for a, p, _ in seen):
            raise AssertionError(f"tenant (a): {n} prefix-hit pages with no "
                                 f"earlier request of {adapter}")
        if not n and any(a != adapter and p[:16] == prompt[:16]
                         for a, p, _ in seen):
            cross += 1
        name = "base" if adapter is None else os.path.basename(adapter)
        hits_by[name] = hits_by.get(name, 0) + n
    if not cross or not sum(hits_by.values()):
        raise AssertionError(f"tenant (a): prefix-hit pages by adapter "
                             f"{hits_by}, cross-adapter misses {cross}")
    lora_reqs = runs["lora"][0][0]
    tau = fleet_tau(torch, model, traffic[0][0])
    oracle, merged = tenant_oracle(torch, model, traffic, tenants, adapters,
                                   page_size=16)
    parts = []
    for tenant, m in merged.items():
        idx = [i for i, t in enumerate(tenants) if t == tenant]
        parts += near_tie_divergences(torch, m, [oracle[i] for i in idx],
                                      [lora_reqs[i] for i in idx], tau)
    del merged, oracle

    def rate(run):
        s = run[1].metrics.summary()
        return n_tok / run[2], s["ttft_s_p50"], s["ttft_s_p99"]
    st = {k: [rate(r) for r in v] for k, v in runs.items()}
    out["lora_tokens_per_s"] = [r[0] for r in st["lora"]]
    out["plain_tokens_per_s"] = [r[0] for r in st["plain"]]
    bank_bytes = lora_eng.compile_stats()["lora"]["bank_bytes"]
    log(f"tenant (a) LoRA base bf16 page 16 (8 slots), rank {TENANT_RANK}, "
        f"{TENANT_ROWS} bank rows ({bank_bytes} bytes), tenants [base, A-E] round-robin over the serve phase's 16 "
        f"requests in two waves: delta/projection RMS on a probe prompt mean "
        f"{np.mean(ratios):.4f} min {min(ratios):.4f} max {max(ratios):.4f};"
        f" tokens_per_s (plain, lora, lora, plain) {st['plain'][0][0]:.2f} "
        f"{st['lora'][0][0]:.2f} {st['lora'][1][0]:.2f} "
        f"{st['plain'][1][0]:.2f}; ttft_s p50/p99 lora "
        f"{st['lora'][0][1]:.4f}/{st['lora'][0][2]:.4f} plain "
        f"{st['plain'][0][1]:.4f}/{st['plain'][0][2]:.4f}; bank loads "
        f"{loads} evictions {evictions}; K4 launches {k4}; prefix-hit pages "
        f"by adapter {hits_by}, cross-adapter shared-prefix misses {cross}; "
        f"{len(traffic) - len(parts)}/16 identical to the merged oracle, "
        f"partings (position, top-two gap) {parts} within tau {tau:.4e} | "
        f"{card}")
    del plain_eng

    # (b) LoRA at 2 layers in f32: exactly the merged oracle, paged and
    # dense, plain, chunked and speculative
    t_b = time.perf_counter()
    m2 = transformer_lm("base", n_layers=2, seed=seed, dtype=torch.float32,
                        device=DEV)
    ad2 = tenant_shallow(adapters, 2)
    modes = (("plain", {}, 0), ("chunked", {"chunk_tokens": TENANT_CHUNK}, 0),
             ("spec", {}, 4))
    spec_steps = {}
    for arena, geo in (("paged", {"page_size": 16}),
                       ("dense", {"page_size": 0})):
        oracle, _ = tenant_oracle(torch, m2, traffic, tenants, ad2, **geo)
        eng = InferenceEngine(m2, n_slots=8, device=DEV,
                              lora_rank=TENANT_RANK,
                              lora_adapters=TENANT_ROWS, **geo)
        for mode, kw, spec in modes:
            got, sched, _ = tenant_serve(torch, eng, traffic, tenants, waves,
                                         ad2, speculate=spec, **kw)
            tenant_exact(f"(b) {arena} {mode}", got,
                         [r.tokens for r in oracle])
            tenant_streams_ok(f"(b) {arena} {mode}", got)
            if spec:
                spec_steps[arena] = sched.metrics.summary()["spec_steps"]
        del eng
    if not all(spec_steps.values()):
        raise AssertionError(f"tenant (b): no verify step {spec_steps}")
    log(f"tenant (b) LoRA base widths, 2 layers, f32, the same requests and "
        f"waves (requests 0 on the base and 2 under B share a 256-token "
        f"prefix): token-identical to the merged oracle on the paged and "
        f"the dense arena, plain, chunked ({TENANT_CHUNK}) and speculate=4 "
        f"(verify steps {spec_steps}) ({time.perf_counter() - t_b:.1f} s) | "
        f"{card}")

    # (c) grammars: the schema over the byte vocabulary, compiled on the
    # host outside every timed window
    t0 = time.perf_counter()
    dfa = compile_json_schema(TENANT_SCHEMA, byte_vocab(vocab), TENANT_EOS)
    compile_s = time.perf_counter() - t0
    constrained = set(range(0, len(traffic), 2))
    free = [i for i in range(len(traffic)) if i not in constrained]
    kernels.reset_launches()
    mixed, msched, _ = tenant_serve(torch, lora_eng, traffic, tenants,
                                    [list(range(len(traffic)))],
                                    grammar=dfa, constrained=constrained)
    out["grammar"] = kernels.LAUNCHES["paged_attention"]
    tenant_streams_ok("(c) mixed", mixed)
    illegal = [i for i in constrained if dfa.walk(mixed[i].tokens) < 0]
    ended = [i for i in constrained if mixed[i].tokens[-1] == TENANT_EOS]
    bad_json = [i for i in ended if not json_ok(mixed[i].tokens)]
    if illegal or bad_json or out["grammar"] <= 0:
        raise AssertionError(f"tenant (c): illegal tokens in {illegal}, "
                             f"EOS-ended requests that do not parse "
                             f"{bad_json}, K4 launches {out['grammar']}")
    alone = {}
    for label, idx in (("constrained", sorted(constrained)),
                       ("free", free)):
        reqs, _, wall = tenant_serve(
            torch, lora_eng, [traffic[i] for i in idx], tenants, [
                list(range(len(idx)))], grammar=dfa,
            constrained=set(range(len(idx))) if label == "constrained"
            else ())
        alone[label] = sum(len(r.tokens) for r in reqs) / wall
    # at 2 layers in f32: the eager masked-argmax oracle, plain, with
    # n-gram speculation (each verify window masked position by
    # position) and chunked (the final chunk's bonus token masked)
    e2 = InferenceEngine(m2, n_slots=8, page_size=16, device=DEV)
    steps = tenant_step_launches(e2)
    want = {i: masked_oracle(torch, m2, traffic[i][0], traffic[i][1], dfa)
            for i in constrained}
    rejected = {}
    for mode, kw, spec in modes:
        got, sched, _ = tenant_serve(torch, e2, traffic, tenants,
                                     [list(range(len(traffic)))],
                                     grammar=dfa, constrained=constrained,
                                     speculate=spec, **kw)
        tenant_exact(f"(c) 2 layers f32 {mode}", got, want,
                     sorted(constrained))
        rejected[mode] = sched.metrics.summary()["grammar_rejected_tokens"]
    if any(n != 2 for n in steps):
        raise AssertionError(f"tenant (c): K4 launches a step {set(steps)}, "
                             f"want one per layer (2)")
    words = mask_words(vocab)
    log(f"tenant (c) grammar: {json.dumps(TENANT_SCHEMA)} over "
        f"byte_vocab({vocab}) (EOS {TENANT_EOS}): {dfa.n_states} states, "
        f"{dfa.nbytes()} bytes of tables, compiled in {compile_s:.3f} s on "
        f"the host; base bf16, 8 constrained + 8 free requests mixed: every "
        f"constrained token legal, {len(ended)}/8 ended by EOS, all parsing "
        f"as the schema; K4 launches {out['grammar']}; tokens_per_s "
        f"constrained alone {alone['constrained']:.2f} free alone "
        f"{alone['free']:.2f} (ratio "
        f"{alone['constrained'] / alone['free']:.3f}); mask bytes a decode "
        f"step packed {8 * words * 4} dense {8 * vocab} (a verify step of "
        f"width 5: {40 * words * 4} / {40 * vocab}); 2 layers f32: "
        f"constrained tokens identical to the eager masked argmax, plain, "
        f"speculate=4 and chunked ({TENANT_CHUNK}), K4 once per layer in "
        f"all {len(steps)} steps; grammar_rejected_tokens {rejected} | "
        f"{card}")
    del e2, m2

    # (d) streams through a faulted fleet: three replicas of the LoRA
    # engine, replica 0's worker killed, replica 1's engine raising, run
    # with the prefix cache on (recorded) and off (held).  Off, a retry on
    # another replica computes its request as the failed attempt did; on,
    # a hit on pages another prompt computed can part it at a bf16
    # near-tie, which its stream rightly reports as divergent (the fleet
    # phase holds (a)-(c) without the cache for the same reason)
    names = (None, "A", "B")

    def faulted_fleet(prefix_cache):
        plan = (FaultPlan().at(replica_site(0, "loop"), 5)
                .at(replica_site(1, "engine"), 20))
        reqs = [Request(list(p), m, stream=TokenStream(),
                        adapter=(None if names[i % 3] is None
                                 else adapters[names[i % 3]][0]),
                        grammar=dfa if i % 4 == 1 else None,
                        eos_id=TENANT_EOS if i % 4 == 1 else None)
                for i, (p, m) in enumerate(traffic)]
        kernels.reset_launches()
        with Router(lora_eng, n_replicas=FLEET_REPLICAS, device=DEV,
                    plan=plan, sched_kwargs={"harvest_lag": 4,
                                             "prefix_cache": prefix_cache},
                    **FLEET_KNOBS) as router:
            for r in reqs:
                router.submit(r)
            if not router.wait(reqs, timeout_s=300):
                raise AssertionError(f"tenant (d): the fleet did not settle "
                                     f"(pump_error={router.pump_error})")
        s = router.summary()
        lost = s["fleet_requests_submitted"] - (
            s["fleet_requests_finished"] + s["fleet_requests_rejected"]
            + s["fleet_requests_expired"] + s["fleet_requests_failed"]
            + s["fleet_requests_aborted"])
        bad = [r.rid for r in reqs if not r.done or r.error]
        if lost or bad or len(plan.log) != 2 \
                or not s["fleet_accounting_ok"]:
            raise AssertionError(f"tenant (d): lost {lost}, failed {bad}, "
                                 f"faults fired {plan.log}")
        return reqs, s, sum(r.stream.divergent for r in reqs)
    _, s_on, div_on = faulted_fleet(True)
    reqs, s, _ = faulted_fleet(False)
    out["fleet"] = fleet_k4(FLEET_REPLICAS)
    tenant_streams_ok("(d) fleet", reqs)
    by_adapter = {os.path.basename(k): v
                  for k, v in s["fleet_tokens_by_adapter"].items()}
    log(f"tenant (d) streams: every request of (a) and (c) streamed, each "
        f"stream closed, not divergent, equal to its tokens; a Router of "
        f"{FLEET_REPLICAS} replicas of the LoRA engine (replica 0's worker "
        f"killed at loop iteration 5, replica 1's engine raising at call "
        f"20) over the 16 requests (tenants base/A/B, every 4th "
        f"constrained), prefix cache off: requests lost 0, divergent "
        f"streams 0, retries {s['fleet_retries']}, evictions "
        f"{s['fleet_evictions']}, stream deliveries "
        f"{s['fleet_stream_deliveries']}, fleet_tokens_by_adapter "
        f"{by_adapter}, K4 by replica {out['fleet']}; prefix cache on: lost 0, "
        f"divergent streams {div_on} (retries {s_on['fleet_retries']}) | "
        f"{card}")
    del lora_eng

    # (e) the twins, each as a user runs it
    d = tenant_dir("twins")
    schema = os.path.join(d, "schema.json")
    with open(schema, "w") as f:
        json.dump(TENANT_SCHEMA, f)
    lora = f"{os.path.join(d, 'a.msgpack')},{os.path.join(d, 'b.msgpack')}"
    trace = os.path.join(d, "serve_fleet.json")
    for name, args in TENANT_TWINS:
        extra = ["--lora", lora, "--seed", str(seed)]
        if name == "serve_lm":
            extra += ["--json-schema", schema]
        else:
            # the trace reads where a worker's iterations go (C7)
            extra += ["--trace", trace]
        text, secs = twin_main(name, [*args, *extra],
                               os.path.join(d, f"{name}.log"))
        served = re.search(r"served (\d+)/(\d+) requests", text)
        if name == "serve_fleet" and (
                "requests lost: 0" not in text
                or "divergent streams: 0" not in text
                or not served or served[1] != served[2]
                or "0 with named errors" not in text):
            raise AssertionError(f"tenant (e): {name}:\n{text[-3000:]}")
        if "multi-lora (2 adapters" not in text:
            raise AssertionError(f"tenant (e): {name}:\n{text[-3000:]}")
        lines = [x.strip() for x in text.splitlines()
                 if re.match(r"\s*(served|multi-lora|constrained|streaming|"
                             r"heartbeat)", x)]
        if name == "serve_fleet":
            events = json.load(open(trace))["traceEvents"]
            it_s, parts = longest_iteration(events)
            lines.append(f"longest worker iteration {it_s:.4f} s ("
                         f"{ {k: round(v, 4) for k, v in parts.items()} }), "
                         f"{span_stats(events, 'prefill')}")
        log(f"tenant (e) twin {name} {' '.join(args)} --lora a,b"
            f"{' --json-schema' if name == 'serve_lm' else ''}: main() "
            f"returned "
            f"({secs:.1f} s): {' / '.join(lines)} | {card}")
    return out


# ---------------------------------------------------------------------------
# obs: the observer, the metrics exporter and the SLOs through training,
# serving and the fleet, on K1-K4
# ---------------------------------------------------------------------------

# (a): pairs of an observed and an unobserved run, in turns (on
# first in even pairs, off first in odd ones); the overhead is the median
# of the pairs' ratios, against JAX's limit
OBS_PAIRS = 5
OBS_LIMIT = 0.02
# (b): pairs of runs observing alternate steps; a serving step's time
# spreads widely (obs_step_overhead), so the gate pools 16 pairs' steps
OBS_SERVE_PAIRS = 16
OBS_TRAIN_STEPS = (3, 10)         # warm-up, timed steps a run
OBS_MFU_TOL = 0.01                # the meter's MFU against the train line
OBS_WATCHDOG = 0.25               # the fleet twin's default
# (c) the fleet: the TTFT objective and the stall that breaks it
OBS_TTFT_SLO, OBS_STALL_S = 1.5, 3.0
OBS_RECOVER_WAVES, OBS_WAVE = 9, 12
# (d) the twins, each at its defaults but for the flags it is run with
OBS_FLEET_TWIN = ["--model-size", "base", "--n-requests", "32"]
OBS_SERVE_TWIN = ["--model-size", "base", "--page-size", "16",
                  "--n-slots", "8", "--n-requests", "16", "--dtype",
                  "bfloat16"]
OBS_TRAIN_TWIN = ["--model-size", "base", "--epochs", "1",
                  "--log-interval", "16"]


def median(xs):
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])


_GC_PAUSE = [0.0, 0.0]          # seconds in the collector, start of the last


def _gc_timer(phase, info):
    if phase == "start":
        _GC_PAUSE[1] = time.perf_counter()
    else:
        _GC_PAUSE[0] += time.perf_counter() - _GC_PAUSE[1]


def host_counters(torch, since=None) -> dict:
    """The host's counters of a timed run: CPU seconds of this thread and
    of the process (every thread), seconds in the garbage collector and
    the caching allocator's device mallocs; with ``since``, the change
    from that reading."""
    if _gc_timer not in gc.callbacks:
        gc.callbacks.append(_gc_timer)
    now = {"cpu_main_s": time.thread_time(), "cpu_all_s": time.process_time(),
           "gc_s": _GC_PAUSE[0],
           "device_mallocs": torch.cuda.memory_stats().get(
               "num_device_alloc", 0) if DEV == "cuda" else 0}
    return now if since is None else {k: now[k] - since[k] for k in now}


def host_sums(runs) -> dict:
    return {k: round(sum(r["host"][k] for r in runs), 4)
            for k in runs[0]["host"]}


def obs_pairs(run) -> dict:
    """``run(on)`` in OBS_PAIRS pairs, the observed run first in even
    pairs and last in odd ones: {True: runs, False: runs}, pair by pair."""
    runs = {True: [], False: []}
    for i in range(OBS_PAIRS):
        for on in ((True, False) if i % 2 == 0 else (False, True)):
            runs[on].append(run(on))
    return runs


def obs_toggled(sched, reqs, phase: int, step_s: list) -> None:
    """``sched.run(reqs)`` with its observer and exporter attached at the
    steps whose index has parity ``phase`` and detached at the others;
    each step's seconds are appended to ``step_s`` (the final drain is
    timed by neither)."""
    from dtdl_tpu_torch.obs.observer import NULL_OBSERVER
    on, off = (sched.observer, sched.exporter), (NULL_OBSERVER, None)
    for r in reqs:
        sched.submit(r)
    i = 0
    while sched.queue or any(s is not None for s in sched.slots):
        observed = i % 2 == phase
        sched.observer, sched.exporter = on if observed else off
        t0 = time.perf_counter()
        sched.step()
        step_s.append(time.perf_counter() - t0)
        i += 1
    sched.observer, sched.exporter = on
    sched.drain()


def obs_step_overhead(a, b) -> list:
    """The observer's share of a step from two toggled runs of the same
    steps, ``a`` observed at the even steps and ``b`` at the odd ones:
    step i takes speed_a(i)·w_i·(1+d) in ``a`` and speed_b(i)·w_i in
    ``b`` when even, the other way round when odd.  Half the difference
    of an even step's log a/b ratio and the next odd step's is log(1+d)
    whatever the steps' work and the runs' host speeds, so long as those
    speeds drift slowly against one step.  Returns one such sample per
    even step; the gate takes the median over every pair's samples."""
    import math
    r = [math.log(x / y) for x, y in zip(a, b)]
    return [(r[i] - r[i + 1]) / 2 for i in range(0, len(r) - 1, 2)]


def obs_dir(*parts) -> str:
    path = os.path.join(ROOT, "build", "obs", *parts)
    os.makedirs(path, exist_ok=True)
    return path


def sync_count(torch, fn, where=None):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")``: (its
    result, the number of operations that waited for the card); each
    one's ``file:line`` is appended to the list ``where``."""
    import warnings
    if DEV != "cuda":
        return fn(), 0
    sync(torch)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    hits = [w for w in caught if "synchroniz" in str(w.message)]
    if where is not None:
        where.extend(f"{os.path.basename(w.filename)}:{w.lineno}"
                     for w in hits)
    return out, len(hits)


def sync_sites(runs) -> dict:
    """{file:line: counts by run} where the runs' synchronizations differ."""
    sites = sorted({x for r in runs for x in r["where"]})
    out = {}
    for x in sites:
        n = [r["where"].count(x) for r in runs]
        if len(set(n)) > 1:
            out[x] = n
    return out


def span_counts(obs) -> dict:
    out: dict = {}
    for e in obs.tracer.to_chrome()["traceEvents"]:
        if e["ph"] == "X":
            key = e["name"] if e["tid"] != 1 else "device (window-settled)"
            out[key] = out.get(key, 0) + 1
    return out


def span_stats(trace_events, name) -> str:
    """Count, mean and max seconds of the ``name`` spans of a trace."""
    d = [e["dur"] / 1e6 for e in trace_events
         if e.get("ph") == "X" and e["name"] == name]
    if not d:
        return f"{name}: none"
    return (f"{name} x{len(d)} mean {sum(d) / len(d):.4f} s max "
            f"{max(d):.4f} s")


def flows_closed(trace_events) -> tuple:
    """(user rids whose flow chain dangles: not one start first and one
    end after it, the rids with steps after their end).  A step after the
    end is a hedge's or a retry's losing attempt, still running when the
    user's terminal closed the chain (JAX's emitters do the same)."""
    by: dict = {}
    flows = [e for e in trace_events if e.get("cat") == "request"]
    for e in sorted(flows, key=lambda e: e["ts"]):
        by.setdefault(e["id"], []).append(e["ph"])
    dangling = [rid for rid, phs in by.items()
                if phs.count("s") != 1 or phs.count("f") != 1
                or phs[0] != "s"]
    late = [rid for rid, phs in by.items()
            if rid not in dangling and phs[-1] != "f"]
    return dangling, late


def parse_prometheus(text) -> dict:
    """{name: value} of a scrape body; raises on a malformed line."""
    out = {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            continue
        name, value, ts = line.split(" ")
        if not re.fullmatch(r"[a-zA-Z_:][a-zA-Z0-9_:]*", name):
            raise AssertionError(f"bad metric name in {line!r}")
        out[name] = float(value)
        int(ts)
    return out


def longest_iteration(trace) -> tuple:
    """The longest interval between two ``admit`` spans of one replica
    worker in which it did work (a prefill, a dispatch or a harvest),
    from a fleet trace: (seconds, its spans' seconds by name)."""
    by_tid: dict = {}
    for e in trace:
        if e.get("ph") == "X" and e["name"] in ("admit", "prefill",
                                                 "dispatch", "verify",
                                                 "harvest", "drain"):
            by_tid.setdefault(e["tid"], []).append(e)
    best = (0.0, {})
    for evs in by_tid.values():
        evs.sort(key=lambda e: e["ts"])
        admits = [e for e in evs if e["name"] == "admit"]
        for a, b in zip(admits, admits[1:]):
            inside = [e for e in evs if a["ts"] <= e["ts"] < b["ts"]
                      and e["name"] != "admit"]
            work = {}
            for e in inside + [a]:
                work[e["name"]] = work.get(e["name"], 0.0) + e["dur"] / 1e6
            if set(work) - {"admit"} and (b["ts"] - a["ts"]) / 1e6 > best[0]:
                best = ((b["ts"] - a["ts"]) / 1e6, work)
    return best


def obs_train(torch, seed, card):
    """(a) the train cell through train_epoch, observed and not."""
    from dtdl_tpu_torch import kernels
    from dtdl_tpu_torch.data.loader import DataLoader
    from dtdl_tpu_torch.data.synthetic import synthetic_lm
    from dtdl_tpu_torch.metrics.report import Reporter
    from dtdl_tpu_torch.models.transformer import transformer_lm
    from dtdl_tpu_torch.obs import (GoodputMeter, JsonlSeriesSink,
                                    MetricsExporter, Observer,
                                    lm_train_flops, peak_flops_per_chip)
    from dtdl_tpu_torch.train.loop import train_epoch
    from dtdl_tpu_torch.train.optim import adamw
    from dtdl_tpu_torch.train.state import init_state
    from dtdl_tpu_torch.train.step import make_lm_train_step
    warm, steps = OBS_TRAIN_STEPS
    tokens, _ = synthetic_lm(n_train=TRAIN_BATCH * (warm + steps),
                             n_test=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                             vocab_size=32000, seed=seed)
    model = transformer_lm("base", max_seq=TRAIN_SEQ, seed=None, device=DEV)
    state = init_state(model, seed, adamw(3e-4), device=DEV)
    step = make_lm_train_step()
    cfg = model.cfg
    flops = lm_train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    peak = peak_flops_per_chip()
    series = os.path.join(obs_dir("train"), "series.jsonl")

    class Sink:
        def __init__(self, ex):
            self.ex = ex

        def write(self, payload):
            if self.ex is not None:     # the report boundary samples it
                self.ex.sample()

        def close(self):
            pass

    def loader(lo, hi):
        return DataLoader({"tokens": tokens[lo * TRAIN_BATCH:
                                            hi * TRAIN_BATCH]},
                          TRAIN_BATCH, shuffle=False, device=DEV)

    def run(on):
        obs = ex = None
        if on:
            obs = Observer(trace=True, sentinel="warn",
                           goodput=GoodputMeter(
                               flops_per_step=flops,
                               tokens_per_step=TRAIN_BATCH * (TRAIN_SEQ - 1)))
            ex = MetricsExporter([JsonlSeriesSink(series)], interval_s=0.0)
            ex.add_source("goodput", obs.goodput.export_window)
        rep = Reporter([Sink(ex)], leader_only=False)
        nonlocal state
        state, _ = train_epoch(step, state, loader(0, warm), reporter=rep,
                               log_interval=5)
        sync(torch)
        kernels.reset_launches()
        where = []
        t0 = time.perf_counter()
        (state, means), n_sync = sync_count(torch, lambda: train_epoch(
            step, state, loader(warm, warm + steps), reporter=rep,
            log_interval=5, observer=obs), where)
        sync(torch)
        wall = time.perf_counter() - t0
        if ex is not None:
            ex.close()
        return dict(wall=wall, syncs=n_sync, obs=obs, ex=ex, where=where,
                    launches=dict(kernels.LAUNCHES), loss=means["loss"])

    # one run first, not kept: the host allocators' first blocks (pinned
    # staging for the uploads) are taken there, not inside a counted run
    run(False)
    runs = obs_pairs(run)
    ms = {on: [1e3 * r["wall"] / steps for r in runs[on]] for on in runs}
    over = median([a / b - 1.0 for a, b in zip(ms[True], ms[False])])
    syncs = {on: [r["syncs"] for r in runs[on]] for on in runs}
    last = runs[True][-1]
    obs = last["obs"]
    mfu_meter = obs.goodput.totals().get("mfu")
    mfu_line = flops * steps / last["wall"] / peak if peak else None
    want = cfg.n_layers * steps
    bad = [(on, r["launches"]) for on in runs for r in runs[on]
           if any(r["launches"][k] != want for k in
                  ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))]
    counts = span_counts(obs)
    points = sum(1 for _ in open(series))
    k123 = {k: last["launches"][k] for k in ("flash_fwd", "flash_bwd_dq",
                                             "flash_bwd_dkv", "rope_rows")}
    log(f"obs (a) train base bf16 (f32 weights) adamw(3e-4) {TRAIN_BATCH}x"
        f"{TRAIN_SEQ} through train_epoch, {steps} steps a run after "
        f"{warm}, observed (Tracer, GoodputMeter, MetricsExporter with a "
        f"JSONL sink) and not, in {OBS_PAIRS} pairs: step_ms on "
        f"{[round(x, 3) for x in ms[True]]} off "
        f"{[round(x, 3) for x in ms[False]]}, overhead (median of the "
        f"pairs) {100 * over:+.3f}% (limit {100 * OBS_LIMIT:.0f}%; pooled "
        f"{100 * (sum(ms[True]) / sum(ms[False]) - 1):+.3f}%); "
        f"synchronizations on {syncs[True]} off "
        f"{syncs[False]} (sites where runs differ, on runs first: "
        f"{sync_sites(runs[True] + runs[False])}); spans {counts}; meter "
        f"mfu {mfu_meter} against "
        f"the train line's reckoning {mfu_line and round(mfu_line, 5)}; "
        f"series points {points}; K1-K3 launches a run {k123} | {card}")
    if over > OBS_LIMIT:
        raise AssertionError(f"obs (a): observer overhead {100 * over:.3f}%")
    if len(set(syncs[True] + syncs[False])) != 1:
        raise AssertionError(f"obs (a): synchronizations differ: {syncs}")
    if bad:
        raise AssertionError(f"obs (a): K1-K3 launches {bad}, want {want}")
    if not ({"data", "dispatch", "drain", "device (window-settled)"}
            <= set(counts)) or counts["dispatch"] != steps:
        raise AssertionError(f"obs (a): spans {counts}")
    if mfu_line is None or mfu_meter is None or \
            abs(mfu_meter - mfu_line) > OBS_MFU_TOL * mfu_line:
        raise AssertionError(f"obs (a): meter mfu {mfu_meter} against "
                             f"{mfu_line}")
    del state, model
    torch.cuda.empty_cache()
    return last["launches"]


def obs_serve(torch, seed, card):
    """(b) the serve cell through a Scheduler, observed and not: one run
    each way for the functional checks, then the overhead from runs that
    observe every other step (see :func:`obs_toggled`)."""
    from dtdl_tpu_torch import kernels
    from dtdl_tpu_torch.models.transformer import transformer_lm
    from dtdl_tpu_torch.obs import JsonlSeriesSink, MetricsExporter, Observer
    from dtdl_tpu_torch.serve.engine import InferenceEngine
    from dtdl_tpu_torch.serve.scheduler import Request, Scheduler
    model = transformer_lm("base", seed=seed, dtype=torch.bfloat16,
                           device=DEV)
    traffic = make_traffic(seed, model.cfg.vocab_size)
    series = os.path.join(obs_dir("serve"), "series.jsonl")

    def run(on, phase=None, traffic=traffic):
        """One serve run, observed (``on``) or not; with ``phase`` 0 or
        1, observed at the steps of that parity only, each step timed."""
        eng = InferenceEngine(model, n_slots=8, page_size=16, device=DEV)
        obs = ex = None
        if on:
            obs = Observer(trace=True, sentinel="warn")
            ex = MetricsExporter([JsonlSeriesSink(series)])
        sched = Scheduler(eng, harvest_lag=4, observer=obs, exporter=ex,
                          device=DEV)
        reqs = [Request(list(p), m) for p, m in traffic]
        sync(torch)
        kernels.reset_launches()
        where, step_s = [], []
        go = sched.run if phase is None else \
            (lambda reqs: obs_toggled(sched, reqs, phase, step_s))
        host = host_counters(torch)
        t0 = time.perf_counter()
        _, n_sync = sync_count(torch, lambda: go(reqs), where)
        sync(torch)
        wall = time.perf_counter() - t0
        host = host_counters(torch, host)
        if ex is not None:
            ex.close()
        s = sched.metrics.summary()
        return dict(wall=wall, syncs=n_sync, obs=obs, reqs=reqs, where=where,
                    tokens=sum(len(r.tokens) for r in reqs), host=host,
                    step_s=step_s, ttft=(s["ttft_s_p50"], s["ttft_s_p99"]),
                    k4=kernels.LAUNCHES["paged_attention"])

    run(False)                 # warm-up, not kept (as (a)'s first run)
    threads = sorted(t.name for t in __import__("threading").enumerate())
    runs = {True: [run(True)], False: [run(False)]}
    toggled = [run(True, phase=i % 2)
               for i in range(2 * OBS_SERVE_PAIRS)]
    pairs = [obs_step_overhead(a["step_s"], b["step_s"])
             for a, b in zip(toggled[0::2], toggled[1::2])]
    over = math.exp(median([x for p in pairs for x in p])) - 1.0
    drop = 1.0 - 1.0 / (1.0 + over)
    tps = {on: [r["tokens"] / r["wall"] for r in runs[on]] for on in runs}
    want = [r.tokens for r in runs[False][0]["reqs"]]
    every = runs[True] + runs[False] + toggled
    same = all([r.tokens for r in x["reqs"]] == want for x in every)
    syncs = {on: [r["syncs"] for r in runs[on]] for on in runs}
    syncs["toggled"] = [r["syncs"] for r in toggled]
    obs = runs[True][-1]["obs"]
    order = ["request_admitted", "request_first_token", "request_finished"]
    bad_tl = []
    for r in runs[True][-1]["reqs"]:
        tl = obs.request_timeline(r.rid)
        names = [e["name"] for e in tl if e["name"] in order]
        flows = [e["ph"] for e in tl if e.get("cat") == "request"]
        if names != order or flows != ["s", "f"]:
            bad_tl.append((r.rid, names, flows))
    points = sum(1 for _ in open(series))
    k4 = [x["k4"] for x in every]
    prefills = span_stats(obs.tracer.to_chrome()["traceEvents"], "prefill")
    log(f"obs (b) serve base bf16 page 16 (8 slots, the serve phase's 16 "
        f"requests) through Scheduler(observer=, exporter=): tokens/s of "
        f"one run observed {tps[True][0]:.2f} and one not "
        f"{tps[False][0]:.2f}; {2 * OBS_SERVE_PAIRS} runs observing every "
        f"other step (even, odd in turns; {len(toggled[0]['step_s'])} steps a "
        f"run, step seconds a run {[round(sum(x['step_s']), 4) for x in toggled]}): "
        f"observed steps' time over the same steps' unobserved, by pair "
        f"(median over the pair's adjacent even/odd steps) "
        f"{[round(100 * (math.exp(median(p)) - 1), 3) for p in pairs]}%, "
        f"pooled over the pairs {100 * over:+.3f}%: tokens/s "
        f"{100 * drop:+.3f}% below (limit {100 * OBS_LIMIT:.0f}%); "
        f"TTFT p50/p99 s on {runs[True][0]['ttft']} off "
        f"{runs[False][0]['ttft']}; greedy tokens identical in all "
        f"{len(every)} runs: {same}; synchronizations {syncs} (sites "
        f"where runs differ: {sync_sites(every)}); every rid admitted -> "
        f"first_token -> finished with its flow opened and closed: "
        f"{not bad_tl}; spans {span_counts(obs)} ({prefills}, one worker); "
        f"JSONL points {points}; K4 launches by run {k4}; host of the "
        f"toggled runs {host_sums(toggled)}; threads alive before the runs "
        f"{threads} | {card}")
    if not same:
        raise AssertionError("obs (b): tokens differ between runs")
    if drop > OBS_LIMIT:
        raise AssertionError(f"obs (b): tokens/s {100 * drop:.3f}% below")
    if len({x["syncs"] for x in every}) != 1:
        raise AssertionError(f"obs (b): synchronizations differ: {syncs}")
    if bad_tl or points < 1 or min(k4) <= 0:
        raise AssertionError(f"obs (b): timelines {bad_tl[:4]}, points "
                             f"{points}, K4 {k4}")
    del model
    torch.cuda.empty_cache()
    return runs[True][-1]["k4"]


def obs_fleet(torch, seed, card):
    """(c) the fleet under the observer, the exporter and the SLOs."""
    import urllib.request
    from dtdl_tpu_torch.models.transformer import transformer_lm
    from dtdl_tpu_torch.obs import JsonlSeriesSink, MetricsExporter, Observer
    from dtdl_tpu_torch.resil.faults import FaultPlan, replica_site
    from dtdl_tpu_torch.serve.engine import InferenceEngine
    from dtdl_tpu_torch.serve.fleet import default_fleet_slos
    model = transformer_lm("base", seed=seed, dtype=torch.bfloat16,
                           device=DEV)
    traffic = make_traffic(seed, model.cfg.vocab_size)
    eng = InferenceEngine(model, n_slots=8, page_size=16, device=DEV)
    nocache = {"prefix_cache": False}
    fleet_single(torch, eng, traffic[:2])              # warm-up
    single, _, _ = fleet_single(torch, eng, traffic, **nocache)
    d = obs_dir("fleet")

    # the fleet phase's three replicas, replica 0's worker killed, hedging
    obs = Observer(trace=True, sentinel="warn")
    path = os.path.join(d, "series.jsonl")
    ex = MetricsExporter([JsonlSeriesSink(path)])
    port = ex.serve_http(port=0)
    scrapes = []

    def scrape(router, reqs):
        time.sleep(0.3)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=5) as r:
            scrapes.append(parse_prometheus(r.read().decode()))

    def scrape_again(router):
        scrape(router, None)

    plan = FaultPlan().at(replica_site(0, "loop"), 5)
    reqs, router, s, wall, k4 = fleet_run(
        torch, eng, traffic, plan=plan, n_replicas=FLEET_REPLICAS,
        sched_kwargs=nocache, observer=obs, exporter=ex,
        slos=default_fleet_slos(ttft_p99_s=30.0, availability=0.9),
        hedge_after_s=1.0, watchdog_s=OBS_WATCHDOG, during=scrape,
        settled=scrape_again)
    ex.close()
    fleet_identical("obs (c)", reqs, single)
    trace = obs.tracer.to_chrome()["traceEvents"]
    terminals = {}
    for e in trace:
        if e["name"] == "request_done":
            rid = e["args"]["rid"]
            terminals[rid] = terminals.get(rid, 0) + 1
    dangling, late = flows_closed(trace)
    pts = [json.loads(x) for x in open(path)]
    lost = s["fleet_requests_submitted"] - s["fleet_requests_finished"]
    evicted = [e["replica"] for e in router.evict_log]
    log(f"obs (c) fleet of {FLEET_REPLICAS} replicas (base bf16 page 16, "
        f"8 slots each, the serve phase's 16 requests), replica 0's worker "
        f"killed at loop iteration 5, hedging after 1.0 s, watchdog "
        f"{OBS_WATCHDOG} s, Router(observer=, exporter=JSONL + "
        f"serve_http(0), slos=default_fleet_slos(ttft_p99_s=30, "
        f"availability=0.9)): tokens identical to one scheduler, lost "
        f"{lost}, evicted {evicted}, retries {s['fleet_retries']}, hedges "
        f"{s['fleet_hedges']}; terminals per rid "
        f"{sorted(set(terminals.values()))} over {len(terminals)} rids, "
        f"dangling flows {len(dangling)} (rids with a losing attempt's "
        f"steps after the end: {len(late)}); {span_stats(trace, 'prefill')} "
        f"over the three workers, longest worker iteration "
        f"{longest_iteration(trace)[0]:.4f} s; {len(scrapes)} scrapes parsed "
        f"({[len(x) for x in scrapes]} series, fleet_requests_submitted "
        f"{[x.get('dtdl_fleet_requests_submitted') for x in scrapes]}); "
        f"JSONL points {len(pts)}; SLO breaches {s['slo_breach_events']}; "
        f"K4 by replica {k4}; longest heartbeat gap by replica "
        f"{[round(r.max_beat_gap_s, 4) for r in router.replicas]} s; "
        f"evictions {[(e['replica'], e['reason'][:80]) for e in router.evict_log]} "
        f"| {card}")
    if lost or len(terminals) != len(traffic) or set(terminals.values()) \
            != {1} or dangling or evicted != [0] or len(scrapes) != 2 \
            or not all(scrapes) or s["slo_breach_events"]:
        raise AssertionError(f"obs (c): lost {lost}, terminals {terminals}, "
                             f"dangling {dangling}, evicted {evicted}, "
                             f"scrapes {len(scrapes)}, breaches "
                             f"{s['slo_breach_events']}")

    # a TTFT regression: replica 0's loop stalls with one request on it,
    # then waves of short requests bring the cumulative p99 back
    rng = __import__("numpy").random.default_rng(seed + 1)
    short = [(rng.integers(0, 32000, int(n)).tolist(), 8)
             for n in rng.integers(32, 65, 1 + OBS_RECOVER_WAVES * OBS_WAVE)]
    obs2 = Observer(trace=True, sentinel="warn")
    sink_path = os.path.join(d, "slo_series.jsonl")
    ex2 = MetricsExporter([JsonlSeriesSink(sink_path)], interval_s=0.05)
    plan2 = FaultPlan().at(replica_site(0, "loop"), 0, kind="stall",
                           seconds=OBS_STALL_S)

    def waves(router, first):
        if not router.wait(first, timeout_s=120):
            raise AssertionError("obs (c): the stalled request never ended")
        for w in range(OBS_RECOVER_WAVES):
            batch = fleet_requests(short[1 + w * OBS_WAVE:
                                         1 + (w + 1) * OBS_WAVE])
            for r in batch:
                router.submit(r)
            if not router.wait(batch, timeout_s=120):
                raise AssertionError("obs (c): a recovery wave hung")
            time.sleep(0.1)           # a sampled point per wave

    reqs2, router2, s2, wall2, _ = fleet_run(
        torch, eng, short[:1], plan=plan2, n_replicas=FLEET_REPLICAS,
        observer=obs2, exporter=ex2,
        slos=default_fleet_slos(ttft_p99_s=OBS_TTFT_SLO), watchdog_s=30.0,
        during=waves)
    ex2.close()
    names = [e["name"] for e in obs2.tracer.to_chrome()["traceEvents"]
             if e["name"].startswith("slo_")]
    pts2 = [json.loads(x) for x in open(sink_path)]
    oks = [p["slo_ttft_p99_ok"] for p in pts2 if "slo_ttft_p99_ok" in p]
    first_ttft = reqs2[0].t_first - reqs2[0].t_submit
    runs = []                      # the verdicts run-length encoded
    for ok in oks:
        if runs and runs[-1][0] == ok:
            runs[-1][1] += 1
        else:
            runs.append([ok, 1])
    log(f"obs (c) TTFT regression: replica 0's loop stalled {OBS_STALL_S} s "
        f"with one request on it (its TTFT {first_ttft:.3f} s against a "
        f"p99 objective of {OBS_TTFT_SLO} s), then {OBS_RECOVER_WAVES} waves "
        f"of {OBS_WAVE} short requests (32-64 prompt tokens, 8 new): trace "
        f"events {names}; series verdicts slo_ttft_p99_ok (value, points) "
        f"{runs}; breaches "
        f"{s2['slo_breach_events']} burn crossings "
        f"{s2['slo_burn_crossings']}; final fleet_ttft_s_p99 "
        f"{s2.get('fleet_ttft_s_p99')} | {card}")
    if "slo_breach" not in names or "slo_recovered" not in names or \
            names.index("slo_breach") > names.index("slo_recovered") or \
            0 not in oks or oks[-1] != 1 or oks.index(0) > \
            len(oks) - 1 - oks[::-1].index(1):
        raise AssertionError(f"obs (c): no breach then recovery: {names} "
                             f"{oks}")
    del eng, router, router2
    torch.cuda.empty_cache()
    return k4


def obs_twins(torch, seed, card):
    """(d) the twins with their observability flags, C7 at the fleet
    twin's default watchdog."""
    d = obs_dir("twins")
    trace = os.path.join(d, "fleet.json")
    series = os.path.join(d, "fleet_series.jsonl")
    text, secs = twin_main("serve_fleet", [
        *OBS_FLEET_TWIN, "--seed", str(seed), "--trace", trace,
        "--metrics-jsonl", series, "--metrics-port", "0", "--slo-ttft-p99",
        "30", "--slo-availability", "0.9"],
        os.path.join(d, "serve_fleet.log"))
    served = re.search(r"served (\d+)/(\d+) requests", text)
    gap = re.search(r"longest gap of a current worker ([\d.]+) ms", text)
    events = json.load(open(trace))["traceEvents"]
    it_s, parts = longest_iteration(events)
    evicts = re.findall(r"evicted replica \d+", text)
    log(f"obs (d) twin serve_fleet {' '.join(OBS_FLEET_TWIN)} at its default "
        f"--watchdog 0.25 with --trace --metrics-jsonl --metrics-port 0 "
        f"--slo-ttft-p99 30 --slo-availability 0.9, main() in this "
        f"process ({secs:.1f} s): "
        f"{served and served[0]}, evictions {len(evicts)}; longest worker "
        f"iteration from the trace {it_s:.4f} s (its spans' host seconds "
        f"{ {k: round(v, 4) for k, v in parts.items()} }), longest "
        f"heartbeat gap {gap and gap[1]} ms; "
        f"{sum(1 for _ in open(series))} series points; dangling flows "
        f"{len(flows_closed(events)[0])} | {card}")
    if not served or served[1] != served[2] or evicts or \
            "requests lost: 0" not in text or "scraping: curl" not in text \
            or flows_closed(events)[0]:
        raise AssertionError(f"obs (d): serve_fleet twin:\n{text[-3000:]}")
    for name, args, want in (
            ("serve_lm", OBS_SERVE_TWIN, {"admit", "prefill", "dispatch",
                                          "harvest", "drain"}),
            ("train_lm", OBS_TRAIN_TWIN, {"data", "dispatch", "drain"})):
        path = os.path.join(d, f"{name}.json")
        text, secs = twin_main(name, [*args, "--seed", str(seed), "--trace",
                                      path], os.path.join(d, f"{name}.log"))
        events = json.load(open(path))["traceEvents"]
        got = {e["name"] for e in events if e["ph"] == "X"}
        lines = [x.strip() for x in text.splitlines()
                 if re.match(r"\s*(served|ttft|trace written)", x)]
        log(f"obs (d) twin {name} {' '.join(args)} --trace: main() "
            f"returned "
            f"({secs:.1f} s), {len(events)} events, spans {sorted(got)}; "
            f"{' / '.join(lines)} | {card}")
        if not want <= got or f"trace written to {path}" not in text:
            raise AssertionError(f"obs (d): {name} trace spans {got}:\n"
                                 f"{text[-3000:]}")


def phase_obs(torch, seed, card):
    """(a) training, (b) serving, (c) the fleet, (d) the twins and C7;
    returns the K1-K4 launches of (a)'s last observed run and (b)'s."""
    t0 = time.perf_counter()
    train = obs_train(torch, seed, card)
    k4 = obs_serve(torch, seed, card)
    fleet = obs_fleet(torch, seed, card)
    obs_twins(torch, seed, card)
    log(f"obs: {time.perf_counter() - t0:.1f} s | {card}")
    return {"train": {k: train[k] for k in ("flash_fwd", "flash_bwd_dq",
                                            "flash_bwd_dkv", "rope_rows")},
            "serve": k4, "fleet": fleet}


# ---- resil: the step guard, the store and elastic training ------------------

RESIL_STEPS = 10                  # steps a run of (a)
RESIL_NAN_AT = 4                  # (a)'s NaN batch
RESIL_PAIRS = 5                   # (a)'s timed pairs, guarded and not
RESIL_TRAINER_STOP = 6            # (b)'s iterations
RESIL_ELASTIC = dict(heartbeat_s=0.03, watchdog_s=0.3, step_timeout_s=5.0,
                     join_grace_s=0.25, rendezvous_timeout_s=20.0,
                     snapshot_every=2)
RESIL_ELASTIC_STEPS, RESIL_KILL_AT = 12, 5
RESIL_TWIN_STEPS = 200            # (d): long enough to kill the store mid-run
RESIL_WATCHDOG_S = 1.0            # (e)'s bound on the stalled drain


def resil_dir(*parts) -> str:
    path = os.path.join(ROOT, "build", "resil", *parts)
    os.makedirs(path, exist_ok=True)
    return path


def resil_batches(torch, seed, n):
    """``n`` batches of the train cell on the card: TRAIN_BATCH x
    TRAIN_SEQ Markov tokens and an all-ones target mask (a NaN batch is
    ``poison_batch`` of one: its mask NaN)."""
    from dtdl_tpu_torch.data.synthetic import synthetic_lm
    tokens, _ = synthetic_lm(n_train=TRAIN_BATCH * n, n_test=TRAIN_BATCH,
                             seq_len=TRAIN_SEQ, vocab_size=32000, seed=seed)
    toks = torch.from_numpy(tokens).to(DEV, torch.long)
    mask = torch.ones(TRAIN_BATCH, TRAIN_SEQ - 1, device=DEV)
    return [{"tokens": toks[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH],
             "mask": mask} for i in range(n)]


def resil_model(torch, seed):
    """The train cell's model (base, bf16 on f32 weights) with weights
    from ``seed``, and a maker of fresh adamw states that puts those
    weights back by a copy on the card (bitwise the seeded draw, without
    drawing again)."""
    from dtdl_tpu_torch.models.transformer import transformer_lm
    from dtdl_tpu_torch.train.optim import adamw
    from dtdl_tpu_torch.train.state import init_state
    model = transformer_lm("base", max_seq=TRAIN_SEQ, seed=None, device=DEV)
    init_state(model, seed, adamw(3e-4), device=DEV)
    weights = {k: v.detach().clone() for k, v in model.state_dict().items()}

    def fresh():
        import torch as _torch
        with _torch.no_grad():
            for k, v in model.state_dict().items():
                v.copy_(weights[k])
        return init_state(model, None, adamw(3e-4), device=DEV)
    return model, fresh


def resil_step(torch, seed, card):
    """(a) the guarded base step: bitwise contracts, launches, waits and
    the guard's overhead."""
    from dtdl_tpu_torch import kernels
    from dtdl_tpu_torch.resil import StepGuard, poison_batch
    from dtdl_tpu_torch.train.step import make_lm_train_step
    batches = resil_batches(torch, seed, RESIL_STEPS)
    model, fresh = resil_model(torch, seed)

    def run(guard, stream, where=None, keep=True):
        """Fresh state from ``seed`` (the one model's weights put back),
        the steps over ``stream``: (the final state's host tree when
        ``keep``, the metrics, seconds of the steps, waits, launches,
        the state's step)."""
        state = fresh()
        step = make_lm_train_step(guard=guard)
        sync(torch)
        kernels.reset_launches()
        t0 = time.perf_counter()

        def steps():
            nonlocal state
            ms = []
            for b in stream:
                state, m = step(state, b)
                ms.append(m)
            return ms
        ms, waits = sync_count(torch, steps, where)
        sync(torch)
        secs = time.perf_counter() - t0
        return (host_tree(torch, state) if keep else None, ms, secs, waits,
                dict(kernels.LAUNCHES), state.step)

    run(StepGuard("skip"), batches[:2], keep=False)   # warm the allocators
    # the timed pairs, in turns; the first pair's states are also the
    # bitwise check's
    where, gwhere = [], []
    runs = {True: [], False: []}
    for i in range(RESIL_PAIRS):
        for on in ((True, False) if i % 2 == 0 else (False, True)):
            runs[on].append(run(StepGuard("skip") if on else None, batches,
                                gwhere if on else where, keep=i == 0))
    plain, guarded = runs[False][0], runs[True][0]
    ms = {on: [1e3 * r[2] / RESIL_STEPS for r in runs[on]] for on in runs}
    over = median([a / b - 1.0 for a, b in zip(ms[True], ms[False])])
    differ = tree_diff(torch, plain[0], guarded[0])
    nan = [poison_batch(b) if i == RESIL_NAN_AT else b
           for i, b in enumerate(batches)]
    guard = StepGuard("skip")
    skipped = run(guard, nan)
    for m in skipped[1]:
        guard.observe({k: float(v) for k, v in m.items()})
    flags = [float(m["bad_step"]) for m in skipped[1]]
    dropped = run(None, [b for i, b in enumerate(batches)
                         if i != RESIL_NAN_AT])
    differ_skip = tree_diff(torch, skipped[0], dropped[0])
    steps_applied = skipped[5]
    want = model.cfg.n_layers * RESIL_STEPS
    every = [("plain", r) for r in runs[False]] + \
        [("guarded", r) for r in runs[True]] + [("skip", skipped)]
    bad_launch = [(name, r[4]) for name, r in every
                  if any(r[4][k] != want for k in ("flash_fwd",
                                                   "flash_bwd_dq",
                                                   "flash_bwd_dkv"))
                  or r[4]["rope_rows"] != 4 * want]
    log(f"resil (a) guarded base step bf16 (f32 weights) adamw(3e-4) "
        f"{TRAIN_BATCH}x{TRAIN_SEQ}, {RESIL_STEPS} steps a run: no fault "
        f"bitwise the unguarded run: {not differ} (differ {differ[:4]}); "
        f"NaN batch at step {RESIL_NAN_AT} under skip: flags {flags}, "
        f"guard n_bad {guard.n_bad}, state.step {steps_applied}, bitwise "
        f"the run with that batch dropped: {not differ_skip} (differ "
        f"{differ_skip[:4]}); waits a run unguarded "
        f"{[r[3] for r in runs[False]]} guarded "
        f"{[r[3] for r in runs[True]]} (sites where they differ "
        f"{sync_sites([{'where': where}, {'where': gwhere}])}); "
        f"launches plain {plain[4]} guarded {guarded[4]} skip "
        f"{skipped[4]}; step_ms guarded {[round(x, 3) for x in ms[True]]}"
        f" unguarded {[round(x, 3) for x in ms[False]]}, overhead (median "
        f"of {RESIL_PAIRS} pairs) {100 * over:+.3f}% | {card}")
    if differ or differ_skip:
        raise AssertionError(f"resil (a): not bitwise: no fault {differ[:8]}"
                             f", skip {differ_skip[:8]}")
    if flags != [float(i == RESIL_NAN_AT) for i in range(RESIL_STEPS)] or \
            steps_applied != RESIL_STEPS - 1 or guard.n_bad != 1:
        raise AssertionError(f"resil (a): flags {flags}, step "
                             f"{steps_applied}, n_bad {guard.n_bad}")
    waits = {r[3] for on in runs for r in runs[on]}
    if len(waits) != 1:
        raise AssertionError(f"resil (a): waits differ: "
                             f"{[r[3] for r in runs[True]]} guarded, "
                             f"{[r[3] for r in runs[False]]} unguarded")
    if bad_launch:
        raise AssertionError(f"resil (a): launches {bad_launch}, want "
                             f"{want} each and rope {4 * want}")
    del plain, runs, skipped, dropped, model, fresh
    gc.collect()
    torch.cuda.empty_cache()
    return guarded[4]


def resil_trainer(torch, seed, card):
    """(b) Trainer(guard=StepGuard("rollback")) at base width: a 2-step NaN
    burst restores the last good snapshot and the run continues, bitwise
    the stream with the first burst batch dropped; a second burst past
    max_rollbacks escalates by name."""
    import shutil
    import numpy as np
    from dtdl_tpu_torch.data.loader import DataLoader
    from dtdl_tpu_torch.data.synthetic import synthetic_lm
    from dtdl_tpu_torch.resil import (FaultPlan, GuardEscalationError,
                                      LoaderFaults, StepGuard)
    from dtdl_tpu_torch.ckpt import Checkpointer
    from dtdl_tpu_torch.train import Trainer, make_lm_train_step, snapshot
    n = RESIL_TRAINER_STOP
    tokens, _ = synthetic_lm(n_train=TRAIN_BATCH * n, n_test=TRAIN_BATCH,
                             seq_len=TRAIN_SEQ, vocab_size=32000, seed=seed)
    data = {"tokens": tokens,
            "mask": np.ones((len(tokens), TRAIN_SEQ - 1), np.float32)}
    model, fresh = resil_model(torch, seed)

    def trainer(out, guard, plan):
        shutil.rmtree(out, ignore_errors=True)
        loader = DataLoader(data, TRAIN_BATCH, shuffle=False, device=DEV)
        tr = Trainer(fresh(),
                     make_lm_train_step(guard=guard),
                     LoaderFaults(loader, plan), None,
                     stop_trigger=(1, "epoch"), out=out, guard=guard)
        tr.ckpt = Checkpointer(out, keep=2)    # the last good one suffices
        tr.extend(snapshot(), trigger=(1, "iteration"))
        return tr

    t0 = time.perf_counter()
    guard = StepGuard("rollback", max_consecutive=2)
    tr = trainer(resil_dir("trainer_a"), guard,
                 FaultPlan().at("loader", 3, "nan").at("loader", 4, "nan"))
    tr.run()
    got = host_tree(torch, tr.state)
    secs = time.perf_counter() - t0
    from dtdl_tpu_torch.train.step import make_lm_train_step as mk
    ref = fresh()
    step = mk()
    loader = DataLoader(data, TRAIN_BATCH, shuffle=False, device=DEV)
    for i, b in enumerate(iter(loader)):
        if i != 3:
            ref, _ = step(ref, b)
    differ = tree_diff(torch, got, host_tree(torch, ref))
    guard2 = StepGuard("rollback", max_consecutive=1, max_rollbacks=1)
    tr2 = trainer(resil_dir("trainer_b"), guard2,
                  # the second burst lands in the replay, past the
                  # batches the first pass had prefetched
                  FaultPlan().at("loader", 2, "nan").at("loader", 6, "nan"))
    try:
        tr2.run()
        escalated = None
    except GuardEscalationError as e:
        escalated = str(e)
    log(f"resil (b) Trainer(guard=StepGuard('rollback', max_consecutive=2)) "
        f"base bf16 {TRAIN_BATCH}x{TRAIN_SEQ}, a snapshot every iteration, "
        f"NaN batches at loader occurrences 3 and 4: rollbacks "
        f"{guard.n_rollbacks}, bad {guard.n_bad}, finished epoch "
        f"{tr.epoch} at iteration {tr.iteration}, bitwise the stream "
        f"without batch 3: {not differ} (differ {differ[:4]}) in "
        f"{secs:.1f}s; max_rollbacks=1 with a second burst escalates: "
        f"{escalated!r} (rollbacks {guard2.n_rollbacks}) | {card}")
    if guard.n_rollbacks != 1 or guard.n_bad != 2 or tr.epoch != 1 or \
            differ:
        raise AssertionError(f"resil (b): rollbacks {guard.n_rollbacks}, "
                             f"bad {guard.n_bad}, epoch {tr.epoch}, differ "
                             f"{differ[:8]}")
    if not escalated or "rollbacks exceeded" not in escalated:
        raise AssertionError(f"resil (b): no escalation: {escalated!r}")
    del tr, tr2, ref, model, fresh
    gc.collect()
    torch.cuda.empty_cache()
    for x in ("trainer_a", "trainer_b"):
        shutil.rmtree(resil_dir(x), ignore_errors=True)


def elastic_latencies(victim, survivors) -> dict:
    """Seconds from the victim's death to the first survivor's detection,
    from there to the re-formed world, and to its first applied step."""
    def first(w, name, after=0.0):
        return min(t for n, t, _ in w.events if n == name and t >= after)
    lost = min(first(w, "peer_lost") for w in survivors)
    world = max(first(w, "world", lost) for w in survivors)
    step = max(first(w, "applied", world) for w in survivors)
    return {"detect_s": lost - victim.stopped_t, "reform_s": world - lost,
            "first_step_s": step - world}


def resil_workers(torch, seed, card):
    """(c) run_workers: four elastic workers (the elastic_train twin's
    MLP) on the card, rank 2 crashed at step RESIL_KILL_AT."""
    import numpy as np
    from dtdl_tpu_torch.data.sharding import GlobalBatchSampler
    from dtdl_tpu_torch.examples import elastic_train as twin
    from dtdl_tpu_torch.parallel.kvstore import HostKVStore, RetryingStore
    from dtdl_tpu_torch.resil import (ElasticConfig, ElasticWorker,
                                      FaultPlan, effective_sample_log,
                                      peer_site, run_workers)
    import shutil
    problem = twin.make_problem(seed, DEV)
    sampler = GlobalBatchSampler(twin.N_EXAMPLES, 12 * 8, seed=seed)
    ck = resil_dir("elastic")
    shutil.rmtree(ck, ignore_errors=True)
    os.makedirs(ck)

    def workers(store, ranks, ckpt_dir=None):
        return [ElasticWorker(RetryingStore(store), r, sampler=sampler,
                              total_steps=RESIL_ELASTIC_STEPS,
                              cfg=ElasticConfig(**RESIL_ELASTIC),
                              ckpt_dir=ckpt_dir, audit_samples=True,
                              **problem) for r in ranks]
    plan = FaultPlan().at(peer_site(2, "step"), RESIL_KILL_AT, "crash")
    with plan:
        ws = workers(HostKVStore(), [0, 1, 2, 3], ck)
        run_workers(ws, timeout_s=60)
    victim, survivors = ws[2], [ws[0], ws[1], ws[3]]
    lat = elastic_latencies(victim, survivors)
    restored = [info["step"] for n, _, info in survivors[0].events
                if n == "restore"]
    ok = all(w.done and w.world.ranks == (0, 1, 3) for w in survivors)
    store = HostKVStore()
    if restored:
        store.set("ckpt/committed",
                  {"step": restored[0],
                   "path": os.path.join(
                       ck, f"elastic_{restored[0]:06d}.msgpack")})
    oracle = workers(store, [0, 1, 3])
    run_workers(oracle, timeout_s=60)
    differ = [k for a, b in zip(survivors, oracle)
              for k in a.state["params"]
              if not torch.equal(a.state["params"][k], b.state["params"][k])]
    eff = effective_sample_log(ws)
    audit = sorted(eff) == list(range(RESIL_ELASTIC_STEPS)) and all(
        np.array_equal(v, np.sort(sampler.batch_indices(s)))
        for s, v in eff.items())
    log(f"resil (c) run_workers: 4 elastic workers (MLP(32) on the card, "
        f"global batch 96), rank 2 crashed at step {RESIL_KILL_AT}: "
        f"survivors done in world {survivors[0].world.ranks} generation "
        f"{survivors[0].world.generation}: {ok}; restored step "
        f"{restored}; bitwise the fault-free world of 3 from the same "
        f"snapshot: {not differ and bool(restored)}; zero samples lost or "
        f"counted twice: {audit}; detect {lat['detect_s']:.4f}s, re-form "
        f"{lat['reform_s']:.4f}s, first step {lat['first_step_s']:.4f}s "
        f"(watchdog {RESIL_ELASTIC['watchdog_s']}s) | {card}")
    if not ok or differ or not restored or not audit:
        raise AssertionError(f"resil (c): survivors {ok}, restored "
                             f"{restored}, differ {differ[:4]}, audit "
                             f"{audit}")
    return lat


def spawn_store(port, wal, ready=True):
    """A standalone coordinator process (``python -m
    dtdl_tpu_torch.parallel.tcpstore``) and its ready line (``None`` when
    not waited for)."""
    p = subprocess.Popen(
        [sys.executable, "-m", "dtdl_tpu_torch.parallel.tcpstore",
         "--port", str(port), "--wal-dir", wal], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": ROOT}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    if not ready:
        return p, None
    line = p.stdout.readline()
    if "STORE ready" not in line:
        p.kill()
        raise AssertionError(f"resil (d): the coordinator said {line!r}")
    return p, line


def resil_launcher(torch, seed, card):
    """(d) the launcher drill: a standalone coordinator with a WAL, the
    elastic_train twin's four worker processes on the card through
    launch_local(store_port=, elastic=True); rank 2 SIGKILLed, then the
    coordinator SIGKILLed after the shrink and restarted from its WAL;
    then an amnesiac restart refused by name.  (e) runs meanwhile."""
    import shutil
    import numpy as np
    from dtdl_tpu_torch.data.sharding import GlobalBatchSampler
    from dtdl_tpu_torch.examples import elastic_train as twin
    from dtdl_tpu_torch.parallel.kvstore import HostKVStore, RetryingStore
    from dtdl_tpu_torch.parallel.tcpstore import (ServerEpochError,
                                                  TCPStoreClient,
                                                  TCPStoreServer)
    from dtdl_tpu_torch.resil import (ElasticConfig, ElasticWorker,
                                      run_workers)
    root = resil_dir("launcher")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    wal, ck, out = (os.path.join(root, x) for x in ("wal", "ck", "out"))
    port = free_port()
    t0 = time.perf_counter()
    # the coordinator starts beside the workers (each worker's connect
    # budget outlasts its start)
    store, _ = spawn_store(port, wal, ready=False)
    argv = ["-m", "dtdl_tpu_torch.examples.elastic_train", "--steps",
            str(RESIL_TWIN_STEPS), "--seed", str(seed), "--ckpt-dir", ck,
            "--out-dir", out, "--kill-rank", "2", "--kill-at",
            str(RESIL_KILL_AT), "--heartbeat-s", "0.05", "--watchdog-s",
            "0.5", "--join-grace-s", "0.5", "--step-timeout-s", "30"]
    logpath = os.path.join(root, "launch.log")
    with open(logpath, "w") as f:
        # its own session, so that a failure below can stop the launcher
        # and its workers together
        launcher = subprocess.Popen(
            [sys.executable, "-m", "dtdl_tpu_torch.launch.local", "--nproc",
             "4", "--port", str(free_port()), "--store-port", str(port),
             "--elastic", "--timeout", "240", "--", *argv], cwd=ROOT,
            env={**os.environ, "PYTHONPATH": ROOT}, stdout=f,
            stderr=subprocess.STDOUT, start_new_session=True)
    import threading
    wd = {}

    def side_run():
        try:
            wd.update(resil_watchdog_world(torch, seed, card))
        except Exception as e:       # raised in the phase's thread below
            wd["exc"] = e
    side = threading.Thread(target=side_run, daemon=True)
    side.start()                                  # (e) meanwhile
    killed_at = restarted = None
    try:
        ready = store.stdout.readline()           # the coordinator is up
        if "STORE ready" not in ready:
            raise AssertionError(f"resil (d): the coordinator said "
                                 f"{ready!r}")
        watcher = TCPStoreClient(f"127.0.0.1:{port}", reconnect_attempts=30,
                                 max_backoff_s=0.2, io_timeout_s=10.0)
        deadline = time.monotonic() + 200
        while killed_at is None:
            latest = watcher.get("world/latest", None)
            done = watcher.get("ckpt/committed", {"step": 0})["step"]
            if latest and latest[0] >= 1 and done >= 20:
                store.kill()
                store.wait(timeout=10)
                killed_at = done
                t_kill = time.perf_counter()
                store, ready = spawn_store(port, wal)
                restarted = (time.perf_counter() - t_kill,
                             "recovered=True" in ready)
            elif launcher.poll() is not None or \
                    time.monotonic() > deadline:
                break
            time.sleep(0.01)
        rc = launcher.wait(timeout=240)
        side.join(120)
        if "exc" in wd:
            raise wd["exc"]
        amnesia = None
        store.kill()
        store.wait(timeout=10)
        # a coordinator without its WAL on the same port (in this
        # process: the same server code without a second interpreter)
        blank = TCPStoreServer(port=port, wal_dir=os.path.join(
            root, "empty_wal")).start()
        try:
            watcher.get("world/latest")
        except ServerEpochError as e:
            amnesia = str(e)
        finally:
            blank.stop()
    finally:
        store.kill()
        store.wait(timeout=10)
        if launcher.poll() is None:
            import signal
            os.killpg(launcher.pid, signal.SIGKILL)
            launcher.wait(timeout=10)
    text = open(logpath).read()
    res = {}
    for r in (0, 1, 3):
        path = os.path.join(out, f"result_{r}.json")
        res[r] = json.load(open(path)) if os.path.exists(path) else None
    ok = all(x and x["done"] and x["generation"] == 1 and
             x["ranks"] == [0, 1, 3] for x in res.values())
    restored = {x["restored_step"] for x in res.values() if x}
    reconnects = sum(x["reconnects"] for x in res.values() if x)
    # the journals: zero lost or counted twice across both kills
    top, logs = {}, {}
    for r in range(4):
        path = os.path.join(out, f"samples_{r}.jsonl")
        for line in (open(path) if os.path.exists(path) else ()):
            rec = json.loads(line)
            logs[(r, rec["gen"], rec["step"])] = rec["idx"]
            top[rec["step"]] = max(top.get(rec["step"], rec["gen"]),
                                   rec["gen"])
    sampler = GlobalBatchSampler(twin.N_EXAMPLES, 12 * 8, seed=seed)
    audit = sorted(top) == list(range(RESIL_TWIN_STEPS)) and all(
        np.array_equal(np.sort(np.concatenate(
            [np.asarray(logs[(r, g, s)]) for r in range(4)
             if (r, g, s) in logs])), np.sort(sampler.batch_indices(s)))
        for s, g in top.items())
    # bitwise against the world of 3 run in this process from the same
    # committed snapshot
    differ = ["no result"]
    if ok and len(restored) == 1:
        step0 = restored.pop()
        hs = HostKVStore()
        hs.set("ckpt/committed", {"step": step0, "path": os.path.join(
            ck, f"elastic_{step0:06d}.msgpack")})
        problem = twin.make_problem(seed, DEV)
        oracle = [ElasticWorker(RetryingStore(hs), r, sampler=sampler,
                                total_steps=RESIL_TWIN_STEPS,
                                cfg=ElasticConfig(heartbeat_s=0,
                                                  join_grace_s=0.2),
                                **problem) for r in (0, 1, 3)]
        run_workers(oracle, timeout_s=120)
        differ = [k for r in (0, 1, 3) for k, v in torch.load(
            os.path.join(out, f"final_{r}.pt")).items()
            if not torch.equal(v, oracle[0].state["params"][k].cpu())]
    secs = time.perf_counter() - t0
    log(f"resil (d) launcher drill: coordinator `python -m "
        f"dtdl_tpu_torch.parallel.tcpstore` with a WAL, elastic_train's 4 "
        f"workers on the card through launch_local(store_port=, "
        f"elastic=True), {RESIL_TWIN_STEPS} steps: rank 2 SIGKILLed at step "
        f"{RESIL_KILL_AT} ({'rank 2 lost to signal 9' in text}); survivors "
        f"done in generation 1 [0, 1, 3]: {ok}; the coordinator SIGKILLed "
        f"after the shrink at committed step {killed_at}, restarted from its "
        f"WAL in {restarted and round(restarted[0], 3)}s (recovered "
        f"{restarted and restarted[1]}), worker reconnects {reconnects}; "
        f"launch rc {rc}; zero lost/doubled: {audit}; bitwise "
        f"the in-process world of 3 from the same snapshot: {not differ}; "
        f"an amnesiac restart refused: {amnesia and amnesia[:90]!r}; "
        f"{secs:.1f}s | {card}")
    if not (ok and rc == 0 and killed_at and restarted
            and restarted[1] and audit and not differ and reconnects >= 1
            and amnesia and "WITHOUT its WAL" in amnesia and wd):
        raise AssertionError(f"resil (d): results {res}, rc {rc},"
                             f" killed {killed_at}, restarted {restarted}, "
                             f"audit {audit}, differ {differ[:4]}, amnesia "
                             f"{amnesia!r}:\n{text[-3000:]}")
    return wd


def resil_watchdog_world(torch, seed, card):
    """(e) StepWatchdog on a two-rank gloo world on the card: rank 1
    stalls; rank 0's DDP step and drain under the watchdog must raise
    PeerLostError within RESIL_WATCHDOG_S (plus slack)."""
    me = os.path.join(ROOT, "chip_smoke.py")
    rc, out, secs = launch([me, "--ddp-worker", "resil_watchdog", "--seed",
                            str(seed)], 2, 120, "resil_watchdog")
    got = rank_lines(out, "resil_result ")
    r = got.get(0, {})
    log(f"resil (e) StepWatchdog({RESIL_WATCHDOG_S}s) on a gloo world of 2 "
        f"on the card, rank 1 stalled: rank 0 {r.get('error')!r} after "
        f"{r.get('waited_s', math.nan):.3f}s; afterwards a fresh op on the "
        f"card from the main thread {r.get('after')}; launch rc {rc} in "
        f"{secs:.1f}s | {card}")
    if rc != 0 or "PeerLostError" not in str(r.get("error")) or \
            not r.get("waited_s", 99) < RESIL_WATCHDOG_S + 1.0:
        raise AssertionError(f"resil (e): {got}\n{out[-3000:]}")
    return r


def resil_worker(args) -> int:
    """One rank of (e)'s gloo world on the card."""
    import torch
    sys.path.insert(0, ROOT)
    from dtdl_tpu_torch.metrics.device import MetricsQueue
    from dtdl_tpu_torch.models import MLP
    from dtdl_tpu_torch.parallel import DataParallel
    from dtdl_tpu_torch.resil import PeerLostError, StepWatchdog
    from dtdl_tpu_torch.runtime import build_mesh, initialize
    from dtdl_tpu_torch.train import init_state, make_train_step
    from dtdl_tpu_torch.train.optim import sgd
    initialize(args.coordinator, args.num_processes, args.process_id,
               backend="gloo", timeout_s=120,
               device="cpu" if DEV == "cpu" else None)
    dp = DataParallel(build_mesh())
    state = dp.replicate(init_state(MLP(device=DEV), args.seed, sgd(0.1),
                                    device=DEV))
    step = make_train_step(dp)
    batch = {"image": torch.randn(32, 784, device=DEV),
             "label": torch.zeros(32, dtype=torch.long, device=DEV)}
    queue = MetricsQueue(4)
    state, m = step(state, batch)                  # both ranks, once
    queue.push(m)
    queue.drain()
    if args.process_id == 1:
        time.sleep(RESIL_WATCHDOG_S + 3)           # the stalled peer
        os._exit(0)

    def step_and_drain():
        queue.push(step(state, batch)[1])
        return queue.drain()
    t0 = time.perf_counter()
    try:
        StepWatchdog(RESIL_WATCHDOG_S, name="drain").run(step_and_drain)
        error = None
    except PeerLostError as e:
        error = f"PeerLostError: {e}"
    waited = time.perf_counter() - t0
    try:
        after = float((torch.ones(4, device=DEV) * 2).sum())
        after = f"completes ({after})"
    except Exception as e:
        after = f"fails: {type(e).__name__}"
    print("resil_result " + json.dumps({"error": error, "waited_s": waited,
                                        "after": after}), flush=True)
    os._exit(0)    # the abandoned collective still waits on its thread


def phase_resil(torch, seed, card):
    """(a)-(e) of the resilience phase (module docstring)."""
    t0 = time.perf_counter()
    sub_s, out = {}, {}
    for name, fn in (("step", resil_step), ("trainer", resil_trainer),
                     ("workers", resil_workers),
                     ("launcher+watchdog", resil_launcher)):
        t1 = time.perf_counter()
        out[name] = fn(torch, seed, card)
        sub_s[name] = round(time.perf_counter() - t1, 1)
    log(f"resil phase: {time.perf_counter() - t0:.1f}s, by part {sub_s}")
    return out["step"]


# ---------------------------------------------------------------------------
# phase 7o: the port's audit
# ---------------------------------------------------------------------------

AUDIT_UNROLL = 4
AUDIT_STEPS = 10                  # bundles of 4, 4 and 2
AUDIT_VERIFY_K = 2
AUDIT_POS = [100, 250, 400, 550, 700, 850, 1000, 1050]   # K4's decode rows
AUDIT_LORA = dict(lora_rank=16, lora_adapters=4)


class StepRecorder:
    """Every drained per-step metric dict, in step order (a guard's
    ``observe`` seat in train_epoch)."""

    def __init__(self):
        self.steps = []

    def observe(self, vals):
        self.steps.append(dict(vals))


def audit_unroll(torch, seed, card):
    """(a) train_epoch(unroll=4) against unroll=1 on the train cell."""
    from dtdl_tpu_torch import kernels
    from dtdl_tpu_torch.data.loader import DataLoader
    from dtdl_tpu_torch.data.synthetic import synthetic_lm
    from dtdl_tpu_torch.train.loop import train_epoch
    from dtdl_tpu_torch.train.step import make_lm_train_step
    tokens, _ = synthetic_lm(n_train=TRAIN_BATCH * AUDIT_STEPS,
                             n_test=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                             vocab_size=32000, seed=seed)
    model, fresh = resil_model(torch, seed)
    step = make_lm_train_step()
    runs = {}
    # warm-up: cuBLAS handles, the allocator's blocks, the pinned staging
    warm = DataLoader({"tokens": tokens[:2 * TRAIN_BATCH]}, TRAIN_BATCH,
                      shuffle=False, device=DEV)
    train_epoch(step, fresh(), warm)
    sync(torch)
    for k in (1, AUDIT_UNROLL):
        state = fresh()
        rec = StepRecorder()
        loader = DataLoader({"tokens": tokens}, TRAIN_BATCH, shuffle=False,
                            device=DEV)
        kernels.reset_launches()
        t0 = time.perf_counter()
        state, means = train_epoch(step, state, loader, guard=rec, unroll=k,
                                   log_interval=AUDIT_STEPS)
        sync(torch)
        wall = time.perf_counter() - t0
        runs[k] = dict(steps=rec.steps, means=means,
                       step_ms=1e3 * wall / AUDIT_STEPS,
                       launches=dict(kernels.LAUNCHES),
                       weights={n: v.detach().cpu().clone() for n, v in
                                model.state_dict().items()})
        del state
    a, b = runs[1], runs[AUDIT_UNROLL]
    same_metrics = a["steps"] == b["steps"] and a["means"] == b["means"]
    same_weights = all(torch.equal(a["weights"][n], b["weights"][n])
                       for n in a["weights"])
    want = model.cfg.n_layers * AUDIT_STEPS
    k123 = {r: {n: runs[r]["launches"][n] for n in
                ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "rope_rows")}
            for r in runs}
    log(f"audit (a) train base bf16 (f32 weights) adamw(3e-4) {TRAIN_BATCH}x"
        f"{TRAIN_SEQ}, {AUDIT_STEPS} batches: train_epoch unroll=1 step_ms="
        f"{a['step_ms']:.3f} unroll={AUDIT_UNROLL} (bundles 4, 4, 2) step_ms="
        f"{b['step_ms']:.3f}; per-step metrics bitwise equal {same_metrics} "
        f"({len(b['steps'])} steps, loss first {b['steps'][0]['loss']:.6f} "
        f"last {b['steps'][-1]['loss']:.6f}), final f32 weights bitwise "
        f"equal {same_weights}; launches {k123} | {card}")
    if len(a["steps"]) != AUDIT_STEPS or not same_metrics:
        raise AssertionError(f"audit (a): per-step metrics differ: "
                             f"{a['steps']} vs {b['steps']}")
    if not same_weights:
        raise AssertionError("audit (a): final weights differ between "
                             "unroll=1 and unroll=4")
    for r in runs:
        got = k123[r]
        if any(got[n] != want for n in ("flash_fwd", "flash_bwd_dq",
                                        "flash_bwd_dkv")) \
                or got["rope_rows"] != 4 * want:
            raise AssertionError(f"audit (a): unroll={r} launches {got}, "
                                 f"want {want} each and rope {4 * want}")
    del runs, model
    torch.cuda.empty_cache()
    return {f"unroll={r}": k123[r] for r in k123}


def audit_engine_call(torch, eng, method, **kw):
    """``call`` and ``kept`` of ``eng.<method>`` over all 8 slots at K4's
    decode rows (AUDIT_POS), each slot on its own live pages."""
    import numpy as np
    b = eng.n_slots
    arena, last = eng.init_arena(), eng.init_last_tokens()
    pos = torch.tensor(AUDIT_POS, dtype=torch.int32, device=DEV)
    tables = (1 + np.arange(b * eng.n_ptab, dtype=np.int32)
              .reshape(b, eng.n_ptab))
    knobs = dict(active=np.ones(b, bool), temp=np.zeros(b, np.float32),
                 top_k=np.zeros(b, np.int32), top_p=np.ones(b, np.float32),
                 page_tables=tables)
    holder = {"arena": arena, "last": last}

    def call():
        # the index stays at AUDIT_POS: every call attends the same rows
        holder["arena"]["index"] = pos
        out = getattr(eng, method)(holder["arena"], holder["last"], **kw,
                                   **knobs)
        holder["arena"], holder["last"] = out[0], out[1]

    return call, lambda: [t for _, t in eng._pool_leaves(holder["arena"])]


def audit_counted(torch, call, names):
    """``call`` wrapped to record each call's launches of ``names``."""
    from dtdl_tpu_torch import kernels
    per_call = []

    def run():
        before = {n: kernels.LAUNCHES[n] for n in names}
        call()
        per_call.append({n: kernels.LAUNCHES[n] - before[n] for n in names})
    return run, per_call


def audit_programs_card(torch, seed, card):
    """(b) the program audit at full width, then the contracts."""
    import numpy as np
    from dtdl_tpu_torch.analysis import contracts
    from dtdl_tpu_torch.analysis.program_audit import audit_program
    from dtdl_tpu_torch.models.transformer import transformer_lm
    from dtdl_tpu_torch.serve.engine import InferenceEngine
    from dtdl_tpu_torch.train.step import make_lm_train_step
    model = transformer_lm("base", seed=seed, dtype=torch.bfloat16,
                           device=DEV)
    eng = InferenceEngine(model, n_slots=8, page_size=16, device=DEV)
    lora = InferenceEngine(model, n_slots=8, page_size=16, device=DEV,
                           **AUDIT_LORA)
    k = AUDIT_VERIFY_K
    programs = {
        "serve_decode": audit_engine_call(torch, eng, "decode"),
        "serve_verify": audit_engine_call(
            torch, eng, "verify", draft_tokens=np.ones((8, k), np.int32),
            draft_len=np.full(8, k, np.int32)),
        "serve_lora_decode": audit_engine_call(
            torch, lora, "decode",
            adapter_ids=np.arange(8, dtype=np.int64) % 3 + 1),
    }
    reports, launches = {}, {}
    for name, (call, kept) in programs.items():
        run, per_call = audit_counted(torch, call, ("paged_attention",))
        rep = audit_program(run, name=name, kept=kept, warmup=1)
        reports[name], launches[name] = rep, per_call[-1]
    del programs, eng, lora, model
    torch.cuda.empty_cache()
    # the train cell's step, on its own batch
    tmodel, fresh = resil_model(torch, seed)
    holder = {"state": fresh()}
    batch = resil_batches(torch, seed, 1)[0]
    step = make_lm_train_step()

    def train_call():
        holder["state"], _ = step(holder["state"], batch)

    def train_kept():
        st = holder["state"]
        out = list(st.model.parameters())
        for v in st.optimizer.state.values():
            out.extend(t for t in v.values()
                       if isinstance(t, torch.Tensor) and t.dim() > 0)
        return out

    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "rope_rows")
    run, per_call = audit_counted(torch, train_call, names)
    reports["train_step (base)"] = audit_program(
        run, name="train_step (base)", kept=train_kept, warmup=1)
    launches["train_step (base)"] = per_call[-1]
    n_layers = tmodel.cfg.n_layers
    del holder, tmodel, fresh, batch
    torch.cuda.empty_cache()
    for name, rep in reports.items():
        c = rep.census
        log(f"audit (b) {name} at full width: collectives "
            f"{c['collectives']} c10d {c['c10d_collectives']} host_syncs="
            f"{c['host_syncs']} {c['host_sync_ops']} d2h_copies="
            f"{c['d2h_copies']} h2d_uploads={c['h2d_uploads']} "
            f"bf16_to_f32_casts={c['bf16_to_f32_casts']} storage_kept="
            f"{c['storage_kept']} cuda_syncs={c['cuda_syncs']} launches "
            f"{launches[name]} findings {[f.render() for f in rep.findings]}"
            f" | {card}")
    bad = {n: [f.render() for f in r.findings] for n, r in reports.items()
           if r.findings or r.census["host_syncs"]
           or r.census["d2h_copies"] or not r.census["storage_kept"]
           or r.census["cuda_syncs"]}
    if bad:
        raise AssertionError(f"audit (b): findings {bad}")
    for name in ("serve_decode", "serve_verify", "serve_lora_decode"):
        if launches[name]["paged_attention"] != n_layers:
            raise AssertionError(f"audit (b): {name} launched K4 "
                                 f"{launches[name]} times, want {n_layers}")
    got = launches["train_step (base)"]
    if any(got[n] != n_layers for n in names[:3]) \
            or got["rope_rows"] != 4 * n_layers:
        raise AssertionError(f"audit (b): the train step launched {got}, "
                             f"want {n_layers} each and rope "
                             f"{4 * n_layers}")
    # the contracts' single-process programs at their tiny geometry
    runnable, skipped = contracts.runnable_programs()
    tiny = contracts.audit_programs(runnable, device=DEV)
    drift = contracts.compare_to_baseline(tiny, contracts.load_baseline())
    found = [f.render() for r in tiny.values() for f in r["_findings"]]
    log(f"audit (b) contracts at their tiny geometry on the card: "
        + "; ".join(f"{n}: collectives {r['collectives']} host_syncs="
                    f"{r['host_syncs']} d2h_copies={r['d2h_copies']} "
                    f"storage_kept={r['storage_kept']} cuda_syncs="
                    f"{r['cuda_syncs']}" for n, r in tiny.items())
        + f"; skipped {skipped}; drift {[f.render() for f in drift]}")
    if drift or found:
        raise AssertionError(f"audit (b): contracts drift {drift} "
                             f"findings {found}")
    return launches


def audit_lint(card):
    """(c) the linter over the port and this script."""
    from dtdl_tpu_torch.analysis import lint_paths, render_report
    t0 = time.perf_counter()
    found = lint_paths([os.path.join(ROOT, "dtdl_tpu_torch"),
                        os.path.join(ROOT, "chip_smoke.py")], root=ROOT)
    log(f"audit (c) lint dtdl_tpu_torch/ and chip_smoke.py: "
        f"{len(found)} unsuppressed findings in "
        f"{time.perf_counter() - t0:.2f}s")
    if found:
        raise AssertionError("audit (c):\n" + render_report(found))


def phase_audit(torch, seed, card):
    """(a)-(c) of the audit phase (module docstring); returns the kernels'
    launches by program."""
    t0 = time.perf_counter()
    sub_s = {}
    t1 = time.perf_counter()
    unroll_launches = audit_unroll(torch, seed, card)
    sub_s["unroll"] = round(time.perf_counter() - t1, 1)
    t1 = time.perf_counter()
    launches = audit_programs_card(torch, seed, card)
    sub_s["programs"] = round(time.perf_counter() - t1, 1)
    t1 = time.perf_counter()
    audit_lint(card)
    sub_s["lint"] = round(time.perf_counter() - t1, 1)
    log(f"audit phase: {time.perf_counter() - t0:.1f}s, by part {sub_s}")
    return {**unroll_launches, **launches}


def phase_profile_fourd(torch, seed, steps: int = 2):
    """Where the fourd phase's 4D step's device time goes (torch.profiler):
    the dense base-width 1F1B step and the routed top-2 MoE one, each by
    range (the head, the attention, the MLP or MoE layer: forwards and
    recomputes, each wrapped in a record_function range here; the
    backwards run inside autograd) and by kernel."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile
    from dtdl_tpu_torch.parallel import megatron as M
    from dtdl_tpu_torch.train.optim import adamw
    parts = {"head fwd": "_head_loss", "attention fwd": "_attention",
             "dense MLP fwd": "_mlp_dense", "MoE layer fwd": "_mlp_moe_routed"}
    saved = {name: getattr(M, attr) for name, attr in parts.items()}

    def ranged(name, fn):
        def wrapper(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return wrapper
    batches = fourd_batches(seed, steps + 2, TRAIN_BATCH, TRAIN_SEQ,
                            FOURD_WIDTHS["vocab_size"])
    for label, kw in (("dense", {}),
                      ("moe routed top-2 E=8", dict(
                          n_experts=8, moe_dispatch="routed", moe_top_k=2,
                          capacity_factor=1.25))):
        cfg = fourd_cfg(torch, **kw)
        mesh = M.build_4d_mesh()
        p = M.place_params(mesh, cfg, M.init_params(cfg, seed), device=DEV)
        tx = adamw(3e-4)
        opt = M.init_optimizer(cfg, mesh, tx, p)
        step = M.make_megatron_train_step(cfg, mesh, tx)
        hosts = [M.shard_lm_batch(mesh, h, device=DEV) for _, h in batches]
        for b in hosts[:2]:
            p, opt, _, _ = step(p, opt, b["tokens"], b["targets"], b["mask"])
        sync(torch)
        try:
            for name, attr in parts.items():
                setattr(M, attr, ranged(name, saved[name]))
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for b in hosts[2:]:
                    p, opt, _, _ = step(p, opt, b["tokens"], b["targets"],
                                        b["mask"])
                sync(torch)
            wall = time.perf_counter() - t0
        finally:
            for name, attr in parts.items():
                setattr(M, attr, saved[name])
        rows = prof.key_averages()
        kernel_rows = [e for e in rows if "CUDA" in str(e.device_type)
                       and e.key not in parts]
        dev = sum(e.self_device_time_total for e in kernel_rows) / 1e3
        log(f"profile fourd {label} {steps} steps: wall {wall:.4f}s (traced), "
            f"device kernel time {dev / steps:.2f} ms per step, busy share "
            f"{dev / 1e3 / wall:.3f}")
        by_key = {e.key: e.device_time_total / 1e3 / steps for e in rows}
        for name in parts:
            if name in by_key:
                log(f"  {by_key[name]:9.2f} ms/step  range {name}")
        for e in sorted(kernel_rows,
                        key=lambda e: -e.self_device_time_total)[:14]:
            log(f"  {e.self_device_time_total / 1e3 / steps:9.2f} ms/step "
                f"{e.count // steps:5d}x/step  {e.key[:70]}")
        del p, opt, step, hosts
        torch.cuda.empty_cache()


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

def audit_kernel_launches(audit, name):
    """{program: launches of kernel ``name`` in its audited call (the
    unroll runs: a whole run)} of the audit phase, or None."""
    if not audit:
        return None
    return {prog: got[name] for prog, got in audit.items() if name in got}


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

    phase_s = {}
    t_mark = time.perf_counter()

    def ended(name):      # seconds of each phase run, logged at the end
        nonlocal t_mark
        if name in phases:
            phase_s[name] = round(time.perf_counter() - t_mark, 1)
        t_mark = time.perf_counter()

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
    ended("build")
    if "identity" in phases:
        log(f"card: {card} (torch {torch.__version__}, CUDA "
            f"{torch.version.cuda}, {torch.cuda.get_device_name(0)})")

    errors = {}
    ended("identity")
    if "kernels" in phases:
        check_rope(torch, errors)
        check_paged(torch, errors)
        check_flash(torch, errors)
        check_flash_bwd(torch, errors)

    k4_launches = None
    train_launches = {}
    traffic = None
    scoring_len = 1024
    ended("kernels")
    if "serve" in phases:
        launches, traffic = phase_serve(torch, args.seed)
        k4_launches = launches["paged_attention"]
    ended("serve")
    if "crosscheck" in phases:
        if traffic is None:
            traffic = make_traffic(args.seed, 32000)
        _, scoring_len = phase_crosscheck(torch, args.seed, traffic)
    ended("crosscheck")
    if "spec" in phases:
        phase_spec(torch, args.seed)
    chunked = quant_launches = None
    ended("spec")
    if "chunked" in phases:
        chunked = phase_chunked(torch, args.seed)
    ended("chunked")
    if "quant" in phases:
        quant_launches = phase_quant(torch, args.seed)
    ended("quant")
    if "contain" in phases:
        phase_contain(torch, args.seed)
    ended("contain")
    if "dense" in phases:
        phase_dense(torch, args.seed)
    ended("dense")
    if "moe_serve" in phases:
        phase_moe_serve(torch, args.seed)
    ended("moe_serve")
    if "train" in phases:
        train_launches, _ = phase_train(torch, args.seed)
    ended("train")
    if "traincheck" in phases:
        phase_traincheck(torch, args.seed)
    ended("traincheck")
    if "moe_train" in phases:
        phase_train(torch, args.seed, size="base-moe8")
    ended("moe_train")
    if "moe_traincheck" in phases:
        phase_traincheck(torch, args.seed, size="base-moe8")
    ended("moe_traincheck")
    if "classify" in phases:
        phase_classify(torch, args.seed)
    ended("classify")
    if "classifycheck" in phases:
        phase_classifycheck(torch, args.seed)
    ended("classifycheck")
    if "ddp" in phases:
        phase_ddp(torch, args.seed, card)
    ended("ddp")
    if "resume" in phases:
        phase_resume(torch, args.seed, card)
    ended("resume")
    if "faces" in phases:
        phase_faces(torch, args.seed, card)
    ended("faces")
    if "fourd" in phases:
        phase_fourd(torch, args.seed, card)
    ended("fourd")
    gspmd_launches = None
    if "gspmd" in phases:
        gspmd_launches = phase_gspmd(torch, args.seed, card)
    ended("gspmd")
    fleet_launches = tenant_launches = None
    if "fleet" in phases:
        fleet_launches = phase_fleet(torch, args.seed, card)
    ended("fleet")
    # tenancy before the timing phase, whose kernels line reports its K4
    # launches
    if "tenant" in phases:
        tenant_launches = phase_tenant(torch, args.seed, card)
    ended("tenant")
    obs_launches = None
    if "obs" in phases:
        obs_launches = phase_obs(torch, args.seed, card)
    ended("obs")
    resil_launches = None
    if "resil" in phases:
        resil_launches = phase_resil(torch, args.seed, card)
    ended("resil")
    audit_launches = None
    if "audit" in phases:
        audit_launches = phase_audit(torch, args.seed, card)
    ended("audit")
    if "profile" in phases:
        phase_profile(torch, args.seed)
        phase_profile_train(torch, args.seed)
        phase_profile_moe(torch, args.seed)
        phase_profile_classify(torch, args.seed)
        phase_profile_fourd(torch, args.seed)
    ended("profile")
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
             "launches_obs": obs_launches and obs_launches["train"][
                 "flash_fwd"],
             "launches_resil": resil_launches and resil_launches[
                 "flash_fwd"],
             "launches_audit": audit_kernel_launches(audit_launches,
                                                     "flash_fwd"),
             "max_abs_err": errors.get(main_case),
             **{k: tr["K1"][k] for k in keys}},
            {"name": "flash_bwd_dq", "route": "cuda",
             "source": "dtdl_tpu_torch/csrc/flash_bwd.cu",
             "replaces": "dtdl_tpu/ops/attention.py:408",
             "launches": train_launches.get("flash_bwd_dq"),
             "launches_obs": obs_launches and obs_launches["train"][
                 "flash_bwd_dq"],
             "launches_resil": resil_launches and resil_launches[
                 "flash_bwd_dq"],
             "launches_audit": audit_kernel_launches(audit_launches,
                                                     "flash_bwd_dq"),
             "max_abs_err": bwd_errs and bwd_errs[0],
             **{k: tr["K2"][k] for k in keys}},
            {"name": "flash_bwd_dkv", "route": "cuda",
             "source": "dtdl_tpu_torch/csrc/flash_bwd.cu",
             "replaces": "dtdl_tpu/ops/attention.py:475",
             "launches": train_launches.get("flash_bwd_dkv"),
             "launches_obs": obs_launches and obs_launches["train"][
                 "flash_bwd_dkv"],
             "launches_resil": resil_launches and resil_launches[
                 "flash_bwd_dkv"],
             "launches_audit": audit_kernel_launches(audit_launches,
                                                     "flash_bwd_dkv"),
             "max_abs_err": bwd_errs and max(bwd_errs[1:]),
             **{k: tr["K3"][k] for k in keys}},
            {"name": "rope_rows", "route": "cuda",
             "source": "dtdl_tpu_torch/csrc/rope_rows.cu",
             "replaces": "dtdl_tpu/ops/attention.py:118",
             "launches": train_launches.get("rope_rows"),
             "launches_obs": obs_launches and obs_launches["train"][
                 "rope_rows"],
             "launches_resil": resil_launches and resil_launches[
                 "rope_rows"],
             "launches_audit": audit_kernel_launches(audit_launches,
                                                     "rope_rows"),
             "max_abs_err": errors.get("rope train 32x4096 hd128 bf16"),
             **{k: rope_t[k] for k in keys}},
            {"name": "paged_attention", "route": "cuda",
             "source": "dtdl_tpu_torch/csrc/paged_attention.cu",
             "replaces": "dtdl_tpu/ops/paged_attention.py:88",
             "launches": k4_launches,
             "launches_fleet": fleet_launches,
             "launches_tenant": tenant_launches,
             "launches_obs": obs_launches and {
                 "serve": obs_launches["serve"],
                 "fleet": obs_launches["fleet"]},
             "launches_audit": audit_kernel_launches(audit_launches,
                                                     "paged_attention"),
             # (h): by part, [rank 0's, rank 1's] launches by replica
             "launches_gspmd_fleet": gspmd_launches,
             "max_abs_err": errors.get("decode S=1 bf16"),
             **{k: k4[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")}},
        ]}
        log(json.dumps(line))

    ended("timing")
    log(f"phase seconds {phase_s}")
    log(f"total {time.perf_counter() - t_start:.1f}s")
    log(card)
    if set(PHASES) <= set(phases):
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
