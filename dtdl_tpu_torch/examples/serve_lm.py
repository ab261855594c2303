#!/usr/bin/env python
"""Continuous-batching LM serving, the twin of examples/serve_lm.py: a
``transformer_lm`` with random weights from ``--seed`` behind the port's
engine and scheduler, over the JAX script's synthetic traffic (mixed
prompt lengths, an optional shared prefix, one sampling config).  With
``--page-size`` the arena is block-paged and every paged attend is the
paged-attention kernel on the card.

    python -m dtdl_tpu_torch.examples.serve_lm --n-requests 32 --n-slots 8
    python -m dtdl_tpu_torch.examples.serve_lm --model-size base \\
        --page-size 16 --shared-prefix 256 --dtype bfloat16

``--spill-host-mb`` (with ``--spill-dir``) puts the KV spill tiers behind
the prefix cache of a paged arena.  Tenancy: ``--lora a,b`` round-robins
the requests over the base model and the adapters (a missing path gets a
random demo adapter saved there), ``--json-schema FILE`` masks every
output to JSON of that schema, ``--stream`` attaches a token stream to
each request.  ``--trace PATH`` writes a Perfetto-loadable Chrome trace
of the scheduler's phases and request lifecycles (the twin's Observer, as
the JAX script's; its sentinel counts captures once the port has them,
queue A5).  ``--platform cpu`` runs on the CPU.  Not ported yet, and
refused by name: ``--restore`` of flax msgpack weights, ROADMAP queue
A8b's remainder.
"""

import argparse
import time

import numpy as np
import torch

from dtdl_tpu_torch.examples.common import (add_device_flags, bootstrap,
                                            demo_adapters, json_report,
                                            json_schema_dfa)
from dtdl_tpu_torch.models import transformer_lm
from dtdl_tpu_torch.obs import Observer
from dtdl_tpu_torch.serve import (InferenceEngine, ModelDraft, Request,
                                  SampleParams, Scheduler, TokenStream)
from dtdl_tpu_torch.utils.config import flag, make_parser
from dtdl_tpu_torch.utils.random import seed_everything

# flags whose modules are not ported yet -> the ROADMAP item that ports them
REFUSED = {
    "restore": "queue A8b's remainder (reading flax msgpack weights)",
}


def parser():
    p = make_parser("dtdl_tpu_torch: batched LM serving")
    flag(p, "--model-size", default="tiny", choices=["tiny", "small", "base"])
    flag(p, "--restore", default="",
         help="msgpack weights to serve: ROADMAP queue A8b's remainder")
    flag(p, "--n-slots", type=int, default=4,
         help="decode batch width (KV-arena rows)")
    flag(p, "--n-requests", type=int, default=12)
    flag(p, "--max-new-tokens", type=int, default=24)
    flag(p, "--temperature", type=float, default=0.0, help="0 = greedy")
    flag(p, "--top-k", type=int, default=0, help="0 = disabled")
    flag(p, "--top-p", type=float, default=1.0, help="1 = disabled")
    flag(p, "--harvest-lag", type=int, default=4,
         help="steps a sampled token may stay on the device before the "
              "host reads it (0 = sync every step)")
    flag(p, "--speculate", type=int, default=0,
         help="speculative decoding: max drafted tokens per step (0 = off)")
    flag(p, "--draft", default="ngram", choices=["ngram", "model"],
         help="draft source for --speculate: n-gram prompt lookup, or a "
              "small random draft transformer sharing the vocab")
    flag(p, "--page-size", type=int, default=0,
         help="block-paged KV arena: tokens per page (0 = dense per-slot "
              "rows; must divide max_seq)")
    flag(p, "--n-pages", type=int, default=0,
         help="page-pool size for --page-size (0 = dense-equivalent "
              "capacity)")
    flag(p, "--prefix-cache", action=argparse.BooleanOptionalAction,
         default=True,
         help="cross-request prefix caching over full prompt pages "
              "(paged arena only)")
    flag(p, "--shared-prefix", type=int, default=0,
         help="synthetic traffic: this many common leading tokens in "
              "every request (a system prompt)")
    flag(p, "--spill-host-mb", type=int, default=0,
         help="KV spill tiers: host-DRAM budget in MiB for evicted prefix "
              "pages, restored on a prefix miss instead of recomputed "
              "(paged arena only)")
    flag(p, "--spill-dir", default="",
         help="disk spill tier for --spill-host-mb: the directory of the "
              "checksummed spill file (host overflow demotes there)")
    flag(p, "--spill-disk-mb", type=int, default=256,
         help="disk spill budget for --spill-dir")
    flag(p, "--chunk-tokens", type=int, default=0,
         help="chunked prefill: per-step prompt token budget (0 = "
              "whole-prompt prefill)")
    flag(p, "--quantize", default="none", choices=["none", "w8", "w8kv8"],
         help="int8 serving: w8 = int8 weights, w8kv8 = + int8 KV arena")
    flag(p, "--lora", default="",
         help="multi-tenant LoRA: comma-separated adapter checkpoint "
              "paths; requests round-robin over base + adapters in the "
              "same steps (a missing path gets a random demo adapter "
              "saved there)")
    flag(p, "--lora-rank", type=int, default=8,
         help="adapter rank for --lora (must match saved adapters)")
    flag(p, "--json-schema", default="",
         help="grammar-constrained decoding: a JSON-schema file; every "
              "request's output is masked to valid JSON for it (vocab "
              "must cover ASCII, i.e. >= 128)")
    flag(p, "--stream", action="store_true",
         help="attach a TokenStream per request and echo the first "
              "requests' tokens as the lag-harvest windows deliver them")
    flag(p, "--seed", type=int, default=0)
    flag(p, "--trace", default="",
         help="write a Chrome-trace-event JSON (Perfetto-loadable) of the "
              "scheduler phases here")
    flag(p, "--dtype", default="float32", choices=["float32", "bfloat16"],
         help="the model's compute dtype (the JAX script serves f32)")
    add_device_flags(p)
    return p


def _stream(args, i):
    if not args.stream:
        return None
    if i >= 2:                  # echo only the first requests
        return TokenStream()
    return TokenStream(callback=lambda new, i=i: print(
        f"    stream req {i}: +{new}"))


def traffic(model, args, rng, tenants=(None,), dfa=None, eos=None):
    """The JAX script's synthetic requests: prompts of 4..hi tokens after
    ``--shared-prefix`` common ones, round-robin over ``tenants`` (None:
    the base model), each under the grammar ``dfa`` and with a stream
    when asked."""
    hi = min(64, model.cfg.max_seq // 2)
    common = rng.integers(0, model.cfg.vocab_size,
                          args.shared_prefix).tolist()
    lens = rng.integers(4, hi, args.n_requests)
    sp = SampleParams(temperature=args.temperature, top_k=args.top_k,
                      top_p=args.top_p)
    return [Request(common + rng.integers(0, model.cfg.vocab_size,
                                          n).tolist(),
                    args.max_new_tokens, sampling=sp,
                    speculate=args.speculate,
                    adapter=tenants[i % len(tenants)], grammar=dfa,
                    eos_id=eos, stream=_stream(args, i))
            for i, n in enumerate(lens)]


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)
    for name, item in REFUSED.items():
        if getattr(args, name):
            raise NotImplementedError(
                f"--{name.replace('_', '-')} is ROADMAP {item}")
    device = bootstrap(args)
    seed_everything(args.seed)

    model = transformer_lm(args.model_size, attn_impl="dense",
                           dtype=getattr(torch, args.dtype), device=device,
                           seed=args.seed)
    hi = min(64, model.cfg.max_seq // 2)
    if not 0 <= args.shared_prefix <= model.cfg.max_seq - hi - 1:
        ap.error(f"--shared-prefix must be in [0, "
                 f"{model.cfg.max_seq - hi - 1}] for this model")
    lora_paths = demo_adapters(model, args.lora, args.lora_rank)
    obs = Observer(trace_path=args.trace or None, sentinel="warn")
    engine = InferenceEngine(model, n_slots=args.n_slots, observer=obs,
                             page_size=args.page_size,
                             n_pages=args.n_pages or None,
                             quantize_weights=args.quantize != "none",
                             kv_dtype=("int8" if args.quantize == "w8kv8"
                                       else None),
                             lora_rank=args.lora_rank if lora_paths else 0,
                             lora_adapters=(len(lora_paths) + 1
                                            if lora_paths else 0),
                             device=device)
    draft = None
    if args.speculate and args.draft == "model":
        # a narrower random draft transformer sharing the vocab (real
        # deployments restore trained draft weights)
        dm = transformer_lm("tiny", vocab_size=model.cfg.vocab_size,
                            attn_impl="dense", device=device,
                            seed=args.seed + 1)
        draft = ModelDraft(dm, warmup=args.speculate)
    sched = Scheduler(engine, seed=args.seed, harvest_lag=args.harvest_lag,
                      observer=obs, draft=draft,
                      prefix_cache=args.prefix_cache,
                      chunk_tokens=args.chunk_tokens or None, device=device,
                      spill_host_bytes=args.spill_host_mb << 20 or None,
                      spill_dir=args.spill_dir or None,
                      spill_disk_bytes=(args.spill_disk_mb << 20
                                        if args.spill_dir else None))
    dfa = eos = None
    if args.json_schema:
        t_dfa = time.perf_counter()
        dfa, eos = json_schema_dfa(model, args.json_schema, ap)
        print(f"  --json-schema: {dfa.n_states}-state token DFA "
              f"({dfa.nbytes():,} bytes of masks, compiled in "
              f"{time.perf_counter() - t_dfa:.2f}s)")
    reqs = traffic(model, args, np.random.default_rng(args.seed),
                   tenants=[None] + lora_paths, dfa=dfa, eos=eos)

    t0 = time.perf_counter()
    sched.run(reqs)
    dt = time.perf_counter() - t0
    for r in reqs[:4]:
        print(f"  req {r.rid}: prompt[{len(r.prompt)}] -> "
              f"{r.tokens[:12]}{'...' if len(r.tokens) > 12 else ''}")
    s = sched.metrics.summary()
    print(f"served {s['requests_finished']} requests in {dt:.2f}s  "
          f"(decode {s['decode_tokens_per_sec']} tok/s, occupancy "
          f"{s['occupancy_mean']:.0%}, ttft {s['ttft_s_mean'] * 1e3:.1f}ms)")
    if "ttft_s_p50" in s:
        print(f"  ttft p50/p95/p99: {s['ttft_s_p50'] * 1e3:.1f} / "
              f"{s['ttft_s_p95'] * 1e3:.1f} / {s['ttft_s_p99'] * 1e3:.1f} ms"
              f"   per-token p50/p99: "
              f"{s.get('tok_latency_s_p50', 0.0) * 1e3:.2f} / "
              f"{s.get('tok_latency_s_p99', 0.0) * 1e3:.2f} ms")
    if args.page_size:
        print(f"  paged kv (page_size={args.page_size}): prefix hit "
              f"rate {s['prefix_hit_rate']:.0%}  prefill tokens saved "
              f"{s['prefill_tokens_saved']}  pages in use "
              f"{s['pages_in_use_last']}/{s['page_capacity']} "
              f"(peak {s['pages_in_use_peak']})  shed "
              f"{s['requests_shed']}")
    if args.spill_host_mb:
        # pages that left the arena and came back instead of being
        # recomputed, by the tier that held them
        print(f"  kv spill: spilled {s['pages_spilled']} pages "
              f"({s['spill_bytes'] >> 10} KiB)  restored "
              f"{s['pages_restored']} (host {s['spill_host_hits']} / "
              f"disk {s['spill_disk_hits']} hits, "
              f"{s['restore_s'] * 1e3:.1f}ms)  quarantined "
              f"{s['spill_quarantined']}")
    if args.quantize != "none":
        # decode bytes/token, KV capacity at fixed memory, and the logits
        # drift of int8 rounding on a probe prompt
        q = engine.compile_stats()["quant"]
        ref = InferenceEngine(model, n_slots=args.n_slots,
                              page_size=args.page_size,
                              n_pages=args.n_pages or None, device=device)
        rq = ref.compile_stats()["quant"]
        kv_x = (rq["kv_arena_bytes"] / q["kv_arena_bytes"]
                if q["kv_arena_bytes"] else 1.0)
        probe = torch.tensor([reqs[0].prompt], device=model.device)
        with torch.no_grad():
            lf, lq = model(probe), engine.model(probe)
        drift = float((lf - lq).abs().max()) / max(float(lf.abs().max()),
                                                   1e-9)
        print(f"  quantized ({args.quantize}): decode bytes/token "
              f"{q['decode_hbm_bytes_per_token']:,} (float: "
              f"{rq['decode_hbm_bytes_per_token']:,})  param bytes "
              f"{q['param_bytes']:,} ({rq['param_bytes']:,} float)  "
              f"kv capacity x{kv_x:.2f} at fixed memory "
              f"(~{int(args.n_slots * kv_x)} slots for these "
              f"{args.n_slots})  probe logits drift {drift:.1%}")
    if args.speculate:
        # per-request ACCEPTED tokens/sec over the request's own decode
        # window
        rates = sorted((len(r.tokens) - 1) / (r.t_done - r.t_first)
                       for r in reqs
                       if len(r.tokens) > 1 and r.t_done > r.t_first)
        pct = (lambda p: rates[min(len(rates) - 1,
                                   int(p * (len(rates) - 1)))]) \
            if rates else (lambda p: 0.0)
        print(f"  speculative k<={args.speculate} ({args.draft}): "
              f"acceptance {s['spec_acceptance_rate']:.0%}  "
              f"tokens/step {s['tokens_per_step_mean']:.2f}  "
              f"accepted-tok/s p50/p95: {pct(0.5):.1f} / {pct(0.95):.1f}  "
              f"draft overhead {s['draft_s'] * 1e3:.1f}ms")
    if lora_paths:
        # delivered tokens by tenant, all through the same steps (the
        # adapter ids are data)
        mix = "  ".join(f"{k.rsplit('/', 1)[-1]}={v}"
                        for k, v in sorted(s["tokens_by_adapter"].items()))
        print(f"  multi-lora ({len(lora_paths)} adapters, rank "
              f"{args.lora_rank}): tokens by tenant: {mix}  bank loads "
              f"{engine.adapter_bank.n_loads} evictions "
              f"{engine.adapter_bank.n_evictions}")
    if dfa is not None:
        n_json, n_cut = json_report(reqs, eos)
        print(f"  constrained ({args.json_schema}): {n_json}/{len(reqs)} "
              f"requests completed valid JSON, {n_cut} cut by the token "
              f"budget mid-structure; illegal draft tokens trimmed "
              f"{s['grammar_rejected_tokens']}")
        for r in reqs[:2]:
            body = r.tokens[:-1] if r.tokens and r.tokens[-1] == eos \
                else r.tokens
            print(f"    req {r.rid}: {''.join(chr(t) for t in body)!r}")
    if args.stream:
        print(f"  streaming: {s['stream_deliveries']} incremental "
              f"deliveries across {len(reqs)} requests")
    print("compiled programs:", engine.compile_stats(), flush=True)
    if args.trace:
        print(f"trace written to {obs.save()}", flush=True)
    return reqs, s, dt


if __name__ == "__main__":
    main()
