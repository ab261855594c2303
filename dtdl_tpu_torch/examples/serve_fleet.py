#!/usr/bin/env python
"""Serving fleet demo, the twin of examples/serve_fleet.py: a
health-checked Router over N replicas of one engine (a ``transformer_lm``
with random weights from ``--seed``), the JAX script's synthetic traffic,
and its report: least-loaded dispatch, failure detection, failover with
retries, hedging, rolling restarts and prefill/decode disaggregation.

    python -m dtdl_tpu_torch.examples.serve_fleet                # 2 replicas
    python -m dtdl_tpu_torch.examples.serve_fleet --n-replicas 3 \\
        --n-requests 64
    # live failover: replica 0's worker dies at its 5th iteration
    python -m dtdl_tpu_torch.examples.serve_fleet --kill-replica-after 5
    python -m dtdl_tpu_torch.examples.serve_fleet --rolling-restart
    python -m dtdl_tpu_torch.examples.serve_fleet --hedge-after 0.05
    python -m dtdl_tpu_torch.examples.serve_fleet --model-size base \\
        --disagg --kill-replica-after 5
    # tenants: base + two LoRA adapters, token streams, JSON output
    python -m dtdl_tpu_torch.examples.serve_fleet --lora a.msgpack,b.msgpack \\
        --stream --json-schema schema.json --kill-replica-after 3
    # observability: a Perfetto trace, a JSONL series, a scrape endpoint
    # and SLO judging
    python -m dtdl_tpu_torch.examples.serve_fleet --trace fleet.json \\
        --metrics-jsonl fleet_series.jsonl --metrics-port 0 \\
        --slo-ttft-p99 0.5 --slo-availability 0.999

It runs on the card (every paged attend through the paged-attention
kernel) unless ``--platform cpu``.  With ``--stream`` it reports the
streams that parted from their request's tokens (``divergent streams``,
0 unless a loser of a retry or hedge streamed).  It also reports the
longest interval between two heartbeats of a working replica against
``--watchdog`` (the watchdog's margin).
"""

import time

import numpy as np
import torch

from dtdl_tpu_torch.examples.common import (add_device_flags, bootstrap,
                                            demo_adapters, json_report,
                                            json_schema_dfa)
from dtdl_tpu_torch.models import transformer_lm
from dtdl_tpu_torch.obs import JsonlSeriesSink, MetricsExporter, Observer
from dtdl_tpu_torch.resil.faults import FaultPlan, replica_site
from dtdl_tpu_torch.serve import (InferenceEngine, Request, Router,
                                  TokenStream, default_fleet_slos)
from dtdl_tpu_torch.utils.config import flag, make_parser
from dtdl_tpu_torch.utils.random import seed_everything


def parser():
    p = make_parser("dtdl_tpu_torch: replicated LM serving fleet")
    flag(p, "--model-size", default="tiny", choices=["tiny", "small", "base"])
    flag(p, "--n-replicas", type=int, default=2)
    flag(p, "--n-slots", type=int, default=4,
         help="decode batch width per replica")
    flag(p, "--n-requests", type=int, default=32)
    flag(p, "--max-new-tokens", type=int, default=24)
    flag(p, "--retry-budget", type=int, default=3,
         help="re-dispatches per request after a replica failure")
    flag(p, "--hedge-after", type=float, default=0.0,
         help="re-submit a straggler to a second replica after this many "
              "seconds (0 = hedging off); first completion wins")
    flag(p, "--kill-replica-after", type=int, default=-1,
         help="fault injection: kill replica 0's worker thread at its K-th "
              "iteration (-1 = off), the live failover demo")
    flag(p, "--rolling-restart", action="store_true",
         help="drain and restart every replica mid-traffic")
    flag(p, "--watchdog", type=float, default=0.25,
         help="seconds of stale worker heartbeat (with work outstanding) "
              "before the stall signal fires")
    flag(p, "--trace", default=None,
         help="write a request-correlated Chrome trace here "
              "(Perfetto-loadable; spans + per-request flow events)")
    flag(p, "--metrics-jsonl", default=None,
         help="append continuous window-delta metric snapshots here "
              "(one JSON object per sampled boundary)")
    flag(p, "--metrics-port", type=int, default=-1,
         help="serve GET /metrics (Prometheus text) on this port "
              "(0 = pick a free port; -1 = off)")
    flag(p, "--metrics-interval", type=float, default=0.25,
         help="minimum seconds between exported snapshots (with "
              "--metrics-jsonl or --metrics-port)")
    flag(p, "--slo-ttft-p99", type=float, default=0.0,
         help="SLO: router-clock TTFT p99 target in seconds (0 = off); "
              "crossings land in the trace AND the series")
    flag(p, "--slo-availability", type=float, default=0.0,
         help="SLO: availability floor, e.g. 0.999 (0 = off); bad = "
              "failed + expired over a rolling window")
    flag(p, "--disagg", action="store_true",
         help="prefill/decode disaggregation: replica 0 serves only prompt "
              "prefills (chunked), the rest only decode; completed "
              "prefills migrate by page handoff (a paged engine)")
    flag(p, "--chunk-tokens", type=int, default=0,
         help="chunked prefill on every replica: per-step prompt token "
              "budget (0 = whole-prompt; 16 under --disagg)")
    flag(p, "--lora", default="",
         help="multi-tenant LoRA across the fleet: comma-separated "
              "adapter checkpoint paths; requests round-robin over base + "
              "adapters (a missing path gets a random demo adapter saved "
              "there)")
    flag(p, "--lora-rank", type=int, default=8,
         help="adapter rank for --lora (must match saved adapters)")
    flag(p, "--json-schema", default="",
         help="grammar-constrained decoding: a JSON-schema file; every "
              "request's output is masked to valid JSON for it")
    flag(p, "--stream", action="store_true",
         help="attach a TokenStream per request; delivery stays "
              "prefix-stable across retries and hedges (only the winning "
              "attempt streams)")
    flag(p, "--seed", type=int, default=0)
    flag(p, "--dtype", default="float32", choices=["float32", "bfloat16"],
         help="the model's compute dtype (the JAX script serves f32)")
    add_device_flags(p)
    return p


def main(argv=None):
    """Run the demo; returns ``(requests, router summary, wall s)``."""
    ap = parser()
    args = ap.parse_args(argv)
    roles = None
    if args.disagg:
        if args.n_replicas < 2:
            ap.error("--disagg needs >= 2 replicas")
        roles = ["prefill"] + ["decode"] * (args.n_replicas - 1)
        if not args.chunk_tokens:
            args.chunk_tokens = 16
    device = bootstrap(args)
    seed_everything(args.seed)

    model = transformer_lm(args.model_size, attn_impl="dense",
                           dtype=getattr(torch, args.dtype), device=device,
                           seed=args.seed)
    lora_paths = demo_adapters(model, args.lora, args.lora_rank)
    engine = InferenceEngine(model, n_slots=args.n_slots, buckets=(64,),
                             page_size=16 if args.disagg else 0,
                             lora_rank=args.lora_rank if lora_paths else 0,
                             lora_adapters=(len(lora_paths) + 1
                                            if lora_paths else 0),
                             device=device)
    plan = None
    if args.kill_replica_after >= 0:
        plan = FaultPlan().at(replica_site(0, "loop"),
                              args.kill_replica_after)
        print(f"fault armed: replica 0's worker dies at loop iteration "
              f"{args.kill_replica_after}")

    dfa = eos = None
    if args.json_schema:
        dfa, eos = json_schema_dfa(model, args.json_schema, ap)
    rng = np.random.default_rng(args.seed)
    hi = min(64, model.cfg.max_seq // 2)
    tenants = [None] + lora_paths
    streams = [TokenStream() if args.stream else None
               for _ in range(args.n_requests)]
    reqs = [Request(rng.integers(0, model.cfg.vocab_size,
                                 int(rng.integers(4, hi))).tolist(),
                    args.max_new_tokens, adapter=tenants[i % len(tenants)],
                    grammar=dfa, eos_id=eos, stream=streams[i])
            for i in range(args.n_requests)]

    # observability, all opt-in: correlated tracing, continuous
    # boundary-sampled export, SLO judging
    observer = Observer(trace=bool(args.trace), trace_path=args.trace)
    exporter = None
    if (args.metrics_jsonl or args.metrics_port >= 0
            or args.slo_ttft_p99 or args.slo_availability):
        sinks = ([JsonlSeriesSink(args.metrics_jsonl)]
                 if args.metrics_jsonl else [])
        exporter = MetricsExporter(sinks=sinks,
                                   interval_s=args.metrics_interval)
        if args.metrics_port >= 0:
            port = exporter.serve_http(port=args.metrics_port)
            print(f"scraping: curl http://127.0.0.1:{port}/metrics")
    slos = default_fleet_slos(
        ttft_p99_s=args.slo_ttft_p99 or None,
        availability=args.slo_availability or None) or None

    t0 = time.perf_counter()
    with Router(engine, n_replicas=args.n_replicas, plan=plan,
                retry_budget=args.retry_budget,
                hedge_after_s=args.hedge_after or None,
                watchdog_s=args.watchdog, observer=observer,
                exporter=exporter, slos=slos, roles=roles, device=device,
                sched_kwargs={"harvest_lag": 4,
                              "chunk_tokens": args.chunk_tokens or None}
                ) as router:
        for r in reqs:
            router.submit(r)
        if args.rolling_restart:
            router.rolling_restart(timeout_s=120)
            print(f"rolling restart done at "
                  f"{time.perf_counter() - t0:.2f}s — traffic continued")
        if not router.wait(reqs, timeout_s=600):
            print("WARNING: fleet did not settle "
                  f"(pump_error={router.pump_error})")
        dt = time.perf_counter() - t0
        evicts = list(router.evict_log)
        beat_gap = max(rep.max_beat_gap_s for rep in router.replicas)
    # after shutdown: the books are settled and the exporter's final
    # forced snapshot (and any SLO verdicts on it) are included
    s = router.summary()

    n_ok = sum(1 for r in reqs if r.done and r.error is None)
    n_err = sum(1 for r in reqs if r.error is not None)
    print(f"served {s['fleet_requests_finished']}/{len(reqs)} requests "
          f"over {args.n_replicas} replicas in {dt:.2f}s  "
          f"({s['fleet_decode_tokens_per_sec']:.2f} tok/s fleet-wide; "
          f"{n_ok} clean, {n_err} with named errors)")
    if "fleet_ttft_s_p50" in s:
        print(f"  ttft p50/p95/p99 (router clock, queue+failover "
              f"included): {s['fleet_ttft_s_p50'] * 1e3:.1f} / "
              f"{s['fleet_ttft_s_p95'] * 1e3:.1f} / "
              f"{s['fleet_ttft_s_p99'] * 1e3:.1f} ms")
    print(f"  resilience: retries {s['fleet_retries']}  evictions "
          f"{s['fleet_evictions']}  failovers {s['fleet_failovers']}  "
          f"restarts {s['fleet_restarts']}  hedges "
          f"{s['fleet_hedges']} (won {s['fleet_hedges_won']})")
    if roles is not None:
        print(f"  disaggregation ({'/'.join(roles)}): migrations "
              f"{s['fleet_migrations']}  kv pages moved "
              f"{s['fleet_kv_handoff_pages']}")
    if lora_paths:
        mix = "  ".join(f"{k.rsplit('/', 1)[-1]}={v}" for k, v in
                        sorted(s["fleet_tokens_by_adapter"].items()))
        print(f"  multi-lora ({len(lora_paths)} adapters, rank "
              f"{args.lora_rank}): tokens by tenant: {mix}")
    if dfa is not None:
        n_json, n_cut = json_report(reqs, eos)
        print(f"  constrained ({args.json_schema}): {n_json}/{len(reqs)} "
              f"valid JSON, {n_cut} cut by the token budget; illegal "
              f"draft tokens trimmed {s['fleet_grammar_rejected_tokens']}")
    if args.stream:
        n_div = sum(1 for st in streams if st.divergent)
        n_match = sum(1 for r, st in zip(reqs, streams)
                      if r.error is None and st.closed
                      and st.tokens == r.tokens)
        print(f"  streaming: {s['fleet_stream_deliveries']} deliveries; "
              f"{n_match}/{n_ok} clean streams token-exact; divergent "
              f"streams: {n_div} (losers never stream)")
    for ev in evicts:
        lat = (f"{ev['detect_latency_s'] * 1e3:.1f}ms after worker "
               f"death" if ev["detect_latency_s"] is not None
               else "passive signals")
        print(f"  evicted replica {ev['replica']} ({lat}); "
              f"{ev['failovers']} in-flight requests failed over: "
              f"{ev['reason'][:80]}")
    acc = (s["fleet_requests_finished"] + s["fleet_requests_rejected"]
           + s["fleet_requests_expired"] + s["fleet_requests_failed"]
           + s["fleet_requests_aborted"])
    print(f"  accounting: submitted {s['fleet_requests_submitted']} == "
          f"finished {s['fleet_requests_finished']} + rejected "
          f"{s['fleet_requests_rejected']} + expired "
          f"{s['fleet_requests_expired']} + failed "
          f"{s['fleet_requests_failed']} + aborted "
          f"{s['fleet_requests_aborted']}  "
          f"[{'OK' if s['fleet_accounting_ok'] and acc else 'VIOLATED'}]"
          f"  requests lost: {s['fleet_requests_submitted'] - acc}")
    print(f"  replica health: {s['replica_health']}")
    print(f"  heartbeat: longest gap of a current worker "
          f"{beat_gap * 1e3:.1f} ms (watchdog {args.watchdog * 1e3:.0f} ms)")
    if exporter is not None:
        slo_bits = {k: v for k, v in s.items() if k.startswith("slo_")}
        print(f"  export: {s.get('export_snapshots', 0)} snapshots"
              + (f" -> {args.metrics_jsonl}" if args.metrics_jsonl
                 else "")
              + (f"  SLO: {slo_bits}" if slo_bits else ""))
        exporter.close()
    if args.trace:
        # one request's correlated story, reconstructed from the trace:
        # intake -> dispatch (every attempt, with lineage) -> admit ->
        # first token -> terminal, what Perfetto draws as flow arrows
        probe = next((r for r in reqs if r.done), None)
        if probe is not None:
            tl = observer.request_timeline(probe.rid)
            steps = [f"{e['ts'] / 1e6:+.3f}s {e['name']}"
                     + (f"[{e['args']['lineage']}]"
                        if e.get("args", {}).get("lineage") else "")
                     for e in tl if e.get("ph") in ("i", "X")]
            print(f"  timeline rid={probe.rid}: " + " -> ".join(steps))
        observer.close()
        print(f"  trace written to {args.trace} (load in Perfetto; "
              f"flow arrows join each request's attempts)")
    print(end="", flush=True)
    return reqs, s, dt


if __name__ == "__main__":
    main()
