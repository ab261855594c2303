"""The port's continuous export, SLO layer and request-correlated tracing
(``dtdl_tpu_torch.obs.export``, ``obs.slo``, the serve layers' emitters)
against the JAX package's, on the CPU.

* **Export**: ``prometheus_text`` is byte-equal to JAX's for the same
  point; the scrape endpoint answers ``GET /metrics`` from the last
  sampled point (port 0 picks a free port); sources, sinks, the throttle,
  ``source_errors`` and ``sink_errors`` give the points JAX's exporter
  gives over the same sources.
* **SLOs**: ``SLO``/``SLOEvaluator`` over the same series (gauge, ratio,
  burn, gates) give the same fields, crossing events and summaries as
  JAX's; ``default_train_slos`` and ``default_fleet_slos`` declare JAX's
  objectives.
* **The catalog audit**: every literal name and f-string family the port
  passes to ``span``/``event``/``instant``/``flow`` lies in the catalogs
  (JAX's sets); the catalog names the port does not emit are exactly the
  resilience plane's, which ROADMAP A13b ports.
* **Timelines**: a standalone scheduler's request timelines and flow
  chains equal the JAX scheduler's in structure (names in order, flow
  phases, correlation args) on the same script, through
  ``CopyingJaxEngine`` (ROADMAP C1), on the dense and the paged arena;
  an error terminal after admission closes its chain as JAX's does.  The
  Router's cases hold JAX's tests' structure (tests/test_obs_export.py):
  a hedged, failed-over request reads as one chain under its rid with one
  terminal and no dangling flow; a rejected intake has no flow at all;
  the exported series telescopes to the settled books; SLOs catch an
  injected TTFT regression and an availability breach.
* **ROADMAP C7**: four slowed admissions in one step at ``watchdog_s``
  0.25 evict nothing (the worker beats after each prefill), and a frozen
  worker (a ``loop``-site stall) is still caught within the watchdog.

Tolerance: exact (host arithmetic, greedy tokens, event structure).
"""

import json
import pathlib
import re
import time
import urllib.request

import numpy as np
import pytest
import torch

import dtdl_tpu.obs as jobs
from dtdl_tpu.obs.slo import default_train_slos as jax_train_slos
from dtdl_tpu.serve import Request as JaxRequest
from dtdl_tpu.serve import Scheduler as JaxScheduler
from dtdl_tpu.serve.fleet import default_fleet_slos as jax_fleet_slos
import dtdl_tpu_torch
from dtdl_tpu_torch.obs import (EVENT_CATALOG, SPAN_CATALOG, SLO,
                                JsonlSeriesSink, MetricsExporter, Observer,
                                PrometheusSink, SLOEvaluator, Tracer,
                                corr_rid, default_train_slos,
                                prometheus_text)
from dtdl_tpu_torch.obs.export import prometheus_name
from dtdl_tpu_torch.obs.slo import BURN_CAP
from dtdl_tpu_torch.resil.faults import FaultPlan, replica_site
from dtdl_tpu_torch.serve import (InferenceEngine, Request, Router,
                                  Scheduler, error_kind)
from dtdl_tpu_torch.serve.fleet import default_fleet_slos
from dtdl_tpu_torch.serve.health import STATES
from test_torch_chunked import CopyingJaxEngine, jax_pair

torch.set_num_threads(1)

MAX_SEQ = 32
N_NEW = 6
CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, d_ff=64,
           max_seq=MAX_SEQ)


class _ListSink:
    def __init__(self):
        self.points = []

    def write(self, point):
        self.points.append(dict(point))

    def close(self):
        pass


def mk_prompts(n, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 64, int(rng.integers(3, 8))).tolist()
            for _ in range(n)]


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

POINTS = [
    {"t": 1700000000.0, "t_mono": 3.5, "fleet_ttft_s_p99": 0.25,
     "ok": True, "skip me": 3, "name": "x", "9lives": 2, "a:b": -1.5,
     "nested": {"x": 1}, "big": 12345678901234, "tiny": 1e-12},
    {"t": 1700000123.456, "requests_finished": 42, "slo_x_burn": BURN_CAP},
    {},
]


@pytest.mark.parametrize("i", range(len(POINTS)))
def test_prometheus_text_byte_equal_to_jax(i):
    point = POINTS[i]
    if point:
        assert prometheus_text(point) == jobs.prometheus_text(point)
        assert prometheus_text(point, "x_") == \
            jobs.prometheus_text(point, "x_")
    else:
        assert prometheus_text(point) == "" == jobs.prometheus_text(point)
    for name in ("a b", "9x", "", "ok:fine_1"):
        assert prometheus_name(name) == jobs.export.prometheus_name(name)
    sink, jsink = PrometheusSink(), jobs.PrometheusSink()
    sink.write(point)
    jsink.write(point)
    if point:
        assert sink.render() == jsink.render()


def test_scrape_endpoint_answers_from_the_last_point():
    exp = MetricsExporter(interval_s=0.0)
    calls = []
    exp.add_source("", lambda: calls.append(1) or {"requests_finished": 42})
    try:
        port = exp.serve_http(port=0)
        assert exp.port == port and exp.serve_http() == port
        exp.sample(force=True)
        url = f"http://127.0.0.1:{port}"
        for _ in range(2):
            with urllib.request.urlopen(url + "/metrics", timeout=5) as r:
                body = r.read().decode()
                assert r.status == 200
                assert "0.0.4" in r.headers["Content-Type"]
        assert "dtdl_requests_finished 42" in body
        assert len(calls) == 1              # scrapes sample nothing
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(url + "/other", timeout=5)
        assert e.value.code == 404
    finally:
        exp.close()
    assert exp.port is None


def _exporter_script(mod, tmp_path, tag):
    """The same sources, sinks and calls through one package's exporter;
    returns what a caller can see."""
    path = str(tmp_path / f"{tag}.jsonl")
    sink = _ListSink()
    exp = mod.MetricsExporter(sinks=[mod.JsonlSeriesSink(path), sink],
                              interval_s=60.0)
    state = {"n": 0}

    def src():
        state["n"] += 1
        return {"count": state["n"], "ok": True, "name": "skipme",
                "nested": {"x": 1}}

    exp.add_source("fleet", src)
    exp.add_source("bad", lambda: 1 / 0)
    exp.add_source("", lambda: {"v": 7})

    class _Broken:
        def write(self, point):
            raise OSError("disk full")

        def close(self):
            raise OSError("still full")

    exp.add_sink(_Broken())
    got = [exp.sample(force=True), exp.sample(), exp.sample(force=True)]
    exp.close()
    strip = [{k: v for k, v in p.items() if k not in ("t", "t_mono")}
             if p else p for p in got]
    lines = [{k: v for k, v in json.loads(x).items()
              if k not in ("t", "t_mono")} for x in open(path)]
    return (strip, lines, [{k: v for k, v in p.items()
                            if k not in ("t", "t_mono")}
                           for p in sink.points],
            exp.source_errors, exp.sink_errors, exp.n_snapshots,
            state["n"])


def test_exporter_sources_sinks_throttle_equal_jax(tmp_path):
    port = _exporter_script(dtdl_tpu_torch.obs, tmp_path, "port")
    jax_ = _exporter_script(jobs, tmp_path, "jax")
    assert port == jax_
    points, lines, _, src_err, sink_err, n, calls = port
    assert points[0] == {"fleet_count": 1, "fleet_ok": 1, "v": 7}
    assert points[1] is None and calls == 2     # throttled: no source read
    assert lines == [p for p in points if p]
    assert (src_err, sink_err, n) == (2, 2, 2)


# ---------------------------------------------------------------------------
# SLOs
# ---------------------------------------------------------------------------

def _series(seed, n=40):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        p = {"ttft_s_p99": float(rng.choice([0.05, 0.2, 0.09, 0.0])),
             "fin": int(rng.integers(0, 6)), "fail": int(rng.integers(0, 2)),
             "exp": int(rng.integers(0, 2)),
             "rate": float(rng.choice([0.0, 0.3, 0.8])),
             "drafted": int(rng.integers(0, 2))}
        if rng.random() < 0.1:
            p = {}
        out.append((float(i * 0.7), p))
    return out


def _slo_decls(mod):
    return [mod.SLO("ttft_p99", metric="ttft_s_p99", op="<=", target=0.1),
            mod.SLO("availability", good="fin", bad=("fail", "exp"),
                    target=0.9, window_s=5.0, burn_alert=2.0),
            mod.SLO("acc", metric="rate", op=">=", target=0.5,
                    gate="drafted"),
            mod.SLO("zero", metric="ttft_s_p99", op="<=", target=0.0)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slo_fields_and_events_equal_jax(seed):
    """Gauge (both ops, a zero target), ratio (rolling window, burn
    alert above 1) and gated objectives over one seeded series: the same
    fields on every point, the same crossing events with the same args,
    the same summary."""
    tt, jt = Tracer(), jobs.Tracer()
    ev = SLOEvaluator(_slo_decls(dtdl_tpu_torch.obs),
                      observer=Observer(trace=tt, sentinel=None))
    jev = jobs.SLOEvaluator(_slo_decls(jobs),
                            observer=jobs.Observer(trace=jt, sentinel=None))
    for now, point in _series(seed):
        out = ev.evaluate(point, now=now)
        assert out == jev.evaluate(point, now=now)
        json.dumps(out)                           # strict JSON: capped
    assert ev.summary() == jev.summary()

    def evs(t):
        return [(e["name"], e.get("args")) for e in
                t.to_chrome()["traceEvents"] if e["ph"] == "i"]

    assert evs(tt) == evs(jt)
    assert {n for n, _ in evs(tt)} <= {"slo_breach", "slo_recovered",
                                        "slo_burn_rate"}
    assert evs(tt)


def test_slo_declarations_and_validation_equal_jax():
    def decl(slos):
        return [(s.name, s.metric, s.op, s.target, s.good, s.bad,
                 s.window_s, s.burn_alert, s.gate) for s in slos]

    for kw in ({}, {"step_time_s": 0.2}, {"bad_step_ratio": 0.01},
               {"step_time_s": 0.2, "bad_step_ratio": 0.05,
                "window_s": 3.0}):
        assert decl(default_train_slos(**kw)) == decl(jax_train_slos(**kw))
    for kw in ({}, {"ttft_p99_s": 0.5}, {"availability": 0.999},
               {"ttft_p99_s": 0.5, "availability": 0.99,
                "acceptance_rate": 0.6, "window_s": 4.0}):
        assert decl(default_fleet_slos(**kw)) == decl(jax_fleet_slos(**kw))
    bad = [dict(target=None, metric="m"), dict(target=0.9),
           dict(metric="m", good="g", bad="b", target=0.9),
           dict(metric="m", op="<", target=1.0),
           dict(good="g", target=0.9), dict(good="g", bad="b", target=1.5)]
    for kw in bad:
        with pytest.raises(ValueError):
            SLO("x", **kw)
        with pytest.raises(ValueError):
            jobs.SLO("x", **kw)
    with pytest.raises(ValueError, match="bad_step_ratio"):
        default_train_slos(bad_step_ratio=1.5)
    with pytest.raises(ValueError, match="duplicate"):
        SLOEvaluator([SLO("a", metric="m", target=1),
                      SLO("a", metric="m", target=1)])


# ---------------------------------------------------------------------------
# the catalog audit
# ---------------------------------------------------------------------------

# the resilience plane's names: catalogued, emitted once A13b ports
# resil/guard.py, train/trainer.py's rollback, resil/elastic.py and
# parallel/tcpstore.py
A13B_NAMES = {"guard_bad_step", "guard_rollback", "trainer_rollback",
              "elastic_peer_lost", "elastic_rendezvous", "elastic_restore",
              "elastic_snapshot", "elastic_stale_fenced",
              "elastic_step_timeout", "store_reconnect", "store_torn_frame",
              "store_epoch_refused", "store_wal_recovered"}


def test_catalog_audit_of_the_port_tree():
    """Every literal name and f-string family passed to .span( / .event( /
    .instant( / .flow( anywhere in dtdl_tpu_torch/ is catalogued (flows
    carry the one chain name "req"); the catalog names the port does not
    emit are exactly the A13b resilience plane's."""
    pkg = pathlib.Path(dtdl_tpu_torch.__file__).parent
    pat = re.compile(r"\.(span|event|instant|flow)\(\s*(f?)\"([^\"]+)\"")
    found = {"span": set(), "event": set(), "instant": set(),
             "flow": set()}
    for py in sorted(pkg.rglob("*.py")):
        for m in pat.finditer(py.read_text()):
            kind, is_f, name = m.groups()
            if is_f:
                assert name == "replica_{state}", (
                    f"{py}: un-auditable dynamic {kind} name {name!r}")
                names = {name.replace("{state}", s) for s in STATES}
            else:
                assert "{" not in name, (py, name)
                names = {name}
            found[kind] |= names
    events = found["event"] | found["instant"]
    assert found["span"] == SPAN_CATALOG, (
        f"uncatalogued spans: {sorted(found['span'] - SPAN_CATALOG)}; "
        f"never emitted: {sorted(SPAN_CATALOG - found['span'])}")
    assert events <= EVENT_CATALOG, \
        f"uncatalogued events: {sorted(events - EVENT_CATALOG)}"
    assert EVENT_CATALOG - events == A13B_NAMES, \
        sorted(EVENT_CATALOG - events)
    assert found["flow"] == {"req"}


# ---------------------------------------------------------------------------
# timelines against the JAX scheduler
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    return jax_pair(**CFG)


@pytest.fixture(scope="module")
def engine(models):
    _, _, tm = models
    return InferenceEngine(tm, n_slots=2, buckets=(8,), page_size=0,
                           device="cpu")


@pytest.fixture(scope="module")
def oracle(models, engine):
    """Six prompts' greedy tokens from the port's single scheduler."""
    prompts = mk_prompts(6)
    reqs = [Request(list(p), N_NEW) for p in prompts]
    Scheduler(engine, harvest_lag=1, device="cpu").run(reqs)
    return prompts, [r.tokens for r in reqs]


def _structure(obs, req, rid_map):
    """A request's timeline as (name, phase, args with the correlation
    ids renamed by order of appearance), timestamps and threads aside."""
    out = []
    for e in obs.request_timeline(req.rid):
        args = dict(e.get("args", {}))
        for k in ("rid", "arid"):
            if k in args:
                args[k] = rid_map.setdefault(args[k], len(rid_map))
        if e.get("cat") == "request":
            out.append((e["name"], e["ph"], rid_map.setdefault(
                e["id"], len(rid_map))))
        else:
            out.append((e["name"], e["ph"], tuple(sorted(args.items()))))
    return out


@pytest.mark.parametrize("page", [0, 8], ids=["dense", "paged"])
def test_scheduler_timelines_equal_jax(models, page):
    """The same six requests through the JAX scheduler (copying engine)
    and the port's, both observed with an exporter: equal tokens, and
    every request's timeline has the same events in the same order with
    the same args (admission, first token, finish, the flow chain opened
    at admission and closed at the finish)."""
    jm, params, tm = models
    prompts = mk_prompts(6)
    geo = {"page_size": page} if page else {}
    jeng = CopyingJaxEngine(jm, params, n_slots=2, buckets=(8,), **geo)
    eng = InferenceEngine(tm, n_slots=2, buckets=(8,), device="cpu", **geo)
    jobs_ = jobs.Observer(trace=True, sentinel=None)
    tobs = Observer(trace=True, sentinel=None)
    jexp, texp = jobs.MetricsExporter(interval_s=0.0), \
        MetricsExporter(interval_s=0.0)
    jreqs = [JaxRequest(list(p), N_NEW) for p in prompts]
    treqs = [Request(list(p), N_NEW) for p in prompts]
    JaxScheduler(jeng, harvest_lag=1, observer=jobs_, exporter=jexp).run(
        jreqs)
    sched = Scheduler(eng, harvest_lag=1, observer=tobs, exporter=texp,
                      device="cpu")
    sched.run(treqs)
    assert [r.tokens for r in treqs] == [r.tokens for r in jreqs]
    for jr, tr in zip(jreqs, treqs):
        want, got = _structure(jobs_, jr, {}), _structure(tobs, tr, {})
        assert got == want
        names = [n for n, ph, _ in got if ph in ("i", "X")]
        assert names[0] == "prefill" and names.index(
            "request_admitted") < names.index("request_first_token") < \
            names.index("request_finished")
        flows = [ph for n, ph, _ in got if n == "req"]
        assert flows == ["s", "f"]
    admitted = next(e for e in tobs.request_timeline(treqs[0].rid)
                    if e["name"] == "request_admitted")
    assert admitted["args"]["rid"] == corr_rid(treqs[0].rid)
    assert admitted["args"]["lineage"] == "primary"
    # boundary sampling: at most a point a step plus the drains
    assert 1 <= texp.n_snapshots <= sched.step_count + 2
    # every field JAX's scheduler exports is exported (the port's books
    # carry a few more, e.g. prefix_hit_pages)
    assert set(jexp.last_point) <= set(texp.last_point)
    # the span counts by name agree too (the spans' phases are JAX's)
    count = lambda o: sorted(  # noqa: E731
        (n, sum(1 for e in o.tracer.to_chrome()["traceEvents"]
                if e["name"] == n and e["ph"] == "X"))
        for n in ("admit", "prefill", "dispatch", "harvest", "drain"))
    assert count(tobs) == count(jobs_)


def test_standalone_error_terminal_closes_flow_chain_as_jax(models):
    """Expiry after admission and a cancel in a slot end with a flow 'f'
    in both schedulers, the same event structure each."""
    jm, params, tm = models
    jeng = CopyingJaxEngine(jm, params, n_slots=2, buckets=(8,))
    eng = InferenceEngine(tm, n_slots=2, buckets=(8,), device="cpu")
    got = {}
    for tag, sch, req_cls, obs in (
            ("jax", lambda o: JaxScheduler(jeng, harvest_lag=1, observer=o),
             JaxRequest, jobs.Observer(trace=True, sentinel=None)),
            ("port", lambda o: Scheduler(eng, harvest_lag=1, observer=o,
                                         device="cpu"),
             Request, Observer(trace=True, sentinel=None))):
        sched = sch(obs)
        expired = req_cls(mk_prompts(1, seed=30)[0], 20, deadline_s=30.0)
        cancelled = req_cls(mk_prompts(1, seed=31)[0], 20)
        sched.submit(expired)
        sched.submit(cancelled)
        sched.step()
        expired.deadline_at = time.perf_counter() - 1.0
        sched.step()
        sched.cancel(cancelled.rid, "test")
        sched.run()
        assert error_kind(expired.error) == "expired"
        assert error_kind(cancelled.error) == "aborted"
        got[tag] = [_structure(obs, r, {}) for r in (expired, cancelled)]
        for tl in got[tag]:
            flows = [ph for n, ph, _ in tl if n == "req"]
            assert flows[0] == "s" and flows[-1] == "f"
    # the expiry's message differs by package (the JAX one names the
    # budget); the structure, args included, does not
    assert got["port"] == got["jax"]


# ---------------------------------------------------------------------------
# the Router: JAX's tests' structure
# ---------------------------------------------------------------------------

def kw(**over):
    base = dict(sched_kwargs={"harvest_lag": 1}, retry_budget=3,
                probe_interval_s=0.01, watchdog_s=1.0, device="cpu")
    base.update(over)
    return base


def test_hedged_failover_single_correlated_timeline(engine, oracle):
    """Replica 0's engine dies on every call, hedging re-submits to
    replica 1 and the hedge wins: one timeline under the user rid holds
    both sibling attempts (distinct arids, lineage primary and hedge),
    one terminal naming the winner, and a flow chain opened at intake and
    closed once, across at least two threads."""
    prompts, want = oracle
    plan = FaultPlan()
    for k in range(50):
        plan.at(replica_site(0, "engine"), k)
    obs = Observer(trace=True, sentinel=None)
    with Router(engine, n_replicas=2, plan=plan, auto_restart=False,
                observer=obs, hedge_after_s=0.0,
                **kw(recover_after=50)) as router:
        reqs = router.run([Request(list(p), N_NEW) for p in prompts])
        s = router.summary()
    for r, toks in zip(reqs, want):
        assert r.error is None and r.tokens == toks
    assert s["fleet_accounting_ok"] and s["fleet_hedges"] >= 1
    probe = None
    for r in reqs:
        tl = obs.request_timeline(r.rid)
        lineages = {e["args"]["lineage"] for e in tl
                    if e.get("args", {}).get("lineage")}
        if {"primary", "hedge"} <= lineages:
            probe, timeline = r, tl
            break
    assert probe is not None, "no request was hedged"
    names = [e["name"] for e in timeline]
    assert names[0] == "request_submitted" and "request_hedged" in names
    arids = {e["args"]["arid"] for e in timeline
             if "arid" in e.get("args", {})}
    assert len(arids) == 2
    assert all(e["args"]["rid"] == corr_rid(probe.rid)
               for e in timeline if "rid" in e.get("args", {}))
    done = [e for e in timeline if e["name"] == "request_done"]
    assert len(done) == 1
    assert done[0]["args"]["kind"] == "finished"
    assert done[0]["args"]["attempts"] == 2 and done[0]["args"]["hedged"] == 1
    finished = {e["args"]["arid"] for e in timeline
                if e["name"] == "request_finished"}
    assert done[0]["args"]["arid"] in finished
    flows = [e["ph"] for e in timeline if e.get("cat") == "request"]
    assert flows[0] == "s" and "t" in flows
    assert flows.count("s") == 1 and flows.count("f") == 1
    assert len({e["tid"] for e in timeline}) >= 2
    ts = {e["name"]: e["ts"] for e in timeline}
    assert ts["request_submitted"] <= ts["request_dispatched"]
    # every user request: exactly one terminal and one chain, opened at
    # intake and closed once (a losing attempt still running when the
    # terminal closed it may add steps after the end, as in JAX)
    for r in reqs:
        tl = obs.request_timeline(r.rid)
        assert sum(e["name"] == "request_done" for e in tl) == 1
        fl = [e["ph"] for e in tl if e.get("cat") == "request"]
        assert fl[0] == "s" and fl.count("s") == 1 and fl.count("f") == 1
        done = next(e["ts"] for e in tl if e["name"] == "request_done")
        end = next(e["ts"] for e in tl if e.get("ph") == "f")
        assert end >= done


def test_rejected_intake_timeline_has_no_dangling_flow(engine, oracle):
    prompts, _ = oracle
    obs = Observer(trace=True, sentinel=None)
    router = Router(engine, n_replicas=1, observer=obs, warmup=False,
                    **kw(poll_s=0.05, probe_interval_s=1.0))
    try:
        router.shutdown()
        late = router.submit(Request(list(prompts[0]), N_NEW))
        assert late.error.startswith("rejected:")
        tl = obs.request_timeline(late.rid)
        assert [e["name"] for e in tl] == ["request_done"]
        assert tl[0]["args"] == {"rid": corr_rid(late.rid),
                                 "kind": "rejected", "attempts": 0}
    finally:
        router.shutdown()
    names = [e["name"] for e in obs.tracer.to_chrome()["traceEvents"]]
    assert names.count("router_shutdown") == 1


def test_failover_exported_series_holds_invariant(engine, oracle, tmp_path):
    """The failover run with the exporter and SLOs attached: tokens as
    the single scheduler's, and the accounting invariant holds in the
    exported series (the window deltas telescope to the settled books)."""
    prompts, want = oracle
    plan = FaultPlan()
    for k in range(50):
        plan.at(replica_site(0, "engine"), k)
    path = str(tmp_path / "series.jsonl")
    exp = MetricsExporter(sinks=[JsonlSeriesSink(path)], interval_s=0.0)
    with Router(engine, n_replicas=2, plan=plan, auto_restart=False,
                exporter=exp,
                slos=default_fleet_slos(ttft_p99_s=60.0, availability=0.5),
                **kw(recover_after=50)) as router:
        reqs = router.run([Request(list(p), N_NEW) for p in prompts])
    s = router.summary()
    for r, toks in zip(reqs, want):
        assert r.error is None and r.tokens == toks, r
    assert s["fleet_retries"] >= 1 and s["fleet_accounting_ok"]
    pts = [json.loads(x) for x in open(path)]
    terms = ("finished", "rejected", "expired", "failed", "aborted")
    sums = {k: sum(p.get(f"fleet_requests_{k}", 0) for p in pts)
            for k in ("submitted",) + terms}
    assert sums["submitted"] == sum(sums[k] for k in terms) == 6
    assert sums["finished"] == s["fleet_requests_finished"] == 6
    assert any("slo_availability_ok" in p for p in pts)
    assert s["slo_breach_events"] == 0
    assert s["export_snapshots"] == len(pts)


def test_slo_detects_injected_ttft_regression(engine, oracle):
    """A loop-site stall (0.35 s, watchdog out of reach) delays every
    first token past a 50 ms TTFT target: the breach and the burn-rate
    crossing land as trace events and as fields of an exported point."""
    prompts, _ = oracle
    plan = FaultPlan().at(replica_site(0, "loop"), 0, kind="stall",
                          seconds=0.35)
    obs = Observer(trace=True, sentinel=None)
    sink = _ListSink()
    exp = MetricsExporter(sinks=[sink], interval_s=0.0)
    with Router(engine, n_replicas=1, plan=plan, observer=obs, exporter=exp,
                slos=default_fleet_slos(ttft_p99_s=0.05),
                sched_kwargs={"harvest_lag": 1}, retry_budget=0,
                probe_interval_s=0.01, watchdog_s=30.0,
                device="cpu") as router:
        reqs = router.run([Request(list(p), N_NEW) for p in prompts])
        s = router.summary()
    assert all(r.error is None for r in reqs)
    assert s["fleet_evictions"] == 0
    assert s["slo_breach_events"] >= 1 and s["slo_burn_crossings"] >= 1
    assert s["slo_ttft_p99_ok"] == 0
    names = [e["name"] for e in obs.tracer.to_chrome()["traceEvents"]]
    assert "slo_breach" in names and "slo_burn_rate" in names
    breached = [p for p in sink.points if p.get("slo_ttft_p99_ok") == 0]
    assert breached and breached[-1]["slo_ttft_p99_burn"] > 1.0


def test_slo_detects_injected_availability_breach(engine, oracle):
    prompts, _ = oracle
    plan = FaultPlan()
    for i in (0, 1):
        for k in range(200):
            plan.at(replica_site(i, "engine"), k)
    obs = Observer(trace=True, sentinel=None)
    sink = _ListSink()
    exp = MetricsExporter(sinks=[sink], interval_s=0.0)
    with Router(engine, n_replicas=2, plan=plan, auto_restart=False,
                observer=obs, exporter=exp,
                slos=default_fleet_slos(availability=0.999),
                **kw(retry_budget=0, evict_after=100,
                     recover_after=1)) as router:
        reqs = router.run([Request(list(p), N_NEW) for p in prompts[:3]],
                          timeout_s=60)
        s = router.summary()
    for r in reqs:
        assert r.error is not None and error_kind(r.error) == "failed"
    assert s["fleet_requests_failed"] == 3 and s["fleet_accounting_ok"]
    assert s["slo_breach_events"] >= 1 and s["slo_burn_crossings"] >= 1
    assert s["slo_availability_ok"] == 0
    names = [e["name"] for e in obs.tracer.to_chrome()["traceEvents"]]
    assert "slo_breach" in names and "slo_burn_rate" in names
    bad = [p for p in sink.points if p.get("slo_availability_ok") == 0]
    assert bad and bad[-1]["slo_availability_burn"] >= 100
    assert bad[-1]["slo_availability_sli"] == 0.0


# ---------------------------------------------------------------------------
# ROADMAP C7: a working replica is not a wedged one
# ---------------------------------------------------------------------------

def _slow_engine(tm, prefill_s):
    """An engine whose every prefill takes ``prefill_s`` more host time
    (a sleep, as a GIL-starved eager prefill of a wide model)."""
    eng = InferenceEngine(tm, n_slots=4, buckets=(8,), device="cpu")
    fast = eng.prefill

    def slow(*a, **k):
        time.sleep(prefill_s)
        return fast(*a, **k)

    eng.prefill = slow
    return eng


def test_c7_four_slow_admissions_in_one_step_evict_nothing(models):
    """Four 0.12 s prefills admitted in one step make a 0.48 s worker
    iteration (the trace's admit span), twice the 0.25 s watchdog; the
    worker beats after each prefill, so no replica is suspected and every
    request finishes, with no gap between beats near the watchdog."""
    _, _, tm = models
    eng = _slow_engine(tm, 0.12)
    obs = Observer(trace=True, sentinel=None)
    prompts = mk_prompts(8, seed=5)
    with Router(eng, n_replicas=1, observer=obs, warmup=False,
                sched_kwargs={"harvest_lag": 1}, probe_interval_s=0.01,
                watchdog_s=0.25, device="cpu") as router:
        reqs = router.run([Request(list(p), N_NEW) for p in prompts])
        s = router.summary()
        gap = router.replicas[0].max_beat_gap_s
    assert all(r.error is None and len(r.tokens) == N_NEW for r in reqs)
    assert s["fleet_evictions"] == 0 and s["fleet_retries"] == 0
    assert s["replica_health"] == ["healthy"]
    trace = obs.tracer.to_chrome()["traceEvents"]
    assert not [e for e in trace if e["name"].startswith("replica_")]
    admits = [e["dur"] / 1e6 for e in trace if e["name"] == "admit"]
    assert max(admits) > 0.25 * 1.5      # the iteration the old beat saw
    assert gap < 0.2


def test_c7_frozen_worker_still_caught(models):
    """The same slowed engine with a 2 s ``loop``-site stall on replica 0:
    its heartbeat freezes, the watchdog evicts it, and its requests
    finish on replica 1."""
    _, _, tm = models
    eng = _slow_engine(tm, 0.05)
    plan = FaultPlan().at(replica_site(0, "loop"), 1, kind="stall",
                          seconds=2.0)
    prompts = mk_prompts(8, seed=6)
    t0 = time.perf_counter()
    with Router(eng, n_replicas=2, plan=plan, warmup=False,
                sched_kwargs={"harvest_lag": 1}, probe_interval_s=0.01,
                watchdog_s=0.25, auto_restart=False,
                device="cpu") as router:
        reqs = router.run([Request(list(p), N_NEW) for p in prompts])
        s = router.summary()
        evicts = list(router.evict_log)
    assert all(r.error is None and len(r.tokens) == N_NEW for r in reqs)
    assert s["fleet_evictions"] == 1 and evicts[0]["replica"] == 0
    # caught inside the stall: within the watchdog plus a few ticks
    assert evicts[0]["t"] - t0 < 2.0
