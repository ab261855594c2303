"""The Router over tensor-parallel replicas (the port's fleet with
``InferenceEngine(mesh=)`` replicas) against the JAX package's single
scheduler and the port's single-engine Router.

A gloo world of 2 processes on a ``{data 1, model 2}`` mesh (this file is
the worker as ``__main__``, tests/_torch_world.py the harness) builds the
same Router on both ranks: process 0's is the front door, process 1
replays its records.  The pytest process runs the JAX single
``Scheduler`` through ``CopyingJaxEngine`` (tests/test_torch_chunked.py,
ROADMAP C1) and the port's single-engine Router on the same bridged
weights: the JAX serving tests' config (vocab 64, d_model 32, 2 layers, 2
heads, max_seq 48, f32), page 8, 2 slots.

* 1 and 2 replicas on one shared TP engine, and two TP engines on two
  sub-meshes over the same processes (one record stream, so their
  collectives reach both ranks in one order): every request carries the
  JAX scheduler's greedy tokens, on both ranks (the follower's own
  replay), and the follower's books are drained at the end.
* The fleet's faults, as tests/test_torch_fleet.py drives them: failover
  at the ``engine`` site, a ``loop``-site raise that evicts and refills,
  a stall (``loop`` site, and ``engine`` site inside the engine's turn)
  that trips the watchdog and restarts, a hedge delivered once, a rolling
  restart with zero failures, a deadline the leader's clock expires on
  both ranks.  Each user request is counted once on each rank.
* The mixed fleet: a TP prefill replica and a single-placement decode
  replica on process 0, and the other way round.
* The refusals by name (ROADMAP A12c), and of tensor-parallel replicas
  whose processes overlap in any but the Router's.
* The rank-lockstep check: each rank logs its engine calls (call number,
  kind, digest of the host inputs, the record they ran under) and its
  records; the logs are equal across the ranks, and no generation sends a
  record after a later generation of its replica began.

Tolerance: tokens, counters and logs exact.
"""

import os
import sys

from _torch_world import World, leave, serve

AXES = ("data", "model")
MESH = (1, 2)
CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, d_ff=64,
           max_seq=48)
BUCKETS = (8, 16, 32, 48)
PAGE = 8
N_NEW = 6
ITERATION = ("step", "drain", "none", "stop")


def _model(case):
    import torch

    from dtdl_tpu_torch.bridge import load_flax_params
    from dtdl_tpu_torch.models.transformer import transformer_lm

    model = transformer_lm("tiny", device="cpu", seed=None,
                           dtype=torch.float32, attn_impl="dense", **CFG)
    load_flax_params(model, case["params"], device="cpu")
    return model


def _engine(model, mesh=None):
    from dtdl_tpu_torch.serve import InferenceEngine
    kw = dict(n_slots=2, buckets=BUCKETS, page_size=PAGE, device="cpu")
    if mesh is None:
        return InferenceEngine(model, **kw)
    return InferenceEngine(model, mesh=mesh, rules="tp", **kw)


class _Spy:
    """Logs an engine's calls: (call number, kind, digest of the host
    inputs, the record it ran under: (n, replica, generation) of its
    stream, or None before the first)."""

    def __init__(self, eng):
        from dtdl_tpu_torch.parallel.collectives import tree_digest
        self.eng, self.calls, self.stream = eng, [], None
        inner = eng._lockstep

        def spy(*host):
            inner(*host)
            st = self.stream
            at = None if st is None or not st.n else (st.n,) + st.at
            self.calls.append((eng._calls, host[0], tree_digest(host), at))
        eng._lockstep = spy


def _knobs(**over):
    base = dict(sched_kwargs={"harvest_lag": 1}, retry_budget=3,
                probe_interval_s=0.01, watchdog_s=1.0, device="cpu")
    base.update(over)
    return base


def _report(router, reqs, spies):
    s = router.summary()
    keep = ("fleet_requests_submitted", "fleet_requests_finished",
            "fleet_requests_expired", "fleet_requests_failed",
            "fleet_requests_aborted", "fleet_requests_rejected",
            "fleet_accounting_ok", "fleet_retries", "fleet_hedges",
            "fleet_hedges_won", "fleet_evictions", "fleet_failovers",
            "fleet_restarts", "fleet_migrations", "replica_health")
    out = {"tokens": [r.tokens for r in reqs],
           "errors": [r.error for r in reqs],
           "done": [r.done for r in reqs],
           "leader": router.is_leader,
           "summary": {k: s[k] for k in keep},
           "replicas": [None if rep is None else
                        {k: rep.metrics.summary()[k] for k in
                         ("requests_finished", "requests_expired",
                          "requests_failed", "decode_tokens")}
                        for rep in router.replicas],
           "restarts": [None if rep is None else rep.restarts
                        for rep in router.replicas],
           "records": {k: list(st.log) for k, st in
                       enumerate(router._streams.values())},
           "calls": {k: sp.calls for k, sp in enumerate(spies)},
           "pump_error": router.pump_error,
           # a follower's unsettled users and unclaimed outcomes
           "books": [len(router._users), len(router._outcomes)]}
    if router.is_leader:
        out["served"] = sorted({e[1] for e in router.dispatch_log})
        out["transitions"] = [[(a, b) for _, a, b, _ in h.transitions]
                              for h in router.health]
        out["reasons"] = [" | ".join(c for _, _, _, c in h.transitions)
                          for h in router.health]
        out["detect"] = [e["detect_latency_s"] for e in router.evict_log]
    return out


def _serve(router, spies, prompts, during=None, timeout_s=60, **req_kw):
    """``prompts`` through ``router`` (``during(router, reqs)`` after the
    submits, before the wait), then the shutdown: the rank's report."""
    from dtdl_tpu_torch.serve import Request
    for sp in spies:
        sp.stream = router._streams[sp.eng.control_ranks]
    with router:
        reqs = [Request(list(p), N_NEW, **req_kw) for p in prompts]
        for r in reqs:
            router.submit(r)
        if during is not None:
            during(router, reqs)
        router.wait(reqs, timeout_s=timeout_s)
    return _report(router, reqs, spies)


def run_case(mesh, name, case):
    from dtdl_tpu_torch.resil.faults import FaultPlan, replica_site
    from dtdl_tpu_torch.runtime import process_index
    from dtdl_tpu_torch.runtime.mesh import MODEL_AXIS, sub_mesh
    from dtdl_tpu_torch.serve import Request, Router

    model = _model(case)
    prompts = case["prompts"]
    leader = process_index() == 0
    if name == "refusal":
        tp = _engine(model, mesh)
        try:
            if leader:
                Router([tp, None], **_knobs())
            else:
                Router([tp, _engine(model)], **_knobs(), roles=[
                    "prefill", "decode"])
        except NotImplementedError as e:
            return {"refused": str(e)}
        return {"refused": None}
    if name == "two_engines":
        meshes = [sub_mesh((0, 1), MODEL_AXIS), sub_mesh((0, 1), MODEL_AXIS)]
        engines = [_engine(model, m) for m in meshes]
        spies = [_Spy(e) for e in engines]
        return _serve(Router(engines, **_knobs()), spies, prompts)
    if name.startswith("mixed"):
        tp = _engine(model, mesh)
        spies = [_Spy(tp)]
        single = _engine(model) if leader else None
        engines = [tp, single] if name == "mixed_tp_prefill" else [single, tp]
        return _serve(Router(engines, roles=["prefill", "decode"],
                             **_knobs()), spies, prompts)
    tp = _engine(model, mesh)
    spies = [_Spy(tp)]
    plan, knobs, during, n = None, _knobs(), None, 2
    if name == "shared1":
        n = 1
    elif name == "engine_fault":
        plan = FaultPlan()
        for k in range(50):
            plan.at(replica_site(0, "engine"), k)
        knobs = _knobs(auto_restart=False, recover_after=50)
    elif name == "loop_fault":
        plan = FaultPlan().at(replica_site(0, "loop"), 0)
    elif name in ("stall_loop", "stall_engine"):
        site = name.split("_")[1]
        plan = FaultPlan().at(replica_site(0, site), 1 if site == "engine"
                              else 0, kind="stall", seconds=0.8)
        knobs = _knobs(watchdog_s=0.1, probe_interval_s=0.02)
    elif name == "hedge":
        knobs = _knobs(hedge_after_s=0.0)
    elif name == "rolling":
        prompts = prompts * 2

        def during(router, reqs):
            router.rolling_restart(timeout_s=30)
    elif name == "deadline":
        n = 1
        plan = FaultPlan().at(replica_site(0, "loop"), 0, kind="stall",
                              seconds=0.3)
        knobs = _knobs(watchdog_s=5.0, probe_interval_s=0.05)
        router = Router(tp, n_replicas=n, plan=plan, **knobs)
        spies[0].stream = router._streams[tp.control_ranks]
        with router:
            reqs = [Request(list(prompts[0]), N_NEW, deadline_s=0.15),
                    Request(list(prompts[1]), N_NEW)]
            router.run(reqs, timeout_s=60)
        return _report(router, reqs, spies)
    router = Router(tp, n_replicas=n, plan=plan, **knobs)
    return _serve(router, spies, prompts, during=during)


if __name__ == "__main__":
    leave(serve(run_case, AXES))

# ---- the pytest side (the JAX oracle) ---------------------------------------

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from dtdl_tpu.serve import Request as JaxRequest  # noqa: E402
from dtdl_tpu.serve import Scheduler as JaxScheduler  # noqa: E402
from dtdl_tpu_torch.serve import (HEALTHY, DRAINING, EVICTED,  # noqa: E402
                                  InferenceEngine, Request, Router,
                                  Scheduler, SUSPECT)
from test_torch_chunked import CopyingJaxEngine, jax_pair  # noqa: E402

torch.set_num_threads(1)

CASES = ("shared1", "shared2", "two_engines", "engine_fault", "loop_fault",
         "stall_loop", "stall_engine", "hedge", "rolling", "deadline",
         "mixed_tp_prefill", "mixed_tp_decode", "refusal")


def mk_prompts(n, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 64, int(rng.integers(3, 8))).tolist()
            for _ in range(n)]


PROMPTS = mk_prompts(6)


@pytest.fixture(scope="module")
def models():
    return jax_pair(**CFG)


@pytest.fixture(scope="module")
def world(models, tmp_path_factory):
    params = jax.device_get(models[1])
    cases = {name: dict(params=params, prompts=PROMPTS) for name in CASES}
    return World(__file__, MESH, cases, tmp_path_factory.mktemp("fleettp"),
                 timeout=240)


@pytest.fixture(scope="module")
def oracle(models):
    """The JAX single Scheduler's greedy tokens of PROMPTS, which the
    port's single Scheduler and its single-engine Router equal."""
    jm, params, tm = models
    jeng = CopyingJaxEngine(jm, params, n_slots=2, buckets=BUCKETS,
                            page_size=PAGE, paged_kernel=False)
    jreqs = [JaxRequest(list(p), N_NEW) for p in PROMPTS]
    JaxScheduler(jeng, harvest_lag=1).run(jreqs)
    want = [r.tokens for r in jreqs]
    eng = InferenceEngine(tm, n_slots=2, buckets=BUCKETS, page_size=PAGE,
                          device="cpu")
    reqs = [Request(list(p), N_NEW) for p in PROMPTS]
    Scheduler(eng, harvest_lag=1, device="cpu").run(reqs)
    assert [r.tokens for r in reqs] == want
    with Router(eng, n_replicas=2, sched_kwargs={"harvest_lag": 1},
                device="cpu") as router:
        fleet = router.run([Request(list(p), N_NEW) for p in PROMPTS])
    assert [r.tokens for r in fleet] == want
    assert all(len(t) == N_NEW for t in want)
    return want


def _outs(world, name):
    outs = [o["cases"][name] for o in world.results()]
    assert [o.get("leader") for o in outs] in ([True, False], [None, None])
    return outs


def _identical(out, want):
    assert out["errors"] == [None] * len(want), out["errors"]
    assert out["tokens"] == want
    assert all(out["done"])


def _counted_once(outs, n):
    for o in outs:
        s = o["summary"]
        assert s["fleet_accounting_ok"]
        assert s["fleet_requests_submitted"] == n
        assert o["books"] == [0, 0]
    assert outs[0]["pump_error"] is None and outs[1]["pump_error"] is None


@pytest.mark.parametrize("name,n_replicas",
                         [("shared1", 1), ("shared2", 2),
                          ("two_engines", 2)])
def test_tp_router_tokens_equal_jax(world, oracle, name, n_replicas):
    """One and two replicas on one TP engine, and two TP engines on two
    sub-meshes: the JAX scheduler's tokens on both ranks; every replica
    takes traffic.  Replicas on one set of processes share one record
    stream, whether they share an engine or not."""
    outs = _outs(world, name)
    for o in outs:
        _identical(o, oracle)
        assert o["summary"]["fleet_requests_finished"] == len(PROMPTS)
        assert sum(r["requests_finished"] for r in o["replicas"]) == 6
    _counted_once(outs, len(PROMPTS))
    assert outs[0]["served"] == list(range(n_replicas))
    # the follower served the same attempts on the same replicas
    assert outs[0]["replicas"] == outs[1]["replicas"]
    assert len(outs[0]["records"]) == 1


def test_failover_at_the_engine_site(world, oracle):
    """Replica 0's engine raises on every call, on both ranks at the same
    call: the flights retry on replica 1 with JAX's tokens, each request
    counted once."""
    outs = _outs(world, "engine_fault")
    for o in outs:
        _identical(o, oracle)
        assert o["summary"]["fleet_requests_finished"] == 6
    _counted_once(outs, 6)
    s = outs[0]["summary"]
    assert s["fleet_retries"] >= 1
    assert outs[0]["transitions"][0][0] == (HEALTHY, SUSPECT)
    assert s["replica_health"][0] in (SUSPECT, EVICTED)
    assert outs[0]["replicas"] == outs[1]["replicas"]


def test_loop_site_raise_evicts_and_refills(world, oracle):
    outs = _outs(world, "loop_fault")
    for o in outs:
        _identical(o, oracle)
    _counted_once(outs, 6)
    s = outs[0]["summary"]
    assert s["fleet_evictions"] == 1 and s["fleet_restarts"] == 1
    assert s["fleet_failovers"] >= 1
    assert s["replica_health"] == [HEALTHY, HEALTHY]
    assert outs[0]["transitions"][0] == [
        (HEALTHY, SUSPECT), (SUSPECT, EVICTED), (EVICTED, DRAINING),
        (DRAINING, HEALTHY)]
    assert outs[0]["detect"][0] is not None
    # the follower dropped the dead generation's scheduler as the leader
    assert outs[1]["restarts"] == outs[0]["restarts"] == [1, 0]


@pytest.mark.parametrize("site", ["loop", "engine"])
def test_stall_trips_the_watchdog_and_restarts(world, oracle, site):
    """A frozen worker (outside the engine's turn at the ``loop`` site,
    inside it at the ``engine`` site) is evicted and restarted; the
    traffic completes with JAX's tokens on both ranks."""
    outs = _outs(world, f"stall_{site}")
    for o in outs:
        _identical(o, oracle)
    _counted_once(outs, 6)
    assert outs[0]["summary"]["fleet_evictions"] >= 1
    assert "stall" in outs[0]["reasons"][0] or "probe" in \
        outs[0]["reasons"][0]
    assert outs[1]["restarts"] == outs[0]["restarts"]
    assert outs[0]["restarts"][0] >= 1


def test_hedge_delivers_exactly_once(world, oracle):
    outs = _outs(world, "hedge")
    for o in outs:
        _identical(o, oracle)
        assert o["summary"]["fleet_requests_finished"] == 6
    _counted_once(outs, 6)
    s = outs[0]["summary"]
    assert s["fleet_hedges"] >= 1
    assert s["fleet_hedges_won"] <= s["fleet_hedges"]


def test_rolling_restart_zero_failures(world, oracle):
    outs = _outs(world, "rolling")
    for o in outs:
        _identical(o, oracle * 2)
        s = o["summary"]
        assert s["fleet_requests_failed"] == s["fleet_requests_aborted"] == 0
    _counted_once(outs, 12)
    assert outs[0]["summary"]["fleet_restarts"] == 2
    assert outs[0]["restarts"] == outs[1]["restarts"] == [1, 1]


def test_deadline_expired_by_the_leaders_clock(world, oracle):
    """A request whose deadline passes while its replica stalls expires
    in the scheduler on both ranks (the leader's clock, through
    ``engine.agree``); the other finishes with JAX's tokens."""
    outs = _outs(world, "deadline")
    for o in outs:
        assert o["errors"][0].startswith("expired:"), o["errors"]
        assert o["errors"][1] is None and o["tokens"][1] == oracle[1]
        assert o["summary"]["fleet_requests_expired"] == 1
        assert o["replicas"][0]["requests_expired"] == 1
    assert outs[0]["errors"] == outs[1]["errors"]
    _counted_once(outs, 2)


@pytest.mark.parametrize("name", ["mixed_tp_prefill", "mixed_tp_decode"])
def test_mixed_fleet_hands_pages_both_ways(world, oracle, name):
    """TP prefill -> single decode on process 0, and single prefill -> TP
    decode: JAX's undisaggregated tokens, every flight migrated once."""
    outs = _outs(world, name)
    for o in outs:
        _identical(o, oracle)
    _counted_once(outs, 6)
    assert outs[0]["summary"]["fleet_migrations"] == 6
    held = [i for i, r in enumerate(outs[1]["replicas"]) if r is not None]
    assert held == ([0] if name == "mixed_tp_prefill" else [1])
    for i in held:
        assert outs[1]["replicas"][i] == outs[0]["replicas"][i]


def test_refusal_by_name(world):
    """The leader given a replica it holds no rank of, and a follower
    given a single-placement engine: each refused before any collective,
    naming A12c."""
    outs = _outs(world, "refusal")
    assert "is not on the Router's process 0" in outs[0]["refused"]
    assert "single-placement engine on process 1" in outs[1]["refused"]
    assert all("A12c" in o["refused"] for o in outs)


@pytest.mark.parametrize("sets,refused", [
    ([(0, 1), (0, 1)], False), ([(0, 1), (0, 2)], False),
    ([(0, 1, 2), (0, 1, 3)], True), ([(0, 1), (0, 1, 2)], True)])
def test_overlapping_process_sets_refused(sets, refused):
    """Tensor-parallel replicas on the same processes share one stream,
    and on processes that share only the Router's have one each; any
    other overlap would reach a process on two threads in no common
    order, and is refused by name before any collective."""
    from types import SimpleNamespace

    from dtdl_tpu_torch.serve.fleet import _router_process
    engines = [SimpleNamespace(control_ranks=r) for r in sets]
    if not refused:
        assert _router_process(engines, 0) == 0
        return
    with pytest.raises(NotImplementedError, match="A12c") as e:
        _router_process(engines, 0)
    assert "share the processes [1]" in str(e.value)


@pytest.mark.parametrize("name", [c for c in CASES if c != "refusal"])
def test_rank_lockstep_logs(world, name):
    """Each engine's calls (number, kind, digest, record) and each
    stream's records are equal on both ranks; the records of a replica
    never go back to an older generation (no collective of a fenced
    generation after the next began), and every call after the warm-up
    ran under a record of an iteration."""
    outs = _outs(world, name)
    assert outs[0]["records"] == outs[1]["records"]
    assert outs[0]["calls"] == outs[1]["calls"]
    for log in outs[0]["records"].values():
        assert log and log[-1][3] == "exit"
        gens = {}
        for n, replica, gen, action in log:
            if replica < 0:
                continue
            assert gen >= gens.get(replica, 0), (n, replica, gen, action)
            gens[replica] = gen
        kinds = {n: action for n, _, _, action in log}
        for calls in outs[0]["calls"].values():
            for _, _, _, at in calls:
                assert at is None or kinds[at[0]] in ITERATION, at
