"""The port's serving fleet against the JAX package's.

* ``ReplicaHealth`` and ``PrefixDirectory`` are host state machines: the
  same seeded operation sequences go through the JAX classes and the
  port's, and every state, listener edge and lookup must be equal.
* The Router's paths (1 and 2 replicas, failover at an ``engine`` and a
  ``loop`` fault site, the stall watchdog, the retry budget running out,
  every replica evicted, hedging, rolling restart, the bounded queue and
  deadlines) run on the CPU at the JAX serving tests' config (vocab 64,
  d_model 32, 2 layers, 2 heads, f32, bridged weights).  Every request a
  scenario finishes must carry exactly the greedy tokens of the JAX
  single ``Scheduler`` (through ``CopyingJaxEngine``, ROADMAP C1) and of
  the port's own single scheduler, which the module's oracle holds equal
  to each other first.  No JAX Router runs: the JAX fleet tests are in
  ROADMAP C3's moving set.

Tolerance: tokens exact; health states, edges and directory lookups exact.
"""

import numpy as np
import pytest
import torch

from dtdl_tpu.serve import Request as JaxRequest
from dtdl_tpu.serve import Scheduler as JaxScheduler
from dtdl_tpu.serve.fleet import PrefixDirectory as JaxDirectory
from dtdl_tpu.serve.health import ReplicaHealth as JaxHealth
from dtdl_tpu_torch.resil.faults import FaultPlan, replica_site
from dtdl_tpu_torch.serve import (DRAINING, EVICTED, HEALTHY, SUSPECT,
                                  InferenceEngine, PrefixDirectory,
                                  ReplicaHealth, Request, Router, Scheduler)
from test_torch_chunked import CopyingJaxEngine, jax_pair

# small shapes: one intra-op thread each leaves the cores to the other
# test workers
torch.set_num_threads(1)

MAX_SEQ = 32
N_NEW = 6
CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, d_ff=64,
           max_seq=MAX_SEQ)


# ---------------------------------------------------------------------------
# the host state machines against JAX's
# ---------------------------------------------------------------------------

def _health_ops(seed, n=60):
    rng = np.random.default_rng(seed)
    names = ("signal", "probe_ok", "probe_fail", "success", "drain",
             "restarted")
    weights = np.array([0.3, 0.25, 0.25, 0.1, 0.05, 0.05])
    return [names[i] for i in rng.choice(len(names), n, p=weights)]


def _apply(h, op):
    return {"signal": lambda: h.on_signal("s"),
            "probe_ok": lambda: h.on_probe(True),
            "probe_fail": lambda: h.on_probe(False),
            "success": h.on_success,
            "drain": lambda: h.start_drain("d"),
            "restarted": h.on_restarted}[op]()


@pytest.mark.parametrize("knobs", [(1, 2, 2), (2, 3, 1), (1, 1, 3)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_health_machine_matches_jax(seed, knobs):
    """The same seeded signal and probe sequence through both machines:
    identical state after every operation, identical listener edges and
    streaks."""
    edges = {"jax": [], "port": []}
    jh = JaxHealth(*knobs, listener=lambda a, b, r: edges["jax"].append(
        (a, b)))
    th = ReplicaHealth(*knobs, listener=lambda a, b, r: edges["port"].append(
        (a, b)))
    for op in _health_ops(seed):
        assert _apply(th, op) == _apply(jh, op), op
        assert (th.state, th.fail_streak, th.probe_fail_streak,
                th.probe_ok_streak, th.dispatchable) == (
            jh.state, jh.fail_streak, jh.probe_fail_streak,
            jh.probe_ok_streak, jh.dispatchable)
    assert edges["port"] == edges["jax"] and edges["port"]
    assert [t[1:] for t in th.transitions] == [t[1:] for t in jh.transitions]


def test_health_circuit_breaks_before_eviction_and_cycles():
    """SUSPECT strictly before EVICTED; the replace walks DRAINING back
    to HEALTHY; EVICTED and DRAINING absorb signals and probes."""
    h = ReplicaHealth(suspect_after=1, evict_after=2)
    assert h.on_signal("a") == SUSPECT and not h.dispatchable
    assert h.on_signal("b") == SUSPECT
    assert h.on_signal("c") == EVICTED
    assert h.on_probe(True) == EVICTED
    assert h.start_drain("replace") == DRAINING
    assert h.on_signal("ignored") == DRAINING
    assert h.on_restarted() == HEALTHY and h.dispatchable
    assert [(a, b) for _, a, b, _ in h.transitions] == [
        (HEALTHY, SUSPECT), (SUSPECT, EVICTED), (EVICTED, DRAINING),
        (DRAINING, HEALTHY)]
    with pytest.raises(ValueError, match="evict_after"):
        ReplicaHealth(evict_after=0)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_prefix_directory_matches_jax(seed):
    """Seeded add/drop/invalidate sequences over a few replicas and a
    short hash space: every lookup (longest single-owner run from the
    root) and the size equal JAX's."""
    rng = np.random.default_rng(seed)
    jd, td = JaxDirectory(), PrefixDirectory()
    for _ in range(200):
        op = rng.integers(0, 10)
        h, rep = int(rng.integers(0, 12)), int(rng.integers(0, 3))
        if op < 5:
            jd.add(h, rep), td.add(h, rep)
        elif op < 8:
            jd.drop(h, rep), td.drop(h, rep)
        elif op < 9:
            assert td.invalidate_replica(rep) == jd.invalidate_replica(rep)
        chain = [int(x) for x in rng.integers(0, 12, rng.integers(0, 6))]
        assert td.lookup(chain) == jd.lookup(chain)
        assert len(td) == len(jd)


# ---------------------------------------------------------------------------
# the Router
# ---------------------------------------------------------------------------

def mk_prompts(n, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 64, int(rng.integers(3, 8))).tolist()
            for _ in range(n)]


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
    """Six prompts' greedy tokens from the JAX single Scheduler and from
    the port's, which must be equal; returns (prompts, tokens)."""
    jm, params, _ = models
    prompts = mk_prompts(6)
    jeng = CopyingJaxEngine(jm, params, n_slots=2, buckets=(8,))
    jreqs = [JaxRequest(list(p), N_NEW) for p in prompts]
    JaxScheduler(jeng, harvest_lag=1).run(jreqs)
    reqs = [Request(list(p), N_NEW) for p in prompts]
    Scheduler(engine, harvest_lag=1, device="cpu").run(reqs)
    want = [r.tokens for r in jreqs]
    assert [r.tokens for r in reqs] == want
    assert all(len(t) == N_NEW for t in want)
    return prompts, want


def kw(**over):
    base = dict(sched_kwargs={"harvest_lag": 1}, retry_budget=3,
                probe_interval_s=0.01, watchdog_s=1.0, device="cpu")
    base.update(over)
    return base


def _identical(reqs, want):
    for r, toks in zip(reqs, want):
        assert r.done and r.error is None, r
        assert r.tokens == toks, f"{r} diverged from the single scheduler"


@pytest.mark.parametrize("n_replicas", [1, 2])
def test_router_replicas_token_identical(engine, oracle, n_replicas):
    """1 and 2 replicas: every request as the single scheduler's; two
    replicas both take traffic (least-loaded)."""
    prompts, want = oracle
    with Router(engine, n_replicas=n_replicas, **kw()) as router:
        reqs = router.run([Request(list(p), N_NEW) for p in prompts])
        served = sorted({e[1] for e in router.dispatch_log})
    _identical(reqs, want)
    s = router.summary()
    assert s["fleet_accounting_ok"] and s["fleet_requests_finished"] == 6
    assert served == list(range(n_replicas))
    assert router.pump_error is None
    assert sum(r["requests_finished"] for r in s["replicas"]) == 6


def test_failover_at_the_engine_site(engine, oracle):
    """Replica 0's engine raises on every call: its attempts fail
    (containment), the circuit opens, the flights retry on replica 1 and
    finish token-identical, each user request counted once."""
    prompts, want = oracle
    plan = FaultPlan()
    for k in range(50):
        plan.at(replica_site(0, "engine"), k)
    with Router(engine, n_replicas=2, plan=plan, auto_restart=False,
                **kw(recover_after=50)) as router:
        reqs = router.run([Request(list(p), N_NEW) for p in prompts])
        s = router.summary()
        h0 = router.health[0]
    _identical(reqs, want)
    assert s["fleet_retries"] >= 1
    assert h0.state in (SUSPECT, EVICTED)
    assert h0.transitions[0][1:3] == (HEALTHY, SUSPECT)
    assert s["fleet_requests_submitted"] == s["fleet_requests_finished"] == 6
    assert s["fleet_accounting_ok"] and router.pump_error is None


def test_failover_at_the_loop_site_evicts_and_refills(engine, oracle):
    """A dead worker (loop-site raise): detected, evicted through
    SUSPECT, its attempts failed over losslessly, and the replica refilled
    through DRAINING back to HEALTHY."""
    prompts, want = oracle
    plan = FaultPlan().at(replica_site(0, "loop"), 0)
    with Router(engine, n_replicas=2, plan=plan, **kw()) as router:
        reqs = router.run([Request(list(p), N_NEW) for p in prompts])
        s = router.summary()
        trans = [(a, b) for _, a, b, _ in router.health[0].transitions]
        ev = list(router.evict_log)
    _identical(reqs, want)
    assert s["fleet_evictions"] == 1 and s["fleet_restarts"] == 1
    assert s["fleet_failovers"] >= 1
    assert s["replica_health"] == [HEALTHY, HEALTHY]
    assert trans == [(HEALTHY, SUSPECT), (SUSPECT, EVICTED),
                     (EVICTED, DRAINING), (DRAINING, HEALTHY)]
    assert ev[0]["detect_latency_s"] is not None
    assert s["fleet_accounting_ok"]


def test_stall_trips_the_watchdog(engine, oracle):
    """A frozen worker with work outstanding stops heart-beating: the
    watchdog (or the probes) evict it and the traffic completes on the
    other replica."""
    prompts, want = oracle
    plan = FaultPlan().at(replica_site(0, "loop"), 0, kind="stall",
                          seconds=0.8)
    with Router(engine, n_replicas=2, plan=plan,
                **kw(watchdog_s=0.1, probe_interval_s=0.02)) as router:
        reqs = router.run([Request(list(p), N_NEW) for p in prompts],
                          timeout_s=60)
        s = router.summary()
        reasons = " | ".join(c for _, _, _, c
                             in router.health[0].transitions)
    _identical(reqs, want)
    assert s["fleet_evictions"] >= 1
    assert "stall" in reasons or "probe" in reasons
    assert s["fleet_accounting_ok"]


def test_block_beat_once_a_layer_of_each_cached_forward(engine, oracle):
    """A fleet worker's heartbeat rides every layer of its serving
    forwards (a long eager prefill keeps beating): the beat set on a
    thread runs once a block of each cached forward on that thread, never
    on a training (uncached) forward nor on another thread."""
    import threading
    from dtdl_tpu_torch.models.transformer import set_block_beat
    prompts, want = oracle
    beats, other = [], []

    def serve():
        Scheduler(engine, harvest_lag=1, device="cpu").run(
            [Request(list(p), N_NEW) for p in prompts[:2]])

    set_block_beat(lambda: beats.append(1))
    try:
        reqs = [Request(list(p), N_NEW) for p in prompts]
        Scheduler(engine, harvest_lag=1, device="cpu").run(reqs)
        served = len(beats)
        engine.model(torch.zeros(1, 8, dtype=torch.long))
        t = threading.Thread(target=serve)
        t.start()
        t.join(60)
        other.append(len(beats))
    finally:
        set_block_beat(None)
    _identical(reqs, want)
    layers = CFG["n_layers"]
    # six prefills and the decode steps, each a cached forward
    assert served >= layers * (len(prompts) + N_NEW - 1)
    assert served % layers == 0
    assert other == [served]


def test_retry_budget_exhausted_is_a_named_failure(engine, oracle):
    """Every engine dead: requests burn their budget and end ``failed:
    retry budget exhausted``; nothing is lost."""
    prompts, _ = oracle
    plan = FaultPlan()
    for i in (0, 1):
        for k in range(200):
            plan.at(replica_site(i, "engine"), k)
    with Router(engine, n_replicas=2, plan=plan, auto_restart=False,
                **kw(probe_interval_s=0.005, recover_after=1,
                     evict_after=100, retry_budget=1)) as router:
        reqs = router.run([Request(list(p), N_NEW) for p in prompts[:2]],
                          timeout_s=60)
        s = router.summary()
    for r in reqs:
        assert r.done and r.error.startswith("failed:")
        assert "retry budget exhausted" in r.error
    assert s["fleet_requests_failed"] == 2
    assert s["fleet_requests_finished"] == 0
    assert s["fleet_accounting_ok"]


def test_all_replicas_evicted_fails_by_name(engine, oracle):
    """Every worker dead, no restart: the requests fail by name and never
    hang."""
    prompts, _ = oracle
    plan = FaultPlan()
    for i in (0, 1):
        plan.at(replica_site(i, "loop"), 0)
    with Router(engine, n_replicas=2, plan=plan, auto_restart=False,
                **kw(watchdog_s=0.1)) as router:
        reqs = router.run([Request(list(p), N_NEW) for p in prompts[:3]],
                          timeout_s=60)
        s = router.summary()
    for r in reqs:
        assert r.done and r.error.startswith("failed:"), r
    assert any("every replica evicted" in r.error
               or "retry budget" in r.error for r in reqs)
    assert s["replica_health"] == [EVICTED, EVICTED]
    assert s["fleet_requests_failed"] == 3
    assert s["fleet_accounting_ok"]


def test_hedge_delivers_exactly_once(engine, oracle):
    """hedge_after_s=0 hedges every flight to the other replica: the
    first completion wins, every request carries exactly the oracle's
    tokens (no double append), one terminal entry each."""
    prompts, want = oracle
    with Router(engine, n_replicas=2, hedge_after_s=0.0, **kw()) as router:
        reqs = router.run([Request(list(p), N_NEW) for p in prompts])
        s = router.summary()
    _identical(reqs, want)
    assert s["fleet_hedges"] >= 1
    assert s["fleet_hedges_won"] <= s["fleet_hedges"]
    assert s["fleet_requests_finished"] == 6 and s["fleet_accounting_ok"]


def test_rolling_restart_zero_failures(engine, oracle):
    """Drain and restart each replica under traffic: no failed or
    aborted request, tokens as the oracle's, and no dispatch into a
    replica between its DRAINING and HEALTHY edges."""
    prompts, want = oracle
    with Router(engine, n_replicas=2, **kw()) as router:
        reqs = [Request(list(p), N_NEW) for p in prompts * 2]
        for r in reqs:
            router.submit(r)
        router.rolling_restart(timeout_s=30)
        assert router.wait(reqs, timeout_s=60)
        s = router.summary()
        log = list(router.dispatch_log)
        windows = [(i, next(t for t, _, b, _ in h.transitions
                            if b == DRAINING),
                    next(t for t, _, b, _ in h.transitions if b == HEALTHY))
                   for i, h in enumerate(router.health)]
    _identical(reqs, want * 2)
    assert s["fleet_requests_failed"] == s["fleet_requests_aborted"] == 0
    assert s["fleet_restarts"] == 2
    for i, t0, t1 in windows:
        assert not [e for e in log if e[1] == i and t0 <= e[0] <= t1]
    assert s["fleet_accounting_ok"]


def test_bounded_queue_deadlines_and_shutdown(engine, oracle):
    """``max_queue`` sheds by name at intake, a deadline that passes in
    the router's queue expires by name, a replica-side ``queue full`` is
    backpressure that burns no retry, and a shut-down router rejects."""
    prompts, want = oracle
    router = Router(engine, n_replicas=1, max_queue=1,
                    **kw(poll_s=0.05, probe_interval_s=1.0))
    try:
        rs = [router.submit(Request(list(prompts[i]), N_NEW))
              for i in range(3)]
        shed = [r for r in rs if r.done and r.error]
        assert shed and all("admission queue full" in r.error
                            and r.error.startswith("rejected:")
                            for r in shed)
        assert router.wait([r for r in rs if r.error is None], timeout_s=60)
    finally:
        router.shutdown()
    late = router.submit(Request(list(prompts[0]), N_NEW))
    assert late.done and late.error.startswith("rejected:")
    assert "shut down" in late.error
    assert router.summary()["fleet_accounting_ok"]

    with Router(engine, n_replicas=1, retry_budget=0, device="cpu",
                sched_kwargs={"harvest_lag": 1, "max_queue": 1}) as router:
        dead = router.submit(Request(list(prompts[0]), N_NEW,
                                     deadline_s=0.0))
        reqs = router.run([Request(list(prompts[i % 6]), N_NEW)
                           for i in range(8)], timeout_s=60)
        s = router.summary()
    assert dead.error.startswith("expired:") and "deadline" in dead.error
    _identical(reqs, [want[i % 6] for i in range(8)])
    assert s["fleet_retries"] == 0 and s["fleet_requests_expired"] == 1
    assert router.health[0].state == HEALTHY and s["fleet_accounting_ok"]


def test_router_refusals_name_their_items(engine):
    """Replica counts and the device are checked.  (The operations
    surface, refused here before A13a, is served: tests/
    test_torch_obs_export.py; the tenants' fields, before A12b:
    tests/test_torch_tenant_stream.py.)  ``slos`` without an exporter
    builds the Router's own sink-less one."""
    with Router(engine, device="cpu", warmup=False,
                slos=[]) as router:
        assert router.exporter is not None and router.slo is not None
    with pytest.raises(ValueError, match="n_replicas"):
        Router(engine, n_replicas=0, device="cpu")
    with pytest.raises(ValueError, match="device"):
        Router(engine, device="cpu", sched_kwargs={"device": "cpu"})
