"""Token streams in the port against the JAX package's
(dtdl_tpu/serve/tenant/stream.py, the scheduler's and the Router's stream
terminals, and the tenants' counters of ServeMetrics and FleetMetrics).

Tolerances, each where it is used:

* ``TokenStream``: every return value and state (delivered tokens,
  owner-guarded offers, ``divergent``, ``closed``, ``error``, callback
  deliveries) equal to JAX's over one script, exactly, but for a
  successor's catch-up, which JAX marks divergent (ROADMAP C6);
* serving on the JAX tests' config (vocab 64, d_model 32, 2 layers, 2
  heads, f32, bridged weights): each stream closed, not divergent, equal
  to its request's tokens, and those tokens the JAX single scheduler's
  (through ``CopyingJaxEngine``, ROADMAP C1), under lag harvest,
  speculation and a grammar; through the Router (two replicas, a
  ``FaultPlan`` kill, hedging) the same, which is tests/test_fleet.py's
  pin (no JAX Router runs: ROADMAP C3);
* ``ServeMetrics``/``FleetMetrics``: the tenants' summary keys, values
  and window deltas equal to JAX's for one sequence of hooks.
"""

import numpy as np
import pytest
import torch

from dtdl_tpu.serve import FleetMetrics as JaxFleetMetrics
from dtdl_tpu.serve import Request as JaxRequest
from dtdl_tpu.serve import Scheduler as JaxScheduler
from dtdl_tpu.serve import ServeMetrics as JaxServeMetrics
from dtdl_tpu.serve import TokenStream as JaxStream
from dtdl_tpu_torch.resil.faults import FaultPlan, replica_site
from dtdl_tpu_torch.serve import (FleetMetrics, InferenceEngine, Request,
                                  Router, Scheduler, ServeMetrics,
                                  TokenStream, byte_vocab, compile_regex)
from test_torch_chunked import CopyingJaxEngine, jax_pair

torch.set_num_threads(1)

N_NEW = 6
EOS = 63
CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, d_ff=64,
           max_seq=32)


def _script(stream):
    """One run of the ownership protocol; every observable, in order."""
    got = []
    s = stream
    for op, rid, toks in [("offer", 1, [10, 11]), ("offer", 2, [10, 11, 12]),
                          ("offer", 1, [10, 11]), ("offer", 1, [10, 11, 12,
                                                                13]),
                          ("drop", 2, None), ("offer", 1, [10, 11, 12, 13,
                                                           14]),
                          ("drop", 1, None), ("offer", 3, [10, 11, 12, 13,
                                                           14, 15]),
                          ("offer", 3, [99]), ("finish", None, [10, 11, 12,
                                                                13, 14, 15,
                                                                16]),
                          ("offer", 3, [10]), ("finish", None, [1])]:
        if op == "offer":
            got.append(s.offer(rid, toks))
        elif op == "drop":
            got.append(s.drop(rid))
        else:
            got.append(s.finish(toks))
        got.append((s.tokens, s.divergent, s.closed, s.error))
    return got


def test_stream_protocol_matches_jax():
    jd, td = [], []
    assert _script(TokenStream(callback=td.append)) == \
        _script(JaxStream(callback=jd.append))
    assert td == jd and td[0] == [10, 11]


def test_stream_finish_reconciles_and_closes_like_jax():
    """Success delivers the unoffered suffix and closes; an error closes
    undelivered; the iterator drains then ends."""
    for cls in (TokenStream, JaxStream):
        got = []
        s = cls(callback=got.append)
        s.offer(1, [4, 5])
        assert s.finish([4, 5, 6, 7]) == 2 and s.closed and s.error is None
        assert s.offer(1, [4, 5, 6, 7, 8]) == 0 and s.finish([1]) == 0
        assert got == [[4, 5], [6, 7]] and list(s) == [4, 5, 6, 7]
        e = cls()
        e.offer(1, [2])
        assert e.finish([2, 3], error="failed: boom") == 0
        assert e.closed and e.error == "failed: boom" and e.tokens == [2]


def test_successor_catching_up_is_not_divergent():
    """ROADMAP C6: after the owner errors out, its successor offers its
    own tokens from the first; while they are a prefix of what was
    delivered they agree and deliver nothing, then the extension goes
    out.  The JAX stream marks such a catch-up divergent."""
    for cls, divergent in ((TokenStream, False), (JaxStream, True)):
        s = cls()
        assert s.offer(1, [4, 5, 6]) == 3
        s.drop(1)
        assert s.offer(2, [4]) == 0 and s.divergent == divergent
    s = TokenStream()
    s.offer(1, [4, 5, 6])
    s.drop(1)
    assert s.offer(2, [4, 5]) == 0 and s.offer(2, [4, 5, 6, 7]) == 1
    assert s.tokens == [4, 5, 6, 7] and not s.divergent
    assert s.offer(2, [4, 9]) == 0 and s.divergent


@pytest.fixture(scope="module")
def models():
    return jax_pair(**CFG)


@pytest.fixture(scope="module")
def engine(models):
    _, _, tm = models
    return InferenceEngine(tm, n_slots=2, buckets=(8, 16), page_size=0,
                           device="cpu")


def _prompts(n, seed=1):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 64, 3).tolist() * 3)[:int(rng.integers(4, 9))]
            for _ in range(n)]


@pytest.fixture(scope="module")
def oracle(models):
    """Six prompts' greedy tokens from the JAX single scheduler."""
    jm, params, _ = models
    prompts = _prompts(6)
    jeng = CopyingJaxEngine(jm, params, n_slots=2, buckets=(8, 16))
    jreqs = [JaxRequest(list(p), N_NEW) for p in prompts]
    JaxScheduler(jeng, harvest_lag=1).run(jreqs)
    return prompts, [r.tokens for r in jreqs]


def _closed_and_equal(reqs, streams):
    for r, st in zip(reqs, streams):
        assert st.closed and not st.divergent, r
        assert st.tokens == r.tokens and st.error == r.error


@pytest.mark.parametrize("lag,spec", [(1, 0), (3, 0), (3, 4)],
                         ids=["lag1", "lag3", "lag3-spec"])
def test_streams_equal_final_tokens(engine, oracle, lag, spec):
    """Under lag harvest and speculation every delivery is harvested
    truth: the streams close equal to their requests' tokens, which are
    JAX's, delivered over more than one window."""
    prompts, want = oracle
    sizes = []
    streams = [TokenStream(callback=lambda new: sizes.append(len(new)))
               for _ in prompts]
    sched = Scheduler(engine, harvest_lag=lag, device="cpu")
    reqs = sched.run([Request(list(p), N_NEW, speculate=spec, stream=s)
                      for p, s in zip(prompts, streams)])
    reqs = sorted(reqs, key=lambda r: r.rid)
    _closed_and_equal(reqs, streams)
    assert [r.tokens for r in reqs] == want
    assert len(sizes) > len(prompts) and sum(sizes) == N_NEW * len(prompts)
    assert sched.metrics.summary()["stream_deliveries"] == sum(sizes)


def test_stream_with_grammar_and_eos(engine):
    """A stream of a constrained request is the masked sequence, EOS
    included."""
    dfa = compile_regex(r"\d\d\d\d", byte_vocab(64), eos_id=EOS)
    stream = TokenStream()
    r = Scheduler(engine, harvest_lag=2, device="cpu").run(
        [Request([7, 2], 12, eos_id=EOS, grammar=dfa, stream=stream)])[0]
    assert r.error is None and stream.closed and stream.tokens == r.tokens
    assert len(r.tokens) == 5 and r.tokens[-1] == EOS


def _fleet_kw(**over):
    base = dict(sched_kwargs={"harvest_lag": 1}, retry_budget=3,
                probe_interval_s=0.01, watchdog_s=1.0, device="cpu")
    base.update(over)
    return base


def test_fleet_streams_reconcile_to_final_tokens(engine, oracle):
    prompts, want = oracle
    streams = [TokenStream() for _ in prompts]
    with Router(engine, n_replicas=2, **_fleet_kw()) as router:
        reqs = router.run([Request(list(p), N_NEW, stream=s)
                           for p, s in zip(prompts, streams)])
        s = router.summary()
    _closed_and_equal(reqs, streams)
    assert [r.tokens for r in reqs] == want
    assert s["fleet_stream_deliveries"] >= len(prompts)
    assert s["fleet_accounting_ok"]


@pytest.mark.parametrize("case", ["kill", "hedge"])
def test_fleet_streams_prefix_stable_under_retry(engine, oracle, case):
    """Replica 0's worker dies mid-flight (attempts retried elsewhere), or
    every request is hedged: only the winning attempt's tokens reach each
    stream, which closes non-divergent and equal to its request's."""
    prompts, want = oracle
    if case == "kill":
        kw = _fleet_kw(plan=FaultPlan().at(replica_site(0, "loop"), 2),
                       auto_restart=False)
    else:
        kw = _fleet_kw(hedge_after_s=0.0)
    streams = [TokenStream() for _ in prompts]
    with Router(engine, n_replicas=2, **kw) as router:
        reqs = router.run([Request(list(p), N_NEW, stream=s)
                           for p, s in zip(prompts, streams)])
        s = router.summary()
    _closed_and_equal(reqs, streams)
    for r, toks in zip(reqs, want):
        assert r.error is None and r.tokens == toks
    assert s["fleet_accounting_ok"]
    assert s["fleet_retries" if case == "kill" else "fleet_hedges"] >= 1


def _hooks(m):
    m.on_adapter_tokens("t1", 3)
    m.on_adapter_tokens("base", 2)
    w1 = m.window()
    m.on_adapter_tokens("t1", 4)
    w2 = m.window()
    m.on_grammar_reject(5)
    m.on_stream(2)
    w3 = m.window()
    return w1, w2, w3


TENANT_KEYS = ("tokens_by_adapter", "grammar_rejected_tokens",
               "stream_deliveries")


def test_serve_metrics_tenant_keys_match_jax():
    """The summary's tenant keys and the window's flattened per-adapter
    deltas equal JAX's for one sequence of hooks."""
    got, want = ServeMetrics(), JaxServeMetrics()
    gw, ww = _hooks(got), _hooks(want)
    for g, w in zip(gw, ww):
        keys = [k for k in w if k.split(".")[0] in TENANT_KEYS]
        assert keys and {k: g[k] for k in keys} == {k: w[k] for k in keys}
        assert not [k for k in g if k.split(".")[0] in TENANT_KEYS
                    and k not in w]
    gs, ws = got.summary(), want.summary()
    assert {k: gs[k] for k in TENANT_KEYS} == {k: ws[k] for k in TENANT_KEYS}


def test_fleet_metrics_tenant_rollups_match_jax():
    reps = [{"tokens_by_adapter": {"a": 3, "base": 1},
             "grammar_rejected_tokens": 2, "stream_deliveries": 5},
            {"tokens_by_adapter": {"a": 4, "b": 6},
             "grammar_rejected_tokens": 1, "stream_deliveries": 0}]
    got, want = FleetMetrics(), JaxFleetMetrics()
    keys = ["fleet_" + k for k in TENANT_KEYS]
    gs, ws = got.summary(reps), want.summary(reps)
    assert {k: gs[k] for k in keys} == {k: ws[k] for k in keys}
    assert gs["fleet_tokens_by_adapter"] == {"a": 7, "base": 1, "b": 6}
    gw, ww = got.window(reps), want.window(reps)
    flat = [k for k in ww if k.split(".")[0] in keys]
    assert flat and {k: gw[k] for k in flat} == {k: ww[k] for k in flat}
