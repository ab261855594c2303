"""Prefill/decode disaggregation in the port against the JAX package's.

* The scheduler's halves: ``prefill_only`` admission (finishes at the
  first token with a page payload) and ``kv_inject`` admission (adopts
  one), with their refusals, against the JAX scheduler's messages.
* The disaggregated Router (roles ``prefill``/``decode``, chunked prefill,
  the page handoff carried by the Router) token-identical to the JAX
  single ``Scheduler`` (through ``CopyingJaxEngine``, ROADMAP C1) and to
  the port's own; a decode replica's death re-injects the held payload;
  the role checks; hedging only of whole flights; the prefix directory
  routing a warm prefix to its holder without changing a token.
* A tensor-parallel engine hands over whole-heads payloads (round trip on
  a ``(1, 1)`` mesh); a payload of another head count raises
  ``ValueError``.

The JAX serving tests' config (vocab 64, d_model 32, 2 layers, 2 heads,
f32, bridged weights), max_seq 32, page 4.  Tolerance: tokens exact.
"""

import time

import numpy as np
import pytest
import torch

from dtdl_tpu.serve import Request as JaxRequest
from dtdl_tpu.serve import Scheduler as JaxScheduler
from dtdl_tpu_torch.resil.faults import FaultPlan, replica_site
from dtdl_tpu_torch.runtime.mesh import build_mesh
from dtdl_tpu_torch.serve import InferenceEngine, Request, Router, Scheduler
from test_torch_chunked import CopyingJaxEngine, jax_pair

# small shapes: one intra-op thread each leaves the cores to the other
# test workers
torch.set_num_threads(1)

MAX_SEQ = 32
PAGE = 4
N_NEW = 6
N_PAGES = 3 * (MAX_SEQ // PAGE) + 1
CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, d_ff=64,
           max_seq=MAX_SEQ)


def mk_prompts(n, seed=9):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 64, int(rng.integers(3, 8))).tolist()
            for _ in range(n)]


@pytest.fixture(scope="module")
def models():
    return jax_pair(**CFG)


@pytest.fixture(scope="module")
def engines(models):
    jm, params, tm = models
    geo = dict(n_slots=2, buckets=(8,), page_size=PAGE, n_pages=N_PAGES)
    return (CopyingJaxEngine(jm, params, paged_kernel=False, **geo),
            InferenceEngine(tm, device="cpu", **geo),
            InferenceEngine(tm, n_slots=2, buckets=(8,), page_size=0,
                            device="cpu"))


@pytest.fixture(scope="module")
def oracle(engines):
    """Six prompts' greedy tokens from the JAX single Scheduler and the
    port's, held equal; returns (prompts, tokens)."""
    jeng, teng, _ = engines
    prompts = mk_prompts(6)
    jreqs = [JaxRequest(list(p), N_NEW) for p in prompts]
    JaxScheduler(jeng, harvest_lag=1).run(jreqs)
    reqs = [Request(list(p), N_NEW) for p in prompts]
    Scheduler(teng, harvest_lag=1, device="cpu").run(reqs)
    want = [r.tokens for r in jreqs]
    assert [r.tokens for r in reqs] == want
    return prompts, want


def kw(**over):
    base = dict(sched_kwargs={"harvest_lag": 1, "chunk_tokens": 4},
                retry_budget=3, probe_interval_s=0.01, watchdog_s=1.0,
                device="cpu")
    base.update(over)
    return base


def _identical(reqs, want):
    for r, toks in zip(reqs, want):
        assert r.done and r.error is None, r
        assert r.tokens == toks, f"{r} diverged across the handoff"


# ---------------------------------------------------------------------------
# the scheduler's two halves
# ---------------------------------------------------------------------------

def _sched(eng, jax_side, **kw_):
    if jax_side:
        return JaxScheduler(eng, harvest_lag=1, **kw_)
    return Scheduler(eng, harvest_lag=1, device="cpu", **kw_)


@pytest.mark.parametrize("chunk", [None, 3])
def test_halves_decode_as_one_flight(engines, oracle, chunk):
    """prefill_only parks its slot, finishes at the first token with the
    payload (one handoff on the source); kv_inject adopts it and decodes
    the rest (one on the target): the two halves' tokens are the whole
    request's, on both packages, whole-prompt and chunked."""
    jeng, teng, _ = engines
    prompts, want = oracle
    for jax_side, eng in ((True, jeng), (False, teng)):
        R = JaxRequest if jax_side else Request
        src, dst = (_sched(eng, jax_side, chunk_tokens=chunk)
                    for _ in range(2))
        firsts = [R(list(p), N_NEW, prefill_only=True) for p in prompts]
        src.run(firsts)
        seconds = []
        for f in firsts:
            assert f.done and f.error is None and len(f.tokens) == 1
            assert f.kv_handoff["first_token"] == f.tokens[0]
            assert f.kv_handoff["n_pages"] == -(-len(f.prompt) // PAGE)
            r = R(list(f.prompt), N_NEW, kv_inject=f.kv_handoff)
            r.tokens = [f.kv_handoff["first_token"]]
            seconds.append(r)
        dst.run(seconds)
        _identical(seconds, want)
        ms, md = src.metrics.summary(), dst.metrics.summary()
        assert ms["decode_tokens"] == 0 and md["prefill_tokens"] == 0
        assert ms["kv_handoff_pages"] == md["kv_handoff_pages"] == sum(
            f.kv_handoff["n_pages"] for f in firsts)


def test_admission_refusals_match_jax(engines):
    """Mutual exclusion raises; a dense engine, a payload of the wrong
    page count, a prompt at max_seq and a pool too small are rejected by
    name, with the JAX scheduler's messages."""
    jeng, teng, dense = engines
    pay = {"n_pages": 1, "data": {}, "first_token": 3}
    cases = [
        (lambda R: R([1, 2, 3], 4, prefill_only=True), "dense",
         "needs a paged engine"),
        (lambda R: R([1] * 9, 4, kv_inject=pay), "paged",
         "payload carries 1 pages but the prompt needs 3"),
        (lambda R: R([1] * MAX_SEQ, 4,
                     kv_inject=dict(pay, n_pages=MAX_SEQ // PAGE)), "paged",
         "leaves no room to decode"),
    ]
    for make, kind, msg in cases:
        for jax_side in (True, False):
            R = JaxRequest if jax_side else Request
            if kind == "dense":
                eng = (dense if not jax_side else None)
                if eng is None:
                    continue
            else:
                eng = jeng if jax_side else teng
            req = _sched(eng, jax_side).submit(make(R))
            assert req.done and req.error.startswith("rejected:"), req
            assert msg in req.error, req.error
    for jax_side, eng in ((True, jeng), (False, teng)):
        R = JaxRequest if jax_side else Request
        with pytest.raises(ValueError, match="mutually exclusive"):
            _sched(eng, jax_side).submit(R([1, 2], 3, prefill_only=True,
                                           kv_inject=pay))
    small = InferenceEngine(teng.model, n_slots=2, buckets=(8,),
                            page_size=PAGE, n_pages=3, device="cpu")
    req = Scheduler(small, device="cpu").submit(
        Request([1] * 9, 4, kv_inject=dict(pay, n_pages=3)))
    assert "page pool exhausted: adopted prompt needs 3 pages" in req.error


def test_tensor_parallel_handoff_is_per_rank(models):
    """A tensor-parallel engine hands over whole-heads payloads: on a
    ``(1, 1)`` mesh one round-trips bitwise into other pages, and a
    payload of another head count raises ``ValueError`` naming the whole
    head count the arena wants."""
    _, _, tm = models
    tp = InferenceEngine(tm, n_slots=2, buckets=(8,), page_size=PAGE,
                         device="cpu",
                         mesh=build_mesh((1, 1), ("data", "model")))
    arena, last = tp.init_arena(), tp.init_last_tokens()
    sched = Scheduler(tp, device="cpu")
    req = sched.submit(Request([5, 1, 4, 1, 5, 9], 4, prefill_only=True))
    sched.run()
    data = req.kv_handoff["data"]
    assert data["block_0"]["attn"]["pages_key"].shape == (2, 2, PAGE, 16)
    arena, last = tp.inject_pages(arena, last, data, [3, 4], 0, 6, 5)
    back = tp.extract_pages(arena, [3, 4])
    for b, node in data.items():
        for k, v in node["attn"].items():
            np.testing.assert_array_equal(back[b]["attn"][k], v)
    half = {b: {"attn": {k: v[:, :1] for k, v in node["attn"].items()}}
            for b, node in data.items()}
    with pytest.raises(ValueError, match="all 2 heads"):
        tp.inject_pages(arena, last, half, [3, 4], 0, 6, 5)


# ---------------------------------------------------------------------------
# the disaggregated fleet
# ---------------------------------------------------------------------------

def test_disaggregated_fleet_token_identical(engines, oracle):
    """A prefill replica (chunked) and a decode replica, the page payload
    carried by the Router: every request as the single schedulers', one
    migration each, the handoff metered on both sides, no decode on the
    prefill replica and no prefill on the decode replica."""
    _, teng, _ = engines
    prompts, want = oracle
    with Router(teng, roles=["prefill", "decode"], **kw()) as router:
        reqs = router.run([Request(list(p), N_NEW) for p in prompts])
        s = router.summary()
    _identical(reqs, want)
    assert s["replica_roles"] == ["prefill", "decode"]
    assert s["fleet_migrations"] == len(prompts)
    assert s["fleet_kv_handoff_pages"] == sum(-(-len(p) // PAGE)
                                             for p in prompts)
    assert all(rep["kv_handoff_pages"] > 0 for rep in s["replicas"])
    assert s["replicas"][0]["decode_tokens"] == 0
    assert s["replicas"][1]["prefill_tokens"] == 0
    assert s["fleet_accounting_ok"] and router.pump_error is None


def test_decode_replica_death_reinjects_the_payload(engines, oracle):
    """A decode replica dies after migrations: its flights go to the
    other decode replica with the same held payloads (re-injection, no
    new prefill), token-identical."""
    _, teng, _ = engines
    prompts, want = oracle
    plan = FaultPlan().at(replica_site(1, "loop"), 2)
    with Router(teng, roles=["prefill", "decode", "decode"], plan=plan,
                **kw()) as router:
        reqs = router.run([Request(list(p), N_NEW) for p in prompts])
        s = router.summary()
    _identical(reqs, want)
    assert s["fleet_evictions"] == 1
    assert s["fleet_migrations"] == len(prompts)
    assert s["replicas"][0]["prefill_tokens"] == sum(len(p) for p in prompts)
    assert s["fleet_accounting_ok"] and router.pump_error is None


def test_role_checks(engines):
    """Every replica a migrated flight can land on must be paged; decode
    replicas need a prefill replica; unknown roles and counts refuse; an
    all-mixed fleet may stay dense."""
    _, teng, dense = engines
    cases = [([teng, dense], ["prefill", "mixed"], "page_size"),
             ([teng, teng], ["mixed", "decode"], "prefill"),
             ([teng, teng], ["prefill", "oops"], "unknown roles"),
             ([teng, teng], ["prefill"], "roles has 1 entries"),
             ([teng, teng], ["decode", "decode"], "prefill-capable"),
             ([teng, teng], ["prefill", "prefill"], "decode-capable")]
    for engs, roles, msg in cases:
        with pytest.raises(ValueError, match=msg):
            Router(engs, roles=roles, warmup=False, device="cpu")
    Router([dense, dense], roles=["mixed", "mixed"], warmup=False,
           device="cpu").shutdown(drain=False)


def test_hedging_only_whole_flights(engines, oracle):
    """A staged fleet never hedges a migrating flight (two payloads would
    race one migration); an all-mixed role fleet hedges; both
    token-identical."""
    _, teng, dense = engines
    prompts, want = oracle
    with Router(teng, roles=["prefill", "decode"], hedge_after_s=0.0,
                **kw()) as router:
        staged = router.run([Request(list(p), N_NEW) for p in prompts])
        s = router.summary()
    _identical(staged, want)
    assert s["fleet_hedges"] == 0 and s["fleet_migrations"] == len(prompts)
    with Router(dense, roles=["mixed", "mixed"], hedge_after_s=0.0,
                **kw(sched_kwargs={"harvest_lag": 1})) as router:
        mixed = router.run([Request(list(p), N_NEW) for p in prompts])
        s = router.summary()
    _identical(mixed, want)
    assert s["fleet_hedges"] >= 1 and s["fleet_accounting_ok"]


def test_prefix_directory_routes_warm_prefixes(engines):
    """Two waves of shared-prefix traffic: the second wave's dispatches
    follow the directory to the replica holding the prefix, and every
    token equals a directory-off fleet's and the single scheduler's."""
    _, teng, _ = engines
    rng = np.random.default_rng(4)
    shared = rng.integers(0, 64, PAGE).tolist()
    waves = [[shared + rng.integers(0, 64, 3).tolist() for _ in range(3)]
             for _ in range(2)]
    single = Scheduler(teng, harvest_lag=1, device="cpu")
    want = []
    for w in waves:
        reqs = [Request(list(p), N_NEW) for p in w]
        single.run(reqs)
        _identical(reqs, [r.tokens for r in reqs])
        want.append([r.tokens for r in reqs])
    out = {}
    for on in (True, False):
        with Router(teng, n_replicas=2, prefix_directory=on,
                    **kw(sched_kwargs={"harvest_lag": 1})) as router:
            got = []
            for w in waves:
                got.append([r.tokens for r in router.run(
                    [Request(list(p), N_NEW) for p in w])])
                time.sleep(0.05)      # the last receipts land
            out[on] = (got, router.summary())
    assert out[True][0] == out[False][0] == want
    s_on, s_off = out[True][1], out[False][1]
    assert s_on["fleet_directory_hits"] >= 1
    assert s_on["prefix_directory_entries"] >= 1
    assert s_off["fleet_directory_hits"] == 0
    assert "prefix_directory_entries" not in s_off
