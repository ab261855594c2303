"""Containment, cancel and shutdown in the port's scheduler against the
JAX package's.

The JAX serving tests' config (vocab 64, d_model 32, 2 layers, 2 heads,
max_seq 48, page 4, f32), bridged weights and numpy-seeded traffic.  The
scenarios are those of tests/test_chunked_prefill.py (expire and cancel
mid chunked prefill), tests/test_resil.py (a raise injected into the
engine, graceful and aborting shutdown) and tests/test_fleet.py (cancel,
the outstanding-work export and the accounting invariant), run on the
port's scheduler and, where they serve tokens, on the JAX scheduler too.
Tolerance: tokens, error kinds and counters exactly.
"""

import time

import numpy as np
import pytest
import torch

from dtdl_tpu.serve import Request as JaxRequest
from dtdl_tpu.serve import Scheduler as JaxScheduler
from dtdl_tpu_torch.serve import InferenceEngine, Request, Scheduler
from dtdl_tpu_torch.serve.metrics import ERROR_KINDS
from test_torch_chunked import CopyingJaxEngine, jax_pair

torch.set_num_threads(1)

MAX_SEQ = 48
PAGE = 4
VOCAB = 64
BUCKETS = (8, 16, 32)
CFG = dict(vocab_size=VOCAB, d_model=32, n_layers=2, n_heads=2, d_ff=64,
           max_seq=MAX_SEQ)


@pytest.fixture(scope="module")
def models():
    return jax_pair(**CFG)


@pytest.fixture(scope="module")
def engine(models):
    return InferenceEngine(models[2], n_slots=2, buckets=BUCKETS,
                           page_size=PAGE, device="cpu")


def _prompts(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, int(rng.integers(4, 14))).tolist()
            for _ in range(n)]


def _accounted(summary):
    return summary["requests_submitted"] == (
        summary["requests_finished"] + summary["requests_rejected"]
        + summary["requests_expired"] + summary["requests_failed"]
        + summary["requests_aborted"] + summary["requests_shed"])


def _boom(*args, **kwargs):
    raise RuntimeError("injected device failure")


def test_expire_and_cancel_mid_chunked_prefill_release_pages(models):
    """A request dying mid chunked prefill (expired, or cancelled) gives
    its partly written pages back and ends with its kind; the recycled
    pool then serves the next request with the whole-prompt tokens."""
    eng = InferenceEngine(models[2], n_slots=1, buckets=BUCKETS,
                          page_size=PAGE, n_pages=MAX_SEQ // PAGE + 1,
                          device="cpu")
    prompt = np.random.default_rng(4).integers(0, VOCAB, 30).tolist()
    sched = Scheduler(eng, harvest_lag=2, chunk_tokens=3, device="cpu")
    victim = sched.submit(Request(prompt, 8, deadline_s=60.0))
    sched.step()
    sched.step()                       # chunks in flight, prompt partial
    assert not victim.done and sched.pages.pages_in_use > 0
    victim.deadline_at = time.perf_counter() - 1.0
    sched.step()
    assert victim.error.startswith("expired:") and victim.tokens == []
    assert sched.pages.pages_in_use == 0
    sched.drain()

    sched2 = Scheduler(eng, harvest_lag=4, chunk_tokens=3, device="cpu")
    victim2 = sched2.submit(Request(prompt, 8))
    sched2.step()
    assert sched2.pages.pages_in_use > 0
    assert sched2.cancel(victim2.rid)
    assert victim2.error.startswith("aborted:")
    assert sched2.pages.pages_in_use == 0
    ref = [Request(prompt, 4)]
    Scheduler(eng, harvest_lag=2, device="cpu").run(ref)
    got = [Request(prompt, 4)]
    sched2.run(got)
    assert got[0].tokens == ref[0].tokens


@pytest.mark.parametrize("chunk", [None, 4])
@pytest.mark.parametrize("page_size", [0, PAGE])
def test_engine_failure_contained_then_queue_served_as_jax(models, chunk,
                                                           page_size):
    """A raise from the engine's step fails the two slotted requests
    (``failed:``, counted), the arena and pages are re-initialized, and
    the queued requests are served with the tokens of a clean run and of
    the JAX scheduler under the same injection; the pages come back and
    the accounting invariant holds."""
    jm, params, tm = models
    prompts = _prompts(4, seed=7)
    outs = []
    for side in ("port", "jax"):
        if side == "port":
            eng = InferenceEngine(tm, n_slots=2, buckets=BUCKETS,
                                  page_size=page_size, device="cpu")
            sched = Scheduler(eng, harvest_lag=1, chunk_tokens=chunk,
                              device="cpu")
            reqs = [Request(p, 6) for p in prompts]
        else:
            eng = CopyingJaxEngine(jm, params, n_slots=2, buckets=BUCKETS,
                                   page_size=page_size, paged_kernel=False)
            sched = JaxScheduler(eng, harvest_lag=1, chunk_tokens=chunk)
            reqs = [JaxRequest(p, 6) for p in prompts]
        for r in reqs:
            sched.submit(r)
        sched.step()                   # the first two admitted
        for name in ("decode", "verify"):
            setattr(eng, name, _boom)
        sched.step()                   # containment, not a crash
        for name in ("decode", "verify"):
            delattr(eng, name)
        assert "injected device failure" in sched.last_engine_error
        sched.run()
        outs.append(reqs)
        s = sched.metrics.summary()
        assert s["requests_failed"] == 2 and _accounted(s)
        if sched.pages is not None:
            assert sched.pages.pages_in_use == 0
    port, jax_reqs = outs
    assert [r.error.split(":")[0] for r in port[:2]] == ["failed"] * 2
    assert [r.error.split(":")[0] for r in jax_reqs[:2]] == ["failed"] * 2
    clean = [Request(p, 6) for p in prompts[2:]]
    Scheduler(InferenceEngine(tm, n_slots=2, buckets=BUCKETS,
                              page_size=page_size, device="cpu"),
              harvest_lag=1, device="cpu").run(clean)
    assert [r.tokens for r in port[2:]] == [r.tokens for r in clean] == \
        [r.tokens for r in jax_reqs[2:]]
    assert all(r.error is None for r in port[2:])


def test_containment_delivers_budget_retired_pending(engine):
    """A request that retired on its budget but still waits in the lag
    harvest finishes cleanly with its tokens when a later step fails; the
    slotted one fails."""
    rng = np.random.default_rng(11)
    sched = Scheduler(engine, harvest_lag=8, device="cpu")
    short = sched.submit(Request(rng.integers(0, VOCAB, 5).tolist(), 2))
    long_ = sched.submit(Request(rng.integers(0, VOCAB, 5).tolist(), 10))
    for _ in range(3):
        sched.step()
    assert not short.done
    engine.decode = _boom
    try:
        sched.step()
    finally:
        del engine.decode
    assert short.done and short.error is None and len(short.tokens) == 2
    assert long_.error.startswith("failed: engine failure")


def test_cancel_queued_and_slotted_and_invariant(engine):
    sched = Scheduler(engine, harvest_lag=2, device="cpu")
    reqs = [sched.submit(Request(p, 6)) for p in _prompts(4, seed=3)]
    sched.step()
    assert sched.load == 4
    assert sorted(r.rid for r in sched.pending_requests()) == \
        sorted(r.rid for r in reqs)
    queued = next(r for r in reqs if r in sched.queue)
    slotted = next(r for r in sched.slots if r is not None)
    assert sched.cancel(queued.rid, "test says so")
    assert queued.error.startswith("aborted: cancelled before admission")
    assert "test says so" in queued.error
    assert sched.cancel(slotted.rid)
    assert slotted.error.startswith("aborted:")
    assert not sched.cancel(slotted.rid)       # too late: finished
    assert not sched.cancel(10 ** 9)           # unknown rid
    sched.run()
    s = sched.metrics.summary()
    assert s["requests_aborted"] == 2 and _accounted(s)
    assert sched.pages.pages_in_use == 0


def test_shutdown_drain_and_abort(engine):
    """shutdown(drain=True): slotted requests finish with a clean run's
    tokens, queued ones end ``aborted:``, a later submit is rejected;
    drain=False aborts what is slotted; leaving the with-block through an
    exception aborts, a clean exit drains."""
    prompts = _prompts(4, seed=5)
    clean = [Request(p, 6) for p in prompts[:2]]
    Scheduler(engine, harvest_lag=1, device="cpu").run(clean)
    with Scheduler(engine, harvest_lag=1, device="cpu") as sched:
        reqs = [sched.submit(Request(p, 6)) for p in prompts]
        sched.step()
        sched.shutdown(drain=True)
        assert [r.tokens for r in reqs[:2]] == [r.tokens for r in clean]
        assert all(r.error is None for r in reqs[:2])
        assert all(r.error.startswith("aborted:") and "shut down" in r.error
                   for r in reqs[2:])
        late = sched.submit(Request(prompts[0], 2))
        assert late.error.startswith("rejected:") and "shut down" in late.error
        sched.shutdown(drain=True)     # idempotent
    assert _accounted(sched.metrics.summary())

    sched = Scheduler(engine, harvest_lag=3, device="cpu")
    reqs = [sched.submit(Request(p, 20)) for p in prompts[:2]]
    sched.step()
    sched.step()
    sched.shutdown(drain=False)
    assert all(r.done and r.error == "aborted: scheduler shut down"
               for r in reqs)
    assert sched.pages.pages_in_use == 0 and not sched._pending

    with pytest.raises(KeyError):
        with Scheduler(engine, harvest_lag=1, device="cpu") as sched:
            inflight = sched.submit(Request(prompts[0], 20))
            sched.step()
            raise KeyError("caller failure")
    assert inflight.error.startswith("aborted:")
    with Scheduler(engine, harvest_lag=1, device="cpu") as sched:
        ok = sched.submit(Request(prompts[1], 3))
        sched.step()                   # admitted: the exit drains it
    assert ok.done and ok.error is None and len(ok.tokens) == 3


def test_submit_mid_contain_rejects_and_reinit_error_propagates(engine):
    """A submit while containment runs is rejected by name; an error from
    re-initializing the arena (an unusable CUDA context) is not
    swallowed, and the containment flag clears on the way out."""
    sched = Scheduler(engine, harvest_lag=1, device="cpu")
    sched._containing = True
    r = sched.submit(Request([1, 2, 3], 4))
    assert r.error.startswith("rejected:") and "containment" in r.error
    sched._containing = False
    victim = sched.submit(Request([4, 5, 6], 8))
    sched.step()
    engine.decode = _boom
    engine.init_arena = lambda: _boom()
    try:
        with pytest.raises(RuntimeError, match="injected"):
            sched.step()
    finally:
        del engine.decode, engine.init_arena
    assert victim.error.startswith("failed:")
    assert not sched._containing
    pattern = {e.split(":")[0] for e in (r.error, victim.error)}
    assert pattern <= set(ERROR_KINDS)
