"""The dense serving arena (``page_size=0``) in the port against the JAX
package's.

The JAX serving tests' config (vocab 64, d_model 32, 2 layers, 2 heads,
max_seq 48, f32) with the same bridged weights and numpy-seeded inputs:

* the engine's prefill writes row ``slot`` of every block's
  [n_slots, H, max_seq, D] K/V and sets that slot's index; decode and the
  verify forward (per-slot positions, ``_verify_attend_slots``) give the
  JAX logits and K/V.  Tolerance: atol 1e-5 (f32, summation order over two
  layers), indices exactly;
* the dense engine serves greedy traffic with tokens identical to the
  JAX dense scheduler's and to the port's paged engine (exact);
* the options that need pages are refused by name, as in JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtdl_tpu.serve import Request as JaxRequest
from dtdl_tpu.serve import Scheduler as JaxScheduler
from dtdl_tpu.serve import SampleParams as JaxSampleParams
from dtdl_tpu_torch.serve import InferenceEngine, Request, Scheduler
from test_torch_chunked import CopyingJaxEngine, jax_pair

torch.set_num_threads(1)

MAX_SEQ = 48
VOCAB = 64
BUCKETS = (8, 16, 32)
CFG = dict(vocab_size=VOCAB, d_model=32, n_layers=2, n_heads=2, d_ff=64,
           max_seq=MAX_SEQ)
ATOL = 1e-5
KNOBS = (np.zeros(2, np.float32), np.zeros(2, np.int32),
         np.ones(2, np.float32))


@pytest.fixture(scope="module")
def models():
    return jax_pair(**CFG)


@pytest.fixture(scope="module")
def engines(models):
    jm, params, tm = models
    return (CopyingJaxEngine(jm, params, n_slots=2, buckets=BUCKETS),
            InferenceEngine(tm, n_slots=2, buckets=BUCKETS, page_size=0,
                            device="cpu"))


def _kv(arena, block=1):
    return {k: np.asarray(arena[f"block_{block}"]["attn"][k])
            for k in ("key", "value")}


def _prefilled(jeng, teng, prompts):
    """Both arenas with prompt i in slot i (slot 1 first, so a prefill
    must leave the other row alone)."""
    ja, jl = jeng.init_arena(), jeng.init_last_tokens()
    ta, tl = teng.init_arena(), teng.init_last_tokens()
    for slot in (1, 0):
        ja, jl, jlog = jeng.prefill(ja, jl, slot, prompts[slot],
                                    JaxSampleParams())
        ta, tl, tlog = teng.prefill(ta, tl, slot, prompts[slot])
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                                   atol=ATOL)
    return ja, jl, ta, tl


def test_dense_prefill_and_decode_match_jax(engines):
    jeng, teng = engines
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, VOCAB, n).tolist() for n in (5, 13)]
    ja, jl, ta, tl = _prefilled(jeng, teng, prompts)
    assert ta["index"].tolist() == [5, 13]
    assert np.asarray(ja["block_0"]["attn"]["index"]).tolist() == [5, 13]
    for name, want in _kv(ja).items():
        np.testing.assert_allclose(_kv(ta)[name], want, rtol=0, atol=ATOL)
    assert tl.tolist() == np.asarray(jl).tolist()
    act = np.asarray([True, False])
    for _ in range(3):
        ja, jl, jlog = jeng.decode(ja, jl, act, jax.random.PRNGKey(0),
                                   *KNOBS)
        ta, tl, tlog = teng.decode(ta, tl, act, *KNOBS)
        np.testing.assert_allclose(tlog[0].numpy(), np.asarray(jlog[0]),
                                   rtol=0, atol=ATOL)
        assert tl.tolist() == np.asarray(jl).tolist()
    assert ta["index"].tolist() == [8, 13]
    for name, want in _kv(ja).items():
        np.testing.assert_allclose(_kv(ta)[name][0], want[0], rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("k", [1, 4])
def test_dense_verify_forward_matches_jax_verify_attend_slots(engines,
                                                              models, k):
    """The per-slot forward of width k+1 on the dense arena, at each
    slot's own position: logits and written K/V as JAX's
    ``_verify_attend_slots`` (the model applied to the arena with [B]
    index leaves)."""
    jm, params, tm = models
    jeng, teng = engines
    rng = np.random.default_rng(k)
    prompts = [rng.integers(0, VOCAB, n).tolist() for n in (7, 20)]
    ja, _, ta, _ = _prefilled(jeng, teng, prompts)
    x = rng.integers(0, VOCAB, (2, k + 1)).astype(np.int32)
    jlog, muts = jm.apply({"params": params, "cache": ja}, jnp.asarray(x),
                          decode=True, mutable=["cache"])
    with torch.no_grad():
        tlog = teng.model(torch.from_numpy(x).long(), pos=ta["index"],
                          cache=ta)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                               atol=ATOL)
    for name, want in _kv(muts["cache"]).items():
        np.testing.assert_allclose(_kv(ta)[name], want, rtol=0, atol=ATOL)


def _traffic(seed):
    rng = np.random.default_rng(seed)
    lens, n_new = (3, 9, 14, 5, 22), (6, 4, 8, 3, 7)
    return [rng.integers(0, VOCAB, n).tolist() for n in lens], n_new


@pytest.mark.parametrize("spec", [0, 3])
def test_dense_engine_tokens_match_jax_and_paged(engines, models, spec):
    """Greedy mixed-length traffic with slot reuse (spec: n-gram drafts
    on every other request): the dense engine's tokens equal the JAX
    dense scheduler's and the port's paged engine's."""
    from dtdl_tpu.serve import NGramDraft as JaxNGramDraft
    jeng, teng = engines
    prompts, n_new = _traffic(1)
    paged = InferenceEngine(models[2], n_slots=2, buckets=BUCKETS,
                            page_size=8, device="cpu")
    out = []
    for eng in (teng, paged):
        reqs = [Request(p, n, speculate=spec * (i % 2 == 0))
                for i, (p, n) in enumerate(zip(prompts, n_new))]
        sched = Scheduler(eng, harvest_lag=3, device="cpu")
        sched.run(reqs)
        assert all(r.done and r.error is None for r in reqs)
        out.append([r.tokens for r in reqs])
    jreqs = [JaxRequest(p, n, speculate=spec * (i % 2 == 0))
             for i, (p, n) in enumerate(zip(prompts, n_new))]
    JaxScheduler(jeng, harvest_lag=3, draft=JaxNGramDraft()).run(jreqs)
    assert out[0] == out[1] == [r.tokens for r in jreqs]
    assert sched.pages is not None and Scheduler(
        teng, device="cpu").pages is None


def test_dense_engine_refuses_page_options(models):
    tm = models[2]
    with pytest.raises(ValueError, match="n_pages requires"):
        InferenceEngine(tm, n_slots=2, page_size=0, n_pages=8, device="cpu")
    with pytest.raises(ValueError, match="kv_pool_bytes requires"):
        InferenceEngine(tm, n_slots=2, page_size=0, kv_pool_bytes=1 << 20,
                        device="cpu")
    eng = InferenceEngine(tm, n_slots=2, buckets=BUCKETS, page_size=0,
                          device="cpu")
    assert eng.compile_stats()["paged"] is None
    with pytest.raises(ValueError, match="paged engine"):
        eng.prefill(eng.init_arena(), eng.init_last_tokens(), 0, [1, 2],
                    page_row=np.zeros(4, np.int32))
    with pytest.raises(ValueError, match="paged engine"):
        eng.decode(eng.init_arena(), eng.init_last_tokens(), [True, True],
                   *KNOBS, np.zeros((2, 4), np.int32))
