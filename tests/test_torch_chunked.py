"""Chunked prefill in the port against the JAX package's.

The JAX chunked-prefill tests' config (vocab 64, d_model 32, 2 layers,
2 heads, max_seq 48, page 4, f32), the same bridged weights and the same
numpy-seeded traffic go through the JAX ``Scheduler(chunk_tokens=)`` and
the port's, on a dense (``page_size=0``) and a paged engine.  The JAX
paged engine runs ``paged_kernel=False`` (its gather path), as its own
tests do on the CPU; the port's paged attend takes the kernel's plain
version for CPU tensors.

Tolerance: greedy tokens and the chunk counters are compared exactly, with
the JAX chunked run and with the port's own whole-prompt run.

:class:`CopyingJaxEngine` is the oracle engine of every test_torch_*.py
file that runs a JAX scheduler from this slice on: the JAX scheduler hands
its engine host arrays (page tables, sampling knobs, ``pos_set``,
``forced``, ``first_tok``, drafts) that it goes on to rewrite, and on the
CPU ``jnp.asarray`` can alias them, so a step still running may read the
rewritten values (ROADMAP C1).  The wrapper copies each of them before the
call.
"""

import jax
import jax.numpy as jnp
import flax.linen as fnn
import numpy as np
import pytest
import torch

from dtdl_tpu.models.transformer import transformer_lm as jax_lm
from dtdl_tpu.serve import InferenceEngine as JaxEngine
from dtdl_tpu.serve import NGramDraft as JaxNGramDraft
from dtdl_tpu.serve import Request as JaxRequest
from dtdl_tpu.serve import Scheduler as JaxScheduler
from dtdl_tpu_torch import bridge
from dtdl_tpu_torch.models.transformer import transformer_lm
from dtdl_tpu_torch.serve import (InferenceEngine, NGramDraft, Request,
                                  Scheduler)
from dtdl_tpu_torch.serve.scheduler import _SlotState

# small shapes: one intra-op thread each leaves the cores to the other
# test workers
torch.set_num_threads(1)

MAX_SEQ = 48
PAGE = 4
VOCAB = 64
BUCKETS = (8, 16, 32, MAX_SEQ)
CFG = dict(vocab_size=VOCAB, d_model=32, n_layers=2, n_heads=2, d_ff=64,
           max_seq=MAX_SEQ)
N_PAGES = 3 * (MAX_SEQ // PAGE) + 1


def _copy(x):
    return None if x is None else np.array(x, copy=True)


class CopyingJaxEngine(JaxEngine):
    """The JAX engine with every host array copied before its call."""

    def prefill(self, arena, last_tokens, slot, prompt, *args, page_row=None,
                **kw):
        return super().prefill(arena, last_tokens, slot, _copy(prompt),
                               *args, page_row=_copy(page_row), **kw)

    def decode(self, arena, last_tokens, active, key, temp, top_k, top_p,
               page_tables=None, **kw):
        return super().decode(arena, last_tokens, _copy(active), key,
                              _copy(temp), _copy(top_k), _copy(top_p),
                              page_tables=_copy(page_tables), **kw)

    def verify(self, arena, last_tokens, draft_tokens, draft_len, active,
               key, temp, top_k, top_p, page_tables=None, forced=None,
               first_tok=None, pos_set=None, **kw):
        return super().verify(
            arena, last_tokens, _copy(draft_tokens), _copy(draft_len),
            _copy(active), key, _copy(temp), _copy(top_k), _copy(top_p),
            page_tables=_copy(page_tables), forced=_copy(forced),
            first_tok=_copy(first_tok), pos_set=_copy(pos_set), **kw)


def jax_pair(**cfg):
    """The JAX model and params of the JAX serving tests' config (f32,
    dense attention, seed 0) and the port's model with those weights."""
    jm = jax_lm("tiny", attn_impl="dense", dtype=jnp.float32, **cfg)
    params = fnn.unbox(jm.init(jax.random.PRNGKey(0),
                               jnp.zeros((1, 4), jnp.int32))["params"])
    tm = transformer_lm("tiny", device="cpu", seed=None, dtype=torch.float32,
                        **cfg)
    bridge.load_flax_params(tm, jax.device_get(params), device="cpu")
    return jm, params, tm


@pytest.fixture(scope="module")
def models():
    return jax_pair(**CFG)


def _geometry(kind):
    return ({"page_size": 0} if kind == "dense"
            else {"page_size": PAGE, "n_pages": N_PAGES})


@pytest.fixture(scope="module")
def engines(models):
    """{kind: (JAX engine, port engine)} for 'dense' and 'paged'; module
    scoped, so the JAX programs compile once."""
    jm, params, tm = models
    out = {}
    for kind in ("dense", "paged"):
        geo = _geometry(kind)
        out[kind] = (CopyingJaxEngine(jm, params, n_slots=2, buckets=BUCKETS,
                                      paged_kernel=False, **geo),
                     InferenceEngine(tm, n_slots=2, buckets=BUCKETS,
                                     device="cpu", **geo))
    return out


def _run(eng, prompts, n_new, chunk=None, spec=0, jax_side=False):
    R, S = (JaxRequest, JaxScheduler) if jax_side else (Request, Scheduler)
    draft = JaxNGramDraft() if jax_side else NGramDraft()
    kw = {} if jax_side else {"device": "cpu"}
    reqs = [R(p, n, speculate=spec) for p, n in zip(prompts, n_new)]
    sched = S(eng, harvest_lag=2, chunk_tokens=chunk, draft=draft, **kw)
    sched.run(reqs)
    assert all(r.done and r.error is None for r in reqs), \
        [(r.rid, r.error) for r in reqs]
    return [r.tokens for r in reqs], sched.metrics.summary()


COUNTERS = ("prefill_chunks", "chunk_tokens", "decode_steps_delayed_by_prefill",
            "decode_tokens", "requests_finished", "prefill_tokens_saved",
            "spec_steps")


@pytest.mark.parametrize("chunk", [1, 3, 8])
@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_chunked_tokens_match_jax_and_whole_prompt(engines, kind, chunk):
    """Mixed-length prompts through 2 slots with mid-flight admission:
    the port's chunked tokens equal the JAX chunked scheduler's and the
    port's whole-prompt run's; the chunk counters equal JAX's, and only
    whole-prompt prefill delays decode steps."""
    jeng, teng = engines[kind]
    gen = np.random.default_rng(1)
    prompts = [gen.integers(0, VOCAB, n).tolist() for n in (3, 14, 29, 5, 7)]
    n_new = (6, 4, 8, 3, 5)
    ref, mref = _run(teng, prompts, n_new)
    assert mref["decode_steps_delayed_by_prefill"] > 0
    got, m = _run(teng, prompts, n_new, chunk=chunk)
    want, mj = _run(jeng, prompts, n_new, chunk=chunk, jax_side=True)
    assert got == want == ref
    for key in COUNTERS:
        assert m[key] == mj[key], key
    assert m["decode_steps_delayed_by_prefill"] == 0
    assert m["chunk_tokens"] == sum(len(p) for p in prompts)
    assert m["prefill_chunks"] >= len(prompts)


def test_chunked_spec_and_prefix_hits_match_jax(engines):
    """Chunked + paged + speculative + prefix cache: the second request
    hits the first's 3 shared pages (published at its final chunk) and
    chunks only its suffix; tokens and counters as JAX's, tokens as the
    port's whole-prompt run's."""
    jeng, teng = engines["paged"]
    gen = np.random.default_rng(2)
    shared = gen.integers(0, VOCAB, 3 * PAGE).tolist()
    p0 = shared + gen.integers(0, VOCAB, 5).tolist()
    p1 = shared + gen.integers(0, VOCAB, 9).tolist()
    ref = [_run(teng, [p], [n])[0][0] for p, n in ((p0, 8), (p1, 6))]
    outs = []
    for jax_side, eng in ((False, teng), (True, jeng)):
        R, S = (JaxRequest, JaxScheduler) if jax_side else (Request,
                                                             Scheduler)
        kw = {} if jax_side else {"device": "cpu"}
        sched = S(eng, harvest_lag=2, chunk_tokens=5,
                  draft=JaxNGramDraft() if jax_side else NGramDraft(), **kw)
        r0, r1 = R(p0, 8, speculate=4), R(p1, 6, speculate=4)
        sched.run([r0])
        sched.run([r1])
        outs.append(([r0.tokens, r1.tokens], sched.metrics.summary()))
    (got, m), (want, mj) = outs
    assert got == want == ref
    assert m["prefill_tokens_saved"] == 3 * PAGE
    assert m["chunk_tokens"] == len(p0) + len(p1) - 3 * PAGE
    for key in COUNTERS:
        assert m[key] == mj[key], key


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_brim_prompt_matches_jax(engines, kind):
    """A prompt filling max_seq decodes its one budgeted token chunked as
    whole-prompt (no 1-token final chunk is ever stranded), as JAX."""
    jeng, teng = engines[kind]
    long = np.random.default_rng(3).integers(0, VOCAB, MAX_SEQ).tolist()
    ref, _ = _run(teng, [long], [3])
    for chunk in (1, 5):
        got, m = _run(teng, [long], [3], chunk=chunk)
        want, mj = _run(jeng, [long], [3], chunk=chunk, jax_side=True)
        assert got == want == ref and len(got[0]) == 1
        assert m["prefill_chunks"] == mj["prefill_chunks"]


def test_slotstate_gap_excludes_chunk_echo():
    """In-flight chunks advance the cache index (pos_hi) but not the
    output (gap_est): an intermediate chunk counts 0, the final one its
    bonus token (the JAX test's numbers)."""
    st = _SlotState(1, 0, 4, fill_end=16)
    st.acc_ema = 1.0
    st.dispatched(7, 1)
    st.dispatched(7, 2)
    st.dispatched(3, 0)
    assert st.pos_hi == 8 + 8 + 4
    assert st.gap_est == 0 + 1 + 4


def test_chunk_tokens_validated(engines):
    with pytest.raises(ValueError, match="chunk_tokens"):
        Scheduler(engines["dense"][1], chunk_tokens=0, device="cpu")
