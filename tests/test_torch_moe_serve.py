"""Serving a routed MoE LM: the port's scheduler and engines against the
JAX package's.

The JAX serving tests' config (vocab 64, d_model 32, 2 layers, 2 heads,
d_ff 64, max_seq 48, page 4, f32) with 4 experts in block 1
(``moe_every=2``), routed top-1 at capacity factor 1.25: the JAX
``Scheduler`` over a :class:`CopyingJaxEngine` (ROADMAP C1) and the
port's over its engine, with the same bridged weights and the same
numpy-seeded traffic, on the paged engine, the dense arena
(``page_size=0``) and an int8 engine (weights, experts included, and KV)
here, chunked prefill and speculative decoding (n-gram) in
tests/test_torch_moe_spec.py.

Routing is per batch row in groups of its tokens, so a prefill bucket's
pad tokens, a zero-padded verify window and a chunk window all take
capacity: at capacity factor 1.25 chunked, speculative and prefix-hit
serving compute other functions than whole-prompt, plain and cold
serving, in both packages (ROADMAP C).  The port follows the JAX
scheduler path for path; identity between such pairs is checked at
capacity factor 4 (= E / top_k), where nothing drops.

Tolerance: greedy tokens exactly equal; logits (the capacity test)
atol 1e-4 between the packages (f32, two layers, as
tests/test_torch_model.py).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtdl_tpu.models.transformer import transformer_lm as jax_lm
from dtdl_tpu.serve import NGramDraft as JaxNGramDraft
from dtdl_tpu.serve import Request as JaxRequest
from dtdl_tpu.serve import Scheduler as JaxScheduler
from dtdl_tpu_torch import bridge
from dtdl_tpu_torch.models.transformer import transformer_lm
from dtdl_tpu_torch.serve import (InferenceEngine, NGramDraft, Request,
                                  Scheduler)
from test_torch_chunked import CopyingJaxEngine

torch.set_num_threads(1)

MAX_SEQ = 48
PAGE = 4
VOCAB = 64
BUCKETS = (16, 32, MAX_SEQ)
CFG = dict(vocab_size=VOCAB, d_model=32, n_layers=2, n_heads=2, d_ff=64,
           max_seq=MAX_SEQ, n_experts=4, moe_every=2,
           moe_dispatch="routed")
N_PAGES = 3 * (MAX_SEQ // PAGE) + 1
_PAIRS = {}


def moe_pair(capacity_factor=1.25):
    if capacity_factor not in _PAIRS:
        cfg = dict(CFG, capacity_factor=capacity_factor)
        jm = jax_lm("tiny", attn_impl="dense", dtype=jnp.float32, **cfg)
        params = fnn.unbox(jax.jit(jm.init)(
            jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"])
        tm = transformer_lm("tiny", device="cpu", seed=None,
                            dtype=torch.float32, **cfg)
        bridge.load_flax_params(tm, jax.device_get(params), device="cpu")
        _PAIRS[capacity_factor] = (jm, params, tm)
    return _PAIRS[capacity_factor]


def _traffic(seed=1):
    """Six requests through two slots: three share an 8-token (two-page)
    prefix, lengths 5-29."""
    gen = np.random.default_rng(seed)
    shared = gen.integers(0, VOCAB, 2 * PAGE).tolist()
    prompts = []
    for i, n in enumerate((13, 5, 21, 9, 29, 11)):
        tail = gen.integers(0, VOCAB, n).tolist()
        prompts.append(shared + tail if i % 2 == 0 else tail)
    return prompts, (6, 4, 7, 5, 3, 6)


def _serve(eng, traffic, jax_side=False, chunk=None, spec=0):
    R, S = (JaxRequest, JaxScheduler) if jax_side else (Request, Scheduler)
    draft = JaxNGramDraft() if jax_side else NGramDraft()
    kw = {} if jax_side else {"device": "cpu"}
    prompts, n_new = traffic
    reqs = [R(p, n, speculate=spec) for p, n in zip(prompts, n_new)]
    sched = S(eng, harvest_lag=2, chunk_tokens=chunk, draft=draft, **kw)
    sched.run(reqs)
    assert all(r.done and r.error is None for r in reqs), \
        [(r.rid, r.error) for r in reqs]
    return [r.tokens for r in reqs], sched.metrics.summary()


_ENGINES = {}


def _engines(capacity_factor=1.25, **geo):
    """(JAX engine, port engine) with these options; cached, so the JAX
    programs compile once per engine."""
    key = (capacity_factor, tuple(sorted(geo.items())))
    if key not in _ENGINES:
        jm, params, tm = moe_pair(capacity_factor)
        _ENGINES[key] = (
            CopyingJaxEngine(jm, params, n_slots=2, buckets=BUCKETS,
                             paged_kernel=False, **geo),
            InferenceEngine(tm, n_slots=2, buckets=BUCKETS, device="cpu",
                            **geo))
    return _ENGINES[key]


PAGED = {"page_size": PAGE, "n_pages": N_PAGES}


def check_tokens_match_jax(case):
    """Greedy tokens of the port's scheduler equal the JAX scheduler's on
    the same traffic and engine options ``case``, with routed capacity
    1.25, and so do the prefill, chunk, decode and spec counters."""
    geo = dict(PAGED)
    run = {}
    if case == "dense_arena":
        geo = {"page_size": 0}
    if case == "int8":
        geo.update(quantize_weights=True, kv_dtype="int8")
    if case in ("chunked", "chunked_spec"):
        run["chunk"] = 5
    if case in ("spec", "chunked_spec"):
        run["spec"] = 4
    jeng, teng = _engines(**geo)
    traffic = _traffic()
    got, m = _serve(teng, traffic, **run)
    want, mj = _serve(jeng, traffic, jax_side=True, **run)
    assert got == want
    for key in ("prefill_tokens_saved", "prefill_chunks", "chunk_tokens",
                "decode_tokens", "spec_steps"):
        assert m[key] == mj[key], key
    if case == "paged":
        assert m["prefix_hit_pages"] > 0
    if case == "int8":
        assert teng.model.block_1.moe.wi.dtype == torch.int8
        assert teng.model.block_1.moe.router.kernel.dtype == torch.float32


@pytest.mark.parametrize("case", ["paged", "dense_arena", "int8"])
def test_moe_scheduler_tokens_match_jax(case):
    """The paged engine (prefix hits included), the dense arena and int8
    weights (experts included) with an int8 KV pool; chunked prefill and
    speculation are in tests/test_torch_moe_spec.py."""
    check_tokens_match_jax(case)


def test_capacity_makes_the_bucket_part_of_the_function():
    """A prompt's last logits depend on the bucket it is padded to, since
    capacity grows with the routed window: this prompt's last token (its
    MoE block is the last block, so nothing else can move its logits)
    drops at the 16-token bucket's 5 slots per expert and not at the
    32-token bucket's 10, in the JAX model, and the port computes the
    same (atol 1e-4 to JAX at each bucket).  At factor 4 the two buckets
    agree."""
    prompt = np.random.default_rng(2).integers(0, VOCAB, 14)
    for cf, differ in ((1.25, True), (4.0, False)):
        jm, params, tm = moe_pair(cf)
        last = {}
        for T in (16, 32):
            toks = np.zeros((1, T), np.int32)
            toks[0, :14] = prompt
            want = np.asarray(jax.jit(jm.apply)({"params": params},
                                                jnp.asarray(toks)))[0, 13]
            with torch.no_grad():
                got = tm(torch.from_numpy(toks))[0, 13].numpy()
            np.testing.assert_allclose(got, want, atol=1e-4)
            last[T] = want
        gap = float(np.abs(last[16] - last[32]).max())
        assert (gap > 1e-3) == differ, (cf, gap)
