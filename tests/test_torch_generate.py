"""The port's dense decode cache, ``generate`` and ``ModelDraft`` against
the JAX package's.

The same bridged weights (vocab 64, d_model 32, 2 layers, 2 heads,
max_seq 48, f32) and the same prompts, made with numpy from seeds.  The
dense decode attend is plain torch in the port and plain jnp in JAX (no
Pallas kernel on this path).  Query rows attend in ``PREFILL_CHUNK``
blocks; at max_seq 48 a prompt cannot pass the real 256, so the chunked
case sets the chunk to 8 on both sides.

Tolerances: greedy tokens and draft proposals exactly equal; the dense
decode logits within atol 1e-4 (f32, different matmul and softmax
summation orders over two layers, as tests/test_torch_model.py).
"""

import jax
import jax.numpy as jnp
import flax.linen as fnn
import numpy as np
import pytest
import torch

from dtdl_tpu.models import transformer as jtr
from dtdl_tpu.serve import ModelDraft as JaxModelDraft
from dtdl_tpu_torch import bridge
from dtdl_tpu_torch.models import generate
from dtdl_tpu_torch.models import transformer as ttr
from dtdl_tpu_torch.serve import (InferenceEngine, ModelDraft, Request,
                                  Scheduler)

# small shapes: one intra-op thread each leaves the cores to the other
# test workers
torch.set_num_threads(1)

MAX_SEQ = 48
VOCAB = 64
CFG = dict(vocab_size=VOCAB, d_model=32, n_layers=2, n_heads=2, d_ff=64,
           max_seq=MAX_SEQ)
ATOL = 1e-4


@pytest.fixture(scope="module")
def models():
    jm = jtr.transformer_lm("tiny", attn_impl="dense", dtype=jnp.float32,
                            **CFG)
    params = fnn.unbox(jm.init(jax.random.PRNGKey(0),
                               jnp.zeros((1, 4), jnp.int32))["params"])
    tm = ttr.transformer_lm("tiny", device="cpu", seed=None,
                            dtype=torch.float32, **CFG)
    bridge.load_flax_params(tm, jax.device_get(params), device="cpu")
    return jm, params, tm


@pytest.mark.parametrize("prompt_len,chunk", [(5, None), (21, 8)])
def test_generate_greedy_matches_jax(models, monkeypatch, prompt_len, chunk):
    """Greedy generate, two prompts per batch: tokens identical to the JAX
    generate, with the prefill unchunked and chunked (21 rows in blocks
    of 8, the last one partial)."""
    jm, params, tm = models
    if chunk is not None:
        monkeypatch.setattr(jtr.Attention, "PREFILL_CHUNK", chunk)
        monkeypatch.setattr(ttr.Attention, "PREFILL_CHUNK", chunk)
    rng = np.random.default_rng(prompt_len)
    prompt = rng.integers(0, VOCAB, (2, prompt_len)).astype(np.int32)
    n_new = MAX_SEQ - prompt_len - 3
    want = np.asarray(jtr.generate(jm, params, jnp.asarray(prompt), n_new))
    got = generate(tm, prompt, n_new)
    assert got.dtype == torch.int32 and got.shape == (2, prompt_len + n_new)
    np.testing.assert_array_equal(got.numpy(), want)


def test_dense_cache_layout_and_logits_match_jax(models):
    """init_cache holds the JAX cache's K/V shapes; a prefill and two
    single-token steps give the JAX decode logits and leave the same
    index; a step past max_seq raises by name."""
    jm, params, tm = models
    jcache = jm.init_cache(2)
    tcache = tm.init_cache(2)
    for i in range(CFG["n_layers"]):
        for name in ("key", "value"):
            assert tuple(tcache[f"block_{i}"]["attn"][name].shape) == \
                jcache[f"block_{i}"]["attn"][name].shape
    rng = np.random.default_rng(4)
    steps = [rng.integers(0, VOCAB, (2, n)).astype(np.int32)
             for n in (7, 1, 1)]
    for toks in steps:
        jl, muts = jm.apply({"params": params, "cache": jcache},
                            jnp.asarray(toks), decode=True,
                            mutable=["cache"])
        jcache = muts["cache"]
        with torch.no_grad():
            tl = tm(torch.from_numpy(toks).long(), cache=tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=ATOL)
    assert int(tcache["index"]) == int(jcache["block_0"]["attn"]["index"])
    np.testing.assert_allclose(
        tcache["block_1"]["attn"]["key"].numpy(),
        np.asarray(jcache["block_1"]["attn"]["key"]), rtol=0, atol=ATOL)
    with pytest.raises(ttr.CacheOverflowError, match="max_seq"):
        with torch.no_grad():
            tm(torch.zeros(2, MAX_SEQ, dtype=torch.long), cache=tcache)


def test_sampled_generate_reproduces_from_the_generator(models):
    """Temperature sampling draws with the caller's generator: the same
    seed gives the same tokens; no generator is refused."""
    tm = models[2]
    prompt = np.arange(6, dtype=np.int32)[None]
    runs = [generate(tm, prompt, 12, temperature=0.8,
                     generator=torch.Generator().manual_seed(5))
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert ((runs[0] >= 0) & (runs[0] < VOCAB)).all()
    with pytest.raises(ValueError, match="Generator"):
        generate(tm, prompt, 4, temperature=0.8)
    with pytest.raises(ValueError, match="max_seq"):
        generate(tm, prompt, MAX_SEQ)


def test_model_draft_proposals_match_jax(models):
    """The draft's power-of-two context and k buckets: proposals equal to
    the JAX ModelDraft's over context lengths 1-20 and k 1-5."""
    jm, params, tm = models
    jd = JaxModelDraft(jm, params, window=8)
    td = ModelDraft(tm, window=8)
    rng = np.random.default_rng(7)
    for ctx_len, k in ((1, 1), (3, 2), (9, 3), (20, 5)):
        ctx = rng.integers(0, VOCAB, ctx_len).astype(np.int32)
        got, want = td.propose(ctx, k), jd.propose(ctx, k)
        assert got.dtype == np.int32 and got.size == k
        np.testing.assert_array_equal(got, want)
    assert td.propose(np.zeros(0, np.int32), 3).size == 0


def test_model_draft_spec_identical(models):
    """ModelDraft through the scheduler (the target model itself over an
    8-token window, the degenerate but fully exercising case, and a warmed
    draft): greedy tokens equal the plain run's and the JAX generate's."""
    jm, params, tm = models
    eng = InferenceEngine(tm, n_slots=1, buckets=(8, 16), page_size=8,
                          device="cpu")
    rng = np.random.default_rng(8)
    prompt = rng.integers(0, VOCAB, 6).tolist()
    plain = Request(prompt, 10)
    Scheduler(eng, harvest_lag=1, device="cpu").run([plain])
    want = np.asarray(jtr.generate(jm, params, jnp.asarray([prompt]), 10))
    assert plain.tokens == want[0, len(prompt):].tolist()
    req = Request(prompt, 10, speculate=2)
    sched = Scheduler(eng, harvest_lag=1, device="cpu",
                      draft=ModelDraft(tm, window=8, warmup=2))
    sched.run([req])
    assert req.tokens == plain.tokens
    s = sched.metrics.summary()
    assert s["spec_steps"] > 0 and s["spec_drafted_tokens"] > 0
