"""Weight and KV quantization in the port against the JAX package's
(dtdl_tpu/quant).

The JAX quantization tests' config (vocab 64, d_model 32, 2 layers,
2 heads, max_seq 48, page 8, f32) with the same bridged weights and
numpy-seeded inputs.  Tolerances, each stated where it is used:

* the quantizers (``quantize_tensor``, ``kv_quantize``): int8 payloads and
  scales bitwise equal to JAX's, fp8 payloads bitwise after a uint8 view
  of both, bf16 scales bitwise;
* ``quantize_params``: JAX's schema (names with ``.`` for ``/``, shapes,
  dtypes) and JAX's values, bitwise;
* logits: the quantized model against the f32 model within the JAX
  tests' stated parity budget, 5% of the f32 logit range for int8
  (``REL_TOL``) and 3x that for fp8; the port's quantized forward against
  JAX's quantized forward within atol 1e-5 (same payloads, f32 summation
  order);
* engines: greedy tokens of the quantized engines identical to the JAX
  quantized engines' on the same traffic (exact); byte receipts and page
  counts equal JAX's (exact).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtdl_tpu import quant as jq
from dtdl_tpu.serve import NGramDraft as JaxNGramDraft
from dtdl_tpu.serve import Request as JaxRequest
from dtdl_tpu.serve import Scheduler as JaxScheduler
from dtdl_tpu_torch import bridge, quant
from dtdl_tpu_torch.models.transformer import transformer_lm
from dtdl_tpu_torch.serve import (InferenceEngine, NGramDraft, Request,
                                  Scheduler)
from test_torch_chunked import CopyingJaxEngine, jax_pair

torch.set_num_threads(1)

MAX_SEQ = 48
PAGE = 8
VOCAB = 64
BUCKETS = (8, 16)
CFG = dict(vocab_size=VOCAB, d_model=32, n_layers=2, n_heads=2, d_ff=64,
           max_seq=MAX_SEQ)
REL_TOL = 0.05
FP8_REL_TOL = 3 * REL_TOL
ATOL = 1e-5
MODES = {"int8": (True, "int8"), "fp8": ("w8f", "fp8")}


@pytest.fixture(scope="module")
def models():
    return jax_pair(**CFG)


def _bits(x):
    """Raw bytes of a JAX or torch array, as numpy (fp8 through uint8)."""
    if isinstance(x, torch.Tensor):
        a = x.view({1: torch.uint8, 2: torch.int16,
                    4: torch.int32}[x.element_size()]).numpy()
    else:
        a = np.asarray(x)
    return a.view({1: np.uint8, 2: np.int16, 4: np.int32}[a.itemsize])


def _weights(seed):
    gen = np.random.default_rng(seed)
    w = (gen.normal(size=(32, 2, 8)) *
         np.logspace(-3, 3, 8)).astype(np.float32)
    w[:, 1, 5] = 0.0                              # an all-zero channel
    return w


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantize_tensor_bitwise_jax(mode):
    w = _weights(0)
    jdt = jnp.int8 if mode == "int8" else jq.FP8_DTYPE
    tdt = torch.int8 if mode == "int8" else torch.float8_e4m3fn
    for scale_shape in ((1, 2, 8), (32, 1, 8), (32, 2, 8)):
        jqv, js = jq.quantize_tensor(w, scale_shape, dtype=jdt)
        tqv, ts = quant.quantize_tensor(torch.from_numpy(w), scale_shape,
                                        dtype=tdt)
        assert tqv.dtype == tdt and tuple(ts.shape) == js.shape
        np.testing.assert_array_equal(_bits(tqv), _bits(jqv))
        np.testing.assert_array_equal(_bits(ts), _bits(js))
    assert float(ts.float().flatten()[0]) > 0
    with pytest.raises(ValueError, match="broadcast"):
        quant.quantize_tensor(torch.from_numpy(w), (2, 8))


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_kv_quantize_bitwise_jax(mode):
    gen = np.random.default_rng(4)
    x = (gen.normal(size=(2, 3, 5, 16)) *
         gen.lognormal(2.0, size=(2, 3, 5, 1))).astype(np.float32)
    x[0, 1, 2] = 0.0                              # an all-zero row
    jdt = jnp.int8 if mode == "int8" else jq.FP8_DTYPE
    tdt = torch.int8 if mode == "int8" else torch.float8_e4m3fn
    jqv, js = jq.kv_quantize(jnp.asarray(x), dtype=jdt)
    tqv, ts = quant.kv_quantize(torch.from_numpy(x), tdt)
    assert ts.dtype == quant.kv_scale_dtype(mode)
    np.testing.assert_array_equal(_bits(tqv), _bits(jqv))
    np.testing.assert_array_equal(_bits(ts), _bits(js))


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantize_params_schema_and_values_match_jax(models, mode):
    """The port's quantized state_dict holds JAX's tree: every name with
    ``.`` for ``/``, its shape and dtype, its bytes.  The JAX quantized
    tree crosses the bridge onto a quantized port model (fp8 as uint8,
    then viewed) to the same state, and re-quantizing a quantized tree
    raises, as in JAX."""
    jm, params, tm = models
    wmode = MODES[mode][0]
    jtree = bridge.flatten(jax.device_get(
        jq.quantize_params(jm, params, wmode)))
    ttree = quant.quantize_params(tm, tm.state_dict(), wmode)
    assert sorted(k.replace(".", "/") for k in ttree) == sorted(jtree)
    for name, t in ttree.items():
        j = jtree[name.replace(".", "/")]
        assert tuple(t.shape) == j.shape, name
        np.testing.assert_array_equal(_bits(t), _bits(j), err_msg=name)
    qm = transformer_lm("tiny", device="cpu", seed=None, dtype=torch.float32,
                        quantize=wmode, **CFG)
    bridge.load_flax_params(qm, jtree, device="cpu")
    for name, t in qm.state_dict().items():
        np.testing.assert_array_equal(_bits(t), _bits(ttree[name]),
                                      err_msg=name)
    with pytest.raises(ValueError, match="already quantized"):
        quant.quantize_params(qm, qm.state_dict(), wmode)
    deq = quant.dequantize_params(ttree)
    jdeq = bridge.flatten(jax.device_get(jq.dequantize_params(
        jq.quantize_params(jm, params, wmode))))
    for name, t in deq.items():
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(jdeq[name.replace(".", "/")],
                                                 np.float32), err_msg=name)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantized_logits_parity(models, mode):
    """The quantized cacheless forward: within the stated budget of the
    f32 logits (5% of their range for int8, 15% for fp8), and within
    atol 1e-5 of JAX's quantized forward."""
    jm, params, tm = models
    wmode = MODES[mode][0]
    toks = np.random.default_rng(1).integers(0, VOCAB, (2, 8))
    qm = tm.clone(quantize=wmode)
    qm.load_state_dict(quant.quantize_params(tm, tm.state_dict(), wmode))
    with torch.no_grad():
        lf = tm(torch.from_numpy(toks)).numpy()
        lq = qm(torch.from_numpy(toks)).numpy()
    tol = (REL_TOL if mode == "int8" else FP8_REL_TOL) * np.abs(lf).max()
    assert np.abs(lq - lf).max() <= tol
    want = jm.clone(quantize=wmode).apply(
        {"params": jq.quantize_params(jm, params, wmode)}, jnp.asarray(toks))
    np.testing.assert_allclose(lq, np.asarray(want), rtol=0, atol=ATOL)


def _traffic(seed, lens, n_new):
    gen = np.random.default_rng(seed)
    return [gen.integers(0, VOCAB, n).tolist() for n in lens], n_new


def _serve_both(models, traffic, spec_every, **geo_and_quant):
    """The same traffic through the JAX engine and the port's with the
    same options; returns (port tokens, JAX tokens, port engine)."""
    jm, params, tm = models
    prompts, n_new = traffic
    jeng = CopyingJaxEngine(jm, params, n_slots=2, buckets=BUCKETS,
                            paged_kernel=False, **geo_and_quant)
    teng = InferenceEngine(tm, n_slots=2, buckets=BUCKETS, device="cpu",
                           **geo_and_quant)
    spec = [4 if spec_every and i % spec_every == 0 else 0
            for i in range(len(prompts))]
    treqs = [Request(p, n, speculate=k)
             for p, n, k in zip(prompts, n_new, spec)]
    sched = Scheduler(teng, harvest_lag=2, draft=NGramDraft(), device="cpu")
    sched.run(treqs)
    jreqs = [JaxRequest(p, n, speculate=k)
             for p, n, k in zip(prompts, n_new, spec)]
    JaxScheduler(jeng, harvest_lag=2, draft=JaxNGramDraft()).run(jreqs)
    assert all(r.done and r.error is None for r in treqs)
    return [r.tokens for r in treqs], [r.tokens for r in jreqs], teng, sched


def test_dense_w8kv8_engine_token_identity(models):
    """The dense int8 arena (per-slot [B, H, max_seq] K/V with scale
    rows) with int8 weights: mixed-length greedy traffic with slot reuse,
    tokens as the JAX dense w8kv8 engine's."""
    got, want, teng, _ = _serve_both(
        models, _traffic(1, (3, 9, 14, 5), (6, 4, 8, 3)), 0, page_size=0,
        quantize_weights=True, kv_dtype="int8")
    assert got == want
    arena = teng.init_arena()
    assert arena["block_0"]["attn"]["key"].dtype == torch.int8
    assert tuple(arena["block_0"]["attn"]["key_scale"].shape) == (2, 2,
                                                                   MAX_SEQ)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantized_paged_spec_mixed_traffic_token_identity(models, mode):
    """Quantized weights and pools on the paged engine, with every other
    request speculating (n-gram drafts), and a prefix hit: tokens as the
    JAX engine's with the same options."""
    wmode, kv = MODES[mode]
    prompts, n_new = _traffic(5, (5, 9, 12), (10, 9, 8))
    prompts.append(list(prompts[2]))           # a prefix-cache hit
    got, want, _, sched = _serve_both(
        models, (prompts, n_new + (5,)), 2, page_size=PAGE,
        quantize_weights=wmode, kv_dtype=kv)
    assert got == want
    assert sched.metrics.summary()["prefill_tokens_saved"] == PAGE
    assert sched.pages.pages_in_use == 0


def test_page_bytes_and_receipts_match_jax(models):
    """page_bytes (the 3-page arena minus the 2-page one, scales
    included), the pages a kv_pool_bytes budget buys, and the byte
    receipts of compile_stats()['quant'] equal JAX's, for every weight
    and KV mode, dense and paged."""
    jm, params, tm = models
    budget = 256 * 1024
    for wmode in (False, True, "w8f"):
        for kv in (None, "int8", "fp8"):
            for geo in ({"page_size": 0},
                        {"page_size": PAGE, "kv_pool_bytes": budget}):
                kw = dict(n_slots=2, buckets=BUCKETS, quantize_weights=wmode,
                          kv_dtype=kv, **geo)
                j = CopyingJaxEngine(jm, params, **kw)
                t = InferenceEngine(tm, device="cpu", **kw)
                assert (t.page_bytes, t.n_pages) == (j.page_bytes,
                                                     j.n_pages), kw
                assert t.compile_stats()["quant"] == \
                    j.compile_stats()["quant"], kw
    pi8 = InferenceEngine(tm, n_slots=2, page_size=PAGE,
                          kv_pool_bytes=budget, kv_dtype="int8", device="cpu")
    pf = InferenceEngine(tm, n_slots=2, page_size=PAGE, kv_pool_bytes=budget,
                         device="cpu")
    assert pi8.n_pages >= 2 * pf.n_pages
    assert pi8.page_bytes * pi8.n_pages <= budget


def test_quant_options_named_errors(models):
    tm = models[2]
    with pytest.raises(ValueError, match="kv_dtype"):
        InferenceEngine(tm, device="cpu", kv_dtype="int4")
    with pytest.raises(ValueError, match="quantize_weights"):
        InferenceEngine(tm, device="cpu", quantize_weights="int4")
    with pytest.raises(ValueError, match="quantize_weights"):
        transformer_lm("tiny", device="cpu", quantize="w4")
    with pytest.raises(ValueError, match="not both"):
        InferenceEngine(tm, device="cpu", page_size=PAGE, n_pages=13,
                        kv_pool_bytes=1 << 20)
    with pytest.raises(ValueError, match="holds"):
        InferenceEngine(tm, device="cpu", page_size=PAGE, kv_pool_bytes=1)
    with pytest.raises(ValueError, match="kv_pool_bytes"):
        InferenceEngine(tm, device="cpu", page_size=0, kv_pool_bytes=1 << 20)


def test_quantized_model_from_seed_is_the_quantized_float_model():
    """transformer_lm(quantize=...) with a seed holds the float model's
    weights from that seed, quantized."""
    f = transformer_lm("tiny", device="cpu", seed=3, **CFG)
    for wmode in (True, "w8f"):
        q = transformer_lm("tiny", device="cpu", seed=3, quantize=wmode,
                           **CFG)
        want = quant.quantize_params(f, f.state_dict(), wmode)
        for name, t in q.state_dict().items():
            np.testing.assert_array_equal(_bits(t), _bits(want[name]))
