"""Batched multi-LoRA in the port against the JAX package's
(dtdl_tpu/serve/tenant/lora.py and its hooks in the model, engine and
scheduler).

The JAX multi-tenant tests' config (vocab 64, d_model 32, 2 layers, 2
heads, max_seq 48, f32, rank 2, 3 bank rows) with the same bridged
weights; three adapters drawn from one numpy seed, saved through each
package's own ``save_weights`` (the JAX one for the JAX bank, the port's
manifest-checked one for the port's).  Tolerances, each where it is used:

* ``adapter_template``/``init_bank``: the JAX layout, shapes and dtypes,
  exactly; ``merge_adapter``: the merged kernels within atol 1e-6;
* the model's forward with a mixed-adapter bank against JAX's
  ``model.apply`` with the ``lora`` collection: atol 1e-5 (f32,
  summation order);
* ``AdapterBank``: every row id, refcount, resident set, load and
  eviction count equal to JAX's over one script, and the bank's rows
  equal to JAX's bitwise;
* serving: greedy tokens exact, against JAX's scheduler (through
  ``CopyingJaxEngine``, ROADMAP C1) and against the merged-weights oracle
  (each request alone on an engine serving ``merge_adapter(model,
  adapter)``), dense and paged, plain, chunked and speculative;
* requests of two adapters that share prompt pages (ROADMAP C5): held to
  the merged oracle and to JAX with ``prefix_cache=False``, never to the
  JAX paged scheduler with its cache on, which maps the pages across
  adapters; a base request's page hashes are JAX's, exactly.
"""

import hashlib
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtdl_tpu.ckpt.checkpoint import save_weights as jax_save_weights
from dtdl_tpu.serve import AdapterBank as JaxBank
from dtdl_tpu.serve import Request as JaxRequest
from dtdl_tpu.serve import Scheduler as JaxScheduler
from dtdl_tpu.serve import adapter_template as jax_template
from dtdl_tpu.serve import merge_adapter as jax_merge
from dtdl_tpu.serve import page_chain_hashes as jax_hashes
from dtdl_tpu.serve.engine import _lora_vars
from dtdl_tpu.serve.tenant import init_bank as jax_init_bank
from dtdl_tpu_torch.ckpt.checkpoint import save_weights
from dtdl_tpu_torch.serve import (AdapterBank, AdapterBankFullError,
                                  InferenceEngine, PageAllocator, Request,
                                  Scheduler, adapter_salt, adapter_template,
                                  merge_adapter, page_chain_hashes)
from dtdl_tpu_torch.serve.tenant import init_bank
from test_torch_chunked import CopyingJaxEngine, jax_pair

torch.set_num_threads(1)

MAX_SEQ = 48
PAGE = 4
BUCKETS = (8, 16, 32, MAX_SEQ)
CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, d_ff=64,
           max_seq=MAX_SEQ)
RANK = 2
N_ADAPTERS = 3          # row 0 = base, 2 loadable rows
N_PAGES = 40
GEOMETRY = {"dense": {"page_size": 0},
            "paged": {"page_size": PAGE, "n_pages": N_PAGES}}


@pytest.fixture(scope="module")
def models():
    return jax_pair(**CFG)


@pytest.fixture(scope="module")
def adapters(models, tmp_path_factory):
    """name -> (JAX file, port file, host tree) for A, B, C: normal(0,
    0.3) factors from one seed, saved through each package's path."""
    _, params, tm = models
    tpl = adapter_template(tm, RANK)
    rng = np.random.default_rng(7)
    jdir = tmp_path_factory.mktemp("jax_adapters")
    tdir = tmp_path_factory.mktemp("port_adapters")
    out = {}
    for name in ("A", "B", "C"):
        tree = {b: {"attn": {n: rng.normal(0.0, 0.3, a.shape)
                             .astype(np.float32)
                             for n, a in sub["attn"].items()}}
                for b, sub in tpl.items()}
        jp, tp = str(jdir / name), str(tdir / name)
        jax_save_weights(jp, tree)
        save_weights(tp, tree)
        out[name] = (jp, tp, tree)
    return out


@pytest.fixture(scope="module")
def engines(models):
    """{kind: (JAX LoRA engine, port LoRA engine)}, module scoped so the
    JAX programs compile once."""
    jm, params, tm = models
    return {kind: (CopyingJaxEngine(jm, params, n_slots=2, buckets=BUCKETS,
                                    paged_kernel=False, lora_rank=RANK,
                                    lora_adapters=N_ADAPTERS, **geo),
                   InferenceEngine(tm, n_slots=2, buckets=BUCKETS,
                                   device="cpu", lora_rank=RANK,
                                   lora_adapters=N_ADAPTERS, **geo))
            for kind, geo in GEOMETRY.items()}


def merged_solo(tm, tree, prompt, n_new, **geo):
    """The merged-weights oracle: the request alone on an engine serving
    ``merge_adapter(tm, tree)`` (the base model for ``tree`` None)."""
    model = tm if tree is None else merge_adapter(tm, tree)
    eng = InferenceEngine(model, n_slots=1, buckets=BUCKETS, device="cpu",
                          **geo)
    return Scheduler(eng, device="cpu").run(
        [Request(list(prompt), n_new)])[0].tokens


def test_template_and_bank_shapes_match_jax(models):
    _, params, tm = models
    want = jax_template(params, RANK)
    got = adapter_template(tm, RANK)
    assert got.keys() == want.keys()
    for b in want:
        assert got[b]["attn"].keys() == want[b]["attn"].keys()
        for n, a in want[b]["attn"].items():
            assert got[b]["attn"][n].shape == a.shape
            assert got[b]["attn"][n].dtype == np.float32
    jbank = jax_init_bank(params, RANK, N_ADAPTERS)
    bank = init_bank(tm, RANK, N_ADAPTERS)
    for b in want:
        for n, leaf in jbank[b]["attn"].items():
            t = bank[b]["attn"][n]
            assert tuple(t.shape) == leaf.shape and t.dtype == torch.float32
            assert not t.any()


def test_merge_adapter_matches_jax(models, adapters):
    """Merged q/k/v/out kernels within atol 1e-6 of JAX's; every other
    parameter untouched; a merged model as well as a merged state_dict."""
    _, params, tm = models
    tree = adapters["A"][2]
    want = jax.device_get(jax_merge(params, tree))
    got = merge_adapter(tm.state_dict(), tree)
    for b in tree:
        for proj in ("q", "k", "v", "out"):
            np.testing.assert_allclose(
                got[f"{b}.attn.{proj}.kernel"].numpy(),
                np.asarray(want[b]["attn"][proj]["kernel"]), atol=1e-6,
                rtol=0)
    base = tm.state_dict()
    assert torch.equal(got["embed"], base["embed"])
    assert torch.equal(got["block_0.mlp.wi.kernel"],
                       base["block_0.mlp.wi.kernel"])
    model = merge_adapter(tm, tree)
    assert torch.equal(model.state_dict()["block_1.attn.out.kernel"],
                       got["block_1.attn.out.kernel"])


def test_forward_with_mixed_bank_matches_jax(models):
    """The cacheless forward of three rows under bank rows 2, 0 and 1
    against JAX's ``apply`` with the ``lora`` collection (f32, atol
    1e-5); row 0 (base) equal to the forward without a bank, bitwise."""
    jm, params, tm = models
    rng = np.random.default_rng(3)
    bank_np = jax.tree.map(
        lambda x: rng.normal(0, 0.3, x.shape).astype(np.float32),
        jax.device_get(jax_init_bank(params, RANK, N_ADAPTERS)))
    for sub in bank_np.values():
        for leaf in sub["attn"].values():
            leaf[0] = 0.0
    aids = np.array([2, 0, 1], np.int32)
    toks = rng.integers(0, 64, (3, 9)).astype(np.int32)
    want = jm.apply({"params": params,
                     "lora": _lora_vars(jax.tree.map(jnp.asarray, bank_np),
                                        jnp.asarray(aids))},
                    jnp.asarray(toks))
    bank = jax.tree.map(torch.from_numpy, bank_np)
    with torch.no_grad():
        got = tm(torch.from_numpy(toks).long(),
                 lora=(bank, torch.from_numpy(aids).long()))
        plain = tm(torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    assert torch.equal(got[1], plain[1])
    assert not torch.allclose(got[0], plain[0])


def test_adapter_bank_state_matches_jax(models, adapters):
    """One acquire/release/evict/full script through the JAX bank and the
    port's: row ids, refcounts, resident sets, loads and evictions equal
    at every step, the full bank's error by the same message, and the
    uploaded rows equal to JAX's bitwise."""
    _, params, tm = models
    jbank = JaxBank(jax_init_bank(params, RANK, N_ADAPTERS),
                    jax_template(params, RANK))
    bank = AdapterBank(init_bank(tm, RANK, N_ADAPTERS),
                       adapter_template(tm, RANK))
    jp = {n: adapters[n][0] for n in "ABC"}
    tp = {n: adapters[n][1] for n in "ABC"}

    def state():
        return ({os.path.basename(k): v for k, v in jbank.resident().items()},
                {os.path.basename(k): v for k, v in bank.resident().items()})

    script = [("acq", None), ("acq", "A"), ("acq", "B"), ("acq", "A"),
              ("full", "C"), ("rel", "B"), ("acq", "C"), ("rel", "A"),
              ("rel", "A"), ("acq", "B"), ("rel", "C"), ("acq", "A"),
              ("rel", 0)]
    rows = {}
    for op, name in script:
        if op == "acq":
            a = jbank.acquire(None if name is None else jp[name])
            b = bank.acquire(None if name is None else tp[name])
            assert a == b, (op, name)
            rows[name] = a
        elif op == "rel":
            row = name if isinstance(name, int) else rows[name]
            jbank.release(row)
            bank.release(row)
        else:
            with pytest.raises(Exception) as je:
                jbank.acquire(jp[name])
            with pytest.raises(AdapterBankFullError) as te:
                bank.acquire(tp[name])
            assert str(te.value).replace(tp[name], "X") == \
                str(je.value).replace(jp[name], "X")
        js, ts = state()
        assert js == ts, (op, name)
        for n in "ABC":
            assert jbank.refcount(jp[n]) == bank.refcount(tp[n])
        assert (jbank.n_loads, jbank.n_evictions) == \
            (bank.n_loads, bank.n_evictions)
    assert bank.n_evictions >= 2
    jleaves = jax.device_get(jbank.bank)
    for b, sub in jleaves.items():
        for n, leaf in sub["attn"].items():
            np.testing.assert_array_equal(bank.bank[b]["attn"][n].numpy(),
                                          np.asarray(leaf))


def test_corrupt_adapter_fails_the_request(engines, adapters, tmp_path):
    """A truncated adapter file fails its request by name (the manifest
    check) without loading a row; the scheduler serves on."""
    _, eng = engines["dense"]
    src = adapters["A"][1]
    dst = str(tmp_path / "torn")
    shutil.copy(src, dst)
    shutil.copy(src + ".manifest.json", dst + ".manifest.json")
    with open(dst, "r+b") as f:
        f.truncate(os.path.getsize(dst) - 16)
    loads = eng.adapter_bank.n_loads
    sched = Scheduler(eng, harvest_lag=2, device="cpu")
    bad, good = sched.run([Request([3, 1], 4, adapter=dst),
                           Request([3, 1], 4)])
    bad, good = sorted((bad, good), key=lambda r: r.adapter is None)
    assert bad.error.startswith("failed:") and "corrupt" in bad.error
    assert good.error is None and len(good.tokens) == 4
    assert eng.adapter_bank.n_loads == loads
    assert dst not in eng.adapter_bank.resident()
    assert sched.metrics.summary()["requests_failed"] == 1


def test_full_bank_sheds_the_request(engines, monkeypatch):
    _, eng = engines["dense"]

    def full(path):
        raise AdapterBankFullError(path, N_ADAPTERS)
    monkeypatch.setattr(eng.adapter_bank, "acquire", full)
    sched = Scheduler(eng, harvest_lag=2, device="cpu")
    r = sched.run([Request([2, 8], 4, adapter="nope")])[0]
    assert r.error.startswith("shed:") and "adapter bank full" in r.error
    assert sched.metrics.summary()["requests_shed"] == 1


def _traffic(seed=3):
    """Three requests, adapters A, B and base, two slots (one reused);
    each prompt a short random phrase repeated, so the n-gram draft has
    something to propose."""
    rng = np.random.default_rng(seed)
    return [((rng.integers(0, 64, n).tolist() * 3)[:3 * n - 1], m, name)
            for n, m, name in ((4, 8, "A"), (3, 6, "B"), (5, 7, None))]


MODES = {"plain": ({}, 0), "chunked": ({"chunk_tokens": 4}, 0),
         "spec": ({}, 4)}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_mixed_batch_matches_jax_and_merged_oracle(models, engines, adapters,
                                                   kind, mode):
    """A, B and base requests batched: each token-identical to JAX's
    scheduler and to its merged-weights solo decode; tokens by adapter
    counted as JAX counts them."""
    _, _, tm = models
    jeng, eng = engines[kind]
    kw, spec = MODES[mode]
    traffic = _traffic()
    jreqs = [JaxRequest(list(p), m, speculate=spec,
                        adapter=None if a is None else adapters[a][0])
             for p, m, a in traffic]
    reqs = [Request(list(p), m, speculate=spec,
                    adapter=None if a is None else adapters[a][1])
            for p, m, a in traffic]
    jsched = JaxScheduler(jeng, harvest_lag=2, **kw)
    jsched.run(jreqs)
    sched = Scheduler(eng, harvest_lag=2, device="cpu", **kw)
    sched.run(reqs)
    for j, r, (p, m, a) in zip(jreqs, reqs, traffic):
        assert j.error is None and r.error is None, (j.error, r.error)
        assert r.tokens == j.tokens
        tree = None if a is None else adapters[a][2]
        assert r.tokens == merged_solo(tm, tree, p, m, **GEOMETRY[kind])
    s, js = sched.metrics.summary(), jsched.metrics.summary()
    assert {os.path.basename(k): v
            for k, v in s["tokens_by_adapter"].items()} == \
        {os.path.basename(k): v for k, v in js["tokens_by_adapter"].items()}
    if mode == "spec":
        assert s["spec_steps"] > 0
    if mode == "chunked":
        assert s["prefill_chunks"] == js["prefill_chunks"] > 0


def test_cross_adapter_shared_prefix_is_not_reused(models, engines,
                                                   adapters):
    """ROADMAP C5: request 1 (adapter A) then request 2 (adapter B) share
    their first two pages; request 3 (adapter A) shares them with request
    1.  Request 2 maps none of request 1's pages and equals its merged
    oracle and JAX with the prefix cache off; request 3 hits both pages
    and equals its merged oracle."""
    jm, params, tm = models
    _, eng = engines["paged"]
    rng = np.random.default_rng(11)
    shared = rng.integers(0, 64, 2 * PAGE).tolist()
    traffic = [(shared + rng.integers(0, 64, 5).tolist(), 6, name)
               for name in ("A", "B", "A")]
    sched = Scheduler(eng, harvest_lag=2, device="cpu")
    jeng = CopyingJaxEngine(jm, params, n_slots=2, buckets=BUCKETS,
                            paged_kernel=False, lora_rank=RANK,
                            lora_adapters=N_ADAPTERS, **GEOMETRY["paged"])
    jsched = JaxScheduler(jeng, harvest_lag=2, prefix_cache=False)
    hits = []
    for p, m, a in traffic:
        before = sched.metrics.summary()["prefix_hit_pages"]
        r = sched.run([Request(list(p), m, adapter=adapters[a][1])])[-1]
        j = jsched.run([JaxRequest(list(p), m, adapter=adapters[a][0])])[-1]
        hits.append(sched.metrics.summary()["prefix_hit_pages"] - before)
        assert r.error is None and j.error is None
        assert r.tokens == merged_solo(tm, adapters[a][2], p, m,
                                       **GEOMETRY["paged"])
        assert r.tokens == j.tokens
    assert hits == [0, 0, 2]


def test_base_page_hashes_are_unchanged():
    """A base request's chain hashes are JAX's; an adapter's chain starts
    from a stable digest of its name, so it shares no hash with the base
    chain or another adapter's."""
    toks = list(range(17))
    want = jax_hashes(toks, 4)
    assert page_chain_hashes(toks, 4) == want
    alloc = PageAllocator(8, 4)
    assert alloc.page_hashes(toks) == want == alloc.page_hashes(toks, None)
    a, b = alloc.page_hashes(toks, "a"), alloc.page_hashes(toks, "b")
    assert len(a) == len(want) and not set(a) & (set(want) | set(b))
    assert adapter_salt("a") == int.from_bytes(
        hashlib.blake2b(b"a", digest_size=8).digest(), "little")
    assert adapter_salt(None) is None


def test_int8_engine_with_lora_matches_jax(models, adapters):
    """Int8 weights and int8 KV on a paged LoRA engine: the mixed batch's
    greedy tokens equal JAX's int8 LoRA engine's."""
    jm, params, tm = models
    geo = dict(GEOMETRY["paged"], quantize_weights=True, kv_dtype="int8",
               lora_rank=RANK, lora_adapters=N_ADAPTERS)
    jeng = CopyingJaxEngine(jm, params, n_slots=2, buckets=BUCKETS,
                            paged_kernel=False, **geo)
    eng = InferenceEngine(tm, n_slots=2, buckets=BUCKETS, device="cpu",
                          **geo)
    traffic = _traffic(5)
    jreqs = JaxScheduler(jeng, harvest_lag=2).run(
        [JaxRequest(list(p), m, adapter=None if a is None
                    else adapters[a][0]) for p, m, a in traffic])
    reqs = Scheduler(eng, harvest_lag=2, device="cpu").run(
        [Request(list(p), m, adapter=None if a is None else adapters[a][1])
         for p, m, a in traffic])
    by = lambda rs: sorted(rs, key=lambda r: r.rid)   # noqa: E731
    for j, r in zip(by(jreqs), by(reqs)):
        assert j.error is None and r.error is None
        assert r.tokens == j.tokens
    assert eng.compile_stats()["lora"] == {
        "rank": RANK, "n_adapters": N_ADAPTERS,
        "bank_bytes": jeng.compile_stats()["lora"]["bank_bytes"]}


def test_engine_lora_arguments_refuse_like_jax(models):
    _, _, tm = models
    for kw, msg in (({"lora_rank": -1, "lora_adapters": 2}, ">= 0"),
                    ({"lora_rank": 2}, "together"),
                    ({"lora_rank": 2, "lora_adapters": 1}, ">= 2")):
        with pytest.raises(ValueError, match=msg):
            InferenceEngine(tm, n_slots=2, device="cpu", **kw)
    plain = InferenceEngine(tm, n_slots=2, buckets=BUCKETS, page_size=0,
                            device="cpu")
    with pytest.raises(ValueError, match="adapter bank"):
        plain.decode(plain.init_arena(), plain.init_last_tokens(),
                     [True, True], [0.0, 0.0], [0, 0], [1.0, 1.0],
                     adapter_ids=[0, 1])
    r = Scheduler(plain, device="cpu").submit(Request([1, 2], 4,
                                                      adapter="x"))
    assert r.error.startswith("rejected:") and "adapter bank" in r.error


def test_jax_paged_cache_maps_pages_across_adapters_c5(models, engines,
                                                       adapters):
    """ROADMAP C5, the reference's fault this port does not copy: request
    1 (adapter A) then request 2 (adapter B) share two prompt pages; the
    JAX paged scheduler with its prefix cache on serves request 2 on the
    pages request 1 computed under A's k/v deltas, so its tokens leave
    the merged-weights oracle that JAX's own docstring and tests state.
    The port, keyed by adapter, serves the oracle's."""
    jm, params, tm = models
    _, eng = engines["paged"]
    rng = np.random.default_rng(11)
    shared = rng.integers(0, 64, 2 * PAGE).tolist()
    p_a, p_b = (shared + rng.integers(0, 64, 5).tolist() for _ in "AB")
    jeng = CopyingJaxEngine(jm, params, n_slots=2, buckets=BUCKETS,
                            paged_kernel=False, lora_rank=RANK,
                            lora_adapters=N_ADAPTERS, **GEOMETRY["paged"])
    jsched = JaxScheduler(jeng, harvest_lag=2)
    sched = Scheduler(eng, harvest_lag=2, device="cpu")
    for p, name in ((p_a, "A"), (p_b, "B")):
        j = jsched.run([JaxRequest(list(p), 6,
                                   adapter=adapters[name][0])])[-1]
        r = sched.run([Request(list(p), 6, adapter=adapters[name][1])])[-1]
    want = merged_solo(tm, adapters["B"][2], p_b, 6, **GEOMETRY["paged"])
    assert jsched.metrics.summary()["prefill_tokens_saved"] == 2 * PAGE
    assert r.tokens == want
    assert j.tokens != want, (j.tokens, want)
