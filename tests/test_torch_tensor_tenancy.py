"""Tensor-parallel tenancy and KV handoff in the port against the JAX
package: ``InferenceEngine(mesh=, lora_rank=, lora_adapters=)`` and the
whole-heads page payloads of a TP engine.

A gloo world of 4 processes on a ``{data 2, model 2}`` mesh runs one TP
engine and its Schedulers per rank (this file is the worker as
``__main__``, tests/_torch_world.py the harness) while the pytest process
runs the JAX single-placement engine through ``CopyingJaxEngine``
(tests/test_torch_chunked.py, ROADMAP C1) on the same bridged weights:
the JAX serving tests' config (vocab 64, d_model 32, 2 layers, 2 heads,
max_seq 48, f32), page 8, LoRA rank 2 with 4 bank rows, three adapters
drawn from one numpy seed and saved through each package's own
``save_weights``.

* LoRA: greedy tokens over mixed adapters (and the base) equal the JAX
  single-placement LoRA engine's with ``prefix_cache=False`` (ROADMAP
  C5); adapter traffic with shared prefixes (cache on) equals the
  merged-weights oracle (``merge_adapter``, each request alone on a port
  engine) and hits its own adapter's pages only.  Every rank returns the
  same tokens.
* The bank: each rank holds JAX's ``bank_pspecs`` cut of it
  (``placement``/``block_of``); assembled from the ranks it is the whole
  bank of the resident adapters, bitwise.
* The forward of mixed adapter rows on the TP model against JAX's
  ``apply`` with the ``lora`` collection: atol 1e-5 (f32; the
  out-projection's delta is summed over a rank's heads before the psum
  over ranks, where JAX sums over every head first), the gap recorded.
* The handoff: a TP engine's ``extract_pages`` is the whole-heads tree,
  bitwise the same on every rank; the rank's cut of it is bitwise the
  rank's pool pages; it equals the port's single-placement engine's
  payload and the JAX engine's payload for the same prompt within the
  atol 1e-5 of tests/test_torch_kv_tiers.py (a rank's column-sliced K/V
  projections, and torch's GEMMs against XLA's, round apart: 1.5e-6 at
  most here; the logits 2.6e-7).  Scheduler-level ``prefill_only`` ->
  ``kv_inject`` over TP Schedulers in lockstep, a JAX payload injected
  into TP decode Schedulers, and a TP payload injected into a JAX engine
  all give JAX's undisaggregated greedy tokens.
* The spill tiers: a TP world whose ranks share one ``spill_dir`` warms a
  prefix, evicts it and restores it from the host tier and from the disk
  tier, token-identical to JAX's spill runs with JAX's counters; the four
  ranks write four different spill files.

Tolerance: tokens and counters exact; logits atol 1e-5; payloads bitwise
across the ranks and against the rank's pool, atol 1e-5 against the
single engine and JAX.
"""

import os
import sys
import time

from _torch_world import World, serve

AXES = ("data", "model")
MESH = (2, 2)
CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, d_ff=64,
           max_seq=48)
BUCKETS = (8, 16, 32, 48)
PAGE = 8
RANK = 2
N_ADAPTERS = 4          # row 0 = base, 3 loadable rows
N_NEW = 6
SYS = list(range(1, 10))          # 9 tokens: one full registered page


def _model(case):
    import torch

    from dtdl_tpu_torch.bridge import load_flax_params
    from dtdl_tpu_torch.models.transformer import transformer_lm

    model = transformer_lm("tiny", device="cpu", seed=None,
                           dtype=torch.float32, attn_impl="dense", **CFG)
    load_flax_params(model, case["params"], device="cpu")
    return model


def _numpy_tree(tree):
    return {k: _numpy_tree(v) if isinstance(v, dict) else v.numpy().copy()
            for k, v in tree.items()}


def run_lora(mesh, case):
    """Mixed-adapter traffic (cache off), the shared-prefix traffic (cache
    on), the rank's bank and specs, and a mixed-row forward."""
    import torch

    from dtdl_tpu_torch.serve import InferenceEngine, Request, Scheduler

    model = _model(case)
    eng = InferenceEngine(model, mesh=mesh, rules="tp", n_slots=2,
                          buckets=BUCKETS, page_size=PAGE, device="cpu",
                          lora_rank=RANK, lora_adapters=N_ADAPTERS)
    paths = case["adapters"]
    reqs = [Request(list(p), m, adapter=None if a is None else paths[a])
            for p, m, a in case["traffic"]]
    Scheduler(eng, harvest_lag=2, prefix_cache=False, device="cpu").run(reqs)
    sched = Scheduler(eng, harvest_lag=2, device="cpu")
    shared, hits = [], []
    for p, m, a in case["shared"]:
        before = sched.metrics.summary()["prefix_hit_pages"]
        r = sched.run([Request(list(p), m, adapter=paths[a])])[-1]
        hits.append(sched.metrics.summary()["prefix_hit_pages"] - before)
        shared.append((r.tokens, r.error))
    rows = {os.path.basename(k): v
            for k, v in eng.adapter_bank.resident().items()}
    aids = torch.tensor([rows["A"], 0, rows["C"]])
    toks = torch.from_numpy(case["forward_tokens"]).long()
    with torch.no_grad():
        logits = eng.model(toks, lora=(eng.adapter_bank.bank, aids))
    return {"tokens": [r.tokens for r in reqs],
            "errors": [r.error for r in reqs],
            "shared": shared, "hits": hits, "rows": rows,
            "aids": aids.numpy(), "logits": logits.numpy(),
            "bank": _numpy_tree(eng.adapter_bank.bank),
            "specs": {b: {k: tuple(v) for k, v in sub["attn"].items()}
                      for b, sub in eng.adapter_bank.specs.items()},
            "lora_stats": eng.compile_stats()["lora"]}


def run_handoff(mesh, case):
    """Payloads of the TP engine (engine level, against the rank's pool
    pages and the single engine's), the TP prefill -> decode Schedulers,
    JAX payloads into the TP decode Scheduler, and TP payloads out."""
    import numpy as np

    from dtdl_tpu_torch.serve import InferenceEngine, Request, Scheduler
    from dtdl_tpu_torch.serve.sampling import SampleParams

    model = _model(case)
    kw = dict(n_slots=2, buckets=BUCKETS, page_size=PAGE, device="cpu")
    tp = InferenceEngine(model, mesh=mesh, rules="tp", **kw)
    single = InferenceEngine(model, **kw)
    prompt = case["prompts"][0]
    n_pg = -(-len(prompt) // PAGE)
    got = {}
    for name, eng in (("tp", tp), ("single", single)):
        arena, last = eng.init_arena(), eng.init_last_tokens()
        row = np.zeros(eng.n_ptab, np.int32)
        row[:n_pg] = np.arange(1, n_pg + 1)
        arena, last, _ = eng.prefill(arena, last, 0, prompt, SampleParams(),
                                     page_row=row)
        got[name] = eng.extract_pages(arena, list(range(1, n_pg + 1)))
        if name == "tp":
            pools = {"/".join(p): eng._bits_view(t)[1:n_pg + 1].numpy().copy()
                     for p, t in eng._pool_leaves(arena)}
    outs, payloads = [], []
    for p in case["prompts"]:
        pre = Request(list(p), N_NEW, prefill_only=True)
        Scheduler(tp, harvest_lag=2, device="cpu").run([pre])
        dec = Request(list(p), N_NEW, kv_inject=pre.kv_handoff)
        dec.tokens = [pre.kv_handoff["first_token"]]
        Scheduler(tp, harvest_lag=2, device="cpu").run([dec])
        outs.append((dec.tokens, dec.error))
        payloads.append(pre.kv_handoff)
    adopted = []
    for p, handoff in zip(case["prompts"], case["jax_handoffs"]):
        dec = Request(list(p), N_NEW, kv_inject=handoff)
        dec.tokens = [handoff["first_token"]]
        Scheduler(tp, harvest_lag=2, device="cpu").run([dec])
        adopted.append((dec.tokens, dec.error))
    return {"tp_payload": got["tp"], "single_payload": got["single"],
            "pools": pools, "disagg": outs, "payloads": payloads,
            "adopted": adopted}


def run_spill(mesh, case):
    """Warm, evict by churn, restore: the host tier, then the disk tier
    with every rank on one ``spill_dir``."""
    from dtdl_tpu_torch.serve import InferenceEngine, Request, Scheduler

    model = _model(case)
    eng = InferenceEngine(model, mesh=mesh, rules="tp", n_slots=2,
                          buckets=BUCKETS, page_size=PAGE, n_pages=6,
                          device="cpu")
    out = {}
    for tier, kw in (("host", dict(spill_host_bytes=1 << 20)),
                     ("disk", dict(spill_host_bytes=1,
                                   spill_disk_bytes=1 << 20,
                                   spill_dir=case["spill_dir"]))):
        s = Scheduler(eng, harvest_lag=2, device="cpu", **kw)
        s.run([Request(SYS + [20, 21], 4)])
        for t in (40, 45, 50, 55, 60):
            s.run([Request([t] * 9 + [t + 1], 3)])
        hot = s.run([Request(SYS + [22, 23], 5)])[-1]
        out[tier] = {"tokens": hot.tokens, "error": hot.error,
                     "metrics": s.metrics.summary(),
                     "path": s.spill.disk.path if s.spill.disk else None}
    return out


def run_case(mesh, name, case):
    return {"lora": run_lora, "handoff": run_handoff,
            "spill": run_spill}[name](mesh, case)


def _main() -> None:
    """The rank's cases, then an exit without the gloo teardown (its
    sockets closing while a peer's gloo threads still read them aborted
    a rank at interpreter exit, about one world in ten under load, every
    result already on disk).  The ranks meet on the rendezvous store,
    which no gloo socket serves: all arrive, the others leave, and
    process 0, which hosts the store, leaves last."""
    import torch.distributed as dist
    code = serve(run_case, AXES)
    store = dist.distributed_c10d._get_default_store()
    n, me = dist.get_world_size(), dist.get_rank()
    store.add("arrived", 1)
    while int(store.add("arrived", 0)) < n:
        time.sleep(0.01)
    if me:
        store.add("left", 1)
    else:
        while int(store.add("left", 0)) < n - 1:
            time.sleep(0.01)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


if __name__ == "__main__":
    _main()

# ---- the pytest side (the JAX oracle) ---------------------------------------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from dtdl_tpu.ckpt.checkpoint import save_weights as jax_save_weights  # noqa
from dtdl_tpu.serve import Request as JaxRequest  # noqa: E402
from dtdl_tpu.serve import Scheduler as JaxScheduler  # noqa: E402
from dtdl_tpu.serve.engine import _lora_vars  # noqa: E402
from dtdl_tpu.serve.tenant import init_bank as jax_init_bank  # noqa: E402
from dtdl_tpu.serve.tenant.lora import bank_pspecs as jax_pspecs  # noqa
from dtdl_tpu_torch import bridge  # noqa: E402
from dtdl_tpu_torch.ckpt.checkpoint import save_weights  # noqa: E402
from dtdl_tpu_torch.serve import (InferenceEngine, Request,  # noqa: E402
                                  Scheduler, adapter_template,
                                  merge_adapter)
from _torch_world import assemble  # noqa: E402
from test_torch_chunked import CopyingJaxEngine, jax_pair  # noqa: E402

torch.set_num_threads(1)

LOGIT_ATOL = 1e-5
PAYLOAD_ATOL = 1e-5
SPILL_COUNTERS = ("pages_spilled", "pages_restored", "spill_host_hits",
                  "spill_disk_hits", "spill_quarantined", "spill_bytes",
                  "restore_bytes", "prefill_tokens_saved",
                  "decode_tokens", "requests_finished")


def _traffic(seed=3):
    """Four requests, adapters A, B, base and C over two slots; each
    prompt a short random phrase repeated."""
    rng = np.random.default_rng(seed)
    return [((rng.integers(0, 64, n).tolist() * 3)[:3 * n - 1], m, name)
            for n, m, name in ((4, 8, "A"), (3, 6, "B"), (5, 7, None),
                               (6, 5, "C"))]


def _shared(seed=11):
    """Requests of adapters A, B, A whose prompts share two pages."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, 64, 2 * PAGE).tolist()
    return [(shared + rng.integers(0, 64, 5).tolist(), 6, name)
            for name in ("A", "B", "A")]


PROMPTS = [list(range(3, 18)), [5, 9, 2] * 4, list(range(40, 56))]
FORWARD = np.random.default_rng(5).integers(0, 64, (3, 9)).astype(np.int32)


@pytest.fixture(scope="module")
def models():
    return jax_pair(**CFG)


@pytest.fixture(scope="module")
def adapters(models, tmp_path_factory):
    """name -> (JAX file, port file, host tree) for A, B, C."""
    tm = models[2]
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


def _jax_engine(models, **kw):
    jm, params, _ = models
    return CopyingJaxEngine(jm, params, n_slots=2, buckets=BUCKETS,
                            page_size=PAGE, paged_kernel=False, **kw)


def _jax_handoff(jeng, prompt):
    req = JaxRequest(list(prompt), N_NEW, prefill_only=True)
    JaxScheduler(jeng, harvest_lag=2).run([req])
    assert req.error is None and req.kv_handoff is not None
    return req.kv_handoff


@pytest.fixture(scope="module")
def jax_plain(models):
    """The JAX single engine without adapters: its prefill_only payloads
    and its undisaggregated greedy tokens of PROMPTS."""
    jeng = _jax_engine(models)
    handoffs = [_jax_handoff(jeng, p) for p in PROMPTS]
    want = []
    for p in PROMPTS:
        ref = JaxRequest(list(p), N_NEW)
        JaxScheduler(jeng, harvest_lag=2).run([ref])
        want.append(ref.tokens)
    return jeng, handoffs, want


@pytest.fixture(scope="module")
def world(models, adapters, jax_plain, tmp_path_factory):
    params = jax.device_get(models[1])
    port = {n: adapters[n][1] for n in adapters}
    handoffs = [dict(h, data=bridge.jax_pages_to_torch(
        jax.device_get(h["data"]))) for h in jax_plain[1]]
    spill_dir = str(tmp_path_factory.mktemp("tp_spill"))
    cases = {
        "lora": dict(params=params, adapters=port, traffic=_traffic(),
                     shared=_shared(), forward_tokens=FORWARD),
        "handoff": dict(params=params, prompts=PROMPTS,
                        jax_handoffs=handoffs),
        "spill": dict(params=params, spill_dir=spill_dir),
    }
    w = World(__file__, MESH, cases, tmp_path_factory.mktemp("tptenancy"))
    w.spill_dir = spill_dir
    return w


def _cases(world, name):
    return [o["cases"][name] for o in world.results()]


def test_tp_lora_tokens_equal_jax_single_engine(world, models, adapters):
    """Mixed adapters on the TP engine, cache off: the JAX single LoRA
    engine's greedy tokens (cache off, ROADMAP C5), on every rank."""
    jeng = _jax_engine(models, lora_rank=RANK, lora_adapters=N_ADAPTERS)
    traffic = _traffic()
    jreqs = [JaxRequest(list(p), m, adapter=None if a is None
                        else adapters[a][0]) for p, m, a in traffic]
    JaxScheduler(jeng, harvest_lag=2, prefix_cache=False).run(jreqs)
    want = [r.tokens for r in jreqs]
    assert all(r.error is None for r in jreqs)
    for out in _cases(world, "lora"):
        assert out["errors"] == [None] * len(traffic)
        assert out["tokens"] == want
        assert out["lora_stats"] == jeng.compile_stats()["lora"]


def test_tp_lora_shared_prefixes_equal_merged_oracle(world, models,
                                                     adapters):
    """A, B, A sharing two prompt pages, cache on: each request equals its
    merged-weights solo run; B maps none of A's pages, the second A both."""
    tm = models[2]
    want = []
    for p, m, a in _shared():
        eng = InferenceEngine(merge_adapter(tm, adapters[a][2]), n_slots=1,
                              buckets=BUCKETS, page_size=PAGE, device="cpu")
        want.append(Scheduler(eng, device="cpu").run(
            [Request(list(p), m)])[0].tokens)
    for out in _cases(world, "lora"):
        assert [t for t, _ in out["shared"]] == want
        assert [e for _, e in out["shared"]] == [None] * 3
        assert out["hits"] == [0, 0, 2]


def test_each_rank_holds_the_bank_pspecs_cut(world, models, adapters):
    """Every rank's leaves are JAX's ``bank_pspecs`` blocks of the whole
    bank: the specs equal JAX's, the head leaves hold H/2 heads, and the
    blocks assemble into the resident adapters' rows bitwise."""
    jspecs = jax_pspecs(jax_init_bank(models[1], RANK, N_ADAPTERS))
    outs = _cases(world, "lora")
    rows = outs[0]["rows"]
    assert all(o["rows"] == rows for o in outs)
    assert sorted(rows) == ["A", "B", "C"]
    for b, sub in jspecs.items():
        for leaf, spec in sub["attn"].items():
            for o in outs:
                assert o["specs"][b][leaf] == tuple(spec), (b, leaf)
            shape = (N_ADAPTERS,) + adapters["A"][2][b]["attn"][leaf].shape
            whole = np.zeros(shape, np.float32)
            for name, row in rows.items():
                whole[row] = adapters[name][2][b]["attn"][leaf]
            got = assemble(
                world.results(),
                lambda o: o["cases"]["lora"]["bank"][b]["attn"][leaf],
                outs[0]["specs"][b][leaf], shape)
            np.testing.assert_array_equal(got, whole)
            local = outs[0]["bank"][b]["attn"][leaf]
            if leaf in ("q_b", "k_b", "v_b"):
                assert local.shape[2] == CFG["n_heads"] // 2
            elif leaf == "out_a":
                assert local.shape[1] == CFG["n_heads"] // 2
            else:
                assert local.shape == shape


def test_tp_lora_forward_matches_jax_apply(world, models, adapters):
    """Rows under adapters A, base and C through the TP model's forward
    against JAX's ``apply`` with the ``lora`` collection: atol 1e-5; the
    base row is the model's plain logits."""
    jm, params, tm = models
    out = _cases(world, "lora")[0]
    bank = jax.device_get(jax_init_bank(params, RANK, N_ADAPTERS))
    for name, row in out["rows"].items():
        for b, sub in adapters[name][2].items():
            for leaf, a in sub["attn"].items():
                bank[b]["attn"][leaf] = np.array(bank[b]["attn"][leaf])
                bank[b]["attn"][leaf][row] = a
    want = np.asarray(jm.apply(
        {"params": params,
         "lora": _lora_vars(jax.tree.map(jnp.asarray, bank),
                            jnp.asarray(out["aids"], jnp.int32))},
        jnp.asarray(FORWARD)))
    gap = float(np.abs(out["logits"] - want).max())
    assert gap <= LOGIT_ATOL, gap
    with torch.no_grad():
        plain = tm(torch.from_numpy(FORWARD).long()).numpy()
    np.testing.assert_allclose(out["logits"][1], plain[1], atol=LOGIT_ATOL,
                               rtol=0)
    for o in _cases(world, "lora")[1:]:
        np.testing.assert_array_equal(o["logits"], out["logits"])


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_tp_extract_is_the_whole_heads_tree(world, jax_plain):
    """The TP payload holds every head on every rank (the same tree
    bitwise), the rank's cut of it is bitwise its pool pages, and it is
    the single engine's payload and the JAX payload of the same prompt
    within atol 1e-5 (the heads' column-sliced K/V projections round
    apart from the whole ones)."""
    outs = _cases(world, "handoff")
    first = _flat(outs[0]["tp_payload"])
    jdata = _flat(jax.device_get(jax_plain[1][0]["data"]))
    assert first.keys() == jdata.keys()
    for out in outs:
        tp = _flat(out["tp_payload"])
        single = _flat(out["single_payload"])
        for path, leaf in tp.items():
            assert leaf.shape[1] == CFG["n_heads"], path
            np.testing.assert_array_equal(leaf, first[path])
            for other in (single[path], jdata[path]):
                gap = float(np.abs(leaf - other).max())
                assert gap <= PAYLOAD_ATOL, (path, gap)
    for o in world.results():
        c = o["coords"]["model"]
        out = o["cases"]["handoff"]
        for path, leaf in _flat(out["tp_payload"]).items():
            np.testing.assert_array_equal(leaf[:, c:c + 1],
                                          out["pools"][path])


def test_tp_disaggregation_and_jax_payloads_decode(world, jax_plain):
    """TP prefill_only -> TP kv_inject Schedulers, and JAX payloads into
    the TP decode Scheduler: JAX's undisaggregated tokens on every rank."""
    want = jax_plain[2]
    for out in _cases(world, "handoff"):
        assert [e for _, e in out["disagg"]] == [None] * len(PROMPTS)
        assert [t for t, _ in out["disagg"]] == want
        assert [e for _, e in out["adopted"]] == [None] * len(PROMPTS)
        assert [t for t, _ in out["adopted"]] == want


def test_tp_payloads_decode_on_a_jax_engine(world, jax_plain):
    jeng, handoffs, want = jax_plain
    out = _cases(world, "handoff")[0]
    for p, th, jh, w in zip(PROMPTS, out["payloads"], handoffs, want):
        req = JaxRequest(list(p), N_NEW, kv_inject=dict(
            th, data=bridge.torch_pages_to_jax(
                th["data"], jax.device_get(jh["data"]))))
        req.tokens = [th["first_token"]]
        JaxScheduler(jeng, harvest_lag=2).run([req])
        assert req.error is None and req.tokens == w


def _jax_spill(models, tier, tmp_path):
    jeng = _jax_engine(models, n_pages=6)
    kw = (dict(spill_host_bytes=1 << 20) if tier == "host" else
          dict(spill_host_bytes=1, spill_disk_bytes=1 << 20,
               spill_dir=str(tmp_path)))
    s = JaxScheduler(jeng, harvest_lag=2, **kw)
    s.run([JaxRequest(SYS + [20, 21], 4)])
    for t in (40, 45, 50, 55, 60):
        s.run([JaxRequest([t] * 9 + [t + 1], 3)])
    hot = s.run([JaxRequest(SYS + [22, 23], 5)])[-1]
    return hot.tokens, s.metrics.summary()


@pytest.mark.parametrize("tier", ["host", "disk"])
def test_tp_spill_restores_like_jax(world, models, tier, tmp_path):
    """The prefix evicted by churn comes back from the tier, with JAX's
    tokens and spill counters, on every rank."""
    tokens, jm = _jax_spill(models, tier, tmp_path)
    for out in (o[tier] for o in _cases(world, "spill")):
        assert out["error"] is None
        assert out["tokens"] == tokens
        m = out["metrics"]
        assert m["pages_restored"] >= 1
        assert m[f"spill_{tier}_hits"] >= 1
        for key in SPILL_COUNTERS:
            assert m[key] == jm[key], key


def test_no_two_ranks_share_a_spill_file(world):
    paths = [o["disk"]["path"] for o in _cases(world, "spill")]
    assert len(set(paths)) == 4
    assert {os.path.dirname(p) for p in paths} == {world.spill_dir}
    assert sorted(os.path.basename(p) for p in paths) == [
        f"kv_spill.rank{r}.bin" for r in range(4)]
    assert all(os.path.getsize(p) > 0 for p in paths)
