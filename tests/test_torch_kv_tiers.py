"""The port's KV handoff and spill tiers against the JAX package's.

* The stores (``HostPageStore``, ``DiskPageStore``) are framework-free host
  classes: the same seeded put/get sequences go through the JAX stores and
  the port's, and every ``holds``, payload, counter, manifest entry and
  quarantine must be equal.
* ``extract_pages`` of a prefilled prompt (a ``prefill_only`` request's
  ``kv_handoff``) equals the JAX engine's through the bridge's converter
  (f32, atol 1e-5), and a payload exported by either package, adopted by
  the other's engine (``kv_inject``), decodes the exporter's single
  scheduler's greedy tokens.
* Restore from the spill tiers (plain, speculative, chunked, the disk
  tier) is token-identical to the port's HBM prefix-hit run, and its
  tokens and spill counters equal the JAX scheduler's on the same traffic
  through ``CopyingJaxEngine`` (ROADMAP C1).  A corrupt disk record is
  quarantined and the prefix recomputed.

The JAX serving tests' config (vocab 64, d_model 32, 2 layers, 2 heads,
f32, bridged weights), max_seq 48, page 8, a pool of 5 usable pages so
that traffic evicts.  Tolerance: tokens and counters exact; payloads
within atol 1e-5.
"""

import json
import mmap

import jax
import numpy as np
import pytest
import torch

from dtdl_tpu.serve import DiskPageStore as JaxDisk
from dtdl_tpu.serve import HostPageStore as JaxHost
from dtdl_tpu.serve import NGramDraft as JaxNGramDraft
from dtdl_tpu.serve import Request as JaxRequest
from dtdl_tpu.serve import Scheduler as JaxScheduler
from dtdl_tpu_torch import bridge
from dtdl_tpu_torch.serve import (DiskPageStore, HostPageStore,
                                  InferenceEngine, NGramDraft, PageAllocator,
                                  Request, Scheduler, SpillCorruptEntryError,
                                  page_chain_hashes)
from dtdl_tpu_torch.serve.metrics import ServeMetrics
from test_torch_chunked import CopyingJaxEngine, jax_pair

# small shapes: one intra-op thread each leaves the cores to the other
# test workers
torch.set_num_threads(1)

MAX_SEQ = 48
BUCKETS = (8, 16)
PAGE = 8
CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, d_ff=64,
           max_seq=MAX_SEQ)
SYS = list(range(1, 10))          # 9 tokens: one full registered page
ATOL = 1e-5


def payload(seed, shape=(1, 2, 3), scale=True):
    rng = np.random.default_rng(seed)
    out = {"k": {"w": rng.standard_normal(shape).astype(np.float32)},
           "v": {"w": rng.standard_normal(shape).astype(np.float32)}}
    if scale:
        out["k"]["s"] = rng.standard_normal((1, 3)).astype(np.float32)
        out["v"]["s"] = rng.standard_normal((1, 3)).astype(np.float32)
    return out


def flat(tree):
    return bridge.flatten(tree) if tree is not None else None


def same(a, b):
    if a is None or b is None:
        return a is None and b is None
    fa, fb = flat(a), flat(b)
    return fa.keys() == fb.keys() and all(
        np.array_equal(np.asarray(fa[k]), np.asarray(fb[k])) for k in fa)


# ---------------------------------------------------------------------------
# the stores against JAX's
# ---------------------------------------------------------------------------

STORE_COUNTERS = ("spilled_pages", "spilled_bytes", "host_hits",
                  "disk_hits", "demotions", "drops", "bytes_used")
DISK_COUNTERS = ("puts", "hits", "corrupt_entries", "drops", "bytes_used",
                 "record_bytes", "_n_slots")


def _manifest(disk):
    with open(disk.manifest_path) as f:
        return json.load(f)


@pytest.mark.parametrize("disk_budget", [None, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_stores_match_jax_under_the_same_sequence(tmp_path, seed,
                                                  disk_budget):
    """LRU within the host budget, demotion to disk, promotion back, the
    disk's LRU and slot reuse, drop receipts: a seeded put/get sequence
    through both packages' stores gives equal answers, counters and
    manifests."""
    nbytes = sum(a.nbytes for a in flat(payload(0)).values())
    stores, drops = [], []
    for k, (Host, Disk) in enumerate(((JaxHost, JaxDisk),
                                      (HostPageStore, DiskPageStore))):
        d = tmp_path / str(k)
        got = []
        drops.append(got)
        disk = Disk(str(d), None if disk_budget is None
                    else disk_budget * nbytes)
        stores.append(Host(2 * nbytes, disk=disk, on_drop=got.append))
    rng = np.random.default_rng(seed)
    for _ in range(80):
        h = int(rng.integers(0, 9))
        if rng.random() < 0.5:
            for st in stores:
                st.put(h, payload(h))
        else:
            a, b = (st.get(h) for st in stores)
            assert same(a, b) and (a is None or same(a, payload(h)))
        assert stores[0].holds(h) == stores[1].holds(h)
        assert len(stores[0]) == len(stores[1])
    jax_s, port = stores
    for name in STORE_COUNTERS:
        assert getattr(port, name) == getattr(jax_s, name), name
    for name in DISK_COUNTERS:
        assert getattr(port.disk, name) == getattr(jax_s.disk, name), name
    assert drops[0] == drops[1]
    assert _manifest(port.disk) == _manifest(jax_s.disk)


@pytest.mark.parametrize("Disk", [JaxDisk, DiskPageStore],
                         ids=["jax", "port"])
def test_corrupt_disk_record_is_quarantined_by_name(tmp_path, Disk):
    """A flipped byte: the read misses (never a crash or wrong bytes), the
    error is named in ``quarantine_log``, the slot is never reused; both
    packages' stores alike (same slot, same message shape)."""
    disk = Disk(str(tmp_path))
    assert disk.put(7, payload(7)) and disk.put(8, payload(8))
    assert not disk.put(9, payload(9, shape=(2, 2, 3)))   # pinned geometry
    slot7 = disk._slots[7]
    with open(disk.path, "r+b") as f:
        off = slot7 * disk.record_bytes + 5
        f.seek(off)
        byte = f.read(1)
        f.seek(off)
        f.write(bytes([byte[0] ^ 0xFF]))
    disk._mm.close()
    disk._mm = mmap.mmap(disk._fh.fileno(),
                         disk._n_slots * disk.record_bytes)
    assert disk.get(7) is None and 7 not in disk
    err = disk.quarantine_log[-1]
    assert type(err).__name__ == "SpillCorruptEntryError"
    assert "sha256 mismatch" in str(err) and disk.path in str(err)
    assert err.slot == slot7 and disk.corrupt_entries == 1
    assert disk.put(9, payload(9)) and disk._slots[9] != slot7
    assert same(disk.get(8), payload(8)) and same(disk.get(9), payload(9))
    if Disk is DiskPageStore:
        assert isinstance(err, SpillCorruptEntryError)


def test_chain_hashes_match_the_allocator():
    toks = list(range(32))
    assert page_chain_hashes(toks, 4) == PageAllocator(8, 4).page_hashes(toks)
    from dtdl_tpu.serve import page_chain_hashes as jax_hashes
    assert page_chain_hashes(toks, 4) == jax_hashes(toks, 4)


# ---------------------------------------------------------------------------
# engines: the handoff against JAX's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    return jax_pair(**CFG)


def _engines(models, n_pages):
    jm, params, tm = models
    return (CopyingJaxEngine(jm, params, n_slots=2, buckets=BUCKETS,
                             page_size=PAGE, n_pages=n_pages,
                             paged_kernel=False),
            InferenceEngine(tm, n_slots=2, buckets=BUCKETS, page_size=PAGE,
                            n_pages=n_pages, device="cpu"))


@pytest.fixture(scope="module")
def tight(models):
    """(JAX engine, port engine) with 5 usable pages: traffic evicts."""
    return _engines(models, 6)


@pytest.fixture(scope="module")
def roomy(models):
    return _engines(models, 3 * (MAX_SEQ // PAGE) + 1)


def _sched(eng, jax_side, **kw):
    if jax_side:
        if "draft" in kw:
            kw["draft"] = JaxNGramDraft()
        return JaxScheduler(eng, harvest_lag=2, **kw)
    return Scheduler(eng, harvest_lag=2, device="cpu", **kw)


def _handoff(eng, jax_side, prompt, n_new=6):
    R = JaxRequest if jax_side else Request
    req = R(list(prompt), n_new, prefill_only=True)
    _sched(eng, jax_side).run([req])
    assert req.done and req.error is None and req.kv_handoff is not None
    return req


PROMPTS = [list(range(3, 18)), [5, 9, 2] * 4, list(range(40, 56))]


@pytest.mark.parametrize("prompt", PROMPTS, ids=["15", "12", "16"])
def test_extract_pages_matches_jax(roomy, prompt):
    """A prefill_only request's payload: the same pages, first token and
    page count as the JAX scheduler's, every leaf within atol 1e-5
    through the bridge's converter in either direction."""
    jeng, teng = roomy
    jr, tr = _handoff(jeng, True, prompt), _handoff(teng, False, prompt)
    jh, th = jr.kv_handoff, tr.kv_handoff
    assert (th["first_token"], th["n_pages"], th["prompt"]) == \
        (jh["first_token"], jh["n_pages"], jh["prompt"])
    jdata = jax.device_get(jh["data"])
    conv = bridge.jax_pages_to_torch(jdata)
    ft, fj = flat(th["data"]), flat(conv)
    assert ft.keys() == fj.keys()
    assert all(ft[k].shape == fj[k].shape and ft[k].dtype == fj[k].dtype
               for k in ft)
    for k in ft:
        np.testing.assert_allclose(ft[k], fj[k], atol=ATOL, rtol=0)
    back = bridge.torch_pages_to_jax(th["data"], jdata)
    for k, v in flat(back).items():
        assert v.dtype == flat(jdata)[k].dtype
        np.testing.assert_allclose(v, flat(jdata)[k], atol=ATOL, rtol=0)


def test_payloads_cross_packages_and_decode(roomy):
    """A JAX-exported payload adopted by the port's engine (kv_inject)
    decodes the JAX single scheduler's greedy tokens, and a port-exported
    one adopted by the JAX engine decodes the port's."""
    jeng, teng = roomy
    for prompt in PROMPTS:
        ref = JaxRequest(list(prompt), 6)
        _sched(jeng, True).run([ref])
        mine = Request(list(prompt), 6)
        _sched(teng, False).run([mine])
        assert mine.tokens == ref.tokens
        jh = _handoff(jeng, True, prompt).kv_handoff
        th = _handoff(teng, False, prompt).kv_handoff
        port_side = Request(list(prompt), 6, kv_inject=dict(
            jh, data=bridge.jax_pages_to_torch(jax.device_get(jh["data"]))))
        port_side.tokens = [jh["first_token"]]
        _sched(teng, False).run([port_side])
        jax_side = JaxRequest(list(prompt), 6, kv_inject=dict(
            th, data=bridge.torch_pages_to_jax(
                th["data"], jax.device_get(jh["data"]))))
        jax_side.tokens = [th["first_token"]]
        _sched(jeng, True).run([jax_side])
        assert port_side.error is None and jax_side.error is None
        assert port_side.tokens == ref.tokens == jax_side.tokens


def test_engine_handoff_checks_match_jax(models, roomy):
    """inject_pages refuses what the JAX engine refuses, with its
    messages; a dense engine refuses the handoff; page 0 is never
    written."""
    jeng, teng = roomy
    arena, last = teng.init_arena(), teng.init_last_tokens()
    data = teng.extract_pages(arena, [1, 2])
    bad = [((data, [1], 0, 5, 1), "carry 1 pages"),
           ((data, [0, 2], 0, 5, 1), r"page ids must be in \[1"),
           ((data, [1, 2], 5, 5, 1), "slot 5 out of range"),
           ((data, [1, 2], 0, 0, 1), "index 0 must be in"),
           ((data, [1, 2], 0, MAX_SEQ, 1), "full-to-the-brim")]
    for args, msg in bad:
        with pytest.raises(ValueError, match=msg):
            teng.inject_pages(arena, last, *args)
        jargs = (jax.device_get(jeng.extract_pages(jeng.init_arena(),
                                                   [1, 2])),) + args[1:]
        with pytest.raises(ValueError, match=msg):
            jeng.inject_pages(jeng.init_arena(), jeng.init_last_tokens(),
                              *jargs)
    with pytest.raises(ValueError, match=r"need 1\.\."):
        teng.extract_pages(arena, [])
    _, _, tm = models
    dense = InferenceEngine(tm, n_slots=2, buckets=BUCKETS, page_size=0,
                            device="cpu")
    for call in (lambda: dense.extract_pages(dense.init_arena(), [1]),
                 lambda: dense.extract_pages_batch(dense.init_arena(), [1]),
                 lambda: dense.inject_pages(dense.init_arena(),
                                            dense.init_last_tokens(), data,
                                            [1, 2], 0, 5, 1)):
        with pytest.raises(ValueError, match="paged engine"):
            call()
    for _, pool in teng._pool_leaves(arena):
        pool.fill_(3.0)
    filled = teng.extract_pages_batch(arena, list(range(1, teng.n_pages)))
    fresh = teng.init_arena()
    fresh, _ = teng.inject_pages_batch(
        fresh, last, [(_page_slice(filled, i, i + 2), [i + 1, i + 2], 0, 5,
                       1) for i in range(0, teng.n_pages - 2, 2)])
    assert all(float(p[0].abs().max()) == 0.0
               for _, p in teng._pool_leaves(fresh))
    assert all(float(p[1:].min()) == 3.0 for _, p in teng._pool_leaves(fresh))


def _page_slice(tree, a, b):
    return {k: (_page_slice(v, a, b) if isinstance(v, dict) else v[a:b])
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# the spill tiers in the scheduler against JAX's
# ---------------------------------------------------------------------------

SPILL_COUNTERS = ("pages_spilled", "pages_restored", "spill_host_hits",
                  "spill_disk_hits", "spill_quarantined", "spill_bytes",
                  "restore_bytes", "prefill_tokens_saved",
                  "decode_tokens", "requests_finished")


def churn(sched, R, seeds, n_new=3):
    """Distinct-prefix traffic that evicts the cached pages."""
    for t in seeds:
        done = sched.run([R([t] * 9 + [t + 1], n_new)])
        assert done[-1].error is None, done[-1].error


def _spill_run(eng, jax_side, hot_new=5, spec=0, **kw):
    R = JaxRequest if jax_side else Request
    s = _sched(eng, jax_side, **kw)
    s.run([R(SYS + [20, 21], 4, speculate=spec)])
    churn(s, R, (40, 45, 50, 55, 60))
    hot = s.run([R(SYS + [22, 23], hot_new, speculate=spec)])[-1]
    assert hot.error is None, hot.error
    return hot.tokens, s


def _hbm_hit(eng, spec=0, hot_new=5, **kw):
    """The no-spill oracle: the same warm-then-hot sequence on a roomy
    pool, so the hot request takes the prefix-hit admission path."""
    s = _sched(eng, False, **kw)
    s.run([Request(SYS + [20, 21], 4, speculate=spec)])
    return s.run([Request(SYS + [22, 23], hot_new, speculate=spec)])[-1].tokens


@pytest.mark.parametrize("mode", ["plain", "spec", "chunked"])
def test_restore_matches_hbm_hit_and_jax(tight, roomy, mode):
    """Warm a prefix, evict it by churn (spilling it to the host tier),
    serve the prefix again: restored, token-identical to an HBM prefix
    hit, with tokens and spill counters equal to JAX's."""
    extra = {"plain": {}, "spec": {"draft": NGramDraft()},
             "chunked": {"chunk_tokens": 8}}[mode]
    spec = 2 if mode == "spec" else 0
    tj, sj = _spill_run(tight[0], True, spec=spec, spill_host_bytes=1 << 20,
                        **dict(extra))
    tt, st = _spill_run(tight[1], False, spec=spec, spill_host_bytes=1 << 20,
                        **dict(extra))
    mt, mj = st.metrics.summary(), sj.metrics.summary()
    assert mt["pages_spilled"] > 0 and mt["pages_restored"] >= 1
    assert mt["spill_host_hits"] >= 1 and mt["restore_bytes"] > 0
    assert tt == tj == _hbm_hit(roomy[1], spec=spec, **dict(extra))
    for key in SPILL_COUNTERS:
        assert mt[key] == mj[key], key


def test_disk_tier_restore_matches_jax(tight, roomy, tmp_path):
    """A host budget below one page sends every spill to the disk tier;
    the restore is a disk hit, token-identical, counters as JAX's."""
    kw = dict(spill_host_bytes=1, spill_disk_bytes=1 << 20)
    tj, sj = _spill_run(tight[0], True, spill_dir=str(tmp_path / "j"), **kw)
    tt, st = _spill_run(tight[1], False, spill_dir=str(tmp_path / "t"), **kw)
    mt, mj = st.metrics.summary(), sj.metrics.summary()
    assert st.spill.disk.puts > 0 and mt["spill_disk_hits"] >= 1
    assert tt == tj == _hbm_hit(roomy[1])
    for key in SPILL_COUNTERS:
        assert mt[key] == mj[key], key
    assert st.spill.disk.puts == sj.spill.disk.puts


def _corrupt_all(disk):
    with open(disk.path, "r+b") as f:
        f.seek(0)
        f.write(b"\xff" * (disk._n_slots * disk.record_bytes))
    disk._mm.close()
    disk._mm = mmap.mmap(disk._fh.fileno(), disk._n_slots * disk.record_bytes)


def test_corrupt_spill_recomputes(tight, tmp_path):
    """Every disk record corrupted mid-serving: the restore quarantines
    by name and the prefix is recomputed, tokens as a cold recompute's
    and as JAX's on the same corruption."""
    out = []
    for jax_side, eng in ((True, tight[0]), (False, tight[1])):
        R = JaxRequest if jax_side else Request
        s = _sched(eng, jax_side, spill_host_bytes=1,
                   spill_dir=str(tmp_path / str(jax_side)),
                   spill_disk_bytes=1 << 20)
        s.run([R(SYS + [20, 21], 4)])
        churn(s, R, (40, 45, 50, 55, 60))
        assert s.spill.disk.puts > 0
        _corrupt_all(s.spill.disk)
        hot = s.run([R(SYS + [22, 23], 4)])[-1]
        assert hot.error is None
        out.append((hot.tokens, s.metrics.summary(), s.spill.disk))
    (tj, mj, dj), (tt, mt, dt) = out
    ref = _sched(tight[1], False).run([Request(SYS + [22, 23], 4)])[-1]
    assert tt == tj == ref.tokens
    assert mt["spill_quarantined"] == mj["spill_quarantined"] == 1
    assert dt.corrupt_entries == dj.corrupt_entries >= 1
    assert mt["pages_restored"] == mj["pages_restored"] == 0
    assert isinstance(dt.quarantine_log[0], SpillCorruptEntryError)


def test_receipts_and_spill_argument_checks(models, tight):
    """Registration publishes add receipts with the chain hashes; the
    spill arguments are checked as JAX checks them; the counters are
    window counters and in every summary."""
    jeng, teng = tight
    s = _sched(teng, False, spill_host_bytes=1 << 20)
    s.run([Request(SYS + [20, 21], 4)])
    assert ("add", page_chain_hashes(SYS + [20, 21], PAGE)[0]) in \
        list(s.kv_receipts)
    jm, params, tm = models
    for jax_side, eng in ((True, jeng), (False, teng)):
        with pytest.raises(ValueError, match="prefix_cache"):
            _sched(eng, jax_side, spill_host_bytes=1 << 20,
                   prefix_cache=False)
    dense = InferenceEngine(tm, n_slots=2, buckets=BUCKETS, page_size=0,
                            device="cpu")
    with pytest.raises(ValueError, match="paged"):
        Scheduler(dense, spill_host_bytes=1 << 20, device="cpu")
    with pytest.raises(ValueError, match="paged"):
        Scheduler(dense, spill_dir="/nonexistent", device="cpu")
    need = {"pages_spilled", "pages_restored", "spill_bytes", "restore_s",
            "directory_hits", "kv_handoff_pages", "spill_quarantined"}
    assert need <= ServeMetrics._WINDOW_COUNTERS
    m = ServeMetrics(n_slots=2).summary()
    assert need <= set(m)
