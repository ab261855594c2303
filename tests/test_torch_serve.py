"""The port's serving path against the JAX package's, request for request.

The same bridged weights and the same traffic (made with numpy from a
seed) go through the JAX ``Scheduler`` over a paged engine
(``paged_kernel=False``, the gather path) and the port's ``Scheduler`` over
its paged engine on the CPU (where the paged attend runs the kernel's
plain version).  Greedy tokens must be identical per request, with and
without a shared prefix: the comparison is with the JAX scheduler's own
output, including its prefix-cache behaviour, not with a cold run.
Tolerance: exact token equality.

One fault of the reference is worked around here, not copied: the JAX
scheduler points a retiring slot's host page-table row at the garbage page
right after dispatching that slot's last decode step, and on the CPU
backend ``jnp.asarray`` of the host table can alias the numpy buffer, so
the still-running step may read the rewritten row and emit a wrong last
token (nondeterministically).  :class:`_SnapshotTablesEngine` hands the
JAX engine a copy of the table at dispatch, the "snapshot copied at
dispatch" its scheduler intends.
"""

import jax
import jax.numpy as jnp
import flax.linen as fnn
import numpy as np
import pytest
import torch

from dtdl_tpu.models.transformer import transformer_lm as jax_lm
from dtdl_tpu.serve import InferenceEngine as JaxEngine
from dtdl_tpu.serve import Request as JaxRequest
from dtdl_tpu.serve import Scheduler as JaxScheduler
from dtdl_tpu_torch import bridge
from dtdl_tpu_torch.models.transformer import generate, transformer_lm
from dtdl_tpu_torch.obs import Observer
from dtdl_tpu_torch.runtime.mesh import build_mesh
from dtdl_tpu_torch.serve.engine import InferenceEngine
from dtdl_tpu_torch.serve.scheduler import Request, Scheduler
from dtdl_tpu_torch.serve.tenant import bank_nbytes

# small shapes: one intra-op thread each leaves the cores to the other
# test workers
torch.set_num_threads(1)


class _SnapshotTablesEngine(JaxEngine):
    def _tables_arg(self, page_tables):
        if page_tables is not None:
            page_tables = np.array(page_tables, copy=True)
        return super()._tables_arg(page_tables)


BUCKETS = (8, 16, 32)
PAGE = 8
VOCAB = 256            # the 'tiny' preset: d_model 64, 2 layers, 4 heads


@pytest.fixture(scope="module")
def models():
    jm = jax_lm("tiny", attn_impl="dense", dtype=jnp.float32)
    params = fnn.unbox(jm.init(jax.random.PRNGKey(0),
                               jnp.zeros((1, 4), jnp.int32))["params"])
    tm = transformer_lm("tiny", device="cpu", seed=None, dtype=torch.float32)
    bridge.load_flax_params(tm, jax.device_get(params), device="cpu")
    return jm, params, tm


def _traffic(seed, n, shared_prefix):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, VOCAB, 2 * PAGE).tolist()
    out = []
    for i in range(n):
        tail = rng.integers(0, VOCAB, int(rng.integers(2, 12))).tolist()
        prompt = prefix + tail if shared_prefix and i % 2 == 0 else \
            rng.integers(0, VOCAB, int(rng.integers(3, 20))).tolist()
        out.append((prompt, int(rng.integers(3, 9))))
    return out


@pytest.mark.parametrize("shared_prefix", [False, True])
def test_greedy_tokens_match_jax_scheduler(models, shared_prefix):
    jm, params, tm = models
    traffic = _traffic(3, 6, shared_prefix)
    jeng = _SnapshotTablesEngine(jm, params, n_slots=2, buckets=BUCKETS,
                                 page_size=PAGE, paged_kernel=False)
    jreqs = [JaxRequest(p, m) for p, m in traffic]
    jsched = JaxScheduler(jeng, harvest_lag=2)
    jsched.run(jreqs)

    teng = InferenceEngine(tm, n_slots=2, buckets=BUCKETS, page_size=PAGE,
                           device="cpu")
    treqs = [Request(p, m) for p, m in traffic]
    tsched = Scheduler(teng, harvest_lag=2, device="cpu")
    tsched.run(treqs)

    assert all(r.done and r.error is None for r in treqs)
    assert [r.tokens for r in treqs] == [r.tokens for r in jreqs]
    ts, js = tsched.metrics.summary(), jsched.metrics.summary()
    for key in ("requests_finished", "prefill_tokens", "decode_tokens",
                "prefill_tokens_saved", "pages_in_use_peak"):
        assert ts[key] == js[key], key
    if shared_prefix:
        assert ts["prefill_tokens_saved"] > 0


def test_rejections_match_jax(models):
    """Oversized prompts are rejected by name at submit, as in JAX."""
    _, _, tm = models
    eng = InferenceEngine(tm, n_slots=2, buckets=BUCKETS, page_size=PAGE,
                          device="cpu")
    sched = Scheduler(eng, harvest_lag=2, max_queue=1, device="cpu")
    too_long = sched.submit(Request([1] * 40, 4))
    assert too_long.done and too_long.error.startswith("rejected:")
    assert "prefill bucket" in too_long.error
    sched.submit(Request([1, 2, 3], 2))
    full = sched.submit(Request([4, 5, 6], 2))
    assert full.error.startswith("rejected: admission queue full")
    done = sched.run()
    assert sum(r.error is None for r in done) == 1


def test_decode_tokens_stay_on_device_until_harvest(models):
    """The lag harvest: with harvest_lag=3 the host has read no token of a
    request until three steps after its dispatch."""
    _, _, tm = models
    eng = InferenceEngine(tm, n_slots=2, buckets=BUCKETS, page_size=PAGE,
                          device="cpu")
    sched = Scheduler(eng, harvest_lag=3, device="cpu")
    req = sched.submit(Request([3, 1, 4, 1, 5], 6))
    sched.step()
    sched.step()
    assert req.tokens == [] and len(sched._pending) == 3
    sched.step()
    assert len(req.tokens) == 1
    sched.run()
    assert len(req.tokens) == 6


def test_engine_refuses_later_slices(models):
    _, _, tm = models
    # the dense arena, quantization, chunked prefill, tensor-parallel
    # serving, tenancy and the observer are ported; a tensor-parallel
    # engine takes an adapter bank (its receipts the JAX engine's)
    mesh = build_mesh((1, 1), ("data", "model"))
    tp = InferenceEngine(tm, n_slots=2, device="cpu", mesh=mesh,
                         lora_rank=2, lora_adapters=3)
    assert tp.compile_stats()["tp"] == {"rules": "tp",
                                        "mesh": {"data": 1, "model": 1}}
    # one model axis of size 1: the whole bank on the one rank
    assert tp.compile_stats()["lora"] == {
        "rank": 2, "n_adapters": 3,
        "bank_bytes": bank_nbytes(tp.adapter_bank.bank)}
    assert tp.adapter_bank.bank["block_0"]["attn"]["q_b"].shape == \
        (3, 2, tm.cfg.n_heads, tm.cfg.head_dim)
    eng = InferenceEngine(tm, n_slots=2, buckets=BUCKETS, page_size=PAGE,
                          device="cpu")
    # the spill tiers and the observer are ported: the scheduler hands its
    # observer to the engine, which watches each program once by name
    assert Scheduler(eng, spill_host_bytes=1 << 20,
                     device="cpu").spill is not None
    watched = []
    obs = Observer(trace=True, sentinel=None)
    obs.watch = lambda fn, name=None, expected=1: watched.append(name) or fn
    Scheduler(eng, observer=obs, device="cpu").run(
        [Request([1, 2, 3], 3), Request([4, 5, 6, 7], 3)])
    assert eng.observer is obs
    assert watched == ["serve.prefill[8]", "serve.decode"]
    with pytest.raises(TypeError, match="not a dtdl_tpu_torch strategy"):
        generate(tm, np.zeros((1, 3), np.int32), 2, strategy=object())


def test_deadline_and_pool_shedding_match_jax(models):
    """A request past its deadline expires by name; with a pool too small
    for every request to grow, the same requests are shed as in the JAX
    scheduler, and the survivors' tokens are identical."""
    jm, params, tm = models
    rng = np.random.default_rng(8)
    traffic = [(rng.integers(0, VOCAB, 12).tolist(), 20) for _ in range(3)]
    jeng = _SnapshotTablesEngine(jm, params, n_slots=3, buckets=BUCKETS,
                                 page_size=PAGE, n_pages=8,
                                 paged_kernel=False)
    jreqs = [JaxRequest(p, m) for p, m in traffic]
    JaxScheduler(jeng, harvest_lag=2, prefix_cache=False).run(jreqs)
    teng = InferenceEngine(tm, n_slots=3, buckets=BUCKETS, page_size=PAGE,
                           n_pages=8, device="cpu")
    treqs = [Request(p, m) for p, m in traffic]
    tsched = Scheduler(teng, harvest_lag=2, prefix_cache=False,
                       device="cpu")
    tsched.run(treqs)
    assert [(r.error or "").split(":")[0] for r in treqs] == \
        [(r.error or "").split(":")[0] for r in jreqs]
    assert any((r.error or "").startswith("shed:") for r in treqs)
    assert [r.tokens for r in treqs if r.error is None] == \
        [r.tokens for r in jreqs if r.error is None]
    assert tsched.metrics.summary()["requests_shed"] >= 1

    late = tsched.submit(Request([1, 2, 3], 4, deadline_s=0.0))
    tsched.run()
    assert late.error.startswith("expired:")


def test_sampled_requests_reproduce_from_the_seed(models):
    """Sampled requests draw with the scheduler's seeded torch.Generator:
    the same seed gives the same tokens, and greedy neighbours in the same
    batch keep their greedy tokens."""
    from dtdl_tpu_torch.serve.sampling import SampleParams
    _, _, tm = models
    eng = InferenceEngine(tm, n_slots=2, buckets=BUCKETS, page_size=PAGE,
                          device="cpu")
    prompt = list(range(5, 17))
    runs = []
    for _ in range(2):
        reqs = [Request(prompt, 8, sampling=SampleParams(0.9, 20, 0.95)),
                Request(prompt, 8)]
        Scheduler(eng, seed=11, harvest_lag=2, prefix_cache=False,
                  device="cpu").run(reqs)
        runs.append([r.tokens for r in reqs])
    assert runs[0] == runs[1]
    greedy = [Request(prompt, 8)]
    Scheduler(eng, harvest_lag=2, device="cpu").run(greedy)
    assert runs[0][1] == greedy[0].tokens
    assert all(0 <= t < VOCAB for t in runs[0][0])
