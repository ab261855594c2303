"""Speculative decoding in the port against the JAX package's.

The same bridged weights (the JAX spec tests' config: vocab 64, d_model
32, 2 layers, 2 heads, max_seq 48, f32) and the same inputs, made with
numpy from seeds, go through the JAX functions and the port's on the CPU.
The JAX paged engine runs ``paged_kernel=False`` (its gather path), as its
own tests do on the CPU; the port's paged attend takes the kernel's plain
version for CPU tensors.

Tolerances: greedy tokens, accepted counts, emitted counts, the arena
index and every scheduler count are compared exactly; the K/V pools after
a verify step within atol 1e-5 (f32, different matmul summation orders
over two layers), the garbage page excluded (inactive rows and padding
positions write it, in no fixed order); sampled rows, whose random
streams differ between the frameworks, by distribution: the acceptance
rate within 4 standard errors of the analytic p(draft), and the emitted
token's empirical distribution within a total-variation distance of 0.03
of p (4000 draws over 4 tokens: the expected distance is ~0.01).

The JAX scheduler can read a page-table row it has already reset (see
tests/test_torch_serve.py): the JAX engine here gets a copy of the table
at dispatch, as there.
"""

import copy

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
from dtdl_tpu.serve import accept_resample as jax_accept_resample
from dtdl_tpu_torch import bridge
from dtdl_tpu_torch.models.transformer import transformer_lm
from dtdl_tpu_torch.serve import (DraftSource, InferenceEngine, ModelDraft,
                                  NGramDraft, Request, Scheduler,
                                  accept_resample)

# small shapes: one intra-op thread each leaves the cores to the other
# test workers
torch.set_num_threads(1)

MAX_SEQ = 48
BUCKETS = (8, 16)
PAGE = 8
VOCAB = 64
CFG = dict(vocab_size=VOCAB, d_model=32, n_layers=2, n_heads=2, d_ff=64,
           max_seq=MAX_SEQ)
POOL_ATOL = 1e-5
TV_BOUND = 0.03


class _SnapshotTablesEngine(JaxEngine):
    def _tables_arg(self, page_tables):
        if page_tables is not None:
            page_tables = np.array(page_tables, copy=True)
        return super()._tables_arg(page_tables)


@pytest.fixture(scope="module")
def models():
    jm = jax_lm("tiny", attn_impl="dense", dtype=jnp.float32, **CFG)
    params = fnn.unbox(jm.init(jax.random.PRNGKey(0),
                               jnp.zeros((1, 4), jnp.int32))["params"])
    tm = transformer_lm("tiny", device="cpu", seed=None, dtype=torch.float32,
                        **CFG)
    bridge.load_flax_params(tm, jax.device_get(params), device="cpu")
    return jm, params, tm


@pytest.fixture(scope="module")
def jax_engine(models):
    jm, params, _ = models
    return _SnapshotTablesEngine(jm, params, n_slots=2, buckets=BUCKETS,
                                 page_size=PAGE, paged_kernel=False)


@pytest.fixture(scope="module")
def engine(models):
    return InferenceEngine(models[2], n_slots=2, buckets=BUCKETS,
                           page_size=PAGE, device="cpu")


def _plain_tokens(engine, prompts, n_new, lag=3):
    reqs = [Request(p, n) for p, n in zip(prompts, n_new)]
    Scheduler(engine, harvest_lag=lag, device="cpu").run(reqs)
    return [r.tokens for r in reqs]


class OracleDraft:
    """Drafts from the known full sequences: the perfect source."""

    def __init__(self, prompts, token_lists):
        self.seqs = [(list(p), list(p) + list(t))
                     for p, t in zip(prompts, token_lists)]

    def propose(self, ctx, k):
        ctx = [int(t) for t in ctx]
        for p, full in self.seqs:
            if ctx[:len(p)] == p and ctx == full[:len(ctx)]:
                return np.asarray(full[len(ctx):len(ctx) + k], np.int32)
        return np.zeros((0,), np.int32)


class GarbageDraft:
    """Always drafts the same, almost always wrong, token."""

    def propose(self, ctx, k):
        return np.full((k,), VOCAB - 1, np.int32)


# ---- accept_resample ------------------------------------------------------

def _accept_case(case, seed):
    """Random logits and drafts: some rows draft their argmax prefix for a
    while, then go wrong; ``draft_len`` covers 0, partial and full."""
    rng = np.random.default_rng(seed)
    B, k, V = 6, 4, 32
    logits = rng.normal(size=(B, k + 1, V)).astype(np.float32)
    allowed = None
    if case == "allowed":
        allowed = rng.random((B, k + 1, V)) < 0.6
        allowed[..., 0] = True                  # no row left empty
    masked = logits if allowed is None else np.where(allowed, logits, -np.inf)
    argmax = masked.argmax(-1)
    draft = rng.integers(0, V, (B, k)).astype(np.int32)
    for b in range(B):
        good = b % (k + 1)                      # 0..k correct drafts
        draft[b, :good] = argmax[b, :good]
    draft_len = np.array([4, 3, 0, 4, 2, 1], np.int32)
    forced = None
    if case == "forced":
        forced = np.array([True, False, True, False, True, False])
    return logits, draft, draft_len, forced, allowed


@pytest.mark.parametrize("case", ["greedy", "forced", "allowed"])
@pytest.mark.parametrize("seed", [0, 1])
def test_accept_resample_greedy_rows_match_jax(case, seed):
    """Greedy rows, padding past draft_len, forced rows and a dense
    allowed mask: tokens and n_accepted exactly equal to the JAX
    function's."""
    logits, draft, draft_len, forced, allowed = _accept_case(case, seed)
    B = logits.shape[0]
    zeros, ones = np.zeros(B, np.float32), np.ones(B, np.float32)
    want_t, want_n = jax_accept_resample(
        jnp.asarray(logits), jnp.asarray(draft), jnp.asarray(draft_len),
        jax.random.PRNGKey(0), jnp.asarray(zeros),
        jnp.zeros(B, jnp.int32), jnp.asarray(ones),
        forced=None if forced is None else jnp.asarray(forced),
        allowed=None if allowed is None else jnp.asarray(allowed))
    got_t, got_n = accept_resample(
        torch.from_numpy(logits), torch.from_numpy(draft),
        torch.from_numpy(draft_len), None, zeros, np.zeros(B, np.int32),
        ones, forced=None if forced is None else torch.from_numpy(forced),
        allowed=None if allowed is None else torch.from_numpy(allowed))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    assert got_t.dtype == torch.int32 and got_n.dtype == torch.int32
    if forced is not None:
        assert (got_n.numpy()[forced] == draft_len[forced]).all()


def test_accept_resample_refuses_packed_masks():
    logits = torch.zeros(1, 2, 40)
    packed = torch.zeros(1, 2, 2, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="A12"):
        accept_resample(logits, torch.zeros(1, 1, dtype=torch.int32),
                        torch.ones(1, dtype=torch.int32), None, [0.0], [0],
                        [1.0], allowed=packed)


def test_rejection_sampling_matches_analytic_acceptance():
    """The hand-computable 4-token case (port of the JAX test): target p =
    softmax(logits), one-hot proposal d.  The acceptance rate is p[d], the
    emitted token is distributed as p (accepted or resampled from the
    residual), a rejected row never emits d, and the JAX function's
    emitted distribution is p too, so the two agree by distribution."""
    logits_row = np.array([2.0, 1.0, 0.0, -1.0], np.float32)
    p = np.exp(logits_row) / np.exp(logits_row).sum()
    d, B = 1, 4000
    logits = np.tile(logits_row, (B, 2, 1))
    ones = np.ones(B, np.float32)
    gen = torch.Generator().manual_seed(0)
    toks, n_acc = accept_resample(
        torch.from_numpy(logits), torch.full((B, 1), d, dtype=torch.int32),
        torch.ones(B, dtype=torch.int32), gen, ones, np.zeros(B, np.int32),
        ones)
    toks, n_acc = toks.numpy(), n_acc.numpy()
    se = np.sqrt(p[d] * (1 - p[d]) / B)
    assert abs(n_acc.mean() - p[d]) < 4 * se, (n_acc.mean(), p[d])
    emitted = toks[np.arange(B), 0]
    freq = np.bincount(emitted, minlength=4) / B
    assert 0.5 * np.abs(freq - p).sum() < TV_BOUND, freq
    assert not np.any(emitted[n_acc == 0] == d)

    jt, _ = jax_accept_resample(
        jnp.asarray(logits), jnp.full((B, 1), d, jnp.int32),
        jnp.ones(B, jnp.int32), jax.random.PRNGKey(0), jnp.asarray(ones),
        jnp.zeros(B, jnp.int32), jnp.asarray(ones))
    jfreq = np.bincount(np.asarray(jt)[:, 0], minlength=4) / B
    assert 0.5 * np.abs(jfreq - p).sum() < TV_BOUND, jfreq

    # greedy rows: exact argmax prefix match only
    toks_g, n_acc_g = accept_resample(
        torch.from_numpy(logits), torch.full((B, 1), d, dtype=torch.int32),
        torch.ones(B, dtype=torch.int32), None, np.zeros(B, np.float32),
        np.zeros(B, np.int32), ones)
    assert (n_acc_g.numpy() == 0).all() and (toks_g.numpy()[:, 0] == 0).all()


def test_sampled_rows_keep_filtered_distribution_over_positions():
    """Two draft positions under top-k 2: the first emitted token follows
    the filtered p_0 whatever the draft (the drafted token is outside the
    keep set half the time), and no emitted token leaves the keep set."""
    logits_row = np.array([1.5, 1.0, 0.2, -0.5, -1.0], np.float32)
    B = 4000
    logits = np.tile(logits_row, (B, 3, 1))
    draft = np.where(np.arange(B)[:, None] % 2 == 0, 1, 3) \
        * np.ones((B, 2), np.int64)
    gen = torch.Generator().manual_seed(3)
    toks, n_acc = accept_resample(
        torch.from_numpy(logits), torch.from_numpy(draft),
        torch.full((B,), 2, dtype=torch.int32), gen,
        np.full(B, 1.0, np.float32), np.full(B, 2, np.int32),
        np.ones(B, np.float32))
    toks, n_acc = toks.numpy(), n_acc.numpy()
    p = np.zeros(5)
    p[:2] = np.exp(logits_row[:2]) / np.exp(logits_row[:2]).sum()
    freq = np.bincount(toks[:, 0], minlength=5) / B
    assert 0.5 * np.abs(freq - p).sum() < TV_BOUND, freq
    assert (n_acc[1::2] == 0).all()          # token 3 is never kept
    emitted = np.concatenate([toks[b, :n + 1] for b, n in enumerate(n_acc)])
    assert set(np.unique(emitted)) <= {0, 1}


# ---- NGramDraft -----------------------------------------------------------

def _ngram_contexts(kind, rng):
    if kind == "repetition":
        period = int(rng.integers(1, 6))
        unit = rng.integers(0, 8, period)
        L = int(rng.integers(2, 40))
        return np.resize(unit, L)
    if kind == "no_hit":
        return rng.permutation(VOCAB)[:int(rng.integers(2, 30))]
    if kind == "short":
        return rng.integers(0, 3, int(rng.integers(0, 4)))
    return rng.integers(0, 6, int(rng.integers(4, 50)))   # mixed


@pytest.mark.parametrize("kind", ["repetition", "no_hit", "short", "mixed"])
def test_ngram_proposals_match_jax(kind):
    """60 seeded contexts of each kind, k from 1 to past the context's
    end, n-gram probes (3, 1) and (2, 2): proposals identical."""
    rng = np.random.default_rng(["repetition", "no_hit", "short",
                                 "mixed"].index(kind))
    pairs = [(NGramDraft(), JaxNGramDraft()),
             (NGramDraft(2, 2), JaxNGramDraft(2, 2))]
    n_nonempty = 0
    for _ in range(60):
        ctx = _ngram_contexts(kind, rng)
        k = int(rng.integers(1, len(ctx) + 6)) if len(ctx) else 3
        for port, ref in pairs:
            got, want = port.propose(ctx, k), ref.propose(ctx, k)
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, want)
            n_nonempty += int(got.size > 0)
    assert isinstance(NGramDraft(), DraftSource)
    if kind in ("repetition", "mixed"):
        assert n_nonempty > 60
    if kind == "no_hit":
        assert n_nonempty == 0


# ---- engine.verify --------------------------------------------------------

@pytest.mark.parametrize("n_right", [0, 2, 4])
def test_verify_matches_jax_paged_engine(models, n_right):
    """One verify step of width 5 over four slots after identical
    prefills: slot 0 drafts ``n_right`` correct tokens then wrong ones
    (its window 6..10 crosses a page boundary), slot 1 drafts nothing,
    slot 2 is inactive, slot 3 is a forced prompt chunk written at
    pos_set 4 below its stale index 8.  Tokens, emitted counts, last
    tokens and the index exactly equal; the pools within POOL_ATOL."""
    jm, params, tm = models
    B, k = 4, 4
    jeng = _SnapshotTablesEngine(jm, params, n_slots=B, buckets=BUCKETS,
                                 page_size=PAGE, paged_kernel=False)
    teng = InferenceEngine(tm, n_slots=B, buckets=BUCKETS, page_size=PAGE,
                           device="cpu")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, VOCAB, n).tolist() for n in (6, 11, 9, 8)]
    tables = np.zeros((B, teng.n_ptab), np.int32)
    tables[:, :2] = np.arange(1, 2 * B + 1).reshape(B, 2)
    ja, jl = jeng.init_arena(), jeng.init_last_tokens()
    ta, tl = teng.init_arena(), teng.init_last_tokens()
    for slot, prompt in enumerate(prompts):
        ja, jl, _ = jeng.prefill(ja, jl, slot, prompt, page_row=tables[slot])
        ta, tl, _ = teng.prefill(ta, tl, slot, prompt, page_row=tables[slot])
    assert tl.tolist() == np.asarray(jl).tolist()

    # slot 0's greedy continuation, from plain decode steps on a copy
    greedy = (np.zeros(B, np.float32), np.zeros(B, np.int32),
              np.ones(B, np.float32))
    only0 = np.array([True, False, False, False])
    ca, cl = copy.deepcopy(ta), tl.clone()
    cont = []
    for _ in range(k):
        ca, cl, _ = teng.decode(ca, cl, only0, *greedy, tables)
        cont.append(int(cl[0]))
    drafts = np.zeros((B, k), np.int32)
    drafts[0] = [(t + 1) % VOCAB for t in cont]
    drafts[0, :n_right] = cont[:n_right]
    drafts[3, :3] = rng.integers(0, VOCAB, 3)
    draft_len = np.array([4, 0, 0, 3], np.int32)
    active = np.array([True, True, False, True])
    forced = np.array([False, False, False, True])
    first_tok = np.array([0, 0, 0, 17], np.int32)
    pos_set = np.array([0, 0, 0, 4], np.int32)

    ja, jl, jt, jn = jeng.verify(
        ja, jl, drafts, draft_len, active, jax.random.PRNGKey(0),
        *(jnp.asarray(g) for g in greedy), page_tables=tables,
        forced=forced, first_tok=first_tok, pos_set=pos_set)
    ta, tl, tt, tn = teng.verify(
        ta, tl, drafts, draft_len, active, *greedy, tables, forced=forced,
        first_tok=first_tok, pos_set=pos_set)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(ta["index"].numpy(),
                                  np.asarray(ja["block_0"]["attn"]["index"]))
    assert tn.tolist() == [min(n_right, 4) + 1, 1, 0, 4]
    assert tt[0, :n_right].tolist() == cont[:n_right]
    assert ta["index"].tolist() == [6 + n_right + 1, 12, 9, 8]
    for i in range(CFG["n_layers"]):
        for name in ("pages_key", "pages_value"):
            got = ta[f"block_{i}"]["attn"][name][1:].numpy()
            want = np.asarray(ja[f"block_{i}"]["attn"][name])[1:]
            np.testing.assert_allclose(got, want, rtol=0, atol=POOL_ATOL)


def test_verify_emits_sequential_decode_tokens_per_window(engine):
    """Port of the JAX window test: with perfect drafts the window holds
    k accepted tokens and the bonus; with a wrong first draft it holds
    exactly the token plain decode gives (n_accepted 0)."""
    rng = np.random.default_rng(5)
    p = rng.integers(0, VOCAB, 6).tolist()
    greedy = (np.zeros(2, np.float32), np.zeros(2, np.int32),
              np.ones(2, np.float32))
    active = np.array([True, False])
    tables = np.zeros((2, engine.n_ptab), np.int32)
    tables[0, :2] = [1, 2]

    def fresh():
        arena, last = engine.init_arena(), engine.init_last_tokens()
        return engine.prefill(arena, last, 0, p, page_row=tables[0])[:2]

    arena, last = fresh()
    seq = [int(last[0])]
    for _ in range(4):
        arena, last, _ = engine.decode(arena, last, active, *greedy, tables)
        seq.append(int(last[0]))

    drafts = np.zeros((2, 3), np.int32)
    drafts[0] = seq[1:4]
    arena, last = fresh()
    _, last, toks, n_em = engine.verify(arena, last, drafts,
                                        np.array([3, 0]), active, *greedy,
                                        tables)
    assert n_em.tolist() == [4, 0]
    assert toks[0, :4].tolist() == seq[1:5] and int(last[0]) == seq[4]
    assert toks[1].tolist() == [0, 0, 0, 0]

    arena, last = fresh()
    _, _, toks, n_em = engine.verify(arena, last, (drafts + 1) % VOCAB,
                                     np.array([3, 0]), active, *greedy,
                                     tables)
    assert n_em.tolist() == [1, 0] and int(toks[0, 0]) == seq[1]


def test_verify_argument_checks(engine):
    arena, last = engine.init_arena(), engine.init_last_tokens()
    knobs = (np.zeros(2, np.float32), np.zeros(2, np.int32),
             np.ones(2, np.float32))
    tables = np.zeros((2, engine.n_ptab), np.int32)
    act = np.array([True, True])
    with pytest.raises(ValueError, match="n_slots"):
        engine.verify(arena, last, np.zeros((3, 2)), [1, 1], act, *knobs,
                      tables)
    with pytest.raises(ValueError, match="k >= 1"):
        engine.verify(arena, last, np.zeros((2, 0)), [0, 0], act, *knobs,
                      tables)
    with pytest.raises(ValueError, match="max_seq"):
        engine.verify(arena, last, np.zeros((2, MAX_SEQ)), [1, 1], act,
                      *knobs, tables)


# ---- the scheduler --------------------------------------------------------

def test_greedy_spec_tokens_and_metrics_match_jax_scheduler(models,
                                                            jax_engine,
                                                            engine):
    """Port of the JAX spec pin: mixed-length prompts through 2 slots
    with slot reuse and mid-flight admission, speculate 4 and 0 mixed,
    n-gram drafts.  Tokens equal the JAX spec scheduler's and the port's
    plain scheduler's; the spec counts and decode_tokens equal the JAX
    summary's."""
    rng = np.random.default_rng(1)
    lens, n_new = (3, 9, 14, 5, 7), (12, 10, 14, 9, 11)
    prompts = [rng.integers(0, VOCAB, n).tolist() for n in lens]
    ref = _plain_tokens(engine, prompts, n_new)
    jreqs = [JaxRequest(p, n, speculate=(4 if i % 2 == 0 else 0))
             for i, (p, n) in enumerate(zip(prompts, n_new))]
    jsched = JaxScheduler(jax_engine, harvest_lag=3, draft=JaxNGramDraft())
    jsched.run(jreqs)
    reqs = [Request(p, n, speculate=(4 if i % 2 == 0 else 0))
            for i, (p, n) in enumerate(zip(prompts, n_new))]
    sched = Scheduler(engine, harvest_lag=3, draft=NGramDraft(),
                      device="cpu")
    sched.run(reqs)
    assert all(r.done and r.error is None for r in reqs)
    assert [r.tokens for r in reqs] == ref
    assert [r.tokens for r in reqs] == [r.tokens for r in jreqs]
    ts, js = sched.metrics.summary(), jsched.metrics.summary()
    assert ts["spec_steps"] > 0 and ts["spec_drafted_tokens"] > 0
    for key in ("spec_steps", "spec_steps_by_k", "spec_drafted_tokens",
                "spec_accepted_tokens", "decode_tokens", "decode_steps",
                "requests_finished"):
        assert ts[key] == js[key], key
    assert ts["decode_tokens"] == sum(len(t) for t in ref) - len(ref)
    assert ts["spec_acceptance_rate"] == pytest.approx(
        js["spec_acceptance_rate"], abs=1e-4)
    assert ts["draft_s"] > 0.0


def test_paged_spec_decode_token_identical(models, jax_engine, engine):
    """Port of the paged spec test: mixed spec and plain greedy traffic
    with n-gram drafts equals the JAX package's plain paged decode, and
    every page comes back to the pool."""
    rng = np.random.default_rng(5)
    lens, n_new = (5, 9, 12), (10, 9, 8)
    prompts = [rng.integers(0, VOCAB, n).tolist() for n in lens]
    jreqs = [JaxRequest(p, n) for p, n in zip(prompts, n_new)]
    JaxScheduler(jax_engine, harvest_lag=2).run(jreqs)
    reqs = [Request(p, n, speculate=(4 if i % 2 == 0 else 0))
            for i, (p, n) in enumerate(zip(prompts, n_new))]
    sched = Scheduler(engine, harvest_lag=2, device="cpu")
    sched.run(reqs)
    assert [r.tokens for r in reqs] == [r.tokens for r in jreqs]
    assert sched.metrics.summary()["spec_steps"] > 0
    assert sched.pages.pages_in_use == 0


@pytest.mark.parametrize("paged_ref", [False, True])
def test_spec_budget_clamped_to_cache_capacity(models, jax_engine, engine,
                                               paged_ref):
    """Speculative overshoot near max_seq: worst-case settling and page
    growth keep verify windows inside the arena, and the request emits
    exactly its clamped budget, equal to the port's plain run and to the
    JAX package's plain paged run."""
    rng = np.random.default_rng(7 if not paged_ref else 6)
    prompt = rng.integers(0, VOCAB, 14).tolist()
    if paged_ref:
        jreq = JaxRequest(prompt, 99)
        JaxScheduler(jax_engine, harvest_lag=2).run([jreq])
        ref = jreq.tokens
    else:
        ref = _plain_tokens(engine, [prompt], (99,))[0]
    req = Request(prompt, 99, speculate=4)
    Scheduler(engine, harvest_lag=2, device="cpu").run([req])
    assert req.done and req.error is None
    assert len(req.tokens) == MAX_SEQ - len(prompt) + 1
    assert req.tokens == ref


def test_spec_lossless_under_garbage_drafts(engine):
    """Every candidate wrong: output token-identical, acceptance ~0, and
    the adaptive k never drafts wider than its start of 2."""
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, VOCAB, n).tolist() for n in (6, 11)]
    ref = _plain_tokens(engine, prompts, (10, 10))
    reqs = [Request(p, 10, speculate=4) for p in prompts]
    sched = Scheduler(engine, harvest_lag=2, draft=GarbageDraft(),
                      device="cpu")
    sched.run(reqs)
    assert [r.tokens for r in reqs] == ref
    s = sched.metrics.summary()
    assert s["spec_acceptance_rate"] < 0.2
    assert set(s["spec_steps_by_k"]) <= {1, 2}


def test_oracle_draft_grows_k_and_accepts_everything(models):
    """A perfect draft source: acceptance 1.0, k doubles from 2 to the
    request's speculate=8, more than two tokens per step, and the output
    is still token-identical."""
    eng = InferenceEngine(models[2], n_slots=1, buckets=BUCKETS,
                          page_size=PAGE, device="cpu")
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, VOCAB, 5).tolist()
    ref = _plain_tokens(eng, [prompt], (30,))[0]
    req = Request(prompt, 30, speculate=8)
    sched = Scheduler(eng, harvest_lag=2, draft=OracleDraft([prompt], [ref]),
                      device="cpu")
    sched.run([req])
    assert req.tokens == ref
    s = sched.metrics.summary()
    assert s["spec_acceptance_rate"] == 1.0
    assert 8 in s["spec_steps_by_k"]
    assert s["tokens_per_step_mean"] > 2.0


@pytest.mark.parametrize("lag", [0, 3])
def test_spec_eos_trims_exactly(engine, lag):
    """EOS under speculation and lag harvest: tokens past the stop token,
    in the same window or later, are trimmed."""
    rng = np.random.default_rng(6)
    prompt = rng.integers(0, VOCAB, 5).tolist()
    ref = _plain_tokens(engine, [prompt], (8,))[0]
    eos = ref[2]
    req = Request(prompt, 8, eos_id=eos, speculate=4)
    Scheduler(engine, harvest_lag=lag, device="cpu").run([req])
    assert req.tokens == ref[:ref.index(eos) + 1]


def test_model_draft_vocab_mismatch_rejected(models, engine):
    other = transformer_lm("tiny", device="cpu", dtype=torch.float32,
                           **{**CFG, "vocab_size": 32, "n_layers": 1})
    with pytest.raises(ValueError, match="vocab"):
        Scheduler(engine, draft=ModelDraft(other), device="cpu")


def test_oversized_prompt_rejected_mid_run(engine):
    """A too-long prompt comes back rejected while the rest of the batch,
    speculating, completes."""
    rng = np.random.default_rng(9)
    good = [Request(rng.integers(0, VOCAB, 5).tolist(), 4, speculate=2)
            for _ in range(2)]
    bad = Request(list(range(BUCKETS[-1] + 1)), 4)
    sched = Scheduler(engine, harvest_lag=1, device="cpu")
    done = sched.run([good[0], bad, good[1]])
    assert bad in done and bad.error is not None and not bad.tokens
    assert "bucket" in bad.error
    for r in good:
        assert r.done and r.error is None and len(r.tokens) == 4
    s = sched.metrics.summary()
    assert s["requests_rejected"] == 1 and s["requests_finished"] == 2


def test_sampled_spec_requests_reproduce_from_the_seed(engine):
    """Sampled speculating requests draw with the scheduler's seeded
    generator: the same seed gives the same tokens, and a greedy
    neighbour keeps its plain greedy tokens."""
    from dtdl_tpu_torch.serve.sampling import SampleParams
    prompt = list(range(5, 17))
    runs = []
    for _ in range(2):
        reqs = [Request(prompt, 10, speculate=3,
                        sampling=SampleParams(0.9, 20, 0.95)),
                Request(prompt, 10, speculate=3)]
        Scheduler(engine, seed=11, harvest_lag=2, prefix_cache=False,
                  device="cpu").run(reqs)
        runs.append([r.tokens for r in reqs])
    assert runs[0] == runs[1]
    assert runs[0][1] == _plain_tokens(engine, [prompt], (10,))[0]
    assert len(runs[0][0]) == 10 and all(0 <= t < VOCAB for t in runs[0][0])
