"""Grammar-constrained decoding in the port against the JAX package's
(dtdl_tpu/serve/tenant/grammar.py, the packed masks of
dtdl_tpu/serve/sampling.py and the scheduler's grammar gate).

Tolerances, each where it is used:

* the compiler: ``TokenDFA`` tables (``trans``, ``allow``, ``accept``,
  states, start) equal to JAX's exactly, on the regex and JSON-schema
  cases of tests/test_multitenant.py and a few more; the same errors;
* ``pack_mask`` words equal to JAX's bitwise (bit 31 set, vocabularies
  that are not a multiple of 32); ``unpack_mask`` the exact inverse on
  the int32 words the engine uploads;
* ``sample``/``accept_resample``: packed and dense masks give the same
  tokens exactly, greedy rows equal to JAX's;
* serving on the JAX tests' config (vocab 64, d_model 32, 2 layers, 2
  heads, max_seq 48, f32, bridged weights), dense and paged: greedy
  constrained tokens exact against JAX's scheduler (through
  ``CopyingJaxEngine``, ROADMAP C1) and against an eager masked-argmax
  oracle, plain, with speculation (a draft that is always right, and one
  that is always illegal: ``grammar_rejected_tokens`` equal to JAX's) and
  chunked; submit rejections by JAX's messages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtdl_tpu.serve import Request as JaxRequest
from dtdl_tpu.serve import Scheduler as JaxScheduler
from dtdl_tpu.serve.sampling import accept_resample as jax_accept_resample
from dtdl_tpu.serve.sampling import pack_mask as jax_pack_mask
from dtdl_tpu.serve.sampling import sample as jax_sample
from dtdl_tpu.serve.tenant import grammar as jg
from dtdl_tpu_torch.serve import (InferenceEngine, Request, Scheduler,
                                  accept_resample, byte_vocab,
                                  compile_json_schema, compile_regex,
                                  mask_words, pack_mask, sample, unpack_mask)
from dtdl_tpu_torch.serve.tenant import json_schema_to_regex
from test_torch_chunked import CopyingJaxEngine, jax_pair

torch.set_num_threads(1)

MAX_SEQ = 48
PAGE = 4
BUCKETS = (8, 16, 32, MAX_SEQ)
CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, d_ff=64,
           max_seq=MAX_SEQ)
EOS = 63
DIGITS = set(range(48, 58))     # byte_vocab(64) covers ASCII 0-63
GEOMETRY = {"dense": {"page_size": 0},
            "paged": {"page_size": PAGE, "n_pages": 40}}

SCHEMA_A = {"type": "object", "properties": {"a": {"type": "integer"}},
            "required": ["a"]}
SCHEMA_MIX = {"type": "object", "properties": {
    "n": {"type": "number"}, "ok": {"type": "boolean"},
    "tag": {"enum": ["x", 1, None]}, "xs": {"type": "array",
                                            "items": {"type": "null"}},
    "s": {"type": "string"}}}


def _same_dfa(got, want):
    assert got.n_states == want.n_states and got.start == want.start
    assert got.eos_id == want.eos_id and got.pattern == want.pattern
    np.testing.assert_array_equal(got.trans, want.trans)
    np.testing.assert_array_equal(got.allow, want.allow)
    np.testing.assert_array_equal(got.accept, want.accept)
    assert got.nbytes() == want.nbytes()


@pytest.mark.parametrize("pattern,vocab", [
    (r"\d\d", 64), (r"\d+", 64), (r"[a-c]+x?", 128), (r"(ab|cd)*e", 128),
    (r"-?[1-9][0-9]*(\.[0-9]+)?", 128), (r"[^\d]\w\s.", 128),
])
def test_regex_dfa_matches_jax(pattern, vocab):
    eos = vocab - 1
    _same_dfa(compile_regex(pattern, byte_vocab(vocab), eos),
              jg.compile_regex(pattern, jg.byte_vocab(vocab), eos))


@pytest.mark.parametrize("schema", [SCHEMA_A, SCHEMA_MIX],
                         ids=["object", "mixed"])
def test_json_schema_dfa_matches_jax(schema):
    assert json_schema_to_regex(schema) == jg.json_schema_to_regex(schema)
    got = compile_json_schema(schema, byte_vocab(128), 127)
    _same_dfa(got, jg.compile_json_schema(schema, jg.byte_vocab(128), 127))
    assert got.step(got.start, ord("{")) >= 0
    assert got.step(got.start, ord("x")) == -1


def test_dfa_walk_masks_and_eos():
    """The JAX unit pins: \\d\\d legalizes EOS only after two digits, \\d+
    allows digits and EOS in its accept state."""
    dfa = compile_regex(r"\d\d", byte_vocab(64), eos_id=EOS)
    assert {t for t in range(64) if dfa.mask(dfa.start)[t]} == DIGITS
    q2 = dfa.walk([48, 57])
    assert dfa.accept[q2] and {t for t in range(64)
                               if dfa.mask(q2)[t]} == {EOS}
    assert dfa.walk([48, 7]) == -1 and dfa.step(dfa.start, EOS) == -1
    plus = compile_regex(r"\d+", byte_vocab(64), eos_id=EOS)
    qa = plus.walk([50])
    assert {t for t in range(64) if plus.mask(qa)[t]} == DIGITS | {EOS}


@pytest.mark.parametrize("bad", ["(ab", "a{2}", "*a", "[ab", "ab)", "z"])
def test_compile_errors_match_jax(bad):
    with pytest.raises(ValueError) as want:
        jg.compile_regex(bad, jg.byte_vocab(64), EOS)
    with pytest.raises(ValueError) as got:
        compile_regex(bad, byte_vocab(64), EOS)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="unsupported schema"):
        json_schema_to_regex({"type": "date"})


@pytest.mark.parametrize("vocab", [31, 32, 33, 64, 100])
def test_pack_mask_words_match_jax(vocab):
    rng = np.random.default_rng(vocab)
    allowed = rng.random((3, 2, vocab)) < 0.5
    allowed[0, 0] = True                       # every bit, 31 included
    got = pack_mask(allowed)
    want = jax_pack_mask(allowed)
    assert got.dtype == np.uint32 and got.shape == (3, 2, mask_words(vocab))
    np.testing.assert_array_equal(got, want)
    assert got[0, 0, 0] == 0xFFFFFFFF if vocab >= 32 else True
    assert pack_mask(got) is got               # packed passes through


@pytest.mark.parametrize("vocab", [33, 70])
def test_unpack_mask_round_trip(vocab):
    rng = np.random.default_rng(1)
    allowed = rng.random((4, vocab)) < 0.5
    allowed[:, 31] = [True, False, True, False]      # the sign bit
    words = pack_mask(allowed)
    as_i32 = torch.from_numpy(words.view(np.int32))
    assert (as_i32[0, 0] < 0) == bool(allowed[0, 31])
    np.testing.assert_array_equal(unpack_mask(as_i32, vocab).numpy(),
                                  allowed)


def _masks(rng, shape, vocab):
    m = rng.random(shape + (vocab,)) < 0.3
    m[..., rng.integers(0, vocab)] = True      # never an empty row
    return m


def test_sample_packed_and_dense_alike():
    """Greedy rows: the masked argmax, packed = dense = JAX's.  Sampled
    rows: the same generator state gives the same draws from a packed
    and a dense mask, and never a refused token."""
    vocab, B = 70, 6
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(B, vocab)).astype(np.float32)
    allowed = _masks(rng, (B,), vocab)
    packed = torch.from_numpy(pack_mask(allowed).view(np.int32))
    dense = torch.from_numpy(allowed)
    zeros = torch.zeros(B)
    tk, tp = torch.zeros(B, dtype=torch.int32), torch.ones(B)
    lg = torch.from_numpy(logits)
    g_dense = sample(lg, None, zeros, tk, tp, allowed=dense)
    g_packed = sample(lg, None, zeros, tk, tp, allowed=packed)
    want = jax_sample(jnp.asarray(logits), jax.random.PRNGKey(0),
                      jnp.zeros(B), jnp.zeros(B, jnp.int32), jnp.ones(B),
                      allowed=jnp.asarray(jax_pack_mask(allowed)))
    assert torch.equal(g_dense, g_packed)
    np.testing.assert_array_equal(g_dense.numpy(), np.asarray(want))
    temp = torch.full((B,), 0.8)
    draws = []
    for mask in (dense, packed):
        gen = torch.Generator().manual_seed(5)
        draws.append(sample(lg, gen, temp,
                            torch.full((B,), 5, dtype=torch.int32),
                            torch.full((B,), 0.9), allowed=mask))
    assert torch.equal(draws[0], draws[1])
    assert all(allowed[b, int(t)] for b, t in enumerate(draws[0]))


def test_accept_resample_packed_and_dense_alike():
    vocab, B, k = 40, 4, 3
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(B, k + 1, vocab)).astype(np.float32)
    allowed = _masks(rng, (B, k + 1), vocab)
    draft = rng.integers(0, vocab, (B, k)).astype(np.int32)
    # half the drafts are the masked argmax, so some get accepted
    masked = np.where(allowed, logits, -np.inf).argmax(-1)
    draft[:2] = masked[:2, :k]
    dl = np.array([3, 2, 3, 0], np.int32)
    zeros, ones = np.zeros(B, np.float32), np.ones(B, np.float32)
    want = jax_accept_resample(
        jnp.asarray(logits), jnp.asarray(draft), jnp.asarray(dl),
        jax.random.PRNGKey(0), jnp.asarray(zeros), jnp.zeros(B, jnp.int32),
        jnp.asarray(ones), allowed=jnp.asarray(jax_pack_mask(allowed)))
    outs = []
    for mask in (torch.from_numpy(allowed),
                 torch.from_numpy(pack_mask(allowed).view(np.int32))):
        outs.append(accept_resample(
            torch.from_numpy(logits), torch.from_numpy(draft),
            torch.from_numpy(dl), None, zeros, np.zeros(B, np.int32), ones,
            allowed=mask))
    for got in outs:
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert int(outs[0][1][0]) == 3


@pytest.fixture(scope="module")
def models():
    return jax_pair(**CFG)


@pytest.fixture(scope="module")
def engines(models):
    jm, params, tm = models
    return {kind: (CopyingJaxEngine(jm, params, n_slots=2, buckets=BUCKETS,
                                    paged_kernel=False, **geo),
                   InferenceEngine(tm, n_slots=2, buckets=BUCKETS,
                                   device="cpu", **geo))
            for kind, geo in GEOMETRY.items()}


def ref_constrained(tm, prompt, n_new, dfa):
    """Eager masked oracle: the cacheless forward's last logits, masked
    by the automaton's state, argmax, one token at a time."""
    q, out, seq = dfa.start, [], list(prompt)
    with torch.no_grad():
        for _ in range(n_new):
            lg = tm(torch.tensor([seq]))[0, -1].numpy()
            t = int(np.argmax(np.where(dfa.mask(q), lg, -np.inf)))
            out.append(t)
            q = dfa.step(q, t)
            assert q >= 0
            seq.append(t)
            if t == EOS:
                break
    return out


class OracleDraft:
    """Drafts exactly the known continuation (every proposal right)."""

    def __init__(self, prompt, tokens):
        self.p, self.full = list(prompt), list(prompt) + list(tokens)

    def propose(self, ctx, k):
        ctx = [int(t) for t in np.asarray(ctx)]
        if ctx == self.full[:len(ctx)]:
            return np.asarray(self.full[len(ctx):len(ctx) + k], np.int32)
        return np.zeros((0,), np.int32)


class GarbageDraft:
    """Proposes token 5 forever, never a digit: every draft is trimmed."""

    def propose(self, ctx, k):
        return np.full((k,), 5, np.int32)


@pytest.mark.parametrize("mode", ["plain", "oracle", "garbage", "chunked"])
@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_constrained_serving_matches_jax_and_oracle(models, engines, kind,
                                                    mode):
    """A \\d+ request beside a free one: the constrained tokens equal the
    eager masked oracle's and JAX's, the free ones JAX's;
    ``grammar_rejected_tokens`` equals JAX's; the chunked prompt's final
    chunk draws the first token masked."""
    _, _, tm = models
    jeng, eng = engines[kind]
    dfa = compile_regex(r"\d+", byte_vocab(64), eos_id=EOS)
    jdfa = jg.compile_regex(r"\d+", jg.byte_vocab(64), eos_id=EOS)
    rng = np.random.default_rng(11)
    prompt = (rng.integers(0, 64, 14).tolist() if mode == "chunked"
              else [7, 2, 11])
    free = rng.integers(0, 64, 9).tolist()
    ref = ref_constrained(tm, prompt, 10, dfa)
    kw, jkw, spec = {}, {}, 0
    if mode == "oracle":
        kw["draft"] = OracleDraft(prompt, ref)
        jkw["draft"] = OracleDraft(prompt, ref)
        spec = 4
    elif mode == "garbage":
        kw["draft"], jkw["draft"], spec = GarbageDraft(), GarbageDraft(), 4
    elif mode == "chunked":
        kw["chunk_tokens"] = jkw["chunk_tokens"] = 4
    jsched = JaxScheduler(jeng, harvest_lag=3, **jkw)
    jreqs = jsched.run([JaxRequest(prompt, 10, eos_id=EOS, grammar=jdfa,
                                   speculate=spec),
                        JaxRequest(free, 7)])
    sched = Scheduler(eng, harvest_lag=3, device="cpu", **kw)
    got = sched.submit(Request(prompt, 10, eos_id=EOS, grammar=dfa,
                               speculate=spec))
    other = sched.submit(Request(free, 7))
    sched.run()
    jgot, jother = sorted(jreqs, key=lambda r: r.rid)
    assert got.error is None and other.error is None
    assert got.tokens == ref == jgot.tokens
    assert other.tokens == jother.tokens
    body = got.tokens[:-1] if got.tokens[-1] == EOS else got.tokens
    assert body and all(t in DIGITS for t in body)
    s, js = sched.metrics.summary(), jsched.metrics.summary()
    assert s["grammar_rejected_tokens"] == js["grammar_rejected_tokens"]
    if mode == "oracle":
        assert s["spec_steps"] > 0 and s["spec_accepted_tokens"] > 0
    if mode == "garbage":
        assert s["grammar_rejected_tokens"] > 0
    if mode == "chunked":
        assert s["prefill_chunks"] == js["prefill_chunks"] >= 2


def test_constrained_mask_forces_termination(engines):
    """After \\d\\d only EOS is legal: three tokens whatever the budget."""
    _, eng = engines["paged"]
    dfa = compile_regex(r"\d\d", byte_vocab(64), eos_id=EOS)
    r = Scheduler(eng, harvest_lag=2, device="cpu").run(
        [Request([5, 3], 12, eos_id=EOS, grammar=dfa)])[0]
    assert r.error is None and len(r.tokens) == 3 and r.tokens[-1] == EOS
    assert all(t in DIGITS for t in r.tokens[:2])


def test_submit_rejections_match_jax(engines):
    jeng, eng = engines["dense"]
    cases = [({}, r"\d", 64), ({"eos_id": 7}, r"\d", 64),
             ({"eos_id": EOS}, r"\d", 128)]
    for kw, pattern, vocab in cases:
        j = JaxScheduler(jeng).submit(JaxRequest(
            [1, 2], 4, grammar=jg.compile_regex(pattern, jg.byte_vocab(vocab),
                                                EOS), **kw))
        r = Scheduler(eng, device="cpu").submit(Request(
            [1, 2], 4, grammar=compile_regex(pattern, byte_vocab(vocab), EOS),
            **kw))
        assert r.error.startswith("rejected:") and r.error == j.error
