"""The port's ops against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.  On
CPU tensors the port's kernel wrappers run their plain versions, so these
tests pin the arithmetic the CUDA kernels are in turn held to on the card
(chip_smoke.py).  The JAX side runs its Pallas kernels in interpret mode,
as the JAX package's own tests do.

Tolerances: f32 atol 2e-6 for rope and attention (the JAX kernel tests'
own bound: summation order and online vs one-shot softmax); attention
gradients f32 atol 5e-5 + rtol 1e-4 (the JAX gradient tests' own) and
bf16 within 1% of each gradient's largest magnitude (BF16_GRAD_SHARE);
sampling keep-sets
exactly equal, kept values rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtdl_tpu.ops import attention as jattn
from dtdl_tpu.ops import rope as jrope
from dtdl_tpu.ops.paged_attention import paged_attention as jax_paged
from dtdl_tpu.quant import kv_quantize
from dtdl_tpu.serve import sampling as jsamp
from dtdl_tpu_torch.ops import attention as tattn
from dtdl_tpu_torch.ops import rope as trope
from dtdl_tpu_torch.ops.paged_attention import (paged_attention,
                                                paged_attention_reference)
from dtdl_tpu_torch.serve import sampling as tsamp

# small shapes: one intra-op thread each leaves the cores to the other
# test workers
torch.set_num_threads(1)

ATOL = 2e-6


def _t(x):
    return torch.from_numpy(np.array(x))


def _qkv(seed, b, h, sq, sk, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, h, s, d)).astype(np.float32)
                 for s in (sq, sk, sk))


# ---------------------------------------------------------------------------
# rope
# ---------------------------------------------------------------------------

def test_rope_tables_and_rows_match_jax():
    jc, js = jrope.rope_frequencies(16, 64)
    tc, ts = trope.rope_frequencies(16, 64)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=ATOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=ATOL)
    pos = np.asarray([0, 5, 63, 17], np.int32)
    for jr, tr in zip(jrope.rope_rows(jc, js, jnp.asarray(pos)),
                      trope.rope_rows(tc, ts, _t(pos).long())):
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=ATOL)


@pytest.mark.parametrize("mode", ["offset0", "offset", "positions"])
def test_apply_rope_matches_jax(mode):
    x = np.random.default_rng(0).normal(size=(2, 3, 12, 16)).astype(
        np.float32)
    jc, js = jrope.rope_frequencies(16, 64)
    tc, ts = trope.rope_frequencies(16, 64)
    kw_j, kw_t = {}, {}
    if mode == "offset":
        kw_j = kw_t = {"offset": 7}
    elif mode == "positions":
        pos = np.random.default_rng(1).permutation(64)[:12].astype(np.int32)
        kw_j, kw_t = {"positions": jnp.asarray(pos)}, {
            "positions": _t(pos).long()}
    want = jrope.apply_rope(jnp.asarray(x), jc, js, **kw_j)
    got = trope.apply_rope(_t(x), tc, ts, **kw_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_apply_rope_per_row_positions():
    """[B, S] positions rotate each row at its own offsets, as the JAX
    paged attend does with a vmap over rows."""
    x = np.random.default_rng(2).normal(size=(3, 2, 4, 16)).astype(
        np.float32)
    jc, js = jrope.rope_frequencies(16, 64)
    tc, ts = trope.rope_frequencies(16, 64)
    offs = [0, 9, 40]
    pos = np.asarray([np.arange(o, o + 4) for o in offs])
    got = trope.apply_rope(_t(x), tc, ts, positions=_t(pos).long())
    for b, o in enumerate(offs):
        want = jrope.apply_rope(jnp.asarray(x[b:b + 1]), jc, js, offset=o)
        np.testing.assert_allclose(got[b:b + 1].numpy(), np.asarray(want),
                                   atol=ATOL)


# ---------------------------------------------------------------------------
# dense and flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", [(32, 32), (24, 56)])
def test_mha_reference_matches_jax(causal, sq, sk):
    q, k, v = _qkv(3, 2, 2, sq, sk, 16)
    want = jattn.mha_reference(*map(jnp.asarray, (q, k, v)), causal=causal)
    got = tattn.mha_reference(*map(_t, (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


# (name, sq, sk, causal, rope): self, cross, ragged (odd lengths) and
# fused rope, at seq <= 64 where the Pallas interpreter is quick
FLASH_CASES = [
    ("self-causal", 64, 64, True, None),
    ("self", 64, 64, False, None),
    ("cross-causal", 24, 56, True, None),
    ("cross", 24, 56, False, None),
    ("ragged-causal", 40, 40, True, None),
    ("rope-causal", 48, 48, True, "default"),
    ("rope-cross", 20, 44, False, "default"),
    ("rope-positions", 32, 32, True, "explicit"),
]


@pytest.mark.parametrize("name,sq,sk,causal,rope", FLASH_CASES,
                         ids=[c[0] for c in FLASH_CASES])
def test_flash_attention_matches_jax_kernel(name, sq, sk, causal, rope):
    """flash_attention_reference and the port's flash_attention (whose
    CPU path is the kernel's plain version) against the JAX Pallas
    kernel under the interpreter."""
    d = 16
    q, k, v = _qkv(4, 2, 2, sq, sk, d)
    jkw, tkw = {}, {}
    if rope is not None:
        jc, js = jrope.rope_frequencies(d, 128)
        tc, ts = trope.rope_frequencies(d, 128)
        jkw["rope"], tkw["rope"] = (jc, js), (tc, ts)
        if rope == "explicit":
            rng = np.random.default_rng(5)
            pq = np.sort(rng.permutation(128)[:sq]).astype(np.int32)
            pk = np.sort(rng.permutation(128)[:sk]).astype(np.int32)
            jkw["rope_positions"] = (jnp.asarray(pq), jnp.asarray(pk))
            tkw["rope_positions"] = (_t(pq).long(), _t(pk).long())
    want = np.asarray(jattn.flash_attention(
        *map(jnp.asarray, (q, k, v)), causal=causal, **jkw))
    ref_o, ref_lse = tattn.flash_attention_reference(
        *map(_t, (q, k, v)), causal=causal, **tkw)
    np.testing.assert_allclose(ref_o.numpy(), want, atol=ATOL)
    got = tattn.flash_attention(*map(_t, (q, k, v)), causal=causal, **tkw)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    assert ref_lse.shape == (2, 2, sq)


def test_flash_fwd_lse_matches_jax_forward():
    """The lse the kernel writes for the backward slice: the lse of the
    JAX forward (``_fwd``, [B·H, 1, Sq]) against the port's [B·H, Sq]."""
    q, k, v = _qkv(6, 1, 2, 48, 48, 16)
    qf, kf, vf = (x.reshape(2, 48, 16) for x in (q, k, v))
    _, jlse = jattn._fwd(*map(jnp.asarray, (qf, kf, vf)), None, 0.25,
                         True, 48, 48)
    _, tlse = tattn.flash_fwd(*map(_t, (qf, kf, vf)), None, scale=0.25,
                              causal=True)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse)[:, 0],
                               atol=ATOL)


# (name, sq, sk, causal, rope, jax blocks): self, cross 160/320 and ragged
# 200 over 128-row JAX tiles (as tests/test_attention.py runs them), fused
# rope at default and explicit positions, and causal with sq > sk, whose
# first rows see no key (JAX then computes them in one tile, as the plain
# version does: lse = -1e30 and p = 1 against every masked key)
GRAD_CASES = [
    ("self-causal", 64, 64, True, None, None),
    ("self", 64, 64, False, None, None),
    ("cross-causal", 160, 320, True, None, 128),
    ("cross", 160, 320, False, None, 128),
    ("ragged-causal", 200, 200, True, None, 128),
    ("ragged", 200, 200, False, None, 128),
    ("rope-causal", 48, 48, True, "default", None),
    ("rope-cross", 20, 44, False, "default", None),
    ("rope-positions", 32, 32, True, "explicit", None),
    ("sq>sk-causal", 72, 40, True, None, None),
]
GRAD_ATOL, GRAD_RTOL = 5e-5, 1e-4          # the JAX gradient tests' own
# bf16: within 1% of the gradient's largest magnitude, about 2.5 bf16 units
# in the last place there: the grads are rounded to bf16, and ds/p are
# rounded to bf16 before their products, where f32 scores that differ in
# the last bits (summation order) can round the other way; where a sum of
# such terms cancels, the difference is of the size of the terms, not of
# the result (the sq > sk rows sum p = 1 over every key)
BF16_GRAD_SHARE = 1e-2


def _grads_both(name, sq, sk, causal, rope, blocks, *, dtype=np.float32,
                d=16):
    """dq, dk, dv with cotangent dO from the JAX flash_attention (Pallas
    K2/K3 under the interpreter) and from the port's flash_attention (the
    plain backward on the CPU), same numpy inputs."""
    q, k, v = _qkv(7, 1, 2, sq, sk, d)
    do = np.random.default_rng(8).normal(size=q.shape).astype(np.float32)
    jkw, tkw = {}, {}
    if blocks is not None:
        jkw.update(block_q=blocks, block_k=blocks)
    if rope is not None:
        jc, js = jrope.rope_frequencies(d, 128)
        tc, ts = trope.rope_frequencies(d, 128)
        jkw["rope"], tkw["rope"] = (jc, js), (tc, ts)
        if rope == "explicit":
            rng = np.random.default_rng(9)
            pq = np.sort(rng.permutation(128)[:sq]).astype(np.int32)
            pk = np.sort(rng.permutation(128)[:sk]).astype(np.int32)
            jkw["rope_positions"] = (jnp.asarray(pq), jnp.asarray(pk))
            tkw["rope_positions"] = (_t(pq).long(), _t(pk).long())
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    jargs = [jnp.asarray(x, jdt) for x in (q, k, v)]
    jdo = jnp.asarray(do, jdt)

    def loss(q, k, v):
        o = jattn.flash_attention(q, k, v, causal=causal, **jkw)
        return jnp.sum(o.astype(jnp.float32) * jdo.astype(jnp.float32))
    want = [np.asarray(g.astype(jnp.float32))
            for g in jax.grad(loss, (0, 1, 2))(*jargs)]
    targs = [_t(x).to(tdt).requires_grad_() for x in (q, k, v)]
    o = tattn.flash_attention(*targs, causal=causal, **tkw)
    got = torch.autograd.grad(o, targs, _t(do).to(tdt))
    assert all(g.dtype == tdt for g in got)
    return [g.float().numpy() for g in got], want


@pytest.mark.parametrize("name,sq,sk,causal,rope,blocks", GRAD_CASES,
                         ids=[c[0] for c in GRAD_CASES])
def test_flash_grads_match_jax_kernels(name, sq, sk, causal, rope, blocks):
    """f32: the port's backward (K2/K3's plain versions) against jax.grad
    through the JAX flash_attention, whose backward runs _bwd_dq_kernel
    and _bwd_dkv_kernel in the Pallas interpreter."""
    got, want = _grads_both(name, sq, sk, causal, rope, blocks)
    for g, w, which in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g, w, atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=f"{name} {which}")


@pytest.mark.parametrize("name,sq,sk,causal,rope,blocks",
                         [GRAD_CASES[0], GRAD_CASES[4], GRAD_CASES[6],
                          GRAD_CASES[9]],
                         ids=["self-causal", "ragged-causal", "rope-causal",
                              "sq>sk-causal"])
def test_flash_grads_bf16_match_jax_kernels(name, sq, sk, causal, rope,
                                            blocks):
    """bf16 inputs, bf16 gradients, against the JAX kernels in bf16."""
    got, want = _grads_both(name, sq, sk, causal, rope, blocks,
                            dtype="bf16", d=32)
    for g, w, which in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(
            g, w, atol=BF16_GRAD_SHARE * float(np.abs(w).max()), rtol=0,
            err_msg=f"{name} {which}")


def test_flash_bwd_reference_is_the_kernels_arithmetic():
    """flash_bwd_reference equals flash_bwd's two kernel wrappers (on the
    CPU, their per-kernel plain versions), and the rope rows get no
    gradient."""
    q, k, v = (_t(x).reshape(2, -1, 16) for x in _qkv(10, 1, 2, 24, 24, 16))
    do = torch.randn_like(q)
    tc, ts = trope.rope_frequencies(16, 64)
    tabs = trope.rope_rows(tc, ts, torch.arange(24)) * 2
    o, lse = tattn.flash_fwd(q, k, v, tabs, scale=0.25, causal=True)
    delta = (do * o).sum(-1)
    kw = dict(scale=0.25, causal=True)
    dq, dk, dv = tattn.flash_bwd_reference(q, k, v, do, lse, delta, tabs,
                                           **kw)
    torch.testing.assert_close(
        dq, tattn.flash_bwd_dq(q, k, v, do, lse, delta, tabs, **kw),
        rtol=0, atol=0)
    for a, b in zip((dk, dv), tattn.flash_bwd_dkv(q, k, v, do, lse, delta,
                                                  tabs, **kw)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    cos = tc.clone().requires_grad_()
    qg = q.reshape(1, 2, 24, 16).clone().requires_grad_()
    o = tattn.flash_attention(qg, qg, qg, rope=(cos, ts))
    o.sum().backward()
    assert qg.grad is not None and cos.grad is None


# ---------------------------------------------------------------------------
# paged attention
# ---------------------------------------------------------------------------

def _pool_case(seed, quant, *, nan_tail=False, b=3, h=2, n_ptab=4, page=8,
               d=16):
    """Random pool/table/pos geometry with slot 2 inactive (the geometry
    of tests/test_paged_kernel.py); with ``nan_tail`` every page past the
    active rows' live prefixes holds NaN (payload, and scales when
    quantized).  Returns numpy arrays."""
    rng = np.random.default_rng(seed)
    n_pages = b * n_ptab + 1
    kf = rng.normal(size=(n_pages, h, page, d)).astype(np.float32)
    vf = rng.normal(size=(n_pages, h, page, d)).astype(np.float32)
    table = 1 + rng.permutation(b * n_ptab).reshape(b, n_ptab).astype(
        np.int32)
    pos = np.asarray([5, 2 * page + 3, 0], np.int32)[:b]
    active = np.asarray([1, 1, 0], np.int32)[:b]
    dead = []
    if nan_tail:
        live = {0}
        for i in range(b):
            if active[i]:
                live.update(int(table[i, j])
                            for j in range((int(pos[i]) + page) // page))
        dead = [p for p in range(n_pages) if p not in live]
        kf[dead] = np.nan
        vf[dead] = np.nan
    ks = vs = None
    if quant:
        pk, ks = (np.asarray(a) for a in kv_quantize(jnp.asarray(kf)))
        pv, vs = (np.asarray(a) for a in kv_quantize(jnp.asarray(vf)))
        if nan_tail:
            ks, vs = ks.copy(), vs.copy()
            ks[dead] = np.nan
            vs[dead] = np.nan
    else:
        pk, pv = kf, vf
    return pk, pv, ks, vs, table, pos, active


def _both_paged(q, case, scale):
    pk, pv, ks, vs, table, pos, active = case
    want = jax_paged(jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
                     jnp.asarray(table), jnp.asarray(pos),
                     jnp.asarray(active), scale=scale,
                     key_scale=None if ks is None else jnp.asarray(ks),
                     value_scale=None if vs is None else jnp.asarray(vs))
    targs = dict(scale=scale, key_scale=None if ks is None else _t(ks),
                 value_scale=None if vs is None else _t(vs))
    return np.asarray(want), targs


@pytest.mark.parametrize("s_new", [1, 5])
@pytest.mark.parametrize("quant", [False, True])
def test_paged_reference_matches_jax_kernel(s_new, quant):
    case = _pool_case(0, quant)
    pk, pv, _, _, table, pos, active = case
    q = np.random.default_rng(1).normal(size=(3, 2, s_new, 16)).astype(
        np.float32)
    scale = 0.25
    want, targs = _both_paged(q, case, scale)
    args = (_t(q), _t(pk), _t(pv), _t(table), _t(pos), _t(active))
    ref = paged_attention_reference(*args, **targs)
    np.testing.assert_allclose(ref.numpy(), want, atol=ATOL)
    got = paged_attention(*args, **targs)        # CPU: the plain version
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    assert np.all(ref.numpy()[active == 0] == 0.0)


@pytest.mark.parametrize("quant", [False, True])
def test_paged_nan_tail_matches_jax_kernel(quant):
    """NaN in every dead page: the JAX kernel never loads them; the plain
    version (a gather of the whole table) on the clean pool gives the
    same output, which is what the CUDA kernel is held to on the card."""
    q = np.random.default_rng(3).normal(size=(3, 2, 1, 16)).astype(
        np.float32)
    want, _ = _both_paged(q, _pool_case(2, quant, nan_tail=True), 0.25)
    assert np.all(np.isfinite(want))
    pk, pv, ks, vs, table, pos, active = _pool_case(2, quant)
    got = paged_attention_reference(
        _t(q), _t(pk), _t(pv), _t(table), _t(pos), _t(active), scale=0.25,
        key_scale=None if ks is None else _t(ks),
        value_scale=None if vs is None else _t(vs))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_paged_scale_pairing_is_checked():
    pk, pv, ks, _, table, pos, active = _pool_case(0, True)
    q = torch.zeros(3, 2, 1, 16)
    with pytest.raises(ValueError, match="together"):
        paged_attention(q, _t(pk), _t(pv), _t(table), _t(pos), _t(active),
                        scale=0.25, key_scale=_t(ks))


# ---------------------------------------------------------------------------
# sampling keep-sets
# ---------------------------------------------------------------------------

def _three(logits, temp, top_k, top_p):
    args_j = (jnp.asarray(logits, jnp.float32), jnp.asarray(temp, jnp.float32),
              jnp.asarray(top_k, jnp.int32), jnp.asarray(top_p, jnp.float32))
    args_t = (torch.tensor(np.asarray(logits, np.float32)),
              torch.tensor(np.asarray(temp, np.float32)),
              torch.tensor(np.asarray(top_k, np.int32)),
              torch.tensor(np.asarray(top_p, np.float32)))
    return (np.asarray(jsamp.filter_logits(*args_j)),
            tsamp.filter_logits(*args_t).numpy(),
            tsamp.filter_logits_sorted(*args_t).numpy())


SAMPLING_CASES = {
    "random": (np.random.default_rng(0).normal(size=(5, 101)) * 3,
               [0.7, 1.0, 0.3, 2.0, 1e-3], [0, 5, 1, 17, 100],
               [0.9, 0.5, 0.3, 0.99, 0.7]),
    "topk-ties": (np.where(np.isin(np.arange(32), [3, 7, 11, 19, 23, 30]),
                           2.0, -5.0)[None], [1.0], [3], [1.0]),
    "topp-tie-boundary": (np.zeros((1, 4)), [1.0], [0], [0.6]),
    "first-token-survives": (np.asarray([[5.0, 0.0, -1.0, -2.0]]), [1.0],
                             [0], [0.01]),
    "disabled-knobs": (np.random.default_rng(1).normal(size=(3, 16)),
                       [1.0, 0.5, 2.0], [0, 99, 3], [1.0, 1.5, 0.8]),
    "negative-zero": (np.where(np.arange(8) % 2 == 0, -0.0, 0.0)[None],
                      [1.0], [3], [0.7]),
}


@pytest.mark.parametrize("name", list(SAMPLING_CASES))
def test_filter_logits_keep_sets(name):
    """Exact keep-sets against JAX's sortless filter and the port's own
    sorted oracle, ties included."""
    j, t, t_sorted = _three(*SAMPLING_CASES[name])
    for other in (j, t_sorted):
        np.testing.assert_array_equal(np.isneginf(t), np.isneginf(other))
        keep = ~np.isneginf(t)
        np.testing.assert_allclose(t[keep], other[keep], rtol=1e-6)


def test_desc_keys_match_jax_uint32_keys():
    """Equal keys to JAX's uint32 keys for normal floats, zeros and
    infinities (XLA on the CPU flushes subnormals to zero, torch keeps
    them, so subnormal logits are left out of the comparison)."""
    x = np.concatenate([np.random.default_rng(2).normal(size=64) * 50,
                        [0.0, -0.0, np.inf, -np.inf, 1e-30, -1e-30]]
                       ).astype(np.float32)
    want = np.asarray(jsamp._desc_keys(jnp.asarray(x))).astype(np.int64)
    got = tsamp._desc_keys(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    order = np.argsort(x, kind="stable")
    assert np.all(np.diff(got[order]) >= 0)


def test_sample_greedy_rows_and_keep_set_draws():
    """Greedy rows are the raw argmax; a sampled row only ever draws from
    its keep-set (the draws themselves use torch's generator, so they are
    compared as sets, never token for token)."""
    logits = torch.tensor(np.random.default_rng(4).normal(size=(2, 50)),
                          dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    temp = torch.tensor([0.0, 1.0])
    top_k = torch.tensor([0, 5], dtype=torch.int32)
    top_p = torch.tensor([1.0, 1.0])
    keep = ~torch.isneginf(tsamp.filter_logits(logits, temp, top_k, top_p))
    for _ in range(20):
        tok = tsamp.sample(logits, gen, temp, top_k, top_p)
        assert tok[0] == torch.argmax(logits[0])
        assert keep[1, tok[1]]


def test_pack_matches_jax():
    params = [tsamp.SampleParams(0.7, 5, 0.9), tsamp.GREEDY]
    jp = jsamp.pack([jsamp.SampleParams(0.7, 5, 0.9), jsamp.GREEDY])
    tp = tsamp.pack(params)
    for j, t in zip(jp, tp):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        assert t.numpy().dtype == np.asarray(j).dtype
    with pytest.raises(ValueError, match="top_p"):
        tsamp.SampleParams(top_p=0.0)
