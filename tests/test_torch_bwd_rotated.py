"""The flash backward's rotate-once convention, and the split rule of the
paged kernel, on the CPU.

On the card the bf16 K2 and K3 take q and k already rotated by the rope
pre-pass, run once for the pair by ``flash_bwd``, and use the rope tables
only for the inverse rotation of dq and dk.  Their plain versions take the
same convention with ``rotated=True``.  These tests hold it: fed the
pre-rotated rows, the plain K2 and K3 give the same dq, dk and dv as fed
the unrotated rows with the tables (bitwise: the same rotation, done
before instead of inside), and both agree with the JAX backward
(``dtdl_tpu/ops/attention.py:_bwd``, its Pallas kernels in the
interpreter) on the same residuals, f32, within the JAX gradient tests'
own atol 5e-5 + rtol 1e-4.

``kv_splits`` is held to its bounds from shapes alone.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtdl_tpu.ops import attention as jattn
from dtdl_tpu.ops import rope as jrope
from dtdl_tpu_torch.ops import attention as tattn
from dtdl_tpu_torch.ops import rope as trope
from dtdl_tpu_torch.ops.paged_attention import kv_splits

# small shapes: one intra-op thread each leaves the cores to the other
# test workers
torch.set_num_threads(1)

GRAD_ATOL, GRAD_RTOL = 5e-5, 1e-4          # the JAX gradient tests' own

# (name, sq, sk, causal): self, cross, ragged, and causal sq > sk, whose
# first rows see no key (one JAX tile holds them, as in test_torch_ops.py)
CASES = [
    ("self-causal", 48, 48, True),
    ("cross", 24, 56, False),
    ("ragged-causal", 40, 40, True),
    ("sq>sk-causal", 56, 24, True),
]
IDS = [c[0] for c in CASES]


def _inputs(seed, sq, sk, d=16, bh=2):
    rng = np.random.default_rng(seed)
    q, do = (rng.normal(size=(bh, sq, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(bh, sk, d)).astype(np.float32)
            for _ in range(2))
    return q, k, v, do


def _rope_rows_np(sq, sk, d):
    """The rope rows (qc, qs, kc, ks) at the default positions (keys from
    0, queries bottom-aligned), as numpy from the JAX tables."""
    cos, sin = jrope.rope_frequencies(d, 128)
    pos_k = np.arange(sk, dtype=np.int32)
    pos_q = np.clip(np.arange(sq) + sk - sq, 0, None).astype(np.int32)
    rows = (jrope.rope_rows(cos, sin, jnp.asarray(pos_q))
            + jrope.rope_rows(cos, sin, jnp.asarray(pos_k)))
    return [np.asarray(r) for r in rows]


def _residuals(q, k, v, tabs, scale, causal):
    """o and lse of the plain forward (rope rows applied), delta later."""
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    ttabs = tuple(torch.from_numpy(t) for t in tabs)
    return tattn.flash_fwd(tq, tk, tv, ttabs, scale=scale, causal=causal)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,sq,sk,causal", CASES, ids=IDS)
def test_plain_k2_k3_fed_rotated_rows_match_unrotated(dtype, name, sq, sk,
                                                      causal):
    """flash_bwd_*_reference(rotated=True) on the pre-pass's rows equals
    the unrotated call with the tables, bitwise, for dq, dk and dv; and
    flash_bwd (whose CPU path is the plain composition) gives the same."""
    d, scale = 16, 0.25
    q, k, v, do = (torch.from_numpy(x).to(dtype)
                   for x in _inputs(1, sq, sk, d))
    tabs = tuple(torch.from_numpy(t) for t in _rope_rows_np(sq, sk, d))
    o, lse = tattn.flash_fwd(q, k, v, tabs, scale=scale, causal=causal)
    delta = (do.float() * o.float()).sum(-1)
    kw = dict(scale=scale, causal=causal)
    want = tattn.flash_bwd_reference(q, k, v, do, lse, delta, tabs, **kw)
    qr = tattn.rope_rotate(q, tabs[0], tabs[1])
    kr = tattn.rope_rotate(k, tabs[2], tabs[3])
    got = tattn.flash_bwd_reference(qr, kr, v, do, lse, delta, tabs,
                                    rotated=True, **kw)
    public = tattn.flash_bwd(q, k, v, do, lse, delta, tabs, **kw)
    for g, p, w, which in zip(got, public, want, ("dq", "dk", "dv")):
        assert g.dtype == dtype, which
        assert torch.equal(g, w), which
        assert torch.equal(p, w), which


@pytest.mark.parametrize("name,sq,sk,causal", CASES, ids=IDS)
def test_rotated_backward_matches_jax_bwd(name, sq, sk, causal):
    """The plain K2 and K3 fed pre-rotated rows, and fed unrotated rows
    with the tables, against the JAX backward _bwd (Pallas K2/K3 in the
    interpreter, one tile) on the same residuals o, lse and dO, f32."""
    d, scale = 16, 0.25
    q, k, v, do = _inputs(2, sq, sk, d)
    tabs = _rope_rows_np(sq, sk, d)
    bq, bk = sq, sk                 # one JAX tile: see test_torch_ops.py
    jo, jlse = jattn._fwd(*map(jnp.asarray, (q, k, v)),
                          tuple(map(jnp.asarray, tabs)), scale, causal, bq,
                          bk)
    want = jattn._bwd(scale, causal, bq, bk,
                      (*map(jnp.asarray, (q, k, v)), jo, jlse),
                      jnp.asarray(do), tuple(map(jnp.asarray, tabs)))
    want = [np.asarray(w) for w in want]
    t = {n: torch.from_numpy(np.asarray(x)) for n, x in
         dict(q=q, k=k, v=v, do=do, o=jo).items()}
    lse = torch.from_numpy(np.asarray(jlse)[:, 0])
    delta = (t["do"] * t["o"]).sum(-1)
    ttabs = tuple(torch.from_numpy(x) for x in tabs)
    kw = dict(scale=scale, causal=causal)
    qr = tattn.rope_rotate(t["q"], ttabs[0], ttabs[1])
    kr = tattn.rope_rotate(t["k"], ttabs[2], ttabs[3])
    rotated = tattn.flash_bwd_reference(qr, kr, t["v"], t["do"], lse, delta,
                                        ttabs, rotated=True, **kw)
    unrotated = tattn.flash_bwd_reference(t["q"], t["k"], t["v"], t["do"],
                                          lse, delta, ttabs, **kw)
    for got in (rotated, unrotated):
        for g, w, which in zip(got, want, ("dq", "dk", "dv")):
            np.testing.assert_allclose(g.numpy(), w, atol=GRAD_ATOL,
                                       rtol=GRAD_RTOL,
                                       err_msg=f"{name} {which}")


def test_rotated_flag_without_tables_is_the_plain_backward():
    """Without rope, ``rotated`` changes nothing."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(3, 32, 32))
    o, lse = tattn.flash_fwd(q, k, v, None, scale=0.25, causal=True)
    delta = (do * o).sum(-1)
    kw = dict(scale=0.25, causal=True)
    for a, b in zip(tattn.flash_bwd_reference(q, k, v, do, lse, delta, None,
                                              **kw),
                    tattn.flash_bwd_reference(q, k, v, do, lse, delta, None,
                                              rotated=True, **kw)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("s_new", [1, 5, 16, 17, 512])
def test_kv_splits_bounds(s_new, sms):
    """Shapes only, at decode and verify windows and prefills, for batches
    of one slot up to ones that fill the card and tables of 1-128 pages:
    at least 1, never more ranges than the table's pages, at most 32
    (decode/verify) or 16 (prefill, 64-row tiles), 1 once the blocks fill
    the card twice over (a prefill at least 2 before that), and never
    more ranges for more rows."""
    cap, rows, fill = (32, 4, 2) if s_new <= 16 else (16, 64, 2)
    for b, h, n in itertools.product((1, 2, 8, 64), (1, 4, 8), (1, 3, 128)):
        got = kv_splits(b, h, s_new, n, sms)
        assert 1 <= got <= min(n, cap), (b, h, n)
        if b * h * -(-s_new // rows) >= fill * sms:
            assert got == 1, (b, h, n)
        elif s_new > 16:
            assert got >= min(2, n), (b, h, n)   # the longest walks halved
        assert kv_splits(2 * b, h, s_new, n, sms) <= got, (b, h, n)
