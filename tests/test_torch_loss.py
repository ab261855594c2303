"""The port's loss ops against dtdl_tpu/ops/cross_entropy.py, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: f32 rtol 1e-6 on per-example losses (the same log-sum-exp,
summation order aside); the chunked LM loss, a sum over every token, and
its gradients atol 1e-5 + rtol 1e-5 (the chunked recurrence rescales the
running sum per chunk, so the last bits differ with the chunk order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtdl_tpu.ops import cross_entropy as jce
from dtdl_tpu_torch.ops import cross_entropy as tce

# small shapes: one intra-op thread each leaves the cores to the other
# test workers
torch.set_num_threads(1)


def _logits(seed, b=12, c=37):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, c)) * 3).astype(np.float32), \
        rng.integers(0, c, b).astype(np.int32)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_softmax_cross_entropy_matches_jax(reduction):
    logits, labels = _logits(0)
    want = np.asarray(jce.softmax_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels), reduction=reduction))
    got = tce.softmax_cross_entropy(torch.from_numpy(logits),
                                    torch.from_numpy(labels),
                                    reduction=reduction).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_softmax_cross_entropy_refuses_unknown_reduction():
    logits, labels = _logits(1)
    with pytest.raises(ValueError, match="reduction"):
        tce.softmax_cross_entropy(torch.from_numpy(logits),
                                  torch.from_numpy(labels), reduction="avg")


def test_accuracy_matches_jax_with_ties():
    """argmax takes the first of tied maxima in both frameworks."""
    logits, labels = _logits(2)
    logits[3, :] = 1.0                       # a row of ties -> class 0
    labels[3] = 0
    logits[5, [4, 9]] = 50.0                 # tie between 4 and 9 -> 4
    labels[5] = 9
    want = float(jce.accuracy(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(tce.accuracy(torch.from_numpy(logits),
                             torch.from_numpy(labels)))
    assert got == want


# (V, chunk): a slid-back last chunk (256 = 96 + 96 + 64, the last window
# slides back to 160 and masks 32 columns), even chunks, one chunk, and a
# chunk that does not divide a prime-ish vocab
CHUNK_CASES = [(256, 96), (256, 64), (100, 100), (53, 7)]


@pytest.mark.parametrize("V,chunk", CHUNK_CASES)
def test_chunked_lm_loss_and_grads_match_jax(V, chunk):
    """loss_sum, correct_sum, and the VJP (dh, demb, dmask) for the
    cotangents (g_loss, g_correct) against the JAX custom VJP."""
    T, D = 24, 16
    rng = np.random.default_rng(V + chunk)
    h = rng.normal(size=(T, D)).astype(np.float32)
    emb = (rng.normal(size=(V, D)) * 0.5).astype(np.float32)
    targets = rng.integers(0, V, T).astype(np.int32)
    targets[:4] = np.argmax(h[:4] @ emb.T, -1)          # some argmax hits
    mask = (rng.random(T) > 0.2).astype(np.float32)
    cot = (np.float32(0.7), np.float32(-0.3))

    jt = jnp.asarray(targets)
    (jl, jc), vjp = jax.vjp(
        lambda h, e, m: jce.chunked_lm_loss(h, e, jt, m, chunk),
        jnp.asarray(h), jnp.asarray(emb), jnp.asarray(mask))
    jdh, jdemb, jdmask = vjp(tuple(jnp.asarray(c) for c in cot))

    th, temb, tmask = (torch.from_numpy(x).requires_grad_()
                       for x in (h, emb, mask))
    tl, tc = tce.chunked_lm_loss(th, temb, torch.from_numpy(targets), tmask,
                                 chunk)
    tdh, tdemb, tdmask = torch.autograd.grad(
        (tl, tc), (th, temb, tmask), tuple(torch.tensor(c) for c in cot))
    kw = dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(tl.detach()), float(jl), **kw)
    assert float(tc.detach()) == float(jc) and float(tc.detach()) >= 1.0
    for got, want in ((tdh, jdh), (tdemb, jdemb), (tdmask, jdmask)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **kw)


def test_chunked_lm_loss_equals_the_dense_loss():
    """The chunked recurrence against the plain masked-sum cross entropy
    on the same f32 logits, value and gradients, in the port alone."""
    T, D, V = 20, 8, 90
    rng = np.random.default_rng(4)
    h = torch.tensor(rng.normal(size=(T, D)), dtype=torch.float32,
                     requires_grad=True)
    emb = torch.tensor(rng.normal(size=(V, D)), dtype=torch.float32,
                       requires_grad=True)
    targets = torch.tensor(rng.integers(0, V, T))
    mask = torch.tensor((rng.random(T) > 0.3).astype(np.float32))
    loss, _ = tce.chunked_lm_loss(h, emb, targets, mask, 32)
    g = torch.autograd.grad(loss, (h, emb))
    dense = (tce.softmax_cross_entropy(h @ emb.t(), targets, "none")
             * mask).sum()
    g_dense = torch.autograd.grad(dense, (h, emb))
    torch.testing.assert_close(loss, dense, atol=1e-5, rtol=1e-5)
    for a, b in zip(g, g_dense):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
