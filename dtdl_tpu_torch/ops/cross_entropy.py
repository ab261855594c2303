"""Classification and LM loss ops, the port of dtdl_tpu/ops/cross_entropy.py.

Plain torch ops, as the JAX module is plain jnp (no Pallas kernel):

* :func:`softmax_cross_entropy` and :func:`accuracy` from integer labels;
* :func:`chunked_lm_loss`, the masked-sum LM cross entropy with the vocab
  axis processed in chunks: an online (max, sumexp) recurrence over
  [tokens, chunk] f32 logit tiles, so the [tokens, vocab] logits never
  exist at once, and a backward that recomputes each tile from the saved
  (h, lse).  When the last chunk would run past the vocab it slides back
  to keep one tile width, and the columns the previous chunk covered are
  masked out (``valid``).
"""

from __future__ import annotations

import torch


def softmax_cross_entropy(logits, labels, reduction: str = "mean"):
    """Cross entropy from integer labels; logits (B, C), labels (B,)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    true_logit = logits.gather(-1, labels[:, None].long())[:, 0]
    losses = lse - true_logit
    if reduction == "mean":
        return losses.mean()
    if reduction == "sum":
        return losses.sum()
    if reduction == "none":
        return losses
    raise ValueError(f"unknown reduction {reduction!r}")


def accuracy(logits, labels):
    """Fraction of argmax predictions matching integer labels."""
    return (logits.argmax(-1) == labels).float().mean()


def _ce_chunks(V: int, chunk_size: int) -> tuple[int, int]:
    vc = min(max(int(chunk_size), 1), V)
    return -(-V // vc), vc


def _chunk_logits(h32, emb, c: int, vc: int, V: int):
    """f32 logits of vocab chunk c: ([T, vc], global column ids, valid
    mask, the chunk's first row of ``emb``).  A last chunk that would run
    past V slides back to V - vc; columns the previous chunk covered come
    back ``valid=False`` with their logits at -inf."""
    start = c * vc
    base = min(start, V - vc)
    cols = torch.arange(base, base + vc, device=h32.device)
    valid = cols >= start
    logits = h32 @ emb[base:base + vc].float().t()
    logits = logits.masked_fill(~valid[None, :], float("-inf"))
    return logits, cols, valid, base


class _ChunkedLMLoss(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h, emb, targets, mask, chunk_size):
        V = emb.shape[0]
        n, vc = _ce_chunks(V, chunk_size)
        T = h.shape[0]
        h32 = h.float()
        tgt = targets.long()
        dev = h.device
        m = torch.full((T,), float("-inf"), device=dev)
        s = torch.zeros(T, device=dev)
        true_l = torch.zeros(T, device=dev)
        best = torch.full((T,), float("-inf"), device=dev)
        arg = torch.zeros(T, dtype=torch.long, device=dev)
        for c in range(n):
            logits, cols, valid, _ = _chunk_logits(h32, emb, c, vc, V)
            cmax = logits.max(-1).values
            m_new = torch.maximum(m, cmax)
            s = (s * torch.exp(m - m_new)
                 + torch.exp(logits - m_new[:, None]).sum(-1))
            hit = (tgt[:, None] == cols[None, :]) & valid[None, :]
            true_l = true_l + torch.where(hit, logits, 0.0).sum(-1)
            carg = cols[logits.argmax(-1)]
            arg = torch.where(cmax > best, carg, arg)
            best = torch.maximum(best, cmax)
            m = m_new
        lse = m + torch.log(s)
        mask32 = mask.float()
        loss = ((lse - true_l) * mask32).sum()
        correct = ((arg == tgt).float() * mask32).sum()
        ctx.save_for_backward(h, emb, tgt, mask32, lse, true_l, arg)
        ctx.chunk_size = chunk_size
        return loss, correct

    @staticmethod
    def backward(ctx, g_loss, g_correct):
        h, emb, tgt, mask, lse, true_l, arg = ctx.saved_tensors
        V, _ = emb.shape
        n, vc = _ce_chunks(V, ctx.chunk_size)
        h32 = h.float()
        w = mask * g_loss
        dh = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
        demb = torch.zeros(emb.shape, dtype=torch.float32, device=h.device)
        for c in range(n):
            logits, cols, valid, base = _chunk_logits(h32, emb, c, vc, V)
            p = torch.where(valid[None, :], torch.exp(logits - lse[:, None]),
                            0.0)
            onehot = ((tgt[:, None] == cols[None, :])
                      & valid[None, :]).float()
            dl = (p - onehot) * w[:, None]                    # [T, vc]
            dh += dl @ emb[base:base + vc].float()
            # the overlap columns of a slid-back last tile add zeros
            demb[base:base + vc] += dl.t() @ h32
        # the loss term and the correct_sum output's own mask cotangent
        # (argmax hits are piecewise constant in h and emb: no grad there)
        dmask = (lse - true_l) * g_loss + (arg == tgt).float() * g_correct
        return dh.to(h.dtype), demb.to(emb.dtype), None, dmask, None


def chunked_lm_loss(h, emb, targets, mask, chunk_size: int = 4096):
    """Masked-sum LM cross entropy with the vocab processed in chunks.

    ``h`` [T, D] final hidden states, ``emb`` [V, D] tied output
    embedding, ``targets`` [T] int, ``mask`` [T] f32.  Returns
    ``(loss_sum, correct_sum)``, where correct counts masked argmax ==
    target hits.  Differentiable in ``h``, ``emb`` and ``mask``; the
    targets get no gradient."""
    return _ChunkedLMLoss.apply(h, emb, targets, mask, chunk_size)
