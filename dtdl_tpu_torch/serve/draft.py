"""Draft sources for speculative decoding, the port of
dtdl_tpu/serve/draft.py.

Speculative decoding splits generation into a cheap *draft* and one
batched *verify* (:meth:`InferenceEngine.verify`), which is lossless by
construction (:func:`~dtdl_tpu_torch.serve.sampling.accept_resample`), so
a draft source only has to guess what the model would say anyway, as
often and as cheaply as it can.  A bad draft costs throughput, never
correctness.

* :class:`NGramDraft`: prompt-lookup drafting.  The tokens that followed
  the most recent earlier occurrence of the context's trailing n-gram;
  pure numpy over the host token history the scheduler keeps.
* :class:`ModelDraft`: a small draft transformer sharing the target's
  vocab, run greedily over a trailing window of the context through
  :func:`~dtdl_tpu_torch.models.transformer.generate` (the dense decode
  cache, on the draft model's device).

The scheduler calls ``propose`` with its optimistic host context
(harvested tokens; the in-flight steps are skipped by its gap estimate),
never by reading the step still on the card.  ``propose`` may return fewer
than ``k`` tokens, or none: the slot then drafts shorter that step.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

import numpy as np
import torch


@runtime_checkable
class DraftSource(Protocol):
    """Anything that can guess the next tokens of a context."""

    def propose(self, ctx: np.ndarray, k: int) -> np.ndarray:
        """Up to ``k`` int32 tokens predicted to continue ``ctx`` (a 1-D
        int array of the sequence known so far).  Fewer, or none, means
        no confident guess: the caller drafts shorter."""
        ...  # pragma: no cover - protocol


class NGramDraft:
    """Prompt-lookup drafting: the continuation of the most recent earlier
    occurrence of the trailing n-gram, longest n first (``max_n`` down to
    ``min_n``)."""

    def __init__(self, max_n: int = 3, min_n: int = 1):
        if not 1 <= min_n <= max_n:
            raise ValueError(f"need 1 <= min_n <= max_n, got "
                             f"min_n={min_n} max_n={max_n}")
        self.max_n = max_n
        self.min_n = min_n

    def propose(self, ctx, k: int) -> np.ndarray:
        ctx = np.asarray(ctx, np.int32).ravel()
        L = ctx.size
        if L < 2 or k < 1:
            return np.zeros((0,), np.int32)
        for n in range(min(self.max_n, L - 1), self.min_n - 1, -1):
            pattern = ctx[L - n:]
            # windows ending strictly before the trailing pattern itself
            starts = np.arange(L - n)
            wins = ctx[starts[:, None] + np.arange(n)[None, :]]
            hits = np.nonzero((wins == pattern[None, :]).all(axis=1))[0]
            if hits.size:
                # the most recent hit with a full k-token continuation
                # (the scheduler's gap skip needs the length, and under
                # repetition an earlier cycle predicts as well), else the
                # first hit, whose continuation is the longest
                full = hits[hits + n + k <= L]
                j = int(full[-1] if full.size else hits[0]) + n
                return ctx[j:j + k].copy()
        return np.zeros((0,), np.int32)


class ModelDraft:
    """Greedy drafts from a small transformer sharing the target's vocab.

    ``model`` is a port :class:`~dtdl_tpu_torch.models.transformer.
    TransformerLM`; the drafts run on its serving twin
    (:meth:`~TransformerLM.compute_copy`), on its device.  Both generate
    dimensions are power-of-two bucketed, as in the JAX class: the
    context is cut to the largest power of two <= min(len, ``window``),
    and ``k`` is rounded up to a power of two before generating (greedy
    decoding is prefix-stable, so the first k tokens of the bucket are the
    same drafts).  ``warmup`` (the widest ``speculate`` to expect;
    ``True`` means 8) runs every (context bucket, k bucket <= 2·warmup)
    once at construction, so the first requests do not pay the first
    calls' set-up (the allocator, cuBLAS handles)."""

    def __init__(self, model, window: int = 32, warmup=0):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.model = model.compute_copy()
        self.window = min(window, model.cfg.max_seq - 1)
        warmup = 8 if warmup is True else int(warmup)
        if warmup < 0:
            raise ValueError(f"warmup must be >= 0, got {warmup}")
        if warmup:
            k_hi = self._k_bucket(2 * warmup)
            s0 = 1
            while True:
                kb = 1
                while kb <= min(k_hi, model.cfg.max_seq - s0):
                    self.propose(np.zeros(s0, np.int32), kb)
                    kb *= 2
                if s0 * 2 > self.window:
                    break
                s0 *= 2

    @staticmethod
    def _k_bucket(k: int) -> int:
        kb = 1
        while kb < k:
            kb *= 2
        return kb

    def propose(self, ctx, k: int) -> np.ndarray:
        from dtdl_tpu_torch.models.transformer import generate
        ctx = np.asarray(ctx, np.int32).ravel()
        if ctx.size < 1 or k < 1:
            return np.zeros((0,), np.int32)
        s0 = 1
        while s0 * 2 <= min(ctx.size, self.window):
            s0 *= 2
        kb = min(self._k_bucket(k), self.model.cfg.max_seq - s0)
        if kb < 1:
            return np.zeros((0,), np.int32)
        out = generate(self.model, ctx[None, ctx.size - s0:], kb)
        # the draft is host work by design (the scheduler meters it as
        # draft_s): this read waits for the draft model's own steps only
        return out[0, s0:s0 + min(k, kb)].to("cpu", torch.int32).numpy()
