"""Per-slot token sampling, the port of dtdl_tpu/serve/sampling.py.

Every knob is a per-slot tensor, so one decode step serves a batch that
mixes greedy and nucleus requests.  ``temperature`` 0 is the greedy argmax
of the raw logits; ``top_k`` 0 and ``top_p`` >= 1 disable their
truncation.

:func:`filter_logits` is the sortless hot path: top-k and top-p both
reduce to "find a logit threshold", found by bisection over an
order-preserving integer key of the f32 logits (32 rounds of a vectorized
count/mass-above, no sort).  The JAX package bit-casts to uint32; torch's
uint32 support is thin, so the key here is the same value held in an
int64, built from ``x.view(torch.int32)``.  :func:`filter_logits_sorted`
is the full-sort oracle the keep-sets are pinned against.

Draws use an explicit ``torch.Generator``; they are not the JAX package's
draws for the same seed (the frameworks' generators differ), so sampled
output is compared by distribution and keep-set, never token for token.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SampleParams:
    """One request's sampling config (host side)."""
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got "
                             f"{self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 disables), got "
                             f"{self.top_k}")
        if not 0 < self.top_p:
            raise ValueError(f"top_p must be > 0, got {self.top_p}")


GREEDY = SampleParams()

_SIGN = 0x80000000
_LOW32 = 0xFFFFFFFF


def _desc_keys(x):
    """Order-preserving keys of f32 values as int64 in [0, 2**32):
    ``a < b`` iff ``key(a) < key(b)``.  The sign fold of the JAX uint32
    keys (negatives bit-flip, positives set the top bit), with ``x + 0.0``
    canonicalizing -0.0 so equal values get equal keys."""
    u = (x.float() + 0.0).contiguous().view(torch.int32).long() & _LOW32
    return torch.where(u >= _SIGN, (~u) & _LOW32, u | _SIGN)


def _desc_threshold(keys, weights, need):
    """Largest key threshold ``t`` with ``sum(weights[keys >= t]) >=
    need`` per row, built bit by bit from the top (32 rounds)."""
    t = torch.zeros(keys.shape[0], dtype=torch.int64, device=keys.device)
    zero = torch.zeros((), dtype=weights.dtype, device=weights.device)
    for i in range(32):
        cand = t | (_SIGN >> i)
        mass = torch.where(keys >= cand[:, None], weights, zero).sum(-1)
        t = torch.where(mass >= need, cand, t)
    return t


def filter_logits(logits, temperature, top_k, top_p):
    """Scale and truncate [B, V] f32 logits per slot; dropped tokens are
    -inf.  Ties at the k-th value widen the top-k keep set; ties at the
    top-p boundary keep the lowest-index tokens first (the oracle's
    stable-sort order)."""
    _, V = logits.shape
    scaled = logits / temperature.clamp(min=1e-6)[:, None]
    keys = _desc_keys(scaled)

    need_k = top_k.clamp(1, V).to(torch.float32)
    t_k = _desc_threshold(keys, torch.ones_like(scaled), need_k)
    keep_k = torch.where((top_k > 0)[:, None], keys >= t_k[:, None],
                         torch.ones_like(keys, dtype=torch.bool))

    probs = torch.softmax(scaled, dim=-1)
    t_p = _desc_threshold(keys, probs, top_p)
    gt = keys > t_p[:, None]
    eq = keys == t_p[:, None]
    above = torch.where(gt, probs, torch.zeros_like(probs)).sum(-1)
    rank_eq = torch.cumsum(eq.to(torch.int32), dim=-1) - eq.to(torch.int32)
    keep_p = gt | (eq & (above[:, None] + rank_eq * probs < top_p[:, None]))
    keep_p = torch.where((top_p < 1.0)[:, None], keep_p,
                         torch.ones_like(keep_p))
    return torch.where(keep_k & keep_p, scaled,
                       torch.full_like(scaled, float("-inf")))


def filter_logits_sorted(logits, temperature, top_k, top_p):
    """The full-sort oracle of :func:`filter_logits` (not on the serving
    path): descending stable argsort, k-th-value threshold, cumsum over
    the sorted probabilities."""
    _, V = logits.shape
    scaled = logits / temperature.clamp(min=1e-6)[:, None]
    order = torch.argsort(-scaled, dim=-1, stable=True)
    sorted_logits = torch.gather(scaled, -1, order)
    kth = torch.gather(sorted_logits, -1,
                       (top_k.long() - 1).clamp(0, V - 1)[:, None])
    keep_k = torch.where((top_k > 0)[:, None], scaled >= kth,
                         torch.ones_like(scaled, dtype=torch.bool))
    probs = torch.softmax(sorted_logits, dim=-1)
    before = torch.cumsum(probs, dim=-1) - probs
    keep_sorted = before < top_p[:, None]
    inv = torch.argsort(order, dim=-1)
    keep_p = torch.gather(keep_sorted, -1, inv)
    return torch.where(keep_k & keep_p, scaled,
                       torch.full_like(scaled, float("-inf")))


def sample(logits, generator, temperature, top_k, top_p, allowed=None):
    """One token per slot: [B, V] f32 logits -> [B] int32.  Rows with
    temperature 0 take the raw argmax; the others draw from their
    filtered distribution with ``generator`` (on the logits' device)."""
    if allowed is not None:
        raise NotImplementedError(
            "grammar masks are ROADMAP queue A12 (tenancy), not in this "
            "slice")
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    masked = filter_logits(logits, temperature, top_k, top_p)
    drawn = torch.multinomial(torch.softmax(masked, dim=-1), 1,
                              generator=generator)[:, 0].to(torch.int32)
    return torch.where(temperature <= 0.0, greedy, drawn)


def pack(params_per_slot, device=None) -> tuple:
    """[SampleParams, ...] -> the (temperature f32, top_k int32, top_p
    f32) per-slot vectors."""
    return (torch.tensor(np.asarray([p.temperature for p in params_per_slot],
                                    np.float32), device=device),
            torch.tensor(np.asarray([p.top_k for p in params_per_slot],
                                    np.int32), device=device),
            torch.tensor(np.asarray([p.top_p for p in params_per_slot],
                                    np.float32), device=device))
