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

:func:`accept_resample` is speculative decoding's accept/resample step:
it takes the verify pass's k+1 positions of logits per slot and commits a
prefix of the drafts plus one final token, losslessly (greedy rows emit
exactly the argmax prefix; sampling rows emit tokens distributed exactly
as plain samples from their filtered distribution).

Grammar masks (``allowed``) reach both as dense ``[..., V]`` bools or
packed: :func:`pack_mask` packs host bools into the JAX package's uint32
words bit for bit (token v at bit ``v % 32`` of word ``v // 32``), and
the engine uploads those words as int32 (the same bits: torch's uint32
shifts are thin), which :func:`unpack_mask` expands on the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dtdl_tpu_torch.device import upload


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


MASK_WORD_BITS = 32


def mask_words(vocab: int) -> int:
    """Words one packed mask row spends on ``vocab`` tokens."""
    return -(-vocab // MASK_WORD_BITS)


def pack_mask(allowed) -> np.ndarray:
    """Pack a host [..., V] bool grammar mask into [..., ceil(V/32)]
    uint32 words, token v at bit ``v % 32`` of word ``v // 32`` (the JAX
    package's words, bit for bit).  Host numpy, before the upload;
    uint32 input passes through unchanged."""
    a = np.asarray(allowed)
    if a.dtype == np.uint32:
        return a
    a = a.astype(bool)
    vocab = a.shape[-1]
    pad = mask_words(vocab) * MASK_WORD_BITS - vocab
    if pad:
        a = np.concatenate([a, np.zeros(a.shape[:-1] + (pad,), bool)],
                           axis=-1)
    bits = a.reshape(a.shape[:-1] + (mask_words(vocab), MASK_WORD_BITS))
    shifts = np.arange(MASK_WORD_BITS, dtype=np.uint32)
    return (bits.astype(np.uint32) << shifts).sum(axis=-1, dtype=np.uint32)


def unpack_mask(packed, vocab: int):
    """Expand packed [..., W] words (int32 carrying the uint32 bits) to a
    [..., vocab] bool mask on their device: each token's word gathered,
    shifted and tested.  The arithmetic shift of a negative word still
    leaves the right bit under ``& 1``."""
    v = torch.arange(vocab, device=packed.device)
    return ((packed[..., v // MASK_WORD_BITS] >> (v % MASK_WORD_BITS))
            & 1).bool()


def _as_dense_mask(allowed, vocab: int):
    """Dense [..., vocab] bool view of a grammar mask given dense (bool)
    or packed (int32 words): the one detection point :func:`sample` and
    :func:`accept_resample` share."""
    if allowed.dtype == torch.bool:
        return allowed
    return unpack_mask(allowed, vocab)


def _masked(logits, allowed):
    """``logits`` with the tokens ``allowed`` refuses at -inf."""
    keep = _as_dense_mask(allowed.to(logits.device), logits.shape[-1])
    return torch.where(keep, logits, torch.full_like(logits, float("-inf")))


def sample(logits, generator, temperature, top_k, top_p, allowed=None):
    """One token per slot: [B, V] f32 logits -> [B] int32.  Rows with
    temperature 0 take the raw argmax; the others draw from their
    filtered distribution with ``generator`` (on the logits' device).
    ``allowed`` ([B, V] bool, or [B, ceil(V/32)] packed words) drops the
    tokens a grammar refuses to -inf before the argmax and the
    truncation; an all-true mask changes nothing."""
    if allowed is not None:
        logits = _masked(logits, allowed)
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    masked = filter_logits(logits, temperature, top_k, top_p)
    drawn = torch.multinomial(torch.softmax(masked, dim=-1), 1,
                              generator=generator)[:, 0].to(torch.int32)
    return torch.where(temperature <= 0.0, greedy, drawn)


def accept_resample(logits, draft, draft_len, generator, temperature, top_k,
                    top_p, forced=None, allowed=None):
    """Speculative decoding's accept/resample step, on the logits' device.

    ``logits`` [B, k+1, V] f32: position i's next-token logits after the
    slot's last committed token and drafts 1..i (the verify pass).
    ``draft`` [B, k] int candidates, of which the first ``draft_len[b]``
    are real; the rest is padding and auto-rejected.  ``temperature``,
    ``top_k`` and ``top_p`` are the per-slot knobs as HOST arrays: whether
    every row is greedy is decided from them without reading the device
    (the JAX ``lax.cond``), and only a batch with a sampling row runs the
    filter sweep over the k+1 positions.  Returns ``(tokens [B, k+1]
    int32, n_accepted [B] int32)``: ``tokens[b, :n+1]`` are the n accepted
    drafts and one final token, zeros after.

    * greedy rows (temperature 0) accept the longest prefix of drafts that
      equal the raw argmax; the final token is the raw argmax at
      ``n_accepted``, so the row emits what sequential greedy decodes do;
    * sampling rows accept draft i with probability ``p_i(draft_i)`` under
      :func:`filter_logits` (a deterministic, one-hot proposal); at the
      first rejection the final token is drawn from the residual, p with
      the rejected token removed, and after all drafts are accepted it is
      a plain draw from ``p_{draft_len}``, so every emitted token is
      distributed exactly as a plain sample from p;
    * ``forced`` [B] bool rows are ground truth (a prompt chunk): they
      commit ``draft_len`` unconditionally and draw the plain bonus;
    * ``allowed`` [B, k+1, V] bool, or [B, k+1, ceil(V/32)] packed
      words, masks each position's logits to -inf before everything else
      (the scheduler walks each grammar along the draft for position i's
      mask); packed and dense masks give the same tokens.
    """
    if allowed is not None:
        logits = _masked(logits, allowed)
    B, k1, V = logits.shape
    k = k1 - 1
    dev = logits.device
    draft = draft.to(device=dev, dtype=torch.int64)
    draft_len = draft_len.to(device=dev, dtype=torch.int64)
    argmaxes = torch.argmax(logits, dim=-1)                     # [B, k+1]
    greedy_host = np.asarray(temperature, np.float32) <= 0.0
    if greedy_host.all():
        acc = draft == argmaxes[:, :k]
    else:
        if generator is None:
            raise ValueError(f"sampled rows need a torch.Generator on {dev}")
        temp = upload(np.asarray(temperature, np.float32), dev)
        tk = upload(np.asarray(top_k, np.int32), dev)
        tp = upload(np.asarray(top_p, np.float32), dev)
        greedy_row = temp <= 0.0
        filt = filter_logits(logits.reshape(B * k1, V),
                             temp.repeat_interleave(k1),
                             tk.repeat_interleave(k1),
                             tp.repeat_interleave(k1)).reshape(B, k1, V)
        probs = torch.softmax(filt, dim=-1)
        u = torch.rand((B, k), generator=generator, device=dev)
        p_draft = torch.gather(probs[:, :k], -1, draft[..., None])[..., 0]
        acc = torch.where(greedy_row[:, None], draft == argmaxes[:, :k],
                          u < p_draft)
    acc = acc & (torch.arange(k, device=dev)[None, :] < draft_len[:, None])
    # the longest accepted prefix: cumprod zeroes everything after the
    # first rejection
    n_acc = torch.cumprod(acc.long(), dim=1).sum(dim=1)
    if forced is not None:
        n_acc = torch.where(forced.to(dev), draft_len, n_acc)
    fin = torch.gather(argmaxes, 1, n_acc[:, None])[:, 0]
    if not greedy_host.all():
        # the final token of a sampling row: the residual draw where a
        # real draft was refused, else the bonus draw from p_{n_acc}
        fin_filt = torch.gather(
            filt, 1, n_acc[:, None, None].expand(B, 1, V))[:, 0]
        rejected = n_acc < draft_len
        d_rej = torch.gather(draft, 1, n_acc.clamp(max=k - 1)[:, None])
        residual = torch.where(
            rejected[:, None]
            & (torch.arange(V, device=dev)[None, :] == d_rej),
            torch.full_like(fin_filt, float("-inf")), fin_filt)
        drawn = torch.multinomial(torch.softmax(residual, dim=-1), 1,
                                  generator=generator)[:, 0]
        fin = torch.where(greedy_row, fin, drawn)
    pos_i = torch.arange(k1, device=dev)[None, :]
    padded = torch.nn.functional.pad(draft, (0, 1))
    tokens = torch.where(pos_i < n_acc[:, None], padded,
                         torch.zeros_like(padded))
    tokens = torch.where(pos_i == n_acc[:, None], fin[:, None], tokens)
    return tokens.to(torch.int32), n_acc.to(torch.int32)


def pack(params_per_slot, device=None) -> tuple:
    """[SampleParams, ...] -> the (temperature f32, top_k int32, top_p
    f32) per-slot vectors."""
    return (torch.tensor(np.asarray([p.temperature for p in params_per_slot],
                                    np.float32), device=device),
            torch.tensor(np.asarray([p.top_k for p in params_per_slot],
                                    np.int32), device=device),
            torch.tensor(np.asarray([p.top_p for p in params_per_slot],
                                    np.float32), device=device))
