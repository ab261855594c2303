"""Flash attention, the port of dtdl_tpu/ops/attention.py.

:func:`flash_attention` keeps the JAX signature (``causal``, ``scale``,
``rope=(cos, sin)``, ``rope_positions``; ``block_q``/``block_k`` are
accepted and ignored: the kernel picks its own tiles).  On a CUDA tensor
the forward runs the hand-written kernel ``csrc/flash_fwd.cu`` (kernel K1,
the port of ``_fwd_kernel``) through :func:`flash_fwd`; on a CPU tensor
:func:`flash_fwd` runs the kernel's plain PyTorch version, the same
rope-then-:func:`mha_reference` arithmetic.  The backward kernels (K2/K3)
come with the training slice, ROADMAP queue B2/B3; until then the
backward raises.
"""

from __future__ import annotations

import math

import torch

from dtdl_tpu_torch import kernels
from dtdl_tpu_torch.ops.rope import apply_rope, rope_rows

NEG_INF = -1e30


def _attend(q, k, v, *, causal: bool, scale: float):
    """Dense attention over [..., S, D] tensors: f32 logits from the
    native-dtype inputs, bottom-aligned causal mask ``tril(k=sk-sq)``
    filled with -1e30 (not -inf), softmax, weights cast to v's dtype,
    f32-accumulated P·V cast back.  Returns (o, lse)."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        sq, sk = q.shape[-2], k.shape[-2]
        mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril(
            diagonal=sk - sq)
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    o = torch.matmul(probs.to(v.dtype).float(), v.float()).to(v.dtype)
    return o, lse


def mha_reference(q, k, v, *, causal: bool = True, scale: float | None = None):
    """Dense reference attention; q, k, v: [batch, heads, seq, head_dim]
    (k/v seq may differ from q's)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _attend(q, k, v, causal=causal, scale=scale)[0]


def _default_positions(sq: int, sk: int, cos, device):
    if max(sq, sk) > cos.shape[0]:
        raise ValueError(
            f"rope table covers {cos.shape[0]} positions but seq_q={sq}, "
            f"seq_k={sk}; build rope_frequencies with max_seq >= the "
            f"sequence length")
    pos_k = torch.arange(sk, device=device)
    pos_q = (torch.arange(sq, device=device) + (sk - sq)).clamp(min=0)
    return pos_q, pos_k


def flash_attention_reference(q, k, v, *, causal: bool = True,
                              scale: float | None = None, rope=None,
                              rope_positions=None):
    """Plain version of :func:`flash_attention` that also returns lse:
    rope (``apply_rope`` at the default or explicit positions) then
    :func:`mha_reference` arithmetic.  Returns (o [B, H, Sq, D],
    lse [B, H, Sq] f32)."""
    sq, sk, d = q.shape[2], k.shape[2], q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if rope is not None:
        cos, sin = rope
        pos_q, pos_k = (rope_positions if rope_positions is not None
                        else _default_positions(sq, sk, cos, q.device))
        q = apply_rope(q, cos, sin, positions=pos_q)
        k = apply_rope(k, cos, sin, positions=pos_k)
    return _attend(q, k, v, causal=causal, scale=scale)


def _rotate(x, c, s):
    """x·c + rot_half(x)·s on [.., S, D] rows in f32, cast back: the
    table-row form of apply_rope the kernel applies on load."""
    xf = x.float()
    d2 = x.shape[-1] // 2
    rot = torch.cat([-xf[..., d2:], xf[..., :d2]], dim=-1)
    return (xf * c + rot * s).to(x.dtype)


_HEAD_DIMS = (16, 32, 64, 128)


def flash_fwd(q, k, v, tabs, *, scale: float, causal: bool):
    """Kernel K1 on [B·H, S, D] tensors: returns (o, lse [B·H, Sq] f32).
    ``tabs`` is None or the rope rows (qc, qs, kc, ks) of
    :func:`~dtdl_tpu_torch.ops.rope.rope_rows`.  CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise."""
    if q.device.type == "cpu":
        if tabs is not None:
            qc, qs, kc, ks = tabs
            q, k = _rotate(q, qc, qs), _rotate(k, kc, ks)
        return _attend(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd runs on cuda or cpu, got {q.device}")
    bh, sq, d = q.shape
    sk = k.shape[1]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_fwd takes f32 or bf16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_fwd head_dim must be one of {_HEAD_DIMS}, "
                         f"got {d}")
    if k.shape != (bh, sk, d) or v.shape != k.shape:
        raise ValueError(f"k/v must be [{bh}, Sk, {d}], got {tuple(k.shape)}"
                         f" and {tuple(v.shape)}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    ptrs = [None] * 4
    if tabs is not None:
        tabs = tuple(t.contiguous().float() for t in tabs)
        if tabs[0].shape != (sq, d) or tabs[2].shape != (sk, d):
            raise ValueError("rope rows must be [Sq, D] and [Sk, D]")
        ptrs = [t.data_ptr() for t in tabs]
    for t in (q, k, v):
        if t.device != q.device or t.data_ptr() % 16:
            raise ValueError("flash_fwd inputs must be 16-byte aligned "
                             "tensors on one device")
    o = torch.empty_like(q)
    lse = torch.empty(bh, sq, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = kernels.lib().dtdl_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), *ptrs, o.data_ptr(),
        lse.data_ptr(), bh, sq, sk, d,
        kernels.BF16 if q.dtype == torch.bfloat16 else kernels.F32,
        int(causal), float(scale), stream)
    kernels.check("flash_fwd", code)
    kernels.LAUNCHES["flash_fwd"] += 1
    return o, lse


class _FlashAttention(torch.autograd.Function):
    """Forward through :func:`flash_fwd`; the backward kernels (dq, dk/dv)
    are ROADMAP queue B2/B3, ported with the training slice."""

    @staticmethod
    def forward(ctx, q, k, v, tabs, scale, causal):
        o, _ = flash_fwd(q, k, v, tabs, scale=scale, causal=causal)
        return o

    @staticmethod
    def backward(ctx, do):
        raise NotImplementedError(
            "flash_attention backward (kernels K2/K3, ops/attention.py "
            "_bwd_dq_kernel/_bwd_dkv_kernel) is ROADMAP queue B2/B3 and "
            "comes with the training slice")


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None,
                    block_q: int | None = None, block_k: int | None = None,
                    rope=None, rope_positions=None):
    """Flash attention over [batch, heads, seq, head_dim] tensors.

    ``rope=(cos, sin)`` (the :func:`rope_frequencies` tables) fuses the
    rotation into the kernel's Q/K loads; ``rope_positions=(pos_q,
    pos_k)`` gives explicit positions, the default being k at
    0..sk-1 with q bottom-aligned.  ``block_q``/``block_k`` are accepted
    for the JAX signature and ignored."""
    del block_q, block_k
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    tabs = None
    if rope is not None:
        cos, sin = rope
        pos_q, pos_k = (rope_positions if rope_positions is not None
                        else _default_positions(sq, sk, cos, q.device))
        tabs = rope_rows(cos, sin, pos_q) + rope_rows(cos, sin, pos_k)
    o = _FlashAttention.apply(q.reshape(b * h, sq, d),
                              k.reshape(b * h, sk, d),
                              v.reshape(b * h, sk, d), tabs, scale, causal)
    return o.reshape(b, h, sq, d)
