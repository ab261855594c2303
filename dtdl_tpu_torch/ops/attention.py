"""Flash attention, the port of dtdl_tpu/ops/attention.py.

:func:`flash_attention` keeps the JAX signature (``causal``, ``scale``,
``rope=(cos, sin)``, ``rope_positions``; ``block_q``/``block_k`` are
accepted and ignored: the kernels pick their own tiles) and is
differentiable.  On CUDA tensors the forward runs the hand-written kernel
``csrc/flash_fwd.cu`` (kernel K1, the port of ``_fwd_kernel``) through
:func:`flash_fwd`, and the backward runs ``csrc/flash_bwd.cu`` through
:func:`flash_bwd`: kernel K2 (dq, the port of ``_bwd_dq_kernel``) then
kernel K3 (dk and dv, the port of ``_bwd_dkv_kernel``).  In bf16, all
three take q and k already rotated: their wrappers first run the rope
pre-pass :func:`rope_rotate` (``csrc/rope_rows.cu``), once per row and
call (once for the K2/K3 pair in :func:`flash_bwd`), where the JAX kernels
rotate every tile they load.  On CPU tensors
each wrapper runs its kernel's plain PyTorch version: the forward is
rope-then-:func:`mha_reference` arithmetic, the backward the same
recompute from the saved lse as the kernels (:func:`flash_bwd_reference`).
"""

from __future__ import annotations

import math

import torch

from dtdl_tpu_torch import kernels
from dtdl_tpu_torch.ops.rope import apply_rope, rope_rows

NEG_INF = -1e30


def _causal_mask(sq: int, sk: int, device):
    """Bottom-aligned causal mask ``tril(k=sk-sq)``: row i sees keys
    j <= i + sk - sq."""
    return torch.ones(sq, sk, dtype=torch.bool, device=device).tril(
        diagonal=sk - sq)


def _attend(q, k, v, *, causal: bool, scale: float):
    """Dense attention over [..., S, D] tensors: f32 logits from the
    native-dtype inputs, bottom-aligned causal mask filled with -1e30 (not
    -inf), softmax, weights cast to v's dtype, f32-accumulated P·V cast
    back.  Returns (o, lse)."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        logits = logits.masked_fill(
            ~_causal_mask(q.shape[-2], k.shape[-2], q.device), NEG_INF)
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


def _unrotate(g, c, s):
    """``g·c − rot_half(g)·s`` on f32 gradient rows: the inverse rotation
    (rope is orthogonal per row), applied to dq and dk as
    ``_unrotate_f32`` does in the JAX kernels."""
    d2 = g.shape[-1] // 2
    rot = torch.cat([-g[..., d2:], g[..., :d2]], dim=-1)
    return g * c - rot * s


_HEAD_DIMS = (16, 32, 64, 128)


def rope_rotate(x, c, s):
    """The rope pre-pass on [B·H, S, D] rows: ``x·c + rot_half(x)·s`` with
    the [S, D] f32 rope rows ``c``, ``s`` (:func:`rope_rows`), computed in
    f32 and rounded to x's dtype.  CPU tensors take the plain version
    :func:`_rotate`; CUDA tensors launch ``csrc/rope_rows.cu``, whose
    output is bitwise the plain version's, or raise."""
    if x.device.type == "cpu":
        return _rotate(x, c, s)
    if x.device.type != "cuda":
        raise ValueError(f"rope_rotate runs on cuda or cpu, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"rope_rotate takes f32 or bf16, got {x.dtype}")
    bh, sq, d = x.shape
    if d not in _HEAD_DIMS:
        raise ValueError(f"rope_rotate head_dim must be one of {_HEAD_DIMS}, "
                         f"got {d}")
    x = x.contiguous()
    c, s = c.contiguous().float(), s.contiguous().float()
    if c.shape != (sq, d) or s.shape != (sq, d):
        raise ValueError(f"rope rows must be [{sq}, {d}], got "
                         f"{tuple(c.shape)} and {tuple(s.shape)}")
    if any(t.device != x.device or t.data_ptr() % 16 for t in (x, c, s)):
        raise ValueError("rope_rotate inputs must be 16-byte aligned "
                         "tensors on one device")
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = kernels.lib().dtdl_rope_rows(
        x.data_ptr(), c.data_ptr(), s.data_ptr(), y.data_ptr(), bh, sq, d,
        _kind(x), stream)
    kernels.check("rope_rows", code)
    kernels.LAUNCHES["rope_rows"] += 1
    return y


def _prerotate(q, k, tabs):
    """The pre-pass of the bf16 bodies of K1, K2 and K3, which take q and k
    already rotated (the f32 bodies rotate on load)."""
    if tabs is None:
        return q, k
    qc, qs, kc, ks = tabs
    return rope_rotate(q, qc, qs), rope_rotate(k, kc, ks)


def _kind(x) -> int:
    return kernels.BF16 if x.dtype == torch.bfloat16 else kernels.F32


def _check_launch(name: str, q, k, v, tabs, extra=()):
    """Checks shared by the flash kernels' wrappers on [B·H, S, D]
    tensors; returns the contiguous q, k, v, ``extra`` tensors and the
    rope-row pointers (four nulls without rope)."""
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, got {q.device}")
    bh, sq, d = q.shape
    sk = k.shape[1]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} takes f32 or bf16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if d not in _HEAD_DIMS:
        raise ValueError(f"{name} head_dim must be one of {_HEAD_DIMS}, "
                         f"got {d}")
    if k.shape != (bh, sk, d) or v.shape != k.shape:
        raise ValueError(f"k/v must be [{bh}, Sk, {d}], got {tuple(k.shape)}"
                         f" and {tuple(v.shape)}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    extra = tuple(t.contiguous() for t in extra)
    ptrs = [None] * 4
    if tabs is not None:
        tabs = tuple(t.contiguous().float() for t in tabs)
        if tabs[0].shape != (sq, d) or tabs[2].shape != (sk, d):
            raise ValueError("rope rows must be [Sq, D] and [Sk, D]")
        ptrs = [t.data_ptr() for t in tabs]
    for t in (q, k, v) + extra:
        if t.device != q.device or t.data_ptr() % 16:
            raise ValueError(f"{name} inputs must be 16-byte aligned "
                             f"tensors on one device")
    # the tables must outlive the launch: keep them with the pointers
    return q, k, v, extra, ptrs, tabs


def flash_fwd(q, k, v, tabs, *, scale: float, causal: bool):
    """Kernel K1 on [B·H, S, D] tensors: returns (o, lse [B·H, Sq] f32).
    ``tabs`` is None or the rope rows (qc, qs, kc, ks) of
    :func:`~dtdl_tpu_torch.ops.rope.rope_rows`.  CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise.  In bf16 (and
    on the CPU) the rope pre-pass rotates q and k first."""
    if q.device.type == "cpu":
        q, k = _prerotate(q, k, tabs)
        return _attend(q, k, v, causal=causal, scale=scale)
    q, k, v, _, ptrs, tabs = _check_launch("flash_fwd", q, k, v, tabs)
    if q.dtype == torch.bfloat16:
        q, k = _prerotate(q, k, tabs)
        ptrs = [None] * 4
    bh, sq, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(bh, sq, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = kernels.lib().dtdl_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), *ptrs, o.data_ptr(),
        lse.data_ptr(), bh, sq, k.shape[1], d, _kind(q), int(causal),
        float(scale), stream)
    kernels.check("flash_fwd", code)
    kernels.LAUNCHES["flash_fwd"] += 1
    return o, lse


# ---------------------------------------------------------------------------
# backward: kernels K2 (dq) and K3 (dk, dv) and their plain versions
# ---------------------------------------------------------------------------

def _bwd_recompute(q, k, v, do, lse, delta, tabs, scale, causal, rotated):
    """What K2 and K3 both recompute from the residuals: the rotated q/k
    rows (input dtype; ``rotated`` says q and k come rotated already),
    ``p = exp(s - lse)`` and ``ds = p∘(dp - delta)·scale`` in f32, with
    ``s`` masked to -1e30 above the diagonal."""
    if tabs is not None and not rotated:
        qc, qs, kc, ks = tabs
        q, k = _rotate(q, qc, qs), _rotate(k, kc, ks)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        s = s.masked_fill(~_causal_mask(q.shape[-2], k.shape[-2], q.device),
                          NEG_INF)
    p = torch.exp(s - lse[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    return q, k, p, ds


def flash_bwd_dq_reference(q, k, v, do, lse, delta, tabs, *, scale: float,
                           causal: bool, rotated: bool = False):
    """Plain version of K2: ``dq = ds·k`` (ds cast to the input dtype,
    f32 accumulation), inverse-rotated with rope, cast to q's dtype.
    ``rotated=True`` takes q and k already rotated (the bf16 kernels'
    inputs): the tables then serve dq's inverse rotation only."""
    _, kr, _, ds = _bwd_recompute(q, k, v, do, lse, delta, tabs, scale,
                                  causal, rotated)
    dq = torch.matmul(ds.to(q.dtype).float(), kr.float())
    if tabs is not None:
        dq = _unrotate(dq, tabs[0], tabs[1])
    return dq.to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, tabs, *, scale: float,
                            causal: bool, rotated: bool = False):
    """Plain version of K3: ``dk = dsᵀ·q`` (inverse-rotated with rope)
    and ``dv = pᵀ·dO``, ds and p cast to the input dtype first;
    ``rotated`` as in :func:`flash_bwd_dq_reference`."""
    qr, _, p, ds = _bwd_recompute(q, k, v, do, lse, delta, tabs, scale,
                                  causal, rotated)
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), qr.float())
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    if tabs is not None:
        dk = _unrotate(dk, tabs[2], tabs[3])
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_reference(q, k, v, do, lse, delta, tabs, *, scale: float,
                        causal: bool, rotated: bool = False):
    """Plain version of :func:`flash_bwd`: (dq, dk, dv)."""
    kw = dict(scale=scale, causal=causal, rotated=rotated)
    return (flash_bwd_dq_reference(q, k, v, do, lse, delta, tabs, **kw),
            *flash_bwd_dkv_reference(q, k, v, do, lse, delta, tabs, **kw))


def _bwd_inputs(name, q, k, v, do, lse, delta, tabs):
    """The checked, contiguous inputs of K2 and K3 on the card: (q, k, v,
    dO, lse, delta, the four rope-row pointers) and the tables, which must
    outlive the launches.  In bf16 the rope pre-pass rotates q and k here,
    once for both kernels, and the tables then serve the inverse rotation
    of dq and dk only; the f32 bodies rotate on load."""
    bh, sq, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"{name}: dO must match q, got {tuple(do.shape)} "
                         f"{do.dtype}")
    for t in (lse, delta):
        if t.shape != (bh, sq) or t.dtype != torch.float32:
            raise ValueError(f"{name}: lse and delta must be [{bh}, {sq}] "
                             f"f32, got {tuple(t.shape)} {t.dtype}")
    q, k, v, (do, lse, delta), ptrs, tabs = _check_launch(
        name, q, k, v, tabs, (do, lse, delta))
    if q.dtype == torch.bfloat16:
        q, k = _prerotate(q, k, tabs)
    return (q, k, v, do, lse, delta, ptrs), tabs


def _launch_dq(args, *, scale, causal):
    q, k, v, do, lse, delta, ptrs = args
    bh, sq, d = q.shape
    dq = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = kernels.lib().dtdl_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), *ptrs, dq.data_ptr(), bh, sq,
        k.shape[1], d, _kind(q), int(causal), float(scale), stream)
    kernels.check("flash_bwd_dq", code)
    kernels.LAUNCHES["flash_bwd_dq"] += 1
    return dq


def _launch_dkv(args, *, scale, causal):
    q, k, v, do, lse, delta, ptrs = args
    bh, sq, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = kernels.lib().dtdl_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), *ptrs, dk.data_ptr(),
        dv.data_ptr(), bh, sq, k.shape[1], d, _kind(q), int(causal),
        float(scale), stream)
    kernels.check("flash_bwd_dkv", code)
    kernels.LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta, tabs, *, scale: float,
                 causal: bool):
    """Kernel K2 on [B·H, S, D] tensors (q, k unrotated; lse and delta
    [B·H, Sq] f32): returns dq.  CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise.  In bf16 the rope pre-pass rotates
    q and k first."""
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(q, k, v, do, lse, delta, tabs,
                                      scale=scale, causal=causal)
    args, _tabs = _bwd_inputs("flash_bwd_dq", q, k, v, do, lse, delta, tabs)
    return _launch_dq(args, scale=scale, causal=causal)


def flash_bwd_dkv(q, k, v, do, lse, delta, tabs, *, scale: float,
                  causal: bool):
    """Kernel K3, the same arguments as :func:`flash_bwd_dq`: returns
    (dk, dv)."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_reference(q, k, v, do, lse, delta, tabs,
                                       scale=scale, causal=causal)
    args, _tabs = _bwd_inputs("flash_bwd_dkv", q, k, v, do, lse, delta, tabs)
    return _launch_dkv(args, scale=scale, causal=causal)


def flash_bwd(q, k, v, do, lse, delta, tabs, *, scale: float, causal: bool):
    """The flash backward on [B·H, S, D] tensors: (dq, dk, dv) from the
    unrotated q/k, v, the output gradient ``do``, the forward's ``lse``
    and ``delta = rowsum(dO∘O)`` (both [B·H, Sq] f32): K2 then K3, on the
    card from one set of checked inputs and (bf16) one rope pre-pass."""
    kw = dict(scale=scale, causal=causal)
    if q.device.type == "cpu":
        return (flash_bwd_dq(q, k, v, do, lse, delta, tabs, **kw),
                *flash_bwd_dkv(q, k, v, do, lse, delta, tabs, **kw))
    args, _tabs = _bwd_inputs("flash_bwd", q, k, v, do, lse, delta, tabs)
    return _launch_dq(args, **kw), *_launch_dkv(args, **kw)


class _FlashAttention(torch.autograd.Function):
    """Forward through :func:`flash_fwd`, backward through
    :func:`flash_bwd`.  The residuals are the unrotated q/k, v, o, lse and
    the rope rows, as the JAX custom VJP keeps them: the backward rotates
    them again (in bf16 once for K2 and K3 together, in f32 on load).
    The rope rows get no gradient (JAX defines their
    cotangents as zero)."""

    @staticmethod
    def forward(ctx, q, k, v, tabs, scale, causal):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = flash_fwd(q, k, v, tabs, scale=scale, causal=causal)
        ctx.save_for_backward(q, k, v, o, lse, *(tabs or ()))
        ctx.scale, ctx.causal = scale, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, *tabs = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(-1)      # [B·H, Sq] f32
        dq, dk, dv = flash_bwd(q, k, v, do, lse, delta, tuple(tabs) or None,
                               scale=ctx.scale, causal=ctx.causal)
        return dq, dk, dv, None, None, None


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
