"""Sequence/context parallelism, ring attention and Ulysses all-to-all,
the port of dtdl_tpu/parallel/sequence.py.

The JAX functions are called inside ``shard_map`` with activations
sharded on a ``seq`` mesh axis; here each process holds its shard and
the functions take the :class:`~dtdl_tpu_torch.runtime.mesh.Mesh` whose
``axis_name`` they run over.  The collectives are the differentiable
ones of :mod:`dtdl_tpu_torch.parallel.collectives`, so autograd runs the
rings and all-to-alls backward as JAX transposes them.

* **ring attention**: K/V blocks rotate around the axis by ``ppermute``
  while each process accumulates its queries' attention over every block
  with the online softmax (running max ``m``, normalizer ``l``), in plain
  torch as the JAX ring is plain ``jnp``.  ``contiguous`` (process i
  holds positions ``[i·s_loc, (i+1)·s_loc)``) or ``zigzag`` (chunks ``i``
  and ``2n-1-i`` of a ``2n``-chunk split, :func:`zigzag_order`), the
  layout that gives every process half a block of causal work per hop.
  A ``lax.cond`` on the ring source becomes a Python branch on the
  process's own values.
* **Ulysses**: one all-to-all re-shards [B, H, S/n, D] sequence shards
  into [B, H/n, S, D] head shards, :func:`flash_attention` runs over the
  full sequence (kernels K1-K3 on CUDA tensors, the plain version on CPU
  tensors), and a second all-to-all restores sequence sharding.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from dtdl_tpu_torch.parallel.collectives import all_to_all, ppermute
from dtdl_tpu_torch.runtime.mesh import Mesh

SEQ_AXIS = "seq"
NEG_INF = -1e30


def zigzag_order(n_shards: int, seq_len: int) -> np.ndarray:
    """Gather indices laying a global sequence out in zigzag shard order.

    ``x[..., zigzag_order(n, S), ...]`` (applied to the sequence dim) puts
    chunks ``(i, 2n-1-i)`` of the original order in shard i's place.
    Identity when n == 1.
    """
    if n_shards <= 1:
        return np.arange(seq_len)
    if seq_len % (2 * n_shards):
        raise ValueError(
            f"zigzag layout needs seq_len ({seq_len}) divisible by "
            f"2*n_shards ({2 * n_shards})")
    c = seq_len // (2 * n_shards)
    parts = []
    for i in range(n_shards):
        parts.append(np.arange(i * c, (i + 1) * c))
        j = 2 * n_shards - 1 - i
        parts.append(np.arange(j * c, (j + 1) * c))
    return np.concatenate(parts)


def zigzag_inverse(n_shards: int, seq_len: int) -> np.ndarray:
    """Scatter indices undoing :func:`zigzag_order`."""
    return np.argsort(zigzag_order(n_shards, seq_len))


def _owner_positions(layout: str, n: int, owner: int, s_loc: int, device):
    """Global positions of ``owner``'s local rows under ``layout``:
    [s_loc] (``arange(s_loc)`` for both layouts at n == 1)."""
    ar = torch.arange(s_loc, device=device)
    if layout == "zigzag" and n > 1:
        c = s_loc // 2
        return torch.cat([owner * c + ar[:c],
                          (2 * n - 1 - owner) * c + ar[:c]])
    return owner * s_loc + ar


def zigzag_positions(mesh: Mesh, axis_name: str, s_loc: int, device=None):
    """Global position of each local row under the zigzag layout: [s_loc]."""
    n = mesh.axis_size(axis_name)
    return _owner_positions("zigzag", n, mesh.axis_index(axis_name), s_loc,
                            device)


def _rope_block(x, rope, positions):
    """Rotate a K block at its owner's global positions (a no-op when
    ``rope`` is None); the ring carries K unrotated."""
    if rope is None:
        return x
    from dtdl_tpu_torch.ops.rope import apply_rope
    cos, sin = rope
    return apply_rope(x, cos, sin, positions=positions)


def _online_update(q_rows, k_blk, v_blk, o, m, l, scale, mask=None):
    """One online-softmax accumulation of (o, m, l) rows against a K/V
    block: f32 products of the native-dtype inputs (JAX's
    ``preferred_element_type=f32``), p cast to v's dtype before P·V."""
    s = torch.matmul(q_rows.float(), k_blk.float().transpose(-1, -2)) * scale
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
    p = torch.exp(s - m_new)
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(-1, keepdim=True)
    o_new = o * alpha + torch.matmul(p.to(v_blk.dtype).float(),
                                     v_blk.float())
    return o_new, m_new, l_new


def _ring_init(q):
    b, h, s_loc, d = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    return (torch.zeros(b, h, s_loc, d, **f32),
            torch.full((b, h, s_loc, 1), NEG_INF, **f32),
            torch.zeros(b, h, s_loc, 1, **f32))


def _shift(kv, mesh, axis_name):
    """K and V one hop along the ring, as one message."""
    n = mesh.axis_size(axis_name)
    perm = [(j, (j + 1) % n) for j in range(n)]
    return ppermute(torch.stack(kv), mesh, axis_name, perm).unbind(0)


def ring_attention(q, k, v, *, mesh: Mesh, axis_name: str = SEQ_AXIS,
                   causal: bool = True, scale: float | None = None,
                   layout: str = "contiguous", rope=None):
    """Blockwise ring attention over a sequence-sharded mesh axis.

    q/k/v are this process's shards ``[batch, heads, seq_local,
    head_dim]`` of a global sequence in ``layout`` order; returns the
    local output shard (same layout).  ``rope=(cos, sin)`` fuses the
    rotary embedding into the ring: q/k arrive unrotated, q is rotated
    once at the local positions and every K block at its owner's
    positions as it is used.
    """
    if layout not in ("contiguous", "zigzag"):
        raise ValueError(f"unknown layout {layout!r}")
    n = mesh.axis_size(axis_name)
    if layout == "zigzag" and causal and n > 1:
        return _ring_zigzag_causal(q, k, v, mesh=mesh, axis_name=axis_name,
                                   scale=scale, rope=rope)
    # non-causal attention touches every block regardless of layout, so the
    # zigzag non-causal case is exactly the contiguous schedule below
    my = mesh.axis_index(axis_name)
    b, h, s_loc, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if rope is not None:
        q = _rope_block(q, rope, _owner_positions(layout, n, my, s_loc,
                                                  q.device))
    ar = torch.arange(s_loc, device=q.device)
    pos_q = my * s_loc + ar[:, None]
    o, m, l = _ring_init(q)
    k_blk, v_blk = k, v
    for t in range(n):
        src = (my - t) % n                        # original owner of k_blk
        # blocks strictly above the diagonal (src > my) are fully masked
        if not causal or src <= my:
            mask = (pos_q >= src * s_loc + ar[None, :]) if causal else None
            k_r = _rope_block(k_blk, rope, _owner_positions(
                layout, n, src, s_loc, q.device))
            o, m, l = _online_update(q, k_r, v_blk, o, m, l, scale, mask)
        if t < n - 1:      # the last hop would only bring the blocks home
            k_blk, v_blk = _shift((k_blk, v_blk), mesh, axis_name)
    if causal and n > 1 and torch.is_grad_enabled():
        # a rank that skipped the blocks above its diagonal still passes
        # their gradients on around the ring: tying the last block into
        # the output at weight 0 puts every hop in every rank's backward
        o = o + 0.0 * k_blk.sum()
    l = torch.where(l == 0.0, torch.ones_like(l), l)   # fully-masked rows
    return (o / l).to(q.dtype)


def _ring_zigzag_causal(q, k, v, *, mesh, axis_name, scale, rope=None):
    """Causal ring attention over the zigzag layout, the balanced
    schedule.  For a K/V block owned by ``src``: the local diagonal
    (``src == my``) under the zigzag causal mask, first; ``src < my``:
    every local query against the block's low chunk, unmasked;
    ``src > my``: the local high chunk's queries against the whole
    block, unmasked.  Every process does half a block per hop."""
    n = mesh.axis_size(axis_name)
    my = mesh.axis_index(axis_name)
    b, h, s_loc, d = q.shape
    if s_loc % 2:
        raise ValueError(f"zigzag needs an even local seq, got {s_loc}")
    c = s_loc // 2
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    o, m, l = _ring_init(q)
    pos = _owner_positions("zigzag", n, my, s_loc, q.device)
    if rope is not None:
        q = _rope_block(q, rope, pos)
    o, m, l = _online_update(q, _rope_block(k, rope, pos), v, o, m, l, scale,
                             pos[:, None] >= pos[None, :])
    k_blk, v_blk = k, v
    for t in range(1, n):
        k_blk, v_blk = _shift((k_blk, v_blk), mesh, axis_name)
        src = (my - t) % n
        pos_src = _owner_positions("zigzag", n, src, s_loc, q.device)
        if src < my:            # q_all against the kv low chunk
            k_low = _rope_block(k_blk[:, :, :c], rope, pos_src[:c])
            o, m, l = _online_update(q, k_low, v_blk[:, :, :c], o, m, l,
                                     scale)
        else:                   # q high chunk against kv all
            k_full = _rope_block(k_blk, rope, pos_src)
            o_hi, m_hi, l_hi = _online_update(
                q[:, :, c:], k_full, v_blk, o[:, :, c:], m[:, :, c:],
                l[:, :, c:], scale)
            o = torch.cat([o[:, :, :c], o_hi], dim=2)
            m = torch.cat([m[:, :, :c], m_hi], dim=2)
            l = torch.cat([l[:, :, :c], l_hi], dim=2)
    return (o / l).to(q.dtype)


def ulysses_attention(q, k, v, *, mesh: Mesh, axis_name: str = SEQ_AXIS,
                      causal: bool = True, scale: float | None = None,
                      attn_fn=None):
    """DeepSpeed-Ulysses sequence parallelism: all-to-all seq -> heads,
    attend, all-to-all back.  Needs ``heads % axis_size == 0``.
    ``attn_fn(q, k, v, causal, scale)`` defaults to
    :func:`~dtdl_tpu_torch.ops.attention.flash_attention` over the
    gathered sequence."""
    from dtdl_tpu_torch.ops.attention import flash_attention
    n = mesh.axis_size(axis_name)
    if q.shape[1] % n:
        raise ValueError(
            f"ulysses needs heads ({q.shape[1]}) divisible by axis size {n}")
    if attn_fn is None:
        def attn_fn(q, k, v, causal, scale):
            return flash_attention(q, k, v, causal=causal, scale=scale)

    def to_heads(x):   # [B, H, S/n, D] -> [B, H/n, S, D]
        return all_to_all(x, mesh, axis_name, 1, 2)

    def to_seq(x):     # [B, H/n, S, D] -> [B, H, S/n, D]
        return all_to_all(x, mesh, axis_name, 2, 1)

    return to_seq(attn_fn(to_heads(q), to_heads(k), to_heads(v), causal,
                          scale))
