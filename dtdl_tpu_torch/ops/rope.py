"""Rotary position embeddings (RoPE), the port of dtdl_tpu/ops/rope.py.

:func:`apply_rope` is the eager rotation (the paged attend rotates the new
query/key rows with it); :func:`rope_rows` builds the full-width per-position
table rows the flash kernel rotates with on load, such that
``x·cc + rot_half(x)·ss`` equals :func:`apply_rope` at those positions.
Both compute in f32 and cast back to the input dtype.
"""

from __future__ import annotations

import torch


def rope_frequencies(head_dim: int, max_seq: int, theta: float = 10000.0,
                     dtype=torch.float32, device=None):
    """(cos, sin) tables of shape [max_seq, head_dim // 2]."""
    inv_freq = 1.0 / (theta ** (torch.arange(
        0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))
    pos = torch.arange(max_seq, dtype=torch.float32, device=device)
    angles = torch.outer(pos, inv_freq)
    return torch.cos(angles).to(dtype), torch.sin(angles).to(dtype)


def rope_rows(cos, sin, positions):
    """[len(positions), head_dim] f32 rows (cc, ss) for the fused kernel."""
    c = cos[positions].float()
    s = sin[positions].float()
    return torch.cat([c, c], dim=-1), torch.cat([s, s], dim=-1)


def apply_rope(x, cos, sin, offset: int = 0, positions=None):
    """Rotate [batch, heads, seq, head_dim] queries/keys.

    ``positions`` overrides ``offset``: a [seq] tensor gives every batch
    row the same positions, a [batch, seq] tensor gives each row its own
    (the serving arena, where each row is a slot at its own position).
    """
    seq = x.shape[2]
    if positions is None:
        positions = torch.arange(offset, offset + seq, device=x.device)
    c, s = cos[positions].float(), sin[positions].float()
    if positions.dim() == 1:
        c, s = c[None, None], s[None, None]
    else:                                   # [B, S, D/2] -> [B, 1, S, D/2]
        c, s = c[:, None], s[:, None]
    return rotate(x, c, s)


def rotate(x, c, s):
    """``x1·c − x2·s ‖ x1·s + x2·c`` with (c, s) already gathered at the
    rows' positions and broadcastable to x's halves; f32, cast back."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return out.to(x.dtype)
