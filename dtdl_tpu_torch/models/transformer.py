"""Decoder-only Transformer LM, the port of dtdl_tpu/models/transformer.py.

Pre-norm blocks, RMSNorm, rotary embeddings, SwiGLU MLP or mixture of
experts (:class:`MoE`, every ``moe_every``-th block), tied head.  The
parameters keep the flax layouts and names, so ``state_dict`` keys are the
flax param paths with ``.`` for ``/`` (``block_0.attn.q.kernel``,
``embed``, ``ln_f.scale``) and :mod:`dtdl_tpu_torch.bridge` maps a flax
tree straight across:

* ``attn.{q,k,v}.kernel`` [d_model, H, D] and ``attn.out.kernel``
  [H, D, d_model] (flax DenseGeneral);
* ``mlp.{wi,wg}.kernel`` [d_model, d_ff] and ``mlp.wo.kernel``
  [d_ff, d_model] (flax Dense);
* an MoE block's ``moe.router.kernel`` [d_model, E] (f32 always) and
  ``moe.{wi,wg}`` [E, d_model, d_ff], ``moe.wo`` [E, d_ff, d_model];
* ``embed`` [vocab, d_model]; ``ln_attn``/``ln_mlp``/``ln_f`` ``scale``.

Parameters are held in f32, as flax holds them (``param_dtype`` f32), and
every use casts to the compute dtype ``cfg.dtype`` where flax's ``dtype=``
casts: the matmul kernels at each product, the embedding after the row
gather and in the tied head.  Training therefore updates f32 master
weights with f32 optimizer state.  Norm scales stay f32, as flax
multiplies them in f32.  A server takes :meth:`TransformerLM.compute_copy`
once, a frozen copy whose weights are already in the compute dtype, so a
decode step pays no per-step cast of every weight.

``cfg.quantize`` (``True`` int8, ``'w8f'`` fp8) builds every matmul
kernel as a :class:`~dtdl_tpu_torch.quant.layers.QuantLinear`: the same
``kernel`` names plus ``kernel_scale`` siblings, the JAX package's
``quantize=`` schema; an MoE block's experts become payloads beside
``{wi,wg,wo}_scale`` [E, 1, out] (its router stays f32).  A quantized
model is served, never trained.

Four forwards:

* the cacheless forward (``pos=None``, the training and scoring path):
  full causal attention, ``attn_impl='flash'`` through
  :func:`~dtdl_tpu_torch.ops.attention.flash_attention` with fused rope
  (kernel K1 forward, K2 and K3 backward on the card) or ``'dense'``
  (``apply_rope`` then :func:`mha_reference`, plain autograd); with
  ``remat`` each block is checkpointed (recomputed in the backward);
* the paged forward (``pos`` given, a paged ``cache``): the engine's paged
  arena, :meth:`Attention.paged_attend` (the port of
  ``_paged_attend_slots``), which ends in
  :func:`~dtdl_tpu_torch.ops.paged_attention.paged_attention` (kernel K4 on
  the card) or, for ``paged_kernel=False``, its plain version;
* the per-slot dense forward (``pos`` given, a dense ``cache`` from
  ``init_cache(B, per_slot_index=True)``): the engine's dense arena, each
  row a slot at its own position, :meth:`Attention.slots_attend` (the port
  of ``_verify_attend_slots``, plain torch as the JAX one is plain jnp);
* the dense decode forward (``cache`` from :meth:`TransformerLM.init_cache`,
  no ``pos``): every row at the cache's one host-side index, the port of
  ``_decode_attend``'s scalar-index path (plain torch), which
  :func:`generate`, the model draft and the dense engine's prefill run on.

A cache or arena with ``kv_dtype`` int8/fp8 holds quantized K/V with a
scale per (row or page, head, position): each new row is quantized as it
is written (:func:`~dtdl_tpu_torch.quant.core.kv_quantize`) and the attend
applies the key scale to the logits and the value scale to the weights.

The forward returns the MoE blocks' Switch load-balance values only when
asked (``return_aux=True``, the train step): each block returns its value
(a checkpointed block's recompute returns it again and records nothing),
and serving computes none.  A forward given ``lora=(bank, aids)`` adds each
row's LoRA delta, gathered from an adapter bank by the row's adapter id,
to the q/k/v and output projections (the engine's multi-LoRA serving).

A placement by the GSPMD rule sets (:mod:`dtdl_tpu_torch.parallel.tensor`)
runs these modules on a rank's shards: attention takes the heads its q/k/v
kernels hold and the caches size their heads by :attr:`TransformerLM.
kv_heads`; the collectives ride forward hooks on attention and SwiGLU and
the ``shard`` objects of the LM (vocab-parallel embedding and head) and of
a routed MoE (its groups and experts over ranks).
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass, fields, replace
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from dtdl_tpu_torch.device import resolve_device, upload
from dtdl_tpu_torch.ops.attention import flash_attention, mha_reference
from dtdl_tpu_torch.ops.paged_attention import (NEG_INF, paged_attention,
                                                paged_attention_reference)
from dtdl_tpu_torch.ops.rope import apply_rope, rope_frequencies, rotate
from dtdl_tpu_torch.quant.core import (canon_kv_dtype, canon_weight_quant,
                                       kv_quantize, kv_scale_dtype,
                                       quantize_params, weight_dtypes)
from dtdl_tpu_torch.quant.layers import QuantLinear


class CacheOverflowError(ValueError):
    """A dense decode step would write past the KV cache (``max_seq``)."""


class _Kernel(nn.Module):
    """One weight tensor under the flax param name ``kernel``, whose first
    ``n_in`` dims are contracted by :meth:`forward`."""

    def __init__(self, *shape, n_in: int = 1, dtype, device):
        super().__init__()
        self.n_in = n_in
        self.kernel = nn.Parameter(torch.empty(*shape, dtype=dtype,
                                               device=device))

    def forward(self, x, dtype):
        """``x`` [..., prod(in_dims)] @ the kernel cast to ``dtype``."""
        k = self.kernel
        return torch.matmul(
            x, k.reshape(math.prod(k.shape[:self.n_in]), -1).to(dtype))


def _weight(*shape, n_in=1, quantize, param_dtype, device):
    """A matmul weight: quantized (``quantize`` True or 'w8f') or float."""
    if quantize:
        return QuantLinear(*shape, n_in=n_in, mode=quantize, device=device)
    return _Kernel(*shape, n_in=n_in, dtype=param_dtype, device=device)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(dim, dtype=torch.float32,
                                             device=device))

    def forward(self, x):
        # x·rsqrt(mean(x²) + eps)·scale in f32, one fused op (the scale read
        # once: a sharded placement gathers it at each read)
        scale = self.scale
        return F.rms_norm(x.float(), scale.shape, scale,
                          self.eps).to(self.dtype)


class Attention(nn.Module):
    """q/k/v/out projections around the cacheless attention (flash or
    dense) or one of the cached attends."""

    def __init__(self, d_model: int, n_heads: int, head_dim: int, *, dtype,
                 param_dtype, attn_impl: str, device, quantize=False):
        super().__init__()
        if attn_impl not in ("flash", "dense"):
            raise ValueError(f"attn_impl must be 'flash' or 'dense', got "
                             f"{attn_impl!r}")
        self.n_heads, self.head_dim = n_heads, head_dim
        self.dtype, self.attn_impl = dtype, attn_impl
        for name in ("q", "k", "v"):
            setattr(self, name, _weight(d_model, n_heads, head_dim,
                                        quantize=quantize,
                                        param_dtype=param_dtype,
                                        device=device))
        self.out = _weight(n_heads, head_dim, d_model, n_in=2,
                           quantize=quantize, param_dtype=param_dtype,
                           device=device)

    def _proj(self, x, w, lora=None, name=None):
        # the heads this module holds: all of them, or a tensor-parallel
        # rank's share (parallel/tensor.py)
        b, s, _ = x.shape
        y = w(x, self.dtype)
        if lora is not None:
            a, bb = lora[name + "_a"], lora[name + "_b"]      # [B, d, r]
            t = torch.bmm(x.to(a.dtype), a)                   # [B, S, r]
            y = y + torch.bmm(t, bb.reshape(b, bb.shape[1], -1)).to(y.dtype)
        return y.reshape(b, s, -1, self.head_dim).transpose(1, 2)

    def forward(self, x, cos, sin, layer=None, step=None, lora=None):
        """``lora``: this layer's adapter rows gathered by the batch rows'
        adapter ids (``{leaf: [B, ...]}``, :func:`_lora_rows`), or None.
        Each q/k/v projection then gains ``(x @ A) @ B`` and the output
        projection ``(o @ out_A) @ out_B``, computed in the factors' dtype
        (f32) and cast to the projection's, as the JAX package's
        ``lo_delta`` (a quantized projection takes it on its output).

        On a tensor-parallel rank the rows hold this rank's heads
        (``tenant.lora.bank_pspecs``): ``x @ A`` is whole and ``@ B`` gives
        the rank's heads, and ``(o @ out_A) @ out_B`` over the rank's
        heads is a partial sum that the ``psum`` after this module
        (``parallel/tensor.py`` ``_megatron_hooks``) adds up with the
        projection's.  JAX sums ``o @ out_A`` over every head before
        ``@ out_B``: the same function, rounded in another order."""
        if lora is None:
            q, k, v = (self._proj(x, w) for w in (self.q, self.k, self.v))
        else:
            q, k, v = (self._proj(x, w, lora, name) for w, name in
                       ((self.q, "q"), (self.k, "k"), (self.v, "v")))
        if isinstance(step, SlotStep):
            attend = (self.paged_attend if step.page_table is not None
                      else self.slots_attend)
            o = attend(q, k, v, layer, step)
        elif step is not None:
            o = self.dense_attend(q, k, v, layer, step, cos, sin)
        elif self.attn_impl == "flash":
            o = flash_attention(q, k, v, causal=True, rope=(cos, sin))
        else:
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
            o = mha_reference(q, k, v, causal=True).to(self.dtype)
        b, _, s, _ = o.shape
        o = o.transpose(1, 2).reshape(b, s, -1)
        out = self.out(o, self.dtype)
        if lora is not None:
            a = lora["out_a"]                                # [B, H, D, r]
            t = torch.bmm(o.to(a.dtype), a.reshape(b, -1, a.shape[-1]))
            out = out + torch.bmm(t, lora["out_b"]).to(out.dtype)
        return out

    @staticmethod
    def _write(layer, names, step, k, v):
        """Scatter the new rows ``k``/``v`` [B, H, S, D] into this layer's
        buffers ``names`` (key, value) at ``step.scatter_at``; a quantized
        cache (``<name>_scale`` leaves present) takes each row quantized
        with its own scale.  Returns the (key scale, value scale) buffers,
        (None, None) for an unquantized cache."""
        nk, nv = names
        scales = (layer.get(nk + "_scale"), layer.get(nv + "_scale"))
        for name, new, sc in ((nk, k, scales[0]), (nv, v, scales[1])):
            buf = layer[name]
            b, h, s_new, d = new.shape
            if sc is not None:
                new, row_scale = kv_quantize(new, buf.dtype)
                sc.index_put_(step.scatter_at,
                              row_scale.transpose(1, 2).reshape(b * s_new, h))
            buf.index_put_(step.scatter_at, new.transpose(1, 2).reshape(
                b * s_new, h, d).to(buf.dtype))
        return scales

    def paged_attend(self, q, k, v, layer, step: "SlotStep"):
        """Attend ``s_new`` new rows per slot against the block-paged
        arena (the port of ``_paged_attend_slots``): ``layer`` is this
        layer's arena node (``pages_key``/``pages_value`` and, for a
        quantized pool, their ``_scale`` sidecars [n_pages, H, page]),
        ``step`` the call's :class:`SlotStep`.  The new rows are roped at
        their positions, scattered into the pools through each row's page
        table (inactive rows to the garbage page 0; quantized on the way
        in), and every query row attends its row's columns up to its own
        position.  The pools are updated in place (``index_put_``) where
        the JAX program returned a new donated arena."""
        q = rotate(q, step.cos, step.sin)
        k = rotate(k, step.cos, step.sin)
        ks, vs = self._write(layer, ("pages_key", "pages_value"), step, k, v)
        attend = paged_attention if step.kernel \
            else paged_attention_reference
        return attend(q, layer["pages_key"], layer["pages_value"],
                      step.page_table, step.pos, step.active_i32,
                      scale=1.0 / math.sqrt(q.shape[-1]), key_scale=ks,
                      value_scale=vs)

    def slots_attend(self, q, k, v, layer, step: "SlotStep"):
        """Attend ``s_new`` new rows per slot against the dense serving
        arena (the port of ``_verify_attend_slots``): row b of ``layer``'s
        ``key``/``value`` [B, H, max_seq, D] buffers is slot b, its new
        rows roped at ``pos[b]..``, written at [pos[b], pos[b] + s_new)
        of its own row (inactive rows too: garbage in their own row,
        overwritten before it is attended) and attending every column up
        to each row's own position."""
        q = rotate(q, step.cos, step.sin)
        k = rotate(k, step.cos, step.sin)
        ks, vs = self._write(layer, ("key", "value"), step, k, v)
        return self._attend(q, layer["key"], layer["value"], step.qpos, ks,
                            vs)

    # query rows attend in blocks of this many, so a long prefill holds
    # [B, H, PREFILL_CHUNK, max_seq] f32 logits at a time, not the prompt's
    PREFILL_CHUNK = 256

    def dense_attend(self, q, k, v, layer, pos: int, cos, sin):
        """Attend ``s_new`` new rows per batch row at the one position
        ``pos`` against the dense cache (the port of ``_decode_attend``'s
        scalar-index path): the new rows are roped at pos.., their K/V
        written at [pos, pos + s_new) of this layer's ``key``/``value``
        [B, H, max_seq, D] buffers (quantized, with their ``_scale``
        rows, in an int8/fp8 cache), and each query row attends every
        cached column up to its own position."""
        s_new = q.shape[2]
        q = apply_rope(q, cos, sin, offset=pos)
        k = apply_rope(k, cos, sin, offset=pos)
        ck, cv = layer["key"], layer["value"]
        ks, vs = layer.get("key_scale"), layer.get("value_scale")
        if ks is not None:
            k, k_scale = kv_quantize(k, ck.dtype)
            v, v_scale = kv_quantize(v, cv.dtype)
            ks[:, :, pos:pos + s_new] = k_scale
            vs[:, :, pos:pos + s_new] = v_scale
        ck[:, :, pos:pos + s_new] = k.to(ck.dtype)
        cv[:, :, pos:pos + s_new] = v.to(cv.dtype)
        qpos = pos + torch.arange(s_new, device=q.device)[None]
        return self._attend(q, ck, cv, qpos, ks, vs)

    def _attend(self, q, keys, values, qpos, key_scale=None,
                value_scale=None):
        """Query rows ``q`` [B, H, S, D] at positions ``qpos`` [B or 1, S]
        against cached ``keys``/``values`` [B, H, L, D]: f32 logits (times
        the key scale of a quantized cache), scaled, masked at -1e30 past
        each row's position, softmax, the weights (times the value scale)
        cast to the compute dtype before P·V; in blocks of
        ``PREFILL_CHUNK`` query rows."""
        s_new, d = q.shape[2], q.shape[3]
        quant = key_scale is not None
        keys_t = keys.to(self.dtype).float().transpose(-1, -2)
        values = values.to(self.dtype)
        scale = 1.0 / math.sqrt(d)
        cols = torch.arange(keys.shape[2], device=q.device)
        out = []
        for c0 in range(0, s_new, self.PREFILL_CHUNK):
            rows = q[:, :, c0:c0 + self.PREFILL_CHUNK]
            mask = cols <= qpos[:, c0:c0 + rows.shape[2], None]
            logits = torch.matmul(rows.float(), keys_t)
            if quant:
                logits = logits * key_scale.float()[:, :, None, :]
            logits = torch.where(mask[:, None], logits * scale,
                                 torch.full_like(logits, NEG_INF))
            probs = torch.softmax(logits, dim=-1)
            if quant:
                probs = probs * value_scale.float()[:, :, None, :]
            out.append(torch.matmul(probs.to(self.dtype), values))
        return torch.cat(out, dim=2)


class SwiGLU(nn.Module):
    def __init__(self, d_model: int, d_ff: int, *, dtype, param_dtype,
                 device, quantize=False):
        super().__init__()
        self.dtype = dtype
        for name, shape in (("wi", (d_model, d_ff)), ("wg", (d_model, d_ff)),
                            ("wo", (d_ff, d_model))):
            setattr(self, name, _weight(*shape, quantize=quantize,
                                        param_dtype=param_dtype,
                                        device=device))

    def forward(self, x):
        dt = self.dtype
        h = F.silu(self.wg(x, dt)) * self.wi(x, dt)
        return self.wo(h, dt)


class _Router(nn.Module):
    """An MoE router: a [d_model, E] f32 ``kernel`` applied in f32 to the
    f32 input, whatever the compute and parameter dtypes (the JAX router
    is an f32 Dense), and never quantized."""

    def __init__(self, d_model: int, n_experts: int, device):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(d_model, n_experts,
                                               dtype=torch.float32,
                                               device=device))

    def forward(self, x):
        return torch.matmul(x.float(), self.kernel)


class MoE(nn.Module):
    """Mixture-of-experts MLP, the port of the JAX ``MoE``: a softmax
    router over ``n_experts`` SwiGLU experts (``wi``/``wg`` [E, D, F],
    ``wo`` [E, F, D]) and two dispatch modes with the same parameters.

    ``'dense'`` (the numerics oracle, top-1 only): every expert over every
    token, the output weighted by the first choice's prob.  ``'routed'``:
    capacity-factor top-k over routing groups of ``g = min(group_size or
    1024, S)`` consecutive tokens of a batch row (a ragged tail padded and
    masked out of routing), ``C = min(g, ceil(cf·g·k/E))`` slots per
    expert and group, filled choice-major in token order; a token past
    capacity is dropped (its residual passes).  Top-k takes the lower
    expert index first on equal probs (``lax.top_k``'s order) and
    renormalizes the k gates when k > 1.  Dispatch and combine go by index
    (the slot of each kept (token, choice) into an [E, groups·C, D]
    buffer and back), which computes the one-hot einsums' function: each
    slot holds at most one token, and the combine sums each token's k
    gated outputs in f32 before the one rounding to the compute dtype,
    the gate rounded to the compute dtype first, as JAX rounds
    ``combine``.

    ``forward(x, want_aux)`` returns ``(y, aux)``: ``aux`` the Switch
    load-balance value ``E · Σ_e mean(first-choice one-hot) · mean(probs)``
    over the unpadded tokens when ``want_aux``, else None."""

    EXPERT_WEIGHTS = ("wi", "wg", "wo")
    # the tensor- or expert-parallel placement's dispatch
    # (parallel/tensor.py); None on one device
    shard = None

    def __init__(self, d_model: int, d_ff: int, n_experts: int, *, dtype,
                 param_dtype, device, dispatch: str = "dense",
                 capacity_factor: float = 1.25, top_k: int = 1,
                 group_size: int = 0, quantize=False):
        super().__init__()
        if not 1 <= top_k <= n_experts:
            raise ValueError(f"top_k={top_k} must be in "
                             f"[1, n_experts={n_experts}]")
        if dispatch == "dense" and top_k != 1:
            raise ValueError("dense dispatch is top-1 only; top_k="
                             f"{top_k} requires dispatch='routed'")
        if dispatch not in ("dense", "routed"):
            raise ValueError(f"unknown MoE dispatch {dispatch!r}")
        self.n_experts, self.top_k, self.dtype = n_experts, top_k, dtype
        self.dispatch, self.capacity_factor = dispatch, capacity_factor
        self.group_size, self.quantize = group_size, quantize
        self.router = _Router(d_model, n_experts, device)
        shapes = {"wi": (d_model, d_ff), "wg": (d_model, d_ff),
                  "wo": (d_ff, d_model)}
        for name, (d_in, d_out) in shapes.items():
            shape = (n_experts, d_in, d_out)
            if quantize:
                payload, scale_dtype = weight_dtypes(quantize)
                setattr(self, name, nn.Parameter(
                    torch.zeros(shape, dtype=payload, device=device),
                    requires_grad=False))
                setattr(self, name + "_scale", nn.Parameter(
                    torch.ones((n_experts, 1, d_out), dtype=scale_dtype,
                               device=device), requires_grad=False))
            else:
                setattr(self, name, nn.Parameter(torch.empty(
                    shape, dtype=param_dtype, device=device)))

    def _emm(self, x, name):
        """Expert matmul ``x`` [E, rows, in] @ this expert weight, in the
        compute dtype; a quantized weight's per-(expert, out-channel)
        scale multiplies the output in f32."""
        y = torch.bmm(x, getattr(self, name).to(self.dtype))
        scale = getattr(self, name + "_scale", None)
        if scale is not None:
            y = (y.float() * scale.float()).to(self.dtype)
        return y

    def _experts(self, xe):
        """SwiGLU of every expert this module holds over its rows ``xe``
        [E, rows, D]."""
        return self._emm(F.silu(self._emm(xe, "wg"))
                         * self._emm(xe, "wi"), "wo")

    def forward(self, x, want_aux: bool = False):
        E = self.n_experts
        probs = torch.softmax(self.router(x), dim=-1)          # [b, s, E]
        aux = None
        if want_aux:
            onehot1 = F.one_hot(probs.argmax(-1), E).float()
            aux = E * torch.sum(onehot1.mean((0, 1)) * probs.mean((0, 1)))
        if self.dispatch == "routed":
            return self._routed(x, probs), aux
        b, s, d = x.shape
        first = probs.argmax(-1)        # the lowest index among equal probs
        gate = probs.gather(-1, first[..., None])               # [b, s, 1]
        onehot = F.one_hot(first, E).to(self.dtype)
        xe = onehot.permute(2, 0, 1)[..., None] * x[None]       # [E,b,s,D]
        h = F.silu(self._emm(xe.reshape(E, b * s, d), "wg")) \
            * self._emm(xe.reshape(E, b * s, d), "wi")          # [E,bs,F]
        if self.quantize:
            # each expert's output scale cannot factor out of a
            # cross-expert contraction: keep the expert axis, then sum
            y = self._emm(h, "wo").sum(0)
        else:
            y = torch.matmul(h.transpose(0, 1).reshape(b * s, -1),
                             self.wo.to(self.dtype).reshape(-1, d))
        return y.reshape(b, s, d) * gate.to(self.dtype), aux

    def _routed(self, x, probs):
        b, s_full, d = x.shape
        E, k = self.n_experts, self.top_k
        g = min(self.group_size or 1024, s_full)
        pad = -s_full % g
        if pad:
            x = F.pad(x, (0, 0, 0, pad))
            probs = F.pad(probs, (0, 0, 0, pad))
        n_groups = b * ((s_full + pad) // g)
        valid = (torch.arange(s_full + pad, device=x.device) < s_full)
        valid = valid.reshape(-1, g).repeat(b, 1)               # [G, g]
        C = min(g, int(math.ceil(self.capacity_factor * g * k / E)))
        args = (x.reshape(n_groups, g, d), probs.reshape(n_groups, g, E),
                valid, C)
        out = (self._groups(*args) if self.shard is None
               else self.shard.groups(self, *args))
        return out.reshape(b, s_full + pad, d)[:, :s_full]

    def _groups(self, x, probs, valid, C: int):
        """Route, dispatch, the experts and combine over routing groups
        ``x`` [G, g, D] with their ``probs`` [G, g, E] and ``valid``
        [G, g] tokens at ``C`` slots per expert and group: [G, g, D] in
        the compute dtype (an expert-parallel placement runs it on its
        share of the groups)."""
        n_groups, g, d = x.shape
        E, k = self.n_experts, self.top_k
        gates, dest = self._route(probs, valid, C)
        # dispatch: each kept (token, choice) to its slot of the expert
        # buffer, the dropped ones to its trash row
        trash = E * n_groups * C
        x = x.reshape(n_groups * g, d)
        xe = x.new_zeros(trash + 1, d).index_put(
            (dest.reshape(-1),), x.expand(k, -1, -1).reshape(-1, d))
        experts = (self._experts if self.shard is None
                   else lambda t: self.shard.experts(self, t))
        y = experts(xe[:trash].view(E, n_groups * C, d))
        # combine: each token's k gated outputs (a dropped one reads the
        # zero row) summed in f32, the gates rounded to the compute dtype.
        # index_select, whose backward adds by atomics: the backward of
        # y[dest] sorts the indices and adds each run of equal ones in
        # series, and every dropped token's index is the zero row
        y = torch.cat([y.reshape(trash, d), y.new_zeros(1, d)])
        gates = gates.reshape(-1, k).to(self.dtype).float()     # [G·g, k]
        out = sum(gates[:, j, None] * y.index_select(0, dest[j]).float()
                  for j in range(k))
        return out.to(self.dtype).reshape(n_groups, g, d)

    def _route(self, probs, valid, C: int):
        """Top-k choices of ``probs`` [G, g, E] over the ``valid`` [G, g]
        tokens of each group, filled choice-major into ``C`` slots per
        expert: ``(gates [G, g, k], dest [k, G·g])``, dest the row of the
        [E·G·C + 1] expert buffer each (choice, token) goes to, the last
        row (trash) for a dropped or padding one."""
        n_groups, g, E = probs.shape
        k = self.top_k
        # top-k, the lower index first among equal probs
        gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        gates, idx = gates[..., :k], idx[..., :k]               # [G, g, k]
        if k > 1:
            gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
        # the slot of (token, choice j) in its expert: the earlier tokens'
        # choices j of that expert plus the slots every earlier choice
        # claimed, kept or not
        group = torch.arange(n_groups, device=probs.device)[:, None]
        taken = torch.zeros(n_groups, 1, E, dtype=torch.long,
                            device=probs.device)
        dest = []
        for j in range(k):
            e = idx[..., j]                                     # [G, g]
            m = F.one_hot(e, E) * valid[..., None]
            slot = (torch.cumsum(m, 1) - m + taken).gather(-1, e[..., None])
            slot = slot[..., 0]
            keep = valid & (slot < C)
            dest.append(torch.where(keep, (e * n_groups + group) * C + slot,
                                    E * n_groups * C).reshape(-1))
            taken = taken + m.sum(1, keepdim=True)
        return gates, torch.stack(dest)


class Block(nn.Module):
    def __init__(self, cfg: "LMConfig", *, param_dtype, device,
                 moe: bool = False):
        super().__init__()
        dt = cfg.dtype
        self.ln_attn = RMSNorm(cfg.d_model, dtype=dt, device=device)
        self.attn = Attention(cfg.d_model, cfg.n_heads, cfg.head_dim,
                              dtype=dt, param_dtype=param_dtype,
                              attn_impl=cfg.attn_impl, device=device,
                              quantize=cfg.quantize)
        self.ln_mlp = RMSNorm(cfg.d_model, dtype=dt, device=device)
        if moe:
            self.moe = MoE(cfg.d_model, cfg.d_ff, cfg.n_experts, dtype=dt,
                           param_dtype=param_dtype, device=device,
                           dispatch=cfg.moe_dispatch,
                           capacity_factor=cfg.capacity_factor,
                           top_k=cfg.moe_top_k,
                           group_size=cfg.moe_group_size,
                           quantize=cfg.quantize)
        else:
            self.mlp = SwiGLU(cfg.d_model, cfg.d_ff, dtype=dt,
                              param_dtype=param_dtype, device=device,
                              quantize=cfg.quantize)

    def forward(self, x, cos, sin, layer=None, step=None,
                want_aux: bool = False, lora=None):
        """(the block's output, its MoE load-balance value when
        ``want_aux``, else None; always None for a dense block).  ``lora``
        is this block's gathered adapter rows (see :meth:`Attention.
        forward`)."""
        x = x + self.attn(self.ln_attn(x), cos, sin, layer, step, lora)
        aux = None
        if hasattr(self, "moe"):
            y, aux = self.moe(self.ln_mlp(x), want_aux)
            x = x + y
        else:
            x = x + self.mlp(self.ln_mlp(x))
        return x, aux


@dataclass(frozen=True)
class LMConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 8
    n_heads: int = 8
    d_ff: int = 1408
    max_seq: int = 2048
    n_experts: int = 0            # 0: every block a dense SwiGLU MLP
    moe_every: int = 2            # every k-th block is MoE (n_experts > 0)
    moe_dispatch: str = "dense"   # 'dense' oracle | 'routed' capacity top-k
    capacity_factor: float = 1.25  # routed: slots = ceil(cf * g * k / E)
    moe_top_k: int = 1            # routed: experts per token
    moe_group_size: int = 0       # routing group (0 = min(seq, 1024))
    attn_impl: str = "flash"      # 'flash' | 'dense'
    remat: bool = False           # checkpoint every block when training
    dtype: torch.dtype = torch.bfloat16
    quantize: Any = False         # weight-only: True int8, 'w8f' fp8

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


@dataclass
class SlotStep:
    """What every layer of one per-slot forward shares, computed once per
    call: the rows' clamped positions and the positions of their new
    tokens, the scatter coordinates of those tokens and their rope rows.
    On a paged arena (``page_table`` given) the coordinates are (physical
    page, heads, offset), inactive rows routed to the garbage page 0, and
    ``kernel`` says whether to attend through the kernel wrapper
    (:func:`paged_attention`) or its plain version; on the dense arena
    they are (slot row, heads, position)."""
    page_table: torch.Tensor | None   # [B, n_ptab] int32, None: dense
    active_i32: torch.Tensor   # [B]
    pos: torch.Tensor          # [B] clamped positions
    qpos: torch.Tensor         # [B, S] positions of the new tokens
    scatter_at: tuple          # ([B*S, 1], [1, H], [B*S, 1]) index_put_
    cos: torch.Tensor          # [B, 1, S, D/2] f32 rope rows
    sin: torch.Tensor
    kernel: bool = True

    @classmethod
    def build(cls, page_table, active, pos, *, s_new, page, n_heads,
              rope_cos, rope_sin, kernel):
        """``page_table`` None (and ``page`` ignored) for the dense arena."""
        max_len = rope_cos.shape[0]
        # identity for active rows (caller contract); keeps stale inactive
        # rows inside every table
        pos_safe = pos.clamp(0, max_len - s_new)
        g = pos_safe[:, None] + torch.arange(s_new, device=pos.device)
        heads = torch.arange(n_heads, device=pos.device)[None, :]
        if page_table is None:
            rows = torch.arange(pos.shape[0], device=pos.device)[:, None]
            at = (rows.expand_as(g).reshape(-1, 1), heads, g.reshape(-1, 1))
        else:
            page_table = page_table.to(torch.int32)
            phys = torch.gather(page_table, 1,
                                (g // page).clamp(0, page_table.shape[1] - 1))
            page_idx = torch.where(active[:, None], phys,
                                   torch.zeros_like(phys))
            at = (page_idx.reshape(-1, 1).long(), heads,
                  (g % page).reshape(-1, 1))
        return cls(page_table=page_table, active_i32=active.to(torch.int32),
                   pos=pos_safe, qpos=g, scatter_at=at,
                   cos=rope_cos[g].float()[:, None],
                   sin=rope_sin[g].float()[:, None], kernel=kernel)


# the calling thread's block beat: a fleet replica's worker heartbeat,
# called after each block of a cached (serving) forward, so that a long
# eager prefill beats once a layer and not only once it returns
_BLOCK_BEAT = threading.local()


def set_block_beat(fn) -> None:
    """Have this thread call ``fn()`` after each block of every cached
    forward it runs (``None``: stop)."""
    _BLOCK_BEAT.fn = fn


class TransformerLM(nn.Module):
    """Decoder-only LM: int tokens [batch, seq] -> f32 logits.  Matmul
    weights and the embedding are held in ``param_dtype`` (f32, as flax
    holds them; :meth:`compute_copy` builds the serving twin)."""

    # the tensor-parallel placement's vocab-parallel embedding and head
    # (parallel/tensor.py); None on one device
    shard = None

    def __init__(self, cfg: LMConfig, device=None,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.param_dtype = param_dtype
        dev = resolve_device(device)
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model,
                                              dtype=param_dtype, device=dev))
        for i in range(cfg.n_layers):
            moe = cfg.n_experts > 0 and (i + 1) % cfg.moe_every == 0
            self.add_module(f"block_{i}", Block(cfg, param_dtype=param_dtype,
                                                device=dev, moe=moe))
        self.ln_f = RMSNorm(cfg.d_model, dtype=cfg.dtype, device=dev)
        cos, sin = rope_frequencies(cfg.head_dim, cfg.max_seq, device=dev)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    @property
    def device(self) -> torch.device:
        return self.rope_cos.device

    @property
    def blocks(self):
        return [getattr(self, f"block_{i}") for i in range(self.cfg.n_layers)]

    def compute_copy(self) -> "TransformerLM":
        """A frozen twin for serving whose matmul weights and embedding
        are held in the compute dtype (norm scales stay f32, a quantized
        model's payloads and scales as they are), copied once so that the
        eager decode step does not cast every weight per call.  The model
        itself when its weights are in the compute dtype already (an f32
        model)."""
        if self.param_dtype == self.cfg.dtype:
            return self
        twin = self.clone(param_dtype=self.cfg.dtype)
        twin.load_state_dict(self.state_dict())
        return twin.requires_grad_(False)

    def clone(self, param_dtype=None, **overrides) -> "TransformerLM":
        """A new model on this one's device with :class:`LMConfig` fields
        replaced by ``overrides`` (``quantize=``, ...) and weights left
        uninitialized (a quantized one's at zero payloads and unit
        scales)."""
        return TransformerLM(replace(self.cfg, **overrides),
                             device=self.device,
                             param_dtype=param_dtype or self.param_dtype)

    def init_weights(self, seed: int = 0) -> "TransformerLM":
        """Random weights from ``seed`` (torch.Generator on the CPU, so
        the same seed gives the same weights on every device): normal
        embedding (std 0.02), fan-in scaled normal matmul kernels (an
        expert weight's fan-in leaves out its expert dim), unit norm
        scales.  A quantized model takes the float model's weights
        from the same seed, quantized
        (:func:`~dtdl_tpu_torch.quant.core.quantize_params`)."""
        if self.cfg.quantize:
            src = self.clone(quantize=False).init_weights(seed)
            self.load_state_dict(quantize_params(src, src.state_dict(),
                                                 self.cfg.quantize))
            return self
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith(".scale"):
                    p.fill_(1.0)
                    continue
                if name == "embed":
                    std = 0.02
                elif name.endswith("out.kernel"):
                    std = 1.0 / math.sqrt(p.shape[0] * p.shape[1])
                elif name.rsplit(".", 1)[-1] in MoE.EXPERT_WEIGHTS:
                    std = 1.0 / math.sqrt(p.shape[1])
                else:
                    std = 1.0 / math.sqrt(p.shape[0])
                p.copy_(torch.randn(p.shape, generator=gen) * std)
        return self

    def forward(self, tokens, *, return_hidden: bool = False, pos=None,
                cache=None, page_table=None, active=None,
                paged_kernel: bool = True, return_aux: bool = False,
                lora=None):
        """Cacheless forward (no ``cache``); a per-slot forward (``pos``
        [B] the rows' write positions): on the engine's paged arena
        (:meth:`init_paged_cache`) with ``page_table`` [B, n_ptab],
        ``active`` [B] bool and ``paged_kernel=False`` attending through
        the plain version instead of the kernel wrapper, or on its dense
        arena (``init_cache(B, per_slot_index=True)``), the K/V updated
        in place and the arena's ``index`` the engine's to advance; or a
        dense decode forward (``cache`` from :meth:`init_cache`, no
        ``pos``): the tokens are written at the cache's host index, which
        advances by their count.  ``return_aux`` returns ``(out, aux)``:
        ``aux`` the MoE blocks' load-balance values, one 0-d tensor per
        MoE block in block order (empty for a dense model).

        ``lora`` = ``(bank, aids)`` serves each batch row under its own
        LoRA adapter: ``bank`` an adapter bank (:func:`~dtdl_tpu_torch.
        serve.tenant.lora.init_bank`, ``{"block_i": {"attn": {leaf:
        [n_adapters, ...]}}}``), ``aids`` [B] int row ids on the model's
        device (row 0 the all-zeros base).  Per-call data, not module
        state, so one model serves a batch that mixes adapters."""
        x = self.embed_tokens(tokens)
        step = None
        if cache is not None and pos is None:
            step = int(cache["index"])
            if step + tokens.shape[1] > self.cfg.max_seq:
                raise CacheOverflowError(
                    f"decode at position {step} with {tokens.shape[1]} new "
                    f"token(s) exceeds max_seq={self.cfg.max_seq}")
        elif pos is not None:
            layer = cache["block_0"]["attn"]
            paged = "pages_key" in layer
            if paged and page_table is None:
                raise ValueError("a paged arena needs page_table")
            if active is None:
                active = torch.ones(pos.shape[0], dtype=torch.bool,
                                    device=pos.device)
            step = SlotStep.build(
                page_table if paged else None, active, pos,
                s_new=tokens.shape[1],
                page=layer["pages_key"].shape[2] if paged else 0,
                n_heads=layer["pages_key" if paged else "key"].shape[1],
                rope_cos=self.rope_cos,
                rope_sin=self.rope_sin, kernel=paged_kernel)
        # remat is a training-time memory/FLOPs trade: never under decode
        remat = self.cfg.remat and step is None and torch.is_grad_enabled()
        aux = []
        beat = None if step is None else getattr(_BLOCK_BEAT, "fn", None)
        for i, block in enumerate(self.blocks):
            layer = None if step is None else cache[f"block_{i}"]["attn"]
            args = (x, self.rope_cos, self.rope_sin, layer, step, return_aux)
            if lora is not None:
                args += (_lora_rows(lora, i),)
            x, a = (checkpoint(block, *args, use_reentrant=False) if remat
                    else block(*args))
            if a is not None:
                aux.append(a)
            if beat is not None:
                beat()
        if cache is not None and pos is None:
            cache["index"].fill_(step + tokens.shape[1])
        x = self.ln_f(x)
        out = x if return_hidden else self.head(x)
        return (out, aux) if return_aux else out

    def embed_tokens(self, tokens):
        """The embedding rows of ``tokens`` in the compute dtype."""
        if self.shard is not None:
            return self.shard.embed(self, tokens)
        return self.embed[tokens].to(self.cfg.dtype)

    def head(self, x):
        """Tied output head ``x @ embed.T`` in the compute dtype, as f32
        (over the whole vocab, under a vocab-parallel placement too)."""
        if self.shard is not None:
            return self.shard.head(self, x)
        return self.local_head(x)

    def local_head(self, x):
        """``x @ embed.T`` over the embedding rows this module holds."""
        return torch.matmul(x, self.embed.to(self.cfg.dtype).t()).float()

    def _kv_leaves(self, shape, kv_dtype, names) -> dict:
        """The K/V leaves ``names`` of ``shape`` [.., L, head_dim] in the
        compute dtype, or in ``kv_dtype`` with ``<name>_scale`` [.., L]
        sidecars."""
        kv_dtype = canon_kv_dtype(kv_dtype)
        out = {n: (shape, kv_dtype or self.cfg.dtype) for n in names}
        if kv_dtype is not None:
            out.update({n + "_scale": (shape[:-1], kv_scale_dtype(kv_dtype))
                        for n in names})
        return out

    @property
    def kv_heads(self) -> int:
        """The heads whose K/V this module's attention computes: all of
        them, or a tensor-parallel rank's share."""
        return self.cfg.n_heads // (1 if self.shard is None
                                    else self.shard.heads_split)

    def cache_shapes(self, batch_size: int, per_slot_index: bool = False,
                     kv_dtype=None, n_heads: int | None = None) -> dict:
        """Shapes and dtypes of the dense cache for ``batch_size`` rows:
        per block a ``key``/``value`` buffer [B, H, max_seq, head_dim] in
        the compute dtype, plus one int32 ``index`` for all blocks (the
        JAX tree keeps an identical copy per block): a scalar, or with
        ``per_slot_index`` a [B] vector (the engine's dense arena, each
        row a slot at its own position).  ``kv_dtype`` 'int8' or 'fp8'
        stores the K/V quantized with ``key_scale``/``value_scale``
        [B, H, max_seq] sidecars (f32 for int8, bf16 for fp8).  H is
        ``n_heads``, by default :attr:`kv_heads`."""
        cfg = self.cfg
        h = self.kv_heads if n_heads is None else n_heads
        kv = self._kv_leaves((batch_size, h, cfg.max_seq,
                              cfg.head_dim), kv_dtype, ("key", "value"))
        out = {f"block_{i}": {"attn": dict(kv)} for i in range(cfg.n_layers)}
        out["index"] = (((batch_size,) if per_slot_index else ()),
                        torch.int32)
        return out

    def init_cache(self, batch_size: int, per_slot_index: bool = False,
                   kv_dtype=None) -> dict:
        """A zeroed dense cache (see :meth:`cache_shapes`): the K/V
        buffers on the model's device; a scalar ``index`` on the host (a
        CPU tensor), so a step's position is known without reading the
        card, a per-slot one on the device beside the K/V."""
        out = _alloc(self.cache_shapes(batch_size, per_slot_index, kv_dtype),
                     self.device)
        if not per_slot_index:
            out["index"] = torch.zeros((), dtype=torch.int32)
        return out

    def paged_cache_shapes(self, n_slots: int, n_pages: int, page_size: int,
                           kv_dtype=None, n_heads: int | None = None) -> dict:
        """Shapes and dtypes of the block-paged serving arena: per block a
        ``pages_key``/``pages_value`` pool [n_pages, H, page_size,
        head_dim] (page 0 is the reserved garbage page), plus one
        ``index`` [n_slots] int32 for all blocks (the JAX tree keeps an
        identical copy per block).  ``kv_dtype`` 'int8' or 'fp8' makes the
        pools int8 or float8_e4m3fn with ``pages_key_scale``/
        ``pages_value_scale`` [n_pages, H, page_size] sidecars (f32 for
        int8, bf16 for fp8) that ride with their page.  H is ``n_heads``,
        by default :attr:`kv_heads`."""
        cfg = self.cfg
        if page_size < 1 or cfg.max_seq % page_size:
            raise ValueError(f"page_size must be >= 1 and divide max_seq="
                             f"{cfg.max_seq}, got {page_size}")
        if n_pages < 2:
            raise ValueError(f"n_pages must be >= 2 (page 0 is the reserved "
                             f"garbage page), got {n_pages}")
        h = self.kv_heads if n_heads is None else n_heads
        pools = self._kv_leaves((n_pages, h, page_size,
                                 cfg.head_dim), kv_dtype,
                                ("pages_key", "pages_value"))
        out = {f"block_{i}": {"attn": dict(pools)}
               for i in range(cfg.n_layers)}
        out["index"] = ((n_slots,), torch.int32)
        return out

    def init_paged_cache(self, n_slots: int, n_pages: int, page_size: int,
                         kv_dtype=None) -> dict:
        """A zeroed paged arena on the model's device."""
        return _alloc(self.paged_cache_shapes(n_slots, n_pages, page_size,
                                              kv_dtype), self.device)


def _lora_rows(lora, i: int) -> dict:
    """Block ``i``'s adapter rows of ``lora = (bank, aids)``: each leaf of
    the bank gathered at the batch rows' adapter ids, ``{leaf: [B, ...]}``
    (the JAX package's ``jnp.take`` along the adapter axis)."""
    bank, aids = lora
    return {name: leaf.index_select(0, aids)
            for name, leaf in bank[f"block_{i}"]["attn"].items()}


def _alloc(node, device):
    """Zeroed tensors on ``device`` for a nested dict of (shape, dtype)."""
    if isinstance(node, dict):
        return {k: _alloc(v, device) for k, v in node.items()}
    shape, dtype = node
    return torch.zeros(shape, dtype=dtype, device=device)


@torch.no_grad()
def generate(model: TransformerLM, prompt, max_new_tokens: int,
             temperature: float = 0.0, generator=None, strategy=None):
    """Autoregressive generation over the dense decode cache, the port of
    ``dtdl_tpu.models.transformer.generate``.

    ``prompt`` int [B, S0] (numpy or a tensor; S0 + ``max_new_tokens``
    must fit ``max_seq``).  One prefill writes the whole prompt into a
    fresh cache (:meth:`TransformerLM.init_cache`) and samples from the
    last position's logits; then ``max_new_tokens - 1`` single-token
    steps.  ``temperature`` 0 is the greedy argmax, otherwise draws from
    softmax(logits / temperature) with ``generator`` (a
    ``torch.Generator`` on the model's device).  Everything runs on the
    model's device.  Returns int32 [B, S0 + max_new_tokens] there.

    ``strategy`` (a :class:`~dtdl_tpu_torch.parallel.DataParallel`)
    decodes data-parallel, as the JAX ``generate`` does: every process
    passes the same full ``prompt``, decodes its stripe of the rows
    (B must divide by the replicas) with its own cache, and each step's
    logits are gathered to the full batch before the pick, so greedy and
    sampled tokens are those of ``strategy=None`` (the same draws from
    the same ``generator`` on every process).  Every process returns the
    full batch."""
    from dtdl_tpu_torch.parallel.strategy import check_strategy
    strategy = check_strategy(strategy)
    dev = model.device
    if isinstance(prompt, torch.Tensor):
        prompt = prompt.to(dev, torch.int64)
    else:
        prompt = upload(np.asarray(prompt, np.int64), dev)
    b, s0 = prompt.shape
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got "
                         f"{max_new_tokens}")
    if s0 + max_new_tokens > model.cfg.max_seq:
        raise ValueError(
            f"prompt ({s0}) + max_new_tokens ({max_new_tokens}) exceeds "
            f"max_seq ({model.cfg.max_seq})")
    if temperature > 0.0 and generator is None:
        raise ValueError("temperature sampling needs a torch.Generator")

    n = strategy.num_replicas
    if b % n:
        raise ValueError(f"{b} prompt rows do not divide over {n} replicas")
    if n > 1:
        from dtdl_tpu_torch.parallel import collectives
        lo = collectives.axis_index(strategy.mesh) * (b // n)
        rows = slice(lo, lo + b // n)
        gather = lambda x: collectives.all_gather_batch(x, strategy.mesh)  # noqa: E731
    else:
        rows, gather = slice(0, b), (lambda x: x)

    def pick(logits):
        logits = gather(logits)          # [B, vocab] on every replica
        if temperature == 0.0:
            return torch.argmax(logits, dim=-1)
        return torch.multinomial(torch.softmax(logits / temperature, -1), 1,
                                 generator=generator)[:, 0]

    cache = model.init_cache(b // n)
    # only the last position's logits are sampled: the [B, S0, vocab]
    # logits of the prompt never materialize
    hidden = model(prompt[rows], cache=cache, return_hidden=True)
    tok = pick(model.head(hidden[:, -1]))
    out = [prompt, tok[:, None]]
    for _ in range(max_new_tokens - 1):
        tok = pick(model(tok[rows, None], cache=cache)[:, -1])
        out.append(tok[:, None])
    return torch.cat(out, dim=1).to(torch.int32)


_PRESETS = {
    "tiny": dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                 d_ff=128, max_seq=128),
    "small": dict(vocab_size=8192, d_model=256, n_layers=4, n_heads=2,
                  d_ff=704, max_seq=1024),
    "base": dict(vocab_size=32000, d_model=512, n_layers=8, n_heads=4,
                 d_ff=1408, max_seq=2048),
    "large": dict(vocab_size=32000, d_model=1024, n_layers=16, n_heads=8,
                  d_ff=2816, max_seq=2048, remat=True),
}
_PRESETS["base-moe8"] = dict(_PRESETS["base"], n_experts=8, moe_every=2,
                             moe_dispatch="routed")
_PRESETS["small-hd128"] = _PRESETS["small"]
_PRESETS["base-hd128"] = _PRESETS["base"]
_FIELDS = {f.name for f in fields(LMConfig)}


def transformer_lm(size: str = "tiny", *, device=None, seed: int | None = 0,
                   **overrides) -> TransformerLM:
    """The JAX package's named configs, built on ``device`` (the card
    unless ``device="cpu"``) with random weights from ``seed`` (``None``
    leaves them uninitialized, for a bridge load).  ``overrides`` set
    :class:`LMConfig` fields (``attn_impl``, ``remat``, ``dtype``,
    ``quantize`` (True/'int8' or 'w8f'), ``n_experts``, ``moe_dispatch``,
    ...); an unknown one raises a TypeError naming it."""
    if size not in _PRESETS:
        raise ValueError(f"unknown size {size!r}; one of {sorted(_PRESETS)}")
    unknown = set(overrides) - _FIELDS
    if unknown:
        raise TypeError(f"transformer_lm got unknown options "
                        f"{sorted(unknown)}")
    if "quantize" in overrides:
        overrides["quantize"] = canon_weight_quant(overrides["quantize"])
    model = TransformerLM(LMConfig(**{**_PRESETS[size], **overrides}),
                          device=device)
    if seed is not None:
        model.init_weights(seed)
    return model
