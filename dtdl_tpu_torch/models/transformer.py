"""Decoder-only Transformer LM, the port of dtdl_tpu/models/transformer.py
(dense part).

Pre-norm blocks, RMSNorm, rotary embeddings, SwiGLU MLP, tied head.  The
parameters keep the flax layouts and names, so ``state_dict`` keys are the
flax param paths with ``.`` for ``/`` (``block_0.attn.q.kernel``,
``embed``, ``ln_f.scale``) and :mod:`dtdl_tpu_torch.bridge` maps a flax
tree straight across:

* ``attn.{q,k,v}.kernel`` [d_model, H, D] and ``attn.out.kernel``
  [H, D, d_model] (flax DenseGeneral);
* ``mlp.{wi,wg}.kernel`` [d_model, d_ff] and ``mlp.wo.kernel``
  [d_ff, d_model] (flax Dense);
* ``embed`` [vocab, d_model]; ``ln_attn``/``ln_mlp``/``ln_f`` ``scale``.

Parameters are held in f32, as flax holds them (``param_dtype`` f32), and
every use casts to the compute dtype ``cfg.dtype`` where flax's ``dtype=``
casts: the matmul kernels at each product, the embedding after the row
gather and in the tied head.  Training therefore updates f32 master
weights with f32 optimizer state.  Norm scales stay f32, as flax
multiplies them in f32.  A server takes :meth:`TransformerLM.compute_copy`
once, a frozen copy whose weights are already in the compute dtype, so a
decode step pays no per-step cast of every weight.

Three forwards:

* the cacheless forward (``pos=None``, the training and scoring path):
  full causal attention, ``attn_impl='flash'`` through
  :func:`~dtdl_tpu_torch.ops.attention.flash_attention` with fused rope
  (kernel K1 forward, K2 and K3 backward on the card) or ``'dense'``
  (``apply_rope`` then :func:`mha_reference`, plain autograd); with
  ``remat`` each block is checkpointed (recomputed in the backward);
* the paged decode forward (``pos`` given): the engine's paged arena,
  :meth:`Attention.paged_attend` (the port of ``_paged_attend_slots``),
  which ends in :func:`~dtdl_tpu_torch.ops.paged_attention.paged_attention`
  (kernel K4 on the card) or, for ``paged_kernel=False``, its plain version;
* the dense decode forward (``cache`` from :meth:`TransformerLM.init_cache`,
  no ``pos``): every row at the cache's one host-side index, the port of
  ``_decode_attend``'s scalar-index path (plain torch, as the JAX one is
  plain jnp), which :func:`generate` and the model draft run on.

Not ported yet (they raise ``NotImplementedError`` naming their ROADMAP
item): mixture-of-experts blocks, quantized layers and KV pools, LoRA, and
the per-slot dense serving arena (a [B] index on the dense cache).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields

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


class CacheOverflowError(ValueError):
    """A dense decode step would write past the KV cache (``max_seq``)."""


class _Kernel(nn.Module):
    """One weight tensor under the flax param name ``kernel``."""

    def __init__(self, *shape, dtype, device):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(*shape, dtype=dtype,
                                               device=device))


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(dim, dtype=torch.float32,
                                             device=device))

    def forward(self, x):
        # x·rsqrt(mean(x²) + eps)·scale in f32, one fused op
        return F.rms_norm(x.float(), self.scale.shape, self.scale,
                          self.eps).to(self.dtype)


class Attention(nn.Module):
    """q/k/v/out projections around the cacheless attention (flash or
    dense) or the paged decode attend."""

    def __init__(self, d_model: int, n_heads: int, head_dim: int, *, dtype,
                 param_dtype, attn_impl: str, device):
        super().__init__()
        if attn_impl not in ("flash", "dense"):
            raise ValueError(f"attn_impl must be 'flash' or 'dense', got "
                             f"{attn_impl!r}")
        self.n_heads, self.head_dim = n_heads, head_dim
        self.dtype, self.attn_impl = dtype, attn_impl
        for name in ("q", "k", "v"):
            setattr(self, name, _Kernel(d_model, n_heads, head_dim,
                                        dtype=param_dtype, device=device))
        self.out = _Kernel(n_heads, head_dim, d_model, dtype=param_dtype,
                           device=device)

    def _proj(self, x, w):
        b, s, _ = x.shape
        kernel = w.kernel.reshape(w.kernel.shape[0], -1).to(self.dtype)
        y = torch.matmul(x, kernel)
        return y.reshape(b, s, self.n_heads, self.head_dim).transpose(1, 2)

    def forward(self, x, cos, sin, pools=None, step=None):
        q, k, v = (self._proj(x, w) for w in (self.q, self.k, self.v))
        if isinstance(step, PagedStep):
            o = self.paged_attend(q, k, v, pools, step)
        elif step is not None:
            o = self.dense_attend(q, k, v, pools, step, cos, sin)
        elif self.attn_impl == "flash":
            o = flash_attention(q, k, v, causal=True, rope=(cos, sin))
        else:
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
            o = mha_reference(q, k, v, causal=True).to(self.dtype)
        b, _, s, _ = o.shape
        o = o.transpose(1, 2).reshape(b, s, -1)
        out = self.out.kernel.reshape(-1, self.out.kernel.shape[-1])
        return torch.matmul(o, out.to(self.dtype))

    def paged_attend(self, q, k, v, pools, step: "PagedStep"):
        """Attend ``s_new`` new rows per slot against the block-paged
        arena (the port of ``_paged_attend_slots``): ``pools`` is this
        layer's (pages_key, pages_value), ``step`` the call's
        :class:`PagedStep`.  The new rows are roped at their positions,
        scattered into the pools through each row's page table (inactive
        rows to the garbage page 0), and every query row attends its
        row's columns up to its own position."""
        b, h, s_new, d = q.shape
        pk, pv = pools
        q = rotate(q, step.cos, step.sin)
        k = rotate(k, step.cos, step.sin)
        # The pools are updated in place (index_put_) where the JAX program
        # returned a new donated arena: token t of row b lands at offset
        # g % page of physical page table[b, g // page].
        for pool, new in ((pk, k), (pv, v)):
            upd = new.transpose(1, 2).reshape(b * s_new, h, d)
            pool.index_put_((step.page_idx, step.heads, step.off_idx),
                            upd.to(pool.dtype))
        attend = paged_attention if step.kernel \
            else paged_attention_reference
        return attend(q, pk, pv, step.page_table, step.pos,
                      step.active_i32, scale=1.0 / math.sqrt(d))


    # query rows attend in blocks of this many, so a long prefill holds
    # [B, H, PREFILL_CHUNK, max_seq] f32 logits at a time, not the prompt's
    PREFILL_CHUNK = 256

    def dense_attend(self, q, k, v, pools, pos: int, cos, sin):
        """Attend ``s_new`` new rows per batch row at the one position
        ``pos`` against the dense cache (the port of ``_decode_attend``'s
        scalar-index path): the new rows are roped at pos.., their K/V
        written at [pos, pos + s_new) of this layer's (key, value)
        [B, H, max_seq, D] buffers, and each query row attends every
        cached column up to its own position, in f32 logits with the
        weights cast to the compute dtype before P·V."""
        s_new, d = q.shape[2], q.shape[3]
        ck, cv = pools
        q = apply_rope(q, cos, sin, offset=pos)
        k = apply_rope(k, cos, sin, offset=pos)
        ck[:, :, pos:pos + s_new] = k.to(ck.dtype)
        cv[:, :, pos:pos + s_new] = v.to(cv.dtype)
        keys_t = ck.float().transpose(-1, -2)
        scale = 1.0 / math.sqrt(d)
        cols = torch.arange(ck.shape[2], device=q.device)
        out = []
        for c0 in range(0, s_new, self.PREFILL_CHUNK):
            rows = q[:, :, c0:c0 + self.PREFILL_CHUNK]
            qpos = pos + c0 + torch.arange(rows.shape[2], device=q.device)
            mask = cols[None, :] <= qpos[:, None]
            logits = torch.matmul(rows.float(), keys_t) * scale
            logits = torch.where(mask, logits,
                                 torch.full_like(logits, NEG_INF))
            probs = torch.softmax(logits, dim=-1)
            out.append(torch.matmul(probs.to(self.dtype), cv))
        return torch.cat(out, dim=2)


class SwiGLU(nn.Module):
    def __init__(self, d_model: int, d_ff: int, *, dtype, param_dtype,
                 device):
        super().__init__()
        self.dtype = dtype
        self.wi = _Kernel(d_model, d_ff, dtype=param_dtype, device=device)
        self.wg = _Kernel(d_model, d_ff, dtype=param_dtype, device=device)
        self.wo = _Kernel(d_ff, d_model, dtype=param_dtype, device=device)

    def forward(self, x):
        dt = self.dtype
        h = F.silu(torch.matmul(x, self.wg.kernel.to(dt))) \
            * torch.matmul(x, self.wi.kernel.to(dt))
        return torch.matmul(h, self.wo.kernel.to(dt))


class Block(nn.Module):
    def __init__(self, cfg: "LMConfig", *, param_dtype, device):
        super().__init__()
        dt = cfg.dtype
        self.ln_attn = RMSNorm(cfg.d_model, dtype=dt, device=device)
        self.attn = Attention(cfg.d_model, cfg.n_heads, cfg.head_dim,
                              dtype=dt, param_dtype=param_dtype,
                              attn_impl=cfg.attn_impl, device=device)
        self.ln_mlp = RMSNorm(cfg.d_model, dtype=dt, device=device)
        self.mlp = SwiGLU(cfg.d_model, cfg.d_ff, dtype=dt,
                          param_dtype=param_dtype, device=device)

    def forward(self, x, cos, sin, pools=None, step=None):
        x = x + self.attn(self.ln_attn(x), cos, sin, pools, step)
        return x + self.mlp(self.ln_mlp(x))


@dataclass(frozen=True)
class LMConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 8
    n_heads: int = 8
    d_ff: int = 1408
    max_seq: int = 2048
    n_experts: int = 0
    attn_impl: str = "flash"      # 'flash' | 'dense'
    remat: bool = False           # checkpoint every block when training
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


@dataclass
class PagedStep:
    """What every layer of one paged forward shares, computed once per
    call: the page tables, the active mask (int32 for the kernel), the
    rows' clamped positions, the (page, offset) scatter coordinates of the
    new tokens and their rope rows, and whether to attend through the
    kernel wrapper (:func:`paged_attention`) or its plain version."""
    page_table: torch.Tensor   # [B, n_ptab] int32
    active_i32: torch.Tensor   # [B]
    pos: torch.Tensor          # [B] clamped positions
    page_idx: torch.Tensor     # [B*S, 1] physical page of each new token
    off_idx: torch.Tensor      # [B*S, 1] offset in that page
    heads: torch.Tensor        # [1, H]
    cos: torch.Tensor          # [B, 1, S, D/2] f32 rope rows
    sin: torch.Tensor
    kernel: bool = True

    @classmethod
    def build(cls, page_table, active, pos, *, s_new, page, n_heads,
              rope_cos, rope_sin, kernel):
        max_len = rope_cos.shape[0]
        # identity for active rows (caller contract); keeps stale inactive
        # rows inside every table
        pos_safe = pos.clamp(0, max_len - s_new)
        g = pos_safe[:, None] + torch.arange(s_new, device=pos.device)
        phys = torch.gather(page_table, 1,
                            (g // page).clamp(0, page_table.shape[1] - 1))
        page_idx = torch.where(active[:, None], phys, torch.zeros_like(phys))
        return cls(page_table=page_table.to(torch.int32),
                   active_i32=active.to(torch.int32), pos=pos_safe,
                   page_idx=page_idx.reshape(-1, 1).long(),
                   off_idx=(g % page).reshape(-1, 1).long(),
                   heads=torch.arange(n_heads, device=pos.device)[None, :],
                   cos=rope_cos[g].float()[:, None],
                   sin=rope_sin[g].float()[:, None], kernel=kernel)


class TransformerLM(nn.Module):
    """Decoder-only LM: int tokens [batch, seq] -> f32 logits.  Matmul
    weights and the embedding are held in ``param_dtype`` (f32, as flax
    holds them; :meth:`compute_copy` builds the serving twin)."""

    def __init__(self, cfg: LMConfig, device=None,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.n_experts > 0:
            raise NotImplementedError(
                "mixture-of-experts blocks are ROADMAP queue A3 (MoE "
                "sub-step), not ported yet")
        self.cfg = cfg
        self.param_dtype = param_dtype
        dev = resolve_device(device)
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model,
                                              dtype=param_dtype, device=dev))
        for i in range(cfg.n_layers):
            self.add_module(f"block_{i}", Block(cfg, param_dtype=param_dtype,
                                                device=dev))
        self.ln_f = RMSNorm(cfg.d_model, dtype=cfg.dtype, device=dev)
        cos, sin = rope_frequencies(cfg.head_dim, cfg.max_seq, device=dev)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def blocks(self):
        return [getattr(self, f"block_{i}") for i in range(self.cfg.n_layers)]

    def compute_copy(self) -> "TransformerLM":
        """A frozen twin for serving whose matmul weights and embedding
        are held in the compute dtype (norm scales stay f32), copied once
        so that the eager decode step does not cast every weight per call.
        The model itself when its weights are in the compute dtype
        already (an f32 model)."""
        if self.param_dtype == self.cfg.dtype:
            return self
        twin = TransformerLM(self.cfg, device=self.device,
                             param_dtype=self.cfg.dtype)
        twin.load_state_dict(self.state_dict())
        return twin.requires_grad_(False)

    def init_weights(self, seed: int = 0) -> "TransformerLM":
        """Random weights from ``seed`` (torch.Generator on the CPU, so
        the same seed gives the same weights on every device): normal
        embedding (std 0.02), fan-in scaled normal matmul kernels, unit
        norm scales."""
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
                else:
                    std = 1.0 / math.sqrt(p.shape[0])
                p.copy_(torch.randn(p.shape, generator=gen) * std)
        return self

    def forward(self, tokens, *, return_hidden: bool = False, pos=None,
                cache=None, page_table=None, active=None,
                paged_kernel: bool = True):
        """Cacheless forward (no ``cache``); a paged decode forward
        (``pos`` given): ``cache`` the engine's arena
        (:meth:`init_paged_cache`), ``page_table`` [B, n_ptab], ``active``
        [B] bool and ``pos`` [B] the rows' write positions,
        ``paged_kernel=False`` attending through the plain version instead
        of the kernel wrapper, the pools updated in place and the arena's
        ``index`` the engine's to advance; or a dense decode forward
        (``cache`` from :meth:`init_cache`, no ``pos``): the tokens are
        written at the cache's index, which advances by their count."""
        if pos is not None and (cache is None or
                                "pages_key" not in cache["block_0"]["attn"]):
            raise NotImplementedError(
                "per-slot positions on the dense [B, max_seq] cache (the "
                "engine's dense arena) are ROADMAP queue A5 (dense arena), "
                "not in this slice")
        x = self.embed[tokens].to(self.cfg.dtype)
        step = None
        if cache is not None and pos is None:
            step = int(cache["index"])
            if step + tokens.shape[1] > self.cfg.max_seq:
                raise CacheOverflowError(
                    f"decode at position {step} with {tokens.shape[1]} new "
                    f"token(s) exceeds max_seq={self.cfg.max_seq}")
        elif pos is not None:
            pool = cache["block_0"]["attn"]["pages_key"]
            if pool.dtype not in (torch.float32, torch.bfloat16):
                raise NotImplementedError(
                    "int8/fp8 KV pools are ROADMAP queue A7 (quantized "
                    "serving)")
            step = PagedStep.build(
                page_table, active, pos, s_new=tokens.shape[1],
                page=pool.shape[2], n_heads=self.cfg.n_heads,
                rope_cos=self.rope_cos, rope_sin=self.rope_sin,
                kernel=paged_kernel)
        # remat is a training-time memory/FLOPs trade: never under decode
        remat = self.cfg.remat and step is None and torch.is_grad_enabled()
        for i, block in enumerate(self.blocks):
            if remat:
                x = checkpoint(block, x, self.rope_cos, self.rope_sin,
                               use_reentrant=False)
                continue
            pools = None
            if isinstance(step, PagedStep):
                layer = cache[f"block_{i}"]["attn"]
                pools = (layer["pages_key"], layer["pages_value"])
            elif step is not None:
                layer = cache[f"block_{i}"]["attn"]
                pools = (layer["key"], layer["value"])
            x = block(x, self.rope_cos, self.rope_sin, pools, step)
        if cache is not None and pos is None:
            cache["index"].fill_(step + tokens.shape[1])
        x = self.ln_f(x)
        if return_hidden:
            return x
        return self.head(x)

    def head(self, x):
        """Tied output head ``x @ embed.T`` in the compute dtype, as f32."""
        return torch.matmul(x, self.embed.to(self.cfg.dtype).t()).float()

    def cache_shapes(self, batch_size: int) -> dict:
        """Shapes and dtypes of the dense decode cache for ``batch_size``
        rows: per block a ``key``/``value`` buffer [B, H, max_seq,
        head_dim] in the compute dtype, plus one scalar int32 ``index``
        for all blocks (the JAX tree keeps an identical copy per block).
        The per-slot [B] index of the engine's dense arena is ROADMAP
        queue A5, int8/fp8 caches A7."""
        cfg = self.cfg
        kv = ((batch_size, cfg.n_heads, cfg.max_seq, cfg.head_dim), cfg.dtype)
        out = {f"block_{i}": {"attn": {"key": kv, "value": kv}}
               for i in range(cfg.n_layers)}
        out["index"] = ((), torch.int32)
        return out

    def init_cache(self, batch_size: int) -> dict:
        """A zeroed dense decode cache: the K/V buffers on the model's
        device, the ``index`` on the host (a CPU scalar tensor), so a
        step's position is known without reading the card."""
        shapes = self.cache_shapes(batch_size)
        out = {name: {"attn": {k: torch.zeros(shape, dtype=dtype,
                                              device=self.device)
                               for k, (shape, dtype) in node["attn"].items()}}
               for name, node in shapes.items() if name != "index"}
        out["index"] = torch.zeros((), dtype=torch.int32)
        return out

    def paged_cache_shapes(self, n_slots: int, n_pages: int, page_size: int,
                           kv_dtype=None) -> dict:
        """Shapes and dtypes of the block-paged serving arena: per block a
        ``pages_key``/``pages_value`` pool [n_pages, H, page_size,
        head_dim] (page 0 is the reserved garbage page), plus one
        ``index`` [n_slots] int32 for all blocks (the JAX tree keeps an
        identical copy per block)."""
        if kv_dtype is not None:
            raise NotImplementedError(
                "int8/fp8 KV pools are ROADMAP queue A7 (quantized serving)")
        cfg = self.cfg
        if page_size < 1 or cfg.max_seq % page_size:
            raise ValueError(f"page_size must be >= 1 and divide max_seq="
                             f"{cfg.max_seq}, got {page_size}")
        if n_pages < 2:
            raise ValueError(f"n_pages must be >= 2 (page 0 is the reserved "
                             f"garbage page), got {n_pages}")
        pool = ((n_pages, cfg.n_heads, page_size, cfg.head_dim), cfg.dtype)
        out = {f"block_{i}": {"attn": {"pages_key": pool,
                                       "pages_value": pool}}
               for i in range(cfg.n_layers)}
        out["index"] = ((n_slots,), torch.int32)
        return out

    def init_paged_cache(self, n_slots: int, n_pages: int, page_size: int,
                         kv_dtype=None) -> dict:
        """A zeroed paged arena on the model's device."""
        def alloc(node):
            if isinstance(node, dict):
                return {k: alloc(v) for k, v in node.items()}
            shape, dtype = node
            return torch.zeros(shape, dtype=dtype, device=self.device)
        return alloc(self.paged_cache_shapes(n_slots, n_pages, page_size,
                                             kv_dtype))


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
    ``strategy`` (data-parallel decoding) is ROADMAP queue A9."""
    if strategy is not None:
        raise NotImplementedError(
            "generate(strategy=...) (data-parallel decoding) is ROADMAP "
            "queue A9 (distributed)")
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

    def pick(logits):
        if temperature == 0.0:
            return torch.argmax(logits, dim=-1)
        return torch.multinomial(torch.softmax(logits / temperature, -1), 1,
                                 generator=generator)[:, 0]

    cache = model.init_cache(b)
    # only the last position's logits are sampled: the [B, S0, vocab]
    # logits of the prompt never materialize
    hidden = model(prompt, cache=cache, return_hidden=True)
    tok = pick(model.head(hidden[:, -1]))
    out = [prompt, tok[:, None]]
    for _ in range(max_new_tokens - 1):
        tok = pick(model(tok[:, None], cache=cache)[:, -1])
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
_PRESETS["base-moe8"] = dict(_PRESETS["base"], n_experts=8)
_PRESETS["small-hd128"] = _PRESETS["small"]
_PRESETS["base-hd128"] = _PRESETS["base"]
_FIELDS = {f.name for f in fields(LMConfig)}


def transformer_lm(size: str = "tiny", *, device=None, seed: int | None = 0,
                   **overrides) -> TransformerLM:
    """The JAX package's named configs, built on ``device`` (the card
    unless ``device="cpu"``) with random weights from ``seed`` (``None``
    leaves them uninitialized, for a bridge load).  ``overrides`` set
    :class:`LMConfig` fields (``attn_impl``, ``remat``, ``dtype``, ...);
    the JAX fields of layers not ported yet, ``moe_every``,
    ``moe_dispatch``, ``capacity_factor``, ``moe_top_k``,
    ``moe_group_size`` and ``quantize``, are refused by name."""
    if size not in _PRESETS:
        raise ValueError(f"unknown size {size!r}; one of {sorted(_PRESETS)}")
    unknown = set(overrides) - _FIELDS
    if unknown:
        raise NotImplementedError(
            f"{sorted(unknown)} are not ported yet (MoE and quantized layers "
            f"are ROADMAP queue A3/A7)")
    model = TransformerLM(LMConfig(**{**_PRESETS[size], **overrides}),
                          device=device)
    if seed is not None:
        model.init_weights(seed)
    return model
