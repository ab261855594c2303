"""Batched LM inference engine over a paged or dense KV arena, the port of
dtdl_tpu/serve/engine.py.

The engine owns the model and threads ``(arena, last_tokens)`` state that
the caller (:class:`~dtdl_tpu_torch.serve.scheduler.Scheduler`) keeps:

* :meth:`InferenceEngine.prefill` admits one prompt into a slot: the
  uncached suffix, right-padded to its power-of-two bucket, runs one
  forward (paged: at ``start``, the number of prefix-cached tokens already
  in shared pages, through the slot's page-table row; dense: at 0 into the
  slot's own row), and the first token is sampled from the last real
  position's logits;
* :meth:`InferenceEngine.decode` steps every slot one token at its own
  position; only active slots advance;
* :meth:`InferenceEngine.verify` scores each slot's draft tokens in one
  forward of width k+1 and commits an accepted prefix plus one token per
  slot (speculative decoding; a ``forced`` row is a prompt chunk riding
  the same pass: chunked prefill).

The arena comes in two layouts.  Paged (``page_size > 0``): a pool of
``n_pages`` pages of ``page_size`` tokens per block (page 0 the garbage
page), sized by ``n_pages`` or by a byte budget ``kv_pool_bytes``.  Dense
(``page_size=0``): one [n_slots, H, max_seq, D] K/V pair per block, each
slot charged max_seq positions.  Either has one per-slot ``index``
[n_slots] int32, updated in place.  ``last_tokens`` is replaced, never
written in place, because the scheduler's lag harvest still holds the
vectors of earlier steps.  Host-side per-call inputs (tokens, page tables,
masks) go up through pinned buffers with non-blocking copies, so a step
never waits for the card.

The engine serves :meth:`TransformerLM.compute_copy` of the model given
to it: the weights in the compute dtype, taken once at construction.
``quantize_weights`` (True int8, 'w8f' fp8) serves the model's weights
quantized (:mod:`dtdl_tpu_torch.quant`), taken from the float weights it
was given; ``kv_dtype`` ('int8', 'fp8') stores the arena's K/V quantized
with a scale per position.

Every paged attend ends in kernel K4 on the card (``paged_kernel='auto'``
resolves to the kernel on CUDA and to the plain version on the CPU;
``False`` asks for the plain version on any device).  The dense arena
attends in plain torch, as the JAX one in plain jnp.  A device mesh,
LoRA and grammar masks are later slices and raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import numpy as np
import torch

from dtdl_tpu_torch.device import resolve_device, upload
from dtdl_tpu_torch.quant.core import (canon_kv_dtype, canon_weight_quant,
                                       quantize_params, tree_bytes)
from dtdl_tpu_torch.serve.sampling import (SampleParams, accept_resample,
                                           sample)


class PromptTooLongError(ValueError):
    """A prompt exceeds the largest configured prefill bucket."""


def default_buckets(max_seq: int, start: int = 16) -> tuple[int, ...]:
    """Power-of-two prompt buckets up to ``max_seq`` (always included)."""
    out, b = [], start
    while b < max_seq:
        out.append(b)
        b *= 2
    out.append(max_seq)
    return tuple(out)


def _resolve_paged_kernel(flag, device) -> bool:
    if isinstance(flag, bool):
        return flag
    if flag == "auto":
        return device.type == "cuda"
    raise ValueError(f"paged_kernel must be True, False or 'auto', "
                     f"got {flag!r}")


class InferenceEngine:
    """Prefill/decode over a paged or dense KV arena (see module
    docstring).  ``n_pages`` defaults to dense-equivalent capacity,
    ``n_slots * max_seq / page_size + 1``; ``kv_pool_bytes`` sizes it
    from a byte budget instead, ``kv_pool_bytes // page_bytes`` pages
    (``page_bytes``: one page of K and V across all blocks, scales
    included)."""

    def __init__(self, model, n_slots: int = 8, buckets=None,
                 page_size: int = 16, n_pages: int | None = None,
                 paged_kernel="auto", device=None, quantize_weights=False,
                 kv_dtype=None, kv_pool_bytes: int | None = None, mesh=None,
                 lora_rank: int = 0, lora_adapters: int = 0, observer=None):
        self.device = resolve_device(device)
        if self.device != model.device:
            raise ValueError(f"the model lives on {model.device}, the engine "
                             f"was asked for {self.device}")
        self.weight_mode = canon_weight_quant(quantize_weights)
        self.kv_dtype = canon_kv_dtype(kv_dtype)
        if mesh is not None:
            raise NotImplementedError(
                "tensor-parallel serving (mesh) is ROADMAP queue A11")
        if lora_rank or lora_adapters:
            raise NotImplementedError(
                "LoRA adapter banks are ROADMAP queue A12 (tenancy)")
        if observer is not None:
            raise NotImplementedError(
                "the observer facade is ROADMAP queue A13 (operations)")
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        if page_size < 0 or (page_size and model.cfg.max_seq % page_size):
            raise ValueError(f"page_size={page_size} must divide "
                             f"max_seq={model.cfg.max_seq}")
        if self.weight_mode:
            # the float weights given are quantized once, as the JAX
            # engine quantizes the params it is given
            qmodel = model.clone(quantize=self.weight_mode)
            qmodel.load_state_dict(quantize_params(
                model, model.state_dict(), self.weight_mode))
            model = qmodel
        self.quantized_weights = model.cfg.quantize
        # the compute-dtype twin, taken once: the eager decode step must not
        # cast every f32 weight per call (the engine serves a snapshot, as
        # the JAX engine serves the params it was given)
        self.model = model.compute_copy()
        self.n_slots = n_slots
        self.max_seq = model.cfg.max_seq
        self.buckets = (tuple(sorted(set(buckets))) if buckets
                        else default_buckets(self.max_seq))
        if self.buckets[-1] > self.max_seq:
            raise ValueError(f"bucket {self.buckets[-1]} exceeds "
                             f"max_seq={self.max_seq}")
        self.paged = page_size > 0
        self.page_size = page_size
        self.n_ptab = self.n_pages = self.page_bytes = 0
        if self.paged:
            self.n_ptab = self.max_seq // page_size
            # one page of K and V (scales included) across all blocks: the
            # 3-page arena minus the 2-page one, as the JAX engine counts
            self.page_bytes = (
                tree_bytes(self.model.paged_cache_shapes(
                    1, 3, page_size, self.kv_dtype))
                - tree_bytes(self.model.paged_cache_shapes(
                    1, 2, page_size, self.kv_dtype)))
            if kv_pool_bytes is not None:
                if n_pages is not None:
                    raise ValueError("pass n_pages or kv_pool_bytes, not "
                                     "both")
                n_pages = kv_pool_bytes // self.page_bytes
                if n_pages < 2:
                    raise ValueError(
                        f"kv_pool_bytes={kv_pool_bytes} holds {n_pages} "
                        f"pages of {self.page_bytes} bytes; the pool needs "
                        f">= 2 (garbage page + one live page)")
            self.n_pages = (n_pages if n_pages is not None
                            else n_slots * self.n_ptab + 1)
            if self.n_pages < 2:
                raise ValueError(f"n_pages must be >= 2, got {self.n_pages}")
        elif n_pages is not None:
            raise ValueError("n_pages requires page_size > 0")
        elif kv_pool_bytes is not None:
            raise ValueError("kv_pool_bytes requires page_size > 0")
        self.paged_kernel = (_resolve_paged_kernel(paged_kernel, self.device)
                             and self.paged)

    # ---- state the caller threads ------------------------------------

    def arena_shapes(self) -> dict:
        """Shapes and dtypes of the engine's arena (nothing allocated)."""
        if self.paged:
            return self.model.paged_cache_shapes(
                self.n_slots, self.n_pages, self.page_size, self.kv_dtype)
        return self.model.cache_shapes(self.n_slots, per_slot_index=True,
                                       kv_dtype=self.kv_dtype)

    def init_arena(self) -> dict:
        """Fresh zeroed arena: the paged pools, or the dense
        [n_slots, H, max_seq, D] rows, per block, plus the slot index."""
        if self.paged:
            return self.model.init_paged_cache(
                self.n_slots, self.n_pages, self.page_size, self.kv_dtype)
        return self.model.init_cache(self.n_slots, per_slot_index=True,
                                     kv_dtype=self.kv_dtype)

    def init_last_tokens(self) -> torch.Tensor:
        return torch.zeros(self.n_slots, dtype=torch.int32,
                           device=self.device)

    def compile_stats(self) -> dict:
        """The geometry and byte receipts of the JAX engine's
        ``compile_stats()`` (its compiled-program counts have no
        counterpart in the eager port): ``paged`` the page geometry (None
        for the dense arena) and ``quant`` the bytes: ``param_bytes`` (the served
        weights, what every decode step reads), the arena split into K/V
        payload and scale sidecars, and ``decode_hbm_bytes_per_token``,
        ``(param_bytes + kv_arena_bytes) / n_slots``."""
        payload = scales = 0

        def walk(node):
            nonlocal payload, scales
            for name, leaf in node.items():
                if isinstance(leaf, dict):
                    walk(leaf)
                elif name.endswith("_scale"):
                    scales += tree_bytes(leaf)
                elif name != "index":
                    payload += tree_bytes(leaf)
        walk(self.arena_shapes())
        param_bytes = tree_bytes(self.model.state_dict())
        return {
            "paged": ({"page_size": self.page_size, "n_pages": self.n_pages,
                       "pages_per_slot": self.n_ptab,
                       "page_bytes": self.page_bytes}
                      if self.paged else None),
            "quant": {
                "weights": self.quantized_weights,
                "kv_dtype": (None if self.kv_dtype is None
                             else "int8" if self.kv_dtype == torch.int8
                             else "fp8"),
                "param_bytes": param_bytes,
                "kv_payload_bytes": payload,
                "kv_scale_bytes": scales,
                "kv_arena_bytes": payload + scales,
                "decode_hbm_bytes_per_token": round(
                    (param_bytes + payload + scales) / self.n_slots),
            }}

    def bucket_for(self, length: int) -> int:
        for b in self.buckets:
            if length <= b:
                return b
        raise PromptTooLongError(
            f"prompt length {length} exceeds the largest prefill bucket "
            f"{self.buckets[-1]} (buckets={self.buckets}, "
            f"max_seq={self.max_seq})")

    def _sample(self, logits, generator, temp, top_k, top_p):
        """Greedy rows take the raw argmax; the filtered draw runs only
        when some row samples (decided from the host-side knobs)."""
        if np.all(np.asarray(temp) <= 0.0):
            return torch.argmax(logits, dim=-1).to(torch.int32)
        if generator is None:
            raise ValueError("sampled requests need a torch.Generator on "
                             f"{self.device}")
        return sample(logits, generator,
                      upload(np.asarray(temp, np.float32), self.device),
                      upload(np.asarray(top_k, np.int32), self.device),
                      upload(np.asarray(top_p, np.float32), self.device))

    # ---- the two entry points ----------------------------------------

    @torch.no_grad()
    def prefill(self, arena, last_tokens, slot: int, prompt,
                sampling: SampleParams = SampleParams(), generator=None,
                page_row=None, start: int = 0):
        """Admit ``prompt`` (the uncached suffix) into ``slot``; returns
        ``(arena, last_tokens, logits[V])`` with ``last_tokens[slot]`` the
        first sampled token.  Paged: ``page_row`` is the slot's [n_ptab]
        page table (prefix-hit pages first, fresh pages for the rest of
        the prompt, garbage page 0 beyond) and ``start`` the page-aligned
        number of prefix-cached tokens already resident.  Dense: the
        prompt runs at position 0 into the slot's row, which it
        overwrites whole (zeros past the bucket)."""
        prompt = np.asarray(prompt, np.int32).ravel()
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if not 0 <= slot < self.n_slots:
            raise ValueError(f"slot {slot} out of range [0, {self.n_slots})")
        if self.paged:
            if page_row is None:
                raise ValueError("paged engine prefill needs the slot's "
                                 "page_row (see Scheduler)")
            if start % self.page_size or start < 0:
                raise ValueError(f"start={start} must be a non-negative "
                                 f"multiple of page_size={self.page_size}")
            page_row = np.asarray(page_row, np.int32).ravel()
            if page_row.size != self.n_ptab:
                raise ValueError(f"page_row must have {self.n_ptab} "
                                 f"entries, got {page_row.size}")
        elif page_row is not None or start:
            raise ValueError("page_row/start require a paged engine "
                             "(page_size > 0)")
        if start + prompt.size > self.max_seq:
            raise ValueError(f"prompt length {start + prompt.size} exceeds "
                             f"max_seq={self.max_seq}")
        T = self.bucket_for(prompt.size)
        if start + T > self.max_seq:
            # the padded window must fit too: the attend clamps pos to
            # max_seq - T, which would shift the write window backward
            # over cached prefix pages
            raise ValueError(
                f"prefix start {start} + padded bucket {T} exceeds "
                f"max_seq={self.max_seq}; map fewer prefix pages so the "
                f"suffix bucket fits")
        padded = np.zeros((1, T), np.int32)
        padded[0, :prompt.size] = prompt
        dev = self.device
        tokens = upload(padded, dev, torch.int64)
        if self.paged:
            hidden = self.model(
                tokens, return_hidden=True,
                pos=upload(np.asarray([start], np.int32), dev),
                cache=arena, page_table=upload(page_row[None], dev),
                active=torch.ones(1, dtype=torch.bool, device=dev),
                paged_kernel=self.paged_kernel)
        else:
            # the slot's row as a one-row dense cache at index 0 (views
            # into the arena, so the forward writes the arena itself)
            row = {name: {"attn": {leaf: buf[slot:slot + 1].zero_()
                                   for leaf, buf in node["attn"].items()}}
                   for name, node in arena.items() if name != "index"}
            row["index"] = torch.zeros((), dtype=torch.int32)
            hidden = self.model(tokens, return_hidden=True, cache=row)
        # logits of the last real suffix position only
        logits = self.model.head(hidden[:, prompt.size - 1])      # [1, V]
        tok = self._sample(logits, generator, [sampling.temperature],
                           [sampling.top_k], [sampling.top_p])
        arena["index"][slot] = start + int(prompt.size)
        last = last_tokens.clone()
        last[slot] = tok[0]
        return arena, last, logits[0]

    def _tables_arg(self, page_tables):
        """The [n_slots, n_ptab] int32 page tables on the device for a
        paged engine (required), None for a dense one (refused)."""
        if not self.paged:
            if page_tables is not None:
                raise ValueError("page_tables require a paged engine")
            return None
        if page_tables is None:
            raise ValueError("paged engine needs page_tables (see "
                             "Scheduler)")
        page_tables = np.asarray(page_tables, np.int32)
        if page_tables.shape != (self.n_slots, self.n_ptab):
            raise ValueError(f"page_tables must be [{self.n_slots}, "
                             f"{self.n_ptab}], got {page_tables.shape}")
        return upload(page_tables, self.device)

    @torch.no_grad()
    def decode(self, arena, last_tokens, active, temp, top_k, top_p,
               page_tables=None, generator=None):
        """One token for every active slot.  ``active`` [n_slots] bool and
        (paged engines) ``page_tables`` [n_slots, n_ptab] int32 are host
        arrays (data, re-supplied each call); ``temp``/``top_k``/``top_p``
        the per-slot sampling knobs.  Returns ``(arena, last_tokens,
        logits[n_slots, V])``."""
        tables = self._tables_arg(page_tables)
        dev = self.device
        act = upload(np.asarray(active, bool), dev)
        pos = arena["index"]
        logits = self.model(
            last_tokens[:, None].long(), pos=pos, cache=arena,
            page_table=tables, active=act,
            paged_kernel=self.paged_kernel)[:, 0]                  # [B, V]
        arena["index"] = torch.where(act, pos + 1, pos)
        tok = self._sample(logits, generator, temp, top_k, top_p)
        return arena, torch.where(act, tok, last_tokens), logits

    @torch.no_grad()
    def verify(self, arena, last_tokens, draft_tokens, draft_len, active,
               temp, top_k, top_p, page_tables=None, generator=None,
               forced=None, first_tok=None, pos_set=None, allowed=None):
        """One speculative verify pass over every slot: score slot b's
        ``draft_len[b]`` candidates (``draft_tokens[b]``, zero-padded to
        the pass's width k) in one forward of width k+1, accept a
        prefix (:func:`accept_resample`) and advance each active slot's
        index by its own ``n_accepted + 1``; inactive slots stay where
        they are.  Returns ``(arena, last_tokens, tokens[n_slots, k+1],
        n_emitted[n_slots])``: ``tokens[b, :n_emitted[b]]`` is what slot b
        emitted (its last entry the new ``last_tokens[b]``), zeros on
        inactive slots.

        A ``forced[b]`` row is a prompt chunk, not a speculation: its
        window is ``first_tok[b]`` and ``draft_len[b]`` further prompt
        tokens, written at ``pos_set[b]`` (host truth: a freshly admitted
        slot's arena index is its previous occupant's), committed
        unconditionally, with the bonus token drawn from the last chunk
        position's distribution.

        ``draft_tokens`` [n_slots, k] and ``draft_len``, ``active``,
        ``page_tables`` (paged engines), ``forced``, ``first_tok``, ``pos_set`` and the
        sampling knobs are host arrays, as for :meth:`decode`.  The caller
        guarantees every active slot room for the whole window,
        ``index + k + 1 <= max_seq``: the attend clamps a row's position
        to ``max_seq - (k + 1)``, which would shift the window back over
        committed K/V.  ``allowed`` (grammar masks) is ROADMAP queue
        A12."""
        if allowed is not None:
            raise NotImplementedError(
                "verify(allowed=...) (grammar masks) is ROADMAP queue A12 "
                "(tenancy)")
        draft_tokens = np.asarray(draft_tokens, np.int32)
        if draft_tokens.ndim != 2 or draft_tokens.shape[0] != self.n_slots:
            raise ValueError(f"draft_tokens must be [n_slots={self.n_slots}"
                             f", k], got {draft_tokens.shape}")
        k = draft_tokens.shape[1]
        if k < 1:
            raise ValueError("verify needs k >= 1 draft positions; use "
                             "decode for a plain step")
        if k + 1 > self.max_seq:
            raise ValueError(f"draft width {k} cannot fit "
                             f"max_seq={self.max_seq}")
        tables = self._tables_arg(page_tables)
        dev = self.device
        act = upload(np.asarray(active, bool), dev)
        drafts = upload(draft_tokens, dev, torch.int64)
        index = arena["index"]
        pos, x0, forced_t = index, last_tokens, None
        if forced is not None:
            forced_t = upload(np.asarray(forced, bool), dev)
            pos = torch.where(forced_t,
                              upload(np.asarray(pos_set, np.int32), dev),
                              index)
            x0 = torch.where(forced_t,
                             upload(np.asarray(first_tok, np.int32), dev),
                             last_tokens)
        x = torch.cat([x0[:, None].long(), drafts], dim=1)      # [B, k+1]
        logits = self.model(
            x, pos=pos, cache=arena, page_table=tables,
            active=act, paged_kernel=self.paged_kernel)        # [B, k+1, V]
        tokens, n_acc = accept_resample(
            logits, drafts, upload(np.asarray(draft_len, np.int32), dev),
            generator, temp, top_k, top_p, forced=forced_t)
        n_em = n_acc + 1
        # the model wrote k+1 positions; the index keeps the committed
        # n_accepted + 1 (K/V past it are overwritten before attended)
        arena["index"] = torch.where(act, pos + n_em, index)
        new_last = torch.gather(tokens, 1, n_acc[:, None].long())[:, 0]
        last = torch.where(act, new_last, last_tokens)
        tokens = torch.where(act[:, None], tokens, torch.zeros_like(tokens))
        return arena, last, tokens, torch.where(act, n_em,
                                                torch.zeros_like(n_em))
