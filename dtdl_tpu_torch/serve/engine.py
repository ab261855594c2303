"""Batched LM inference engine over a block-paged KV arena, the port of
dtdl_tpu/serve/engine.py.

The engine owns the model and threads ``(arena, last_tokens)`` state that
the caller (:class:`~dtdl_tpu_torch.serve.scheduler.Scheduler`) keeps:

* :meth:`InferenceEngine.prefill` admits one prompt into a slot: the
  uncached suffix, right-padded to its power-of-two bucket, runs one paged
  forward at ``start`` (the number of prefix-cached tokens already in
  shared pages), writing its K/V through the slot's page-table row, and
  the first token is sampled from the last real position's logits;
* :meth:`InferenceEngine.decode` steps every slot one token at its own
  position; only active slots advance.

The arena is a pool of ``n_pages`` pages of ``page_size`` tokens per
block (page 0 the garbage page) plus one per-slot ``index``
[n_slots] int32, updated in place.  ``last_tokens`` is replaced, never
written in place, because the scheduler's lag harvest still holds the
vectors of earlier steps.  Host-side per-call inputs (tokens, page tables,
masks) go up through pinned buffers with non-blocking copies, so a step
never waits for the card.

The engine serves :meth:`TransformerLM.compute_copy` of the model given
to it: the weights in the compute dtype, taken once at construction.

Every paged attend ends in kernel K4 on the card (``paged_kernel='auto'``
resolves to the kernel on CUDA and to the plain version on the CPU;
``False`` asks for the plain version on any device).  The dense arena,
verify (speculative decoding), weight/KV quantization, a device mesh and
LoRA are later slices and raise ``NotImplementedError`` naming their
ROADMAP item.
"""

from __future__ import annotations

import numpy as np
import torch

from dtdl_tpu_torch.device import resolve_device, upload
from dtdl_tpu_torch.serve.sampling import SampleParams, sample


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
    """Prefill/decode over a paged KV arena (see module docstring).
    ``n_pages`` defaults to dense-equivalent capacity,
    ``n_slots * max_seq / page_size + 1``."""

    def __init__(self, model, n_slots: int = 8, buckets=None,
                 page_size: int = 16, n_pages: int | None = None,
                 paged_kernel="auto", device=None, quantize_weights=False,
                 kv_dtype=None, kv_pool_bytes: int | None = None, mesh=None,
                 lora_rank: int = 0, lora_adapters: int = 0, observer=None):
        self.device = resolve_device(device)
        if self.device != model.device:
            raise ValueError(f"the model lives on {model.device}, the engine "
                             f"was asked for {self.device}")
        if page_size == 0:
            raise NotImplementedError(
                "the dense [n_slots, max_seq] arena (page_size=0) is ROADMAP "
                "queue A5 (dense arena); pass page_size > 0")
        if quantize_weights or kv_dtype is not None \
                or kv_pool_bytes is not None:
            raise NotImplementedError(
                "weight and KV quantization (quantize_weights, kv_dtype, "
                "kv_pool_bytes) is ROADMAP queue A7 (quantized serving)")
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
        if page_size < 0 or model.cfg.max_seq % page_size:
            raise ValueError(f"page_size={page_size} must divide "
                             f"max_seq={model.cfg.max_seq}")
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
        self.page_size = page_size
        self.n_ptab = self.max_seq // page_size
        self.n_pages = (n_pages if n_pages is not None
                        else n_slots * self.n_ptab + 1)
        if self.n_pages < 2:
            raise ValueError(f"n_pages must be >= 2, got {self.n_pages}")
        self.paged_kernel = _resolve_paged_kernel(paged_kernel, self.device)

    # ---- state the caller threads ------------------------------------

    def init_arena(self) -> dict:
        """Fresh zeroed paged arena (pools per block + the slot index)."""
        return self.model.init_paged_cache(self.n_slots, self.n_pages,
                                           self.page_size)

    def init_last_tokens(self) -> torch.Tensor:
        return torch.zeros(self.n_slots, dtype=torch.int32,
                           device=self.device)

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
        first sampled token.  ``page_row`` is the slot's [n_ptab] page
        table (prefix-hit pages first, fresh pages for the rest of the
        prompt, garbage page 0 beyond) and ``start`` the page-aligned
        number of prefix-cached tokens already resident."""
        prompt = np.asarray(prompt, np.int32).ravel()
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if not 0 <= slot < self.n_slots:
            raise ValueError(f"slot {slot} out of range [0, {self.n_slots})")
        if page_row is None:
            raise ValueError("paged engine prefill needs the slot's page_row "
                             "(see Scheduler)")
        if start % self.page_size or start < 0:
            raise ValueError(f"start={start} must be a non-negative multiple "
                             f"of page_size={self.page_size}")
        page_row = np.asarray(page_row, np.int32).ravel()
        if page_row.size != self.n_ptab:
            raise ValueError(f"page_row must have {self.n_ptab} entries, got "
                             f"{page_row.size}")
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
        hidden = self.model(
            upload(padded, dev, torch.int64), return_hidden=True,
            pos=upload(np.asarray([start], np.int32), dev),
            cache=arena, page_table=upload(page_row[None], dev),
            active=torch.ones(1, dtype=torch.bool, device=dev),
            paged_kernel=self.paged_kernel)
        # logits of the last real suffix position only
        logits = self.model.head(hidden[:, prompt.size - 1])      # [1, V]
        tok = self._sample(logits, generator, [sampling.temperature],
                           [sampling.top_k], [sampling.top_p])
        arena["index"][slot] = start + int(prompt.size)
        last = last_tokens.clone()
        last[slot] = tok[0]
        return arena, last, logits[0]

    @torch.no_grad()
    def decode(self, arena, last_tokens, active, temp, top_k, top_p,
               page_tables, generator=None):
        """One token for every active slot.  ``active`` [n_slots] bool and
        ``page_tables`` [n_slots, n_ptab] int32 are host arrays (data, re-
        supplied each call); ``temp``/``top_k``/``top_p`` the per-slot
        sampling knobs.  Returns ``(arena, last_tokens, logits[n_slots,
        V])``."""
        page_tables = np.asarray(page_tables, np.int32)
        if page_tables.shape != (self.n_slots, self.n_ptab):
            raise ValueError(f"page_tables must be [{self.n_slots}, "
                             f"{self.n_ptab}], got {page_tables.shape}")
        dev = self.device
        act = upload(np.asarray(active, bool), dev)
        pos = arena["index"]
        logits = self.model(
            last_tokens[:, None].long(), pos=pos, cache=arena,
            page_table=upload(page_tables, dev), active=act,
            paged_kernel=self.paged_kernel)[:, 0]                  # [B, V]
        arena["index"] = torch.where(act, pos + 1, pos)
        tok = self._sample(logits, generator, temp, top_k, top_p)
        return arena, torch.where(act, tok, last_tokens), logits

    def verify(self, *args, **kwargs):
        raise NotImplementedError(
            "verify (speculative decoding and chunked prefill) is ROADMAP "
            "queue A6 (speculative decoding)")

