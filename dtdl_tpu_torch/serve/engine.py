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
  the same pass: chunked prefill);
* :meth:`InferenceEngine.extract_pages` and :meth:`InferenceEngine.
  inject_pages` (and their batch forms) hand a prompt's K/V pages between
  engines as host numpy trees: prefill/decode disaggregation, and the
  spill tiers' eviction and restore.

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
attends in plain torch, as the JAX one in plain jnp.

Tenancy.  ``lora_rank``/``lora_adapters`` give the engine an adapter bank
(:mod:`dtdl_tpu_torch.serve.tenant.lora`): ``adapter_id=`` on
:meth:`~InferenceEngine.prefill` and ``adapter_ids=`` [n_slots] on
:meth:`~InferenceEngine.decode` and :meth:`~InferenceEngine.verify` serve
each slot under its own adapter in one step (row 0 is the base model).
``allowed=`` on all three is a grammar mask (dense bools, or the packed
words of ``sampling.pack_mask``), packed on the host and uploaded through
the pinned staging as int32 words.  The neutral inputs cost nothing: a
step whose ids are all 0 skips the delta (which is exactly zero), and a
step without a mask uploads and applies none, where the JAX engine feeds
its compiled programs cached all-zero ids and all-true masks.

``mesh`` and ``rules`` (a :mod:`dtdl_tpu_torch.parallel.tensor` preset,
``'tp'`` by default) serve tensor-parallel: every process of the mesh
runs one engine (and one :class:`~dtdl_tpu_torch.serve.scheduler.
Scheduler`) over its shards of the weights (``place_lm``; quantized
weights through ``quant_logical_shardings``) and its share of the KV
heads (the arena is ``[n_pages, H/tp, page, D]`` per rank, 1/tp of the
bytes), attending its own heads through K4 and summing the
out-projection over ``model``; the vocab-sharded logits are gathered
before sampling, so every rank samples the same tokens from
bitwise-equal logits with its own identically seeded generator.  The
ranks must make the same calls in the same order: every call first
compares a digest of its host inputs across the processes
(``collectives.assert_same_across_hosts``), so a rank that parts fails
by name instead of hanging in a collective, and a decision a scheduler
takes from its clock (deadlines) is the leader's (:meth:`agree`).  The
byte receipts of ``compile_stats()`` stay the whole engine's, as the
JAX engine's count its sharded arrays whole.
"""

from __future__ import annotations

import numpy as np
import torch

from dtdl_tpu_torch.device import resolve_device, upload

# pool dtypes numpy cannot hold travel in a page payload as their bits
_BITS = {torch.bfloat16: (torch.int16, np.uint16),
         torch.float8_e4m3fn: (torch.uint8, np.uint8)}
from dtdl_tpu_torch.quant.core import (Fp8UnsupportedError, canon_kv_dtype,
                                       canon_weight_quant, quantize_params,
                                       tree_bytes)
from dtdl_tpu_torch.serve.paged import concat_payloads
from dtdl_tpu_torch.serve.sampling import (SampleParams, _masked,
                                           accept_resample, pack_mask,
                                           sample)
from dtdl_tpu_torch.serve.tenant.lora import (AdapterBank, adapter_template,
                                              bank_nbytes, init_bank)


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
                 rules="tp", lora_rank: int = 0, lora_adapters: int = 0,
                 observer=None):
        self.device = resolve_device(device)
        # a tensor-parallel engine may take the whole model from the host
        if self.device != model.device and (mesh is None
                                            or model.device.type != "cpu"):
            raise ValueError(f"the model lives on {model.device}, the engine "
                             f"was asked for {self.device}")
        self.weight_mode = canon_weight_quant(quantize_weights)
        self.kv_dtype = canon_kv_dtype(kv_dtype)
        self.mesh = mesh
        self.rules = rules if mesh is not None else None
        if mesh is not None:
            from dtdl_tpu_torch.parallel.tensor import heads_axis_size
            if self.weight_mode == "w8f" and not isinstance(rules, str):
                raise Fp8UnsupportedError(
                    "fp8 weights (quantize_weights='w8f') under a mesh need "
                    "a named rule preset (parallel/tensor.py RULE_PRESETS): "
                    "the quant rule map derives fp8 kernel and scale specs "
                    "from the f32 twin per preset; got a raw rules sequence")
            tp = heads_axis_size(mesh, rules)
            if model.cfg.n_heads % tp:
                raise ValueError(
                    f"n_heads={model.cfg.n_heads} must divide by the mesh's "
                    f"tensor-parallel axis size {tp} (rules={rules!r})")
        if lora_rank < 0 or lora_adapters < 0:
            raise ValueError("lora_rank/lora_adapters must be >= 0")
        if bool(lora_rank) != bool(lora_adapters):
            raise ValueError("pass lora_rank AND lora_adapters together "
                             "(both 0 disables the adapter bank)")
        if lora_adapters == 1:
            raise ValueError("lora_adapters must be >= 2: row 0 is the "
                             "reserved all-zeros base adapter")
        if lora_rank and mesh is not None:
            raise NotImplementedError(
                "a LoRA adapter bank on a tensor-parallel engine (each rank "
                "holding its heads' rows of q_b/k_b/v_b/out_a) is ROADMAP "
                "queue A12a's follow-up (tensor-parallel tenancy and "
                "handoff)")
        # the obs facade: each program is watched under JAX's name on its
        # first call (the sentinel counts captures with A5)
        self.observer = observer
        self._watched: set = set()
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
        model = model.compute_copy()
        self._param_bytes = tree_bytes(model.state_dict())
        self._calls = 0
        if mesh is not None:
            from dtdl_tpu_torch.parallel.tensor import place_lm
            model = place_lm(model, mesh, rules, self.device)
        self.model = model
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
            h = model.cfg.n_heads
            self.page_bytes = (
                tree_bytes(self.model.paged_cache_shapes(
                    1, 3, page_size, self.kv_dtype, n_heads=h))
                - tree_bytes(self.model.paged_cache_shapes(
                    1, 2, page_size, self.kv_dtype, n_heads=h)))
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
        # the adapter bank (f32 factors on the card, row 0 the base) and
        # its refcounted host registry
        self.lora_rank = lora_rank
        self.lora_adapters = lora_adapters
        self.adapter_bank = None
        if lora_rank:
            self.adapter_bank = AdapterBank(
                init_bank(model, lora_rank, lora_adapters,
                          device=self.device),
                adapter_template(model, lora_rank), observer=observer)

    # ---- state the caller threads ------------------------------------

    def arena_shapes(self, whole: bool = False) -> dict:
        """Shapes and dtypes of this rank's arena (nothing allocated), or
        with ``whole`` of the whole engine's (every head)."""
        h = self.model.cfg.n_heads if whole else None
        if self.paged:
            return self.model.paged_cache_shapes(
                self.n_slots, self.n_pages, self.page_size, self.kv_dtype,
                n_heads=h)
        return self.model.cache_shapes(self.n_slots, per_slot_index=True,
                                       kv_dtype=self.kv_dtype, n_heads=h)

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
        for the dense arena), ``quant`` the bytes: ``param_bytes`` (the served
        weights, what every decode step reads), the arena split into K/V
        payload and scale sidecars, and ``decode_hbm_bytes_per_token``,
        ``(param_bytes + kv_arena_bytes) / n_slots``, the whole engine's on
        a mesh too; and ``tp``, ``{"rules", "mesh"}`` of a tensor-parallel
        engine (None otherwise); ``lora``, the adapter bank's rank, rows
        and bytes (None without a bank)."""
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
        walk(self.arena_shapes(whole=True))
        param_bytes = self._param_bytes
        return {
            "tp": ({"rules": self.rules, "mesh": dict(self.mesh.shape)}
                   if self.mesh is not None else None),
            # the bank is one fixed [n_adapters, ...] allocation whatever
            # the load and evict traffic
            "lora": ({"rank": self.lora_rank,
                      "n_adapters": self.lora_adapters,
                      "bank_bytes": bank_nbytes(self.adapter_bank.bank)}
                     if self.adapter_bank is not None else None),
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

    def agree(self, value):
        """``value`` as the mesh's leader (its first process) has it, on
        every process of a tensor-parallel engine; ``value`` elsewhere."""
        if self.mesh is None or self.mesh.group is None:
            return value
        from dtdl_tpu_torch.parallel.collectives import host_broadcast
        from dtdl_tpu_torch.runtime.bootstrap import process_index
        return host_broadcast(value, process_index() == self.mesh.ranks[0])

    def _lockstep(self, *host) -> None:
        """On a tensor-parallel engine: raise unless every process makes
        this call (its kind and host inputs) as its n-th."""
        self._calls += 1
        if self.mesh is None or self.mesh.group is None:
            return
        from dtdl_tpu_torch.parallel.collectives import (
            assert_same_across_hosts)
        assert_same_across_hosts(
            (self._calls,) + host,
            f"tensor-parallel engine call {self._calls} ({host[0]})")

    def _watch(self, name: str) -> None:
        """Hand the program ``name`` (JAX's: ``serve.prefill[T]``,
        ``serve.decode``, ``serve.verify[k]``, ``serve.kv_extract``,
        ``serve.kv_inject``) to the observer's sentinel, once."""
        if self.observer is not None and name not in self._watched:
            self._watched.add(name)
            self.observer.watch(self.model, name)

    def bucket_for(self, length: int) -> int:
        for b in self.buckets:
            if length <= b:
                return b
        raise PromptTooLongError(
            f"prompt length {length} exceeds the largest prefill bucket "
            f"{self.buckets[-1]} (buckets={self.buckets}, "
            f"max_seq={self.max_seq})")

    def _sample(self, logits, generator, temp, top_k, top_p, allowed=None):
        """Greedy rows take the raw argmax (of the masked logits under a
        grammar mask); the filtered draw runs only when some row samples
        (decided from the host-side knobs)."""
        if np.all(np.asarray(temp) <= 0.0):
            if allowed is not None:
                logits = _masked(logits, allowed)
            return torch.argmax(logits, dim=-1).to(torch.int32)
        if generator is None:
            raise ValueError("sampled requests need a torch.Generator on "
                             f"{self.device}")
        return sample(logits, generator,
                      upload(np.asarray(temp, np.float32), self.device),
                      upload(np.asarray(top_k, np.int32), self.device),
                      upload(np.asarray(top_p, np.float32), self.device),
                      allowed=allowed)

    def _lora_args(self, adapter_ids, n: int):
        """``(bank, ids on the card)`` for the model's forward, or None
        when every id is 0 (the base row: a zero delta, skipped) or the
        engine has no bank.  Ids without a bank raise."""
        if self.adapter_bank is None:
            if adapter_ids is not None:
                raise ValueError("adapter ids require an adapter bank "
                                 "(lora_rank/lora_adapters > 0)")
            return None
        if adapter_ids is None:
            return None
        ids = np.asarray(adapter_ids, np.int64).reshape(-1)
        if ids.size != n:
            raise ValueError(f"adapter ids must be [{n}], got {ids.size}")
        if not ids.any():
            return None
        if ids.min() < 0 or ids.max() >= self.lora_adapters:
            raise ValueError(f"adapter ids must be in [0, "
                             f"{self.lora_adapters}), got {ids.tolist()}")
        return self.adapter_bank.bank, upload(ids, self.device)

    def _mask_arg(self, allowed):
        """A grammar mask packed on the host (``pack_mask``) and uploaded
        as int32 words (the same bits), or None."""
        if allowed is None:
            return None
        return upload(pack_mask(allowed).view(np.int32), self.device)

    # ---- the two entry points ----------------------------------------

    @torch.no_grad()
    def prefill(self, arena, last_tokens, slot: int, prompt,
                sampling: SampleParams = SampleParams(), generator=None,
                page_row=None, start: int = 0, adapter_id=None,
                allowed=None):
        """Admit ``prompt`` (the uncached suffix) into ``slot``; returns
        ``(arena, last_tokens, logits[V])`` with ``last_tokens[slot]`` the
        first sampled token.  Paged: ``page_row`` is the slot's [n_ptab]
        page table (prefix-hit pages first, fresh pages for the rest of
        the prompt, garbage page 0 beyond) and ``start`` the page-aligned
        number of prefix-cached tokens already resident.  Dense: the
        prompt runs at position 0 into the slot's row, which it
        overwrites whole (zeros past the bucket).  ``adapter_id`` is the
        request's row in the adapter bank (None or 0: the base model);
        ``allowed`` ([1, V] bool or packed words) masks the sampled first
        token (a grammar's start state)."""
        prompt = np.asarray(prompt, np.int32).ravel()
        words = None if allowed is None else pack_mask(allowed)
        self._lockstep("prefill", slot, prompt, page_row, start,
                       (sampling.temperature, sampling.top_k, sampling.top_p),
                       adapter_id, words)
        lora = self._lora_args(None if adapter_id is None else [adapter_id],
                               1)
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
        self._watch(f"serve.prefill[{T}]")
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
                paged_kernel=self.paged_kernel, lora=lora)
        else:
            # the slot's row as a one-row dense cache at index 0 (views
            # into the arena, so the forward writes the arena itself)
            row = {name: {"attn": {leaf: buf[slot:slot + 1].zero_()
                                   for leaf, buf in node["attn"].items()}}
                   for name, node in arena.items() if name != "index"}
            row["index"] = torch.zeros((), dtype=torch.int32)
            hidden = self.model(tokens, return_hidden=True, cache=row,
                                lora=lora)
        # logits of the last real suffix position only
        logits = self.model.head(hidden[:, prompt.size - 1])      # [1, V]
        tok = self._sample(logits, generator, [sampling.temperature],
                           [sampling.top_k], [sampling.top_p],
                           self._mask_arg(words))
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
               page_tables=None, generator=None, adapter_ids=None,
               allowed=None):
        """One token for every active slot.  ``active`` [n_slots] bool and
        (paged engines) ``page_tables`` [n_slots, n_ptab] int32 are host
        arrays (data, re-supplied each call); ``temp``/``top_k``/``top_p``
        the per-slot sampling knobs; ``adapter_ids`` [n_slots] each slot's
        adapter row and ``allowed`` [n_slots, V] (or packed) its grammar
        mask, host arrays too.  Returns ``(arena, last_tokens,
        logits[n_slots, V])``."""
        words = None if allowed is None else pack_mask(allowed)
        self._lockstep("decode", active, temp, top_k, top_p, page_tables,
                       adapter_ids, words)
        self._watch("serve.decode")
        tables = self._tables_arg(page_tables)
        lora = self._lora_args(adapter_ids, self.n_slots)
        dev = self.device
        act = upload(np.asarray(active, bool), dev)
        pos = arena["index"]
        logits = self.model(
            last_tokens[:, None].long(), pos=pos, cache=arena,
            page_table=tables, active=act,
            paged_kernel=self.paged_kernel, lora=lora)[:, 0]       # [B, V]
        arena["index"] = torch.where(act, pos + 1, pos)
        tok = self._sample(logits, generator, temp, top_k, top_p,
                           self._mask_arg(words))
        return arena, torch.where(act, tok, last_tokens), logits

    @torch.no_grad()
    def verify(self, arena, last_tokens, draft_tokens, draft_len, active,
               temp, top_k, top_p, page_tables=None, generator=None,
               forced=None, first_tok=None, pos_set=None, adapter_ids=None,
               allowed=None):
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
        committed K/V.  ``adapter_ids`` [n_slots] are the slots' adapter
        rows; ``allowed`` [n_slots, k+1, V] bools (or packed words) mask
        each window position's logits (the scheduler walks a grammar
        along the draft)."""
        draft_tokens = np.asarray(draft_tokens, np.int32)
        words = None if allowed is None else pack_mask(allowed)
        self._lockstep("verify", draft_tokens, draft_len, active, temp,
                       top_k, top_p, page_tables, forced, first_tok, pos_set,
                       adapter_ids, words)
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
        self._watch(f"serve.verify[{k}]")
        tables = self._tables_arg(page_tables)
        lora = self._lora_args(adapter_ids, self.n_slots)
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
            active=act, paged_kernel=self.paged_kernel,
            lora=lora)                                         # [B, k+1, V]
        tokens, n_acc = accept_resample(
            logits, drafts, upload(np.asarray(draft_len, np.int32), dev),
            generator, temp, top_k, top_p, forced=forced_t,
            allowed=self._mask_arg(words))
        n_em = n_acc + 1
        # the model wrote k+1 positions; the index keeps the committed
        # n_accepted + 1 (K/V past it are overwritten before attended)
        arena["index"] = torch.where(act, pos + n_em, index)
        new_last = torch.gather(tokens, 1, n_acc[:, None].long())[:, 0]
        last = torch.where(act, new_last, last_tokens)
        tokens = torch.where(act[:, None], tokens, torch.zeros_like(tokens))
        return arena, last, tokens, torch.where(act, n_em,
                                                torch.zeros_like(n_em))

    # ---- prefill/decode disaggregation: the page-granular KV handoff --

    def _pool_leaves(self, arena, prefix=()):
        """``[(path, pool tensor)]`` of every page-pool leaf (K/V pages
        and, on int8/fp8 arenas, their scale siblings), the per-slot
        ``index`` left out."""
        out = []
        for name, node in arena.items():
            if name == "index":
                continue
            if isinstance(node, dict):
                out.extend(self._pool_leaves(node, prefix + (name,)))
            else:
                out.append((prefix + (name,), node))
        return out

    def _check_handoff(self):
        if not self.paged:
            raise ValueError("KV handoff requires a paged engine "
                             "(page_size > 0)")

    def _extract_chunks(self, arena, chunks) -> list:
        """Gather each chunk of page ids from every pool leaf and start
        its copy into pinned host memory; one event after the last copy
        is the only wait.  Returns one numpy tree per chunk."""
        self._watch("serve.kv_extract")
        leaves = self._pool_leaves(arena)
        cuda = self.device.type == "cuda"
        staged = []
        for ids in chunks:
            idx = upload(np.asarray(ids, np.int64), self.device)
            got = []
            for path, pool in leaves:
                bits = _BITS.get(pool.dtype)
                t = self._bits_view(pool).index_select(0, idx)
                if cuda:
                    host = torch.empty(t.shape, dtype=t.dtype,
                                       pin_memory=True)
                    host.copy_(t, non_blocking=True)
                    t = host
                got.append((path, t, bits))
            staged.append(got)
        if cuda:
            # the gathers follow the prefill that wrote the pages on this
            # stream, so one event after the last copy is enough: the one
            # deliberate sync of a handoff (kv_handoff_s, spill_s)
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
        out = []
        for got in staged:
            tree: dict = {}
            for path, t, bits in got:
                arr = t.numpy()
                if bits is not None:
                    arr = arr.view(bits[1])
                if cuda:
                    # out of the pinned staging: spilled payloads may
                    # live long, and pinned host memory is scarce
                    arr = arr.copy()
                node = tree
                for k in path[:-1]:
                    node = node.setdefault(k, {})
                node[path[-1]] = arr
            out.append(tree)
        return out

    @torch.no_grad()
    def extract_pages(self, arena, page_ids) -> dict:
        """Export ``page_ids`` (a slot's prompt pages, in logical order) to
        host memory: the source half of prefill/decode disaggregation.
        Returns a tree of numpy arrays keyed as the arena (``block_i/attn/
        pages_key`` ..., the ``index`` left home), each leaf
        ``[len(page_ids), H, page_size, ...]``; bf16 and fp8 leaves carry
        their bits (uint16, uint8).  The one wait for the card is an event
        after the copies, behind the prefill that wrote the pages."""
        self._check_handoff()
        n = len(page_ids)
        if not 0 < n <= self.n_ptab:
            raise ValueError(f"need 1..{self.n_ptab} pages, got {n}")
        self._lockstep("extract_pages", np.asarray(page_ids, np.int64))
        return self._extract_chunks(arena, [list(page_ids)])[0]

    @torch.no_grad()
    def extract_pages_batch(self, arena, page_ids) -> dict:
        """Export any number of pages in one sync, the spill-on-evict
        primitive: ``page_ids`` goes in chunks of ``n_ptab``, every
        chunk's gather and copy is dispatched before the one wait, and the
        tree's leaves hold ``len(page_ids)`` pages in input order."""
        self._check_handoff()
        n = len(page_ids)
        if n < 1:
            raise ValueError("need at least one page id")
        self._lockstep("extract_pages_batch", np.asarray(page_ids, np.int64))
        page_ids = list(page_ids)
        trees = self._extract_chunks(
            arena, [page_ids[i:i + self.n_ptab]
                    for i in range(0, n, self.n_ptab)])
        return trees[0] if len(trees) == 1 else concat_payloads(trees)

    def _payload_tensor(self, path, arr, pool, n):
        """One payload leaf uploaded as a tensor of ``pool``'s dtype: bits
        viewed back (uint16 into bf16, uint8 into fp8), anything else
        cast."""
        arr = np.asarray(arr)
        want = (n,) + tuple(pool.shape[1:])
        if arr.shape != want:
            if self.mesh is not None and arr.ndim == pool.ndim \
                    and arr.shape[0] == n:
                raise NotImplementedError(
                    f"{'/'.join(path)}: a payload of {arr.shape[1]} heads "
                    f"into a tensor-parallel rank's {pool.shape[1]}: the "
                    f"cross-rank handoff is ROADMAP queue A12a's follow-up "
                    f"(each rank hands over its own heads' pages)")
            raise ValueError(f"{'/'.join(path)}: payload leaf "
                             f"{arr.shape}, the arena wants {want}")
        bits = _BITS.get(pool.dtype)
        arr = np.ascontiguousarray(arr)
        if not arr.flags.writeable:     # a disk record read back
            arr = arr.copy()
        if bits is not None and arr.dtype == bits[1]:
            raw = arr.view(np.int16) if bits[1] == np.uint16 else arr
            return upload(raw, self.device).view(pool.dtype)
        return upload(arr, self.device).to(pool.dtype)

    @staticmethod
    def _bits_view(t):
        """A bf16 or fp8 tensor as its integer bits (the copies of a
        handoff move bits; index_copy_ has no fp8 kernel on the CPU)."""
        bits = _BITS.get(t.dtype)
        return t if bits is None else t.view(bits[0])

    @torch.no_grad()
    def inject_pages(self, arena, last_tokens, data, page_ids, slot: int,
                     index: int, first_token: int):
        """Adopt extracted prompt pages into this engine's pool: write
        ``data`` (an :meth:`extract_pages` tree) into ``page_ids`` (pages
        the target scheduler allocated, never the garbage page 0), set
        slot ``slot``'s cache index to ``index`` (the prompt length) and
        its ``last_tokens`` entry to ``first_token``; the slot then
        decodes through :meth:`decode`/:meth:`verify` as if this engine
        had prefilled the prompt.  The payload goes up by
        :func:`~dtdl_tpu_torch.device.upload` and into place by
        ``index_copy_``: nothing waits for the card.  Returns ``(arena,
        last_tokens)``."""
        self._check_handoff()
        n = len(page_ids)
        leaves = self._pool_leaves(data)
        if not leaves or any(np.shape(a)[0] != n for _, a in leaves):
            raise ValueError(f"data leaves must carry {n} pages "
                             f"(one per page id)")
        if not 0 < n <= self.n_ptab:
            raise ValueError(f"need 1..{self.n_ptab} pages, got {n}")
        if any(not 0 < p < self.n_pages for p in page_ids):
            raise ValueError(f"page ids must be in [1, {self.n_pages}), "
                             f"got {list(page_ids)}")
        if not 0 <= slot < self.n_slots:
            raise ValueError(f"slot {slot} out of range "
                             f"[0, {self.n_slots})")
        if not 0 < index < self.max_seq:
            raise ValueError(f"index {index} must be in (0, "
                             f"{self.max_seq}) — a full-to-the-brim "
                             f"sequence has nothing left to decode")
        self._lockstep("inject_pages", np.asarray(page_ids, np.int64), slot,
                       index, first_token)
        pools = dict(self._pool_leaves(arena))
        given = {path for path, _ in leaves}
        if given != set(pools):
            missing = sorted("/".join(p) for p in set(pools) - given)
            extra = sorted("/".join(p) for p in given - set(pools))
            raise ValueError(f"payload leaves do not match the arena: "
                             f"missing {missing}, extra {extra}")
        self._watch("serve.kv_inject")
        ids = upload(np.asarray(page_ids, np.int64), self.device)
        for path, arr in leaves:
            pool = pools[path]
            self._bits_view(pool).index_copy_(
                0, ids, self._bits_view(self._payload_tensor(path, arr, pool,
                                                             n)))
        arena["index"][slot] = int(index)
        last = last_tokens.clone()
        last[slot] = int(first_token)
        return arena, last

    def inject_pages_batch(self, arena, last_tokens, items):
        """Adopt several extracted page groups, ``items`` of ``(data,
        page_ids, slot, index, first_token)``, one :meth:`inject_pages`
        each; no sync.  Returns ``(arena, last_tokens)``."""
        for data, page_ids, slot, index, first_token in items:
            arena, last_tokens = self.inject_pages(
                arena, last_tokens, data, page_ids, slot, index,
                first_token)
        return arena, last_tokens
