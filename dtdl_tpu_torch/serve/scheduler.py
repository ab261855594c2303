"""Slot-based continuous batcher over the paged InferenceEngine, the port
of dtdl_tpu/serve/scheduler.py (its continuous-batching core).

A request is admitted into the first free slot (one bucketed prefill of
its uncached suffix), decodes in lockstep with whatever else is in
flight, and retires the moment its budget is exhausted, freeing the row
for the next queued request mid-flight.

Admission is gated on free pages: the scheduler owns the host-side
:class:`~dtdl_tpu_torch.serve.paged.PageAllocator`, maps the longest
cached prompt prefix read-only, prefills only the suffix, and waits in
FIFO order when the pool cannot map a prompt yet.  Decode growth
allocates pages from worst-case host arithmetic (``pos_hi``), so the
fresh table rides into the next step as data; a slot the pool cannot grow
is shed with the named :class:`PagePoolExhaustedError` message.

Dispatch never reads what it just dispatched.  The sampled tokens stay on
the card as the next step's input; each step's token vector starts a
non-blocking copy into pinned host memory with a CUDA event behind it,
and the host reads it ``harvest_lag`` steps later, when the event has long
fired.  EOS is therefore seen up to ``harvest_lag`` steps late; the
garbage tokens past it are trimmed at harvest.

Not in this slice (each raises ``NotImplementedError`` naming its ROADMAP
item): speculative decoding (``speculate``/``draft``), chunked prefill,
KV spill tiers, the exporter and observer, LoRA adapters, grammars,
streams, and prefill/decode disaggregation (``prefill_only``,
``kv_inject``).
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Any, Optional, Sequence

import numpy as np
import torch

from dtdl_tpu_torch.device import resolve_device
from dtdl_tpu_torch.serve.engine import InferenceEngine, PromptTooLongError
from dtdl_tpu_torch.serve.metrics import ERROR_KINDS, ServeMetrics
from dtdl_tpu_torch.serve.paged import (GARBAGE_PAGE, PageAllocator,
                                        PagePoolExhaustedError)
from dtdl_tpu_torch.serve.sampling import GREEDY, SampleParams

_ids = itertools.count()


@dataclasses.dataclass
class Request:
    """One generation request plus its lifecycle record.

    ``tokens`` fills with the generated tokens (eos included, post-eos
    trimmed) as they harvest; ``done`` flips when the last one lands.
    ``error`` is set instead of raising when the scheduler rejects,
    expires or sheds the request, always starting with its kind
    (``rejected:``, ``expired:``, ``shed:``).  ``deadline_s`` is a budget
    from this scheduler's submit, ``deadline_at`` an absolute
    ``time.perf_counter()`` instant.  The remaining fields belong to later
    slices and must stay at their defaults here.
    """
    prompt: Sequence[int]
    max_new_tokens: int
    sampling: SampleParams = GREEDY
    eos_id: Optional[int] = None
    speculate: int = 0
    deadline_s: Optional[float] = None
    deadline_at: Optional[float] = None
    prefill_only: bool = False
    kv_inject: Optional[dict] = dataclasses.field(default=None, repr=False)
    adapter: Optional[str] = None
    grammar: Any = dataclasses.field(default=None, repr=False)
    stream: Any = dataclasses.field(default=None, repr=False)
    rid: int = dataclasses.field(default_factory=lambda: next(_ids))
    tokens: list = dataclasses.field(default_factory=list)
    done: bool = False
    error: Optional[str] = None
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0
    admit_step: int = -1
    _guaranteed: int = dataclasses.field(default=0, repr=False)
    _retired: bool = dataclasses.field(default=False, repr=False)

    def __post_init__(self):
        if self.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{self.max_new_tokens}")
        if self.speculate < 0:
            raise ValueError(f"speculate must be >= 0, got {self.speculate}")

    def __repr__(self):
        state = ("pending" if not self.done
                 else "error" if self.error else "done")
        err = f", error={self.error!r}" if self.error else ""
        return (f"Request(rid={self.rid}, prompt_len={len(self.prompt)}, "
                f"max_new_tokens={self.max_new_tokens}, "
                f"tokens={len(self.tokens)}, {state}{err})")


_LATER = (
    ("speculate", 0, "speculative decoding is ROADMAP queue A6"),
    ("prefill_only", False, "prefill/decode disaggregation is ROADMAP "
                            "queue A12 (fleet)"),
    ("kv_inject", None, "prefill/decode disaggregation is ROADMAP queue "
                        "A12 (fleet)"),
    ("adapter", None, "LoRA adapters are ROADMAP queue A12 (tenancy)"),
    ("grammar", None, "grammar-constrained decoding is ROADMAP queue A12 "
                      "(tenancy)"),
    ("stream", None, "token streams are ROADMAP queue A12 (tenancy)"),
)


class _SlotState:
    """Host-side tracking while a request occupies a slot: ``pos`` is the
    cache index as of the last harvested step; ``inflight`` counts the
    dispatched-but-unharvested steps, so ``pos_hi`` bounds the device
    index from above."""

    __slots__ = ("rid", "pos", "inflight")

    def __init__(self, rid: int, pos: int):
        self.rid = rid
        self.pos = pos
        self.inflight = 0

    @property
    def pos_hi(self) -> int:
        return self.pos + self.inflight

    def dispatched(self) -> None:
        self.inflight += 1

    def settle(self, n_emitted: int) -> None:
        self.inflight = max(0, self.inflight - 1)
        self.pos += n_emitted


class _HostTokens:
    """A device token vector on its way to the host: a non-blocking copy
    into pinned memory plus an event, so reading it later waits for that
    one copy and not for whatever the card has queued since."""

    __slots__ = ("_host", "_event")

    def __init__(self, tokens: torch.Tensor):
        if tokens.is_cuda:
            self._host = torch.empty(tokens.shape, dtype=tokens.dtype,
                                     pin_memory=True)
            self._host.copy_(tokens, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host, self._event = tokens, None

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


class Scheduler:
    """Continuous batcher (see module docstring).  ``submit`` enqueues or
    rejects; ``step`` runs one watchdog + admit + decode + harvest round;
    ``run`` drives until everything submitted has finished and returns
    the finished requests in completion order."""

    def __init__(self, engine: InferenceEngine, seed: int = 0,
                 harvest_lag: int = 4, max_queue: Optional[int] = None,
                 prefix_cache: bool = True, device=None, observer=None, draft=None, exporter=None,
                 chunk_tokens: Optional[int] = None,
                 spill_host_bytes: Optional[int] = None,
                 spill_dir: Optional[str] = None,
                 spill_disk_bytes: Optional[int] = None):
        dev = resolve_device(device)
        if dev != engine.device:
            raise ValueError(f"the engine runs on {engine.device}, the "
                             f"scheduler was asked for {dev}")
        if draft is not None:
            raise NotImplementedError(
                "draft sources (speculative decoding) are ROADMAP queue A6")
        if chunk_tokens is not None:
            raise NotImplementedError(
                "chunked prefill is ROADMAP queue A6 (chunked prefill)")
        if spill_host_bytes is not None or spill_dir is not None \
                or spill_disk_bytes is not None:
            raise NotImplementedError(
                "KV spill tiers are ROADMAP queue A12 (KV hierarchy)")
        if observer is not None or exporter is not None:
            raise NotImplementedError(
                "the observer and the metrics exporter are ROADMAP queue "
                "A13 (operations)")
        if harvest_lag < 0:
            raise ValueError(f"harvest_lag must be >= 0, got {harvest_lag}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.engine = engine
        self.harvest_lag = harvest_lag
        self.max_queue = max_queue
        self.arena = engine.init_arena()
        self.last_tokens = engine.init_last_tokens()
        self.queue: deque[Request] = deque()
        self.slots: list[Optional[Request]] = [None] * engine.n_slots
        self.metrics = ServeMetrics(n_slots=engine.n_slots)
        self.finished: list[Request] = []
        self._reqs: dict[int, Request] = {}
        self._active = np.zeros(engine.n_slots, bool)
        self._state: list[Optional[_SlotState]] = [None] * engine.n_slots
        self._temp = np.zeros(engine.n_slots, np.float32)
        self._topk = np.zeros(engine.n_slots, np.int32)
        self._topp = np.ones(engine.n_slots, np.float32)
        self._gen = torch.Generator(device=dev).manual_seed(seed)
        # lag harvest: (token vector on its way to the host, ((slot, rid),))
        self._pending: deque[tuple[_HostTokens, tuple]] = deque()
        self.step_count = 0
        self._deadlines_seen = False
        self.pages = PageAllocator(engine.n_pages, engine.page_size,
                                   prefix_cache=prefix_cache)
        self._ptab = np.full((engine.n_slots, engine.n_ptab), GARBAGE_PAGE,
                             np.int32)
        self._slot_pages: list[list[int]] = [[] for _ in
                                             range(engine.n_slots)]

    # ---- intake -------------------------------------------------------

    def _finish_error(self, req: Request, reason: str, metric_hook,
                      kind: str) -> Request:
        assert kind in ERROR_KINDS, kind
        req.error = f"{kind}: {reason}"
        req.done = True
        req.t_done = time.perf_counter()
        self.finished.append(req)
        metric_hook(req)
        return req

    def _reject(self, req: Request, reason: str) -> Request:
        self._reqs[req.rid] = req
        return self._finish_error(req, reason, self.metrics.on_reject,
                                  "rejected")

    def submit(self, req: Request) -> Request:
        """Enqueue ``req``; one the scheduler cannot serve comes back
        rejected (``req.error`` set, ``req.done`` True): a prompt past the
        largest prefill bucket, a full admission queue, or a prompt whose
        pages exceed the whole pool."""
        for field, default, why in _LATER:
            if getattr(req, field) != default:
                raise NotImplementedError(f"Request.{field}: {why}")
        prompt_len = len(req.prompt)
        if prompt_len < 1:
            raise ValueError("empty prompt")
        req.t_submit = time.perf_counter()
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            return self._reject(req, f"admission queue full ({self.max_queue}"
                                     f" waiting); retry later")
        try:
            self.engine.bucket_for(prompt_len)
        except PromptTooLongError as e:
            return self._reject(req, str(e))
        pg = self.engine.page_size
        need = (prompt_len + 1 + pg - 1) // pg
        if need > self.pages.capacity:
            return self._reject(
                req, f"page pool exhausted: prompt needs {need} pages "
                     f"(page_size={pg}) but the pool has only "
                     f"{self.pages.capacity}")
        if req.deadline_at is None and req.deadline_s is not None:
            req.deadline_at = req.t_submit + req.deadline_s
        if req.deadline_at is not None:
            self._deadlines_seen = True
        self._reqs[req.rid] = req
        self.queue.append(req)
        self.metrics.on_submit(req)
        return req

    # ---- slot lifecycle ----------------------------------------------

    def _budget(self, req: Request) -> int:
        # the k-th decode step writes K/V at position len(prompt)+k-1,
        # which must stay < max_seq; prefill contributes token 1
        return min(req.max_new_tokens,
                   self.engine.max_seq - len(req.prompt) + 1)

    def _retire(self, slot: int):
        req = self.slots[slot]
        req._retired = True
        self.slots[slot] = None
        self._active[slot] = False
        self._temp[slot], self._topk[slot], self._topp[slot] = 0.0, 0, 1.0
        # release the slot's pages (cached prefix pages become evictable)
        # and point the stale table row at the garbage page; any step
        # still in flight for it was dispatched with its own table copy,
        # and the stream orders it before whatever reuses the pages
        for p in self._slot_pages[slot]:
            self.pages.release(p)
        self._slot_pages[slot] = []
        self._ptab[slot] = GARBAGE_PAGE

    def _expire(self):
        """Deadline watchdog: retire any request past its deadline, queued
        or in a slot, with ``req.error`` set.  Free until the first
        deadline-carrying request arrives."""
        if not self._deadlines_seen:
            return
        now = time.perf_counter()

        def expired(req):
            return req.deadline_at is not None and now >= req.deadline_at

        for req in [r for r in self.queue if expired(r)]:
            self.queue.remove(req)
            self._finish_error(req, "deadline exceeded before admission",
                               self.metrics.on_expire, "expired")
        for slot, req in enumerate(self.slots):
            if req is not None and expired(req):
                self._finish_error(
                    req, f"deadline exceeded after {len(req.tokens)} tokens",
                    self.metrics.on_expire, "expired")
                self._retire(slot)

    def _admit(self):
        eng = self.engine
        for slot in range(eng.n_slots):
            if self.slots[slot] is not None or not self.queue:
                continue
            req = self.queue[0]
            pg = eng.page_size
            prompt = [int(t) for t in req.prompt]
            hits = self.pages.match_prefix(prompt)
            hashes = (self.pages.page_hashes(prompt)
                      if self.pages.prefix_cache else [])
            # the suffix's padded bucket must fit max_seq too; dropping
            # trailing hit pages grows the suffix until it does
            while hits and (len(hits) * pg
                            + eng.bucket_for(len(prompt) - len(hits) * pg)
                            > eng.max_seq):
                hits.pop()
            start = len(hits) * pg
            n_prompt_pages = -(-len(prompt) // pg)
            need = n_prompt_pages - len(hits)
            # pinning an evictable (refcount-0) hit consumes a page too
            evictable = sum(1 for p in hits if self.pages.refcount(p) == 0)
            if need + evictable > self.pages.available:
                break                  # FIFO backpressure: wait for pages
            for p in hits:             # pin BEFORE alloc can evict them
                self.pages.acquire(p)
            fresh = [self.pages.alloc() for _ in range(need)]
            row = np.full(eng.n_ptab, GARBAGE_PAGE, np.int32)
            row[:len(hits)] = hits
            row[len(hits):n_prompt_pages] = fresh
            suffix = prompt[start:]
            self.queue.popleft()
            sp = req.sampling
            self.arena, self.last_tokens, _ = eng.prefill(
                self.arena, self.last_tokens, slot, suffix, sp, self._gen,
                page_row=row, start=start)
            self._ptab[slot] = row
            self._slot_pages[slot] = list(hits) + list(fresh)
            # publish the freshly computed full prompt pages: the next
            # identical prefix hits (same tokens at the same positions give
            # identical K/V, so first-writer-wins is sound)
            for i in range(len(hits), len(hashes)):
                self.pages.register(hashes[i], int(row[i]))
            self.metrics.on_prefix(len(hits), len(hashes), start)
            self.slots[slot] = req
            self._active[slot] = True
            self._state[slot] = _SlotState(req.rid, len(req.prompt))
            self._temp[slot] = sp.temperature
            self._topk[slot] = sp.top_k
            self._topp[slot] = sp.top_p
            req.t_admit = time.perf_counter()
            req.admit_step = self.step_count
            self.metrics.on_admit(req, slot, len(suffix))
            req._guaranteed = 1
            self._state[slot].dispatched()
            self._pending.append((_HostTokens(self.last_tokens),
                                  ((slot, req.rid),)))
            if req._guaranteed >= self._budget(req):
                self._retire(slot)

    def _grow_pages(self, step_act):
        """Map pages covering every stepped slot's worst-case write window
        ``[0, pos_hi + 1)`` before dispatch (host arithmetic, no device
        reads).  A slot the pool cannot grow, with nothing evictable, is
        shed with the named :class:`PagePoolExhaustedError` message."""
        pg = self.engine.page_size
        for slot, req in enumerate(self.slots):
            if req is None or not step_act[slot]:
                continue
            st = self._state[slot]
            # pos_hi runs one ahead of the engine index; clamp to the table
            # (an out-of-range write clamps into the slot's own last page)
            need = min(-(-(st.pos_hi + 1) // pg), self.engine.n_ptab)
            pages = self._slot_pages[slot]
            try:
                while len(pages) < need:
                    p = self.pages.alloc()
                    self._ptab[slot, len(pages)] = p
                    pages.append(p)
            except PagePoolExhaustedError as e:
                self._finish_error(
                    req, f"{e} (shed after {len(req.tokens)} harvested "
                         f"tokens)", self.metrics.on_shed, "shed")
                self._retire(slot)

    # ---- the decode round --------------------------------------------

    def step(self) -> int:
        """One watchdog + admit + decode round; returns how many slots
        stepped."""
        self._expire()
        self._admit()
        # overflow settling: a slot whose worst-case index leaves no room
        # for one more write waits for its in-flight steps to harvest
        # (only ever within the last steps of a sequence)
        while self._pending and any(
                self._state[s].pos_hi > self.engine.max_seq - 1
                for s in range(self.engine.n_slots) if self._active[s]):
            self._harvest_one()
        n_active = int(self._active.sum())
        if n_active:
            self._dispatch_round()
        self.step_count += 1
        self.metrics.on_step(n_active, self.engine.n_slots)
        self.metrics.on_pages(self.pages.pages_in_use, self.pages.capacity)
        if len(self._pending) > self.harvest_lag:
            while len(self._pending) > self.harvest_lag:
                self._harvest_one()
        elif not n_active and self._pending:
            self._harvest_one()
        return n_active

    def _dispatch_round(self):
        step_act = self._active.copy()
        self._grow_pages(step_act)
        step_act &= self._active          # growth may have shed slots
        if not step_act.any():
            return
        entries = tuple((slot, req.rid) for slot, req in enumerate(self.slots)
                        if step_act[slot])
        self.arena, self.last_tokens, _ = self.engine.decode(
            self.arena, self.last_tokens, step_act, self._temp, self._topk,
            self._topp, self._ptab, generator=self._gen)
        self._pending.append((_HostTokens(self.last_tokens), entries))
        for slot, _ in entries:
            self._state[slot].dispatched()
            req = self.slots[slot]
            req._guaranteed += 1
            if req._guaranteed >= self._budget(req):
                self._retire(slot)

    # ---- harvest ------------------------------------------------------

    def _harvest_one(self):
        window, entries = self._pending.popleft()
        arr = window.numpy()       # waits only for this (lagged) copy
        now = time.perf_counter()
        for slot, rid in entries:
            req = self._reqs[rid]
            st = self._state[slot]
            if st is not None and st.rid == rid:
                st.settle(1)
            if req.done:           # post-eos/budget garbage from the lag
                continue
            budget = self._budget(req)
            first_window = len(req.tokens) == 0
            req.tokens.append(int(arr[slot]))
            if len(req.tokens) == 1:
                req.t_first = now
                self.metrics.on_first_token(req)
            hit_eos = req.eos_id is not None and req.tokens[-1] == req.eos_id
            if hit_eos or len(req.tokens) >= budget:
                req.done = True
                req.t_done = now
                self.finished.append(req)
                self.metrics.on_finish(req)
            self.metrics.on_harvest_tokens(0 if first_window else 1)
            if req.done and self.slots[slot] is req:
                self._retire(slot)

    def drain(self):
        """Harvest everything still in flight (the boundary sync)."""
        while self._pending:
            self._harvest_one()

    def run(self, requests: Sequence[Request] = ()) -> list[Request]:
        for r in requests:
            self.submit(r)
        while self.queue or any(s is not None for s in self.slots):
            self.step()
        self.drain()
        return self.finished
