"""Slot-based continuous batcher over the InferenceEngine, the port of
dtdl_tpu/serve/scheduler.py (its continuous-batching core, speculative
decoding, chunked prefill, containment, prefill/decode disaggregation,
the KV spill tiers and tenancy).

A request is admitted into the first free slot (one bucketed prefill of
its uncached suffix), decodes in lockstep with whatever else is in
flight, and retires the moment its budget is exhausted, freeing the row
for the next queued request mid-flight.

On a paged engine admission is gated on free pages: the scheduler owns
the host-side :class:`~dtdl_tpu_torch.serve.paged.PageAllocator`, maps the
longest cached prompt prefix read-only, prefills only the suffix, and
waits in FIFO order when the pool cannot map a prompt yet.  Decode growth
allocates pages from worst-case host arithmetic (``pos_hi``), so the
fresh table rides into the next step as data; a slot the pool cannot grow
is shed with the named :class:`PagePoolExhaustedError` message.  A dense
engine (``page_size=0``) gives every slot its own max_seq row, and none of
that applies.

Dispatch never reads what it just dispatched.  The sampled tokens stay on
the card as the next step's input; each step's token vector starts a
non-blocking copy into pinned host memory with a CUDA event behind it,
and the host reads it ``harvest_lag`` steps later, when the event has long
fired.  EOS is therefore seen up to ``harvest_lag`` steps late; the
garbage tokens past it are trimmed at harvest.

A request with ``speculate=k > 0`` gets per-step drafts from the
scheduler's :class:`~dtdl_tpu_torch.serve.draft.DraftSource` (default
:class:`~dtdl_tpu_torch.serve.draft.NGramDraft`), drafted from the host
context it already has, and its steps become verify steps
(:meth:`InferenceEngine.verify`) that commit up to k+1 tokens each.  One
verify step serves the whole batch at a power-of-two width; plain
requests ride it with no drafts.  Each slot's draft length adapts to its
trailing acceptance, and its worst-case index ``pos_hi`` counts every
in-flight window, so page growth and the room check stay host
arithmetic.

**Chunked prefill** (``chunk_tokens=N``): a prompt is admitted without a
prefill (its pages mapped) and enters in per-step chunks of at most N
tokens in all, FIFO over the prefilling slots, riding the verify step as
``forced`` rows beside the decoding slots, so a long admission no longer
stalls every in-flight decode for a whole-prompt prefill.  The final
chunk's bonus token is the request's first token, and a paged prompt's
pages are published to the prefix cache only once that chunk is
dispatched.  Greedy tokens are those of whole-prompt prefill.

**Containment**: an exception from a step's dispatch fails the requests in
flight (``failed:``), re-initializes the arena and, for a paged engine,
the pages, and the queue is then served; ``cancel(rid)`` aborts one
request, ``shutdown(drain=)`` stops intake and drains or aborts what is
in flight.  Every terminal error is ``"<kind>: <reason>"`` with a kind of
:data:`~dtdl_tpu_torch.serve.metrics.ERROR_KINDS`.

**Disaggregation**: a ``prefill_only`` request finishes at its first
token with ``req.kv_handoff``, the host payload of its prompt's pages
(:meth:`InferenceEngine.extract_pages`, the one sync of the handoff); a
``kv_inject`` request adopts such a payload into fresh pages
(:meth:`InferenceEngine.inject_pages`) and decodes as if it had prefilled
here.  The fleet Router (:mod:`dtdl_tpu_torch.serve.fleet`) carries the
payload between replicas.

**The spill tiers** (``spill_host_bytes``, ``spill_dir``,
``spill_disk_bytes``): refcount-0 cached pages that the allocator evicts
are extracted in one batched sync to a host LRU
(:class:`~dtdl_tpu_torch.serve.paged.HostPageStore`), which demotes to an
mmap'd disk file (:class:`~dtdl_tpu_torch.serve.paged.DiskPageStore`); a
prefix miss at admission continues the chain walk into them and restores
the pages by inject instead of recomputing them.  A disk record that
fails its check is quarantined and recomputed.  ``kv_receipts`` tells the
Router's prefix directory what this scheduler holds.

On a tensor-parallel engine every rank runs its own Scheduler in
lockstep: the handoff's and the spill tiers' payloads are whole-heads
trees (the engine gathers the heads), so every rank holds the same
payloads and takes the same decisions, and each rank keeps its disk tier
in its own file (``kv_spill.rank<r>.bin`` in ``spill_dir``).

**Tenancy**: a request may name a LoRA ``adapter`` (a checkpoint path the
engine's :class:`~dtdl_tpu_torch.serve.tenant.lora.AdapterBank` hot-loads
at admission and releases at retirement; a full bank sheds the request,
a corrupt file fails it), carry a ``grammar`` (a
:class:`~dtdl_tpu_torch.serve.tenant.grammar.TokenDFA`: every sampled
token is masked to the automaton's legal set, advanced at harvest, and
a constrained slot dispatches only with nothing of its own in flight,
since its mask is a function of harvested truth; drafts are trimmed at
their first illegal token and the verify window's masks walk the DFA
along the draft), and a ``stream`` (a
:class:`~dtdl_tpu_torch.serve.tenant.stream.TokenStream` offered the
harvested tokens, closed at the request's terminal).  A request's prefix
pages are keyed by its adapter as well as its tokens
(:func:`~dtdl_tpu_torch.serve.paged.adapter_salt`), so no request maps
K/V that another adapter computed (ROADMAP C5).

**Observability**: ``observer=`` (:mod:`dtdl_tpu_torch.obs`) records JAX's
spans (``admit``, ``prefill``, ``draft``, ``verify``, ``dispatch``,
``harvest``, ``drain``), the request lifecycle (``request_admitted``,
``request_first_token``, ``request_finished``, with ``rid``/``arid`` and a
flow chain per user request), the containment, tier and tenancy events, at
JAX's points and from host truth only: an event's args are host ints and
floats, and the first-token event is emitted at the harvest, so nothing
waits for the card on its account.  ``exporter=`` (a
:class:`~dtdl_tpu_torch.obs.export.MetricsExporter`) takes this
scheduler's ``metrics.window`` as a source and is sampled at each step's
harvest boundary and at the drain.
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
from dtdl_tpu_torch.obs.observer import NULL_OBSERVER
from dtdl_tpu_torch.obs.trace import corr_rid
from dtdl_tpu_torch.runtime.bootstrap import process_index
from dtdl_tpu_torch.serve.draft import NGramDraft
from dtdl_tpu_torch.serve.engine import InferenceEngine, PromptTooLongError
from dtdl_tpu_torch.serve.metrics import ERROR_KINDS, ServeMetrics
from dtdl_tpu_torch.serve.paged import (GARBAGE_PAGE, DiskPageStore,
                                        HostPageStore, PageAllocator,
                                        PagePoolExhaustedError,
                                        concat_payloads, payload_nbytes,
                                        slice_payload)
from dtdl_tpu_torch.serve.sampling import GREEDY, SampleParams
from dtdl_tpu_torch.serve.tenant.lora import AdapterBankFullError

_ids = itertools.count()


def _spill_file(engine) -> str:
    """The disk tier's file name: ``kv_spill.bin``, or one per rank of a
    tensor-parallel world, so ranks that share ``spill_dir`` never open
    one file."""
    mesh = engine.mesh
    if mesh is None or mesh.group is None:
        return "kv_spill.bin"
    return f"kv_spill.rank{process_index()}.bin"


@dataclasses.dataclass
class Request:
    """One generation request plus its lifecycle record.

    ``tokens`` fills with the generated tokens (eos included, post-eos
    trimmed) as they harvest; ``done`` flips when the last one lands.
    ``error`` is set instead of raising when the scheduler rejects,
    expires, fails (containment), aborts (cancel, shutdown) or sheds the
    request, always starting with its kind (``rejected:``, ``expired:``,
    ``failed:``, ``aborted:``, ``shed:``).  ``deadline_s`` is a budget
    from this scheduler's submit, ``deadline_at`` an absolute
    ``time.perf_counter()`` instant.  ``speculate`` is the request's
    largest draft length (0: plain decode).

    ``origin_rid``/``lineage`` are stamped by the fleet Router on each
    replica-local attempt: the user request's rid and how the attempt
    came to be (``primary``, ``retry:N``, ``requeue``, ``hedge``,
    ``migrate``).  ``prefill_only`` asks for the prefill half only: the
    request finishes at its first token with ``kv_handoff`` set to the
    page payload that a decode replica's ``kv_inject`` admission adopts
    (both need a paged engine).  ``adapter`` names a LoRA checkpoint the
    engine's adapter bank hot-loads (None: the base weights); ``grammar``
    is a compiled ``TokenDFA`` constraining every emitted token (it needs
    ``eos_id``, the EOS it was compiled for); ``stream`` is a
    ``TokenStream`` delivering tokens as they harvest.
    """
    prompt: Sequence[int]
    max_new_tokens: int
    sampling: SampleParams = GREEDY
    eos_id: Optional[int] = None
    speculate: int = 0
    deadline_s: Optional[float] = None
    deadline_at: Optional[float] = None
    origin_rid: Optional[int] = None
    lineage: str = "primary"
    prefill_only: bool = False
    kv_inject: Optional[dict] = dataclasses.field(default=None, repr=False)
    kv_handoff: Optional[dict] = dataclasses.field(default=None, repr=False)
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
    # the grammar automaton's state over the harvested tokens
    _gq: int = dataclasses.field(default=0, repr=False)

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


class _SlotState:
    """Host-side tracking while a request occupies a slot.

    ``pos`` is the cache index as of the last harvested step (exact);
    ``inflight`` holds each dispatched-but-unharvested step's (draft
    length, kind), so ``pos_hi`` bounds the device index from above (every
    draft accepted) and ``gap_est`` is the expected number of output
    tokens the device is ahead of the harvested ones: drafting predicts
    across that gap afresh every step, so a wrong guess heals at the next
    harvest.  ``k_cur`` is the adaptive draft length (from 2 up to
    ``k_max``, the request's ``speculate``), steered by the acceptance EMA
    ``acc_ema``.

    ``fill_next``/``fill_end`` are the chunked-prefill cursor: while
    ``fill_next < fill_end`` the slot still takes its prompt in chunks
    (``fill_next``, the next prompt position to write, advances at
    dispatch and equals ``pos_hi``) and never decodes, drafts or emits;
    ``fill_toks`` is the prompt as one int32 array.  Whole-prompt
    admission leaves the two equal.  A step's kind is 0 (decode or
    verify), 1 (an intermediate chunk) or 2 (the final chunk).
    """

    __slots__ = ("rid", "pos", "k_max", "k_cur", "acc_ema", "inflight",
                 "fill_next", "fill_end", "fill_toks")

    def __init__(self, rid: int, pos: int, k_max: int = 0,
                 fill_end: Optional[int] = None):
        self.rid = rid
        self.pos = pos
        self.k_max = k_max
        # start at 2: the EMA doubles it under sustained acceptance and
        # halves it under poor acceptance, so a weak draft source costs
        # a few over-drafted steps before settling at 1
        self.k_cur = max(1, min(2, k_max))
        self.acc_ema = 1.0                  # optimistic until measured
        self.inflight: deque[tuple[int, int]] = deque()
        self.fill_next = pos
        self.fill_end = pos if fill_end is None else fill_end
        self.fill_toks = None

    @property
    def prefilling(self) -> bool:
        """Still taking prompt chunks: no decode, draft or output."""
        return self.fill_next < self.fill_end

    @property
    def pos_hi(self) -> int:
        """Worst-case (all-accepted) device index."""
        return self.pos + sum(dl + 1 for dl, _ in self.inflight)

    @property
    def gap_est(self) -> int:
        """Expected output tokens in flight: one per decode or verify
        step plus the acceptance-weighted drafts.  Prefill chunks advance
        the cache index, not the output: an intermediate chunk counts 0,
        the final one its bonus token."""
        a = min(1.0, max(0.0, self.acc_ema))
        out = 0
        for dl, kind in self.inflight:
            if kind == 1:
                continue
            out += 1 if kind == 2 else 1 + int(round(dl * a))
        return out

    def dispatched(self, draft_len: int = 0, kind: int = 0) -> None:
        self.inflight.append((draft_len, kind))

    def settle(self, draft_len: int, n_emitted: int) -> None:
        """One in-flight step harvested: the exact index, the acceptance
        EMA, and k halved under ~50% trailing acceptance or doubled (up to
        ``k_max``) above ~80%."""
        if self.inflight:
            self.inflight.popleft()
        self.pos += n_emitted
        if draft_len > 0:
            rate = (n_emitted - 1) / draft_len
            self.acc_ema = 0.5 * self.acc_ema + 0.5 * rate
            if self.acc_ema < 0.5:
                self.k_cur = max(1, self.k_cur // 2)
            elif self.acc_ema > 0.8:
                self.k_cur = min(max(1, self.k_cur * 2), self.k_max)


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
            # audit: ok[host-sync] the lag harvest waits for its own copy only
            self._event.synchronize()
        # audit: ok[host-sync-numpy] the pinned copy the event settled
        return self._host.numpy()


class Scheduler:
    """Continuous batcher (see module docstring).  ``submit`` enqueues or
    rejects; ``step`` runs one watchdog + admit + draft/chunk + decode or
    verify + harvest round; ``run`` drives until everything submitted has
    finished and returns the finished requests in completion order.
    ``draft`` is the draft source of requests with ``speculate > 0``; a
    draft model must share the served model's vocab.  ``chunk_tokens``
    turns on chunked prefill with that many prompt tokens per step.
    ``spill_host_bytes`` (and ``spill_dir`` with ``spill_disk_bytes``)
    put the spill tiers behind the prefix cache of a paged engine.
    ``metrics`` lets a caller keep one :class:`ServeMetrics` across
    schedulers (a fleet replica's restarts).  Used as a context manager it
    shuts down on exit: draining on a clean exit, aborting on an
    exception."""

    def __init__(self, engine: InferenceEngine, seed: int = 0,
                 harvest_lag: int = 4, max_queue: Optional[int] = None,
                 prefix_cache: bool = True, device=None, observer=None,
                 draft=None, exporter=None,
                 chunk_tokens: Optional[int] = None,
                 spill_host_bytes: Optional[int] = None,
                 spill_dir: Optional[str] = None,
                 spill_disk_bytes: Optional[int] = None,
                 metrics: Optional[ServeMetrics] = None):
        dev = resolve_device(device)
        if dev != engine.device:
            raise ValueError(f"the engine runs on {engine.device}, the "
                             f"scheduler was asked for {dev}")
        if harvest_lag < 0:
            raise ValueError(f"harvest_lag must be >= 0, got {harvest_lag}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if chunk_tokens is not None and chunk_tokens < 1:
            raise ValueError(f"chunk_tokens must be >= 1, got "
                             f"{chunk_tokens}")
        self.draft = draft if draft is not None else NGramDraft()
        draft_model = getattr(self.draft, "model", None)
        if draft_model is not None and \
                draft_model.cfg.vocab_size != engine.model.cfg.vocab_size:
            raise ValueError(
                f"draft model vocab ({draft_model.cfg.vocab_size}) must "
                f"match the served model's ({engine.model.cfg.vocab_size})")
        # the obs facade (spans, lifecycle events, the engine's sentinel);
        # the default NULL_OBSERVER no-ops every hook
        self.observer = observer or NULL_OBSERVER
        if observer is not None and engine.observer is None:
            engine.observer = observer
        if engine.adapter_bank is not None \
                and engine.adapter_bank.observer is None \
                and observer is not None:
            engine.adapter_bank.observer = observer
        # sampled at the boundaries this loop already settles at (a step's
        # harvest and the drain); the exporter throttles itself
        self.exporter = exporter
        self.engine = engine
        self.harvest_lag = harvest_lag
        self.max_queue = max_queue
        self.chunk_tokens = chunk_tokens
        self.arena = engine.init_arena()
        self.last_tokens = engine.init_last_tokens()
        self.queue: deque[Request] = deque()
        self.slots: list[Optional[Request]] = [None] * engine.n_slots
        self.metrics = metrics or ServeMetrics(n_slots=engine.n_slots)
        if exporter is not None:
            # this scheduler's window-delta feed; callers stack further
            # sources on the same exporter
            exporter.add_source("", self.metrics.window)
        self.finished: list[Request] = []
        self._reqs: dict[int, Request] = {}
        self._active = np.zeros(engine.n_slots, bool)
        self._state: list[Optional[_SlotState]] = [None] * engine.n_slots
        self._temp = np.zeros(engine.n_slots, np.float32)
        self._topk = np.zeros(engine.n_slots, np.int32)
        self._topp = np.ones(engine.n_slots, np.float32)
        # each slot's adapter-bank row (0: the base), the [B] ids every
        # step takes as data; acquired at admission, released at retirement
        self._aids = np.zeros(engine.n_slots, np.int32)
        self._gen = torch.Generator(device=dev).manual_seed(seed)
        # lag harvest: (tokens on their way to the host, the emitted counts
        # of a verify step or None, ((slot, rid, draft_len, kind), ...))
        self._pending: deque[tuple] = deque()
        self.step_count = 0
        self._deadlines_seen = False
        # containment: intake closed by shutdown, or paused while _contain
        # re-initializes the arena; the last contained error
        self._closed = False
        self._containing = False
        self.last_engine_error: Optional[str] = None
        # called (no args, host only) at each unit of progress inside a
        # step: after an admission's prefill or inject and after each
        # harvest.  The fleet's replica worker beats its watchdog here
        self.on_progress = None
        # paged arena: the host page allocator, the tables every step
        # takes as data, each slot's pages (released at retirement), and
        # the prefix hashes a chunked admission publishes at its final
        # chunk; a dense engine has none of these
        self.pages: Optional[PageAllocator] = None
        self._slot_hashes: list = [None] * engine.n_slots
        # the spill tiers behind the prefix cache, and the receipts the
        # fleet's prefix directory drains: ("add", hash) when a prefix page
        # is published in any tier, ("drop", hash) when the last tier
        # forgets it, ("reset", 0) on containment.  A receipt lost to the
        # deque's bound only makes the directory stale, which costs a
        # recompute, never a wrong token
        self.spill: Optional[HostPageStore] = None
        self.kv_receipts: deque = deque(maxlen=65536)
        if engine.paged:
            self.pages = PageAllocator(engine.n_pages, engine.page_size,
                                       prefix_cache=prefix_cache)
            self._ptab = np.full((engine.n_slots, engine.n_ptab),
                                 GARBAGE_PAGE, np.int32)
            self._slot_pages: list[list[int]] = [[] for _ in
                                                 range(engine.n_slots)]
            if spill_host_bytes is not None or spill_dir is not None:
                if not prefix_cache:
                    raise ValueError("spill tiers require "
                                     "prefix_cache=True (spilled pages "
                                     "are keyed by chain hash)")
                disk = (DiskPageStore(spill_dir, spill_disk_bytes,
                                      filename=_spill_file(engine))
                        if spill_dir is not None else None)
                self.spill = HostPageStore(
                    spill_host_bytes if spill_host_bytes is not None
                    else 0,
                    disk=disk,
                    on_drop=lambda h: self.kv_receipts.append(("drop", h)))
                self.pages.record_evictions = True
        elif spill_host_bytes is not None or spill_dir is not None:
            raise ValueError("spill_host_bytes/spill_dir require a paged "
                             "engine with prefix_cache=True")

    # ---- intake -------------------------------------------------------

    def _corr(self, req: Request) -> dict:
        """Trace-correlation args of a request-scoped event: ``rid`` the
        USER request id (the Router's ``origin_rid`` on an attempt; a
        standalone request is its own origin), ``arid`` this attempt's,
        both in the :func:`~dtdl_tpu_torch.obs.trace.corr_rid` wire form."""
        rid = req.origin_rid if req.origin_rid is not None else req.rid
        return {"rid": corr_rid(rid), "arid": corr_rid(req.rid)}

    def _finish_error(self, req: Request, reason: str, metric_hook,
                      kind: str) -> Request:
        assert kind in ERROR_KINDS, kind
        req.error = f"{kind}: {reason}"
        req.done = True
        req.t_done = time.perf_counter()
        self.finished.append(req)
        self._stream_terminal(req)
        metric_hook(req)
        if req.origin_rid is None and req.admit_step >= 0:
            # a standalone request that was admitted started a flow at its
            # admission: close it (a fleet attempt's chain is the Router's)
            self.observer.flow("req", corr_rid(req.rid), "end")
        return req

    def _reject(self, req: Request, reason: str) -> Request:
        self._reqs[req.rid] = req
        return self._finish_error(req, reason, self.metrics.on_reject,
                                  "rejected")

    def _stream_terminal(self, req: Request) -> None:
        """Close out a streaming request's TokenStream at its terminal: a
        standalone request (``origin_rid`` None) owns the user's stream,
        so success delivers any suffix not offered yet and closes it, an
        error closes it undelivered.  A fleet attempt only releases its
        claim, and only on an error, so a retry or hedge can take over;
        the Router closes the user's stream."""
        if req.stream is None:
            return
        if req.origin_rid is None:
            req.stream.finish(req.tokens, req.error)
        elif req.error is not None:
            req.stream.drop(req.rid)

    def _acquire_adapter(self, req: Request) -> Optional[int]:
        """Pin ``req``'s adapter in the engine's bank at admission (a cold
        one loads through the manifest-checked checkpoint path).  Returns
        the bank row (0: the base weights), or None after finishing the
        request: a bank with every row pinned sheds it with the
        :class:`AdapterBankFullError` message, a corrupt or unreadable
        adapter fails it."""
        if req.adapter is None:
            return 0
        try:
            return self.engine.adapter_bank.acquire(req.adapter)
        except AdapterBankFullError as e:
            self.queue.remove(req)
            self._finish_error(req, str(e), self.metrics.on_shed, "shed")
        except Exception as e:
            self.queue.remove(req)
            self._finish_error(
                req, f"adapter {req.adapter!r} failed to load: {e}",
                self.metrics.on_failure, "failed")
        return None

    def _release_adapter(self, aid: int) -> None:
        if aid:
            self.engine.adapter_bank.release(aid)

    def release_adapters(self) -> None:
        """Release every slot's adapter row without retiring the slots:
        the fleet abandons a dead worker's scheduler this way, so its
        pinned rows do not fill a shared bank."""
        for slot in range(self.engine.n_slots):
            self._release_adapter(int(self._aids[slot]))
            self._aids[slot] = 0

    def submit(self, req: Request) -> Request:
        """Enqueue ``req``; one the scheduler cannot serve comes back
        rejected (``req.error`` set, ``req.done`` True): a shut-down
        scheduler or one in containment, a full admission queue, a prompt
        past the largest prefill bucket, a prompt whose pages exceed the
        whole pool, a disaggregation half on a dense engine, a
        ``kv_inject`` payload that does not fit the prompt, an adapter
        without a bank, or a grammar without its EOS or of another
        vocabulary."""
        prompt_len = len(req.prompt)
        if prompt_len < 1:
            raise ValueError("empty prompt")
        req.t_submit = time.perf_counter()
        if self._closed:
            return self._reject(req, "scheduler is shut down")
        if self._containing:
            return self._reject(
                req, "engine containment in progress; retry shortly")
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            return self._reject(req, f"admission queue full ({self.max_queue}"
                                     f" waiting); retry later")
        if req.adapter is not None and self.engine.adapter_bank is None:
            return self._reject(
                req, "adapter requests need an engine built with an "
                     "adapter bank (lora_rank/lora_adapters)")
        if req.grammar is not None:
            # the automaton legalizes EOS only in accepting states, which
            # is how a constrained request stops on a complete structure
            if req.eos_id is None:
                return self._reject(
                    req, "grammar-constrained requests need eos_id (the "
                         "automaton legalizes EOS in accepting states)")
            if req.grammar.eos_id != req.eos_id:
                return self._reject(
                    req, f"grammar was compiled for eos_id="
                         f"{req.grammar.eos_id} but the request has "
                         f"eos_id={req.eos_id}")
            vocab = self.engine.model.cfg.vocab_size
            if req.grammar.allow.shape[1] != vocab:
                return self._reject(
                    req, f"grammar was compiled over a vocab of "
                         f"{req.grammar.allow.shape[1]} tokens; the "
                         f"engine serves {vocab}")
        if req.prefill_only and req.kv_inject is not None:
            raise ValueError("prefill_only and kv_inject are mutually "
                             "exclusive (one request is one half of a "
                             "disaggregated flight)")
        if (req.prefill_only or req.kv_inject is not None) \
                and self.pages is None:
            return self._reject(
                req, "prefill/decode disaggregation needs a paged "
                     "engine (page_size > 0): the KV handoff is "
                     "page-granular")
        if req.kv_inject is not None:
            # the decode half of a migrated flight runs no prefill, so the
            # bucket check does not apply: the payload must fit the prompt
            # and decoding must have room
            pg = self.engine.page_size
            n_pg = int(req.kv_inject.get("n_pages", 0))
            if n_pg != -(-prompt_len // pg):
                return self._reject(
                    req, f"kv_inject payload carries {n_pg} pages but "
                         f"the prompt needs {-(-prompt_len // pg)} "
                         f"(page_size={pg})")
            if prompt_len >= self.engine.max_seq:
                return self._reject(
                    req, f"adopted prompt of {prompt_len} tokens "
                         f"leaves no room to decode "
                         f"(max_seq={self.engine.max_seq})")
            need = (prompt_len + 1 + pg - 1) // pg
            if need > self.pages.capacity:
                return self._reject(
                    req, f"page pool exhausted: adopted prompt needs "
                         f"{need} pages (page_size={pg}) but the pool "
                         f"has only {self.pages.capacity}")
            return self._enqueue(req)
        try:
            self.engine.bucket_for(prompt_len)
        except PromptTooLongError as e:
            return self._reject(req, str(e))
        if self.pages is not None:
            pg = self.engine.page_size
            need = (prompt_len + 1 + pg - 1) // pg
            if need > self.pages.capacity:
                return self._reject(
                    req, f"page pool exhausted: prompt needs {need} pages "
                         f"(page_size={pg}) but the pool has only "
                         f"{self.pages.capacity}")
        return self._enqueue(req)

    def _enqueue(self, req: Request) -> Request:
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
        # the slot's claim on its bank row: at refcount 0 the row is
        # LRU-evictable, its weights resident for a warm re-acquire
        self._release_adapter(int(self._aids[slot]))
        self._aids[slot] = 0
        if self.pages is not None:
            # release the slot's pages (cached prefix pages become
            # evictable) and point the stale table row at the garbage page;
            # any step still in flight for it was dispatched with its own
            # table copy, and the stream orders it before whatever reuses
            # the pages
            for p in self._slot_pages[slot]:
                self.pages.release(p)
            self._slot_pages[slot] = []
            self._ptab[slot] = GARBAGE_PAGE
        # a request retired mid-chunked-prefill must not leave its deferred
        # prefix registration to the slot's next occupant
        self._slot_hashes[slot] = None

    def _expire(self):
        """Deadline watchdog: retire any request past its deadline, queued
        or in a slot, with ``req.error`` set.  Free until the first
        deadline-carrying request arrives."""
        if not self._deadlines_seen:
            return
        now = time.perf_counter()

        def expired(req):
            return req.deadline_at is not None and now >= req.deadline_at

        # by place in the queue and slot: a tensor-parallel engine's ranks
        # take the leader's clock's decision
        queued, slotted = self.engine.agree((
            [i for i, r in enumerate(self.queue) if expired(r)],
            [i for i, r in enumerate(self.slots)
             if r is not None and expired(r)]))
        for req in [self.queue[i] for i in queued]:
            self.queue.remove(req)
            self._finish_error(req, "deadline exceeded before admission",
                               self.metrics.on_expire, "expired")
            self.observer.event("request_expired", queued=1,
                                **self._corr(req))
        for slot in slotted:
            req = self.slots[slot]
            if req is not None:
                self._finish_error(
                    req, f"deadline exceeded after {len(req.tokens)} tokens",
                    self.metrics.on_expire, "expired")
                self.observer.event("request_expired", slot=slot,
                                    **self._corr(req))
                self._retire(slot)

    # ---- outstanding work, cancel, containment ----------------------

    @property
    def load(self) -> int:
        """Queued plus slot-occupying requests."""
        return len(self.queue) + sum(s is not None for s in self.slots)

    def pending_requests(self) -> list:
        """Every submitted request not finished yet: queued, slotted, or
        retired and waiting for the lag harvest."""
        return [r for r in self._reqs.values() if not r.done]

    def cancel(self, rid: int, reason: str = "cancelled") -> bool:
        """Cancel one request by id: a queued one leaves the queue, a
        slotted one retires (its pages come back); both finish
        ``aborted: cancelled ...`` and count under ``requests_aborted``.
        False when it is too late: unknown rid, already finished, or
        retired on its budget with its tokens still in the lag harvest
        (those are computed and will be delivered)."""
        req = self._reqs.get(rid)
        if req is None or req.done:
            return False
        if req in self.queue:
            self.queue.remove(req)
            self._finish_error(req, f"cancelled before admission: {reason}",
                               self.metrics.on_abort, "aborted")
            self.observer.event("request_cancelled", queued=1,
                                **self._corr(req))
            return True
        for slot, r in enumerate(self.slots):
            if r is req:
                self._finish_error(
                    req, f"cancelled after {len(req.tokens)} tokens: "
                         f"{reason}", self.metrics.on_abort, "aborted")
                self.observer.event("request_cancelled", slot=slot,
                                    **self._corr(req))
                self._retire(slot)
                return True
        return False

    def _contain(self, exc: BaseException):
        """A step raised: the arena may be half written, so everything in
        flight is condemned.  The windows harvested already come from
        steps that completed, so they are delivered first (a request that
        retired on its budget and only waited for the harvest finishes
        cleanly); then every slotted request, and every unsettled one
        from the lag, finishes ``failed:``, the arena and the last tokens
        are re-initialized and the pages reset.  The queue survives.  An
        error from the re-initialization itself (an unusable CUDA
        context) propagates."""
        self._containing = True
        try:
            self.last_engine_error = f"{type(exc).__name__}: {exc}"
            self.observer.event("engine_failure",
                                error=self.last_engine_error)
            reason = f"engine failure: {self.last_engine_error}"
            pending_rids = {rid for _, _, entries in self._pending
                            for _, rid, _, _ in entries}
            try:
                while self._pending:
                    self._harvest_one()
            except Exception:       # the device's results are unusable
                self._pending.clear()
            for slot, req in enumerate(self.slots):
                if req is None:
                    continue
                self._finish_error(req, reason, self.metrics.on_failure,
                                   "failed")
                self._retire(slot)
                self._state[slot] = None
            for rid in pending_rids:     # retired on budget, unharvested
                req = self._reqs[rid]
                if not req.done:
                    self._finish_error(req, reason, self.metrics.on_failure,
                                       "failed")
            self.arena = self.engine.init_arena()
            self.last_tokens = self.engine.init_last_tokens()
            if self.pages is not None:
                # the new arena holds none of the cached pages' contents
                self.pages.reset()
                self._ptab[:] = GARBAGE_PAGE
                self._slot_pages = [[] for _ in range(self.engine.n_slots)]
                # every page this replica advertised in the arena is gone
                # (spilled host and disk copies survive)
                self.kv_receipts.append(("reset", 0))
        finally:
            self._containing = False

    # ---- admission ----------------------------------------------------

    def _admit(self):
        if self._closed:
            return
        eng = self.engine
        chunked = self.chunk_tokens is not None
        for slot in range(eng.n_slots):
            if self.slots[slot] is not None or not self.queue:
                continue
            req = self.queue[0]
            if req.kv_inject is not None:
                # the decode half of a disaggregated flight adopts its
                # pages instead of prefilling
                if self._admit_inject(slot, req):
                    continue
                break                  # pool backpressure: FIFO waits
            aid = self._acquire_adapter(req)
            if aid is None:
                continue               # shed or failed, by name
            prompt = [int(t) for t in req.prompt]
            start, row, hits, fresh, hashes, restored = 0, None, [], [], [], []
            if self.pages is not None:
                pg = eng.page_size
                # keyed by the adapter too: its k/v deltas change the K/V
                hits = self.pages.match_prefix(prompt, req.adapter)
                hashes = (self.pages.page_hashes(prompt, req.adapter)
                          if self.pages.prefix_cache else [])
                if self.spill is not None:
                    # restore on miss: the chain walk goes on into the
                    # spill tiers; each payload found there is a page of
                    # prefill not recomputed
                    for i in range(len(hits), (len(prompt) - 1) // pg):
                        tier = self.spill.holds(hashes[i])
                        payload = (self.spill.get(hashes[i])
                                   if tier is not None else None)
                        if payload is None:
                            if tier == "disk":
                                # held by the manifest, failed its check:
                                # quarantined by the store, recomputed here
                                self.metrics.on_spill_quarantine(1)
                            break
                        restored.append((payload, tier))

                def resident() -> int:
                    # prompt pages already materialized in any tier
                    return len(hits) + len(restored)

                def drop_one() -> None:
                    # trailing resident pages go first: the restored ones
                    # (their payloads stay in the spill store)
                    (restored if restored else hits).pop()
                if chunked:
                    # chunks write exact positions (no padded bucket); the
                    # one rule is never to strand a 1-token final chunk at
                    # max_seq - 1 (a window there would clamp back over
                    # the cached pages)
                    while resident() and len(prompt) == eng.max_seq \
                            and len(prompt) - resident() * pg < 2:
                        drop_one()
                else:
                    # the suffix's padded bucket must fit max_seq too;
                    # dropping trailing resident pages grows the suffix
                    # until it does
                    while resident() and (resident() * pg
                                          + eng.bucket_for(len(prompt)
                                                           - resident() * pg)
                                          > eng.max_seq):
                        drop_one()
                start = resident() * pg
                n_prompt_pages = -(-len(prompt) // pg)
                need = n_prompt_pages - len(hits)
                # pinning an evictable (refcount-0) hit consumes a page too
                evictable = sum(1 for p in hits
                                if self.pages.refcount(p) == 0)
                if need + evictable > self.pages.available:
                    # FIFO backpressure: wait for pages, the adapter row
                    # unpinned meanwhile (re-acquired warm)
                    self._release_adapter(aid)
                    break
                for p in hits:         # pin BEFORE alloc can evict them
                    self.pages.acquire(p)
                fresh = [self.pages.alloc() for _ in range(need)]
                # the allocations may have evicted cached pages: extract
                # them before the inject or prefill below rewrites them
                self._spill_evicted()
                row = np.full(eng.n_ptab, GARBAGE_PAGE, np.int32)
                row[:len(hits)] = hits
                row[len(hits):n_prompt_pages] = fresh
            suffix = prompt[start:]
            self.queue.popleft()
            sp = req.sampling
            corr = self._corr(req)
            if restored:
                # the spilled payloads re-enter the arena by inject into
                # fresh[:n]; the suffix's prefill or chunks that follow
                # on the stream overwrite its index and last-token seeding
                t0 = time.perf_counter()
                payloads = [p for p, _ in restored]
                data = (payloads[0] if len(payloads) == 1
                        else concat_payloads(payloads))
                try:
                    self.arena, self.last_tokens = eng.inject_pages(
                        self.arena, self.last_tokens, data,
                        fresh[:len(restored)], slot, start, 0)
                except Exception as e:
                    self._contain(e)
                    self._finish_error(
                        req, f"engine failure: {self.last_engine_error}",
                        self.metrics.on_failure, "failed")
                    self._release_adapter(aid)   # not slotted yet
                    return
                nbytes = sum(payload_nbytes(p) for p in payloads)
                self.metrics.on_restore(
                    len(restored), nbytes, time.perf_counter() - t0,
                    host_hits=sum(1 for _, t in restored if t == "host"),
                    disk_hits=sum(1 for _, t in restored if t == "disk"))
                self.observer.event(
                    "page_restored", slot=slot, pages=len(restored),
                    nbytes=nbytes, cached=len(hits) * eng.page_size, **corr)
            if not chunked:
                # a blocking whole-prompt prefill: every decoding slot
                # waits for it
                self.metrics.on_prefill_block(int(self._active.sum()))
                # the prefill's sample is the first output token: it draws
                # under the grammar's start-state mask (the prompt never
                # advances the automaton)
                g0 = (req.grammar.mask(req.grammar.start)[None, :]
                      if req.grammar is not None else None)
                try:
                    with self.observer.span("prefill", slot=slot,
                                            suffix_len=len(suffix),
                                            cached=start, **corr):
                        self.arena, self.last_tokens, _ = eng.prefill(
                            self.arena, self.last_tokens, slot, suffix, sp,
                            self._gen, page_row=row, start=start,
                            adapter_id=(aid if eng.adapter_bank is not None
                                        else None),
                            allowed=g0)
                except Exception as e:
                    # this request is not slotted yet: _contain frees the
                    # pages it mapped with the pool reset
                    self._contain(e)
                    self._finish_error(
                        req, f"engine failure: {self.last_engine_error}",
                        self.metrics.on_failure, "failed")
                    self._release_adapter(aid)
                    return
                if self.on_progress is not None:
                    self.on_progress()
            if self.pages is not None:
                self._ptab[slot] = row
                self._slot_pages[slot] = list(hits) + list(fresh)
                n_res = len(restored)
                # restored pages are complete at the inject: publish them
                # back into the arena's cache whichever prefill follows
                for i in range(len(hits), len(hits) + n_res):
                    self._publish(hashes[i], int(row[i]))
                if chunked:
                    # published at the final chunk, once fully written
                    self._slot_hashes[slot] = (hashes, len(hits) + n_res)
                else:
                    # same tokens at the same positions give identical
                    # K/V, so first-writer-wins is sound
                    for i in range(len(hits) + n_res, len(hashes)):
                        self._publish(hashes[i], int(row[i]))
                # HBM hits and spill restores both skipped recompute
                self.metrics.on_prefix(len(hits) + n_res, len(hashes), start)
            self.slots[slot] = req
            self._active[slot] = True
            self._aids[slot] = aid
            if req.grammar is not None:
                req._gq = req.grammar.start
            st = _SlotState(req.rid, start if chunked else len(prompt),
                            req.speculate,
                            fill_end=len(prompt) if chunked else None)
            self._state[slot] = st
            self._temp[slot] = sp.temperature
            self._topk[slot] = sp.top_k
            self._topp[slot] = sp.top_p
            req.t_admit = time.perf_counter()
            req.admit_step = self.step_count
            # the admission marker on this worker's track, and the flow
            # arrow joining the attempt to its user request's chain (a
            # standalone request starts it here)
            self.observer.event("request_admitted", slot=slot,
                                step=self.step_count,
                                prompt_len=len(req.prompt),
                                cached=start, lineage=req.lineage, **corr)
            self.observer.flow(
                "req", corr["rid"],
                "step" if req.origin_rid is not None else "start")
            self.metrics.on_admit(req, slot, len(suffix))
            if chunked:
                # no token guaranteed yet: the first is the final chunk's
                st.fill_toks = np.asarray(prompt, np.int32)
                continue
            req._guaranteed = 1
            st.dispatched()
            self._pending.append((_HostTokens(self.last_tokens), None,
                                  ((slot, req.rid, 0, 0),)))
            if req._guaranteed >= self._budget(req):
                self._retire(slot)
            elif req.prefill_only:
                # a prefill-role slot parks (no decode step) until its
                # first token harvests and its pages are extracted
                self._active[slot] = False

    def _publish(self, h: int, page: int) -> None:
        """Register a fully written prompt page under its chain hash and
        tell the fleet's prefix directory."""
        self.pages.register(h, page)
        self.kv_receipts.append(("add", h))

    def _admit_inject(self, slot: int, req: Request) -> bool:
        """Admit a migrated (``kv_inject``) request: fresh pages, the
        extracted prompt K/V written into them, the slot's cache index and
        last token seeded; the slot then decodes as if this scheduler had
        prefilled it.  False when the pool cannot map the payload yet
        (FIFO backpressure, as for a prefill)."""
        payload = req.kv_inject
        n_pg = int(payload["n_pages"])
        if n_pg > self.pages.available:
            return False
        aid = self._acquire_adapter(req)
        if aid is None:
            return True            # finished with a named reason
        if req.grammar is not None:
            # the automaton catches up over the tokens the prefill half
            # delivered (the seeded first token)
            req._gq = req.grammar.walk(req.tokens)
            if req._gq < 0:
                self.queue.remove(req)
                self._finish_error(
                    req, "migrated tokens violate the request's grammar",
                    self.metrics.on_failure, "failed")
                self._release_adapter(aid)
                return True
        self.queue.popleft()
        fresh = [self.pages.alloc() for _ in range(n_pg)]
        # evictions of the allocations spill before the inject rewrites
        self._spill_evicted()
        row = np.full(self.engine.n_ptab, GARBAGE_PAGE, np.int32)
        row[:n_pg] = fresh
        corr = self._corr(req)
        t0 = time.perf_counter()
        try:
            with self.observer.span("prefill", slot=slot, suffix_len=0,
                                    cached=len(req.prompt), **corr):
                self.arena, self.last_tokens = self.engine.inject_pages(
                    self.arena, self.last_tokens, payload["data"], fresh,
                    slot, len(req.prompt), int(payload["first_token"]))
        except Exception as e:
            self._contain(e)
            self._finish_error(
                req, f"engine failure: {self.last_engine_error}",
                self.metrics.on_failure, "failed")
            self._release_adapter(aid)
            return True
        if self.on_progress is not None:
            self.on_progress()
        self._ptab[slot] = row
        self._slot_pages[slot] = list(fresh)
        # the migrated full prompt pages join this scheduler's prefix
        # cache (first writer wins, as at prefill)
        if self.pages.prefix_cache:
            prompt = [int(t) for t in req.prompt]
            for h, p in zip(self.pages.page_hashes(prompt, req.adapter),
                            fresh):
                self._publish(h, int(p))
        self.metrics.on_kv_handoff(n_pg, time.perf_counter() - t0)
        sp = req.sampling
        self.slots[slot] = req
        self._active[slot] = True
        self._aids[slot] = aid
        self._state[slot] = _SlotState(req.rid, len(req.prompt),
                                       req.speculate)
        self._temp[slot] = sp.temperature
        self._topk[slot] = sp.top_k
        self._topp[slot] = sp.top_p
        req.t_admit = time.perf_counter()
        req.admit_step = self.step_count
        self.observer.event("kv_handoff", side="inject", pages=n_pg, **corr)
        self.observer.event("request_admitted", slot=slot,
                            step=self.step_count,
                            prompt_len=len(req.prompt),
                            cached=len(req.prompt), lineage=req.lineage,
                            **corr)
        self.observer.flow(
            "req", corr["rid"],
            "step" if req.origin_rid is not None else "start")
        # the prefill half delivered the first token (seeded in req.tokens
        # by the Router); this slot owes the rest
        req._guaranteed = max(1, req._guaranteed)
        self.metrics.on_admit(req, slot, 0)
        if req._guaranteed >= self._budget(req):
            self._retire(slot)
        return True

    def _grow_pages(self, step_act, lens=None):
        """Map pages covering every stepped slot's worst-case write window
        ``[0, pos_hi + lens + 1)`` before dispatch (``lens`` the upcoming
        verify step's draft or chunk widths minus one, None for a decode
        step; host arithmetic, no device reads).  A slot the pool cannot
        grow, with nothing evictable, is shed with the named
        :class:`PagePoolExhaustedError` message."""
        pg = self.engine.page_size
        for slot, req in enumerate(self.slots):
            if req is None or not step_act[slot]:
                continue
            st = self._state[slot]
            width = 1 + (int(lens[slot]) if lens is not None else 0)
            # pos_hi runs one ahead of the engine index; clamp to the table
            # (an out-of-range write clamps into the slot's own last page)
            need = min(-(-(st.pos_hi + width) // pg), self.engine.n_ptab)
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
                self.observer.event("page_pool_shed", slot=slot,
                                    **self._corr(req))
                self._retire(slot)
        # growth may have evicted cached pages: spill them before the
        # caller's dispatch rewrites them
        self._spill_evicted()

    def _spill_evicted(self) -> None:
        """Drain the allocator's pending evictions into the spill store
        with one batched extract.  Runs after every allocation burst and
        before the next dispatch rewrites the evicted pages (the extract's
        sync puts the payloads on the host first).  Best effort: a failure
        drops the payloads (their prefixes are recomputed later) and never
        breaks an admission or a decode."""
        if self.spill is None or self.pages is None \
                or not self.pages.pending_spills:
            return
        evs = self.pages.pending_spills
        self.pages.pending_spills = []
        t0 = time.perf_counter()
        try:
            data = self.engine.extract_pages_batch(self.arena,
                                                   [p for _, p in evs])
        except Exception:
            return
        dt = time.perf_counter() - t0
        nbytes = 0
        for i, (h, _) in enumerate(evs):
            payload = slice_payload(data, i)
            nbytes += payload_nbytes(payload)
            self.spill.put(h, payload)
        self.metrics.on_spill(len(evs), nbytes, dt)
        self.observer.event("page_spilled", pages=len(evs), nbytes=nbytes,
                            host_pages=len(self.spill))

    # ---- drafting and chunk planning ---------------------------------

    def _spec_desires(self) -> dict[int, int]:
        """Each speculating decoding slot's draft length this step, clamped
        to its adaptive k, its budget and its room in the arena."""
        desires = {}
        for slot, req in enumerate(self.slots):
            if not self._active[slot] or not req.speculate:
                continue
            st = self._state[slot]
            if st.prefilling:
                continue
            room = self.engine.max_seq - 1 - st.pos_hi
            remaining = self._budget(req) - req._guaranteed
            des = min(st.k_cur, req.speculate, remaining - 1, room)
            if des > 0:
                desires[slot] = des
        return desires

    def _plan_chunks(self) -> dict[int, int]:
        """This step's prefill chunks ``{slot: width}`` under the per-step
        budget ``chunk_tokens``, FIFO over the prefilling slots.  A prompt
        that fills ``max_seq`` must never be left a 1-token final chunk (a
        window there would clamp back over its own written positions), so
        the chunk before it shrinks, or the final pair goes out together,
        one token over the budget."""
        if self.chunk_tokens is None:
            return {}
        max_seq = self.engine.max_seq
        plan = {}
        budget = self.chunk_tokens
        filling = [s for s in range(self.engine.n_slots)
                   if self._active[s] and self._state[s] is not None
                   and self._state[s].prefilling]
        for slot in sorted(filling, key=lambda s: self._state[s].rid):
            if budget < 1:
                break
            st = self._state[slot]
            remaining = st.fill_end - st.fill_next
            w = min(budget, remaining)
            if st.fill_end == max_seq and remaining - w == 1:
                w = remaining - 2 if remaining > 2 else 2
            plan[slot] = w
            budget -= w
        return plan

    def _draft(self, desires: dict, k_prog: int, drafts, lens) -> int:
        """Fill ``drafts``/``lens`` rows of the desiring slots, each from
        the slot's harvested context, skipping the ``gap_est`` tokens
        already in flight, a constrained slot's draft cut at its first
        token the grammar refuses; returns the number of tokens
        drafted."""
        t0 = time.perf_counter()
        n_drafted = 0
        for slot, des in desires.items():
            req, st = self.slots[slot], self._state[slot]
            want = min(des, k_prog)
            gap = st.gap_est
            ctx = np.asarray(list(req.prompt) + req.tokens, np.int32)
            pred = np.asarray(self.draft.propose(ctx, gap + want), np.int32)
            cand = pred[gap:gap + want]
            if req.grammar is not None:
                # trim at the first illegal token: the verify masks would
                # refuse everything from there on.  gap is 0 here (the
                # grammar gate dispatches with nothing in flight), so
                # ``req._gq`` is the state the draft continues from
                q, keep = req._gq, 0
                for t in cand:
                    q = req.grammar.step(q, int(t))
                    if q < 0:
                        break
                    keep += 1
                if keep < cand.size:
                    self.metrics.on_grammar_reject(int(cand.size) - keep)
                    cand = cand[:keep]
            drafts[slot, :cand.size] = cand
            lens[slot] = cand.size
            n_drafted += int(cand.size)
        self.metrics.on_draft(time.perf_counter() - t0)
        return n_drafted

    # ---- the decode round --------------------------------------------

    def step(self) -> int:
        """One watchdog + admit + draft/chunk + decode/verify round;
        returns how many slots were active.  An exception from the
        dispatch is contained to the in-flight batch (:meth:`_contain`)."""
        self._expire()
        with self.observer.span("admit"):
            self._admit()
        # overflow settling: a slot whose worst-case index leaves no room
        # for one more write waits for its in-flight steps to harvest
        # (only ever within the last k+1 positions of a sequence)
        while self._pending and any(
                self._state[s].pos_hi > self.engine.max_seq - 1
                for s in range(self.engine.n_slots) if self._active[s]):
            with self.observer.span("harvest", forced=1):
                self._harvest_one()
        n_active = int(self._active.sum())
        if n_active:
            try:
                self._dispatch_round(n_active)
            except Exception as e:
                self._contain(e)
        self.step_count += 1
        self.metrics.on_step(n_active, self.engine.n_slots)
        if self.pages is not None:
            self.metrics.on_pages(self.pages.pages_in_use,
                                  self.pages.capacity)
        if len(self._pending) > self.harvest_lag:
            with self.observer.span("harvest"):
                while len(self._pending) > self.harvest_lag:
                    self._harvest_one()
        elif not n_active and self._pending:
            with self.observer.span("harvest", idle=1):
                self._harvest_one()
        if self.exporter is not None:
            # harvest boundary: host counters the lag harvest settled; the
            # exporter's interval decides whether this becomes a point
            self.exporter.sample()
        return n_active

    def _dispatch_round(self, n_active: int):
        """Plan drafts and chunks, then one decode or verify step over the
        stepped slots: the decoding ones, plain or speculative, and the
        prefilling ones that drew a chunk, as ``forced`` rows."""
        B = self.engine.n_slots
        max_seq = self.engine.max_seq
        desires = self._spec_desires()
        chunk_plan = self._plan_chunks()
        # a prefilling slot steps only when it drew a chunk (its index
        # must not advance in a step it is not part of)
        step_act = self._active.copy()
        for slot in range(B):
            st = self._state[slot]
            if step_act[slot] and st.prefilling and slot not in chunk_plan:
                step_act[slot] = False
        # the grammar gate: a constrained slot dispatches only with nothing
        # of its own in flight, since its mask is a function of the
        # automaton's state over harvested truth.  Prompt chunks are
        # exempt; speculation wins back what the gate costs (one verify
        # step commits up to k+1 masked tokens)
        gated = False
        for slot in range(B):
            req, st = self.slots[slot], self._state[slot]
            if req is None or req.grammar is None or not step_act[slot] \
                    or st.prefilling:
                continue
            if st.inflight:
                step_act[slot] = False
                desires.pop(slot, None)
                gated = True
        if not step_act.any():
            if gated and self._pending:
                # settle the oldest window so the gated automata advance:
                # a lone constrained slot never reaches the lag threshold
                with self.observer.span("harvest", grammar=1):
                    self._harvest_one()
            return
        # the room bound covers every active slot, stepped or not: the
        # window of k+1 positions is written for every row (a dense row
        # at its own index), and a row's position is clamped to
        # max_seq - (k + 1), which would shift an overflowing window back
        # over committed K/V
        k_room = min(max_seq - 1 - self._state[s].pos_hi
                     for s in range(B) if self._active[s])
        if k_room < 1 and (desires or chunk_plan):
            # a slot has room for one more token only: no k >= 1 window
            # fits, so drafts wait and chunks sit this round out
            desires, chunk_plan = {}, {}
            for slot in range(B):
                if step_act[slot] and self._state[slot].prefilling:
                    step_act[slot] = False
            if not step_act.any():
                return
        k_need = max([0] + list(desires.values())
                     + [w - 1 for w in chunk_plan.values()]
                     + ([1] if chunk_plan else []))
        lens = None
        if k_need > 0:
            k_prog = 1
            while k_prog < k_need:
                k_prog *= 2
            while k_prog > k_room and k_prog > 1:
                k_prog //= 2
            # re-cap the chunks to the step's width
            for slot in list(chunk_plan):
                st = self._state[slot]
                w = min(chunk_plan[slot], k_prog + 1)
                if st.fill_end == max_seq and st.fill_end - st.fill_next \
                        - w == 1:
                    w -= 1          # never strand a 1-token final chunk
                if w < 1:
                    del chunk_plan[slot]
                    step_act[slot] = False
                else:
                    chunk_plan[slot] = w
            if not step_act.any():
                return
            drafts = np.zeros((B, k_prog), np.int32)
            lens = np.zeros(B, np.int32)
            forced = np.zeros(B, bool)
            first_tok = np.zeros(B, np.int32)
            pos_set = np.zeros(B, np.int32)
            with self.observer.span("draft", n_active=n_active):
                n_drafted = self._draft(desires, k_prog, drafts, lens)
            for slot, w in chunk_plan.items():
                st = self._state[slot]
                toks = st.fill_toks[st.fill_next:st.fill_next + w]
                first_tok[slot] = toks[0]
                drafts[slot, :w - 1] = toks[1:]
                lens[slot] = w - 1
                forced[slot] = True
                pos_set[slot] = st.fill_next
            if n_drafted == 0 and not chunk_plan:
                lens = None     # every draft came back empty: decode
        if self.pages is not None:
            self._grow_pages(step_act, lens)
            step_act &= self._active      # growth may have shed slots
            if not step_act.any():
                return
        tables = self._ptab if self.pages is not None else None
        if lens is not None:
            entries = []
            for slot in range(B):
                if not step_act[slot]:
                    continue
                rid = self.slots[slot].rid
                if slot in chunk_plan:
                    st = self._state[slot]
                    final = st.fill_next + chunk_plan[slot] == st.fill_end
                    # kind 1: an intermediate chunk (nothing delivered);
                    # kind 2: the final chunk (its bonus token is the
                    # request's first); the draft length rides as 0 so
                    # the harvest never counts prompt as speculation
                    entries.append((slot, rid, 0, 2 if final else 1))
                else:
                    entries.append((slot, rid, int(lens[slot]), 0))
            entries = tuple(entries)
            g_allowed = self._grammar_masks(step_act, chunk_plan, drafts,
                                            lens, k_prog)
            with self.observer.span("verify", n_active=n_active, k=k_prog):
                self.arena, self.last_tokens, window, counts = \
                    self.engine.verify(
                        self.arena, self.last_tokens, drafts, lens,
                        step_act, self._temp, self._topk, self._topp,
                        tables, generator=self._gen, forced=forced,
                        first_tok=first_tok, pos_set=pos_set,
                        adapter_ids=self._adapter_ids(), allowed=g_allowed)
            self._pending.append((_HostTokens(window), _HostTokens(counts),
                                  entries))
            if n_drafted:
                self.metrics.on_verify(k_prog)
            for slot, _, dl, kind in entries:
                st = self._state[slot]
                if kind == 0:
                    st.dispatched(dl)
                    continue
                w = chunk_plan[slot]
                st.dispatched(w - 1, kind)   # worst-case index += w
                st.fill_next += w
                self.metrics.on_chunk(w)
                if kind == 2 and self._slot_hashes[slot] is not None:
                    # the prompt is fully dispatched: publish its pages
                    # (one stream orders any later hit after these writes)
                    hashes, n_hits = self._slot_hashes[slot]
                    for i in range(n_hits, len(hashes)):
                        self._publish(hashes[i], int(self._ptab[slot, i]))
                    self._slot_hashes[slot] = None
        else:
            entries = tuple((slot, req.rid, 0, 0)
                            for slot, req in enumerate(self.slots)
                            if step_act[slot])
            g_rows = [s for s in range(B) if step_act[s]
                      and self.slots[s].grammar is not None]
            allowed = None
            if g_rows:
                allowed = np.ones((B, self.engine.model.cfg.vocab_size),
                                  bool)
                for s in g_rows:
                    r = self.slots[s]
                    allowed[s] = r.grammar.mask(r._gq)
            with self.observer.span("dispatch", n_active=n_active):
                self.arena, self.last_tokens, _ = self.engine.decode(
                    self.arena, self.last_tokens, step_act, self._temp,
                    self._topk, self._topp, tables, generator=self._gen,
                    adapter_ids=self._adapter_ids(), allowed=allowed)
            self._pending.append((_HostTokens(self.last_tokens), None,
                                  entries))
            for slot, _, _, _ in entries:
                self._state[slot].dispatched()
        for slot, _, _, kind in entries:
            if kind == 1:
                continue             # a chunk guarantees no token
            req = self.slots[slot]
            req._guaranteed += 1
            if req._guaranteed >= self._budget(req):
                self._retire(slot)
            elif kind == 2 and req.prefill_only:
                # a prefill-role slot parks until its first token
                # harvests and its pages are extracted
                self._active[slot] = False

    def _adapter_ids(self):
        """The slots' adapter rows for a step, None without a bank."""
        return self._aids if self.engine.adapter_bank is not None else None

    def _grammar_masks(self, step_act, chunk_plan, drafts, lens, k_prog):
        """Per-position allowed-token masks [B, k_prog + 1, V] for one
        verify step, or None when no stepped slot is constrained.  A
        decode or speculative row masks position 0 from the harvested
        state and position i + 1 from the state after draft token i (the
        drafts were trimmed legal); a chunk row constrains only the final
        chunk's bonus position (the first output token, the start
        state), prompt positions stay all-true."""
        B = self.engine.n_slots
        rows = [s for s in range(B) if step_act[s]
                and self.slots[s] is not None
                and self.slots[s].grammar is not None]
        if not rows:
            return None
        allowed = np.ones((B, k_prog + 1, self.engine.model.cfg.vocab_size),
                          bool)
        for slot in rows:
            req = self.slots[slot]
            dfa = req.grammar
            if slot in chunk_plan:
                st = self._state[slot]
                w = chunk_plan[slot]
                if st.fill_next + w == st.fill_end:
                    allowed[slot, w - 1] = dfa.mask(dfa.start)
                continue
            q = req._gq
            allowed[slot, 0] = dfa.mask(q)
            for i in range(int(lens[slot])):
                q = dfa.step(q, int(drafts[slot, i]))
                allowed[slot, i + 1] = dfa.mask(q)
        return allowed

    # ---- harvest ------------------------------------------------------

    def _harvest_one(self):
        window, counts, entries = self._pending.popleft()
        # audit: ok[host-sync-numpy] the lag harvest, the sanctioned read
        arr = window.numpy()       # waits only for this (lagged) copy
        # audit: ok[host-sync-numpy] the same harvest's accepted counts
        cnt = counts.numpy() if counts is not None else None
        now = time.perf_counter()
        for slot, rid, dl, kind in entries:
            req = self._reqs[rid]
            n_em = int(cnt[slot]) if cnt is not None else 1
            if kind == 1:
                toks = arr[slot, :0]         # prompt echo: nothing
            elif kind == 2:
                toks = arr[slot, n_em - 1:n_em]   # the bonus token only
            else:
                toks = (arr[slot, :n_em] if arr.ndim == 2
                        else arr[slot:slot + 1])
            st = self._state[slot]
            if st is not None and st.rid == rid:
                st.settle(dl, n_em)
            if dl:
                self.metrics.on_spec_harvest(dl, n_em - 1)
            if req.done:           # post-eos/budget garbage from the lag
                continue           # (or a verify step's overshoot)
            budget = self._budget(req)
            first_window = len(req.tokens) == 0
            delivered = 0
            for t in toks:
                req.tokens.append(int(t))
                delivered += 1
                if req.grammar is not None:
                    # the state every later dispatch masks from.  An
                    # illegal token here (the masks make it unreachable)
                    # fails the request and is never delivered
                    q = req.grammar.step(req._gq, int(t))
                    if q < 0:
                        req.tokens.pop()
                        delivered -= 1
                        self.observer.event(
                            "grammar_violation", token=int(t),
                            reason="illegal", **self._corr(req))
                        self._finish_error(
                            req, f"grammar violation: token {int(t)} is "
                                 f"illegal in automaton state {req._gq}",
                            self.metrics.on_failure, "failed")
                        break
                    req._gq = q
                if len(req.tokens) == 1:
                    req.t_first = now
                    self.metrics.on_first_token(req)
                    self.observer.event("request_first_token", slot=slot,
                                        **self._corr(req))
                hit_eos = req.eos_id is not None and int(t) == req.eos_id
                if hit_eos or len(req.tokens) >= budget:
                    req.done = True
                    req.t_done = now
                    self.finished.append(req)
                    self.metrics.on_finish(req)
                    corr = self._corr(req)
                    self.observer.event("request_finished",
                                        tokens=len(req.tokens),
                                        eos=int(hit_eos), **corr)
                    if req.grammar is not None \
                            and not req.grammar.accept[req._gq]:
                        # the budget ran out mid-structure: legal so far,
                        # not a complete utterance (a truncation)
                        self.observer.event("grammar_violation",
                                            reason="incomplete", **corr)
                    self.observer.flow(
                        "req", corr["rid"],
                        "step" if req.origin_rid is not None else "end")
                    break          # EOS mid-window trims exactly
            # every generated token counts once; the first is the prefill's
            self.metrics.on_harvest_tokens(
                delivered - (1 if first_window and delivered else 0))
            if delivered:
                self.metrics.on_adapter_tokens(req.adapter or "base",
                                               delivered)
                if req.stream is not None and req.error is None:
                    # the first offerer owns the stream (a hedge's loser
                    # delivers nothing); extensions are prefix-guarded
                    n = req.stream.offer(req.rid, req.tokens)
                    if n:
                        self.metrics.on_stream(n)
                        self.observer.event("stream_delivery", tokens=n,
                                            **self._corr(req))
            if req.prefill_only and not req.done and req.tokens:
                # the prefill half is done with generation still owed:
                # export the prompt's pages for the decode half
                self._handoff_out(slot, req)
            if req.done and req.error is None:
                # a standalone request's success closes its stream here,
                # with any suffix not offered yet
                self._stream_terminal(req)
            if req.done and self.slots[slot] is req:
                self._retire(slot)
        if self.on_progress is not None:
            self.on_progress()

    def _handoff_out(self, slot: int, req: Request):
        """Finish a ``prefill_only`` request by exporting its prompt's K/V
        pages to the host (the one deliberate sync of the handoff,
        ``kv_handoff_s``) into ``req.kv_handoff``, the payload a decode
        replica's ``kv_inject`` admission adopts.  The slot's pages are
        released only after the extract (the caller's retire), so an
        expiry mid-handoff cannot free them early."""
        pg = self.engine.page_size
        n_pg = -(-len(req.prompt) // pg)
        pages = self._slot_pages[slot][:n_pg]
        t0 = time.perf_counter()
        data = self.engine.extract_pages(self.arena, pages)
        self.metrics.on_kv_handoff(n_pg, time.perf_counter() - t0)
        req.kv_handoff = {
            "prompt": [int(t) for t in req.prompt],
            "first_token": int(req.tokens[0]),
            "n_pages": n_pg,
            "data": data,
            "t_first": req.t_first,
        }
        corr = self._corr(req)
        self.observer.event("kv_handoff", side="extract", pages=n_pg,
                            **corr)
        req.done = True
        req.t_done = time.perf_counter()
        self.finished.append(req)
        self.metrics.on_finish(req)
        self.observer.event("request_finished", tokens=len(req.tokens),
                            eos=0, **corr)
        self.observer.flow(
            "req", corr["rid"],
            "step" if req.origin_rid is not None else "end")

    def drain(self):
        """Harvest everything still in flight (the boundary sync)."""
        with self.observer.span("drain"):
            while self._pending:
                self._harvest_one()
        if self.exporter is not None:
            self.exporter.sample()

    # ---- shutdown -----------------------------------------------------

    def shutdown(self, drain: bool = True) -> None:
        """Stop the intake and wind down.  Queued requests finish
        ``aborted:`` either way.  ``drain=True`` runs the slotted ones to
        completion and settles every harvest; ``drain=False`` dispatches
        nothing more, settles the windows already computed, and aborts
        what is still slotted.  Idempotent; a later ``submit`` is
        rejected."""
        already = self._closed
        self._closed = True
        while self.queue:
            # on_abort, not on_reject: on_submit counted them already
            self._finish_error(self.queue.popleft(),
                               "scheduler shut down before admission",
                               self.metrics.on_abort, "aborted")
        if already:
            return
        self.observer.event("scheduler_shutdown", drain=int(drain))
        if drain:
            while any(s is not None for s in self.slots):
                self.step()
            self.drain()
            if self.exporter is not None:
                self.exporter.sample(force=True)   # the final point
            return
        self.drain()
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            self._finish_error(req, "scheduler shut down",
                               self.metrics.on_abort, "aborted")
            self._retire(slot)
        if self.exporter is not None:
            self.exporter.sample(force=True)

    def __enter__(self) -> "Scheduler":
        return self

    def __exit__(self, exc_type, *exc) -> bool:
        # a clean exit drains; an exception aborts (stepping a possibly
        # broken engine to drain would compound the failure)
        self.shutdown(drain=exc_type is None)
        return False

    def run(self, requests: Sequence[Request] = ()) -> list[Request]:
        for r in requests:
            self.submit(r)
        while self.queue or any(s is not None for s in self.slots):
            self.step()
        self.drain()
        return self.finished
