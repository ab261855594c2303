"""Span tracer, the port's copy of dtdl_tpu/obs/trace.py: host-side
phase timing as Chrome trace events.

Between log boundaries the loops only enqueue work on the card, so wall
clock no longer says where host time goes.  ``span("data")`` /
``span("dispatch")`` / ``span("drain")`` (the scheduler adds ``admit``,
``prefill``, ``draft``, ``verify`` and ``harvest``; the Router ``route``)
record complete ('X') events on the calling thread; the resil, serve and
fleet layers mark their edges as zero-duration :meth:`Tracer.instant`
events through ``Observer.event``.  Everything is thread-safe (replica
workers, the Router's pump and the scrape thread share one tracer) and
exports as Chrome-trace JSON that Perfetto and ``chrome://tracing`` load,
the format ``torch.profiler`` writes too, so :func:`profiler_events`
parses either.

Two rules, the JAX package's:

* a span measures **host phases only**: entering or leaving one never
  touches the card, and a span's args are host ints and floats, never a
  tensor, so tracing adds no synchronization;
* device time appears only as **window-settled** spans
  (:meth:`Tracer.device_window`): after a drain settles a log window its
  wall time goes on a synthetic "device" track, one span per window.

While a ``torch.profiler`` capture is active each span also opens a
``torch.profiler.record_function`` of its name, so host phases line up
with the card's kernels in one view (JAX opens a ``TraceAnnotation``
under ``jax.profiler`` the same way).

**Request correlation.**  Every request-scoped event carries ``rid`` (the
USER request id, stable across attempts), ``arid`` (the replica-local
attempt id) and on dispatch a ``lineage`` (``primary`` / ``retry:N`` /
``requeue`` / ``hedge``); :meth:`Tracer.flow` adds flow events (``ph``
s/t/f sharing ``id=rid``) and :meth:`Tracer.request_timeline` rebuilds one
request's story across threads.

:data:`SPAN_CATALOG` and :data:`EVENT_CATALOG` are JAX's sets: every name
emitted anywhere in dtdl_tpu_torch is in them (tests/test_torch_obs_export.py
audits the tree).
"""

from __future__ import annotations

import contextlib
import gzip
import json
import os
import threading
import time

import torch

# synthetic track ids inside the exported trace: host spans carry the
# real thread id; settled device windows live on their own track
DEVICE_TID = 1

# ---------------------------------------------------------------------------
# the span/event catalog: every name emitted through Observer.span /
# Observer.event / Tracer.instant anywhere in dtdl_tpu_torch/.  JAX's sets
# (names of emitters not ported yet included); audited against the tree
# by tests/test_torch_obs_export.py.
# ---------------------------------------------------------------------------

SPAN_CATALOG = frozenset({
    # training loops
    "data", "dispatch", "drain",
    # serve scheduler: admission, drafting, the k-wide verify
    # dispatch, the lag harvest, and the per-admission prefill call
    "admit", "draft", "verify", "harvest", "prefill",
    # fleet router
    "route",
})

EVENT_CATALOG = frozenset({
    # resil: the step guard and the Trainer's preemption and rollback
    "guard_bad_step", "guard_rollback", "trainer_preempted",
    "trainer_rollback",
    # serve scheduler containment + lifecycle
    "request_expired", "request_cancelled", "engine_failure",
    "scheduler_shutdown", "page_pool_shed",
    # fleet health/lifecycle edges; replica_* names are emitted as
    # f"replica_{state}" over the health-machine states
    "replica_suspect", "replica_evicted", "replica_draining",
    "replica_healthy", "replica_restarted", "replica_drain_timeout",
    "request_retry", "request_hedged", "hedge_won", "router_shutdown",
    "router_drain_timeout", "router_pump_error",
    # request-correlated lifecycle: intake → dispatch →
    # admit → first token → terminal, every one carrying rid/arid
    "request_submitted", "request_dispatched", "request_admitted",
    "request_first_token", "request_finished", "request_done",
    # SLO layer
    "slo_breach", "slo_recovered", "slo_burn_rate",
    # chunked prefill / disaggregation: the page-granular
    # KV migration (side=extract on the prefill replica, side=inject
    # on the decode one) and the Router's stage transition between them
    "kv_handoff", "request_migrated",
    # elastic training plane: peer detection, world
    # re-formation, shrink-to-survivors restore, generation fencing —
    # every abort/fence/shed on the failure path surfaces here, never
    # as a silent hang
    "elastic_peer_lost", "elastic_rendezvous", "elastic_restore",
    "elastic_snapshot", "elastic_stale_fenced", "elastic_step_timeout",
    # TCP control-plane store: every socket-level recovery
    # edge of the coordinator protocol — a reconnect after a dead
    # socket, a torn reply frame detected by name, an amnesiac
    # coordinator refused by epoch, and a WAL rehydration on the
    # server side
    "store_reconnect", "store_torn_frame", "store_epoch_refused",
    "store_wal_recovered",
    # multi-tenant serving: LoRA adapter-bank residency
    # edges, grammar-constraint outcomes (reason=illegal is a contained
    # failure, reason=incomplete a budget truncation mid-structure),
    # and incremental TokenStream deliveries at harvest boundaries
    "adapter_loaded", "adapter_evicted", "grammar_violation",
    "stream_delivery",
    # hierarchical KV cache: a batch of evicted pages
    # spilled to the host/disk tiers, a prefix-miss served back out of
    # them, and the fleet prefix directory's routing/consistency edges
    # (a hit = affinity beat least-loaded; an invalidation = a replica
    # eviction/drain/containment delisted its advertised pages)
    "page_spilled", "page_restored", "prefix_directory_hit",
    "prefix_directory_invalidated",
})


# ---------------------------------------------------------------------------
# correlation ids: rids are prefixed with a process tag so
# multi-host traces (and elastic-training events from many workers)
# merge into one Perfetto view without id collisions — process A's
# request 7 ("p0/7") can never chain into process B's ("p1/7").
# ---------------------------------------------------------------------------

_PROC_TAG: str | None = None


def proc_tag() -> str:
    """This process's correlation-id prefix: ``DTDL_PROC_TAG`` when set
    (a router/launcher naming its workers), else ``p{process_index}`` of
    the port's runtime.  Cached on first use; override early via
    :func:`set_proc_tag`."""
    global _PROC_TAG
    if _PROC_TAG is None:
        tag = os.environ.get("DTDL_PROC_TAG")
        if not tag:
            from dtdl_tpu_torch.runtime.bootstrap import process_index
            tag = f"p{process_index()}"
        _PROC_TAG = tag
    return _PROC_TAG


def set_proc_tag(tag: str | None) -> None:
    """Set (or with None, reset) the process tag — call before any
    correlated event is emitted; changing it mid-trace splits chains."""
    global _PROC_TAG
    _PROC_TAG = tag


def corr_rid(n) -> str:
    """The wire form of a correlation id: ``f"{proc_tag}/{n}"``.  Every
    emitter of a ``rid``/``arid`` arg or a request-flow id goes through
    here; already-prefixed strings pass through unchanged (the Router
    stamps attempt clones whose user rid was prefixed at intake)."""
    return n if isinstance(n, str) else f"{proc_tag()}/{n}"


class _Span:
    """One open span; records the 'X' event on exit."""

    __slots__ = ("tracer", "name", "args", "t0", "_ann")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self.tracer = tracer
        self.name = name
        self.args = args
        self._ann = None

    def __enter__(self):
        # a record_function only inside an active torch.profiler capture
        if torch.autograd._profiler_enabled():
            self._ann = torch.profiler.record_function(self.name)
            self._ann.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self._ann is not None:
            self._ann.__exit__(*exc)
        self.tracer._record(self.name, self.t0, t1 - self.t0,
                            threading.get_ident(), self.args)
        return False


class Tracer:
    """Thread-safe span recorder with Chrome-trace-event export.

    ``max_events`` bounds memory: the buffer is a ring in spirit — once
    full, new events are dropped and ``dropped`` counts them (a trace
    that silently ate the heap would violate the observability budget
    it exists to enforce).
    """

    def __init__(self, max_events: int = 200_000):
        self.max_events = max_events
        self.dropped = 0
        self._events: list[dict] = []
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self._meta: dict = {"pid": os.getpid()}

    # ---- recording ----------------------------------------------------

    def span(self, name: str, **args) -> _Span:
        """Context manager timing one host phase on the calling thread."""
        return _Span(self, name, args)

    def instant(self, name: str, **args) -> None:
        """A zero-duration marker event."""
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            self._events.append({
                "name": name, "ph": "i", "s": "t",
                "ts": (time.perf_counter() - self._t0) * 1e6,
                "pid": self._meta["pid"],
                "tid": threading.get_ident(),
                **({"args": args} if args else {})})

    def counter(self, name: str, value: float) -> None:
        """A counter sample (Perfetto renders these as a line track)."""
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            self._events.append({
                "name": name, "ph": "C",
                "ts": (time.perf_counter() - self._t0) * 1e6,
                "pid": self._meta["pid"], "tid": 0,
                "args": {"value": value}})

    _FLOW_PH = {"start": "s", "step": "t", "end": "f"}

    def flow(self, name: str, fid, phase: str = "step",
             **args) -> None:
        """A Chrome-trace flow event: ``phase`` is ``start`` / ``step``
        / ``end`` and every event sharing (``name``, ``fid``) is joined
        into one arrow chain across threads — the Perfetto rendering of
        a request's path through router intake, dispatch, and each
        attempt's replica thread.  ``fid`` is the correlation id (the
        fleet uses the USER request rid in its proc-tagged
        :func:`corr_rid` wire form)."""
        ph = self._FLOW_PH.get(phase)
        if ph is None:
            raise ValueError(f"flow phase must be one of "
                             f"{sorted(self._FLOW_PH)}, got {phase!r}")
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            ev = {"name": name, "cat": "request", "ph": ph, "id": fid,
                  "ts": (time.perf_counter() - self._t0) * 1e6,
                  "pid": self._meta["pid"],
                  "tid": threading.get_ident()}
            if ph == "f":
                ev["bp"] = "e"     # bind the arrowhead to the enclosing
            if args:               # slice's end, the Perfetto convention
                ev["args"] = args
            self._events.append(ev)

    def request_timeline(self, rid) -> list[dict]:
        """Every recorded event correlated with USER request ``rid``,
        ordered by timestamp — the programmatic reconstruction of one
        request's story across threads, attempts, and failovers.

        An event correlates when its args carry ``rid == rid`` (the
        emitters thread the user rid through attempt clones, so a
        retried/hedged request's sibling attempts all land here, each
        distinguished by its ``arid``/``lineage`` args) or when it is a
        flow event with ``id == rid``.  Accepts either the wire form
        (``"p0/7"``) or a bare local request id, normalized through
        :func:`corr_rid` — emitters always record the prefixed form."""
        rid = corr_rid(rid)
        with self._lock:
            events = list(self._events)
        out = [e for e in events
               if e.get("args", {}).get("rid") == rid
               or (e.get("cat") == "request" and e.get("id") == rid)]
        out.sort(key=lambda e: e["ts"])
        return out

    def device_window(self, name: str, seconds: float, steps: int = 1,
                      **args) -> None:
        """Record a window-settled device span ending *now*.

        Called right after a boundary drain/sync: the window's wall time
        is attributed to the synthetic device track, one span per
        window (NOT per step — per-step device times do not exist
        without per-step syncs, and we refuse to add those).
        """
        t1 = time.perf_counter()
        self._record(name, t1 - seconds, seconds, DEVICE_TID,
                     {"steps": steps, **args})

    def _record(self, name: str, t0: float, dur: float, tid: int,
                args: dict) -> None:
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            ev = {"name": name, "ph": "X",
                  "ts": (t0 - self._t0) * 1e6, "dur": dur * 1e6,
                  "pid": self._meta["pid"], "tid": tid}
            if args:
                ev["args"] = args
            self._events.append(ev)

    # ---- export -------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def to_chrome(self) -> dict:
        """The Chrome trace-event JSON object (Perfetto-loadable)."""
        with self._lock:
            events = list(self._events)
        meta = [{"name": "thread_name", "ph": "M", "pid": self._meta["pid"],
                 "tid": DEVICE_TID,
                 "args": {"name": "device (window-settled)"}}]
        return {"traceEvents": meta + events, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def save(self, path: str) -> str:
        """Write the trace to ``path`` (gzipped when it ends in .gz)."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "wt") as f:
            json.dump(self.to_chrome(), f)
        return path


# ---------------------------------------------------------------------------
# torch.profiler trace parsing
# ---------------------------------------------------------------------------

def profiler_events(trace_dir: str) -> list:
    """The card's kernel events of the newest ``torch.profiler`` Chrome
    trace under ``trace_dir`` (``*.json`` or ``*.json.gz``, searched
    recursively): the counterpart of JAX's ``xla_events``, with the same
    shape of result, a list of complete ('X') events that :func:`aggregate`
    groups.  Without device activity (a CPU capture) it returns the CPU
    operator events instead."""
    import glob
    paths = (glob.glob(os.path.join(trace_dir, "**", "*.json"),
                       recursive=True)
             + glob.glob(os.path.join(trace_dir, "**", "*.json.gz"),
                         recursive=True))
    if not paths:
        raise FileNotFoundError(f"no torch.profiler trace under "
                                f"{trace_dir!r}")
    path = max(paths, key=os.path.getmtime)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        trace = json.load(f)
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    return kernels or [e for e in events if e.get("cat") == "cpu_op"]


def aggregate(events, key_fn):
    """Sum durations/calls/bytes of ``events`` grouped by ``key_fn``.

    Returns (groups, total_s): groups maps key -> [dur_s, calls,
    hlo_category, bytes_accessed], sorted by descending time.
    """
    import collections
    groups = collections.defaultdict(lambda: [0.0, 0, "", 0.0])
    total = 0.0
    for e in events:
        dur = e.get("dur", 0) / 1e6          # us -> s
        total += dur
        args = e.get("args", {})
        rec = groups[key_fn(e, args)]
        rec[0] += dur
        rec[1] += 1
        rec[2] = args.get("hlo_category", rec[2])
        try:
            rec[3] += float(args.get("bytes_accessed", 0) or 0)
        except (TypeError, ValueError):
            pass
    ordered = dict(sorted(groups.items(), key=lambda kv: -kv[1][0]))
    return ordered, total


_NULL_CTX = contextlib.nullcontext()


class NullTracer:
    """Disabled tracer: every operation is a near-zero no-op (a shared
    nullcontext for spans), so call sites never branch on 'is tracing
    on' themselves."""

    dropped = 0

    def span(self, name: str, **args):
        return _NULL_CTX

    def instant(self, name: str, **args) -> None:
        pass

    def counter(self, name: str, value: float) -> None:
        pass

    def flow(self, name: str, fid: int, phase: str = "step",
             **args) -> None:
        pass

    def request_timeline(self, rid: int) -> list:
        return []

    def device_window(self, name: str, seconds: float, steps: int = 1,
                      **args) -> None:
        pass

    def __len__(self) -> int:
        return 0

    def to_chrome(self) -> dict:
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    def save(self, path: str) -> str:
        raise ValueError("tracing is disabled; nothing to save")


NULL_TRACER = NullTracer()
