"""Serving fleet: a health-checked Router over N engine replicas, the port
of dtdl_tpu/serve/fleet.py.

One Scheduler+InferenceEngine pair in one thread is a single point of
failure: a wedged step or a poisoned arena is a full outage.  This module
turns N such pairs into one service that survives a sick replica:

* **admission + dispatch**: :meth:`Router.submit` feeds a bounded global
  queue (``rejected: router admission queue full`` past ``max_queue``) and
  a pump thread dispatches **least-loaded** over the replicas' occupancy
  (queued + slotted requests, host ints, never a device read).  A
  deadline becomes an absolute ``deadline_at`` at router intake, so time
  queued in front of a replica counts against it.
* **health + failure detection**: each replica runs under the
  :class:`~dtdl_tpu_torch.serve.health.ReplicaHealth` machine ``HEALTHY ->
  SUSPECT -> EVICTED -> DRAINING -> HEALTHY``, fed by passive signals
  (engine containments, failed attempts, a stale worker heartbeat past
  ``watchdog_s``, a dead worker thread) and periodic host-side probes.
  SUSPECT is the circuit breaker: dispatch stops at the first signal.
* **retry + hedging**: attempts lost to a containment or an eviction are
  re-dispatched under ``retry_budget``.  Greedy decoding is deterministic
  and every replica serves the same weights, so a retried request
  completes token-identical to an unfailed run, or carries a named
  ``failed: retry budget exhausted`` error.  ``hedge_after_s`` re-submits
  a straggler to a second replica; the first completion wins, the loser is
  cancelled, and delivery is exactly-once.
* **lifecycle**: :meth:`Router.drain_replica` / :meth:`Router.
  rolling_restart` take a replica through DRAINING and restart it while
  the rest serve; an EVICTED replica is refilled the same way.
* **disaggregation** (``roles``): 'prefill' replicas run only the prompt
  half of a flight (``prefill_only`` attempts, ending in a page payload),
  'decode' replicas only the generation half (``kv_inject`` attempts);
  'mixed' replicas serve whole flights.
* **the prefix directory**: on paged engines the Router learns which
  replica holds which chain-hashed prompt page (from the schedulers'
  ``kv_receipts``) and routes a warm prefix to its holder.

The router is host code only: threads, deques and health bits, never a
device value.  Replicas may share one :class:`InferenceEngine` (its
weights, each replica its own arena), the construction the tests and the
card's one-process fleet use, or bring one each.  Fault injection rides
:func:`dtdl_tpu_torch.resil.faults.replica_site`: per-replica ``engine``,
``loop`` and ``probe`` sites.

**Tensor-parallel replicas**: a replica's engine may be an
``InferenceEngine(mesh=)``, one process a rank.  Every process of the
world builds the same Router (the same arguments, ``None`` in place of a
replica it holds no rank of), as every rank builds the same engine.  The
Router's process is the first process of every tensor-parallel replica's
control group (``engine.control_ranks``) and the only home of a
single-placement replica: its Router is the front door (``submit``,
``run``, ``wait``, health, hedging, restarts, metrics).  On the other
ranks (``is_leader`` False) the Router runs no pump, probe or watchdog:
one thread replays its leader's records (:class:`ControlStream`), and
``run`` returns the same requests, each with the tokens of the
follower's own replay of the winning attempt (the leader's, when it ran
on a replica the follower holds no rank of).  The replicas on one set of
processes, whether they share one tensor-parallel engine or bring one
each, share one stream and take turns at their engines in the leader's
order: their collectives reach every process in one order, which two
NCCL communicators driven from two threads would not (two ranks that
enqueue them in different orders deadlock).  So engines whose processes
overlap in any but the Router's are refused.  A fleet of
single-placement engines has no stream and no turn, so this costs it
nothing.  A fault site fires on the leader and
its outcome reaches the followers (``engine`` through ``engine.agree``,
``loop`` as the record ``die``; ``probe`` is the leader's alone).  A
replica whose processes do not include the Router's would need a
transport between front end and replica, which the JAX package does not
have: the Router refuses it by name (ROADMAP A12c).  A dead follower
process is a failure of the world, as for any tensor-parallel engine.

On the card, failover is held for faults raised on the host (the
``FaultPlan`` sites), as in the JAX package: a CUDA error raised by a
kernel is sticky for the whole process, so the fleet does not catch device
errors and no replica is ever moved to the CPU.  The Router's warm-up
builds the kernels in the calling thread before any worker starts.

**Observability**: ``Router(observer=)`` reaches every replica's
scheduler, so all workers' spans and events land on one thread-safe
tracer: the intake (``request_submitted``), each dispatch, retry, hedge
and migration, the health edges (``replica_*``) and the one terminal
``request_done`` carry the user's ``rid`` (and an attempt's ``arid``), and
flow events join them into one chain per user request.  ``exporter=``
is sampled once per pump tick (it throttles itself) with the fleet's
window deltas; ``slos=`` (a list of :class:`~dtdl_tpu_torch.obs.slo.SLO`,
e.g. :func:`default_fleet_slos`, or a ready evaluator) judges every
sampled point, on a sink-less exporter the Router builds when none is
given.

**Heartbeats**: a worker beats at the top of each loop iteration and at
each unit of progress inside a step: after each admission's prefill and
after each harvest.  A working replica whose iteration holds several
eager prefills behind other threads' GIL turns therefore never reads as
wedged, while a frozen worker (a ``loop``-site stall, a hung call) stops
beating and is caught within ``watchdog_s``.

Tenant requests ride every attempt: the clones carry the user request's
``adapter``, ``grammar`` and ``stream``.  The stream is shared by the
attempts, and its ownership protocol keeps it prefix-stable: the first
attempt to offer owns it, an attempt that ends in error releases it, and
the Router closes it at the user request's terminal with the winning
attempt's tokens.  The prefix directory looks prompts up under the
adapter's salt, as the replicas' allocators publish them.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Optional, Sequence

from dtdl_tpu_torch.device import resolve_device
from dtdl_tpu_torch.models.transformer import set_block_beat
from dtdl_tpu_torch.obs.hist import LogHistogram
from dtdl_tpu_torch.obs.observer import NULL_OBSERVER
from dtdl_tpu_torch.obs.slo import SLO, SLOEvaluator
from dtdl_tpu_torch.obs.trace import corr_rid
from dtdl_tpu_torch.resil.faults import FaultPlan, InjectedFault, replica_site
from dtdl_tpu_torch.runtime.bootstrap import process_index
from dtdl_tpu_torch.serve.health import (DRAINING, EVICTED, HEALTHY, SUSPECT,
                                         ReplicaHealth)
from dtdl_tpu_torch.serve.metrics import (UNAVAILABLE_KINDS, ServeMetrics,
                                          _window_delta, error_kind)
from dtdl_tpu_torch.serve.paged import adapter_salt, page_chain_hashes
from dtdl_tpu_torch.serve.scheduler import Request, Scheduler

__all__ = ["ControlStream", "DRAINING", "EVICTED", "HEALTHY", "SUSPECT",
           "FleetMetrics", "PrefixDirectory", "Replica", "Router",
           "default_fleet_slos"]


class _FaultableEngine:
    """Replica-scoped fault shim over an engine: fires the replica's
    ``engine`` fault site before every prefill, decode and verify, so a
    FaultPlan can raise on exactly the k-th engine call of replica i.
    Everything else passes through to the wrapped engine.

    On a tensor-parallel engine the leader fires the site and every rank
    of the control group takes its outcome (``engine.agree``: none, or
    the :class:`InjectedFault` to raise) before the call, so a follower
    (``fire=False``) raises the same error at the same call and
    containment retires the same slots on every rank."""

    def __init__(self, engine, plan: FaultPlan, site: str,
                 fire: bool = True):
        object.__setattr__(self, "_engine", engine)
        object.__setattr__(self, "_plan", plan)
        object.__setattr__(self, "_site", site)
        object.__setattr__(self, "_fire_here", fire)

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def __setattr__(self, name, value):
        setattr(self._engine, name, value)

    def _fire(self) -> None:
        err = None
        if self._fire_here:
            try:
                self._plan.fire(self._site)
            except InjectedFault as e:
                err = e
        said = self._engine.agree(None if err is None else str(err))
        if err is None and said is not None:
            err = InjectedFault(said)
        if err is not None:
            raise err

    def prefill(self, *a, **kw):
        self._fire()
        return self._engine.prefill(*a, **kw)

    def decode(self, *a, **kw):
        self._fire()
        return self._engine.decode(*a, **kw)

    def verify(self, *a, **kw):
        self._fire()
        return self._engine.verify(*a, **kw)


def _sched_idle(sched: Scheduler) -> bool:
    return (not sched.queue and not sched._pending
            and all(x is None for x in sched.slots))


# the fields of a replica-local attempt that a record carries to the
# followers (its stream stays on the leader)
_WIRE_FIELDS = ("prompt", "max_new_tokens", "sampling", "eos_id",
                "speculate", "deadline_at", "origin_rid", "lineage",
                "prefill_only", "kv_inject", "adapter", "grammar", "rid",
                "tokens", "t_first")


def _wire(req: Request) -> dict:
    """An attempt as plain data, as the leader dispatched it."""
    return {k: (list(v) if k in ("prompt", "tokens") else v)
            for k, v in ((k, getattr(req, k)) for k in _WIRE_FIELDS)}


class _Turn:
    """A first-come first-served lock: the replicas that share one
    tensor-parallel engine take turns at it in the order they asked."""

    def __init__(self):
        self._cv = threading.Condition()
        self._next = 0
        self._serving = 0

    def acquire(self, beat=None) -> None:
        """Wait for this caller's turn; ``beat`` (a worker's heartbeat) is
        called while it waits: a replica queued behind another's long
        iteration is not wedged."""
        with self._cv:
            ticket = self._next
            self._next += 1
            while self._serving != ticket:
                if beat is not None:
                    beat()
                self._cv.wait(timeout=0.01)

    def release(self) -> None:
        with self._cv:
            self._serving += 1
            self._cv.notify_all()

    def __enter__(self) -> "_Turn":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def try_enter(self) -> bool:
        """Take the turn only if nobody holds or waits for it."""
        with self._cv:
            if self._serving != self._next:
                return False
            self._next += 1
            return True


# a follower's longest wait between two records: well inside a process
# group's timeout (gloo's default 30 min, 600 s in the card's worlds)
_KEEPALIVE_S = 30.0


class ControlStream:
    """The records of the tensor-parallel replicas on one set of
    processes (``engine.control_ranks``), in one order on every rank; it
    sends them on the first such engine's control group.

    The leader (the group's first process) sends one record a worker
    iteration, under the engine's :attr:`turn`, after the worker took its
    inbox and cancels and the ``loop`` site fired, and then runs the
    iteration; a follower receives the records in order on one thread and
    replays each on the replica it names: the same ``submit``, ``cancel``
    and ``step`` or ``drain``, so every engine call inside, the
    scheduler's own ``agree`` included, meets its leader's.  A record is
    ``{"replica", "gen", "action", "subs", "cancels", "outcomes"}``;
    actions: ``step``, ``drain``, ``none`` (an iteration), ``begin`` (a
    restarted generation's first record), ``die`` (the ``loop`` site
    killed the worker), ``stop`` (the Router's shutdown of the replica),
    ``idle`` (the pump's keep-alive, sent when the turn is free and
    :meth:`due`) and ``exit``.  The turn is every replica's on these
    processes, whatever engine it runs.  ``outcomes`` carry the users' terminal
    outcomes to the followers' :meth:`Router.run`.  ``log`` keeps
    ``(n, replica, generation, action)`` of every record, the same on
    every rank."""

    def __init__(self, group, ranks):
        self.group = group
        self.ranks = tuple(ranks)
        self.turn = _Turn()
        self.outbox: deque = deque()
        self.last_sent = time.perf_counter()
        self.n = 0
        # (replica, generation) of the record at the engine now
        self.at: Optional[tuple[int, int]] = None
        self.log: deque = deque(maxlen=65536)

    def due(self) -> bool:
        """Outcomes wait, or the followers have waited ``_KEEPALIVE_S``."""
        return (bool(self.outbox)
                or time.perf_counter() - self.last_sent > _KEEPALIVE_S)

    def send(self, replica: int, gen: int, action: str, subs=(),
             cancels=(), **extra) -> None:
        """Send one record (the leader, holding the turn)."""
        outcomes = []
        while self.outbox:
            outcomes.append(self.outbox.popleft())
        self._exchange({"replica": replica, "gen": gen, "action": action,
                        "subs": list(subs), "cancels": list(cancels),
                        "outcomes": outcomes, **extra})
        self.last_sent = time.perf_counter()

    def recv(self) -> dict:
        """The next record (a follower)."""
        return self._exchange(None)

    def _exchange(self, rec):
        import torch.distributed as dist
        box = [rec]
        dist.broadcast_object_list(box, src=self.ranks[0], group=self.group)
        rec = box[0]
        self.n += 1
        self.at = (rec["replica"], rec["gen"])
        self.log.append((self.n, rec["replica"], rec["gen"], rec["action"]))
        return rec


class Replica:
    """One thread-hosted Scheduler+InferenceEngine pair behind the Router.

    The worker thread (named ``serve-replica<idx>``) owns the scheduler;
    the only cross-thread surface is the inbox, cancel and completion
    deques under one condition variable, plus plain int peeks (``load``)
    for routing.  The worker heart-beats every iteration (``last_beat``),
    which the Router's watchdog and probes read; a ``loop``-site fault can
    kill (``raise``) or freeze (``stall``) it.  ``restart()`` fences the
    old worker by generation (a wedged thread is abandoned, a daemon that
    exits at its next fence check; its arena is freed when it does) and
    builds a fresh Scheduler on the same engine; the replica's cumulative
    :class:`ServeMetrics` survives the swap.

    A tensor-parallel replica has a :class:`ControlStream`.  On the
    leader the worker runs each iteration inside the stream's turn,
    sending its record first; the generation fence is checked again
    inside the turn.  A restart does not wait for a wedged worker: the
    turn orders the generations on the group instead.  A stale worker
    that stalled outside the turn exits at the fence without a record; one
    wedged inside it (a stalled engine call) finishes that iteration,
    which its followers replay on the old scheduler, before the new
    generation's ``begin`` record can be sent, and then exits at the
    fence.  So no collective of a fenced generation follows the first of
    the next.  The ``begin`` record drops the old scheduler on the
    followers (and its adapter rows, when the leader released them), as
    the leader dropped it.  A follower's replica (``follow=True``) has no
    thread: the Router's follower loop calls :meth:`replay`."""

    def __init__(self, idx: int, engine, sched_kwargs: dict | None = None,
                 plan: Optional[FaultPlan] = None, device=None,
                 idle_wait_s: float = 0.002, observer=None,
                 stream: Optional[ControlStream] = None,
                 follow: bool = False):
        self.idx = idx
        self.engine = engine
        self.plan = plan
        self.stream = stream
        self.follow = follow
        self.observer = observer or NULL_OBSERVER
        self.device = engine.device if device is None else device
        self.idle_wait_s = idle_wait_s
        self._sched_kwargs = dict(sched_kwargs or {})
        self.metrics = self._sched_kwargs.pop(
            "metrics", None) or ServeMetrics(n_slots=engine.n_slots)
        self._cv = threading.Condition()
        self._inbox: deque[Request] = deque()
        self._cancels: deque[tuple[int, str]] = deque()
        self.completions: deque[Request] = deque()
        self._on_complete = None          # Router wake hook
        self._gen = 0                     # restart fence
        # a restarted generation's begin record: (old scheduler, whether
        # its adapter rows go back to the bank)
        self._prev: Optional[tuple] = None
        self.dead_error: Optional[str] = None
        self.dead_at: Optional[float] = None
        self.last_beat = time.perf_counter()
        # the longest interval between two beats of a working worker (its
        # watchdog's margin, read by the twin's report)
        self.max_beat_gap_s = 0.0
        self.restarts = 0
        self.sched = self._make_sched()
        self._thread = None if follow else self._spawn()

    def _make_sched(self) -> Scheduler:
        engine = self.engine
        if self.plan is not None:
            engine = _FaultableEngine(
                engine, self.plan, replica_site(self.idx, "engine"),
                fire=not self.follow)
        kw = dict(self._sched_kwargs)
        if "observer" not in kw and self.observer is not NULL_OBSERVER:
            # the Router's observer reaches every replica: all workers'
            # spans and events land on one tracer, so request_timeline
            # joins a request's attempts across replica threads
            kw["observer"] = self.observer
        sched = Scheduler(engine, metrics=self.metrics, device=self.device,
                          **kw)
        sched._fleet_published = 0   # per-generation completion cursor
        # a beat at each unit of progress inside a step (see module doc)
        sched.on_progress = self._beat
        return sched

    def _beat(self) -> None:
        now = time.perf_counter()
        if now - self.last_beat > self.max_beat_gap_s:
            self.max_beat_gap_s = now - self.last_beat
        self.last_beat = now

    def _spawn(self) -> threading.Thread:
        t = threading.Thread(target=self._run, args=(self._gen,),
                             name=f"serve-replica{self.idx}", daemon=True)
        t.start()
        return t

    # ---- router-facing (any thread) ----------------------------------

    def submit(self, req: Request) -> None:
        with self._cv:
            self._inbox.append(req)
            self._cv.notify_all()

    def cancel(self, rid: int, reason: str) -> None:
        with self._cv:
            self._cancels.append((rid, reason))
            self._cv.notify_all()

    def drain_completions(self) -> list[Request]:
        with self._cv:
            out = list(self.completions)
            self.completions.clear()
        return out

    @property
    def load(self) -> int:
        """Queued + slotted work, inbox included: the least-loaded routing
        key (plain int reads that never stop the worker)."""
        return len(self._inbox) + self.sched.load

    @property
    def idle(self) -> bool:
        return not self._inbox and _sched_idle(self.sched)

    def probe(self) -> bool:
        """Host-only health probe: the fault plan's ``probe`` site may
        blackhole (no answer) or raise; otherwise healthy means the worker
        thread is alive and did not die on an injected loop fault.
        Heartbeat freshness is the Router's to judge (``watchdog_s``)."""
        if self.plan is not None:
            try:
                f = self.plan.fire(replica_site(self.idx, "probe"))
            except InjectedFault:
                return False
            if f is not None and f.kind == "blackhole":
                return False
        return self._thread.is_alive() and self.dead_error is None

    def restart(self, join_timeout_s: float = 2.0) -> None:
        with self._cv:
            self._gen += 1               # fence: the old worker exits at
            self._cv.notify_all()        # its next check, even mid-stall
        self._thread.join(timeout=join_timeout_s)
        with self._cv:
            self._inbox.clear()
            self._cancels.clear()
        # the abandoned generation's adapter rows go back to the engine's
        # bank (a wedged worker still owns its own); on a tensor-parallel
        # replica in the new generation's begin record, in the engine's
        # turn, so every rank's bank sees the same order
        release = not self._thread.is_alive()
        if self.stream is None:
            if release:
                self.sched.release_adapters()
        else:
            self._prev = (self.sched, release)
        self.sched = self._make_sched()
        self.dead_error = None
        self.dead_at = None
        self.last_beat = time.perf_counter()
        self.restarts += 1
        self._thread = self._spawn()

    def stop(self, drain: bool = True, join_timeout_s: float = 5.0) -> None:
        """Stop the worker, then wind the scheduler down on the calling
        thread (the worker is fenced out first).  A tensor-parallel
        replica sends the ``stop`` record in the engine's turn, and its
        followers wind down (or abandon) the same scheduler."""
        with self._cv:
            gen = self._gen
            self._gen += 1
            self._cv.notify_all()
        self._thread.join(timeout=join_timeout_s)
        if self.stream is None:
            if self._thread.is_alive():
                # a wedged worker outlived the join and still owns this
                # scheduler: abandon the generation (its completions die
                # with it, as a dead replica's)
                return
            self._wind_down(self.sched, drain)
            return
        with self.stream.turn:
            alive = self._thread.is_alive()
            self.stream.send(self.idx, gen, "stop", drain=drain, alive=alive)
            if not alive:
                self._wind_down(self.sched, drain)

    def _wind_down(self, sched: Scheduler, drain: bool) -> None:
        try:
            sched.shutdown(drain=drain)
        except Exception:      # a broken engine must not block shutdown
            pass
        self._publish_from(sched)

    # ---- the worker ---------------------------------------------------

    def _run(self, gen: int) -> None:
        # the worker binds ITS generation's scheduler: after a restart a
        # stale worker waking from a stall touches only its own abandoned
        # scheduler, and the generation check drops its publishes
        sched = self.sched
        if self.device.type == "cuda":
            import torch
            torch.cuda.set_device(self.device)
        # a beat at each layer too: an eager prefill is many launches,
        # which other replicas' threads slow by holding the GIL
        set_block_beat(self._beat)
        if self.stream is not None and gen:
            self.stream.turn.acquire(self._beat)
            try:
                if gen != self._gen:
                    return
                prev, release = self._prev
                self.stream.send(self.idx, gen, "begin", release=release)
                if release:
                    prev.release_adapters()
            finally:
                self.stream.turn.release()
        while True:
            with self._cv:
                while (gen == self._gen and not self._inbox
                       and not self._cancels and _sched_idle(sched)):
                    self.last_beat = time.perf_counter()
                    self._cv.wait(timeout=self.idle_wait_s)
                if gen != self._gen:
                    return
                subs = list(self._inbox)
                self._inbox.clear()
                cans = list(self._cancels)
                self._cancels.clear()
            self._beat()
            if self.plan is not None:
                try:
                    # "stall" sleeps here with the heartbeat frozen (the
                    # watchdog's trigger); "raise" kills this worker
                    self.plan.fire(replica_site(self.idx, "loop"))
                except InjectedFault as e:
                    self.dead_error = f"{type(e).__name__}: {e}"
                    self.dead_at = time.perf_counter()
                    if self.stream is not None:
                        with self.stream.turn:
                            if gen == self._gen:
                                self.stream.send(self.idx, gen, "die")
                    return
                if gen != self._gen:
                    return         # fenced out while it stalled
            if self.stream is None:
                self._iterate(sched, subs, cans)
            else:
                self.stream.turn.acquire(self._beat)
                try:
                    if gen != self._gen:
                        return     # fenced out while it waited its turn
                    self._iterate(sched, subs, cans, gen)
                finally:
                    self.stream.turn.release()
            self._publish_from(sched, gen)

    def _iterate(self, sched: Scheduler, subs, cans,
                 gen: Optional[int] = None) -> None:
        """One iteration: the new attempts and cancels, then a step (work
        queued or slotted) or a drain (only harvests left).  On a
        tensor-parallel replica the record goes first (submit and cancel
        are host-only)."""
        wire = [_wire(r) for r in subs] if self.stream is not None else ()
        for r in subs:
            sched.submit(r)
        for rid, reason in cans:
            sched.cancel(rid, reason)
        action = ("step" if sched.queue
                  or any(x is not None for x in sched.slots)
                  else "drain" if sched._pending else "none")
        if self.stream is not None:
            self.stream.send(self.idx, gen, action, wire, cans)
        if action == "step":
            sched.step()
        elif action == "drain":
            sched.drain()

    def replay(self, rec: dict) -> None:
        """A follower's turn at one of its leader's records (see
        :class:`ControlStream`)."""
        gen, action = rec["gen"], rec["action"]
        if gen != self._gen:
            # the leader began a new generation: drop the old scheduler
            # (its arena goes with it) as the leader did
            if action == "begin" and rec.get("release"):
                self.sched.release_adapters()
            self.sched = self._make_sched()
            self._gen = gen
            self.restarts += 1
        sched = self.sched
        # a begin needs nothing more; after a die the generation's
        # scheduler waits for the next begin, as the leader's does
        if action == "stop":
            if not rec["alive"]:
                self._wind_down(sched, rec["drain"])
        elif action in ("step", "drain", "none"):
            for d in rec["subs"]:
                sched.submit(Request(**d))
            for rid, reason in rec["cancels"]:
                sched.cancel(rid, reason)
            if action == "step":
                sched.step()
            elif action == "drain":
                sched.drain()
            self._publish_from(sched)

    def _publish_from(self, sched: Scheduler,
                      gen: Optional[int] = None) -> None:
        """Move newly finished requests of ``sched`` into the completion
        deque; a stale worker's (``gen`` no longer current) are dropped
        under the lock, as a real dead replica's would be."""
        n = len(sched.finished)
        if sched._fleet_published >= n:
            return
        with self._cv:
            if gen is not None and gen != self._gen:
                return
            while sched._fleet_published < n:
                self.completions.append(
                    sched.finished[sched._fleet_published])
                sched._fleet_published += 1
        if self._on_complete is not None:
            self._on_complete()


class PrefixDirectory:
    """Fleet-wide chain-hash -> replica map, fed by the replicas'
    :attr:`Scheduler.kv_receipts`: ``("add", hash)`` when a replica
    publishes a prefix page in any tier, ``("drop", hash)`` when its last
    tier forgets it, ``("reset", 0)`` on containment.  The Router drains
    the receipts once per pump tick and consults :meth:`lookup` at
    dispatch.  Ownership is last-writer-wins per hash, and the whole map
    is advisory: a stale entry routes a request to a replica that then
    recomputes, a miss in speed, never a wrong token (each replica's own
    chain-hashed prefix cache is the only authority over page content)."""

    def __init__(self):
        self._owner: dict[int, int] = {}      # chain hash -> replica idx

    def add(self, h: int, replica: int) -> None:
        self._owner[h] = replica

    def drop(self, h: int, replica: int) -> None:
        # only the advertised owner may retract: replica A dropping its
        # spill copy must not delist replica B's live copy
        if self._owner.get(h) == replica:
            del self._owner[h]

    def invalidate_replica(self, replica: int) -> int:
        """Drop every entry owned by ``replica`` (eviction, drain,
        containment); returns how many went."""
        stale = [h for h, r in self._owner.items() if r == replica]
        for h in stale:
            del self._owner[h]
        return len(stale)

    def lookup(self, hashes: Sequence[int]) -> tuple[Optional[int], int]:
        """Longest single-owner run from the start of the chain,
        ``(replica, n_pages)``, or ``(None, 0)`` on a cold prefix (page k
        is useless without pages 0..k-1)."""
        owner, n = None, 0
        for h in hashes:
            r = self._owner.get(h)
            if r is None or (owner is not None and r != owner):
                break
            owner = r
            n += 1
        return owner, n

    def __len__(self) -> int:
        return len(self._owner)


class FleetMetrics:
    """Router-level accounting plus fleet-wide tails.  The invariant::

        submitted == finished + rejected + expired + failed + aborted

    counts each USER request once however many replica attempts (retries,
    hedges, failovers, migrations) served it; the attempt churn has its
    own ledger.  Per-replica :class:`ServeMetrics` keep their own books,
    nested under ``replicas`` in :meth:`summary`.  TTFT and per-token
    tails are on the router's clock (from router submit)."""

    def __init__(self):
        self.n_submitted = 0
        self.n_finished = 0
        self.n_rejected = 0
        self.n_expired = 0
        self.n_failed = 0
        self.n_aborted = 0
        self.retries = 0
        self.hedges = 0
        self.hedges_won = 0
        self.evictions = 0
        self.failovers = 0
        self.restarts = 0
        # disaggregation: flights migrated to a decode replica and the
        # pages they carried
        self.migrations = 0
        self.kv_handoff_pages = 0
        # the prefix directory: affinity dispatches, the prefill tokens
        # they were expected to save, bulk invalidations
        self.directory_hits = 0
        self.directory_tokens_saved = 0
        self.directory_invalidations = 0
        self.ttft_hist = LogHistogram()
        self.tok_latency_hist = LogHistogram()
        self._t_start: Optional[float] = None
        self._t_last: Optional[float] = None
        self._win_prev: dict = {}

    # ---- router hooks -------------------------------------------------

    def on_submit(self):
        self.n_submitted += 1
        if self._t_start is None:
            self._t_start = time.perf_counter()

    def on_reject(self):
        self.n_submitted += 1
        self.n_rejected += 1

    def on_reject_terminal(self):
        """A deterministic replica-side rejection surfaced as the user's
        outcome: counted rejected without a second submit."""
        self.n_rejected += 1

    def on_expire(self):
        self.n_expired += 1

    def on_failed(self):
        self.n_failed += 1

    def on_abort(self):
        self.n_aborted += 1

    def on_finish(self, user: Request, attempt: Request):
        self.n_finished += 1
        self._t_last = time.perf_counter()
        if attempt.t_first and user.t_submit:
            self.ttft_hist.add(attempt.t_first - user.t_submit)
        n_dec = len(attempt.tokens) - 1
        if n_dec > 0 and attempt.t_done > attempt.t_first:
            self.tok_latency_hist.add(
                (attempt.t_done - attempt.t_first) / n_dec)

    def on_retry(self):
        self.retries += 1

    def on_hedge(self):
        self.hedges += 1

    def on_hedge_won(self):
        self.hedges_won += 1

    def on_eviction(self, n_failover: int):
        self.evictions += 1
        self.failovers += n_failover

    def on_restart(self):
        self.restarts += 1

    def on_migrate(self, pages: int):
        """One completed prefill handed to a decode replica with
        ``pages`` KV pages."""
        self.migrations += 1
        self.kv_handoff_pages += pages

    def on_directory_hit(self, tokens_saved: int):
        self.directory_hits += 1
        self.directory_tokens_saved += tokens_saved

    def on_directory_invalidate(self, n_entries: int):
        self.directory_invalidations += n_entries

    # ---- aggregation --------------------------------------------------

    @property
    def accounted(self) -> int:
        return (self.n_finished + self.n_rejected + self.n_expired
                + self.n_failed + self.n_aborted)

    def summary(self, replicas: Sequence[dict] = (),
                health: Sequence[str] = ()) -> dict:
        replicas = list(replicas)
        wall = 0.0
        if self._t_start is not None and self._t_last is not None:
            wall = self._t_last - self._t_start
        decode_tokens = sum(r.get("decode_tokens", 0) for r in replicas)
        return {
            "fleet_requests_submitted": self.n_submitted,
            "fleet_requests_finished": self.n_finished,
            "fleet_requests_rejected": self.n_rejected,
            "fleet_requests_expired": self.n_expired,
            "fleet_requests_failed": self.n_failed,
            "fleet_requests_aborted": self.n_aborted,
            "fleet_accounting_ok": self.n_submitted == self.accounted,
            "fleet_retries": self.retries,
            "fleet_hedges": self.hedges,
            "fleet_hedges_won": self.hedges_won,
            "fleet_evictions": self.evictions,
            "fleet_failovers": self.failovers,
            "fleet_restarts": self.restarts,
            "fleet_migrations": self.migrations,
            "fleet_kv_handoff_pages": self.kv_handoff_pages,
            "fleet_wall_s": wall,
            "fleet_decode_tokens": decode_tokens,
            "fleet_decode_tokens_per_sec": (decode_tokens / wall
                                            if wall > 0 else 0.0),
            # the tenants' ledgers, summed over the replica books
            "fleet_tokens_by_adapter": _merge_counts(
                r.get("tokens_by_adapter", {}) for r in replicas),
            "fleet_grammar_rejected_tokens": sum(
                r.get("grammar_rejected_tokens", 0) for r in replicas),
            "fleet_stream_deliveries": sum(
                r.get("stream_deliveries", 0) for r in replicas),
            "fleet_pages_spilled": sum(
                r.get("pages_spilled", 0) for r in replicas),
            "fleet_pages_restored": sum(
                r.get("pages_restored", 0) for r in replicas),
            "fleet_spill_bytes": sum(
                r.get("spill_bytes", 0) for r in replicas),
            "fleet_restore_s": sum(
                r.get("restore_s", 0.0) for r in replicas),
            "fleet_directory_hits": self.directory_hits,
            "fleet_directory_tokens_saved": self.directory_tokens_saved,
            "fleet_directory_invalidations": self.directory_invalidations,
            "fleet_ttft_s_mean": 0.0, "fleet_tok_latency_s_mean": 0.0,
            **self.ttft_hist.summary("fleet_ttft_s_"),
            **self.tok_latency_hist.summary("fleet_tok_latency_s_"),
            "replica_health": list(health),
            "replicas": replicas,
        }

    # the monotonic fleet ledgers window() diffs
    _WINDOW_COUNTERS = frozenset({
        "fleet_requests_submitted", "fleet_requests_finished",
        "fleet_requests_rejected", "fleet_requests_expired",
        "fleet_requests_failed", "fleet_requests_aborted",
        "fleet_retries", "fleet_hedges", "fleet_hedges_won",
        "fleet_evictions", "fleet_failovers", "fleet_restarts",
        "fleet_migrations", "fleet_kv_handoff_pages",
        "fleet_decode_tokens", "fleet_tokens_by_adapter",
        "fleet_grammar_rejected_tokens", "fleet_stream_deliveries",
        "fleet_pages_spilled",
        "fleet_pages_restored", "fleet_spill_bytes", "fleet_restore_s",
        "fleet_directory_hits", "fleet_directory_tokens_saved",
        "fleet_directory_invalidations",
    })

    def window(self, replicas: Sequence[dict] = (),
               health: Sequence[str] = ()) -> dict:
        """Counter increments since the last :meth:`window` call plus the
        current gauges and tails, flat (nested replica summaries
        dropped)."""
        return _window_delta(self.summary(replicas, health),
                             self._WINDOW_COUNTERS, self._win_prev)


def _warm_tenancy(eng) -> None:
    """One prefill, decode and verify of ``eng`` through its LoRA path
    (bank row 1, whatever it holds) under all-true grammar masks, on a
    scratch arena whose writes land in the garbage page: the tenant
    paths' first calls happen before any worker's watchdog runs."""
    import numpy as np
    n, vocab = eng.n_slots, eng.model.cfg.vocab_size
    arena, last = eng.init_arena(), eng.init_last_tokens()
    tables = (np.zeros((n, eng.n_ptab), np.int32) if eng.paged else None)
    knobs = (np.zeros(n, np.float32), np.zeros(n, np.int32),
             np.ones(n, np.float32))
    ids, active = np.ones(n, np.int32), np.ones(n, bool)
    arena, last, _ = eng.prefill(
        arena, last, 0, [0], page_row=None if tables is None else tables[0],
        adapter_id=1, allowed=np.ones((1, vocab), bool))
    arena, last, _ = eng.decode(arena, last, active, *knobs, tables,
                                adapter_ids=ids,
                                allowed=np.ones((n, vocab), bool))
    eng.verify(arena, last, np.zeros((n, 1), np.int32), np.ones(n, np.int32),
               active, *knobs, tables, adapter_ids=ids,
               allowed=np.ones((n, 2, vocab), bool))


def _merge_counts(dicts) -> dict:
    """Sum dict-valued counters key by key (the per-adapter tokens)."""
    out: dict = {}
    for d in dicts:
        for k, v in d.items():
            out[k] = out.get(k, 0) + v
    return out


def default_fleet_slos(ttft_p99_s: Optional[float] = None,
                       availability: Optional[float] = None,
                       acceptance_rate: Optional[float] = None,
                       window_s: float = 10.0) -> list:
    """The standard serving objectives as :class:`~dtdl_tpu_torch.obs.slo.
    SLO` declarations over the Router's exported fields (pass the result
    as ``Router(slos=...)``), JAX's:

    * ``ttft_p99_s``: router-clock TTFT p99 at most the target, judged on
      the histogram tail ``fleet_ttft_s_p99``;
    * ``availability``: finished / (finished + failed + expired) over a
      rolling ``window_s`` (:data:`~dtdl_tpu_torch.serve.metrics.
      UNAVAILABLE_KINDS`: sheds, rejections and aborts never burn it);
    * ``acceptance_rate``: a speculative-acceptance floor on the
      per-scheduler ``spec_acceptance_rate`` (needs a ServeMetrics source
      on the same exporter), gated on drafted tokens.
    """
    slos = []
    if ttft_p99_s is not None:
        slos.append(SLO("ttft_p99", metric="fleet_ttft_s_p99",
                        op="<=", target=ttft_p99_s))
    if availability is not None:
        slos.append(SLO(
            "availability", good="fleet_requests_finished",
            bad=tuple(f"fleet_requests_{k}" for k in UNAVAILABLE_KINDS),
            target=availability, window_s=window_s))
    if acceptance_rate is not None:
        # gated on drafted tokens: the rate exports 0.0 in windows with
        # speculation off, which would breach the floor every idle window
        slos.append(SLO("acceptance", metric="spec_acceptance_rate",
                        op=">=", target=acceptance_rate,
                        gate="spec_drafted_tokens"))
    return slos


def _router_process(engines, me: int) -> int:
    """The process whose Router is the front door: the first process of
    every tensor-parallel replica's control group and the only home of a
    single-placement replica (this one when there is no tensor-parallel
    replica).  A replica that cannot be driven from it is refused by
    name here, before any collective, as are tensor-parallel replicas
    whose processes overlap in any but the Router's (module docstring)."""
    tp = [e.control_ranks for e in engines
          if e is not None and e.control_ranks is not None]
    lead = tp[0][0] if tp else me
    where = (f"the Router's process {lead} (the first process of every "
             f"tensor-parallel replica's control group)")
    for i, eng in enumerate(engines):
        ranks = None if eng is None else eng.control_ranks
        if eng is None and lead == me:
            why = f"is not on {where}"
        elif ranks is not None and lead not in ranks:
            why = (f"runs on the processes {list(ranks)}, whose control "
                   f"group does not hold {where}")
        elif ranks is not None and ranks[0] != lead:
            why = f"is led by process {ranks[0]}, not by {where}"
        elif eng is not None and ranks is None and lead != me:
            why = (f"is a single-placement engine on process {me}, not on "
                   f"{where}")
        else:
            continue
        raise NotImplementedError(
            f"replica {i}'s engine {why}: the Router drives every replica "
            f"from its own process, and a replica outside it needs a "
            f"transport between front end and replica, which the JAX "
            f"package does not have (ROADMAP A12c)")
    sets = sorted(set(tp))
    for k, a in enumerate(sets):
        for b in sets[k + 1:]:
            shared = sorted(set(a) & set(b) - {lead})
            if shared:
                raise NotImplementedError(
                    f"tensor-parallel replicas on the processes {list(a)} "
                    f"and {list(b)} share the processes {shared} besides "
                    f"the Router's: their records would reach those "
                    f"processes on two threads in no common order, and two "
                    f"NCCL communicators' collectives issued in different "
                    f"orders deadlock.  Build them over the same processes "
                    f"(one record stream) or over processes that share only "
                    f"the Router's (ROADMAP A12c)")
    return lead


@dataclasses.dataclass
class _Flight:
    """Router-side record of one USER request: its attempts (replica-local
    Request clones), which are live, the retries burned, whether it was
    hedged.  ``stage``/``handoff`` are the disaggregation state: a flight
    in a role fleet starts at 'prefill' and, when its prefill attempt
    completes with a ``kv_handoff`` payload, moves to 'decode' carrying it;
    every decode attempt (and retry) re-injects the same host pages, so a
    decode replica's death re-serves the flight without a new prefill."""
    req: Request
    t_router: float
    live: dict = dataclasses.field(default_factory=dict)   # rid -> replica
    attempts: list = dataclasses.field(default_factory=list)
    retries: int = 0
    hedged: bool = False
    hedge_rid: Optional[int] = None
    stage: str = "prefill"
    handoff: Optional[dict] = None
    seq: int = 0                  # intake order: the followers' index


class Router:
    """Health-checked fleet front end (see module docstring).

    ``engines`` is one :class:`InferenceEngine` (shared by ``n_replicas``
    replicas: one set of weights, an arena each) or a sequence of engines,
    one per replica.  ``sched_kwargs`` goes to every replica's Scheduler
    (harvest_lag, draft, chunk_tokens, spill_host_bytes, ...).  ``plan``
    arms the per-replica fault sites.  Health knobs:
    ``probe_interval_s``, ``watchdog_s``, ``suspect_after``,
    ``evict_after``, ``recover_after``; ``auto_restart`` refills an
    evicted replica.  ``retry_budget`` bounds re-dispatches per request;
    ``hedge_after_s`` re-submits stragglers.  ``roles`` ('prefill',
    'decode', 'mixed' per replica) disaggregates; ``prefix_directory``
    and ``affinity_min_tokens`` steer warm prefixes.  ``device`` is where
    the replicas' schedulers run (the card unless ``"cpu"``); it must be
    the engines'.  ``observer``, ``exporter`` and ``slos``: see the module
    docstring.  Tensor-parallel engines (module docstring): an entry is
    ``None`` on a process that holds no rank of that replica, and every
    process submits the same requests in the same order."""

    def __init__(self, engines, n_replicas: Optional[int] = None,
                 sched_kwargs: dict | None = None,
                 max_queue: Optional[int] = None, retry_budget: int = 2,
                 hedge_after_s: Optional[float] = None,
                 probe_interval_s: float = 0.02,
                 watchdog_s: float = 0.5, suspect_after: int = 1,
                 evict_after: int = 2, recover_after: int = 2,
                 auto_restart: bool = True, metrics: FleetMetrics = None,
                 observer=None, plan: Optional[FaultPlan] = None,
                 poll_s: float = 0.002, warmup: bool = True,
                 exporter=None, slos=None, roles=None,
                 prefix_directory: bool = True,
                 affinity_min_tokens: Optional[int] = None, device=None):
        sched_kwargs = dict(sched_kwargs or {})
        if sched_kwargs.pop("device", None) is not None:
            raise ValueError("sched_kwargs['device']: pass the device to "
                             "the Router, not to its schedulers")
        dev = resolve_device(device)
        if isinstance(engines, (list, tuple)):
            engines = list(engines)
            if n_replicas is not None and n_replicas != len(engines):
                raise ValueError(f"n_replicas={n_replicas} but "
                                 f"{len(engines)} engines given")
        else:
            if n_replicas is not None and n_replicas < 1:
                raise ValueError(f"n_replicas must be >= 1, got "
                                 f"{n_replicas}")
            n_eff = n_replicas
            if n_eff is None:
                n_eff = len(roles) if roles is not None else 2
            engines = [engines] * n_eff
        if not engines:
            raise ValueError("need at least one engine")
        me = process_index()
        self.leader = _router_process(engines, me)
        self.is_leader = self.leader == me
        for i, eng in enumerate(engines):
            if eng is not None and eng.device != dev:
                raise ValueError(f"replica {i}'s engine runs on "
                                 f"{eng.device}, the Router was asked for "
                                 f"{dev}")
        if retry_budget < 0:
            raise ValueError(f"retry_budget must be >= 0, got "
                             f"{retry_budget}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if roles is not None:
            roles = list(roles)
            if len(roles) != len(engines):
                raise ValueError(f"roles has {len(roles)} entries for "
                                 f"{len(engines)} replicas")
            bad = [r for r in roles if r not in ("prefill", "decode",
                                                 "mixed")]
            if bad:
                raise ValueError(f"unknown roles {bad}; expected "
                                 f"'prefill'/'decode'/'mixed'")
            if not any(r in ("prefill", "mixed") for r in roles):
                raise ValueError("no prefill-capable replica: fresh "
                                 "prompts would never dispatch")
            if not any(r in ("decode", "mixed") for r in roles):
                raise ValueError("no decode-capable replica: migrated "
                                 "flights would never finish")
            has_prefill_role = any(r == "prefill" for r in roles)
            if "decode" in roles and not has_prefill_role:
                # a decode replica is reached only by migrations, which
                # only prefill-role replicas produce: dead capacity
                raise ValueError(
                    "'decode' replicas need at least one 'prefill' "
                    "replica to migrate from (mixed replicas serve "
                    "whole flights and never hand off)")
            for i, r in enumerate(roles):
                # in a fleet with prefill-role replicas a mixed replica is
                # decode-capable, so migrated flights can land on it too
                needs_paged = r != "mixed" or has_prefill_role
                if needs_paged and engines[i] is not None \
                        and not engines[i].paged:
                    raise ValueError(
                        f"replica {i} has role {r!r} in a fleet that "
                        f"migrates KV (page-granular handoff) but a "
                        f"dense engine: build it with page_size > 0")
        self.roles = roles
        self.device = dev
        self.observer = observer or NULL_OBSERVER
        self.metrics = metrics or FleetMetrics()
        self.max_queue = max_queue
        self.retry_budget = retry_budget
        self.hedge_after_s = hedge_after_s
        self.probe_interval_s = probe_interval_s
        self.watchdog_s = watchdog_s
        self.auto_restart = auto_restart
        self.poll_s = poll_s
        if warmup:
            self._warm(engines, sched_kwargs)
        # one record stream a set of processes, made before any worker runs
        self._streams: dict[tuple, ControlStream] = {}
        for eng in engines:
            if eng is not None and eng.control_group is not None \
                    and eng.control_ranks not in self._streams:
                self._streams[eng.control_ranks] = ControlStream(
                    eng.control_group, eng.control_ranks)
        self.replicas = [
            None if eng is None else Replica(
                i, eng, sched_kwargs, plan, dev, observer=self.observer,
                stream=self._streams.get(eng.control_ranks),
                follow=not self.is_leader)
            for i, eng in enumerate(engines)]
        sizes = {eng.page_size for eng in engines if eng is not None}
        self.prefix_dir = (PrefixDirectory()
                           if prefix_directory and sizes != {0}
                           and len(sizes) == 1 and self.is_leader
                           else None)
        self._hash_pg = next(iter(sizes)) if len(sizes) == 1 else 0
        if affinity_min_tokens is None:
            affinity_min_tokens = self._hash_pg
        self.affinity_min_tokens = max(1, affinity_min_tokens)
        self.health = [
            ReplicaHealth(suspect_after, evict_after, recover_after,
                          listener=self._directory_listener(i))
            for i in range(len(engines))] if self.is_leader else []
        self._cv = threading.Condition()
        self.queue: deque[_Flight] = deque()
        self._flights: dict[int, _Flight] = {}      # user rid -> flight
        self._by_attempt: dict[int, _Flight] = {}   # attempt rid -> flight
        # fixed memory under unbounded traffic: the most recent entries;
        # the counts live in FleetMetrics, and evict_log (rare by
        # construction) keeps every eviction's MTTR record
        self.finished: deque[Request] = deque(maxlen=65536)
        self.dispatch_log: deque[tuple[float, int, int, int]] = \
            deque(maxlen=65536)
        self.evict_log: list[dict] = []
        self._engine_errs: list[Optional[str]] = [None] * len(engines)
        self._last_stall: list[float] = [0.0] * len(engines)
        self._tick_signaled: set[int] = set()
        self._last_probe = 0.0
        self._closed = False
        self._stop = False
        self.pump_error: Optional[str] = None
        self._n_intake = 0
        # a follower's books: its unsettled users and the leader's outcomes
        # by intake number, its replicas' finished attempts
        self._users: dict[int, Request] = {}
        self._outcomes: dict[int, tuple] = {}
        self._attempts: dict[int, Request] = {}
        # continuous export and SLO judging: the pump samples the exporter
        # once a tick (self-throttled) with the fleet's window deltas; an
        # attached evaluator judges every point and its crossings land on
        # this router's trace.  ``slos`` without an exporter builds a
        # sink-less one (the evaluator still judges, summary() rolls up)
        self._own_exporter = False
        if slos is not None and exporter is None:
            from dtdl_tpu_torch.obs.export import MetricsExporter
            exporter = MetricsExporter()
            self._own_exporter = True
        self.exporter = exporter
        if exporter is not None:
            exporter.add_source("", self._export_window)
            if slos is not None:
                if not isinstance(slos, SLOEvaluator):
                    slos = SLOEvaluator(slos)
                if slos.observer is None:
                    slos.observer = self.observer
                exporter.attach_slo(slos)
        if not self.is_leader:
            self._pump = None
            self._followers = [
                threading.Thread(target=self._follow, args=(st,),
                                 name=f"serve-follower{k}", daemon=True)
                for k, st in enumerate(self._streams.values())]
            for t in self._followers:
                t.start()
            return
        for rep in self.replicas:
            rep._on_complete = self._wake
        self._pump = threading.Thread(target=self._pump_loop,
                                      name="serve-router", daemon=True)
        self._pump.start()

    def _warm(self, engines, sched_kwargs) -> None:
        """Run every distinct engine's paths once in the calling thread,
        before any worker owns traffic: the kernels build here (never two
        threads at once), and no first call's set-up inside a worker reads
        as a wedge to the watchdog.  With ``chunk_tokens`` every chunk
        width the planner can produce runs once too."""
        wk = dict(sched_kwargs)
        wk.pop("metrics", None)        # warm-up is not traffic
        ct = wk.get("chunk_tokens")
        seen: set[int] = set()
        for eng in engines:
            if eng is None or id(eng) in seen:
                continue
            seen.add(id(eng))
            if eng.paged_kernel and eng.device.type == "cuda":
                from dtdl_tpu_torch import kernels
                kernels.lib()
            Scheduler(eng, device=self.device, **wk).run([Request([0], 2)])
            if eng.adapter_bank is not None:
                _warm_tenancy(eng)
            if ct:
                ks, k = [], 1
                while True:
                    ks.append(k)
                    if k >= max(1, ct - 1):
                        break
                    k *= 2
                for k in ks:
                    n = min(k + 1, ct, eng.buckets[-1])
                    Scheduler(eng, device=self.device, **wk).run(
                        [Request([0] * n, 2)])

    # ---- intake -------------------------------------------------------

    @property
    def slo(self):
        """The live SLO evaluator (read through the exporter, so one
        attached after construction still shows in :meth:`summary`)."""
        return self.exporter.slo if self.exporter is not None else None

    def _export_window(self) -> dict:
        """The fleet's exporter feed: FleetMetrics window deltas plus the
        replicas' health gauges (host state only)."""
        return self.metrics.window(
            [rep.metrics.summary() for rep in self.replicas],
            health=[h.state for h in self.health])

    def _wake(self) -> None:
        with self._cv:
            self._cv.notify_all()

    def submit(self, req: Request) -> Request:
        """Enqueue ``req`` for the fleet; rejections come back with a
        named ``req.error`` (shut-down router, full admission queue), as
        :meth:`Scheduler.submit`'s do."""
        now = time.perf_counter()
        req.t_submit = now
        if req.deadline_at is None and req.deadline_s is not None:
            # absolute from router intake: queue time counts
            req.deadline_at = now + req.deadline_s
        with self._cv:
            seq = self._n_intake
            self._n_intake += 1
            if not self.is_leader:
                # the leader decides; its outcome settles this request
                self._users[seq] = req
                self.metrics.on_submit()
                self._resolve_locked()
                return req
            if self._closed:
                return self._terminal_locked(
                    req, "rejected: router is shut down",
                    self.metrics.on_reject, seq)
            if (self.max_queue is not None
                    and len(self.queue) >= self.max_queue):
                return self._terminal_locked(
                    req, f"rejected: router admission queue full "
                         f"({self.max_queue} waiting); retry later",
                    self.metrics.on_reject, seq)
            self.metrics.on_submit()
            fl = _Flight(req, now, seq=seq)
            self._flights[req.rid] = fl
            # the intake marker and the flow chain's anchor, under the
            # lock so they precede the dispatch's (the tracer's lock is a
            # leaf: no ordering cycle)
            self.observer.event("request_submitted", rid=corr_rid(req.rid),
                                prompt_len=len(req.prompt),
                                max_new_tokens=req.max_new_tokens)
            self.observer.flow("req", corr_rid(req.rid), "start")
            self.queue.append(fl)
            self._cv.notify_all()
        return req

    def _terminal_locked(self, req: Request, error: str,
                         hook, seq: int) -> Request:
        """Finish a user request at intake; the caller holds the lock."""
        self._announce(seq, error)
        req.error = error
        req.done = True
        req.t_done = time.perf_counter()
        hook()
        if req.stream is not None:
            req.stream.finish(req.tokens, req.error)
        self.finished.append(req)
        # an intake rejection started no flow chain: its terminal marker
        # only, no dangling flow end
        self.observer.event("request_done", rid=corr_rid(req.rid),
                            kind=error_kind(error), attempts=0)
        self._cv.notify_all()
        return req

    def _finish_user(self, fl: _Flight, error: Optional[str], hook,
                     attempt: Optional[Request] = None) -> None:
        """A flight's terminal outcome (lock not held): deliver or error
        the user request exactly once, cancel leftover live attempts,
        prune the flight."""
        user = fl.req
        with self._cv:
            if user.done:
                return
            if error is None and attempt is not None:
                user.tokens = list(attempt.tokens)
                user.error = None
                user.t_admit = attempt.t_admit
                user.t_first = attempt.t_first
                user.t_done = attempt.t_done
                user.done = True
                self.metrics.on_finish(user, attempt)
            else:
                user.error = error
                user.done = True
                user.t_done = time.perf_counter()
                hook()
            if user.stream is not None:
                # the Router owns the user's stream terminal: reconcile
                # the winning attempt's tokens (prefix-guarded) and close;
                # an error closes it undelivered
                user.stream.finish(user.tokens, user.error)
            self._flights.pop(user.rid, None)
            self._announce(fl.seq, user.error, attempt, next(
                (j for rid, j, _ in fl.attempts
                 if attempt is not None and rid == attempt.rid), None))
            losers = list(fl.live.items())
            fl.live.clear()
            for rid, _ in losers:
                # a decided flight needs no routing: late completions of
                # the losers fall out at _collect
                self._by_attempt.pop(rid, None)
            self.finished.append(user)
            self._cv.notify_all()
        # the terminal marker (which attempt won, how many ran) closes the
        # request's flow chain
        self.observer.event(
            "request_done", rid=corr_rid(user.rid),
            kind=error_kind(user.error) if user.error else "finished",
            attempts=len(fl.attempts), retries=fl.retries,
            hedged=int(fl.hedged),
            **({"arid": corr_rid(attempt.rid)} if attempt is not None
               else {}))
        self.observer.flow("req", corr_rid(user.rid), "end")
        for rid, j in losers:
            # best effort: a loser past cancellation finishes on its
            # replica and is dropped at collection
            self.replicas[j].cancel(rid, "lost the race")

    # ---- the pump -----------------------------------------------------

    def _pump_loop(self) -> None:
        while True:
            with self._cv:
                if self._stop:
                    return
                self._cv.wait(timeout=self.poll_s)
                if self._stop:
                    return
            try:
                self._tick()
            except Exception as e:     # the pump must outlive any bug
                self.pump_error = f"{type(e).__name__}: {e}"
                self.observer.event("router_pump_error",
                                    error=self.pump_error)

    def _tick(self) -> None:
        # one health signal per replica per tick: one root cause (a
        # containment failing every slotted attempt at once) must not walk
        # a replica from HEALTHY through SUSPECT to EVICTED in one pass
        self._tick_signaled.clear()
        self._collect()
        self._drain_receipts()
        self._health_check()
        self._expire_queued()
        self._dispatch()
        self._hedge()
        self._keep_alive()
        if self.exporter is not None:
            # the tick is the router's drain boundary: completions are
            # collected above, so the sampled counters are consistent
            self.exporter.sample()

    # ---- the tensor-parallel replicas' records ------------------------

    def _announce(self, seq: int, error: Optional[str],
                  attempt: Optional[Request] = None,
                  replica: Optional[int] = None) -> None:
        """Queue a user request's terminal outcome for the followers:
        ``(intake number, replica, winning attempt's rid, tokens,
        error)``, on every stream (a follower holds exactly one)."""
        out = (seq, replica, None if attempt is None else attempt.rid,
               [] if attempt is None else list(attempt.tokens), error)
        for st in self._streams.values():
            st.outbox.append(out)

    def _keep_alive(self) -> None:
        """Send an ``idle`` record on each stream that is :meth:`due
        <ControlStream.due>` and whose turn is free (a busy stream's
        records carry the outcomes anyway)."""
        for st in self._streams.values():
            if st.due() and st.turn.try_enter():
                try:
                    st.send(-1, 0, "idle")
                finally:
                    st.turn.release()

    def _follow(self, st: ControlStream) -> None:
        """A follower's loop over one stream: replay every record on the
        replica it names, settle the users the outcomes decide, and end at
        ``exit``."""
        me = threading.current_thread()
        name = me.name
        try:
            while True:
                rec = st.recv()
                with self._cv:
                    for out in rec["outcomes"]:
                        self._outcomes[out[0]] = out
                if rec["action"] == "exit":
                    return
                if rec["action"] != "idle":
                    # the replay runs under the leader's worker's name, so
                    # launch counts and spans go to the replica as there
                    me.name = f"serve-replica{rec['replica']}"
                    try:
                        self.replicas[rec["replica"]].replay(rec)
                    finally:
                        me.name = name
                with self._cv:
                    self._resolve_locked()
        except Exception as e:     # the world is broken: fail by name
            self.pump_error = f"{type(e).__name__}: {e}"
            self.observer.event("router_pump_error", error=self.pump_error)
        finally:
            with self._cv:
                self._resolve_locked()
                self._cv.notify_all()

    def _resolve_locked(self) -> None:
        """Settle every submitted user whose outcome has come (a
        follower; the caller holds the lock): a finished one takes the
        tokens of this process's own replay of the winning attempt when
        it ran on a replica held here, the leader's otherwise."""
        for rep in self.replicas:
            if rep is not None:
                for att in rep.drain_completions():
                    self._attempts[att.rid] = att
                    if len(self._attempts) > 65536:   # losers never claimed
                        del self._attempts[next(iter(self._attempts))]
        for seq in sorted(self._outcomes):
            if seq >= self._n_intake:
                break              # its user is not submitted here yet
            user = self._users.get(seq)
            if user is None:       # settled already
                del self._outcomes[seq]
                continue
            _, i, arid, tokens, error = self._outcomes[seq]
            att = None
            if error is None and i is not None \
                    and self.replicas[i] is not None:
                att = self._attempts.pop(arid, None)
                if att is None:
                    continue       # its replay has not finished it yet
                tokens, error = att.tokens, att.error
            del self._outcomes[seq]
            del self._users[seq]
            self._settle(user, tokens, error, att)
        self._cv.notify_all()

    def _settle(self, user: Request, tokens, error: Optional[str],
                att: Optional[Request] = None) -> None:
        if user.done:
            return
        user.tokens = list(tokens)
        user.error = error
        user.done = True
        user.t_done = time.perf_counter()
        if error is None:
            self.metrics.on_finish(user, att if att is not None else user)
        else:
            {"rejected": self.metrics.on_reject_terminal,
             "expired": self.metrics.on_expire,
             "aborted": self.metrics.on_abort}.get(
                error_kind(error), self.metrics.on_failed)()
        if user.stream is not None:
            user.stream.finish(user.tokens, user.error)
        self.finished.append(user)

    # ---- prefix directory ---------------------------------------------

    def _directory_listener(self, i: int):
        """Replica ``i``'s health listener: leaving for EVICTED or
        DRAINING means its arena is lost or rebuilt, so its entries go;
        SUSPECT keeps them."""
        def _on_edge(prev: str, state: str, reason: str) -> None:
            if state in (EVICTED, DRAINING):
                self._invalidate_directory(i, reason)
        return _on_edge

    def _invalidate_directory(self, i: int, reason: str) -> None:
        if self.prefix_dir is None:
            return
        n = self.prefix_dir.invalidate_replica(i)
        if n:
            self.metrics.on_directory_invalidate(n)
            self.observer.event("prefix_directory_invalidated",
                                replica=i, entries=n, reason=reason[:200])

    def _drain_receipts(self) -> None:
        """Fold every replica's ``kv_receipts`` into the directory, once a
        tick (deque pops are atomic; a receipt published mid-drain lands
        next tick)."""
        if self.prefix_dir is None:
            return
        for i, rep in enumerate(self.replicas):
            rec = rep.sched.kv_receipts
            while True:
                try:
                    op, h = rec.popleft()
                except IndexError:
                    break
                if op == "add":
                    self.prefix_dir.add(h, i)
                elif op == "drop":
                    self.prefix_dir.drop(h, i)
                else:            # "reset": a containment wiped the arena
                    self._invalidate_directory(i, "containment reset")

    def _affinity(self, fl: _Flight) -> Optional[tuple[int, int, int]]:
        """``(replica, n_pages, tokens_saved)`` when prefix affinity
        should beat least-loaded for this flight, else None: the owner
        must pass every gate the normal pick applies and the tokens saved
        must clear ``affinity_min_tokens``.  Migrated decode halves carry
        their pages and owe no prefill.  Caller holds the lock."""
        if self.roles is not None and fl.stage != "prefill":
            return None
        prompt = fl.req.prompt
        if len(prompt) <= self._hash_pg:
            return None
        owner, n = self.prefix_dir.lookup(
            page_chain_hashes(prompt[:len(prompt) - 1], self._hash_pg,
                              adapter_salt(fl.req.adapter)))
        if owner is None:
            return None
        saved = n * self._hash_pg
        if saved < self.affinity_min_tokens:
            return None
        if not self.health[owner].dispatchable:
            return None
        if not self._role_ok(owner, fl.stage if self.roles is not None
                             else None):
            return None
        if (self.replicas[owner].load
                >= 2 * self.replicas[owner].engine.n_slots):
            return None
        return owner, n, saved

    # ---- completions --------------------------------------------------

    def _collect(self) -> None:
        for i, rep in enumerate(self.replicas):
            for att in rep.drain_completions():
                with self._cv:
                    fl = self._by_attempt.pop(att.rid, None)
                    if fl is not None:
                        fl.live.pop(att.rid, None)
                if fl is None:
                    continue           # stale (evicted and failed over)
                self._attempt_done(fl, att, i)

    def _attempt_done(self, fl: _Flight, att: Request, i: int) -> None:
        user = fl.req
        if att.error is None:
            self.health[i].on_success()
            if att.kv_handoff is not None and not user.done:
                # the prefill half finished with generation owed: migrate,
                # at the HEAD of the queue, carrying the page payload
                fl.stage = "decode"
                fl.handoff = att.kv_handoff
                n_pg = int(att.kv_handoff["n_pages"])
                self.metrics.on_migrate(n_pg)
                self.observer.event(
                    "request_migrated", rid=corr_rid(user.rid),
                    arid=corr_rid(att.rid), replica=i, pages=n_pg)
                self.observer.flow("req", corr_rid(user.rid), "step")
                with self._cv:
                    self.queue.appendleft(fl)
                    self._cv.notify_all()
                return
            if fl.hedged and att.rid == fl.hedge_rid and not user.done:
                self.metrics.on_hedge_won()
                self.observer.event("hedge_won", rid=corr_rid(user.rid),
                                    arid=corr_rid(att.rid), replica=i)
            self._finish_user(fl, None, None, attempt=att)
            return
        kind = error_kind(att.error)
        if user.done:
            return                     # a raced loser; already delivered
        if kind == "expired":
            # the deadline is global: retrying cannot un-expire it
            self._finish_user(fl, att.error, self.metrics.on_expire)
            return
        if kind == "aborted" and "cancelled" in att.error:
            return                     # our own cancel (hedge, eviction)
        with self._cv:
            hedge_alive = bool(fl.live)
        if kind == "rejected":
            # an admission decision, never a health signal
            if ("queue full" in att.error
                    or "containment in progress" in att.error):
                # transient backpressure: requeue at the tail without
                # burning the retry budget
                if not hedge_alive:
                    with self._cv:
                        self.queue.append(fl)
                        self._cv.notify_all()
                return
            # deterministic rejection (prompt past every bucket, pool that
            # can never fit it): the same everywhere, so the user's outcome
            self._finish_user(fl, att.error,
                              self.metrics.on_reject_terminal)
            return
        if kind != "shed":
            # failed, or aborted by a replica's shutdown: a passive health
            # signal (a page-pool shed is capacity, not sickness)
            self._signal(i, f"attempt error: {att.error}")
        if hedge_alive:
            # the hedge still runs elsewhere and decides the outcome
            return
        self._retry_or_fail(fl, att.error)

    def _retry_or_fail(self, fl: _Flight, error: str) -> None:
        user = fl.req
        now = time.perf_counter()
        if user.deadline_at is not None and now >= user.deadline_at:
            self._finish_user(
                fl, f"expired: deadline exceeded after {fl.retries} "
                    f"retries (last: {error})", self.metrics.on_expire)
            return
        if fl.retries >= self.retry_budget:
            self._finish_user(
                fl, f"failed: retry budget exhausted "
                    f"({self.retry_budget}); last error: {error}",
                self.metrics.on_failed)
            return
        fl.retries += 1
        self.metrics.on_retry()
        self.observer.event("request_retry", rid=corr_rid(user.rid),
                            n=fl.retries)
        with self._cv:
            self.queue.appendleft(fl)
            self._cv.notify_all()

    # ---- health -------------------------------------------------------

    def _signal(self, i: int, reason: str) -> None:
        if i in self._tick_signaled:
            return                     # burst dedup (see _tick)
        self._tick_signaled.add(i)
        h = self.health[i]
        prev = h.state
        state = h.on_signal(reason)
        if state != prev:
            self.observer.event(f"replica_{state}", replica=i,
                                reason=reason[:200])
        if state == EVICTED and prev != EVICTED:
            self._evict(i, reason)

    def _busy(self, i: int) -> bool:
        """Does replica ``i`` hold outstanding work, by the router's own
        live-attempt table or the replica's visible state?  A worker that
        stalled before submitting its inbox looks idle from its scheduler,
        which is the case the watchdog exists for."""
        with self._cv:
            if any(rep == i for fl in self._by_attempt.values()
                   for rep in fl.live.values()):
                return True
        return not self.replicas[i].idle

    def _health_check(self) -> None:
        now = time.perf_counter()
        for i, rep in enumerate(self.replicas):
            if self.health[i].state in (EVICTED, DRAINING):
                continue
            err = rep.sched.last_engine_error
            if err is not None and err != self._engine_errs[i]:
                self._engine_errs[i] = err
                self._signal(i, f"engine containment: {err}")
            if rep.dead_error is not None:
                self._signal(i, f"worker died: {rep.dead_error}")
            elif (self._busy(i)
                  and now - rep.last_beat > self.watchdog_s):
                # harvest stall watchdog, one signal per watchdog window
                if now - self._last_stall[i] > self.watchdog_s:
                    self._last_stall[i] = now
                    self._signal(
                        i, f"harvest stall: no heartbeat for "
                           f"{now - rep.last_beat:.3f}s "
                           f"(watchdog {self.watchdog_s}s)")
        if now - self._last_probe < self.probe_interval_s:
            return
        self._last_probe = now
        for i, rep in enumerate(self.replicas):
            h = self.health[i]
            if h.state in (EVICTED, DRAINING):
                continue
            ok = rep.probe()
            if (ok and self._busy(i)
                    and now - rep.last_beat > self.watchdog_s):
                ok = False             # alive but wedged counts as down
            prev = h.state
            state = h.on_probe(ok)
            if state != prev:
                self.observer.event(f"replica_{state}", replica=i,
                                    probe_ok=int(ok))
                if state == EVICTED:
                    self._evict(i, "probe failures")

    def _fail_over(self, i: int, why: str) -> int:
        """Abandon every live attempt on replica ``i`` (cancelled, best
        effort) and re-dispatch its flights under the retry budget;
        returns how many moved."""
        with self._cv:
            victims = []
            for rid, fl in [(r, f) for r, f in self._by_attempt.items()
                            if f.live.get(r) == i]:
                self._by_attempt.pop(rid, None)
                fl.live.pop(rid, None)
                victims.append((rid, fl))
        moved = 0
        for rid, fl in victims:
            self.replicas[i].cancel(rid, f"replica {why}")
            if fl.req.done:
                continue
            if fl.live:
                continue               # a hedge still runs elsewhere
            moved += 1
            self._retry_or_fail(fl, f"failed: replica {i} {why}")
        return moved

    def _evict(self, i: int, reason: str) -> None:
        """Fail over replica ``i``'s live attempts, log the eviction (with
        the detection latency when the worker's death instant is known)
        and, with ``auto_restart``, refill it."""
        moved = self._fail_over(i, f"evicted ({reason})")
        self.metrics.on_eviction(moved)
        now = time.perf_counter()
        dead_at = self.replicas[i].dead_at
        self.evict_log.append({
            "t": now, "replica": i, "reason": reason[:200],
            "failovers": moved,
            "detect_latency_s": (now - dead_at
                                 if dead_at is not None else None),
        })
        self.observer.event("replica_evicted", replica=i,
                            reason=reason[:200], failovers=moved)
        if self.auto_restart:
            self._refill(i)

    def _refill(self, i: int) -> None:
        """Replace an evicted replica: DRAINING, a fresh worker, HEALTHY.
        On the pump thread, so the old worker's join is short: a wedged
        one is abandoned behind the generation fence."""
        with self._cv:
            self.health[i].start_drain("replacing evicted replica")
        self.replicas[i].restart(join_timeout_s=0.1)
        self._engine_errs[i] = None
        self.metrics.on_restart()
        with self._cv:
            self.health[i].on_restarted()
        self.observer.event("replica_restarted", replica=i)

    # ---- dispatch -----------------------------------------------------

    def _expire_queued(self) -> None:
        now = time.perf_counter()
        expired = []
        with self._cv:
            for fl in [f for f in self.queue
                       if f.req.deadline_at is not None
                       and now >= f.req.deadline_at]:
                self.queue.remove(fl)
                expired.append(fl)
        for fl in expired:
            self._finish_user(
                fl, "expired: deadline exceeded in router queue",
                self.metrics.on_expire)

    def _role_ok(self, i: int, stage: Optional[str]) -> bool:
        """May replica ``i`` serve a flight at ``stage``?  Fresh prompts go
        to prefill or mixed replicas, migrated flights to decode or mixed
        ones; always True in a role-less fleet."""
        if self.roles is None or stage is None:
            return True
        if stage == "prefill":
            return self.roles[i] in ("prefill", "mixed")
        return self.roles[i] in ("decode", "mixed")

    def _pick(self, exclude: Optional[int] = None,
              stage: Optional[str] = None,
              whole: bool = False) -> Optional[int]:
        """Least-loaded over dispatchable (HEALTHY) replicas with
        capacity: a replica already holding twice its slots is skipped, so
        backlog stays in the router's queue where ``max_queue`` bounds it.
        ``exclude`` asks for a different replica (hedging), ``stage``
        applies the role filter, ``whole`` keeps a role fleet to its mixed
        replicas (a hedge must run the flight end to end)."""
        cands = [i for i, h in enumerate(self.health)
                 if h.dispatchable and i != exclude
                 and self._role_ok(i, stage)
                 and (not whole or self.roles is None
                      or self.roles[i] == "mixed")
                 and self.replicas[i].load
                 < 2 * self.replicas[i].engine.n_slots]
        if not cands:
            return None
        return min(cands, key=lambda i: (self.replicas[i].load, i))

    def _dispatch(self) -> None:
        with self.observer.span("route"):
            while True:
                dead = None
                with self._cv:
                    if not self.queue:
                        return
                    # role fleets pick by the HEAD flight's stage (strict
                    # FIFO: a decode-capacity stall holds the queue)
                    head_stage = (self.queue[0].stage
                                  if self.roles is not None else None)
                    target = self._pick(stage=head_stage)
                    aff = None
                    if target is not None and self.prefix_dir is not None:
                        aff = self._affinity(self.queue[0])
                        if aff is not None:
                            target = aff[0]
                    if target is None:
                        # SUSPECT and DRAINING recover; a fleet ENTIRELY
                        # evicted (no auto_restart) never will: fail the
                        # queue by name instead of hanging
                        if all(h.state == EVICTED for h in self.health):
                            dead = list(self.queue)
                            self.queue.clear()
                        else:
                            return         # circuits open: wait for probes
                    else:
                        fl = self.queue.popleft()
                        if fl.req.done:
                            continue
                        if self.roles is not None and fl.stage == "decode":
                            att = self._clone(fl.req, "migrate")
                            att.kv_inject = fl.handoff
                            # the prefill half delivered the first token:
                            # seed it, the decode replica owes the rest
                            att.tokens = [int(fl.handoff["first_token"])]
                            att.t_first = float(
                                fl.handoff.get("t_first") or 0.0)
                        else:
                            lineage = ("primary" if not fl.attempts
                                       else f"retry:{fl.retries}"
                                       if fl.retries else "requeue")
                            att = self._clone(fl.req, lineage)
                            if self.roles is not None \
                                    and self.roles[target] == "prefill":
                                att.prefill_only = True
                        now = time.perf_counter()
                        fl.live[att.rid] = target
                        fl.attempts.append((att.rid, target, now))
                        self._by_attempt[att.rid] = fl
                        self.dispatch_log.append(
                            (now, target, fl.req.rid, att.rid))
                if dead is not None:
                    for fl in dead:
                        self._finish_user(
                            fl, "failed: no healthy replica (every "
                                "replica evicted)",
                            self.metrics.on_failed)
                    return
                if aff is not None:
                    self.metrics.on_directory_hit(aff[2])
                    self.replicas[target].metrics.on_directory_hit()
                    self.observer.event(
                        "prefix_directory_hit", rid=corr_rid(fl.req.rid),
                        replica=target, pages=aff[1], tokens_saved=aff[2])
                self.observer.event("request_dispatched",
                                    rid=corr_rid(fl.req.rid),
                                    arid=corr_rid(att.rid), replica=target,
                                    lineage=att.lineage, retries=fl.retries)
                self.observer.flow("req", corr_rid(fl.req.rid), "step")
                self.replicas[target].submit(att)

    def _clone(self, user: Request, lineage: str = "primary") -> Request:
        """A fresh replica-local attempt for a user request: the same
        generation parameters and tenant fields, its own rid and
        lifecycle, the USER's absolute deadline, and
        ``origin_rid``/``lineage``."""
        return Request(list(user.prompt), user.max_new_tokens,
                       sampling=user.sampling, eos_id=user.eos_id,
                       speculate=user.speculate,
                       deadline_at=user.deadline_at,
                       origin_rid=user.rid, lineage=lineage,
                       # the tenant fields ride every attempt; the shared
                       # stream's protocol keeps the siblings prefix-stable
                       adapter=user.adapter, grammar=user.grammar,
                       stream=user.stream)

    def _hedge(self) -> None:
        if self.hedge_after_s is None:
            return
        now = time.perf_counter()
        todo = []
        with self._cv:
            for fl in self._flights.values():
                if (fl.req.done or fl.hedged or len(fl.live) != 1
                        or not fl.attempts):
                    continue
                _, first_rep, t_disp = fl.attempts[-1]
                if now - t_disp < self.hedge_after_s:
                    continue
                if self.roles is not None:
                    # a role fleet hedges only single-stage flights that
                    # run whole on a MIXED replica: a staged flight would
                    # race two handoff payloads for one migration
                    if (fl.stage != "prefill" or fl.handoff is not None
                            or self.roles[first_rep] != "mixed"):
                        continue
                j = self._pick(exclude=first_rep, whole=True)
                if j is None:
                    continue
                att = self._clone(fl.req, "hedge")
                fl.hedged = True
                fl.hedge_rid = att.rid
                fl.live[att.rid] = j
                fl.attempts.append((att.rid, j, now))
                self._by_attempt[att.rid] = fl
                self.dispatch_log.append((now, j, fl.req.rid, att.rid))
                self.metrics.on_hedge()
                todo.append((j, att, fl.req.rid))
        for j, att, rid in todo:
            # the hedge is the flight's second dispatch: rid joins it to
            # the primary, arid and lineage tell the attempts apart
            self.observer.event("request_hedged", rid=corr_rid(rid),
                                arid=corr_rid(att.rid), replica=j,
                                lineage="hedge")
            self.observer.flow("req", corr_rid(rid), "step")
            self.replicas[j].submit(att)

    # ---- lifecycle ----------------------------------------------------

    def drain_replica(self, i: int, timeout_s: float = 60.0) -> None:
        """Rolling-restart primitive: stop dispatch to replica ``i``
        (DRAINING), let its in-flight attempts finish and be collected,
        then restart it and return it to HEALTHY while the rest serve.  A
        drain that completes within ``timeout_s`` fails and aborts
        nothing; work still in flight at the timeout is failed over like
        an eviction's.  A follower's is a no-op: it replays the
        leader's."""
        if not self.is_leader:
            return
        with self._cv:
            self.health[i].start_drain("rolling restart")
        deadline = time.perf_counter() + timeout_s
        drained = False
        while time.perf_counter() < deadline:
            with self._cv:
                busy = any(rep == i for fl in self._by_attempt.values()
                           for rep in fl.live.values())
            if not busy and self.replicas[i].idle:
                drained = True
                break
            time.sleep(self.poll_s)
        if not drained:
            moved = self._fail_over(i, "drain timed out; restarting")
            self.observer.event("replica_drain_timeout", replica=i,
                                failovers=moved)
        self.replicas[i].restart()
        self._engine_errs[i] = None
        self.metrics.on_restart()
        with self._cv:
            self.health[i].on_restarted()
        self.observer.event("replica_restarted", replica=i)

    def rolling_restart(self, timeout_s: float = 60.0) -> None:
        """Drain and restart every replica in turn under live traffic."""
        for i in range(len(self.replicas)):
            self.drain_replica(i, timeout_s=timeout_s)

    # ---- driving ------------------------------------------------------

    def wait(self, requests: Optional[Sequence[Request]] = None,
             timeout_s: float = 120.0) -> bool:
        """Block until the given requests (default: everything submitted)
        are terminal; False on timeout."""
        deadline = time.perf_counter() + timeout_s
        with self._cv:
            while True:
                if requests is not None:
                    pending = any(not r.done for r in requests)
                elif self.is_leader:
                    pending = bool(self.queue or self._flights)
                else:
                    pending = bool(self._users)
                if not pending:
                    return True
                if time.perf_counter() >= deadline or (
                        not self.is_leader and not any(
                            t.is_alive() for t in self._followers)):
                    return False
                self._cv.wait(timeout=0.01)

    def run(self, requests: Sequence[Request],
            timeout_s: float = 120.0) -> list[Request]:
        """Submit ``requests`` and block until all are terminal."""
        for r in requests:
            self.submit(r)
        if not self.wait(requests, timeout_s=timeout_s):
            raise TimeoutError(
                f"fleet did not settle within {timeout_s}s "
                f"({sum(1 for r in requests if not r.done)} pending; "
                f"pump_error={self.pump_error})")
        return list(requests)

    # ---- shutdown -----------------------------------------------------

    def shutdown(self, drain: bool = True, timeout_s: float = 60.0) -> None:
        """``drain=True``: stop intake, let every accepted request reach a
        terminal state, then stop the replicas.  ``drain=False``: abort
        queued and in-flight requests by name and tear down.  Idempotent;
        a later ``submit`` is rejected.  A follower waits for its
        leader's ``exit`` records."""
        with self._cv:
            already = self._closed
            self._closed = True
        if already and self._stop:
            return
        if not self.is_leader:
            # bounded by the process group's timeout if the leader is gone
            for t in self._followers:
                t.join()
            with self._cv:
                self._stop = True
                for user in self._users.values():
                    self._settle(user, [], "aborted: router shut down")
                self._users.clear()
            return
        self.observer.event("router_shutdown", drain=int(drain))
        timed_out = False
        if drain:
            timed_out = not self.wait(None, timeout_s=timeout_s)
            if timed_out:
                self.observer.event("router_drain_timeout",
                                    timeout_s=timeout_s)
        if not drain or timed_out:
            # an accepted request is never left non-terminal
            why = ("shutdown drain timed out" if timed_out
                   else "router shut down")
            with self._cv:
                queued = list(self.queue)
                self.queue.clear()
            for fl in queued:
                self._finish_user(
                    fl, f"aborted: {why} before dispatch",
                    self.metrics.on_abort)
            for fl in list(self._flights.values()):
                self._finish_user(fl, f"aborted: {why}",
                                  self.metrics.on_abort)
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._pump.join(timeout=5.0)
        for rep in self.replicas:
            rep.stop(drain=drain)
        self._collect()    # the pump is gone: settle the last completions
        for st in self._streams.values():
            with st.turn:  # the followers' run() and shutdown() return
                st.send(-1, 0, "exit")
        if self.exporter is not None:
            # the final point carries the settled books, so the series
            # telescopes to the end-of-run summary
            self.exporter.sample(force=True)
            if self._own_exporter:
                self.exporter.close()

    def __enter__(self) -> "Router":
        return self

    def __exit__(self, exc_type, *exc) -> bool:
        self.shutdown(drain=exc_type is None)
        return False

    # ---- reporting ----------------------------------------------------

    def summary(self) -> dict:
        """Fleet-level metrics with per-replica summaries nested under
        ``replicas`` (call after :meth:`wait` or :meth:`shutdown`, so the
        harvest-side numbers are settled); with an exporter the export
        volume and the SLO rollup ride along."""
        out = self.metrics.summary(
            [rep.metrics.summary() for rep in self.replicas
             if rep is not None],
            health=[h.state for h in self.health])
        if self.roles is not None:
            out["replica_roles"] = list(self.roles)
        if self.prefix_dir is not None:
            out["prefix_directory_entries"] = len(self.prefix_dir)
        if self._streams:
            out["control_records"] = [st.n for st in self._streams.values()]
        if self.exporter is not None:
            out["export_snapshots"] = self.exporter.n_snapshots
        if self.slo is not None:
            out.update(self.slo.summary())
        return out
