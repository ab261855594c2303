"""Elastic training, the port of dtdl_tpu/resil/elastic.py: peer
liveness, step watchdogs, generation-fenced re-rendezvous and
shrink-to-survivors resume.

A multi-process world is fail-stop: one dead or wedged peer hangs every
survivor inside a collective.  This module is the training plane's
detect, abort, re-form, resume machine, over a control-plane store
(:class:`~dtdl_tpu_torch.parallel.kvstore.HostKVStore` for threads in one
process, :mod:`~dtdl_tpu_torch.parallel.tcpstore` across processes):

* **peer liveness**: every worker holds a heartbeat *lease* in the
  store; a beat thread refreshes ``hb/{rank}`` every ``heartbeat_s`` and
  the store stamps arrivals on one clock.  A peer whose lease goes quiet
  for ``watchdog_s`` is dead, and survivors learn it without waiting out
  a step deadline.
* **step watchdogs**: the gradient exchange runs under a deadline.  A
  missing contribution past ``step_timeout_s`` (lease fresh, gradients
  absent: a wedged peer) or an expired lease aborts the step with a
  named :class:`PeerLostError`, never a silent hang.
  :class:`StepWatchdog` gives the same deadline to a plain loop's drain
  (``Trainer(watchdog=...)``): the hung wait is abandoned on a daemon
  thread.
* **generation-fenced re-rendezvous**: survivors re-form through
  :func:`rendezvous`: the store's generation is CAS-bumped (concurrent
  proposers coalesce), joiners register under the new epoch, and the
  provisional leader (lowest joined rank) closes membership after a
  quiet window.  Every step key carries the epoch, so a stale peer
  waking from a stall cannot write into the new world: it is refused by
  a named :class:`~dtdl_tpu_torch.parallel.kvstore.StaleGenerationError`.
* **shrink-to-survivors resume**: the new world restores the last
  *committed* snapshot (the port's integrity-checked ``save_weights``
  blob; the commit marker lives in the store and is written only after
  the blob is durable), and the world-size-agnostic
  :class:`~dtdl_tpu_torch.data.sharding.GlobalBatchSampler` re-slices the
  same remaining sample stream over the survivors: no sample is lost or
  counted twice, and the timeline after the shrink is bitwise a
  fault-free run of the surviving world restored from the same
  snapshot.  :func:`~dtdl_tpu_torch.runtime.mesh.shrink_mesh` is the
  process-group counterpart.

Aggregation goes through the store (workers push gradient trees, pull
the sum in rank order: MXNet's ``dist_sync`` idiom), which is what makes
shrinking possible: no collective holds a ticket for the ghost.  What
goes on the wire is numpy trees (a worker's tensors are copied to the
host first), so a store never holds torch objects and a JAX worker's
trees and a port worker's are the same bytes.  Tests and the card's
drills host workers as threads sharing one store, with every failure
edge injected through :func:`~dtdl_tpu_torch.resil.faults.peer_site`;
every event on the failure path is named (``elastic_*``).
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

# NOTE: dtdl_tpu_torch.ckpt.checkpoint is imported lazily inside the
# restore/commit methods — the checkpoint layer itself imports
# resil.faults (its injection sites), so a module-level import here
# would be circular through the resil package __init__.
from dtdl_tpu_torch.obs.observer import NULL_OBSERVER
from dtdl_tpu_torch.parallel.kvstore import (  # noqa: F401  (re-exported)
    HostKVStore, RetryingStore, StaleGenerationError, StoreTimeoutError,
    store_barrier,
)
from dtdl_tpu_torch.resil.faults import InjectedFault, fire, peer_site


class PeerLostError(RuntimeError):
    """A peer is dead (expired lease) or wedged (step deadline expired):
    the step was aborted instead of waiting on a ghost.  ``lost`` names
    the ranks when they are known; survivors should re-rendezvous."""

    def __init__(self, lost=(), generation: Optional[int] = None,
                 reason: str = ""):
        self.lost = tuple(sorted(lost))
        self.generation = generation
        gen = f" at generation {generation}" if generation is not None \
            else ""
        who = f"peer(s) {list(self.lost)}" if self.lost else "a peer"
        super().__init__(f"{who} lost{gen}: {reason}")


class RendezvousError(RuntimeError):
    """A (re-)rendezvous did not form a world within its timeout —
    fewer than ``min_world`` survivors showed up, or the store is
    unreachable.  Named so the launcher can requeue instead of hanging."""


@dataclasses.dataclass(frozen=True)
class World:
    """One formed training world: the epoch and its sorted membership."""

    generation: int
    ranks: tuple
    rank: int                       # this worker's original id

    @property
    def index(self) -> int:
        """Position among the survivors — the data-shard coordinate."""
        return self.ranks.index(self.rank)

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def is_leader(self) -> bool:
        return self.index == 0


@dataclasses.dataclass
class ElasticConfig:
    """Knobs of the detect → abort → re-form → resume machine.

    ``watchdog_s`` is the lease TTL (dead-peer detection bound);
    ``step_timeout_s`` the per-step collective deadline (wedged-peer
    bound, deliberately ≫ watchdog so a crash is attributed to the
    lease, not the deadline).  The deadline must comfortably exceed the
    worst-case gap between the fastest and slowest peer *entering* the
    exchange — including a post-re-form restore and any first-call
    compile — or a merely slow peer reads as wedged and the world
    churns through spurious re-forms (they converge, since a slow peer
    stays a member of every formed world, but each costs a restore;
    warm the step (kernels built, allocators primed) before arming the
    machine).  ``join_grace_s`` is how long a forming rendezvous stays
    open after its last joiner — it must cover the spread of the
    survivors' abort times; ``heartbeat_s <= 0`` disables the liveness
    layer (a baseline without it)."""

    heartbeat_s: float = 0.05
    watchdog_s: float = 0.3
    step_timeout_s: float = 5.0
    poll_s: float = 0.02
    join_grace_s: float = 0.25
    rendezvous_timeout_s: float = 10.0
    min_world: int = 1
    snapshot_every: int = 2


class HeartbeatLease:
    """Publishes this worker's lease: ``hb/{rank}`` refreshed every
    ``heartbeat_s`` from a daemon thread (host-side only — zero device
    syncs).  The *store* stamps each beat, so lease age is judged on
    one clock.  The beat thread fires the ``peer_site(rank,
    'heartbeat')`` fault point, making partitioned-peer scenarios
    (beats stop, main loop runs on) deterministically injectable."""

    def __init__(self, store, rank: int, heartbeat_s: float):
        self.store = store
        self.rank = rank
        self.heartbeat_s = heartbeat_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._beats = 0

    def start(self) -> "HeartbeatLease":
        if self.heartbeat_s <= 0 or self._thread is not None:
            return self
        self._beat()                        # lease live before step 0
        self._thread = threading.Thread(
            target=self._run, name=f"elastic-hb-{self.rank}", daemon=True)
        self._thread.start()
        return self

    def _beat(self) -> None:
        fire(peer_site(self.rank, "heartbeat"))   # may stall/raise
        self._beats += 1
        self.store.set(f"hb/{self.rank}", self._beats)

    def _run(self) -> None:
        while not self._stop.wait(self.heartbeat_s):
            try:
                self._beat()
            except InjectedFault:
                return                      # injected beat-thread death
            except Exception:
                return          # a dead store ends the lease — honest

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)
            self._thread = None


def dead_peers(store, ranks, watchdog_s: float):
    """Ranks whose lease has gone quiet for longer than ``watchdog_s``
    (or never beat at all) — the liveness verdict survivors act on."""
    dead = []
    for r in ranks:
        age = store.age(f"hb/{r}")
        if age is None or age > watchdog_s:
            dead.append(r)
    return tuple(dead)


def rendezvous(store, rank: int, cfg: ElasticConfig,
               observer=NULL_OBSERVER, prev_world: Optional[World] = None
               ) -> World:
    """Generation-fenced world formation (module docstring, item c).

    Survivors of ``prev_world`` CAS-bump the store generation (one bump
    no matter how many propose) and join the new round; fresh workers
    join the bootstrap round.  The provisional leader — lowest joined
    rank — publishes membership once the round has been quiet for
    ``join_grace_s`` and at least ``min_world`` joined.  The fence: a
    worker that a *formed* world excludes (it stalled through the whole
    window, or arrived after bootstrap closed) is refused with a named
    :class:`StaleGenerationError`; fewer than ``min_world`` joiners
    raise :class:`RendezvousError` at the deadline.  Store ops should
    ride :class:`RetryingStore` for bounded transient-fault retries.
    """
    fire(peer_site(rank, "join"))           # the late-joiner fault point
    my_gen = prev_world.generation if prev_world is not None else -1
    deadline = time.monotonic() + cfg.rendezvous_timeout_s
    while True:
        latest = store.get("world/latest", None)
        if latest is not None:
            lgen, lranks = latest
            if lgen > my_gen and rank not in lranks:
                raise StaleGenerationError(
                    f"worker {rank} fenced out: world generation {lgen} "
                    f"formed without it (last member of generation "
                    f"{my_gen}) — a stale peer cannot rejoin")
        gen = store.generation
        if prev_world is not None and gen == prev_world.generation:
            gen = store.bump_generation(gen)    # propose the new round
        store.set(f"rdzv/{gen}/join/{rank}", rank)
        while True:
            ranks = store.get(f"world/{gen}", None)
            if ranks is not None:
                if rank not in ranks:
                    raise StaleGenerationError(
                        f"worker {rank} fenced out: it joined generation "
                        f"{gen} after membership closed on {list(ranks)}")
                world = World(gen, tuple(ranks), rank)
                observer.event("elastic_rendezvous", generation=gen,
                               rank=rank, size=world.size,
                               ranks=str(list(ranks)))
                return world
            if store.generation != gen:
                break                           # a newer round started
            joined = sorted(
                int(k.rsplit("/", 1)[1])
                for k in store.keys(f"rdzv/{gen}/join/"))
            if (joined and joined[0] == rank
                    and len(joined) >= cfg.min_world):
                quiet = store.newest_age(f"rdzv/{gen}/join/")
                if quiet is not None and quiet >= cfg.join_grace_s:
                    # provisional leader closes the round
                    store.set(f"world/{gen}", tuple(joined))
                    store.set("world/latest", (gen, tuple(joined)))
                    continue
            if time.monotonic() > deadline:
                raise RendezvousError(
                    f"rendezvous at generation {gen} formed no world "
                    f"within {cfg.rendezvous_timeout_s}s (joined: "
                    f"{joined}, min_world: {cfg.min_world})")
            time.sleep(cfg.poll_s)


def exchange_grads(store, world: World, step: int, grads, cfg: ElasticConfig):
    """Push this worker's gradient tree, pull the rank-ordered sum —
    the deadline-guarded collective (module docstring, item b).

    The wait is sliced: between slices the liveness view is consulted
    (an expired lease aborts within ``watchdog_s`` — no need to wait
    out the step deadline for a crashed peer) and the epoch is checked
    (a bumped generation means the world moved on; the caller
    re-rendezvouses).  Expiry raises :class:`PeerLostError` naming the
    missing ranks.  Summation is in ``world.ranks`` order — the
    deterministic reduction the bitwise shrink contract relies on.
    """
    gen = world.generation
    store.check_generation(gen)
    prefix = f"g/{gen}/{step}/"
    store.set(prefix + str(world.rank), grads)
    # GC: nobody can still need this worker's step-2 contribution (a
    # peer posting step s has consumed every step s-1 tree)
    store.delete(f"g/{gen}/{step - 2}/{world.rank}")
    deadline = time.monotonic() + cfg.step_timeout_s
    total = None
    for r in world.ranks:
        while True:
            try:
                tree = store.wait(prefix + str(r), timeout_s=cfg.poll_s)
                break
            except StoreTimeoutError:
                if store.generation != gen:
                    raise PeerLostError(
                        (), gen, f"world generation advanced past {gen} "
                        f"mid-step — re-rendezvous")
                if cfg.heartbeat_s > 0:
                    dead = dead_peers(store, world.ranks, cfg.watchdog_s)
                    if dead:
                        raise PeerLostError(
                            dead, gen, f"heartbeat lease expired "
                            f"(watchdog_s={cfg.watchdog_s})")
                if time.monotonic() > deadline:
                    missing = tuple(
                        q for q in world.ranks
                        if store.get(prefix + str(q), None) is None)
                    raise PeerLostError(
                        missing, gen, f"step {step} gradient exchange "
                        f"deadline ({cfg.step_timeout_s}s) expired")
        total = tree if total is None else tree_add(total, tree)
    return total


def to_host(tree):
    """``tree`` (nested dicts, lists, tuples) with every tensor as a numpy
    array: what a worker puts on the wire."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree


def tree_add(a, b):
    """Leafwise ``np.add`` of two trees of one structure."""
    if isinstance(a, dict):
        return {k: tree_add(a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return type(a)(tree_add(x, y) for x, y in zip(a, b))
    return np.add(a, b)


def _placed(tree, like):
    """``tree`` (as ``load_weights`` returns it) with every leaf where and
    as ``like``'s is: a tensor on its device, a numpy array as numpy."""
    if isinstance(like, dict):
        return {k: _placed(tree[k], like[k]) for k in like}
    if isinstance(like, torch.Tensor):
        return tree.to(device=like.device, dtype=like.dtype)
    if isinstance(like, np.ndarray):
        return tree.numpy()
    return tree


class StepWatchdog:
    """Deadline on a blocking wait for the card (a loop's drain):
    ``run(fn)`` executes ``fn`` on a worker thread and raises a named
    :class:`PeerLostError` if it does not settle within ``timeout_s``, so
    a dead peer inside a collective can never hang the host silently.
    The abandoned wait keeps blocking on the daemon thread (a collective
    cannot be cancelled, and under NCCL it holds its stream: treat the
    process as lost and leave it), the same contract as
    ``bootstrap.barrier(timeout_s)``."""

    def __init__(self, timeout_s: float, name: str = "train_step",
                 observer=None):
        self.timeout_s = timeout_s
        self.name = name
        self.observer = observer or NULL_OBSERVER
        self.n_timeouts = 0

    def run(self, fn: Callable, *args, **kwargs):
        done = threading.Event()
        box: list = []

        def _work():
            try:
                box.append(("ok", fn(*args, **kwargs)))
            except BaseException as e:       # surfaced to the caller
                box.append(("err", e))
            finally:
                done.set()

        t = threading.Thread(target=_work, daemon=True,
                             name=f"dtdl-watchdog-{self.name}")
        t.start()
        if not done.wait(self.timeout_s):
            self.n_timeouts += 1
            self.observer.event("elastic_step_timeout", phase=self.name,
                                timeout_s=self.timeout_s)
            raise PeerLostError(
                (), None, f"{self.name} did not settle within "
                f"{self.timeout_s}s — a peer is dead or wedged inside "
                f"the collective")
        kind, value = box[0]
        if kind == "err":
            raise value
        return value


class ElasticWorker:
    """One logical training process of the elastic world (a thread in
    the tests and the card's drills, one process per host in a real
    deployment).  Drives the full machine: heartbeat lease up, join the
    world, loop deadline-guarded steps, and on :class:`PeerLostError`
    abort → re-rendezvous → restore the last committed snapshot →
    re-shard → continue at the smaller world.  A fence verdict
    (:class:`StaleGenerationError` from rendezvous) ends the worker
    with ``fenced`` set and the error recorded — named, never silent.

    The training step is functional: ``grad_fn(state, batch) -> grads``
    (tensors, copied to the host as numpy for the exchange),
    ``apply_fn(state, summed_grads, world_size) -> state`` (the summed
    numpy tree), ``batch_fn(indices) -> batch``; ``init_fn() -> state``
    gives a tree of tensors (what a snapshot saves and restores, each
    leaf back on its device).  Data order comes from a world-size-agnostic
    :class:`GlobalBatchSampler`, so the sample stream is identical across
    any shrink (zero lost / zero double-counted).
    """

    def __init__(self, store, rank: int, *, init_fn, grad_fn, apply_fn,
                 batch_fn, sampler, total_steps: int,
                 cfg: Optional[ElasticConfig] = None,
                 ckpt_dir: Optional[str] = None, observer=None,
                 audit_samples: bool = False):
        self.store = store
        self.rank = rank
        self.init_fn = init_fn
        self.grad_fn = grad_fn
        self.apply_fn = apply_fn
        self.batch_fn = batch_fn
        self.sampler = sampler
        self.total_steps = total_steps
        self.cfg = cfg or ElasticConfig()
        self.ckpt_dir = ckpt_dir
        self.observer = observer or NULL_OBSERVER
        self.audit_samples = audit_samples

        self.state = None
        self.step = 0
        self.world: Optional[World] = None
        self.error: Optional[BaseException] = None
        self.fenced = False
        self.done = False
        self.stopped_t: Optional[float] = None
        # host-side drill telemetry: (event, monotonic t, info): the
        # detect, re-form and first-step latencies are read from here
        self.events: list = []
        # opt-in (audit_samples=True): (generation, step) -> the shard
        # indices THIS worker actually fed its grad step — the raw
        # material of the zero-lost/zero-dup audit.  Logging what was
        # consumed (not what the sampler would say) keeps the audit
        # falsifiable, and the opt-in gate keeps a long production run
        # from accumulating an unbounded index log.
        self.sample_log: dict = {}

    # ---- lifecycle ----------------------------------------------------

    def _mark(self, name: str, **info) -> None:
        self.events.append((name, time.monotonic(), info))

    def _on_world(self, world: World) -> None:
        """Enter a formed world: validate the shard math, then restore
        the last committed snapshot (or cold-start when none exists)."""
        self.world = world
        self.sampler.check_world(world.size)
        self._mark("world", generation=world.generation, size=world.size)
        committed = self.store.get("ckpt/committed", None)
        if committed is None:
            self.state = self.init_fn()
            self.step = 0
            return
        from dtdl_tpu_torch.ckpt.checkpoint import load_weights
        like = self.init_fn()
        self.state = _placed(load_weights(committed["path"], like), like)
        self.step = int(committed["step"])
        self.observer.event("elastic_restore", rank=self.rank,
                            generation=world.generation,
                            step=self.step, path=committed["path"])
        self._mark("restore", step=self.step)

    def _commit_snapshot(self) -> None:
        """Leader-only: durable blob + manifest first (its integrity
        manifest), THEN the store commit marker — a crash mid-save leaves the
        previous marker intact and survivors just replay a bit more."""
        from dtdl_tpu_torch.ckpt.checkpoint import save_weights
        path = os.path.join(self.ckpt_dir,
                            f"elastic_{self.step:06d}.msgpack")
        save_weights(path, self.state)
        self.store.set("ckpt/committed", {"step": self.step,
                                          "path": path})
        self.observer.event("elastic_snapshot", step=self.step,
                            generation=self.world.generation)

    def run(self) -> None:
        cfg = self.cfg
        hb = HeartbeatLease(self.store, self.rank, cfg.heartbeat_s)
        try:
            hb.start()
            self._on_world(rendezvous(self.store, self.rank, cfg,
                                      self.observer))
            while self.step < self.total_steps:
                fire(peer_site(self.rank, "step"))   # crash/stall point
                world = self.world
                local = self.sampler.shard(self.step, world.index,
                                           world.size)
                grads = to_host(
                    self.grad_fn(self.state, self.batch_fn(local)))
                try:
                    total = exchange_grads(self.store, world, self.step,
                                           grads, cfg)
                except (PeerLostError, StaleGenerationError) as e:
                    lost = getattr(e, "lost", ())
                    self.observer.event(
                        "elastic_peer_lost", rank=self.rank,
                        generation=world.generation, step=self.step,
                        lost=str(list(lost)), reason=str(e))
                    self._mark("peer_lost", step=self.step,
                               lost=tuple(lost))
                    # survivors re-form; the rendezvous fence decides
                    # whether WE are still welcome (a ghost gets the
                    # named StaleGenerationError here)
                    self._on_world(rendezvous(self.store, self.rank,
                                              cfg, self.observer,
                                              prev_world=world))
                    continue
                self.state = self.apply_fn(self.state, total, world.size)
                if self.audit_samples:
                    self.sample_log[(world.generation, self.step)] = \
                        np.asarray(local)
                self._mark("applied", step=self.step,
                           generation=world.generation)
                self.step += 1
                if (self.ckpt_dir and world.is_leader
                        and self.step % cfg.snapshot_every == 0):
                    self._commit_snapshot()
            self.done = True
        except StaleGenerationError as e:
            self.fenced = True
            self.error = e
            self.observer.event("elastic_stale_fenced", rank=self.rank,
                                reason=str(e))
            self._mark("fenced")
        except BaseException as e:          # injected crashes included
            self.error = e
            self._mark("died", error=type(e).__name__)
        finally:
            hb.stop()
            self.stopped_t = time.monotonic()


def run_workers(workers, timeout_s: float = 60.0):
    """Host the workers on threads and join them: the world driver the
    tests and the card's drills share.  A worker that fails
    to finish within ``timeout_s`` fails the run by name (the harness
    must never itself hang on a hang)."""
    threads = [threading.Thread(target=w.run, daemon=True,
                                name=f"elastic-w{w.rank}")
               for w in workers]
    for t in threads:
        t.start()
    deadline = time.monotonic() + timeout_s
    for w, t in zip(workers, threads):
        t.join(max(0.0, deadline - time.monotonic()))
        if t.is_alive():
            raise RuntimeError(
                f"elastic worker {w.rank} still running after "
                f"{timeout_s}s — the drill harness refuses to hang")
    return workers


def effective_sample_log(workers) -> dict:
    """The surviving timeline's step → consumed-indices map, built from
    what each worker's grad step ACTUALLY fed (``audit_samples=True``
    logs): for each step, take the HIGHEST generation any worker
    applied it at (an older generation's application was discarded by
    the post-shrink restore) and concatenate every worker's shard at
    that generation, sorted.  The zero-lost/zero-dup audit compares
    this multiset against the sampler's pure stream — a shard that
    dropped or double-consumed an index makes the comparison fail,
    which the sampler-side recomputation alone could not detect."""
    top: dict = {}
    for w in workers:
        for (gen, step), _ in w.sample_log.items():
            top[step] = max(top.get(step, gen), gen)
    out: dict = {}
    for step, gen in top.items():
        shards = [w.sample_log[(gen, step)] for w in workers
                  if (gen, step) in w.sample_log]
        out[step] = np.sort(np.concatenate(shards))
    return out
