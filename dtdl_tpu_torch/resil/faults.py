"""Deterministic, seeded fault injection, the port's copy of
dtdl_tpu/resil/faults.py — recovery paths exercised by tests, not luck.

The copy is the JAX module's, with one change: :func:`poison_batch`
also poisons float tensors (the port's loader yields tensors, on the
card by default), where it lies.

The reference's checkpoint/resume idioms (SURVEY §5.4) assume nothing
fails mid-write, mid-step, or mid-request.  The ROADMAP north star —
production traffic from millions of users — guarantees the opposite:
preemption, torn snapshot writes, NaN bursts, and hung hosts are
routine.  This module is the harness that makes every one of those
failures *reproducible*: a :class:`FaultPlan` names exactly which
occurrence of which site fails, and how, so the recovery code in ckpt/,
train/, and serve/ is pinned by tests (tests/test_torch_ckpt.py for the
port) instead of hoped about.

Two injection surfaces:

* **product-code sites** — two narrow hooks compiled into the
  checkpoint layer, each a single :func:`fire` call that is a no-op
  dict lookup unless a plan is installed:

  - ``ckpt.pre_rename``  — between a weights file's tmp write and its
    ``os.replace`` (the classic torn-checkpoint window);
  - ``ckpt.pre_commit``  — between a snapshot becoming durable and its
    commit marker being written (a preemption mid-finalize).

  A ``crash`` fault at either site raises :class:`InjectedCrash`,
  modeling the process dying at that instant: the test abandons the
  instance and verifies a *fresh* run quarantines the torn artifact and
  falls back to the previous good one.

* **the data boundary** — :class:`LoaderFaults` wraps any loader and
  injects at chosen global batch *yields* (site-local occurrence
  counts), with no product hooks at all: ``raise`` (loader exception),
  ``nan`` (poison every float array — the compiled step's grads go
  non-finite, exercising the on-device guard for real), ``sigterm``
  (deliver a real SIGTERM to this process — the preemption drill), and
  ``stall`` (a slow-host sleep).

Determinism: a fault fires at the Nth call of its site, full stop.
Occurrence counters are **plan-local and monotonic**, so a replay after
rollback/resume within the same plan does NOT re-fire (faults are
transient, like a real NaN burst or preemption); a fresh process builds
a fresh plan and chooses its own occurrence indices.  For randomized
schedules, :meth:`FaultPlan.random` derives the fire steps from a seed
— same seed, same schedule, bit for bit.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import time
from collections import defaultdict
from typing import Iterable, Optional

import numpy as np
import torch

KINDS = ("raise", "crash", "sigterm", "sigkill", "stall", "nan",
         "blackhole", "torn")

# the serving-fleet injection surface (dtdl_tpu/serve/fleet.py): every
# replica exposes three sites, so every transition of the router's
# health state machine is deterministically reachable —
#   engine — fired before each compiled-program dispatch of replica i
#            ("raise" at occurrence k == the engine dying on exactly its
#            k-th program call; the Scheduler contains it, the Router
#            sees the passive containment signal);
#   loop   — fired once per worker-thread iteration ("raise" kills the
#            hosting thread = a wedged/dead replica whose heartbeat
#            stops; "stall" freezes the harvest loop for `seconds`,
#            tripping the Router's stall watchdog);
#   probe  — fired on each active health probe of replica i
#            ("blackhole" = the probe gets no answer, "raise" = the
#            health endpoint itself crashing; either way the probe
#            reports failure and the circuit breaker advances).
REPLICA_POINTS = ("engine", "loop", "probe")


# the elastic-training injection surface (dtdl_tpu/resil/elastic.py):
# every ElasticWorker fires three sites, so every detection / abort /
# re-form edge of the training-plane state machine is deterministically
# reachable —
#   step      — fired at the top of each training step of worker `rank`
#               ("crash" at occurrence k == the worker dying right
#               before exchanging step-k gradients: its heartbeat lease
#               stops and survivors abort within watchdog_s; "stall"
#               with `seconds` == a wedged worker whose heartbeat
#               thread keeps beating but whose gradients never arrive —
#               the collective/step watchdog path — and whose late
#               wake-up is then fenced out by generation);
#   heartbeat — fired on each lease beat of worker `rank` ("stall"
#               freezes the beats while the main loop runs on: a
#               partitioned peer whose lease expires);
#   join      — fired when worker `rank` enters (re-)rendezvous
#               ("stall" == a late joiner arriving after the quiet
#               window closed: the formed world excludes it and it is
#               refused by name).
PEER_POINTS = ("step", "heartbeat", "join")


# the control-plane store injection surface (dtdl_tpu/parallel/
# tcpstore.py): the TCP client and server fire three sites so every
# socket-level edge of the store protocol is deterministically
# reachable —
#   rpc     — fired by the CLIENT before each RPC send ("raise" at
#             occurrence k == the connection dying under exactly the
#             k-th RPC: the client's framing layer sees a dead socket,
#             reconnects, and surfaces only TransientStoreError;
#             "blackhole" == the network eats the request — nothing is
#             sent and the client's IO deadline expires into the same
#             transient path; "stall" with `seconds` == a slow link);
#   connect — fired by the CLIENT on each (re)connect attempt ("raise"
#             == connection refused: the coordinator is down or still
#             restarting; the bounded jittered backoff rides it);
#   reply   — fired by the SERVER before each reply frame ("torn" ==
#             half the response frame is written and the connection
#             killed, so the client's torn-frame detection fires BY
#             NAME; "crash" == the coordinator process dies mid-reply
#             — the whole server aborts, nothing else is sent, and a
#             test restarts it from the WAL; "raise" == this one
#             connection is dropped without a reply; "blackhole" ==
#             the reply never comes and the client times out).
STORE_POINTS = ("rpc", "connect", "reply")


def store_site(point: str) -> str:
    """Canonical fault-site name for the TCP control-plane store — one
    of the three socket-level injection points above.  Central so
    tests, the TCPStore client/server, and FaultPlan schedules can
    never drift on spelling."""
    if point not in STORE_POINTS:
        raise ValueError(f"unknown store fault point {point!r} "
                         f"(one of {STORE_POINTS})")
    return f"store.{point}"


def peer_site(rank: int, point: str) -> str:
    """Canonical fault-site name for elastic-training worker ``rank`` —
    one of the three per-worker injection points above (crash / stall /
    late-joiner scenarios per the point docs).  Central so tests, the
    ElasticWorker loop, and FaultPlan schedules can never drift on
    spelling."""
    if point not in PEER_POINTS:
        raise ValueError(f"unknown peer fault point {point!r} "
                         f"(one of {PEER_POINTS})")
    return f"peer{rank}.{point}"


def replica_site(idx: int, point: str) -> str:
    """Canonical fault-site name for serving-fleet replica ``idx`` —
    one of the three per-replica injection points above.  Central so
    tests, the Replica host, and FaultPlan schedules can never drift on
    spelling."""
    if point not in REPLICA_POINTS:
        raise ValueError(f"unknown replica fault point {point!r} "
                         f"(one of {REPLICA_POINTS})")
    return f"replica{idx}.{point}"


class InjectedFault(RuntimeError):
    """A fault deliberately injected by an installed FaultPlan."""


class InjectedCrash(InjectedFault):
    """Models the process dying at a chosen instant (e.g. between a
    checkpoint tmp write and its rename).  Tests abandon the failing
    instance when they catch this — nothing after the raise point ran,
    exactly as if the host had been preempted there."""


@dataclasses.dataclass
class Fault:
    """One scheduled failure: the ``at``-th call of ``site`` (0-based,
    plan-local count) triggers ``kind``.  ``seconds`` is the stall
    duration for ``kind='stall'``."""

    site: str
    at: int
    kind: str = "raise"
    seconds: float = 0.0
    fired: bool = dataclasses.field(default=False, compare=False)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(one of {KINDS})")
        if self.at < 0:
            raise ValueError(f"fault occurrence index must be >= 0, "
                             f"got {self.at}")


class FaultPlan:
    """A deterministic schedule of failures (see module docstring).

    Build with the fluent :meth:`at` (or :meth:`random` for a seeded
    schedule), then either ``with plan:`` to arm the product-code sites
    for a block, or hand it to :class:`LoaderFaults` for data-boundary
    faults (the wrapper consults the plan directly — no install
    needed).  ``plan.log`` records every fault that actually fired, in
    order, so tests assert the scenario ran as scripted.
    """

    def __init__(self, faults: Iterable[Fault] = ()):
        self.faults: list[Fault] = list(faults)
        self.log: list[tuple[str, int, str]] = []
        self._counts: dict[str, int] = defaultdict(int)

    # ---- schedule construction ---------------------------------------

    def at(self, site: str, at: int, kind: str = "raise",
           seconds: float = 0.0) -> "FaultPlan":
        """Schedule ``kind`` at the ``at``-th occurrence of ``site``."""
        self.faults.append(Fault(site, at, kind, seconds))
        return self

    @classmethod
    def random(cls, seed: int, site: str, n_steps: int, rate: float,
               kind: str = "nan") -> "FaultPlan":
        """Seeded random schedule: each of ``n_steps`` occurrences of
        ``site`` fails independently with probability ``rate``.  Same
        seed, same schedule — the harness stays deterministic even when
        the failure pattern is 'random'."""
        rng = np.random.default_rng(seed)
        plan = cls()
        for i in np.nonzero(rng.random(n_steps) < rate)[0]:
            plan.at(site, int(i), kind)
        return plan

    # ---- firing -------------------------------------------------------

    def fire(self, site: str) -> Optional[Fault]:
        """Record one occurrence of ``site``; trigger any fault scheduled
        for it.  Control-flow kinds (raise/crash/sigterm/sigkill/stall)
        trigger here; data kinds (``nan``, ``blackhole``, ``torn``) are
        returned for the caller — e.g. :class:`LoaderFaults` poisons its
        payload on ``nan``, a fleet Replica's probe reports no-answer on
        ``blackhole``, the TCP store server tears a reply frame on
        ``torn``."""
        i = self._counts[site]
        self._counts[site] += 1
        for f in self.faults:
            if f.site == site and f.at == i and not f.fired:
                f.fired = True
                self.log.append((site, i, f.kind))
                if f.kind in ("raise", "crash"):
                    err = InjectedCrash if f.kind == "crash" else \
                        InjectedFault
                    raise err(f"injected {f.kind} at {site}#{i}")
                if f.kind == "sigterm":
                    os.kill(os.getpid(), signal.SIGTERM)
                elif f.kind == "sigkill":
                    # real, uncatchable process death — the subprocess
                    # elastic drills use this for a worker that
                    # genuinely vanishes (no atexit, no flush, no
                    # goodbye on its sockets)
                    os.kill(os.getpid(), signal.SIGKILL)
                elif f.kind == "stall":
                    time.sleep(f.seconds)
                return f
        return None

    # ---- arming the product-code sites -------------------------------

    def install(self) -> "FaultPlan":
        global _PLAN
        _PLAN = self
        return self

    def uninstall(self) -> None:
        global _PLAN
        if _PLAN is self:
            _PLAN = None

    def __enter__(self) -> "FaultPlan":
        return self.install()

    def __exit__(self, *exc) -> bool:
        self.uninstall()
        return False


_PLAN: Optional[FaultPlan] = None


def fire(site: str) -> Optional[Fault]:
    """The product-code hook: a no-op unless a plan is installed.

    Sites live in checkpoint-critical windows (module docstring); the
    uninstalled cost is one global read and an ``is None`` check, so the
    hook stays in production builds — the harness tests the *same* code
    that ships, not an instrumented twin.  Data kinds (``nan`` /
    ``blackhole`` / ``torn``) are returned to the caller, exactly like
    :meth:`FaultPlan.fire` — the TCP store consults the returned fault
    to decide whether to eat a request or tear a reply frame."""
    if _PLAN is not None:
        return _PLAN.fire(site)
    return None


def poison_batch(batch: dict) -> dict:
    """NaN-fill every float array or tensor of a batch (ints — labels,
    tokens — pass through); a tensor stays on its device.  A NaN input
    makes the step's loss and gradients non-finite *on the device*,
    which is exactly what the step anomaly guard must catch — no
    host-side shortcut."""
    def poison(v):
        if isinstance(v, torch.Tensor):
            return torch.full_like(v, float("nan")) \
                if v.is_floating_point() else v
        return (np.full_like(v, np.nan)
                if np.issubdtype(np.asarray(v).dtype, np.floating) else v)
    return {k: poison(v) for k, v in batch.items()}


class LoaderFaults:
    """Loader wrapper injecting faults at chosen global batch yields.

    Delegates the loader protocol (``set_epoch`` / ``__len__`` /
    ``iter_from`` / ``batch_size``) so it drops into every loop flavor,
    including mid-epoch resume.  The occurrence counter is the plan's
    ``site`` count across the wrapper's whole life — epoch boundaries
    and resume replays do NOT reset it, so an injected burst is
    transient: a rollback that replays the same batch indices sees
    clean data, the way a real NaN burst or preemption doesn't replay
    itself.
    """

    def __init__(self, loader, plan: FaultPlan, site: str = "loader"):
        self.loader = loader
        self.plan = plan
        self.site = site

    # ---- loader protocol ---------------------------------------------

    @property
    def batch_size(self):
        return self.loader.batch_size

    def set_epoch(self, epoch: int) -> None:
        self.loader.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self):
        return self._gen(iter(self.loader))

    def iter_from(self, start_batch: int):
        return self._gen(self.loader.iter_from(start_batch))

    # ---- injection ----------------------------------------------------

    def _gen(self, it):
        for batch in it:
            fault = self.plan.fire(self.site)  # may raise / kill / stall
            if fault is not None and fault.kind == "nan":
                batch = poison_batch(batch)
            yield batch
