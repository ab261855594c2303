"""Per-replica health: a four-state machine with a circuit breaker, the
port's own copy of dtdl_tpu/serve/health.py (framework-free host
bookkeeping, carried across unchanged).

The fleet Router (dtdl_tpu_torch/serve/fleet.py) must answer one question
per dispatch -- *is this replica safe to hand work to?* -- from two noisy
signal families:

* **passive signals**, free observations of work already in flight: an
  engine containment (``Scheduler.last_engine_error`` changed), a
  failed attempt completion, a harvest stall (the replica's worker
  heartbeat went stale while it held work), a dead worker thread;
* **active probes**, a periodic lightweight host-side health check
  (thread alive + heartbeat fresh; no device work), which a FaultPlan
  can blackhole to model an unresponsive replica.

The state machine turns those into the dispatch decision::

    HEALTHY --(failure signal)--> SUSPECT --(more failures /
        failed probes)--> EVICTED --(replace)--> DRAINING --> HEALTHY
       ^                     |
       +--(probe recovery)---+                 HEALTHY --(operator
                                    drain)--> DRAINING --> HEALTHY

``SUSPECT`` is the **circuit breaker**: dispatch stops at the *first*
failure signal, strictly before the replica is declared dead, so a sick
replica accumulates at most the work already in flight.  A SUSPECT
replica that answers ``recover_after`` consecutive probes cleanly (and
generates no new failure signals) closes the circuit and returns to
HEALTHY.  ``EVICTED`` is terminal until a lifecycle replace: the Router
fails over its in-flight work and (optionally) restarts it, passing
through ``DRAINING`` -- also the operator state for a rolling restart,
where in-flight work *finishes* rather than failing over.

The machine itself is pure host bookkeeping -- no threads, no clocks
beyond the transition timestamps it records -- so every edge is held by
direct unit tests with injected signals (tests/test_torch_fleet.py), and
the threaded Router layers timing on top.
"""

from __future__ import annotations

import time

HEALTHY = "healthy"
SUSPECT = "suspect"
EVICTED = "evicted"
DRAINING = "draining"
STATES = (HEALTHY, SUSPECT, EVICTED, DRAINING)


class ReplicaHealth:
    """One replica's health state (see module docstring).

    ``suspect_after``: consecutive failure signals (or failed probes)
    that open the circuit HEALTHY → SUSPECT;
    ``evict_after``: additional consecutive failure signals or failed
    probes, while SUSPECT, that declare the replica dead;
    ``recover_after``: consecutive clean probes, while SUSPECT, that
    close the circuit back to HEALTHY.

    ``transitions`` records every edge as ``(t, from, to, reason)`` —
    the receipt the eviction-latency bench and the never-dispatch-to-
    DRAINING tests read.
    """

    def __init__(self, suspect_after: int = 1, evict_after: int = 2,
                 recover_after: int = 2, listener=None):
        for name, v in (("suspect_after", suspect_after),
                        ("evict_after", evict_after),
                        ("recover_after", recover_after)):
            if v < 1:
                raise ValueError(f"{name} must be >= 1, got {v}")
        self.suspect_after = suspect_after
        self.evict_after = evict_after
        self.recover_after = recover_after
        self.state = HEALTHY
        self.fail_streak = 0        # consecutive passive failure signals
        self.probe_fail_streak = 0
        self.probe_ok_streak = 0
        self.transitions: list[tuple[float, str, str, str]] = []
        # optional ``listener(from, to, reason)`` fired on every edge —
        # how the Router's prefix directory learns a replica's pages
        # are no longer worth routing to (round 23)
        self.listener = listener

    @property
    def dispatchable(self) -> bool:
        """The one question the Router asks: only HEALTHY replicas get
        new work — SUSPECT (circuit open), EVICTED, and DRAINING all
        refuse, each for its own reason."""
        return self.state == HEALTHY

    def _to(self, state: str, reason: str) -> None:
        if state != self.state:
            prev = self.state
            self.transitions.append(
                (time.perf_counter(), prev, state, reason))
            self.state = state
            if self.listener is not None:
                self.listener(prev, state, reason)

    # ---- signal intake ------------------------------------------------

    def on_success(self) -> str:
        """A completed attempt with no error: passive evidence of
        health.  Resets the failure streak (so ``suspect_after > 1``
        means *consecutive* failures, not lifetime total) — but never
        closes an open circuit by itself: recovery from SUSPECT goes
        through probes, which test the replica rather than ride on work
        that may have been dispatched before it sickened."""
        if self.state == HEALTHY:
            self.fail_streak = 0
        return self.state

    def on_signal(self, reason: str) -> str:
        """One passive failure signal (containment, failed attempt,
        stall, dead worker).  Opens the circuit after ``suspect_after``
        consecutive signals; evicts after ``evict_after`` more while
        SUSPECT.  EVICTED and DRAINING are absorbing here — an evicted
        replica cannot get sicker, and a draining one is the
        lifecycle's responsibility."""
        if self.state in (EVICTED, DRAINING):
            return self.state
        self.fail_streak += 1
        self.probe_ok_streak = 0
        if self.state == HEALTHY and self.fail_streak >= self.suspect_after:
            self._suspect(reason)
        elif (self.state == SUSPECT
              and self.fail_streak >= self.evict_after):
            self._to(EVICTED, reason)
        return self.state

    def _suspect(self, reason: str) -> None:
        """Enter SUSPECT and restart BOTH failure streaks: eviction
        then needs ``evict_after`` further failures *counted from
        suspicion*, from whichever signal family produces them — a
        replica suspected on a passive stall and confirmed dead by
        probes pays the same confirmation count as one suspected and
        confirmed by a single family (the two counters stay separate
        only so each family's streak remains CONSECUTIVE within
        itself)."""
        self.fail_streak = 0
        self.probe_fail_streak = 0
        self._to(SUSPECT, reason)

    def on_probe(self, ok: bool) -> str:
        """One active probe result.  Clean probes recover a SUSPECT
        replica after ``recover_after`` in a row; failed probes open the
        circuit like any failure signal and, while SUSPECT, evict after
        ``evict_after`` in a row — the probe is the tie-breaker that
        keeps a silently wedged replica (no completions, so no passive
        signals either) from sitting SUSPECT forever."""
        if self.state in (EVICTED, DRAINING):
            return self.state
        if ok:
            self.probe_ok_streak += 1
            self.probe_fail_streak = 0
            if (self.state == SUSPECT
                    and self.probe_ok_streak >= self.recover_after):
                self.fail_streak = 0
                self._to(HEALTHY, f"{self.recover_after} consecutive "
                                  f"clean probes")
        else:
            self.probe_fail_streak += 1
            self.probe_ok_streak = 0
            # same two-stage contract as on_signal — suspect_after
            # failures open the circuit, evict_after MORE (counted from
            # suspicion, see _suspect) confirm the death — and elif, so
            # one probe call can never walk HEALTHY straight to EVICTED
            # (the circuit-breaker window must exist before eviction,
            # whichever signal family fires)
            if (self.state == HEALTHY
                    and self.probe_fail_streak >= self.suspect_after):
                self._suspect(f"{self.probe_fail_streak} failed probes")
            elif (self.state == SUSPECT
                    and self.probe_fail_streak >= self.evict_after):
                self._to(EVICTED, f"{self.probe_fail_streak} failed "
                                  f"probes while suspect")
        return self.state

    # ---- lifecycle edges ----------------------------------------------

    def start_drain(self, reason: str = "drain requested") -> str:
        """Enter DRAINING: no new dispatch; what happens to in-flight
        work is the caller's choice (a rolling restart lets it finish,
        an eviction replacement already failed it over)."""
        self._to(DRAINING, reason)
        return self.state

    def on_restarted(self) -> str:
        """A fresh worker is live behind this slot: streaks reset, back
        to HEALTHY."""
        self.fail_streak = 0
        self.probe_fail_streak = 0
        self.probe_ok_streak = 0
        self._to(HEALTHY, "restarted")
        return self.state

    def __repr__(self):
        return (f"ReplicaHealth(state={self.state}, "
                f"fails={self.fail_streak}, "
                f"probe_fails={self.probe_fail_streak}, "
                f"transitions={len(self.transitions)})")
