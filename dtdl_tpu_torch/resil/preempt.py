"""Preemption watcher: SIGTERM → durable snapshot → exact resume; the
port's copy of dtdl_tpu/resil/preempt.py.

Spot/preemptible capacity (Varuna/Bamboo-style training economics) and
cluster maintenance both speak the same protocol: the host gets SIGTERM
and a grace window.  The watcher converts the signal into a flag the
training loop polls at step boundaries — never mid-dispatch — so the
response is always a *consistent* snapshot: the Trainer saves (params,
optimizer state, step, epoch, iteration-in-epoch), waits for durability
(which also writes the snapshot's commit marker), and returns with
``trainer.preempted`` set.  ``Trainer.resume()`` in the replacement
process continues bitwise-exactly, mid-epoch included (the loader's
(seed, epoch)-keyed order + ``iter_from`` replay — see
dtdl_tpu_torch/data/loader.py).

Signal handlers are process-global state: the watcher installs via
context manager (or explicit :meth:`install`/:meth:`uninstall`) and
restores the previous handlers on exit, so tests and nested uses
compose.  Handlers can only be installed from the main thread (a Python
``signal`` rule); the flag read is safe from anywhere.
"""

from __future__ import annotations

import signal


class PreemptionWatcher:
    """Latches SIGTERM (by default) into a poll-able flag.

    ``requested`` stays True once set — a second SIGTERM during the
    snapshot must not be lost.  ``count`` says how many arrived.
    """

    def __init__(self, signals=(signal.SIGTERM,)):
        self.signals = tuple(signals)
        self._requested = False
        self.count = 0
        self._old: dict = {}

    # ---- signal plumbing ---------------------------------------------

    def _handler(self, signum, frame):
        del signum, frame
        self._requested = True
        self.count += 1

    def install(self) -> "PreemptionWatcher":
        for s in self.signals:
            self._old[s] = signal.signal(s, self._handler)
        return self

    def uninstall(self) -> None:
        for s, old in self._old.items():
            signal.signal(s, old)
        self._old.clear()

    def __enter__(self) -> "PreemptionWatcher":
        return self.install()

    def __exit__(self, *exc) -> bool:
        self.uninstall()
        return False

    # ---- the poll -----------------------------------------------------

    @property
    def requested(self) -> bool:
        return self._requested

    def clear(self) -> None:
        """Re-arm after a handled preemption (tests; long-lived agents)."""
        self._requested = False
