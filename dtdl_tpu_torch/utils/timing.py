"""Wall-clock step timing, the port of dtdl_tpu/utils/timing.py.

:class:`StepTimer` tracks per-step time, running averages and the
epoch's elapsed time, in two modes, as the JAX timer:

* ``blocking=True``: ``step(*blockers)`` waits for the card and reads
  the clock every step: exact per-step times, one stall each;
* ``blocking=False``: ``step()`` only counts dispatches; :meth:`sync`,
  called once per log window after its metrics were drained, waits and
  spreads the window's wall time evenly over its steps.

JAX waits on a value (``block_until_ready``); eager PyTorch has no handle
on one kernel's end, so a blocker that is a CUDA tensor makes the timer
``torch.cuda.synchronize()`` its device (every kernel queued before
it ends first).  Host values and CPU tensors are ready as they are.
"""

from __future__ import annotations

import datetime
import time

import torch


def fmt_timedelta(seconds: float) -> str:
    return str(datetime.timedelta(seconds=int(seconds)))


def _block(blockers) -> None:
    for dev in {b.device for b in blockers
                if isinstance(b, torch.Tensor) and b.is_cuda}:
        torch.cuda.synchronize(dev)


class StepTimer:
    """Tracks per-step wall time and epoch elapsed time."""

    def __init__(self, blocking: bool = True):
        self.blocking = blocking
        self.reset_epoch()

    def reset_epoch(self) -> None:
        self.epoch_start = time.perf_counter()
        self._step_start = self.epoch_start
        self.last_step_s = 0.0
        self.total_steps = 0
        self._sum_step_s = 0.0
        # non-blocking window bookkeeping (steps dispatched since last sync)
        self._window_start = self.epoch_start
        self._window_steps = 0

    def step(self, *blockers) -> float:
        """Mark the end of a step; pass device tensors to wait on first.

        Non-blocking mode ignores ``blockers`` and only counts the
        dispatch; the window is settled at the next :meth:`sync`.  The
        return value is the latest known per-step time (stale until
        then)."""
        if not self.blocking:
            self.total_steps += 1
            self._window_steps += 1
            return self.last_step_s
        _block(blockers)
        now = time.perf_counter()
        self.last_step_s = now - self._step_start
        self._step_start = now
        self.total_steps += 1
        self._sum_step_s += self.last_step_s
        # keep the window anchored so a later sync() never double-counts
        self._window_start = now
        self._window_steps = 0
        return self.last_step_s

    def sync(self, *blockers) -> float:
        """Settle the current window: wait on ``blockers``, then average
        the window over its steps.  Returns that per-step average, which
        also becomes :attr:`last_step_s`."""
        _block(blockers)
        now = time.perf_counter()
        if self._window_steps:
            window = now - self._window_start
            self.last_step_s = window / self._window_steps
            self._sum_step_s += window
        self._window_start = now
        self._window_steps = 0
        self._step_start = now
        return self.last_step_s

    @property
    def avg_step_s(self) -> float:
        return self._sum_step_s / max(self.total_steps, 1)

    @property
    def epoch_elapsed_s(self) -> float:
        return time.perf_counter() - self.epoch_start

    @property
    def epoch_elapsed(self) -> str:
        return fmt_timedelta(self.epoch_elapsed_s)
