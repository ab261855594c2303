"""Bounded in-flight queue of per-step metrics, the port of
dtdl_tpu/metrics/device.py:MetricsQueue.

A loop pushes each step's metric dict (host floats, or 0-d tensors still
on the device) and never converts it inline; an entry is converted to
floats only when backpressure pops it, ``lag`` steps later, or at an
explicit :meth:`drain`, the boundary where the loop wants one sync.
"""

from __future__ import annotations

from collections import deque

DEFAULT_LAG = 8


def to_host(metrics: dict) -> dict:
    """One metric dict's values as Python floats (blocks on device values)."""
    return {k: float(v) for k, v in metrics.items()}


class MetricsQueue:
    """At most ``lag`` metric dicts in flight; older ones convert on push."""

    def __init__(self, lag: int = DEFAULT_LAG):
        if lag < 0:
            raise ValueError(f"lag must be >= 0, got {lag}")
        self.lag = lag
        self._buf: deque = deque()

    def push(self, metrics: dict) -> list:
        """Enqueue one step; returns the dicts popped by backpressure."""
        self._buf.append(metrics)
        out = []
        while len(self._buf) > self.lag:
            out.append(to_host(self._buf.popleft()))
        return out

    def drain(self) -> list:
        """Convert and return everything still in flight, in step order."""
        out = [to_host(m) for m in self._buf]
        self._buf.clear()
        return out
