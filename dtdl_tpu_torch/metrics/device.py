"""Bounded in-flight queue of per-step metrics, the port of
dtdl_tpu/metrics/device.py:MetricsQueue.

A loop pushes each step's metric dict (host floats, or 0-d tensors still
on the device) and never converts it inline; an entry is converted to
floats only when backpressure pops it, ``lag`` steps later, or at an
explicit :meth:`drain`, the boundary where the loop wants one sync.

An entry pushed with ``count=k`` holds a bundle of k steps (the
``unroll`` path of :func:`dtdl_tpu_torch.train.loop.train_epoch`): each
value is a ``[k]`` tensor, the steps stacked in order.  It counts as k
toward ``lag`` and converts into k per-step dicts; the floats are
bitwise those the per-step loop reads (the same f32 widened to double).
"""

from __future__ import annotations

from collections import deque

DEFAULT_LAG = 8


def to_host(metrics: dict) -> dict:
    """One metric dict's values as Python floats (blocks on device values)."""
    return {k: float(v) for k, v in metrics.items()}


def _split_stacked(metrics: dict, count: int) -> list:
    """Split a stacked metric dict (each value ``[count]``) into ``count``
    per-step float dicts, in step order: one copy to the host a value."""
    cols = {k: v.detach().cpu().tolist() for k, v in metrics.items()}
    return [{k: float(col[j]) for k, col in cols.items()}
            for j in range(count)]


class MetricsQueue:
    """At most ``lag`` steps in flight; older entries convert on push.

    Entries pushed with ``count=k`` hold stacked metrics for k steps and
    count as k toward the bound."""

    def __init__(self, lag: int = DEFAULT_LAG):
        if lag < 0:
            raise ValueError(f"lag must be >= 0, got {lag}")
        self.lag = lag
        self._buf: deque = deque()
        self._in_flight = 0

    def __len__(self) -> int:
        """Steps currently buffered (a stacked entry counts its width)."""
        return self._in_flight

    def _pop(self) -> list:
        metrics, count = self._buf.popleft()
        self._in_flight -= count
        if count == 1:
            return [to_host(metrics)]
        return _split_stacked(metrics, count)

    def push(self, metrics: dict, count: int = 1) -> list:
        """Enqueue one step (or a ``count``-step bundle); returns the
        per-step dicts popped by backpressure, in step order."""
        self._buf.append((metrics, count))
        self._in_flight += count
        out: list = []
        while self._in_flight > self.lag:
            out.extend(self._pop())
        return out

    def drain(self) -> list:
        """Convert and return everything still in flight, in step order."""
        out: list = []
        while self._buf:
            out.extend(self._pop())
        return out
