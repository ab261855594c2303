"""Recompile sentinel, the shell of dtdl_tpu/obs/recompile.py: its event
type, its policies and its rollup.

JAX's sentinel wraps a jitted callable and compares the jit cache's size
before and after each call, so an unexpected retrace becomes a named
:class:`RecompileEvent` under a policy: ``'warn'`` logs through the
``dtdl_tpu_torch`` logger, ``'raise'`` raises :class:`RecompileError`,
``'silent'`` only records, and a callable receives the event.

The port runs eager programs and captures nothing yet, so there is no
cache to count: :meth:`RecompileSentinel.watch` returns every callable
unwrapped, as JAX's does for a callable without ``_cache_size``.  Counting
the port's captures (CUDA graphs per prefill bucket and verify width)
comes with them, ROADMAP queue A5.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable

_log = logging.getLogger("dtdl_tpu_torch")


class RecompileError(RuntimeError):
    """An unexpected retrace under policy='raise'."""


def diff_signatures(old: dict | None, new: dict) -> dict:
    """{path: 'old -> new'} for every leaf that changed (or appeared)."""
    if not old:
        return {}
    out = {}
    for k, v in new.items():
        if old.get(k) != v:
            out[k] = f"{old.get(k, '<absent>')} -> {v}"
    for k in old:
        if k not in new:
            out[k] = f"{old[k]} -> <absent>"
    return out


@dataclasses.dataclass
class RecompileEvent:
    """One unexpected retrace."""
    name: str
    n_compiles: int            # total traces of this fn since watch()
    cache_size: int            # cache entries after this call
    signature: dict            # the signature that (re)traced
    diff: dict                 # vs the signature that compiled before

    def message(self) -> str:
        changed = ("; ".join(f"{k}: {v}" for k, v in self.diff.items())
                   or "signature change outside shapes/dtypes "
                      "(static arg / tree structure)")
        return (f"unexpected retrace #{self.n_compiles} of "
                f"{self.name!r} (jit cache now {self.cache_size} "
                f"entries) — changed args: {changed}")


class RecompileSentinel:
    """Collects :class:`RecompileEvent` s under a policy (see module
    docstring); events accumulate on :attr:`events` whatever the policy."""

    def __init__(self, policy: str | Callable = "warn"):
        if not callable(policy) and policy not in ("warn", "raise",
                                                   "silent"):
            raise ValueError(f"policy must be 'warn', 'raise', 'silent' "
                             f"or callable, got {policy!r}")
        self.policy = policy
        self.events: list[RecompileEvent] = []

    def watch(self, fn: Callable, name: str | None = None,
              expected: int = 1) -> Callable:
        """``fn`` unwrapped: the port has no compile cache to watch
        before A5 (JAX returns a callable without ``_cache_size`` the
        same way)."""
        return fn

    def _fire(self, event: RecompileEvent) -> None:
        self.events.append(event)
        if callable(self.policy):
            self.policy(event)
        elif self.policy == "warn":
            _log.warning("%s", event.message())
        elif self.policy == "raise":
            raise RecompileError(event.message())

    def summary(self) -> dict:
        return {"recompile_events": len(self.events),
                "recompiled_fns": sorted({e.name for e in self.events})}


class NullSentinel:
    """Disabled sentinel: watch() is identity, nothing records."""

    events: list = []

    def watch(self, fn: Callable, name: str | None = None,
              expected: int = 1) -> Callable:
        return fn

    def summary(self) -> dict:
        return {}


NULL_SENTINEL = NullSentinel()
