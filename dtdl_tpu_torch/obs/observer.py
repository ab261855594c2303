"""Observer, the port of dtdl_tpu/obs/observer.py: the one handle every
loop takes for the obs subsystem.

Call sites (train_epoch / evaluate / fit / Trainer / Estimator / Solver /
InferenceEngine / Scheduler / Router) add ~3 lines each:

    obs = observer or NULL_OBSERVER            # default: all no-ops
    step = obs.watch(step, "train_step")       # recompile sentinel
    with obs.span("dispatch"): ...             # tracer phases
    payload.update(obs.window(steps, secs))    # goodput per drained window

Everything composes with the loops' async discipline: spans time host
phases, the goodput meter and the step-time histogram consume only window
numbers the drain already settled, so an Observer never adds a wait for
the card (pinned by the sync-counting tests in tests/test_torch_obs.py).
The sentinel is the shell of JAX's until the port captures graphs (A5).

The default :data:`NULL_OBSERVER` short-circuits every method (shared
nullcontext spans, identity watch, ``{}`` windows), so a loop wired for
observability costs nothing when it is off.
"""

from __future__ import annotations

from typing import Callable, Optional

from dtdl_tpu_torch.obs.goodput import GoodputMeter
from dtdl_tpu_torch.obs.hist import LogHistogram
from dtdl_tpu_torch.obs.recompile import (NULL_SENTINEL, RecompileSentinel)
from dtdl_tpu_torch.obs.trace import NULL_TRACER, Tracer


class Observer:
    """Bundles tracer + recompile sentinel + goodput meter + step-time
    histogram behind one object (see module docstring).

    ``trace``: True / a Tracer for span recording (False = off);
    ``sentinel``: a policy string ('warn' / 'raise' / 'silent'), a
    RecompileSentinel, or None (off);
    ``goodput``: a configured GoodputMeter or None;
    ``trace_path``: where :meth:`save` / :meth:`close` write the Chrome
    trace (also enables tracing when ``trace`` was not given).
    """

    enabled = True

    def __init__(self, trace=None, sentinel="warn",
                 goodput: Optional[GoodputMeter] = None,
                 trace_path: Optional[str] = None):
        if isinstance(trace, (Tracer,)):
            self.tracer = trace
        elif trace or (trace is None and trace_path):
            self.tracer = Tracer()
        else:
            self.tracer = NULL_TRACER
        if isinstance(sentinel, RecompileSentinel):
            self.sentinel = sentinel
        elif sentinel:
            self.sentinel = RecompileSentinel(policy=sentinel)
        else:
            self.sentinel = NULL_SENTINEL
        self.goodput = goodput
        self.trace_path = trace_path
        self.step_time_s = LogHistogram()

    # ---- the four verbs ----------------------------------------------

    def span(self, name: str, **args):
        """Host-phase span (context manager); no-op when tracing is off."""
        return self.tracer.span(name, **args)

    def event(self, name: str, **args) -> None:
        """Zero-duration marker on the trace (e.g. the resil guard's
        ``guard_bad_step`` / ``guard_rollback``, the serve scheduler's
        containment events).  Host-side only, like every verb here."""
        self.tracer.instant(name, **args)

    def flow(self, name: str, fid, phase: str = "step",
             **args) -> None:
        """Chrome-trace flow event (start/step/end) joining spans across
        threads under one correlation id — the serve layers call this
        with the USER request rid so a hedged, failed-over request reads
        as one arrow chain in Perfetto.  No-op when tracing is off."""
        self.tracer.flow(name, fid, phase, **args)

    def request_timeline(self, rid) -> list:
        """All recorded events correlated with user request ``rid``,
        ordered (see :meth:`Tracer.request_timeline`)."""
        return self.tracer.request_timeline(rid)

    def watch(self, fn: Callable, name: str | None = None,
              expected: int = 1) -> Callable:
        """Recompile-sentinel wrap (identity until the port captures
        graphs, ROADMAP A5)."""
        return self.sentinel.watch(fn, name, expected=expected)

    def window(self, steps: int, seconds: float, name: str = "device") ->\
            dict:
        """Account one settled window: feeds the step-time histogram and
        the settled-device trace track, returns the goodput fields to
        merge into the window's reporter payload.  Host floats only."""
        if steps <= 0 or seconds <= 0:
            return {}
        self.step_time_s.add(seconds / steps)
        self.tracer.device_window(name, seconds, steps)
        if self.goodput is None:
            return {}
        return self.goodput.window(steps, seconds)

    def summary(self) -> dict:
        """Run-level rollup: step-time tails, goodput totals, sentinel
        events, trace volume."""
        out = dict(self.step_time_s.summary("step_time_s_"))
        if self.goodput is not None:
            out.update(self.goodput.totals())
        out.update(self.sentinel.summary())
        n = len(self.tracer)
        if n:
            out["trace_events"] = n
        return out

    # ---- lifecycle ----------------------------------------------------

    def save(self, path: Optional[str] = None) -> Optional[str]:
        """Write the Chrome trace (to ``path`` or the configured
        ``trace_path``); returns the path written, or None."""
        path = path or self.trace_path
        if not path or self.tracer is NULL_TRACER:
            return None
        return self.tracer.save(path)

    def close(self) -> None:
        self.save()

    def __enter__(self) -> "Observer":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


class _NullObserver(Observer):
    """The default observer: every verb is a no-op (shared instance)."""

    enabled = False

    def __init__(self):
        super().__init__(trace=False, sentinel=None, goodput=None)

    def window(self, steps: int, seconds: float, name: str = "device") ->\
            dict:
        return {}

    def summary(self) -> dict:
        return {}


NULL_OBSERVER = _NullObserver()
