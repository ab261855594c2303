"""SLO layer, the port's copy of dtdl_tpu/obs/slo.py: declarative
targets, error budgets, burn-rate alerts.

The obs stack measures (tails, counters, goodput); this module judges,
with the standard SRE construction: a declarative objective, a rolling
evaluation window, and an **error budget** (the fraction of badness the
target tolerates) whose consumption rate, the "burn rate", is the alert
signal.

Two objective shapes, both evaluated on the exported series points the
:class:`~dtdl_tpu_torch.obs.export.MetricsExporter` feeds through
:class:`SLOEvaluator` (so evaluation happens exactly at the sampling
boundaries, never waits for the card, and its verdict fields land in the same
exported point as the window that triggered them):

* **gauge SLOs** — a threshold on an exported field, e.g. TTFT p99
  ≤ 0.5 s from the existing fixed-memory
  :class:`~dtdl_tpu_torch.obs.hist.LogHistogram` tails, or an
  acceptance-rate floor.  ``burn = value / target`` (inverted for
  ``>=`` objectives) — 1.0 is the line.
* **ratio SLOs** — good/bad *counter increments* (the
  ``window()`` delta fields from serve/metrics.py) accumulated over a
  rolling ``window_s``, e.g. availability ≥ 99.9% with bad =
  failed + expired (the :data:`~dtdl_tpu_torch.serve.metrics.
  UNAVAILABLE_KINDS` classification — load-shedding rejections are
  deliberate and do not burn the budget).  ``burn = error_rate /
  (1 - target)`` — burn 1.0 means the budget is being consumed exactly
  at the rate that exhausts it at the window's end; a 100%-outage
  window at target 99.9% burns at 1000x.

Crossings are emitted twice, by design: as trace events
(``slo_breach`` / ``slo_burn_rate`` / ``slo_recovered`` — they land on
the timeline next to the evictions/retries that caused them) and as
``slo_*`` exported series fields (a monitor needs no trace parser).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Optional, Sequence

# burn rates are clamped here: a zero denominator (a >= objective
# collapsing to value 0, a <= objective with target 0) reads "maximal
# burn", and a finite cap keeps every exported point strict-JSON
# (json.dumps would otherwise emit the literal `Infinity`, which RFC
# 8259 consumers reject)
BURN_CAP = 1e6


class SLO:
    """One declarative objective (see module docstring).

    Gauge mode: ``SLO("ttft_p99", metric="fleet_ttft_s_p99", op="<=",
    target=0.5)`` — judged on the exported field's current value.
    Ratio mode: ``SLO("availability", good="fleet_requests_finished",
    bad=("fleet_requests_failed", "fleet_requests_expired"),
    target=0.999)`` — judged on counter increments over a rolling
    ``window_s``.  ``burn_alert`` is the burn-rate crossing threshold
    (1.0 = budget consumed exactly as fast as it accrues).
    """

    def __init__(self, name: str, metric: Optional[str] = None,
                 op: str = "<=", target: float = None,
                 good: Optional[str] = None,
                 bad: Optional[Sequence[str] | str] = None,
                 window_s: float = 10.0, burn_alert: float = 1.0,
                 gate: Optional[str] = None):
        if target is None:
            raise ValueError(f"SLO {name!r} needs a target")
        gauge = metric is not None
        ratio = good is not None or bad is not None
        if gauge == ratio:
            raise ValueError(
                f"SLO {name!r}: pass exactly one of metric= (gauge "
                f"threshold) or good=/bad= (rolling ratio)")
        if gauge and op not in ("<=", ">="):
            raise ValueError(f"SLO {name!r}: op must be '<=' or '>=', "
                             f"got {op!r}")
        if ratio:
            if not (good and bad):
                raise ValueError(f"SLO {name!r}: ratio mode needs both "
                                 f"good= and bad= fields")
            if not 0.0 < target < 1.0:
                raise ValueError(f"SLO {name!r}: a ratio target must be "
                                 f"in (0, 1), got {target}")
        self.name = name
        self.metric = metric
        self.op = op
        self.target = float(target)
        self.good = good
        self.bad = ((bad,) if isinstance(bad, str) else tuple(bad or ()))
        self.window_s = window_s
        self.burn_alert = burn_alert
        # gate: skip judgment on points where this field is absent or
        # zero — for objectives over rates whose input field is ALWAYS
        # exported (e.g. spec_acceptance_rate is 0.0 in every window
        # even with speculation off; gating on spec_drafted_tokens
        # judges only windows that actually drafted)
        self.gate = gate
        self.ok: Optional[bool] = None      # None until first verdict
        self.alerting = False               # burn-rate crossing latch
        self.breaches = 0
        self.burn_crossings = 0
        self._events: deque = deque()       # ratio mode: (t, good, bad)

    # ---- evaluation ----------------------------------------------------

    def _verdict(self, point: dict, now: float):
        """(value-ish fields, ok, burn) for this point, or None when
        the input field(s) are absent (no traffic yet) or the gate
        field says the objective does not apply to this window."""
        if self.gate is not None and not point.get(self.gate):
            return None
        if self.metric is not None:
            v = point.get(self.metric)
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                return None
            if self.op == "<=":
                ok = v <= self.target
                burn = (v / self.target if self.target > 0
                        else BURN_CAP if v > 0 else 0.0)
            else:
                ok = v >= self.target
                burn = (self.target / v if v > 0
                        else BURN_CAP if self.target > 0 else 0.0)
            return {"value": round(float(v), 6)}, ok, min(burn, BURN_CAP)
        g = point.get(self.good, 0)
        b = sum(point.get(f, 0) or 0 for f in self.bad)
        if not isinstance(g, (int, float)):
            g = 0
        self._events.append((now, g, b))
        while self._events and now - self._events[0][0] > self.window_s:
            self._events.popleft()
        G = sum(e[1] for e in self._events)
        B = sum(e[2] for e in self._events)
        if G + B <= 0:
            return None                 # no terminal traffic in window
        sli = G / (G + B)
        budget = 1.0 - self.target
        burn = min((1.0 - sli) / budget, BURN_CAP)
        return ({"sli": round(sli, 6), "good": G, "bad": B},
                sli >= self.target, burn)

    def evaluate(self, point: dict, now: float, observer=None) -> dict:
        """Judge one exported point; returns the ``slo_<name>_*``
        fields to merge into it and emits crossing events on the
        observer (ok↔breach transitions and burn-rate latch edges)."""
        verdict = self._verdict(point, now)
        if verdict is None:
            return {}
        fields, ok, burn = verdict
        pre = f"slo_{self.name}_"
        out = {pre + k: v for k, v in fields.items()}
        out[pre + "ok"] = int(ok)
        out[pre + "burn"] = round(burn, 4)
        out[pre + "target"] = self.target
        # state transitions and crossing counters advance UNCONDITIONALLY
        # — an evaluator without an observer still keeps honest books
        # (summary() is the bench/monitor rollup); the observer only
        # decides whether the crossing also lands on a trace
        prev_ok = self.ok
        self.ok = ok
        breached = not ok and prev_ok is not False
        recovered = ok and prev_ok is False
        if breached:
            self.breaches += 1
        crossed = burn >= self.burn_alert and not self.alerting
        if crossed:
            self.alerting = True
            self.burn_crossings += 1
        elif burn < self.burn_alert and self.alerting:
            self.alerting = False
        if observer is not None:
            if breached:
                observer.event("slo_breach", slo=self.name,
                               target=self.target,
                               burn=out[pre + "burn"], **fields)
            elif recovered:
                observer.event("slo_recovered", slo=self.name,
                               target=self.target, **fields)
            if crossed:
                observer.event("slo_burn_rate", slo=self.name,
                               burn=out[pre + "burn"],
                               alert=self.burn_alert, **fields)
        return out


def default_train_slos(step_time_s: Optional[float] = None,
                       bad_step_ratio: Optional[float] = None,
                       window_s: float = 10.0) -> list:
    """The standard *training* objectives — the twin of
    ``serve.fleet.default_fleet_slos`` — declared over the fields a
    trainer-attached exporter samples from ``GoodputMeter.
    export_window()`` (source name ``"goodput"``) and ``StepGuard.
    window()`` (source name ``"guard"``):

    * ``step_time_s`` — mean settled step time ≤ the target, judged on
      ``goodput_step_time_s`` and gated on ``goodput_steps`` so idle
      windows are skipped;
    * ``bad_step_ratio`` — the anomalous-step budget: a rolling
      good/bad ratio over ``guard_good_steps`` / ``guard_bad_steps``
      with target ``1 - bad_step_ratio`` (e.g. 0.01 tolerates 1% bad
      steps; a NaN burst burns the budget at the same burn-rate math
      the serving availability SLO uses).
    """
    slos = []
    if step_time_s is not None:
        slos.append(SLO("step_time", metric="goodput_step_time_s",
                        op="<=", target=step_time_s,
                        gate="goodput_steps"))
    if bad_step_ratio is not None:
        if not 0.0 < bad_step_ratio < 1.0:
            raise ValueError(f"bad_step_ratio must be in (0, 1), got "
                             f"{bad_step_ratio}")
        slos.append(SLO("bad_steps", good="guard_good_steps",
                        bad="guard_bad_steps",
                        target=1.0 - bad_step_ratio, window_s=window_s))
    return slos


class SLOEvaluator:
    """Evaluates a set of :class:`SLO` objectives on each exported
    series point (attach via :meth:`~dtdl_tpu_torch.obs.export.
    MetricsExporter.attach_slo`); crossings go to ``observer`` as trace
    events, verdicts into the point as ``slo_*`` fields."""

    def __init__(self, slos: Sequence[SLO], observer=None):
        names = [s.name for s in slos]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names: {names}")
        self.slos = list(slos)
        self.observer = observer

    def evaluate(self, point: dict, now: Optional[float] = None) -> dict:
        now = time.perf_counter() if now is None else now
        out = {}
        for slo in self.slos:
            out.update(slo.evaluate(point, now, self.observer))
        return out

    def summary(self) -> dict:
        """Flat rollup: per-SLO last verdict + fleet-wide crossing
        counts (the ``slo_*`` bench summary fields)."""
        out = {"slo_breach_events": sum(s.breaches for s in self.slos),
               "slo_burn_crossings": sum(s.burn_crossings
                                         for s in self.slos)}
        for s in self.slos:
            if s.ok is not None:
                out[f"slo_{s.name}_ok"] = int(s.ok)
        return out
