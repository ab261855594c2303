"""Continuous metrics export, the port's copy of dtdl_tpu/obs/export.py:
boundary-sampled time series, pluggable sinks, and an opt-in Prometheus
scrape endpoint.

A monitor watching a fleet needs the end-of-run ``summary()`` numbers
*continuously*.  The exporter never touches a device value and is only
**sampled at boundaries the loops already own** (the router's pump tick,
a scheduler drain, a trainer's log boundary), so it adds no wait for the
card, and :meth:`MetricsExporter.sample` throttles itself to
``interval_s`` so a hot pump loop costs one clock read per tick.

The pieces:

* **sources** — named callables returning flat metric dicts.  The serve
  layer feeds ``ServeMetrics.window()`` / ``FleetMetrics.window()``
  (counter *increments* since the last sample, tails/gauges at current
  value — see serve/metrics.py), so a series point reads as "what
  happened this window"; cumulative sources (``GoodputMeter.totals``,
  ``StepGuard.summary``) plug in the same way.
* **sinks** — ``write(point)`` receivers.  :class:`JsonlSeriesSink`
  appends one JSON object per sample (the greppable artifact the
  invariant tests read); :class:`PrometheusSink` holds the latest point
  and renders the text exposition format any Prometheus-compatible
  scraper ingests.
* **scrape endpoint** — :meth:`MetricsExporter.serve_http` starts a
  stdlib ``http.server`` thread answering ``GET /metrics`` with the
  latest point (opt-in; port 0 picks a free port).  Pull-based export
  costs nothing between scrapes, and the scrape thread answers from the
  last sampled point: it samples nothing itself.
* **SLO hook** — an attached :class:`~dtdl_tpu_torch.obs.slo.SLOEvaluator`
  runs on every sampled point and its ``slo_*`` fields are merged into
  the same point before the sinks see it, so threshold/burn-rate
  crossings land in the exported series exactly where the triggering
  window does.
"""

from __future__ import annotations

import http.server
import json
import os
import re
import threading
import time
from typing import Callable, Optional

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def prometheus_name(name: str) -> str:
    """Sanitize a field name to the Prometheus metric grammar."""
    name = _NAME_RE.sub("_", name)
    if not name or name[0].isdigit():
        name = "_" + name
    return name


def prometheus_text(point: dict, prefix: str = "dtdl_") -> str:
    """Render one series point as Prometheus text exposition (0.0.4):
    every numeric field becomes a gauge line with the point's timestamp
    in milliseconds.  Window-delta fields are gauges of per-interval
    increments — rate() over them is wrong; sum-over-time is the
    cumulative count."""
    ts_ms = int(point.get("t", time.time()) * 1e3)
    lines = []
    for k, v in sorted(point.items()):
        if k in ("t", "t_mono"):
            continue
        if isinstance(v, bool):
            v = int(v)
        elif not isinstance(v, (int, float)):
            continue
        name = prometheus_name(prefix + k)
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {v} {ts_ms}")
    return "\n".join(lines) + ("\n" if lines else "")


class JsonlSeriesSink:
    """One JSON object per sampled point, appended to ``path`` and
    flushed per write (boundary-rate traffic; a crashed run keeps every
    settled point)."""

    def __init__(self, path: str):
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self.path = path
        self._f = open(path, "a")

    def write(self, point: dict) -> None:
        self._f.write(json.dumps(point) + "\n")
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


class PrometheusSink:
    """Holds the latest point; :meth:`render` is the scrape body."""

    def __init__(self, prefix: str = "dtdl_"):
        self.prefix = prefix
        self.last_point: dict = {}

    def write(self, point: dict) -> None:
        self.last_point = point

    def render(self) -> str:
        return prometheus_text(self.last_point, self.prefix)

    def close(self) -> None:
        pass


class _ScrapeHandler(http.server.BaseHTTPRequestHandler):
    render: Callable[[], str]        # bound by serve_http per server

    def do_GET(self):                # noqa: N802 - stdlib naming
        if self.path.split("?", 1)[0] != "/metrics":
            self.send_error(404)
            return
        body = self.render().encode()
        self.send_response(200)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):        # silence per-request stderr spam
        pass


class MetricsExporter:
    """Boundary-sampled metrics pipeline: sources → (SLO eval) → sinks
    (see module docstring).

    ``interval_s`` is the minimum spacing between snapshots — callers
    invoke :meth:`sample` at every boundary they own and the exporter
    decides which ones become points (``force=True`` bypasses the
    throttle, e.g. for the final snapshot at shutdown).  The exporter
    is host-only and lock-free by design: it is sampled from ONE thread
    (the router pump or the scheduler's drain path); sinks that cross
    threads (the scrape server reads ``PrometheusSink.last_point``)
    exchange a single dict reference, which is atomic in CPython.
    """

    def __init__(self, sinks=(), interval_s: float = 0.25,
                 observer=None, prefix: str = "dtdl_"):
        self.sinks = list(sinks)
        self.interval_s = interval_s
        self.observer = observer
        self.prefix = prefix
        self._sources: list[tuple[str, Callable[[], dict]]] = []
        self.slo = None
        self.last_point: dict = {}
        self.n_snapshots = 0
        self.source_errors = 0
        self.sink_errors = 0
        self._last_t = 0.0
        self._http: Optional[http.server.ThreadingHTTPServer] = None
        self._prom: Optional[PrometheusSink] = None

    # ---- configuration ------------------------------------------------

    def add_source(self, name: str,
                   fn: Callable[[], dict]) -> "MetricsExporter":
        """Register a metrics source; ``name`` prefixes its fields
        (pass "" for sources whose fields are already namespaced, like
        the serve summaries)."""
        self._sources.append((name, fn))
        return self

    def add_sink(self, sink) -> "MetricsExporter":
        self.sinks.append(sink)
        return self

    def attach_slo(self, evaluator) -> "MetricsExporter":
        """Run ``evaluator`` (an :class:`~dtdl_tpu_torch.obs.slo.
        SLOEvaluator`) on every sampled point; its ``slo_*`` fields are
        merged into the point before the sinks write it."""
        self.slo = evaluator
        return self

    def serve_http(self, port: int = 0,
                   host: str = "127.0.0.1") -> int:
        """Opt-in scrape endpoint: GET /metrics returns the latest
        point in Prometheus text format.  Returns the bound port
        (``port=0`` picks a free one).  Daemon thread; idle between
        scrapes."""
        if self._http is not None:
            return self._http.server_address[1]
        if self._prom is None:
            self._prom = PrometheusSink(self.prefix)
            self.sinks.append(self._prom)
        prom = self._prom
        handler = type("Handler", (_ScrapeHandler,),
                       {"render": staticmethod(prom.render)})
        self._http = http.server.ThreadingHTTPServer((host, port),
                                                     handler)
        t = threading.Thread(target=self._http.serve_forever,
                             name="metrics-scrape", daemon=True)
        t.start()
        return self._http.server_address[1]

    @property
    def port(self) -> Optional[int]:
        return self._http.server_address[1] if self._http else None

    # ---- sampling ------------------------------------------------------

    def sample(self, force: bool = False) -> Optional[dict]:
        """Take one snapshot if ``interval_s`` has elapsed (or
        ``force``); returns the point written, or None when throttled.
        Call this only from boundaries the owning loop already settles
        at — the exporter reads host counters, never the device."""
        now = time.perf_counter()
        if not force and now - self._last_t < self.interval_s:
            return None
        self._last_t = now
        point = {"t": time.time(), "t_mono": round(now, 6)}
        for name, fn in self._sources:
            try:
                vals = fn()
            except Exception:
                # a broken source must not take the serving loop (or
                # the other sources) down with it; count and move on
                self.source_errors += 1
                continue
            pre = f"{name}_" if name else ""
            for k, v in vals.items():
                if isinstance(v, bool):
                    point[pre + k] = int(v)
                elif isinstance(v, (int, float)):
                    point[pre + k] = v
        if self.slo is not None:
            point.update(self.slo.evaluate(point, now=now))
        for sink in self.sinks:
            try:
                sink.write(point)
            except Exception:
                # same contract as sources: a sick sink (disk full, a
                # file closed under us) must never take the serving
                # loop down — count it and keep the other sinks fed
                self.sink_errors += 1
        self.last_point = point
        self.n_snapshots += 1
        return point

    # ---- lifecycle -----------------------------------------------------

    def close(self) -> None:
        if self._http is not None:
            self._http.shutdown()
            self._http.server_close()
            self._http = None
        for sink in self.sinks:
            try:
                sink.close()
            except Exception:
                pass

    def __enter__(self) -> "MetricsExporter":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
