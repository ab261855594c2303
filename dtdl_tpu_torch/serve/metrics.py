"""Serving telemetry, the port of dtdl_tpu/serve/metrics.py for the
counters this slice touches.

Nothing here reads the device.  Dispatch-side counters (admissions,
steps, occupancy) are host state the scheduler already has; request
timing (TTFT, per-token latency) is stamped when a token reaches the host
through the lag harvest, so with ``harvest_lag=k`` it runs up to k steps
late and ``Scheduler.drain`` settles it; throughput is wall clock from the
first admission to the last harvest.  Tails come from fixed-memory
:class:`~dtdl_tpu_torch.obs.hist.LogHistogram`\\ s.
"""

from __future__ import annotations

import time

from dtdl_tpu_torch.metrics.device import MetricsQueue
from dtdl_tpu_torch.obs.hist import LogHistogram

# the terminal error kinds this slice's scheduler gives (``req.error``
# starts with one of them); failed/aborted come with containment, cancel
# and shutdown, ROADMAP A6
ERROR_KINDS = ("rejected", "expired", "shed")


class ServeMetrics:
    """Scheduler-driven serving telemetry."""

    def __init__(self, n_slots: int = 0):
        self.queue = MetricsQueue()
        self.n_slots = n_slots
        self.n_submitted = 0
        self.n_rejected = 0
        self.n_expired = 0
        self.n_shed = 0
        self.n_admitted = 0
        self.n_finished = 0
        self.n_decode_steps = 0
        self.decode_slot_steps = 0
        self.decode_tokens_delivered = 0
        self.prefill_tokens = 0
        self.prefix_hit_pages = 0
        self.prefix_full_pages = 0
        self.prefill_tokens_saved = 0
        self.pages_in_use_peak = 0
        self.pages_in_use_last = 0
        self.page_capacity = 0
        self.ttft_hist = LogHistogram()
        self.tok_latency_hist = LogHistogram()
        self._t_start = None
        self._t_last_harvest = None
        self._occupancy: list[dict] = []

    # ---- scheduler hooks ---------------------------------------------

    def on_submit(self, req):
        self.n_submitted += 1

    def on_reject(self, req):
        self.n_submitted += 1
        self.n_rejected += 1

    def on_expire(self, req):
        self.n_expired += 1

    def on_shed(self, req):
        self.n_shed += 1

    def on_prefix(self, hit_pages: int, full_pages: int, tokens_saved: int):
        self.prefix_hit_pages += hit_pages
        self.prefix_full_pages += full_pages
        self.prefill_tokens_saved += tokens_saved

    def on_pages(self, pages_in_use: int, capacity: int):
        self.pages_in_use_last = pages_in_use
        self.pages_in_use_peak = max(self.pages_in_use_peak, pages_in_use)
        self.page_capacity = capacity

    def on_harvest_tokens(self, n: int):
        """``n`` generated tokens delivered at harvest (the request's
        first token, sampled by prefill, excluded)."""
        self.decode_tokens_delivered += n

    def on_admit(self, req, slot: int, prompt_len: int):
        if self._t_start is None:
            self._t_start = time.perf_counter()
        self.n_admitted += 1
        self.prefill_tokens += prompt_len

    def on_step(self, n_active: int, n_slots: int):
        if n_active:
            self.n_decode_steps += 1
            self.decode_slot_steps += n_active
        self.n_slots = n_slots or self.n_slots
        self._occupancy.extend(self.queue.push({"n_active": float(n_active)}))

    def on_first_token(self, req):
        self._t_last_harvest = time.perf_counter()
        self.ttft_hist.add(self._t_last_harvest - req.t_submit)

    def on_finish(self, req):
        self._t_last_harvest = time.perf_counter()
        self.n_finished += 1
        n_decoded = len(req.tokens) - 1
        if n_decoded > 0:
            self.tok_latency_hist.add((req.t_done - req.t_first) / n_decoded)

    # ---- aggregation --------------------------------------------------

    def summary(self) -> dict:
        """Aggregate; call after ``Scheduler.drain`` (or ``run``)."""
        self._occupancy.extend(self.queue.drain())
        wall = 0.0
        if self._t_start is not None and self._t_last_harvest is not None:
            wall = self._t_last_harvest - self._t_start
        occ = [e["n_active"] for e in self._occupancy]
        occ_mean = sum(occ) / len(occ) if occ else 0.0
        tokens = self.decode_tokens_delivered
        return {
            "requests_submitted": self.n_submitted,
            "requests_rejected": self.n_rejected,
            "requests_expired": self.n_expired,
            "requests_shed": self.n_shed,
            "requests_finished": self.n_finished,
            "prefill_tokens": self.prefill_tokens,
            "decode_steps": self.n_decode_steps,
            "decode_tokens": tokens,
            "wall_s": wall,
            "decode_tokens_per_sec": tokens / wall if wall > 0 else 0.0,
            "prefix_hit_rate": (self.prefix_hit_pages / self.prefix_full_pages
                                if self.prefix_full_pages else 0.0),
            "prefix_hit_pages": self.prefix_hit_pages,
            "prefill_tokens_saved": self.prefill_tokens_saved,
            "pages_in_use_peak": self.pages_in_use_peak,
            "pages_in_use_last": self.pages_in_use_last,
            "page_capacity": self.page_capacity,
            "occupancy_mean": occ_mean / self.n_slots if self.n_slots else 0.0,
            "ttft_s_mean": 0.0, "tok_latency_s_mean": 0.0,
            **self.ttft_hist.summary("ttft_s_"),
            **self.tok_latency_hist.summary("tok_latency_s_"),
        }
