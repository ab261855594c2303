"""Serving telemetry, the port of dtdl_tpu/serve/metrics.py for the
counters the ported scheduler touches (the fleet's, the spill tiers' and
the tenants' wait for their slices).

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

# the terminal error kinds (``req.error`` is "<kind>: <reason>").  The
# accounting invariant: submitted == finished + rejected + expired +
# failed + aborted + shed, every request counted once
ERROR_KINDS = ("rejected", "expired", "failed", "aborted", "shed")


class ServeMetrics:
    """Scheduler-driven serving telemetry."""

    def __init__(self, n_slots: int = 0):
        self.queue = MetricsQueue()
        self.n_slots = n_slots
        self.n_submitted = 0
        self.n_rejected = 0
        self.n_expired = 0      # deadline watchdog retirements
        self.n_failed = 0       # engine-failure containment retirements
        self.n_aborted = 0      # cancelled, or cut by shutdown
        self.n_shed = 0
        self.n_admitted = 0
        self.n_finished = 0
        self.n_decode_steps = 0
        self.decode_slot_steps = 0
        self.decode_tokens_delivered = 0
        self.prefill_tokens = 0
        # chunked prefill: chunks dispatched and their prompt tokens, and
        # the decode slots a blocking whole-prompt prefill stalled
        self.n_prefill_chunks = 0
        self.n_chunk_tokens = 0
        self.n_decode_steps_delayed = 0
        # speculative decoding: verify steps (by draft width), drafted and
        # accepted candidates (known at harvest), and the host time spent
        # inside DraftSource.propose, the draft's cost against its win
        self.n_verify_steps = 0
        self.verify_steps_by_k: dict[int, int] = {}
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.draft_s = 0.0
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

    def on_failure(self, req):
        """Engine-failure containment: the request was in flight when a
        step raised, and retired ``failed:``."""
        self.n_failed += 1

    def on_abort(self, req):
        """A submitted request cancelled by rid or cut by shutdown: a
        deliberate abort, kept apart from ``requests_failed`` (engine
        health); ``on_submit`` counted it already."""
        self.n_aborted += 1

    def on_shed(self, req):
        self.n_shed += 1

    def on_chunk(self, tokens: int):
        """One prefill chunk of ``tokens`` prompt tokens dispatched in a
        step shared with the in-flight decodes."""
        self.n_prefill_chunks += 1
        self.n_chunk_tokens += tokens

    def on_prefill_block(self, n_decoding: int):
        """One blocking whole-prompt prefill dispatched while
        ``n_decoding`` slots were mid-decode, each of which waits for it;
        zero under chunked prefill."""
        self.n_decode_steps_delayed += n_decoding

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
        first token, sampled by prefill, excluded): every generated token
        counts once, accepted from a draft or plainly decoded."""
        self.decode_tokens_delivered += n

    def on_draft(self, seconds: float):
        """One drafting phase's host time (the drafted and accepted counts
        land at harvest, :meth:`on_spec_harvest`)."""
        self.draft_s += seconds

    def on_verify(self, k: int):
        """One verify step dispatched at draft width ``k``."""
        self.n_verify_steps += 1
        self.verify_steps_by_k[k] = self.verify_steps_by_k.get(k, 0) + 1

    def on_spec_harvest(self, drafted: int, accepted: int):
        """One slot's verify outcome, known at harvest: ``drafted``
        candidates were scored and ``accepted`` of them survived."""
        self.spec_drafted += drafted
        self.spec_accepted += accepted

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
            "requests_failed": self.n_failed,
            "requests_aborted": self.n_aborted,
            "requests_shed": self.n_shed,
            "requests_finished": self.n_finished,
            "prefill_tokens": self.prefill_tokens,
            "prefill_chunks": self.n_prefill_chunks,
            "chunk_tokens": self.n_chunk_tokens,
            "decode_steps_delayed_by_prefill": self.n_decode_steps_delayed,
            "decode_steps": self.n_decode_steps,
            "decode_tokens": tokens,
            "wall_s": wall,
            "decode_tokens_per_sec": tokens / wall if wall > 0 else 0.0,
            "tokens_per_step_mean": (tokens / self.n_decode_steps
                                     if self.n_decode_steps else 0.0),
            "prefix_hit_rate": (self.prefix_hit_pages / self.prefix_full_pages
                                if self.prefix_full_pages else 0.0),
            "prefix_hit_pages": self.prefix_hit_pages,
            "prefill_tokens_saved": self.prefill_tokens_saved,
            "pages_in_use_peak": self.pages_in_use_peak,
            "pages_in_use_last": self.pages_in_use_last,
            "page_capacity": self.page_capacity,
            "spec_steps": self.n_verify_steps,
            "spec_steps_by_k": dict(self.verify_steps_by_k),
            "spec_drafted_tokens": self.spec_drafted,
            "spec_accepted_tokens": self.spec_accepted,
            "spec_acceptance_rate": (self.spec_accepted / self.spec_drafted
                                     if self.spec_drafted else 0.0),
            "draft_s": self.draft_s,
            "occupancy_mean": occ_mean / self.n_slots if self.n_slots else 0.0,
            "ttft_s_mean": 0.0, "tok_latency_s_mean": 0.0,
            **self.ttft_hist.summary("ttft_s_"),
            **self.tok_latency_hist.summary("tok_latency_s_"),
        }
