"""Serving telemetry, the port of dtdl_tpu/serve/metrics.py: the
scheduler's counters, the KV handoff and spill-tier ledgers the fleet and
the tiers feed, the tenants' ledgers (delivered tokens by adapter, draft
tokens a grammar trimmed, stream deliveries), and
:meth:`ServeMetrics.window`, the delta feed.

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

# the kinds that count against availability: failed (engine or replica
# health) and expired (the service blew the deadline) are service faults;
# rejected and shed are load management, aborted a caller's decision
UNAVAILABLE_KINDS = ("failed", "expired")


def error_kind(error) -> str | None:
    """The kind prefix of a terminal ``req.error`` (one of
    :data:`ERROR_KINDS`), or None for no error or an unprefixed string."""
    if not error:
        return None
    kind = error.split(":", 1)[0]
    return kind if kind in ERROR_KINDS else None


def _window_delta(summary: dict, counters, prev: dict) -> dict:
    """Flatten ``summary`` to numeric scalars, each field in ``counters``
    replaced by its increment since the last call (state in ``prev``,
    updated in place).  Gauges and tails pass through at their current
    value, bools become 0/1, nested dicts and lists are dropped but for a
    dict-valued counter, which flattens to ``<field>.<key>`` deltas."""
    out = {}
    for k, v in summary.items():
        if isinstance(v, bool):
            out[k] = int(v)
        elif isinstance(v, (int, float)):
            out[k] = v - prev.get(k, 0) if k in counters else v
        elif isinstance(v, dict) and k in counters:
            for kk, vv in v.items():
                if isinstance(vv, (int, float)):
                    fk = f"{k}.{kk}"
                    out[fk] = vv - prev.get(fk, 0)
                    prev[fk] = vv
    prev.update({k: summary[k] for k in counters
                 if isinstance(summary.get(k), (int, float))})
    return out


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
        # prefill/decode disaggregation: pages handed over (extracted on
        # a prefill replica, injected on a decode one) and the host
        # seconds of each side, the extract's one sync included
        self.n_kv_handoff_pages = 0
        self.kv_handoff_s = 0.0
        self.kv_handoff_hist = LogHistogram()
        # the spill tiers: pages extracted to host or disk on eviction,
        # pages restored on a prefix miss, their bytes and host seconds,
        # hits by tier, disk records quarantined; fleet affinity hits
        self.pages_spilled = 0
        self.spill_bytes = 0
        self.spill_s = 0.0
        self.pages_restored = 0
        self.restore_bytes = 0
        self.restore_s = 0.0
        self.spill_host_hits = 0
        self.spill_disk_hits = 0
        self.spill_quarantined = 0
        self.directory_hits = 0
        # tenancy: delivered generated tokens keyed by adapter name
        # ("base" = no adapter), draft tokens the grammar automaton
        # trimmed before verify, tokens pushed through TokenStreams
        self.tokens_by_adapter: dict[str, int] = {}
        self.grammar_rejected_tokens = 0
        self.stream_deliveries = 0
        self._win_prev: dict = {}
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

    def on_kv_handoff(self, pages: int, seconds: float):
        """One side of a prefill-to-decode page migration: ``pages`` moved
        (extracted at the source or injected at the target) in
        ``seconds`` of host time; the extract's wait for the card is the
        one deliberate sync of the disaggregation path."""
        self.n_kv_handoff_pages += pages
        self.kv_handoff_s += seconds
        self.kv_handoff_hist.add(seconds)

    def on_spill(self, pages: int, nbytes: int, seconds: float):
        """One batched spill on eviction: ``pages`` evicted pages
        extracted to the host tier in one sync of ``seconds``, ``nbytes``
        moved."""
        self.pages_spilled += pages
        self.spill_bytes += nbytes
        self.spill_s += seconds

    def on_restore(self, pages: int, nbytes: int, seconds: float,
                   host_hits: int = 0, disk_hits: int = 0):
        """One admission's restore from the spill tiers: ``pages`` pages
        re-entered the arena by inject (no sync), their prompt tokens not
        recomputed; ``host_hits``/``disk_hits`` split them by tier."""
        self.pages_restored += pages
        self.restore_bytes += nbytes
        self.restore_s += seconds
        self.spill_host_hits += host_hits
        self.spill_disk_hits += disk_hits

    def on_spill_quarantine(self, n: int):
        """``n`` disk spill records failed their integrity check and were
        quarantined by name (their prefixes are recomputed)."""
        self.spill_quarantined += n

    def on_directory_hit(self):
        """The fleet's prefix directory routed a request here, to the
        replica holding its prefix."""
        self.directory_hits += 1

    def on_prefix(self, hit_pages: int, full_pages: int, tokens_saved: int):
        self.prefix_hit_pages += hit_pages
        self.prefix_full_pages += full_pages
        self.prefill_tokens_saved += tokens_saved

    def on_pages(self, pages_in_use: int, capacity: int):
        self.pages_in_use_last = pages_in_use
        self.pages_in_use_peak = max(self.pages_in_use_peak, pages_in_use)
        self.page_capacity = capacity

    def on_adapter_tokens(self, adapter: str, n: int):
        """``n`` generated tokens harvested for a request served under
        ``adapter`` (``"base"`` when none): the per-tenant split of the
        same harvested-truth accounting as :meth:`on_harvest_tokens`."""
        self.tokens_by_adapter[adapter] = \
            self.tokens_by_adapter.get(adapter, 0) + n

    def on_grammar_reject(self, n: int):
        """``n`` draft tokens trimmed at dispatch because the grammar
        automaton refuses them."""
        self.grammar_rejected_tokens += n

    def on_stream(self, n: int):
        """``n`` tokens delivered through a request's TokenStream at one
        lag-harvest boundary."""
        self.stream_deliveries += n

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
            "kv_handoff_pages": self.n_kv_handoff_pages,
            "kv_handoff_s": self.kv_handoff_s,
            "pages_spilled": self.pages_spilled,
            "pages_restored": self.pages_restored,
            "spill_bytes": self.spill_bytes,
            "restore_bytes": self.restore_bytes,
            "spill_s": self.spill_s,
            "restore_s": self.restore_s,
            "spill_host_hits": self.spill_host_hits,
            "spill_disk_hits": self.spill_disk_hits,
            "spill_quarantined": self.spill_quarantined,
            "directory_hits": self.directory_hits,
            "tokens_by_adapter": dict(self.tokens_by_adapter),
            "grammar_rejected_tokens": self.grammar_rejected_tokens,
            "stream_deliveries": self.stream_deliveries,
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
            **self.kv_handoff_hist.summary("kv_handoff_s_"),
        }

    # the monotonic summary fields window() diffs; rates, occupancy,
    # tails and page gauges pass through at their current value
    _WINDOW_COUNTERS = frozenset({
        "requests_submitted", "requests_rejected", "requests_expired",
        "requests_failed", "requests_aborted", "requests_finished",
        "requests_shed", "prefill_tokens", "decode_steps",
        "decode_tokens", "prefill_tokens_saved", "spec_drafted_tokens",
        "spec_accepted_tokens", "spec_steps", "draft_s", "prefill_chunks",
        "chunk_tokens", "decode_steps_delayed_by_prefill",
        "kv_handoff_pages", "kv_handoff_s", "pages_spilled",
        "pages_restored", "spill_bytes", "restore_bytes", "spill_s",
        "restore_s", "spill_host_hits", "spill_disk_hits",
        "spill_quarantined", "directory_hits", "tokens_by_adapter",
        "grammar_rejected_tokens", "stream_deliveries",
    })

    def window(self) -> dict:
        """Counters since the last :meth:`window` call (increments) with
        the numeric gauges, rates and tails at their current value,
        non-scalar fields dropped: the delta feed an exporter samples at
        the drain and harvest boundaries.  :meth:`summary` is untouched."""
        return _window_delta(self.summary(), self._WINDOW_COUNTERS,
                             self._win_prev)
