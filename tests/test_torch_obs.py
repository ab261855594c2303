"""The port's observability core (``dtdl_tpu_torch.obs``) against the JAX
package's ``dtdl_tpu.obs``, on the CPU.

* **Tracer**: spans nest and export the Chrome trace-event JSON JAX's
  does (the same keys, the window-settled device track); gzip by suffix;
  the event cap counts what it drops; threads write one tracer safely;
  ``SPAN_CATALOG`` and ``EVENT_CATALOG`` equal JAX's sets; ``corr_rid``
  and the process tag behave as JAX's.
* **LogHistogram**: the same samples through both give equal counts,
  percentiles, min/max/mean and summaries; ``merge``, clamping and the
  validation errors are JAX's.
* **FLOPs**: ``lm_train_flops``, ``lm_decode_flops``, ``lm_prefill_flops``,
  ``lm_verify_flops`` and ``lm_rope_hbm_bytes`` equal JAX's on the
  ``tiny`` and ``base`` configs (and a routed-MoE one).
* **GoodputMeter**: the same windows give equal fields, totals and export
  windows.
* **Observer**: the facade's verbs, the null observer and ``save``; the
  sentinel shell's policies and ``summary()`` equal JAX's on the same
  events.
* **No added synchronization**: ``train_epoch`` with the full observer
  converts each metric once, at the log boundaries only (the port's
  counterpart of JAX's
  ``test_train_epoch_with_observer_keeps_one_sync_per_window``).

Tolerance: everything exact (host floats through the same arithmetic),
except the hand-checked MFU (1%).
"""

import gzip
import json
import logging
import threading
import time

import numpy as np
import pytest
import torch

import dtdl_tpu.obs as jobs
from dtdl_tpu.models import transformer_lm as jax_lm
from dtdl_tpu.obs import goodput as jgoodput
from dtdl_tpu_torch.data.loader import DataLoader
from dtdl_tpu_torch.metrics.report import Reporter
from dtdl_tpu_torch.models import MLP
from dtdl_tpu_torch.models.transformer import _PRESETS, LMConfig
from dtdl_tpu_torch.obs import (EVENT_CATALOG, NULL_OBSERVER, NULL_TRACER,
                                SPAN_CATALOG, GoodputMeter, LogHistogram,
                                Observer, RecompileError, RecompileEvent,
                                RecompileSentinel, Tracer, aggregate,
                                corr_rid, lm_decode_flops, lm_prefill_flops,
                                lm_train_flops, lm_verify_flops,
                                profiler_events, proc_tag, set_proc_tag)
from dtdl_tpu_torch.obs.goodput import lm_rope_hbm_bytes
from dtdl_tpu_torch.train.loop import train_epoch
from dtdl_tpu_torch.train.optim import sgd
from dtdl_tpu_torch.train.state import init_state
from dtdl_tpu_torch.train.step import make_train_step

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------

def _trace_pair(tracer):
    with tracer.span("outer", phase="epoch"):
        time.sleep(0.002)
        with tracer.span("inner"):
            time.sleep(0.002)
    tracer.instant("guard_bad_step", step=3)
    tracer.counter("queue", 2.0)
    tracer.flow("req", "p0/1", "start")
    tracer.flow("req", "p0/1", "end", n=1)
    tracer.device_window("device", seconds=0.004, steps=2)
    return tracer.to_chrome()


def test_tracer_chrome_json_matches_jax(tmp_path):
    """The same calls through both tracers: the same events in the same
    order, with the same phases, keys and args (timestamps aside), and a
    named device track."""
    port, jax_ = _trace_pair(Tracer()), _trace_pair(jobs.Tracer())

    def shape(trace):
        return [(e["name"], e["ph"], sorted(e), e.get("args"),
                 e.get("id"), e.get("bp"))
                for e in trace["traceEvents"]]

    assert shape(port) == shape(jax_)
    assert port["displayTimeUnit"] == jax_["displayTimeUnit"] == "ms"
    assert port["otherData"] == jax_["otherData"] == {"dropped_events": 0}
    ev = {e["name"]: e for e in port["traceEvents"] if e["ph"] == "X"}
    outer, inner = ev["outer"], ev["inner"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1
    assert ev["device"]["tid"] != outer["tid"]
    path = Tracer().save(str(tmp_path / "sub" / "t.json"))
    assert json.load(open(path))["traceEvents"][0]["ph"] == "M"
    with pytest.raises(ValueError, match="flow phase"):
        Tracer().flow("req", 1, "middle")


def test_tracer_gzip_and_event_cap(tmp_path):
    t = Tracer(max_events=5)
    for i in range(9):
        with t.span(f"s{i}"):
            pass
    t.instant("x")
    assert len(t) == 5 and t.dropped == 5
    path = t.save(str(tmp_path / "trace.json.gz"))
    with gzip.open(path, "rt") as f:
        trace = json.load(f)
    assert trace["otherData"]["dropped_events"] == 5
    assert Tracer().max_events == jobs.Tracer().max_events == 200_000


def test_tracer_thread_safe_and_timelines():
    """Four threads write one tracer (one track each); a request's
    timeline joins its events across threads, ordered, and accepts the
    bare or the wire form of the rid."""
    t = Tracer()
    barrier = threading.Barrier(4)

    def work(i):
        barrier.wait()
        for _ in range(50):
            with t.span("w"):
                pass
        t.instant("request_admitted", rid=corr_rid(7), arid=corr_rid(i))

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    evs = [e for e in t.to_chrome()["traceEvents"] if e.get("ph") == "X"]
    assert len(evs) == 200 and len({e["tid"] for e in evs}) == 4
    tl = t.request_timeline(7)
    assert len(tl) == 4 and tl == t.request_timeline(corr_rid(7))
    assert [e["ts"] for e in tl] == sorted(e["ts"] for e in tl)
    assert len({e["tid"] for e in tl}) == 4


def test_catalogs_and_correlation_ids_equal_jax():
    assert SPAN_CATALOG == jobs.SPAN_CATALOG
    assert EVENT_CATALOG == jobs.EVENT_CATALOG
    try:
        for tag in ("p3", None):
            set_proc_tag(tag)
            jobs.set_proc_tag(tag)
            assert proc_tag() == jobs.proc_tag()
            assert corr_rid(12) == jobs.corr_rid(12)
            assert corr_rid("p9/4") == "p9/4"
    finally:
        set_proc_tag(None)
        jobs.set_proc_tag(None)
    assert proc_tag() == "p0"


def test_null_tracer_and_aggregate(tmp_path):
    with NULL_TRACER.span("x"):
        pass
    NULL_TRACER.instant("x")
    assert len(NULL_TRACER) == 0 and NULL_TRACER.request_timeline(1) == []
    with pytest.raises(ValueError, match="disabled"):
        NULL_TRACER.save(str(tmp_path / "t.json"))
    events = [{"name": "a", "ph": "X", "dur": 2e6, "args": {}},
              {"name": "b", "ph": "X", "dur": 1e6, "args": {}},
              {"name": "a", "ph": "X", "dur": 1e6, "args": {}}]
    got = aggregate(events, lambda e, a: e["name"])
    assert got == jobs.aggregate(events, lambda e, a: e["name"])
    assert got[1] == 4.0 and list(got[0]) == ["a", "b"]


def test_profiler_events_read_a_torch_profiler_trace(tmp_path):
    """``profiler_events`` (JAX's ``xla_events``' counterpart) reads the
    newest ``torch.profiler`` Chrome trace: on the CPU its operator
    events; a span opens a ``record_function`` only inside a capture."""
    from torch.profiler import ProfilerActivity, profile
    t = Tracer()
    with t.span("outside"):
        torch.ones(4).sum()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with t.span("inside"):
            torch.ones(4).add(1)
    (tmp_path / "a").mkdir()
    prof.export_chrome_trace(str(tmp_path / "a" / "trace.json"))
    raw = json.load(open(tmp_path / "a" / "trace.json"))["traceEvents"]
    notes = {e["name"] for e in raw if e.get("cat") == "user_annotation"}
    assert "inside" in notes and "outside" not in notes
    events = profiler_events(str(tmp_path))
    names = {e["name"] for e in events}
    assert "aten::add" in names and "inside" not in names
    groups, total = aggregate(events, lambda e, a: e["name"])
    assert total > 0 and "aten::add" in groups
    with pytest.raises(FileNotFoundError):
        profiler_events(str(tmp_path / "none"))


# ---------------------------------------------------------------------------
# the histogram
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_histogram_matches_jax(seed):
    rng = np.random.default_rng(seed)
    xs = rng.lognormal(mean=-4.0, sigma=1.5, size=5000)
    th, jh = LogHistogram(), jobs.LogHistogram()
    th.extend(xs)
    jh.extend(xs)
    for p in (0, 1, 50, 90, 95, 99, 99.9, 100):
        assert th.percentile(p) == jh.percentile(p), p
    assert (th.p50, th.p95, th.p99) == (jh.p50, jh.p95, jh.p99)
    assert (th.n, th.min, th.max, th.mean) == (jh.n, jh.min, jh.max,
                                               jh.mean)
    assert th.summary("x_", unit=1e3) == jh.summary("x_", unit=1e3)
    # numpy within one bucket ratio
    tol = 10 ** (1.0 / th.bins_per_decade) - 1.0
    for p in (50, 95, 99):
        ref = np.percentile(xs, p)
        assert abs(th.percentile(p) - ref) / ref <= tol


def test_histogram_merge_clamping_and_errors_match_jax():
    halves = np.array_split(np.random.default_rng(2).lognormal(-3, 1, 400),
                            2)
    ta, tb = LogHistogram(), LogHistogram()
    ja, jb = jobs.LogHistogram(), jobs.LogHistogram()
    ta.extend(halves[0]), tb.extend(halves[1])
    ja.extend(halves[0]), jb.extend(halves[1])
    assert ta.merge(tb) is ta
    ja.merge(jb)
    assert ta.summary() == ja.summary() and ta._counts == ja._counts
    assert ta.min == ja.min and ta.max == ja.max
    clamped = []
    for cls in (LogHistogram, jobs.LogHistogram):
        h = cls(lo=1e-3, hi=1e3, bins_per_decade=10)
        n = len(h._counts)
        for x in (1e-9, 1e9, 0.0, -1.0):
            h.add(x)
        # out-of-range samples land in the end buckets; min/max stay exact
        assert len(h._counts) == n and h._counts[0] == 3
        assert h.min == -1.0 and h.max == 1e9
        clamped.append([h.percentile(p) for p in (0, 50, 75, 100)])
        with pytest.raises(ValueError, match="bucket layouts"):
            h.merge(cls(bins_per_decade=7))
        with pytest.raises(ValueError, match=r"\[0, 100\]"):
            h.percentile(101)
        with pytest.raises(ValueError, match="lo < hi"):
            cls(lo=1.0, hi=0.1)
        with pytest.raises(ValueError, match="bins_per_decade"):
            cls(bins_per_decade=0)
        empty = cls()
        assert (empty.summary(), empty.min, empty.max, empty.p99) == (
            {}, 0.0, 0.0, 0.0)
    assert clamped[0] == clamped[1]


# ---------------------------------------------------------------------------
# FLOPs and the goodput meter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size,over", [("tiny", {}), ("base", {}),
                                       ("tiny", {"n_experts": 4,
                                                 "moe_top_k": 2})])
def test_lm_flops_and_rope_bytes_equal_jax(size, over):
    cfg = LMConfig(**{**_PRESETS[size], **over})
    jm = jax_lm(size, **over)
    for b, s in ((8, 128), (2, 4096)):
        assert lm_train_flops(cfg, b, s) == jobs.lm_train_flops(jm, b, s)
        assert lm_decode_flops(cfg, b, s) == jobs.lm_decode_flops(jm, b, s)
        assert lm_prefill_flops(cfg, s) == jobs.lm_prefill_flops(jm, s)
        for k in (1, 4):
            assert lm_verify_flops(cfg, b, s, k) == \
                jobs.lm_verify_flops(jm, b, s, k)
        for nbytes in (2, 4):
            assert lm_rope_hbm_bytes(cfg, b, s, nbytes) == \
                jgoodput.lm_rope_hbm_bytes(jm, b, s, nbytes)


def test_lm_flops_hand_check_and_mfu():
    """JAX's hand derivation for 'tiny' at 8 x 128 (t = 127 predicted
    positions), and the MFU a window reports from it (1%)."""
    cfg = LMConfig(**_PRESETS["tiny"])
    B, t, D, V, F, L, H, hd = 8, 127, 64, 256, 128, 2, 4, 16
    per_tok = (L * (8 * D * D + 4 * H * t * hd * 0.5 + 6 * D * F)
               + 2 * D * V)
    hand = 3.0 * B * t * per_tok
    got = lm_train_flops(cfg, 8, 128)
    assert abs(got - hand) / hand < 0.01
    w = GoodputMeter(flops_per_step=got, tokens_per_step=8 * 127,
                     peak_flops=1e12).window(steps=4, seconds=2.0)
    assert abs(w["mfu"] - hand * 2 / 1e12) / (hand * 2 / 1e12) < 0.01


def test_goodput_meter_equals_jax():
    kw = dict(flops_per_step=1e9, tokens_per_step=1016, samples_per_step=64,
              peak_flops=1e12, roofline_mfu=0.5)
    tm, jm = GoodputMeter(**kw), jobs.GoodputMeter(**kw)
    rng = np.random.default_rng(3)
    for _ in range(6):
        steps = int(rng.integers(0, 20))
        secs = float(rng.uniform(0.0, 3.0))
        assert tm.window(steps, secs) == jm.window(steps, secs)
        if rng.random() < 0.5:
            assert tm.export_window() == jm.export_window()
    assert tm.totals() == jm.totals()
    assert tm.export_window() == jm.export_window()
    assert tm.export_window() == {} == jm.export_window()
    for k in ("peak_flops",):
        cpu = GoodputMeter(flops_per_step=1e9, **{k: None})
        assert cpu.window(2, 1.0) == jobs.GoodputMeter(
            flops_per_step=1e9, **{k: None}).window(2, 1.0)
    # "auto" takes this card's peak: none on the CPU
    assert GoodputMeter().peak_flops is None


# ---------------------------------------------------------------------------
# the Observer facade and the sentinel shell
# ---------------------------------------------------------------------------

def test_observer_facade_null_and_save(tmp_path):
    with NULL_OBSERVER.span("x"):
        pass
    NULL_OBSERVER.event("x")
    NULL_OBSERVER.flow("req", 1)
    assert NULL_OBSERVER.window(5, 1.0) == {}
    assert NULL_OBSERVER.summary() == {} and not NULL_OBSERVER.enabled
    f = lambda x: x  # noqa: E731
    assert NULL_OBSERVER.watch(f) is f and NULL_OBSERVER.save() is None
    assert NULL_OBSERVER.request_timeline(3) == []
    path = str(tmp_path / "t.json")
    meter = GoodputMeter(flops_per_step=1e9, peak_flops=1e12)
    with Observer(trace_path=path, goodput=meter) as obs:
        with obs.span("phase"):
            pass
        obs.event("request_done", rid=corr_rid(1))
        assert obs.window(4, 2.0) == meter._fields(4, 2.0)
        assert obs.window(0, 2.0) == {}
        assert obs.watch(f, "fn") is f
    names = [e["name"] for e in json.load(open(path))["traceEvents"]]
    assert {"phase", "request_done", "device"} <= set(names)
    s = obs.summary()
    assert s["step_time_s_count"] == 1 and s["trace_events"] == 3
    assert s["recompile_events"] == 0 and s["mfu"] == 0.002
    # trace=False with no path is off; a Tracer instance is taken as is
    assert Observer(trace=False).tracer is NULL_TRACER
    tr = Tracer()
    assert Observer(trace=tr).tracer is tr
    assert Observer(sentinel=None).sentinel.watch(f) is f


def test_sentinel_shell_policies_match_jax(caplog):
    """The port captures nothing yet (A5): ``watch`` returns the callable
    unwrapped.  The policies and the rollup over the same events are
    JAX's."""
    def event(name, n):
        return dict(name=name, n_compiles=n, cache_size=n,
                    signature={"args[0]": "float32[8,64]"},
                    diff={"args[0]": "float32[4,64] -> float32[8,64]"})

    for policy in ("silent", "warn"):
        ts, js = RecompileSentinel(policy), jobs.RecompileSentinel(policy)
        for e in (event("a", 2), event("b", 2), event("a", 3)):
            ts._fire(RecompileEvent(**e))
            js._fire(jobs.RecompileEvent(**e))
        assert ts.summary() == js.summary()
        assert [e.message() for e in ts.events] == \
            [e.message() for e in js.events]
    seen = []
    RecompileSentinel(seen.append)._fire(RecompileEvent(**event("c", 2)))
    assert seen[0].name == "c"
    with pytest.raises(RecompileError, match="unexpected retrace #2"):
        RecompileSentinel("raise")._fire(RecompileEvent(**event("d", 2)))
    with pytest.raises(ValueError, match="policy"):
        RecompileSentinel("loud")
    with caplog.at_level(logging.WARNING, logger="dtdl_tpu_torch"):
        RecompileSentinel("warn")._fire(RecompileEvent(**event("e", 2)))
    assert "unexpected retrace" in caplog.text
    f = lambda x: x  # noqa: E731
    assert RecompileSentinel().watch(f, "f") is f


# ---------------------------------------------------------------------------
# no added synchronization
# ---------------------------------------------------------------------------

class _Counted:
    """A metric tensor's stand-in that records each host conversion with
    the number of steps dispatched when it happened."""

    def __init__(self, value, log):
        self.value, self.log = value, log

    def __float__(self):
        self.log["events"].append(self.log["dispatched"])
        return float(self.value)


def test_train_epoch_with_observer_keeps_one_sync_per_window():
    """The full observer (tracer, sentinel, goodput meter) adds no host
    conversion: with log_interval 8 over 24 steps each metric converts
    exactly once, and only at the boundary dispatches (1, 9, 17) and the
    epoch's end (24), observer on or off alike."""
    steps, log_interval = 24, 8
    rng = np.random.default_rng(0)
    data = {"image": rng.normal(size=(steps * 8, 32)).astype(np.float32),
            "label": rng.integers(0, 10, steps * 8).astype(np.int64)}
    got = {}
    for on in (False, True):
        log = {"dispatched": 0, "events": []}
        real = make_train_step()

        def tracked(state, batch, real=real, log=log):
            log["dispatched"] += 1
            state, metrics = real(state, batch)
            return state, {k: _Counted(v, log) for k, v in metrics.items()}

        payloads = []
        sink = type("Sink", (), {"write": lambda self, p: payloads.append(p),
                                 "close": lambda self: None})()
        obs = (Observer(trace=True, sentinel="warn",
                        goodput=GoodputMeter(flops_per_step=1e9,
                                             tokens_per_step=8,
                                             peak_flops=1e12))
               if on else None)
        state = init_state(MLP(n_units=16, in_features=32, device="cpu"), 0, sgd(0.05),
                           device="cpu")
        train_epoch(tracked, state,
                    DataLoader(data, 8, shuffle=False, device="cpu"),
                    reporter=Reporter([sink], leader_only=False),
                    log_interval=log_interval, observer=obs)
        got[on] = log["events"]
        assert len(log["events"]) == steps * 2     # loss, accuracy once each
        assert set(log["events"]) <= {1, 9, 17, steps}
        windows = [p for p in payloads if "mfu" in p]
        if on:
            assert len(windows) == 3 and all(p["tokens_per_sec"] > 0
                                             for p in windows)
            names = {e["name"] for e in obs.tracer.to_chrome()["traceEvents"]}
            assert {"data", "dispatch", "drain", "device"} <= names
            assert obs.summary()["step_time_s_count"] == 4
            assert obs.sentinel.events == []
        else:
            assert windows == []
    assert got[True] == got[False]
