"""Observability for the port, the counterpart of dtdl_tpu/obs/: span
tracing, goodput/MFU accounting, latency percentiles, continuous metric
export and SLOs, for the train AND serve loops.  Nothing here adds a wait
for the card to a hot loop.

trace      span("data"/"dispatch"/"drain") → Chrome trace JSON (Perfetto),
           window-settled device track, torch.profiler annotations,
           request-correlated flow events + request_timeline(rid), the
           span/event catalogs
recompile  the sentinel's events and policies (counting captures is A5)
goodput    analytic model FLOPs (LM from config, CNNs from netspec), the
           card's peak, per-window MFU / tokens-per-sec / vs-roofline
hist       streaming log-bucketed histogram: p50/p95/p99 in fixed memory
observer   the Observer facade every loop takes (~3 lines per call site)
export     boundary-sampled continuous metrics: JSONL series, Prometheus
           text + opt-in http scrape endpoint, window-delta sources
slo        declarative SLO targets over the exported series: error
           budgets, burn-rate alerts, crossings as trace events

Quick start::

    from dtdl_tpu_torch.obs import Observer, GoodputMeter, lm_train_flops

    obs = Observer(trace_path="trace.json",
                   goodput=GoodputMeter(
                       flops_per_step=lm_train_flops(model, bs, seq),
                       tokens_per_step=bs * (seq - 1)))
    train_epoch(step, state, loader, strategy, reporter=rep, observer=obs)
    obs.close()                       # writes the Perfetto-loadable trace
"""

from dtdl_tpu_torch.obs.export import (  # noqa: F401
    JsonlSeriesSink, MetricsExporter, PrometheusSink, prometheus_text,
)
from dtdl_tpu_torch.obs.goodput import (  # noqa: F401
    GoodputMeter, lm_decode_flops, lm_forward_flops, lm_prefill_flops,
    lm_train_flops, lm_verify_flops, netspec_flops, peak_flops_per_chip,
)
from dtdl_tpu_torch.obs.hist import LogHistogram  # noqa: F401
from dtdl_tpu_torch.obs.observer import NULL_OBSERVER, Observer  # noqa: F401
from dtdl_tpu_torch.obs.recompile import (  # noqa: F401
    RecompileError, RecompileEvent, RecompileSentinel,
)
from dtdl_tpu_torch.obs.slo import (  # noqa: F401
    SLO, SLOEvaluator, default_train_slos,
)
from dtdl_tpu_torch.obs.trace import (  # noqa: F401
    EVENT_CATALOG, NULL_TRACER, SPAN_CATALOG, Tracer, aggregate,
    corr_rid, profiler_events, proc_tag, set_proc_tag,
)
