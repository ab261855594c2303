"""The observer adds no synchronization on the card.

These need the card (K1-K4 have no CPU mode): they carry the ``cuda``
marker and skip, with the reason, where no CUDA device is visible.  On the
card: ``python -m pytest tests/test_torch_obs_card.py -m cuda``.

A 2-layer LM at base width (d_model 512, 4 heads of 128, vocab 32000)
with random weights from one seed.  Under
``torch.cuda.set_sync_debug_mode("warn")`` every operation that waits for
the card warns; after a first run that warms the host allocators, the
warnings (by file and line) of runs with the full observer (tracer,
goodput meter, metrics exporter) must equal those of runs without it,
for train epochs through ``train_epoch`` (K1-K3) and for a paged decode
loop through the ``Scheduler`` (K4).  Tolerance: the sites equal, and the
greedy tokens identical.
"""

import warnings

import numpy as np
import pytest
import torch

from dtdl_tpu_torch.data.loader import DataLoader
from dtdl_tpu_torch.metrics.report import Reporter
from dtdl_tpu_torch.models.transformer import transformer_lm
from dtdl_tpu_torch.obs import (GoodputMeter, MetricsExporter, Observer,
                                lm_train_flops)
from dtdl_tpu_torch.serve import InferenceEngine, Request, Scheduler
from dtdl_tpu_torch.train.loop import train_epoch
from dtdl_tpu_torch.train.optim import adamw
from dtdl_tpu_torch.train.state import init_state
from dtdl_tpu_torch.train.step import make_lm_train_step


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: kernels K1-K4 have no CPU mode")
    return torch.device("cuda")


def _counting(fn):
    """Run ``fn`` under the sync debug mode; returns (its result, the
    ``file:line`` of each synchronizing operation it warned about)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sorted(f"{w.filename}:{w.lineno}" for w in caught
                       if "synchroniz" in str(w.message))


def _observer(flops=None, tokens=None):
    ex = MetricsExporter(interval_s=0.0)
    obs = Observer(trace=True, sentinel="warn",
                   goodput=GoodputMeter(flops_per_step=flops,
                                        tokens_per_step=tokens))
    ex.add_source("goodput", obs.goodput.export_window)
    return obs, ex


@pytest.mark.cuda
def test_train_epoch_syncs_the_same_with_the_observer(cuda):
    batch, seq = 4, 512
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 32000, (batch * 6, seq)).astype(np.int32)
    model = transformer_lm("base", n_layers=2, max_seq=seq,
                           dtype=torch.bfloat16, seed=1, device=cuda)
    state = init_state(model, None, adamw(3e-4), device=cuda)
    step = make_lm_train_step()
    flops = lm_train_flops(model.cfg, batch, seq)
    sites = {}
    # the first epoch warms the host allocators (pinned staging), then
    # the observer off, on, off, on
    for i, on in enumerate((False, False, True, False, True)):
        loader = DataLoader({"tokens": tokens}, batch, shuffle=False,
                            device=cuda)
        obs, ex = _observer(flops, batch * (seq - 1)) if on else (None, None)
        # the same boundaries either way; on, each report samples the
        # exporter (as a Trainer samples it at its drain)
        sink = type("Sink", (), {
            "write": lambda self, p, ex=ex: ex and ex.sample(),
            "close": lambda self: None})()
        (state, _), sites[i] = _counting(lambda: train_epoch(
            step, state, loader, reporter=Reporter([sink], leader_only=False),
            log_interval=3, observer=obs))
        if on:
            names = {e["name"] for e in obs.tracer.to_chrome()["traceEvents"]}
            assert {"data", "dispatch", "drain", "device"} <= names
            assert ex.n_snapshots >= 1
    assert sites[1] == sites[2] == sites[3] == sites[4], sites


@pytest.mark.cuda
def test_decode_loop_syncs_the_same_with_the_observer(cuda):
    model = transformer_lm("base", n_layers=2, max_seq=512,
                           dtype=torch.bfloat16, seed=2, device=cuda)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 32000, int(n)).tolist()
               for n in rng.integers(16, 200, 6)]
    got, counts = {}, {}
    # the first run warms the host allocators, then off, on
    for i, on in enumerate((False, False, True)):
        eng = InferenceEngine(model, n_slots=4, page_size=16, device=cuda)
        obs, ex = _observer() if on else (None, None)
        sched = Scheduler(eng, harvest_lag=2, observer=obs, exporter=ex,
                          device=cuda)
        reqs = [Request(list(p), 16) for p in prompts]
        _, counts[i] = _counting(lambda: sched.run(reqs))
        got[i] = [r.tokens for r in reqs]
        if on:
            for r in reqs:
                names = [e["name"] for e in obs.request_timeline(r.rid)]
                assert names.index("request_admitted") < names.index(
                    "request_first_token") < names.index("request_finished")
    assert got[0] == got[1] == got[2]
    assert counts[1] == counts[2], counts
