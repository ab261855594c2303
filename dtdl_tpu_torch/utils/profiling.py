"""Profiling, the port of dtdl_tpu/utils/profiling.py: a torch.profiler
trace as a first-class hook around any training region.

The wall-clock side lives in :mod:`dtdl_tpu_torch.utils.timing`; this
module adds the device side: a ``torch.profiler`` trace of the host and
(on the card) CUDA activity, written as a Chrome trace under ``logdir``
(load it in Perfetto or ``chrome://tracing``)::

    from dtdl_tpu_torch.utils.profiling import maybe_trace, step_annotation

    with maybe_trace("/tmp/trace"):          # no-op when dir is falsy
        for i, batch in enumerate(loader):
            with step_annotation(i):          # groups ops per step
                state, metrics = train_step(state, batch)

``train_epoch(..., profile_dir=...)`` wires this for the standard loop.
"""

from __future__ import annotations

import contextlib
import os

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def maybe_trace(logdir: str | None):
    """Trace the block with ``torch.profiler`` (CPU, and CUDA when a card
    is visible) into ``logdir``/trace.json (falsy ``logdir``: no-op)."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def step_annotation(step: int):
    """Label what this step dispatches inside an active trace
    (``train_step#<step>``); cheap when no trace is active."""
    return torch.profiler.record_function(f"train_step#{step}")
