"""The imperative training loop, the port of dtdl_tpu/train/loop.py:
``train_epoch`` and ``evaluate``.

The per-step work is the step function's (:mod:`dtdl_tpu_torch.train.
step`); this is the host loop around it, with the JAX loop's async
contract: the loop never reads a metric on the step it just dispatched.
Each step's metric tensors go into a bounded :class:`MetricsQueue` and
become floats only at a log boundary (one drain, one wait for the card,
a window) or by the queue's backpressure ``lag`` steps later, so between
boundaries the host only enqueues the next step.  ``sync_every_step=True``
is the blocking loop (exact per-step times, one stall a step); the values
are the same either way.

Under a strategy each batch goes through ``strategy.shard_batch``, and
``evaluate``'s sums are sum-synced over the replicas: each process pads
its own ragged tail with mask 0, and a process with fewer batches than
another runs all-masked ones, so the world's counts cover every example
of every process's loader exactly once.

``profile_dir`` traces the epoch with ``torch.profiler``
(:mod:`dtdl_tpu_torch.utils.profiling`), each step annotated.
``observer`` (:mod:`dtdl_tpu_torch.obs`) adds the host-phase spans
(``data`` / ``dispatch`` / ``drain``) and per-window goodput fields merged
into the boundary reports, at JAX's points; all host-side, so the
one-wait-per-window contract holds.

Not ported yet, and refused by name: ``unroll > 1`` (JAX runs k steps as
one ``lax.scan`` program; in PyTorch that meaning comes with CUDA-graph
capture, ROADMAP queue A5) and ``guard`` (queue A13b).
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from dtdl_tpu_torch.metrics.device import MetricsQueue
from dtdl_tpu_torch.metrics.report import Accumulator, Reporter
from dtdl_tpu_torch.obs.observer import NULL_OBSERVER
from dtdl_tpu_torch.parallel.strategy import check_strategy
from dtdl_tpu_torch.utils.profiling import maybe_trace, step_annotation
from dtdl_tpu_torch.utils.timing import StepTimer


def _refuse(unroll: int = 1, guard=None) -> None:
    if unroll > 1:
        raise NotImplementedError(
            "unroll > 1 (k steps as one program) is ROADMAP queue A5 "
            "(CUDA-graph capture)")
    if guard is not None:
        raise NotImplementedError("guard is ROADMAP queue A13b "
                                  "(resilience)")


def _prefetch(iterator, depth: int):
    """Pull ``depth`` batches ahead of the consumer, so each batch's
    upload is queued before the steps that precede its own."""
    buf = deque()
    for item in iterator:
        buf.append(item)
        if len(buf) >= depth:
            yield buf.popleft()
    while buf:
        yield buf.popleft()


def train_epoch(train_step, state, loader, strategy=None,
                reporter: Reporter | None = None, epoch: int = 0,
                log_interval: int = 20, timer: StepTimer | None = None,
                prefetch: int = 2, profile_dir: str | None = None,
                sync_every_step: bool = False, lag: int | None = None,
                unroll: int = 1, observer=None, guard=None):
    """Run one epoch; returns (state, epoch_mean_metrics).

    Async by default: metrics are drained (one wait for the card) once per
    ``log_interval`` steps and at the epoch end; ``lag`` bounds the
    in-flight queue between boundaries (default ``log_interval``).
    ``sync_every_step=True`` blocks on every step.  Each boundary reports
    {epoch, step, steps_per_epoch, the metrics, batch_time} and the epoch
    end {epoch, split: "train_epoch", the means, epoch_time,
    avg_batch_time}, the JAX payloads."""
    if unroll < 1:
        raise ValueError(f"unroll must be >= 1, got {unroll}")
    strategy = check_strategy(strategy)
    _refuse(unroll, guard)
    obs = observer or NULL_OBSERVER
    timer = timer or StepTimer(blocking=sync_every_step)
    timer.reset_epoch()
    acc = Accumulator()
    loader.set_epoch(epoch)
    steps_per_epoch = len(loader)
    it = _prefetch(map(strategy.shard_batch, loader), prefetch)

    with maybe_trace(profile_dir):
        state = _run_epoch(train_step, state, it, reporter, epoch,
                           log_interval, timer, sync_every_step, lag, acc,
                           steps_per_epoch, obs)
    if reporter is not None:
        reporter.report({
            "epoch": epoch, "split": "train_epoch", **acc.means(),
            "epoch_time": timer.epoch_elapsed_s,
            "avg_batch_time": timer.avg_step_s,
        })
    return state, acc.means()


def _run_epoch(train_step, state, it, reporter, epoch, log_interval, timer,
               sync_every_step, lag, acc, steps_per_epoch, obs):
    """The epoch's steps (the body of :func:`train_epoch`); returns the
    state."""
    step_fn = obs.watch(train_step, "train_step")
    if sync_every_step:
        for i, batch in enumerate(it):
            with step_annotation(i), obs.span("dispatch", step=i):
                state, metrics = step_fn(state, batch)
            timer.step(metrics["loss"])
            # blocking mode: every step is its own settled window
            goodput = obs.window(1, timer.last_step_s)
            vals = {k: float(v) for k, v in metrics.items()}
            acc.add(vals)
            if reporter is not None and (i % log_interval) == 0:
                reporter.report({
                    "epoch": epoch, "step": i,
                    "steps_per_epoch": steps_per_epoch, **vals,
                    "batch_time": timer.last_step_s, **goodput,
                })
        return state
    queue = MetricsQueue(lag if lag is not None else max(log_interval, 1))
    latest: dict | None = None
    next_log = 0
    step0 = 0
    window_start = 0          # first step of the current obs/goodput window
    it = iter(it)
    end = object()
    while True:
        with obs.span("data"):
            batch = next(it, end)
        if batch is end:
            break
        with step_annotation(step0), obs.span("dispatch", step=step0):
            state, metrics = step_fn(state, batch)
        timer.step()
        popped = queue.push(metrics)
        for vals in popped:
            acc.add(vals)
        if popped:
            latest = popped[-1]
        if reporter is not None and step0 >= next_log:
            # boundary: ONE drain converts the whole window (waits on
            # the step just dispatched), the window's only sync
            with obs.span("drain", steps=step0 + 1 - window_start):
                drained = queue.drain()
            for vals in drained:
                acc.add(vals)
            if drained:
                latest = drained[-1]
            timer.sync()
            w = step0 + 1 - window_start
            window_start = step0 + 1
            reporter.report({
                "epoch": epoch, "step": step0,
                "steps_per_epoch": steps_per_epoch, **(latest or {}),
                "batch_time": timer.last_step_s,
                # settled-window goodput, host floats only
                **obs.window(w, timer.last_step_s * w),
            })
            next_log = (step0 // log_interval + 1) * log_interval
        step0 += 1
    with obs.span("drain", steps=step0 - window_start):
        for vals in queue.drain():
            acc.add(vals)
    timer.sync()
    if step0 > window_start:
        obs.window(step0 - window_start,
                   timer.last_step_s * (step0 - window_start))
    return state


def _pad_and_mask(batch, target: int):
    """Pad a ragged tail batch to ``target`` rows by repeating its last
    row, with ``mask`` 0 on the padding (1 on every real row), so the
    eval step sees one batch shape and counts each example once.  The
    batch's arrays may be numpy or tensors (then padded where they lie,
    on the card for the DataLoader's)."""
    first = next(iter(batch.values()))
    n = len(first)
    if isinstance(first, torch.Tensor):
        dev = first.device
        mask = torch.ones(n, dtype=torch.float32, device=dev)
        if n == target:
            return {**batch, "mask": mask}
        out = {k: torch.cat([v, v[-1:].expand(target - n, *v.shape[1:])])
               for k, v in batch.items()}
        out["mask"] = torch.cat([mask, torch.zeros(target - n, device=dev)])
        return out
    mask = np.ones(n, np.float32)
    if n == target:
        return {**batch, "mask": mask}
    out = {k: np.concatenate([v, np.repeat(v[-1:], target - n, axis=0)])
           for k, v in batch.items()}
    out["mask"] = np.concatenate([mask, np.zeros(target - n, np.float32)])
    return out


def evaluate(eval_step, state, loader, strategy=None,
             reporter: Reporter | None = None, epoch: int = 0,
             prefetch: int = 2, lag: int = 8, observer=None):
    """Full-dataset evaluation; returns exact mean {loss, accuracy}.

    A ragged tail batch is padded to the loader's batch size with masked
    rows, so every real example counts exactly once.  Batches dispatch
    back to back; per-batch sums convert on the queue's backpressure
    (``lag`` batches behind) and at the final drain, summed in batch
    order.  Reports {epoch, split: "val", val_loss, val_accuracy}.

    Under a strategy every process runs as many eval steps as the one
    with the most batches (``max_sync``); the extra ones repeat the last
    batch with mask 0, so the sum-synced counts stay exact."""
    strategy = check_strategy(strategy)
    obs = observer or NULL_OBSERVER
    eval_fn = obs.watch(eval_step, "eval_step")
    target = loader.batch_size
    queue = MetricsQueue(lag)
    sums = {"loss_sum": 0.0, "correct_sum": 0.0, "count": 0.0}

    def absorb(entries):
        for vals in entries:
            for k in sums:
                sums[k] += vals[k]

    def batches():
        last = None
        for batch in loader:
            last = _pad_and_mask(batch, target)
            yield last
        for _ in range(extra):
            yield {**last, "mask": last["mask"] * 0}

    # one replica needs no agreement (and its loader may have no len)
    extra = (strategy.max_sync(len(loader)) - len(loader)
             if strategy.num_replicas > 1 else 0)
    for batch in _prefetch(map(strategy.shard_batch, batches()), prefetch):
        with obs.span("dispatch", phase="eval"):
            metrics = eval_fn(state, batch)
        absorb(queue.push(metrics))
    with obs.span("drain", phase="eval"):
        absorb(queue.drain())
    if sums["count"] == 0:
        return {"loss": float("nan"), "accuracy": float("nan")}
    means = {"loss": sums["loss_sum"] / sums["count"],
             "accuracy": sums["correct_sum"] / sums["count"]}
    if reporter is not None:
        reporter.report({"epoch": epoch, "split": "val",
                         **{f"val_{k}": v for k, v in means.items()}})
    return means
