"""Estimator, the TF1 API flavor (model_fn / input_fn / RunConfig), the
port of dtdl_tpu/train/estimator.py.

TF1's training surface: a ``model_fn`` builds the model per mode, an
``input_fn`` supplies data, ``RunConfig`` schedules checkpoints, and
``train_and_evaluate`` alternates the two, with the contract that
**every call restores the latest checkpoint from model_dir**: the
Estimator holds no training state across calls, so training resumes by
construction and train and evaluate can run in separate processes.

Here ``model_fn(mode, params)`` returns an :class:`EstimatorSpec` whose
``model`` is a port module (built on the device the caller chose) and
``tx`` a :mod:`dtdl_tpu_torch.train.optim` transform; each verb runs the
port's train/eval/predict step under the strategy.  The checkpoint is the
TRAIN state (parameters and optimizer slots, TF1-style), a port snapshot
(:class:`~dtdl_tpu_torch.ckpt.Checkpointer`).  ``observer``
(:mod:`dtdl_tpu_torch.obs`) adds ``dispatch``/``drain`` spans and each log
window's goodput fields to ``train``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np

from dtdl_tpu_torch.ckpt.checkpoint import Checkpointer
from dtdl_tpu_torch.data.loader import (DataLoader, LimitBatches,
                                        prefetch_to_device, resume_iter)
from dtdl_tpu_torch.data.sharding import ShardedSampler
from dtdl_tpu_torch.metrics.device import MetricsQueue
from dtdl_tpu_torch.metrics.report import Reporter, StdoutSink
from dtdl_tpu_torch.obs.observer import NULL_OBSERVER
from dtdl_tpu_torch.parallel.strategy import Strategy, check_strategy
from dtdl_tpu_torch.runtime.bootstrap import process_count, process_index
from dtdl_tpu_torch.train.loop import _pad_and_mask, evaluate as _evaluate
from dtdl_tpu_torch.train.optim import sgd
from dtdl_tpu_torch.train.state import init_state
from dtdl_tpu_torch.train.step import (make_eval_step, make_predict_step,
                                       make_train_step)


class ModeKeys:
    """tf.estimator.ModeKeys equivalents."""
    TRAIN = "train"
    EVAL = "eval"
    PREDICT = "infer"


@dataclass
class EstimatorSpec:
    """What ``model_fn`` returns for a mode.

    ``model`` is a port module (the per-mode "graph"); ``tx`` the
    optimizer transform (TRAIN mode only); ``loss_fn`` overrides the
    default softmax cross entropy and follows the steps' loss contract:
    ``loss_fn(logits, labels, reduction="mean"|"none")`` (the eval step
    asks for per-example losses with ``reduction="none"``, as
    :func:`dtdl_tpu_torch.ops.cross_entropy.softmax_cross_entropy`)."""
    mode: str
    model: Any
    tx: Any = None
    loss_fn: Any = None


@dataclass
class RunConfig:
    """Checkpoint/logging cadence (tf.estimator.RunConfig surface)."""
    save_checkpoints_steps: int = 1000
    keep_checkpoint_max: int = 5
    log_step_count_steps: int = 100
    tf_random_seed: int = 0


@dataclass
class TrainSpec:
    input_fn: Callable
    max_steps: int


@dataclass
class EvalSpec:
    input_fn: Callable
    steps: int | None = None


def _as_loader(data, batch_size: int = 128, device=None):
    """``input_fn`` may return a loader or a (features, labels) pair; a
    pair is read in global batches of ``batch_size``, each process its
    stripe."""
    if hasattr(data, "batch_size"):
        return data
    features, labels = data
    nproc = process_count()
    return DataLoader({"image": np.asarray(features),
                       "label": np.asarray(labels)}, batch_size // nproc,
                      sampler=ShardedSampler(len(labels), nproc,
                                             process_index(), seed=0),
                      device=device)


class Estimator:
    """tf.estimator.Estimator over the port's steps.

    ``model_fn(mode, params) -> EstimatorSpec`` (``params`` the
    hyperparameter dict, TF1 style).  All state lives in ``model_dir``:
    train() restores the latest checkpoint, advances, checkpoints;
    evaluate()/predict() restore and run.  ``strategy`` brings DP/DDP as
    TF1's RunConfig train_distribute did; ``device`` places the loader of
    an input_fn that returns arrays (``None``: the card)."""

    def __init__(self, model_fn: Callable, model_dir: str = "./estimator",
                 config: RunConfig | None = None, params: dict | None = None,
                 strategy: Strategy | None = None, observer=None,
                 device=None):
        self.observer = observer or NULL_OBSERVER
        self.model_fn = model_fn
        self.model_dir = model_dir
        self.config = config or RunConfig()
        self.params = params or {}
        self.strategy = check_strategy(strategy)
        self.device = device
        self.ckpt = Checkpointer(model_dir,
                                 keep=self.config.keep_checkpoint_max)
        self.reporter = Reporter([StdoutSink()])

    # -- state plumbing -------------------------------------------------------

    def _build_state(self, spec: EstimatorSpec):
        # the checkpoint always holds the TRAIN graph's variables (params
        # and optimizer slots), TF1-style, so the restore template takes
        # the TRAIN-mode optimizer even when evaluating or predicting
        tx = spec.tx
        if tx is None:
            tx = self.model_fn(ModeKeys.TRAIN, self.params).tx
        if tx is None:
            tx = sgd(0.01)
        return self.strategy.replicate(init_state(
            spec.model, self.config.tf_random_seed, tx,
            device=spec.model.device))

    def _restore_or_init(self, spec: EstimatorSpec):
        state = self._build_state(spec)
        restored, step = self.ckpt.restore(state)
        if restored is not None:
            return restored, int(step)
        return state, 0

    def latest_global_step(self) -> int:
        """Step of the latest checkpoint in model_dir (0 if none)."""
        return self.ckpt.latest_step() or 0

    # -- the three verbs ------------------------------------------------------

    def train(self, input_fn: Callable, steps: int | None = None,
              max_steps: int | None = None) -> "Estimator":
        """Advance training; restores the latest checkpoint first (the
        TF1 contract).

        ``steps`` = additional steps from wherever the checkpoint left
        off; ``max_steps`` = absolute global-step ceiling (no-op if
        reached); neither = one full pass over input_fn's data."""
        spec = self.model_fn(ModeKeys.TRAIN, self.params)
        loader = _as_loader(input_fn(), device=self.device)
        state, global_step = self._restore_or_init(spec)
        target = (max_steps if max_steps is not None
                  else global_step + (steps if steps is not None
                                      else len(loader)))
        if global_step >= target:
            return self

        train_step = self.observer.watch(make_train_step(
            self.strategy, **({"loss_fn": spec.loss_fn} if spec.loss_fn
                              else {}),
            seed=self.config.tf_random_seed), "estimator.train_step")
        cfg = self.config
        # the loop dispatches back to back and syncs once per
        # log_step_count_steps: the drain at the log boundary fetches the
        # loss and closes the timing window
        queue = MetricsQueue(max(cfg.log_step_count_steps, 1))
        t0, logged_at = time.time(), global_step
        # the shuffle order is a function of (seed, epoch): resume at the
        # epoch/offset the restored global_step implies, so successive
        # train_and_evaluate legs walk the dataset
        steps_per_epoch = len(loader)
        epoch = global_step // steps_per_epoch
        skip = global_step % steps_per_epoch
        last_saved = global_step
        try:
            while global_step < target:
                loader.set_epoch(epoch)
                raw = resume_iter(loader, skip)
                skip = 0
                it = prefetch_to_device(raw, self.strategy.shard_batch, 2)
                for batch in it:
                    if global_step >= target:
                        break
                    with self.observer.span("dispatch",
                                            global_step=global_step):
                        state, metrics = train_step(state, batch)
                    global_step += 1
                    queue.push(metrics)
                    if (cfg.log_step_count_steps
                            and global_step % cfg.log_step_count_steps == 0):
                        with self.observer.span("drain"):
                            drained = queue.drain()  # waits on this step
                        dt = time.time() - t0
                        rate = (global_step - logged_at) / max(dt, 1e-9)
                        goodput = self.observer.window(
                            global_step - logged_at, dt)
                        t0, logged_at = time.time(), global_step
                        self.reporter.report({
                            "global_step": global_step,
                            "loss": drained[-1]["loss"] if drained
                            else float(metrics["loss"]),
                            "global_step/sec": round(rate, 2),
                            **goodput,
                        })
                    if (cfg.save_checkpoints_steps
                            and global_step % cfg.save_checkpoints_steps == 0):
                        self.ckpt.save(global_step, state)
                        last_saved = global_step
                epoch += 1
            if global_step != last_saved:
                self.ckpt.save(global_step, state)
        finally:
            # async saves durable before return, on an exception too
            self.ckpt.wait_until_finished()
        return self

    def evaluate(self, input_fn: Callable, steps: int | None = None) -> dict:
        """Exact metrics at the latest checkpoint (padded ragged tails)."""
        spec = self.model_fn(ModeKeys.EVAL, self.params)
        loader = _as_loader(input_fn(), device=self.device)
        state, global_step = self._restore_or_init(spec)
        if steps:
            loader = LimitBatches(loader, steps)
        eval_step = make_eval_step(
            self.strategy, **({"loss_fn": spec.loss_fn} if spec.loss_fn
                              else {}))
        means = _evaluate(eval_step, state, loader, self.strategy)
        result = {**means, "global_step": global_step}
        self.reporter.report({"split": "eval", **result})
        return result

    def predict(self, input_fn: Callable):
        """Generator of per-example prediction dicts (TF1's predict
        shape: ``logits``, ``class_ids``, ``probabilities``).  A ragged
        tail batch is padded to the loader's batch size and the padding
        rows are dropped from the stream."""
        spec = self.model_fn(ModeKeys.PREDICT, self.params)
        loader = _as_loader(input_fn(), device=self.device)
        state, _ = self._restore_or_init(spec)
        predict_step = make_predict_step(self.strategy)
        for batch in iter(loader):
            n = len(next(iter(batch.values())))
            padded = _pad_and_mask(batch, loader.batch_size)
            padded.pop("mask")
            logits = predict_step(state, self.strategy.shard_batch(padded))
            for row in logits[:n].float().cpu().numpy():
                yield {"logits": row, "class_ids": int(np.argmax(row)),
                       "probabilities": _softmax(row)}


def _softmax(row: np.ndarray) -> np.ndarray:
    e = np.exp(row - row.max())
    return e / e.sum()


def train_and_evaluate(estimator: Estimator, train_spec: TrainSpec,
                       eval_spec: EvalSpec) -> dict:
    """tf.estimator.train_and_evaluate: train in checkpoint-sized legs,
    evaluating after each new checkpoint, until max_steps."""
    leg = max(1, estimator.config.save_checkpoints_steps)
    result: dict = {}
    while True:
        at = estimator.latest_global_step()
        if at >= train_spec.max_steps:
            break
        estimator.train(train_spec.input_fn,
                        max_steps=min(at + leg, train_spec.max_steps))
        result = estimator.evaluate(eval_spec.input_fn, eval_spec.steps)
    return result
