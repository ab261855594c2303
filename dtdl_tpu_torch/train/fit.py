"""compile()/fit() — the Keras-style API flavor, the port of
dtdl_tpu/train/fit.py.

Capability parity with the TF2 track: build and compile a model under a
strategy (the object itself is the "scope"), ``fit(x, y, batch_size,
epochs, validation_data, callbacks)`` with a :class:`History`,
per-epoch :class:`ModelCheckpoint`, :class:`TensorBoard`, and
restore-latest + evaluate.

The module is a port model (``MLP``, ``MnistCNN``, ...) built on its
device (the card unless ``device="cpu"``); the batches go there.
``compile(seed=)`` draws its weights from ``seed`` with the port's
initializers (``None`` keeps the weights it holds, e.g. bridged ones);
``example_input`` is accepted and unused (a port module knows its
shapes).  The weights a callback or ``save_weights`` writes are the
params tree of :func:`~dtdl_tpu_torch.train.state.params_tree` (flax
paths and layouts).  ``fit(observer=)`` adds JAX's ``dispatch`` /
``drain`` spans and each epoch's goodput window to its logs.
"""

from __future__ import annotations

import time
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from dtdl_tpu_torch.bridge import load_flax_params, state_dict_to_flax
from dtdl_tpu_torch.ckpt.checkpoint import (Checkpointer, load_weights,
                                            save_weights)
from dtdl_tpu_torch.data.loader import DataLoader
from dtdl_tpu_torch.data.sharding import ShardedSampler
from dtdl_tpu_torch.metrics.device import MetricsQueue
from dtdl_tpu_torch.metrics.report import (Accumulator, Reporter, StdoutSink,
                                           TensorBoardSink)
from dtdl_tpu_torch.obs.observer import NULL_OBSERVER
from dtdl_tpu_torch.parallel.strategy import Strategy, check_strategy
from dtdl_tpu_torch.runtime.bootstrap import (host_group, process_count,
                                              process_index)
from dtdl_tpu_torch.train.loop import _prefetch
from dtdl_tpu_torch.train.loop import evaluate as _evaluate
from dtdl_tpu_torch.train.optim import adam, rmsprop, sgd
from dtdl_tpu_torch.train.state import init_state, params_tree
from dtdl_tpu_torch.train.step import (make_eval_step, make_predict_step,
                                       make_train_step)


class Callback:
    def set_model(self, model: "Model") -> None:
        self.model = model

    def on_train_begin(self) -> None: ...
    def on_epoch_begin(self, epoch: int) -> None: ...
    def on_epoch_end(self, epoch: int, logs: dict) -> None: ...
    def on_train_end(self) -> None: ...


class History(Callback):
    def on_train_begin(self) -> None:
        self.history: dict[str, list] = {}

    def on_epoch_end(self, epoch: int, logs: dict) -> None:
        for k, v in logs.items():
            self.history.setdefault(k, []).append(v)


class ModelCheckpoint(Callback):
    """Per-epoch checkpoints (the reference saves ``ckpt_{epoch}`` weights
    every epoch).  ``save_weights_only=False`` snapshots the full
    TrainState (optimizer slots, BN stats, step) instead."""

    def __init__(self, directory: str, save_weights_only: bool = True,
                 keep: int | None = None):
        self.ckpt = Checkpointer(directory, keep=keep)
        self.save_weights_only = save_weights_only

    def on_epoch_end(self, epoch: int, logs: dict) -> None:
        if self.save_weights_only:
            self.ckpt.save_weights_epoch(epoch,
                                         params_tree(self.model.module))
        else:
            self.ckpt.save(epoch, self.model.state)

    def on_train_end(self) -> None:
        # full-state saves are async; block so restore-latest-then-evaluate
        # sees the snapshot
        self.ckpt.wait_until_finished()


class TensorBoard(Callback):
    """TensorBoard events when a writer is available."""

    def __init__(self, log_dir: str):
        self.sink = TensorBoardSink(log_dir)

    def on_epoch_end(self, epoch: int, logs: dict) -> None:
        self.sink.write({"step": epoch, "split": "epoch", **logs})

    def on_train_end(self) -> None:
        self.sink.close()


class PrintLR(Callback):
    """Parity with the reference's (unused) PrintLR callback."""

    def __init__(self, schedule_or_value):
        self.lr = schedule_or_value

    def on_epoch_end(self, epoch: int, logs: dict) -> None:
        lr = self.lr(self.model.state.step) if callable(self.lr) else self.lr
        print(f"\nLearning rate for epoch {epoch + 1} is {float(lr)}",
              flush=True)


# optax's default-rate recipes, as the JAX fit names them
_OPTIMIZERS = {
    "adam": lambda: adam(1e-3),
    "sgd": lambda: sgd(1e-2),
    "rmsprop": lambda: rmsprop(1e-3),
}


class Model:
    """Keras-flavored wrapper around a port module + strategy."""

    def __init__(self, module, strategy: Strategy | None = None):
        self.module = module
        self.strategy = check_strategy(strategy)
        self.state = None
        self._train_step = None
        self._eval_step = None
        self._predict_step = None

    @property
    def device(self) -> torch.device:
        return self.module.device

    def compile(self, optimizer="adam", loss: str | None = None,
                metrics: Sequence[str] = ("accuracy",), seed: int | None = 0,
                example_input=None) -> "Model":
        """The optimizer (a name of ``_OPTIMIZERS`` or a
        :class:`~dtdl_tpu_torch.train.optim.Transform`) and the steps.

        ``loss`` accepts 'sparse_categorical_crossentropy' (the
        reference's choice) or None for the same."""
        if loss not in (None, "sparse_categorical_crossentropy"):
            raise ValueError(f"unsupported loss {loss!r}")
        del metrics, example_input
        self._tx = (_OPTIMIZERS[optimizer.lower()]()
                    if isinstance(optimizer, str) else optimizer)
        self._seed = seed
        self._train_step = make_train_step(self.strategy)
        self._eval_step = make_eval_step(self.strategy)
        self._predict_step = make_predict_step(self.strategy,
                                               probabilities=True)
        return self

    def _ensure_state(self, x=None) -> None:
        if self.state is not None:
            return
        if self._train_step is None:
            raise ValueError("compile the model first")
        self.state = self.strategy.replicate(init_state(
            self.module, self._seed, self._tx, device=self.device))

    def _loader(self, x, y, batch_size: int, shuffle: bool, seed: int,
                drop_last: bool = True) -> DataLoader:
        """Per-process loader: each process reads only its stripe of the
        global permutation and feeds ``batch_size / process_count`` rows;
        the strategy syncs the global batch."""
        nproc = process_count()
        if batch_size % nproc:
            raise ValueError(
                f"batch_size {batch_size} not divisible by {nproc} processes")
        sampler = ShardedSampler(len(y), nproc, process_index(),
                                 shuffle=shuffle, seed=seed)
        return DataLoader({"image": x, "label": y}, batch_size // nproc,
                          sampler=sampler, drop_last=drop_last,
                          device=self.device)

    def fit(self, x, y, batch_size: int = 32, epochs: int = 1,
            validation_data=None, callbacks: Sequence[Callback] = (),
            shuffle: bool = True, seed: int = 0, verbose: int = 1,
            observer=None) -> History:
        obs = observer or NULL_OBSERVER
        x, y = np.asarray(x), np.asarray(y)
        self._ensure_state(x)
        history = History()
        cbs = [history, *callbacks]
        for cb in cbs:
            cb.set_model(self)
            cb.on_train_begin()
        reporter = Reporter([StdoutSink()]) if verbose else None
        loader = self._loader(x, y, batch_size, shuffle, seed)
        step_fn = obs.watch(self._train_step, "fit.train_step")
        try:
            for epoch in range(epochs):
                for cb in cbs:
                    cb.on_epoch_begin(epoch)
                loader.set_epoch(epoch)
                acc = Accumulator()
                # steps dispatch back to back; the bounded queue converts
                # metrics `lag` steps behind and the epoch end drains the
                # rest — same floats, same order, no per-step stall
                queue = MetricsQueue()
                n_steps, t0 = 0, time.perf_counter()
                for batch in _prefetch(map(self.strategy.shard_batch,
                                           loader), 2):
                    with obs.span("dispatch", epoch=epoch):
                        self.state, metrics = step_fn(self.state, batch)
                    n_steps += 1
                    for vals in queue.push(metrics):
                        acc.add(vals)
                with obs.span("drain", epoch=epoch):
                    for vals in queue.drain():
                        acc.add(vals)
                logs = acc.means()
                # the drain settled every dispatched step: the epoch's
                # train section is an honest goodput window
                logs.update(obs.window(n_steps, time.perf_counter() - t0))
                if validation_data is not None:
                    vx, vy = validation_data
                    val = self.evaluate(vx, vy, batch_size=batch_size,
                                        verbose=0)
                    logs.update({f"val_{k}": v for k, v in val.items()})
                if reporter is not None:
                    reporter.report({"epoch": epoch, **logs})
                for cb in cbs:
                    cb.on_epoch_end(epoch, logs)
        finally:
            # on_train_end also flushes pending async checkpoints — run it
            # on a mid-train crash too, so restarts see the newest snapshot
            for cb in cbs:
                cb.on_train_end()
        return history

    def evaluate(self, x, y, batch_size: int = 32, verbose: int = 1) -> dict:
        """Exact full-dataset metrics (ragged tails masked, never dropped)."""
        x, y = np.asarray(x), np.asarray(y)
        self._ensure_state(x)
        loader = self._loader(x, y, batch_size, shuffle=False, seed=0,
                              drop_last=False)
        means = _evaluate(self._eval_step, self.state, loader, self.strategy)
        if verbose:
            print(" - ".join(f"{k}: {v:.4f}" for k, v in means.items()),
                  flush=True)
        return means

    def predict(self, x, batch_size: int = 32) -> np.ndarray:
        """Class probabilities (the reference model ends in softmax), as a
        host array.  Multi-process: each process computes its stripe and
        every process returns the full, ordered output."""
        x = np.asarray(x)
        self._ensure_state(x)
        n = len(x)
        nproc = process_count()
        if nproc > 1:
            # contiguous equal stripes (padded at the end), gathered below
            stripe = -(-n // nproc)
            local = x[process_index() * stripe:][:stripe]
            if len(local) < stripe:
                pad_rows = np.repeat(x[-1:], stripe - len(local), axis=0)
                local = np.concatenate([local, pad_rows]) if len(local) \
                    else pad_rows
        else:
            local = x
        outs = []
        per_proc = max(batch_size // nproc, 1)
        for start in range(0, len(local), per_proc):
            xb = local[start:start + per_proc]
            pad = per_proc - len(xb)
            if pad:
                xb = np.concatenate([xb, xb[-1:].repeat(pad, axis=0)])
            batch = self.strategy.shard_batch(
                {"image": xb, "label": np.zeros(len(xb), np.int32)})
            # audit: ok[host-sync] predict() returns host arrays by contract
            probs = self._predict_step(self.state, batch).cpu().numpy()
            outs.append(probs[:per_proc - pad])
        local_out = np.concatenate(outs)
        if nproc > 1:
            parts = [None] * nproc
            dist.all_gather_object(parts, local_out, group=host_group())
            return np.concatenate(parts)[:n]
        return local_out[:n]

    # -- weights io -----------------------------------------------------------

    def save_weights(self, path: str) -> None:
        save_weights(path, params_tree(self.module))

    def _load_params(self, params) -> None:
        load_flax_params(self.module, params,
                         state_dict_to_flax(self.module, "batch_stats"),
                         device=self.device)

    def load_weights(self, path: str) -> None:
        if self.state is None:
            raise ValueError("call fit/evaluate once (or compile with "
                             "example_input) before load_weights")
        self._load_params(load_weights(path, params_tree(self.module)))

    def load_latest(self, directory: str) -> bool:
        """Restore-latest-then-evaluate flow: the newest per-epoch weights
        in ``directory``; False when there are none."""
        if self.state is None:
            raise ValueError("state not initialized yet")
        params, _ = Checkpointer(directory).latest_weights(
            params_tree(self.module))
        if params is None:
            return False
        self._load_params(params)
        return True

