"""Trainer + extensions — the Chainer-style API flavor, the port of
dtdl_tpu/train/trainer.py.

A :class:`Trainer` drives the train step until a stop trigger, firing
extensions on (n, 'iteration'|'epoch') triggers:

* :class:`Evaluator`     — full val-set metrics (sum-synced under a
                           strategy)
* :class:`LogReport`     — JSON log of per-period means
* :class:`PrintReport`   — column table on stdout
* :class:`snapshot`      — full trainer snapshot, resumable
* :class:`dump_graph`    — the train step's graph: the eager port has no
                           lowering, so it writes the module tree and each
                           parameter's flax path, shape and dtype
* :class:`ProgressSummary` — per-epoch one-liner with epoch time

``--resume`` restores params, optimizer state, BN stats, the schedule's
count, iteration/epoch and the loader position (``iteration_in_epoch``:
a mid-epoch resume replays the exact remainder of the epoch through
``resume_iter``), and each extension's state (``Extension.serialize``).
Output is leader-gated.  ``preempt=`` (a
:class:`~dtdl_tpu_torch.resil.PreemptionWatcher`) snapshots at the next
iteration boundary after SIGTERM and returns with ``preempted`` set.
``observer=`` (:mod:`dtdl_tpu_torch.obs`) adds the ``dispatch`` and
``drain`` spans and each drained window's goodput fields to the
observation; ``exporter=`` (a
:class:`~dtdl_tpu_torch.obs.export.MetricsExporter`) is sampled at each
drain and once, forced, at the end of :meth:`Trainer.run`.

``guard=`` (a :class:`~dtdl_tpu_torch.resil.guard.StepGuard`, the
instance folded into ``train_step``) is fed every drained step; under
its ``rollback`` policy the Trainer restores the last good snapshot and
continues mid-epoch (``trainer_rollback``), and with no snapshot to
restore it escalates by name.  ``watchdog=`` (a
:class:`~dtdl_tpu_torch.resil.elastic.StepWatchdog`) bounds the drain's
wait for the card: a peer dead inside a collective surfaces as a named
``PeerLostError`` instead of hanging this host.
"""

from __future__ import annotations

import json
import logging
import os
import time

from dtdl_tpu_torch.bridge import flatten
from dtdl_tpu_torch.ckpt.checkpoint import Checkpointer
from dtdl_tpu_torch.data.loader import resume_iter
from dtdl_tpu_torch.metrics.device import MetricsQueue
from dtdl_tpu_torch.metrics.report import (Accumulator, JsonlSink, Reporter,
                                           StdoutSink)
from dtdl_tpu_torch.obs.observer import NULL_OBSERVER
from dtdl_tpu_torch.parallel.strategy import Strategy, check_strategy
from dtdl_tpu_torch.resil.guard import GuardEscalationError, GuardRollback
from dtdl_tpu_torch.runtime.bootstrap import is_leader
from dtdl_tpu_torch.train.loop import _prefetch
from dtdl_tpu_torch.train.state import params_tree
from dtdl_tpu_torch.utils.timing import StepTimer


class Trigger:
    """Fires every n iterations or epochs."""

    def __init__(self, period: int, unit: str):
        if unit not in ("iteration", "epoch"):
            raise ValueError(f"trigger unit {unit!r}")
        self.period = period
        self.unit = unit

    @classmethod
    def of(cls, spec) -> "Trigger":
        if isinstance(spec, Trigger):
            return spec
        period, unit = spec
        return cls(period, unit)

    def should_fire(self, trainer: "Trainer", boundary: str) -> bool:
        if boundary != self.unit:
            return False
        count = trainer.iteration if self.unit == "iteration" else trainer.epoch
        return count > 0 and count % self.period == 0


class Extension:
    """Base extension; subclasses override __call__(trainer)."""

    default_trigger = (1, "epoch")
    priority = 100

    def __call__(self, trainer: "Trainer") -> None:
        raise NotImplementedError

    def serialize(self) -> dict:
        return {}

    def deserialize(self, data: dict) -> None:
        pass


class Trainer:
    """Drives (state, batch) -> (state, metrics) until the stop trigger."""

    def __init__(self, state, train_step, train_loader, strategy: Strategy,
                 stop_trigger=(20, "epoch"), out: str = "./result",
                 prefetch: int = 2, metrics_lag: int = 20, observer=None,
                 guard=None, preempt=None, exporter=None, watchdog=None):
        self.state = state
        self.train_step = train_step
        # the obs facade; the default NULL_OBSERVER no-ops every hook
        self.observer = observer or NULL_OBSERVER
        # the StepGuard folded into train_step: fed every drained step
        self.guard = guard
        # a StepWatchdog bounding the drain's wait for the card
        self.watchdog = watchdog
        # sampled at the drain, the one boundary this loop already owns
        self.exporter = exporter
        # a PreemptionWatcher polled at iteration boundaries: on SIGTERM
        # the run snapshots and returns with ``self.preempted`` set
        self.preempt = preempt
        self.preempted = False
        self.train_loader = train_loader
        self.strategy = check_strategy(strategy)
        self.stop = Trigger.of(stop_trigger)
        self.out = out
        self.prefetch = prefetch

        self.iteration = 0
        self.epoch = 0
        self.iteration_in_epoch = 0
        self._skip_batches = 0  # fast-forward after a mid-epoch resume
        self.observation: dict[str, float] = {}
        self.accumulator = Accumulator()
        # metrics stay on the device in a bounded queue; they are drained
        # — ONE wait for the card — right before an extension fires, so
        # back-to-back iterations never block on the step just dispatched
        self.metrics_queue = MetricsQueue(metrics_lag)
        self.timer = StepTimer(blocking=False)
        self.start_time = time.time()
        self._extensions: list[tuple[str, Extension, Trigger]] = []
        self.ckpt = Checkpointer(out)  # creates out/ (leader-gated)

    # -- extension management -------------------------------------------------

    def extend(self, extension: Extension, trigger=None,
               name: str | None = None) -> "Trainer":
        trig = Trigger.of(trigger or extension.default_trigger)
        name = name or type(extension).__name__
        self._extensions.append((name, extension, trig))
        self._extensions.sort(key=lambda e: -getattr(e[1], "priority", 100))
        return self

    def _fire(self, boundary: str) -> None:
        for _, ext, trig in self._extensions:
            if trig.should_fire(self, boundary):
                ext(self)

    def _will_fire(self, boundary: str) -> bool:
        return any(trig.should_fire(self, boundary)
                   for _, _, trig in self._extensions)

    def _absorb(self, drained) -> None:
        for vals in drained:
            if self.guard is not None:
                self.guard.observe(vals)
            self.observation = vals
            self.accumulator.add(vals)

    def _drain_metrics(self) -> None:
        """Settle pending device metrics into observation/accumulator, in
        dispatch order (the floats a sync-every-iteration loop would
        produce)."""
        with self.observer.span("drain"):
            drained = (self.watchdog.run(self.metrics_queue.drain)
                       if self.watchdog is not None
                       else self.metrics_queue.drain())
        self._absorb(drained)
        if drained:
            self.timer.sync()
            # settled window = exactly the drained steps; goodput fields
            # land in observation so LogReport/PrintReport can select them
            self.observation.update(self.observer.window(
                len(drained), self.timer.last_step_s * len(drained)))
        if self.exporter is not None:
            self.exporter.sample()

    # -- run loop -------------------------------------------------------------

    @property
    def _done(self) -> bool:
        count = self.iteration if self.stop.unit == "iteration" else self.epoch
        return count >= self.stop.period

    def run(self) -> None:
        step_fn = self.observer.watch(self.train_step, "trainer.train_step")
        try:
            while not self._done:
                try:
                    if self._run_epoch(step_fn):
                        return
                except GuardRollback:
                    # the guard's rollback policy: restore the last good
                    # snapshot and continue from there (mid-epoch exact,
                    # through the resume path)
                    self._rollback()
        finally:
            # snapshots save asynchronously; make them durable before the
            # process moves on (a fresh Trainer may resume immediately)
            self.ckpt.wait_until_finished()
            if self.exporter is not None:
                # the forced final point closes the window-delta
                # telescope even on an exception path
                self.exporter.sample(force=True)

    def _rollback(self) -> None:
        # in-flight metrics belong to the abandoned timeline: settle and
        # discard them (the queued work is harmless, the guard's device
        # select already kept any bad update out of the state)
        self.metrics_queue.drain()
        self.accumulator.reset()
        self.observer.event("trainer_rollback", iteration=self.iteration)
        self.ckpt.wait_until_finished()
        if not self.resume():
            raise GuardEscalationError(
                f"guard requested rollback-to-last-good but no snapshot "
                f"exists in {self.out} — add the snapshot extension (or "
                f"use policy='skip')")

    def _check_preempt(self) -> bool:
        """SIGTERM received: snapshot at this (consistent) boundary and
        stop; run()'s finally makes it durable and committed."""
        if self.preempt is None or not self.preempt.requested:
            return False
        self.observer.event("trainer_preempted", iteration=self.iteration)
        self.save_snapshot()
        self.preempted = True
        return True

    def _run_epoch(self, step_fn) -> bool:
        """One epoch (or the remainder of one after a resume); True when
        the run should stop (done or preempted)."""
        self.train_loader.set_epoch(self.epoch)
        self.timer.reset_epoch()
        if self._skip_batches:
            # mid-epoch resume: the sampler's (seed, epoch) order and the
            # per-batch-keyed transform rng are deterministic, so starting
            # at the consumed prefix replays the exact remainder
            skip, self._skip_batches = self._skip_batches, 0
            raw = resume_iter(self.train_loader, skip)
        else:
            raw = iter(self.train_loader)
            self.iteration_in_epoch = 0
        for batch in _prefetch(map(self.strategy.shard_batch, raw),
                               self.prefetch):
            with self.observer.span("dispatch", iteration=self.iteration):
                self.state, metrics = step_fn(self.state, batch)
            self.iteration += 1
            self.iteration_in_epoch += 1
            self.timer.step()
            self._absorb(self.metrics_queue.push(metrics))
            done = self._done and self.stop.unit == "iteration"
            if done or self._will_fire("iteration"):
                self._drain_metrics()
            self._fire("iteration")
            if done or self._check_preempt():
                return True
        self.epoch += 1
        self.iteration_in_epoch = 0
        self._drain_metrics()
        self._fire("epoch")
        return self._check_preempt()

    # -- snapshot / resume ----------------------------------------------------

    def save_snapshot(self) -> str:
        """Snapshot the state (asynchronously) as ``snapshot_<iteration>``
        and write the trainer's sidecar beside it
        (``snapshot_<iteration>.meta.json``)."""
        path = self.ckpt.save(self.iteration, self.state)
        meta = {
            "iteration": self.iteration,
            "epoch": self.epoch,
            "iteration_in_epoch": self.iteration_in_epoch,
            "extensions": {name: ext.serialize()
                           for name, ext, _ in self._extensions},
        }
        if is_leader():
            with open(path + ".meta.json", "w") as f:
                json.dump(meta, f)
        return path

    def resume(self, path: str = "") -> bool:
        """Restore trainer state; empty path = latest snapshot in out/."""
        if path:
            state = self.ckpt.restore_path(self.state, path)
            meta_path = path.rstrip("/") + ".meta.json"
        else:
            state, step = self.ckpt.restore(self.state)
            if state is None:
                return False
            meta_path = os.path.join(self.out, f"snapshot_{step}.meta.json")
        self.state = state
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            self.iteration = meta["iteration"]
            self.epoch = meta["epoch"]
            self.iteration_in_epoch = meta.get("iteration_in_epoch", 0)
            self._skip_batches = self.iteration_in_epoch
            for name, ext, _ in self._extensions:
                if name in meta.get("extensions", {}):
                    ext.deserialize(meta["extensions"][name])
        return True

    @property
    def elapsed_time(self) -> float:
        return time.time() - self.start_time


# ---- extensions -------------------------------------------------------------

class Evaluator(Extension):
    """Full validation pass; reports val_<metric>.  Under a strategy the
    eval sums are sum-synced inside the eval step (the multi-node
    evaluator)."""

    priority = 200  # run before reporting extensions

    def __init__(self, eval_step, val_loader, strategy: Strategy,
                 prefetch: int = 2):
        self.eval_step = eval_step
        self.val_loader = val_loader
        self.strategy = strategy
        self.prefetch = prefetch
        self.last: dict[str, float] = {}

    def __call__(self, trainer: Trainer) -> None:
        from dtdl_tpu_torch.train.loop import evaluate as _evaluate
        means = _evaluate(self.eval_step, trainer.state, self.val_loader,
                          self.strategy, prefetch=self.prefetch)
        self.last = {f"val_{k}": v for k, v in means.items()}
        trainer.observation.update(self.last)


class LogReport(Extension):
    """Collect per-period means into a JSON log; keeps the records in
    memory and appends to ``out/log.jsonl`` on the leader."""

    priority = 150

    def __init__(self):
        self.records: list[dict] = []
        self._sink: JsonlSink | None = None

    def __call__(self, trainer: Trainer) -> None:
        rec = {
            "epoch": trainer.epoch,
            "iteration": trainer.iteration,
            **trainer.accumulator.means(),
            **{k: v for k, v in trainer.observation.items()
               if k.startswith("val_")},
            "elapsed_time": round(trainer.elapsed_time, 3),
        }
        self.records.append(rec)
        if is_leader():
            if self._sink is None:
                self._sink = JsonlSink(os.path.join(trainer.out, "log.jsonl"))
            self._sink.write(rec)
        trainer.accumulator.reset()

    def serialize(self) -> dict:
        return {"records": self.records}

    def deserialize(self, data: dict) -> None:
        self.records = data.get("records", [])


class PrintReport(Extension):
    """Column table of selected entries."""

    priority = 140

    def __init__(self, entries: list[str], log_report: LogReport):
        self.entries = entries
        self.log_report = log_report
        self._header_printed = False

    def __call__(self, trainer: Trainer) -> None:
        if not is_leader() or not self.log_report.records:
            return
        rec = self.log_report.records[-1]
        if not self._header_printed:
            print("  ".join(f"{e:>14}" for e in self.entries), flush=True)
            self._header_printed = True
        cells = []
        for e in self.entries:
            v = rec.get(e, "")
            cells.append(f"{v:14.5g}" if isinstance(v, float) else f"{v!s:>14}")
        print("  ".join(cells), flush=True)


class snapshot(Extension):  # noqa: N801 - chainer-style lowercase name
    """Full trainer snapshot at each trigger."""

    def __call__(self, trainer: Trainer) -> None:
        trainer.save_snapshot()


class dump_graph(Extension):  # noqa: N801
    """Dump the train step's graph once, without running it: JAX writes
    the lowered HLO; the eager port has no lowering and writes
    ``train_step.graph.txt`` with the module tree and each parameter's
    flax path, shape and dtype.  A failure is logged, never raised."""

    default_trigger = (1, "epoch")

    def __init__(self, example_batch):
        self.example_batch = example_batch
        self._dumped = False

    def __call__(self, trainer: Trainer) -> None:
        if self._dumped or not is_leader():
            return
        self._dumped = True
        try:
            model = trainer.state.model
            lines = [repr(model), "", "# flax path  shape  dtype"]
            lines += [f"{path}  {tuple(p.shape)}  {p.dtype}"
                      for path, p in flatten(params_tree(model)).items()]
            lines += ["", "# example batch"]
            lines += [f"{k}  {tuple(v.shape)}  {v.dtype}"
                      for k, v in self.example_batch.items()]
            with open(os.path.join(trainer.out, "train_step.graph.txt"),
                      "w") as f:
                f.write("\n".join(lines) + "\n")
        except Exception as e:  # graph dump must never kill training
            logging.getLogger("dtdl_tpu_torch").warning(
                "dump_graph failed: %s", e)


class ProgressSummary(Extension):
    """Per-epoch one-liner with epoch time (the torch loops' epoch
    print)."""

    priority = 130

    def __init__(self, reporter: Reporter | None = None):
        self.reporter = reporter or Reporter([StdoutSink()])

    def __call__(self, trainer: Trainer) -> None:
        self.reporter.report({
            "epoch": trainer.epoch,
            **trainer.observation,
            "epoch_time": trainer.timer.epoch_elapsed_s,
            "avg_batch_time": trainer.timer.avg_step_s,
        })
