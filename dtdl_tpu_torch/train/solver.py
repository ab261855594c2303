"""Caffe-style Solver, the port of dtdl_tpu/train/solver.py: ``caffe
train --solver=solver.prototxt``, where the solver prototxt names a net
prototxt (:mod:`dtdl_tpu_torch.models.netspec`) and the optimization
schedule.

Solver fields honored (Caffe SolverParameter semantics, as in JAX):
net / train_net / test_net, test_iter, test_interval,
test_initialization, base_lr, lr_policy (fixed | step | exp | inv |
multistep | poly | sigmoid), gamma, power, stepsize, stepvalue
(repeated), max_iter, iter_size, momentum, weight_decay, type (SGD |
Nesterov | Adam | AdaGrad | RMSProp | AdaDelta), delta, momentum2,
rms_decay, display, snapshot, snapshot_prefix, random_seed.

Iterations throughout (Caffe has no epochs): one iteration is
``iter_size`` forward/backward passes and one update
(:func:`~dtdl_tpu_torch.train.optim.multi_steps`), and the display, test
and snapshot cadences count iterations.  The lr policy is a function of
the update count, the optimizer's schedule
(:mod:`dtdl_tpu_torch.train.optim`); weight_decay is L2 added to the
gradient before the update (``add_decayed_weights``).
"""

from __future__ import annotations

import math
import os
import time

import torch

from dtdl_tpu_torch.ckpt.checkpoint import Checkpointer
from dtdl_tpu_torch.data.loader import (LimitBatches, prefetch_to_device,
                                        resume_iter)
from dtdl_tpu_torch.metrics.device import MetricsQueue
from dtdl_tpu_torch.metrics.report import Reporter, StdoutSink
from dtdl_tpu_torch.models.netspec import build_net
from dtdl_tpu_torch.obs.observer import NULL_OBSERVER
from dtdl_tpu_torch.parallel.strategy import Strategy, check_strategy
from dtdl_tpu_torch.train import optim
from dtdl_tpu_torch.train.loop import evaluate as _evaluate
from dtdl_tpu_torch.train.state import TrainState, init_state
from dtdl_tpu_torch.train.step import make_eval_step, make_train_step
from dtdl_tpu_torch.utils.prototxt import Message, parse_file


def lr_schedule(sp: Message):
    """SolverParameter -> Caffe's lr_policy as a schedule (update count
    -> learning rate)."""
    base = float(sp.get_scalar("base_lr", 0.01))
    policy = str(sp.get_scalar("lr_policy", "fixed"))
    gamma = float(sp.get_scalar("gamma", 0.1))
    power = float(sp.get_scalar("power", 0.75))
    stepsize = int(sp.get_scalar("stepsize", 100000))
    max_iter = int(sp.get_scalar("max_iter", 10000))
    stepvalues = [int(v) for v in sp.getlist("stepvalue")]

    if policy == "fixed":
        return lambda it: base
    if policy == "step":
        return lambda it: base * gamma ** math.floor(it / stepsize)
    if policy == "exp":
        return lambda it: base * gamma ** it
    if policy == "inv":
        return lambda it: base * (1.0 + gamma * it) ** (-power)
    if policy == "multistep":
        bounds = stepvalues or [max_iter]
        return lambda it: base * gamma ** sum(it >= b for b in bounds)
    if policy == "poly":
        return lambda it: base * (1.0 - min(it, max_iter) / max_iter) ** power
    if policy == "sigmoid":
        return lambda it: base / (1.0 + math.exp(-gamma * (it - stepsize)))
    raise ValueError(f"unknown lr_policy {policy!r}")


def make_optimizer(sp: Message) -> optim.Transform:
    """SolverParameter -> the optimizer of Caffe's solver type, with
    weight_decay as L2 in front and ``iter_size`` as gradient
    accumulation around it."""
    schedule = lr_schedule(sp)
    # "momentum: 0.0" (explicit, honored) is not an absent momentum
    momentum = sp.get_scalar("momentum", None)
    momentum = float(momentum) if momentum is not None else None
    decay = float(sp.get_scalar("weight_decay", 0.0))
    delta = float(sp.get_scalar("delta", 1e-8))
    kind = str(sp.get_scalar("type", "SGD"))

    if kind in ("SGD", "Nesterov"):
        # optax applies nesterov only through a momentum trace
        opt = optim.sgd(schedule, momentum=momentum or None,
                        nesterov=kind == "Nesterov" and bool(momentum))
    elif kind == "Adam":
        opt = optim.adam(schedule,
                         b1=momentum if momentum is not None else 0.9,
                         b2=float(sp.get_scalar("momentum2", 0.999)),
                         eps=delta)
    elif kind == "AdaGrad":
        opt = optim.adagrad(schedule, eps=delta)
    elif kind == "RMSProp":
        opt = optim.rmsprop(schedule,
                            decay=float(sp.get_scalar("rms_decay", 0.99)),
                            eps=delta)
    elif kind == "AdaDelta":
        opt = optim.adadelta(schedule,
                             rho=momentum if momentum is not None else 0.95,
                             eps=delta)
    else:
        raise ValueError(f"unknown solver type {kind!r}")
    opt = optim.add_decayed_weights(decay, opt)
    return optim.multi_steps(opt, int(sp.get_scalar("iter_size", 1)))


class Solver:
    """``caffe train`` over the port's step engine.

    ``solve()`` / ``test()`` run against loaders of {'image', 'label'}
    batches from the data pipeline (a data-layer prototxt names the
    dataset; the batches come from :mod:`dtdl_tpu_torch.data`).  The
    net is built for the loader's example shape on ``device`` (``None``:
    the card), its fillers drawn from the prototxt's ``random_seed``.
    ``observer`` (:mod:`dtdl_tpu_torch.obs`) adds the ``dispatch`` and
    ``drain`` spans and each display window's goodput fields."""

    def __init__(self, solver_path_or_msg, train_loader, test_loader=None,
                 strategy: Strategy | None = None, dtype=torch.float32,
                 out: str | None = None, overrides: dict | None = None,
                 observer=None, device=None):
        self.observer = observer or NULL_OBSERVER
        sp = (parse_file(solver_path_or_msg)
              if isinstance(solver_path_or_msg, str) else solver_path_or_msg)
        # overrides land BEFORE the optimizer is built: lr policies like
        # poly/multistep read max_iter/stepvalue at construction
        if overrides:
            sp = Message({**sp, **overrides})
        self.param = sp
        self.strategy = check_strategy(strategy)
        self.train_loader = train_loader
        self.test_loader = test_loader

        base = os.path.dirname(solver_path_or_msg) if isinstance(
            solver_path_or_msg, str) else "."

        def _resolve(p):
            return p if os.path.isabs(p) else os.path.join(base, p)

        net_path = sp.get_scalar("net") or sp.get_scalar("train_net")
        if net_path is None:
            raise ValueError("solver prototxt names no net/train_net")
        sample = next(iter(train_loader))
        shape = tuple(sample["image"].shape[1:])
        self.net = build_net(_resolve(net_path), dtype, input_shape=shape,
                             device=device, seed=None)
        # split-file layout: a separate test_net shares weights by layer
        # name (Caffe's weight-sharing rule)
        test_net_path = sp.get_scalar("test_net")
        self.test_net = self.net
        if test_net_path:
            self.test_net = build_net(_resolve(test_net_path), dtype,
                                      input_shape=shape, device=device,
                                      seed=None)
            for name, layer in list(self.test_net.layers.items()):
                own = self.net.layers[name] if name in self.net.layers \
                    else None
                if own is None or own.weight.shape != layer.weight.shape:
                    raise ValueError(
                        f"test_net layer {name!r} has no train-net layer "
                        f"of the same name and shape to share weights with")
                self.test_net.layers[name] = own

        seed = int(sp.get_scalar("random_seed", 0))
        self.tx = make_optimizer(sp)
        self.state = self.strategy.replicate(init_state(
            self.net, seed, self.tx, device=self.net.device))
        self.train_step = make_train_step(self.strategy, seed=seed)
        self.eval_step = make_eval_step(self.strategy)

        # the full prefix is the snapshot namespace (caffe writes
        # <prefix>_iter_N; here <prefix>/snapshot_N) so two solvers with
        # different prefixes in one directory never clobber each other
        prefix = str(sp.get_scalar("snapshot_prefix", "./result/caffe_model"))
        self.out = out or prefix
        self.ckpt = Checkpointer(self.out)
        self.reporter = Reporter([StdoutSink()])
        self.iteration = 0

    @property
    def max_iter(self) -> int:
        return int(self.param.get_scalar("max_iter", 10000))

    def test(self) -> dict:
        """One test pass through the test net: ``test_iter`` batches (0 =
        the whole set), exact means over a padded ragged tail."""
        test_iter = int(self.param.get_scalar("test_iter", 0))
        loader = (LimitBatches(self.test_loader, test_iter) if test_iter
                  else self.test_loader)
        state = TrainState(self.state.step, self.test_net,
                           self.state.optimizer)
        means = _evaluate(self.eval_step, state, loader, self.strategy)
        return {f"test_{k}": v for k, v in means.items()}

    def snapshot(self) -> str:
        return self.ckpt.save(self.iteration, self.state)

    def restore(self, step: int | None = None) -> bool:
        state, it = self.ckpt.restore(self.state, step)
        if state is None:
            return False
        self.state, self.iteration = state, int(it)
        return True

    def solve(self) -> dict:
        """Run to max_iter with the display/test/snapshot cadence; returns
        the last reported metrics.

        Resume is replay-exact, as in JAX: the batch stream is a function
        of the batch counter (pass index = batches // len(loader) keys
        the shuffle, offset = batches % len(loader) is skipped at the
        index level by ``resume_iter``), and snapshots land on update
        boundaries, so restore() + solve() replays the stream an
        uninterrupted run would have seen.  Per-update metrics stay on
        the device in a bounded queue and convert at a display boundary
        or at the end."""
        sp = self.param
        display = int(sp.get_scalar("display", 0))
        test_interval = int(sp.get_scalar("test_interval", 0))
        snap = int(sp.get_scalar("snapshot", 0))
        iter_size = int(sp.get_scalar("iter_size", 1))
        if (self.test_loader is not None and test_interval
                and bool(sp.get_scalar("test_initialization", True))):
            self.reporter.report({"iter": self.iteration, **self.test()})
        last: dict = {}
        metrics = None
        queue = MetricsQueue(max(display, 1) if display else 8)
        newest: dict = {}
        step_fn = self.observer.watch(self.train_step, "solver.train_step")
        t_disp, iters_at_disp = time.perf_counter(), self.iteration
        try:
            steps_per_pass = len(self.train_loader)
        except TypeError:
            # unsized loader: resume restarts the interrupted pass
            steps_per_pass = None
        batches = self.iteration * iter_size
        try:
            while self.iteration < self.max_iter:
                if steps_per_pass:
                    pass_idx, skip = divmod(batches, steps_per_pass)
                else:
                    pass_idx, skip = self.iteration, 0
                self.train_loader.set_epoch(pass_idx)
                it = prefetch_to_device(resume_iter(self.train_loader, skip),
                                        self.strategy.shard_batch, 2)
                for batch in it:
                    if self.iteration >= self.max_iter:
                        break
                    with self.observer.span("dispatch",
                                            iteration=self.iteration):
                        self.state, metrics = step_fn(self.state, batch)
                    batches += 1
                    if batches % iter_size:
                        continue  # mid-accumulation: not an iteration yet
                    self.iteration += 1
                    popped = queue.push(metrics)
                    if popped:
                        newest = popped[-1]
                    if display and self.iteration % display == 0:
                        with self.observer.span("drain"):
                            drained = queue.drain()  # the window's one sync
                        if drained:
                            newest = drained[-1]
                        last = newest
                        goodput = self.observer.window(
                            self.iteration - iters_at_disp,
                            time.perf_counter() - t_disp)
                        t_disp = time.perf_counter()
                        iters_at_disp = self.iteration
                        self.reporter.report({"iter": self.iteration,
                                              **last, **goodput})
                    if (test_interval and self.test_loader is not None
                            and self.iteration % test_interval == 0):
                        last = self.test()
                        self.reporter.report({"iter": self.iteration, **last})
                    if snap and self.iteration % snap == 0:
                        self.snapshot()
            if not last and metrics is not None:
                drained = queue.drain()
                last = drained[-1] if drained else newest
            if snap:
                self.snapshot()
        finally:
            # async saves durable before return, on a crash too, so a
            # restarted solver restores the newest snapshot
            self.ckpt.wait_until_finished()
        return last
