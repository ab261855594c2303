"""Train state, the port of dtdl_tpu/train/state.py.

The JAX :class:`TrainState` is an immutable pytree (step, params,
opt_state, batch_stats) that every step replaces.  Here the parameters
live in the model and the optimizer state in a ``torch.optim``
optimizer, and :meth:`TrainState.apply_gradients` updates both in place
where JAX returns a new state: PyTorch keeps one copy of the weights and
moments instead of a donated old and a new one.  A classifier's BatchNorm
statistics live in its BN modules' buffers, which a train-mode forward
updates; :attr:`TrainState.batch_stats` shows them in the flax tree
shape.
"""

from __future__ import annotations

import torch

from dtdl_tpu_torch.bridge import (_classifier_leaves, _flax_layout, _nest,
                                   batch_stats_view, flatten)
from dtdl_tpu_torch.device import resolve_device
from dtdl_tpu_torch.models.layers import Classifier
from dtdl_tpu_torch.train.optim import (MultiSteps, OwnOptimizer,
                                         Transform)


class TrainState:
    """``step`` counts the updates applied: the updates dispatched less
    those a step guard suppressed (:attr:`skipped`, a device count the
    guard adds its flags to, so the step never waits for the card; reading
    ``step`` under a guard settles it).  Setting ``step`` resets both."""

    def __init__(self, step: int, model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer):
        self.model = model                # the params
        self.optimizer = optimizer        # the opt_state
        self.step = step

    def __repr__(self) -> str:
        return (f"TrainState(step={self._dispatched}"
                f"{'' if self.skipped is None else ' - skipped'}, "
                f"model={type(self.model).__name__}, "
                f"optimizer={type(self.optimizer).__name__})")

    @property
    def step(self) -> int:
        if self.skipped is None:
            return self._dispatched
        return self._dispatched - int(self.skipped)

    @step.setter
    def step(self, value: int) -> None:
        self._dispatched = int(value)
        self.skipped = None

    def count_skipped(self, bad: torch.Tensor) -> None:
        """Add a guard's 0-d ``bad`` flag to the device count of
        suppressed updates."""
        if self.skipped is None:
            self.skipped = torch.zeros((), dtype=torch.int64,
                                       device=bad.device)
        self.skipped.add_(bad.to(torch.int64))

    @property
    def batch_stats(self) -> dict | None:
        """The model's BatchNorm statistics as the flax ``batch_stats``
        tree of its live buffers; ``None`` for a model without BatchNorm
        (the LM, the MLP, the CNN)."""
        return batch_stats_view(self.model)

    def apply_gradients(self) -> "TrainState":
        """One optimizer update from the gradients the parameters hold
        (``.grad``), and step + 1: in place, where JAX's
        ``apply_gradients`` returns a new state."""
        self.optimizer.step()
        self._dispatched += 1
        return self


def init_state(model, seed: int | None, tx: Transform,
               device=None) -> TrainState:
    """Weights of ``model`` from ``seed`` (an explicit CPU
    ``torch.Generator``, so one seed gives the same weights on every
    device; a classifier as the JAX ``conv_init``/flax defaults draw
    them, BatchNorm statistics reset; ``None`` keeps the weights the
    model holds, e.g. after a bridge load) and the optimizer ``tx`` over
    them.  ``device`` must be the model's (``None`` = the card, as for
    every entry point)."""
    dev = resolve_device(device)
    if dev != model.device:
        raise ValueError(f"the model lives on {model.device}, the state was "
                         f"asked for {dev}")
    if seed is not None:
        model.init_weights(seed)
    model.train()
    return TrainState(step=0, model=model,
                      optimizer=tx.init(model.parameters()))


# ---- the snapshot view -------------------------------------------------------

def _param_paths(model) -> list:
    """(flax path, parameter, layout kind) for every parameter."""
    if isinstance(model, Classifier):
        own = dict(model.named_parameters())
        return [(path, own[key], kind) for (coll, path), (key, kind)
                in _classifier_leaves(model).items() if coll == "params"]
    return [(name.replace(".", "/"), p, None)
            for name, p in model.named_parameters()]


def _scalar_dtype() -> torch.dtype:
    return torch.float64 if torch.get_default_dtype() == torch.float64 \
        else torch.float32


def _fresh_slots(optimizer, group, p) -> dict:
    """The state torch creates for ``p`` at its first update (zeros; a
    zero SGD momentum buffer gives the buffer torch would start from,
    the first gradient, as optax's trace starting at 0 does)."""
    if isinstance(optimizer, (torch.optim.Adam, torch.optim.AdamW)):
        on_dev = group.get("capturable") or group.get("fused")
        out = {"step": torch.zeros((), dtype=_scalar_dtype(),
                                   device=p.device if on_dev else "cpu")}
        for slot in ("exp_avg", "exp_avg_sq") + (
                ("max_exp_avg_sq",) if group.get("amsgrad") else ()):
            out[slot] = torch.zeros_like(p, memory_format=torch.preserve_format)
        return out
    if isinstance(optimizer, torch.optim.SGD):
        return ({"momentum_buffer": torch.zeros_like(
            p, memory_format=torch.preserve_format)}
            if group["momentum"] else {})
    if isinstance(optimizer, OwnOptimizer):
        return optimizer.fresh(p, group)
    raise TypeError(f"no snapshot view of {type(optimizer).__name__} state")


def _opt_tree(state, install: bool) -> dict:
    """{slot: {flax path: tensor}} of the optimizer state (live tensors
    in flax layout; a slot torch has not created yet as its zeros, which
    ``install`` puts into the optimizer), plus ``count``; under
    :class:`MultiSteps` also its accumulator (slot ``acc``) and
    ``mini_step``."""
    wrapper = state.optimizer
    multi = isinstance(wrapper, MultiSteps)
    opt = wrapper.inner if multi else wrapper
    group_of = {p: g for g in opt.param_groups for p in g["params"]}
    tree: dict = {}
    for path, p, kind in _param_paths(state.model):
        if p not in group_of:
            continue
        live = opt.state.get(p)
        if not live:
            live = _fresh_slots(opt, group_of[p], p)
            if install and live:
                opt.state[p] = live
        if multi:
            live = {**live, "acc": wrapper.acc_of(p)}
        for slot, v in live.items():
            if not isinstance(v, torch.Tensor):
                continue
            if v.dim() == p.dim() and kind is not None:
                v = _flax_layout(kind, v)
            tree.setdefault(slot, {})[path] = v
    counts = {g["count"] for g in opt.param_groups if "count" in g}
    if len(counts) > 1:
        raise ValueError(f"param groups at different update counts {counts}")
    if counts:
        tree["count"] = counts.pop()
    if multi:
        tree["mini_step"] = wrapper.mini_step
    return tree


def params_tree(model) -> dict:
    """The model's parameters under flax paths, in flax's layouts (live
    views, no copy): the ``params`` of :func:`state_to_tree`."""
    return _nest({path: (_flax_layout(kind, p) if kind else p).detach()
                  for path, p, kind in _param_paths(model)})


def state_to_tree(state: TrainState) -> dict:
    """{"step", "params", "opt_state", "batch_stats"} of ``state``, each
    tensor the LIVE one (a layout view, no copy): copy it before the
    next step changes it.  ``batch_stats`` is ``None`` without
    BatchNorm."""
    opt = _opt_tree(state, install=False)
    return {"step": int(state.step), "params": params_tree(state.model),
            "opt_state": {k: (_nest(v) if isinstance(v, dict) else v)
                          for k, v in opt.items()},
            "batch_stats": state.batch_stats}


def load_state_tree(state: TrainState, tree: dict) -> TrainState:
    """Copy a snapshot tree (as :func:`state_to_tree` gives it, the
    tensors anywhere) into ``state`` in place: every tensor keeps the
    device and dtype of the state's own (Adam's per-parameter ``step``
    stays where torch keeps it); ``step`` and the schedule's count are
    set, so the next update takes the learning rate the uninterrupted run
    would.  The caller validates the tree first
    (:func:`dtdl_tpu_torch.ckpt.checkpoint.validate_tree`)."""
    live = state_to_tree(state)
    live["opt_state"] = {k: (_nest(v) if isinstance(v, dict) else v)
                         for k, v in _opt_tree(state, install=True).items()}
    want, got = flatten(live), flatten(tree)
    with torch.no_grad():
        for path, dst in want.items():
            if isinstance(dst, torch.Tensor):
                dst.copy_(got[path])
    state.step = int(tree["step"])
    count = tree["opt_state"].get("count")
    if count is not None:
        for group in state.optimizer.param_groups:
            group["count"] = int(count)
    if isinstance(state.optimizer, MultiSteps):
        state.optimizer.mini_step = int(tree["opt_state"]["mini_step"])
    return state
