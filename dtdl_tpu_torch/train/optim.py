"""The optax transforms the JAX package trains with, as ``torch.optim``.

Each function returns a :class:`Transform`, whose ``init(params)`` builds
the ``torch.optim.Optimizer`` over the given parameters, as optax's
``tx.init(params)`` builds the optimizer state.  The defaults are optax's,
not torch's.  The update rules are the same up to floating-point rounding
order; with m, v the moment estimates of gradient g at step t, and the
bias corrections m̂ = m / (1 - b1^t), v̂ = v / (1 - b2^t):

* ``adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4)``: optax
  computes u = m̂ / (√v̂ + eps) + wd·p and p ← p - lr·u; torch's AdamW
  computes p ← p·(1 - lr·wd), then p ← p - lr·m̂ / (√v̂ + eps), which is
  p - lr·(m̂ / (√v̂ + eps) + wd·p) for the same old p.  torch's default
  decay is 1e-2, optax's 1e-4; here it is optax's.  As optax with
  ``mask=None``, the decay applies to every parameter, norm scales and
  the embedding included.
* ``adam(lr, b1=0.9, b2=0.999, eps=1e-8)``: the same without decay
  (``torch.optim.Adam``, weight_decay 0).
* ``sgd(lr, momentum=None, nesterov=False)``: optax's trace t = g +
  momentum·t (t starts at 0) with update -lr·t, or -lr·(g + momentum·t)
  with Nesterov, is torch's SGD buffer b = momentum·b + g (b starts at
  g, dampening 0); without momentum both are p ← p - lr·g.
* ``sgd(lr, momentum, weight_decay=wd)`` is optax's
  ``chain(add_decayed_weights(wd), sgd(lr, momentum))`` (the JAX
  examples' ``sgd_steplr``, the reference's SGD + StepLR): optax adds
  wd·p to the gradient before the trace, and torch's ``SGD(weight_decay=
  wd)`` adds wd·p to the gradient before the momentum buffer.
* ``rmsprop(lr, decay=0.9, eps=1e-8)``: optax's ``scale_by_rms``,
  nu ← decay·nu + (1 - decay)·g², update g·rsqrt(nu + eps) (the port's
  own :class:`RMSProp`: ``torch.optim.RMSprop`` is another function).
* ``adagrad(lr, initial_accumulator_value=0.1, eps=1e-7)``: optax's
  ``scale_by_rss``, acc ← acc + g² (acc starting at the initial value),
  update g·rsqrt(acc + eps), 0 where acc is 0 (the port's own
  :class:`AdaGrad`: ``torch.optim.Adagrad`` starts at 0 and puts eps
  outside the root).
* ``adadelta(lr, rho=0.9, eps=1e-6)``: optax's ``scale_by_adadelta``
  then ``-lr`` (the port's own :class:`AdaDelta`; torch's Adadelta
  defaults to lr 1.0).
* ``add_decayed_weights(wd, tx)`` is optax's ``chain(add_decayed_weights(
  wd), tx)``: wd·p is added to the gradient before ``tx`` reads it (L2,
  Caffe's ``weight_decay``; for adam that is not AdamW's decoupled
  decay).
* ``multi_steps(tx, k)`` is optax's ``MultiSteps`` (Caffe's
  ``iter_size``): :class:`MultiSteps`.

A learning rate may be a schedule, a function of the update count
(:func:`exponential_decay`, :func:`warmup_cosine_decay_schedule`,
optax's): as optax's ``scale_by_schedule``,
the n-th update (from 0) takes ``schedule(n)``, set on the optimizer's
param groups just before each ``step()``; the count is the group's
``"count"`` entry, which a snapshot saves and a restore sets.

The optimizer state lives beside the parameters, on their device and in
their dtype (f32 master weights keep f32 moments); on the card Adam and
AdamW are built ``capturable``, so their step counters live there too.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable

import torch


@dataclass(frozen=True)
class Transform:
    """A named optimizer recipe; ``init(params)`` builds the optimizer."""
    name: str
    make: Callable = field(repr=False)

    def init(self, params) -> torch.optim.Optimizer:
        return self.make(list(params))


def _build(name: str, ctor, learning_rate, **hp) -> Transform:
    """A Transform whose optimizer is ``ctor(params, lr=..., **hp)``;
    ``learning_rate`` a float or a schedule (count -> lr)."""
    if not callable(learning_rate):
        return Transform(name, lambda p: ctor(p, lr=learning_rate, **hp))
    return Transform(name, lambda p: _scheduled(
        ctor(p, lr=learning_rate(0), **hp), learning_rate))


def _capturable(ctor):
    """``ctor`` with ``capturable=True`` for parameters on the card: the
    step counters then live on the device beside the moments, so a step
    guard can keep a suppressed update's count without a wait
    (:mod:`dtdl_tpu_torch.resil.guard`).  Guarded and unguarded steps
    build the same optimizer, so they stay one function."""
    def make(params, **hp):
        tensors = [t for p in params
                   for t in (p["params"] if isinstance(p, dict) else [p])]
        return ctor(params, capturable=any(t.is_cuda for t in tensors),
                    **hp)
    return make


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4) -> Transform:
    hp = dict(lr=learning_rate, betas=(b1, b2), eps=eps,
              weight_decay=weight_decay)
    return Transform("adamw",
                     lambda p: _capturable(torch.optim.AdamW)(p, **hp))


def adam(learning_rate, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Transform:
    """``learning_rate`` a float or a schedule (count -> lr)."""
    return _build("adam", _capturable(torch.optim.Adam), learning_rate,
                  betas=(b1, b2), eps=eps, weight_decay=0.0)


def sgd(learning_rate, momentum: float | None = None,
        nesterov: bool = False, weight_decay: float = 0.0) -> Transform:
    """``learning_rate`` a float or a schedule (count -> lr)."""
    if nesterov and not momentum:
        raise ValueError("nesterov needs a momentum")
    return _build("sgd", torch.optim.SGD, learning_rate,
                  momentum=momentum or 0.0, nesterov=nesterov,
                  weight_decay=weight_decay)


def _scheduled(opt: torch.optim.Optimizer, schedule) -> torch.optim.Optimizer:
    """Set each group's lr to ``schedule(count)`` just before every
    ``step()``, ``count`` the group's update count (optax's
    ``scale_by_schedule`` count).  The count lives in the param group,
    so a snapshot carries it and a restored run continues the schedule
    from it."""
    for group in opt.param_groups:
        group["count"] = 0

    def set_lr(optimizer, args, kwargs):
        for group in optimizer.param_groups:
            group["lr"] = schedule(group["count"])
            group["count"] += 1
    opt.register_step_pre_hook(set_lr)
    return opt


class OwnOptimizer(torch.optim.Optimizer):
    """Base of the port's own optimizers (optax's functions where torch's
    differ): ``fresh(p, group)`` is the state a parameter gets at its
    first update, which the snapshot view also asks for;
    ``update(p, g, state, group)`` is one update of ``p`` in place."""

    def fresh(self, p, group) -> dict:
        raise NotImplementedError

    def update(self, p, g, state, group) -> None:
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError(f"{type(self).__name__} takes no closure")
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state.update(self.fresh(p, group))
                self.update(p, p.grad, state, group)


def _zeros(p):
    return torch.zeros_like(p, memory_format=torch.preserve_format)


class RMSProp(OwnOptimizer):
    """optax's ``rmsprop`` (``scale_by_rms`` then ``-lr``): nu ← decay·nu
    + (1 - decay)·g², p ← p - lr·g·rsqrt(nu + eps), nu starting at 0.
    ``torch.optim.RMSprop`` is another function (alpha 0.99 by default,
    eps outside the square root)."""

    def __init__(self, params, lr: float, decay: float = 0.9,
                 eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    def fresh(self, p, group) -> dict:
        return {"nu": _zeros(p)}

    def update(self, p, g, state, group) -> None:
        nu = state["nu"]
        nu.mul_(group["decay"]).addcmul_(g, g, value=1.0 - group["decay"])
        p.addcmul_(g, (nu + group["eps"]).rsqrt(), value=-group["lr"])


class AdaGrad(OwnOptimizer):
    """optax's ``adagrad`` (``scale_by_rss`` then ``-lr``): acc ← acc +
    g², p ← p - lr·g·rsqrt(acc + eps) where acc > 0 (0 elsewhere), acc
    starting at ``initial_accumulator_value``."""

    def __init__(self, params, lr: float,
                 initial_accumulator_value: float = 0.1, eps: float = 1e-7):
        super().__init__(params, dict(lr=lr, eps=eps,
                                      initial=initial_accumulator_value))

    def fresh(self, p, group) -> dict:
        return {"sum_of_squares": torch.full_like(
            p, group["initial"], memory_format=torch.preserve_format)}

    def update(self, p, g, state, group) -> None:
        acc = state["sum_of_squares"]
        acc.addcmul_(g, g)
        inv = torch.where(acc > 0, (acc + group["eps"]).rsqrt(),
                          torch.zeros_like(acc))
        p.addcmul_(g, inv, value=-group["lr"])


class AdaDelta(OwnOptimizer):
    """optax's ``adadelta`` (``scale_by_adadelta`` then ``-lr``): e_g ←
    rho·e_g + (1 - rho)·g², u = g·√(e_x + eps) / √(e_g + eps), e_x ←
    rho·e_x + (1 - rho)·u², p ← p - lr·u; e_g and e_x start at 0."""

    def __init__(self, params, lr: float, rho: float = 0.9,
                 eps: float = 1e-6):
        super().__init__(params, dict(lr=lr, rho=rho, eps=eps))

    def fresh(self, p, group) -> dict:
        return {"e_g": _zeros(p), "e_x": _zeros(p)}

    def update(self, p, g, state, group) -> None:
        rho, eps = group["rho"], group["eps"]
        e_g, e_x = state["e_g"], state["e_x"]
        e_g.mul_(rho).addcmul_(g, g, value=1.0 - rho)
        u = (e_x + eps).sqrt() / (e_g + eps).sqrt() * g
        e_x.mul_(rho).addcmul_(u, u, value=1.0 - rho)
        p.add_(u, alpha=-group["lr"])


def rmsprop(learning_rate, decay: float = 0.9,
            eps: float = 1e-8) -> Transform:
    """optax's ``rmsprop`` at its defaults (no momentum, not centered,
    eps inside the square root): :class:`RMSProp`.  ``learning_rate`` a
    float or a schedule."""
    return _build("rmsprop", RMSProp, learning_rate, decay=decay, eps=eps)


def adagrad(learning_rate, initial_accumulator_value: float = 0.1,
            eps: float = 1e-7) -> Transform:
    """optax's ``adagrad``: :class:`AdaGrad`."""
    return _build("adagrad", AdaGrad, learning_rate,
                  initial_accumulator_value=initial_accumulator_value,
                  eps=eps)


def adadelta(learning_rate, rho: float = 0.9, eps: float = 1e-6
             ) -> Transform:
    """optax's ``adadelta`` with a learning rate: :class:`AdaDelta`."""
    return _build("adadelta", AdaDelta, learning_rate, rho=rho, eps=eps)


class MultiSteps:
    """optax's ``MultiSteps(inner, every_k_schedule=k)`` over a torch
    optimizer.  Each :meth:`step` folds the gradients the parameters hold
    into a running mean, ``acc ← acc + (g - acc) / (mini_step + 1)``;
    every k-th call the inner optimizer updates from that mean (its count
    and its schedule advance on those calls only) and the mean restarts
    at 0; the other calls leave the parameters as they are.

    ``param_groups`` and ``state`` are the inner optimizer's; the
    accumulator (``acc``, by parameter) and ``mini_step`` are this
    object's, and the snapshot view saves them
    (:func:`dtdl_tpu_torch.train.state.state_to_tree`)."""

    def __init__(self, inner: torch.optim.Optimizer, every_k: int):
        if every_k < 1:
            raise ValueError(f"every_k must be >= 1, got {every_k}")
        self.inner, self.every_k = inner, every_k
        self.acc: dict = {}
        self.mini_step = 0

    @property
    def param_groups(self):
        return self.inner.param_groups

    @property
    def state(self):
        return self.inner.state

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.inner.zero_grad(set_to_none=set_to_none)

    def acc_of(self, p) -> torch.Tensor:
        """``p``'s accumulator, created as zeros on first use."""
        if p not in self.acc:
            self.acc[p] = _zeros(p)
        return self.acc[p]

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("MultiSteps takes no closure")
        params = [p for g in self.param_groups for p in g["params"]
                  if p.grad is not None]
        for p in params:
            acc = self.acc_of(p)
            acc.add_((p.grad - acc) / (self.mini_step + 1))
        if self.mini_step < self.every_k - 1:
            self.mini_step += 1
            return
        for p in params:
            p.grad.copy_(self.acc[p])
        self.inner.step()
        for p in params:
            self.acc[p].zero_()
        self.mini_step = 0


def multi_steps(tx: Transform, every_k: int) -> Transform:
    """optax's ``MultiSteps(tx, every_k)``: :class:`MultiSteps` (``tx``
    itself at ``every_k`` 1)."""
    if every_k == 1:
        return tx
    return Transform(f"multi_steps({every_k})+{tx.name}",
                     lambda p: MultiSteps(tx.make(p), every_k))


def add_decayed_weights(weight_decay: float, tx: Transform) -> Transform:
    """optax's ``chain(add_decayed_weights(weight_decay), tx)``: just
    before each update of ``tx``'s optimizer, ``weight_decay``·p is added
    to every gradient it is about to read (``tx`` itself at 0)."""
    if not weight_decay:
        return tx

    def add_l2(optimizer, args, kwargs):
        with torch.no_grad():
            for group in optimizer.param_groups:
                for p in group["params"]:
                    if p.grad is not None:
                        p.grad.add_(p, alpha=weight_decay)

    def make(params):
        opt = tx.make(params)
        inner = opt.inner if isinstance(opt, MultiSteps) else opt
        inner.register_step_pre_hook(add_l2)
        return opt
    return Transform(f"add_decayed_weights+{tx.name}", make)


def exponential_decay(init_value: float, transition_steps: int,
                      decay_rate: float, staircase: bool = False
                      ) -> Callable[[int], float]:
    """optax's ``exponential_decay``: count n -> init·rate^(n / steps),
    the exponent floored with ``staircase`` (a step decay every
    ``transition_steps`` updates).  ``transition_steps <= 0`` gives the
    constant ``init_value``, as optax."""
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count: int) -> float:
        p = count / transition_steps
        return init_value * decay_rate ** (math.floor(p) if staircase else p)
    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0
                                 ) -> Callable[[int], float]:
    """optax's ``warmup_cosine_decay_schedule``: linear from
    ``init_value`` to ``peak_value`` over ``warmup_steps`` counts, then a
    cosine from ``peak_value`` to ``end_value`` over the remaining
    ``decay_steps - warmup_steps`` counts, and ``end_value`` after
    them."""
    span = decay_steps - warmup_steps
    if span <= 0:
        raise ValueError(f"The cosine_decay_schedule requires positive "
                         f"decay_steps, got decay_steps={span}.")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - max(count, 0) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        t = min(count - warmup_steps, span)
        decay = 0.5 * (1.0 + math.cos(math.pi * t / span))
        return peak_value * ((1.0 - alpha) * decay + alpha)
    return schedule
