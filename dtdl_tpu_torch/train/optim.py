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

A learning rate may be a schedule, a function of the update count
(:func:`exponential_decay`, optax's): as optax's ``scale_by_schedule``,
the n-th update (from 0) takes ``schedule(n)``, set on the optimizer's
param groups just before each ``step()``; the count is the group's
``"count"`` entry, which a snapshot saves and a restore sets.

The optimizer state lives beside the parameters, on their device and in
their dtype (f32 master weights keep f32 moments).
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


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4) -> Transform:
    hp = dict(lr=learning_rate, betas=(b1, b2), eps=eps,
              weight_decay=weight_decay)
    return Transform("adamw", lambda p: torch.optim.AdamW(p, **hp))


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Transform:
    hp = dict(lr=learning_rate, betas=(b1, b2), eps=eps, weight_decay=0.0)
    return Transform("adam", lambda p: torch.optim.Adam(p, **hp))


def sgd(learning_rate, momentum: float | None = None,
        nesterov: bool = False, weight_decay: float = 0.0) -> Transform:
    """``learning_rate`` a float or a schedule (count -> lr)."""
    if nesterov and not momentum:
        raise ValueError("nesterov needs a momentum")
    hp = dict(momentum=momentum or 0.0, nesterov=nesterov,
              weight_decay=weight_decay)
    if not callable(learning_rate):
        return Transform("sgd", lambda p: torch.optim.SGD(
            p, lr=learning_rate, **hp))
    return Transform("sgd", lambda p: _scheduled(
        torch.optim.SGD(p, lr=learning_rate(0), **hp), learning_rate))


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


class RMSProp(torch.optim.Optimizer):
    """optax's ``rmsprop`` (``scale_by_rms`` then ``-lr``): nu ← decay·nu
    + (1 - decay)·g², p ← p - lr·g·rsqrt(nu + eps), nu starting at 0.
    ``torch.optim.RMSprop`` is another function (alpha 0.99 by default,
    eps outside the square root)."""

    def __init__(self, params, lr: float, decay: float = 0.9,
                 eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("RMSProp takes no closure")
        for group in self.param_groups:
            decay, eps, lr = group["decay"], group["eps"], group["lr"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
                g = p.grad
                nu = state["nu"]
                nu.mul_(decay).addcmul_(g, g, value=1.0 - decay)
                p.addcmul_(g, (nu + eps).rsqrt(), value=-lr)


def rmsprop(learning_rate: float, decay: float = 0.9,
            eps: float = 1e-8) -> Transform:
    """optax's ``rmsprop`` at its defaults (no momentum, not centered,
    eps inside the square root): :class:`RMSProp`."""
    return Transform("rmsprop", lambda p: RMSProp(p, learning_rate, decay,
                                                  eps))


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
