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

A learning rate may be a schedule, a function of the update count
(:func:`exponential_decay`, optax's): as optax's ``scale_by_schedule``,
the n-th update (from 0) takes ``schedule(n)``, set on the optimizer's
param groups just before each ``step()``.

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

    def make(params):
        opt = torch.optim.SGD(params, lr=learning_rate(0), **hp)
        count = [0]

        def set_lr(optimizer, args, kwargs):
            for group in optimizer.param_groups:
                group["lr"] = learning_rate(count[0])
            count[0] += 1
        opt.register_step_pre_hook(set_lr)
        return opt
    return Transform("sgd", make)


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
