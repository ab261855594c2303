"""The optimizers and schedules the Solver and the ResNet-50 example take
(``dtdl_tpu_torch.train.optim``: ``adagrad``, ``adadelta``, ``rmsprop``
and ``adam`` with schedules, ``add_decayed_weights``, ``multi_steps``,
``warmup_cosine_decay_schedule``) against optax, on the CPU.

Each runs six updates of a small parameter set from the same start and
the same gradients in both, in float64 (torch's default dtype set to f64,
optax under ``jax.enable_x64``): the parameters within 1e-12.  The
schedule's values over counts 0..steps+5 within 1e-7 of optax's.  The
new optimizers' state goes into a snapshot and back (``state_to_tree``,
a ``MultiSteps`` accumulator and mini-step included).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dtdl_tpu_torch.train import optim
from dtdl_tpu_torch.train.state import (TrainState, load_state_tree,
                                        state_to_tree)


@pytest.fixture
def f64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    with jax.enable_x64():
        yield
    torch.set_default_dtype(old)


def schedule(count):
    return 0.05 * (1.0 + 0.1 * count) ** -0.75


def jschedule(count):
    return 0.05 * (1.0 + 0.1 * count) ** -0.75


RNG = np.random.default_rng(0)
P0 = {"w": RNG.normal(size=(3, 4)), "b": RNG.normal(size=(4,))}
P0["b"][1] = 0.0          # a parameter at exactly 0
GRADS = [{k: RNG.normal(size=v.shape) for k, v in P0.items()}
         for _ in range(6)]
for g in GRADS[:2]:
    g["b"][2] = 0.0       # a gradient at exactly 0 (adagrad's where)


def run_port(tx):
    params = [torch.nn.Parameter(torch.tensor(P0[k])) for k in ("w", "b")]
    opt = tx.init(params)
    for g in GRADS:
        for p, k in zip(params, ("w", "b")):
            p.grad = torch.tensor(g[k])
        opt.step()
    return [p.detach().numpy() for p in params]


def run_optax(tx):
    p = {k: jnp.asarray(v) for k, v in P0.items()}
    s = tx.init(p)
    for g in GRADS:
        u, s = tx.update({k: jnp.asarray(v) for k, v in g.items()}, s, p)
        p = optax.apply_updates(p, u)
    return [np.asarray(p["w"]), np.asarray(p["b"])]


CASES = {
    "adagrad": (lambda: optim.adagrad(0.1),
                lambda: optax.adagrad(0.1)),
    "adagrad scheduled, eps": (lambda: optim.adagrad(schedule, eps=1e-4),
                               lambda: optax.adagrad(jschedule, eps=1e-4)),
    "adagrad initial 0": (
        lambda: optim.adagrad(0.1, initial_accumulator_value=0.0),
        lambda: optax.adagrad(0.1, initial_accumulator_value=0.0)),
    "adadelta": (lambda: optim.adadelta(1.0),
                 lambda: optax.adadelta(1.0)),
    "adadelta scheduled": (
        lambda: optim.adadelta(schedule, rho=0.95, eps=1e-8),
        lambda: optax.adadelta(jschedule, rho=0.95, eps=1e-8)),
    "rmsprop scheduled": (lambda: optim.rmsprop(schedule, decay=0.99),
                          lambda: optax.rmsprop(jschedule, decay=0.99)),
    "adam scheduled": (lambda: optim.adam(schedule, b1=0.0, b2=0.99),
                       lambda: optax.adam(jschedule, b1=0.0, b2=0.99)),
    "adam + decay": (
        lambda: optim.add_decayed_weights(0.05, optim.adam(schedule)),
        lambda: optax.chain(optax.add_decayed_weights(0.05),
                            optax.adam(jschedule))),
    "sgd nesterov + decay": (
        lambda: optim.add_decayed_weights(
            0.01, optim.sgd(schedule, momentum=0.9, nesterov=True)),
        lambda: optax.chain(optax.add_decayed_weights(0.01),
                            optax.sgd(jschedule, momentum=0.9,
                                      nesterov=True))),
    "multi_steps(3) adagrad + decay": (
        lambda: optim.multi_steps(optim.add_decayed_weights(
            0.05, optim.adagrad(schedule)), 3),
        lambda: optax.MultiSteps(optax.chain(optax.add_decayed_weights(0.05),
                                             optax.adagrad(jschedule)), 3)),
    "multi_steps(2) sgd momentum": (
        lambda: optim.multi_steps(optim.sgd(schedule, momentum=0.9), 2),
        lambda: optax.MultiSteps(optax.sgd(jschedule, momentum=0.9), 2)),
}


@pytest.mark.parametrize("name", CASES)
def test_optimizer_matches_optax(name, f64):
    port, jax_tx = CASES[name]
    for got, want in zip(run_port(port()), run_optax(jax_tx())):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_multi_steps_counts_updates_not_mini_steps(f64):
    """The schedule (and the inner count) advance on the k-th calls
    only; between them the parameters stay as they are."""
    p = torch.nn.Parameter(torch.ones(2))
    opt = optim.multi_steps(optim.sgd(schedule), 3).init([p])
    seen = []
    for i in range(7):
        p.grad = torch.full((2,), float(i + 1))
        before = p.detach().clone()
        opt.step()
        seen.append((opt.mini_step, opt.param_groups[0]["count"],
                     bool(torch.equal(before, p.detach()))))
    assert seen == [(1, 0, True), (2, 0, True), (0, 1, False),
                    (1, 1, True), (2, 1, True), (0, 2, False),
                    (1, 2, True)]
    with pytest.raises(ValueError, match="every_k"):
        optim.MultiSteps(opt.inner, 0)


@pytest.mark.parametrize("args", [(0.0, 0.4, 20, 100), (0.1, 1.0, 3, 10),
                                  (0.0, 0.2, 0, 50), (0.05, 0.3, 5, 6,
                                                      0.01)])
def test_warmup_cosine_decay_matches_optax(args, f64):
    got = optim.warmup_cosine_decay_schedule(*args)
    want = optax.warmup_cosine_decay_schedule(*args)
    steps = args[3]
    np.testing.assert_allclose([got(c) for c in range(steps + 6)],
                               [float(want(c)) for c in range(steps + 6)],
                               rtol=0, atol=1e-7)
    with pytest.raises(ValueError, match="positive decay_steps"):
        optim.warmup_cosine_decay_schedule(0.0, 1.0, 10, 10)


class Tiny(torch.nn.Module):
    """The smallest model the snapshot view takes: its parameters under
    their own names."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.arange(6.0).reshape(2, 3) / 7)
        self.b = torch.nn.Parameter(torch.ones(3))


@pytest.mark.parametrize("tx,slots", [
    (lambda: optim.adagrad(schedule), {"sum_of_squares"}),
    (lambda: optim.adadelta(0.5), {"e_g", "e_x"}),
    (lambda: optim.multi_steps(optim.add_decayed_weights(
        0.1, optim.rmsprop(schedule)), 2), {"nu", "acc"}),
])
def test_new_optimizers_snapshot_and_restore(tx, slots):
    def state():
        m = Tiny()
        return TrainState(0, m, tx().init(m.parameters()))

    def step(s, i):
        for p in s.model.parameters():
            p.grad = torch.full_like(p, 0.1 * (i + 1)) + p.detach()
        s.apply_gradients()

    a, b = state(), state()
    fresh = state_to_tree(b)
    assert set(fresh["opt_state"]) - {"count", "mini_step"} == slots
    for i in range(3):
        step(a, i)
        step(b, i)
    tree = {k: v for k, v in state_to_tree(b).items()}
    tree = torch.utils._pytree.tree_map(
        lambda x: x.clone() if isinstance(x, torch.Tensor) else x, tree)
    c = load_state_tree(state(), tree)
    for i in range(3, 6):
        step(a, i)
        step(c, i)
    for pa, pc in zip(a.model.parameters(), c.model.parameters()):
        assert torch.equal(pa, pc)
