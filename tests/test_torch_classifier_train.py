"""The port's classifier steps against the JAX package's, on the CPU.

One flax variable tree per model (made as in
``tests/test_torch_classifier.py``) goes into both packages: the JAX
``TrainState`` with ``dtdl_tpu.train.make_train_step`` (``SingleDevice``)
and the port's ``init_state(model, None, tx)`` with its
``make_train_step``; the same numpy batches then go through both.
Compared: loss and accuracy, every parameter and every BatchNorm
statistic after one SGD step (lr 0.1, momentum 0.9, weight decay 0.05,
so the decay moves every parameter by 5e-3 of itself), and after three
steps of the JAX examples' ``sgd_steplr`` chain,
``chain(add_decayed_weights(wd), sgd(exponential_decay(lr, 2, 0.1,
staircase=True), momentum))``, whose learning rate drops tenfold before
the third step; ``make_eval_step``'s masked sums and
``make_predict_step``.

The oracle is the JAX package computed in float64: its models built with
``dtype=jnp.float64`` under ``jax.enable_x64`` (the same code and steps),
against the port in f32.  The JAX models' f32 path is too coarse to hold
a gradient to: flax's BatchNorm takes the variance as E[x²] - E[x]², and
on the 4 x 64 x 64 ResNet batch its f32 BN outputs lie up to 9e-5 from
its own f64 ones (the port's, with torch's variance about the mean,
within 1e-5).

Tolerances (port f32 against JAX f64): loss within 1e-5 relative and
accuracy exact; params atol 1e-6 after one step and 1e-5 after three;
statistics within 1e-5 of each BatchNorm's scale (``stats_err``); eval
sums and logits within 1e-5 relative.  The ResNet is a ReLU network whose
last stage normalizes 16 values a channel: an f32 rounding moves a ReLU
input that lies within it of 0 across the kink, which switches that
element's gradient on or off, and BN over 16 values spreads the change
over its channel (one such switch moved the stem BN's bias by 3.6e-5
after one step at lr 0.1).  No fixed bound holds that, so for the ResNet
each bound widens by twice the JAX package's own f32 error at that
tensor (its f32 step against its f64 one, computed in the test): the
port's f32 step must be about as close to the exact step as the
reference's own f32 step is.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dtdl_tpu import models as jmodels
from dtdl_tpu.train import (TrainState, make_eval_step as jax_eval_step,
                            make_predict_step as jax_predict_step,
                            make_train_step as jax_train_step)
from dtdl_tpu_torch import bridge, models
from dtdl_tpu_torch.train.optim import exponential_decay, sgd
from dtdl_tpu_torch.train.state import init_state
from dtdl_tpu_torch.train.step import (make_eval_step, make_predict_step,
                                       make_train_step)
from test_torch_classifier import random_tree, stats_err

# small shapes: one intra-op thread each leaves the cores to the other
# test workers
torch.set_num_threads(1)

LR, MOMENTUM, WD = 0.1, 0.9, 0.05
CALIBRATED = ("resnet",)

F64 = jnp.float64

# name -> (JAX model of a dtype, port model (no weights), NHWC input
# shape, classes)
MODELS = {
    "mlp": (lambda dt=F64: jmodels.MLP(n_units=32, dtype=dt),
            lambda: models.MLP(n_units=32, device="cpu", seed=None),
            (8, 784), 10),
    "cnn": (lambda dt=F64: jmodels.MnistCNN(dtype=dt),
            lambda: models.MnistCNN(device="cpu", seed=None),
            (8, 28, 28, 1), 10),
    "pyramidnet": (lambda dt=F64: jmodels.PyramidNet(num_layers=2, alpha=12,
                                                     dtype=dt),
                   lambda: models.PyramidNet(num_layers=2, alpha=12,
                                             device="cpu", seed=None),
                   (8, 20, 20, 3), 10),
    "resnet": (lambda dt=F64: jmodels.ResNet(stage_sizes=(1, 1, 1, 1),
                                             num_classes=10, dtype=dt),
               lambda: models.ResNet(stage_sizes=(1, 1, 1, 1),
                                     num_classes=10, device="cpu", seed=None),
               (4, 64, 64, 3), 10),
}


@pytest.fixture(autouse=True)
def x64():
    """Every JAX array and program of these tests in float64."""
    with jax.enable_x64():
        yield


def batches(name, n, seed=0):
    _, _, shape, classes = MODELS[name]
    rng = np.random.default_rng(seed)
    return [{"image": rng.normal(size=shape).astype(np.float32),
             "label": rng.integers(0, classes, shape[0]).astype(np.int32)}
            for _ in range(n)]


def jax_state(name, v, jtx, dtype=F64):
    """The JAX TrainState of ``v`` with its model at ``dtype``."""
    cast = lambda tree: jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)  # noqa: E731
    return TrainState.create(
        apply_fn=MODELS[name][0](dtype).apply, params=cast(v["params"]),
        tx=jtx,
        batch_stats=cast(v["batch_stats"]) if "batch_stats" in v else None)


def pair(name, jtx, ttx):
    """(JAX state, port state, the variable tree) from one tree."""
    make_t = MODELS[name][1]
    v = random_tree(make_t(), spread=0.25)
    tm = bridge.load_flax_params(make_t(), v["params"], v.get("batch_stats"),
                                 device="cpu")
    return jax_state(name, v, jtx), init_state(tm, None, ttx, device="cpu"), v


def sgd_steplr_pair(steps_per_epoch=1, step_epochs=2):
    """examples/common.py:sgd_steplr in both packages."""
    schedule = optax.exponential_decay(
        LR, transition_steps=step_epochs * steps_per_epoch, decay_rate=0.1,
        staircase=True)
    jtx = optax.chain(optax.add_decayed_weights(WD),
                      optax.sgd(schedule, momentum=MOMENTUM))
    ttx = sgd(exponential_decay(LR, step_epochs * steps_per_epoch, 0.1,
                                staircase=True),
              momentum=MOMENTUM, weight_decay=WD)
    return jtx, ttx


def compare_states(jstate, tstate, atol, slack=None):
    """Every parameter within ``atol`` (plus ``slack[path]``) of the JAX
    one, every statistic within 1e-5 of its BN's scale (plus
    ``slack["stats"]``)."""
    slack = slack or {}
    want = bridge.flatten(jax.device_get(jstate.params))
    got = bridge.flatten(bridge.state_dict_to_flax(tstate.model))
    assert set(got) == set(want)
    for path in want:
        err = np.abs(got[path] - want[path]).max()
        assert err <= atol + slack.get(path, 0.0), (path, err)
    if jstate.batch_stats is None:
        assert tstate.batch_stats is None
    else:
        got_stats = jax.tree.map(lambda t: t.numpy(), tstate.batch_stats)
        assert stats_err(got_stats, jax.device_get(jstate.batch_stats)) \
            <= 1e-5 + slack.get("stats", 0.0)


def jax_run(jstate, name, n):
    step = jax_train_step()
    metrics = []
    for batch in batches(name, n):
        jstate, m = step(jstate, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return jstate, metrics


def check_steps(name, jtx, ttx, n, atol):
    """``n`` steps through both packages, compared.  For the ResNet the
    bound on each tensor widens by twice the JAX package's own f32 error
    there (its f32 step against its f64 one), see the module docstring."""
    jstate, tstate, v = pair(name, jtx, ttx)
    jstate, want = jax_run(jstate, name, n)
    tstep = make_train_step()
    got = []
    for batch in batches(name, n):
        tstate, m = tstep(tstate, batch)
        assert set(m) == {"loss", "accuracy"} and m["loss"].dim() == 0
        got.append({k: float(x) for k, x in m.items()})
    assert tstate.step == int(jstate.step) == n
    slack = {}
    slack_loss = [0.0] * n
    if name in CALIBRATED:
        j32, m32 = jax_run(jax_state(name, v, jtx, jnp.float32), name, n)
        p32 = bridge.flatten(jax.device_get(j32.params))
        slack = {path: 2 * np.abs(p32[path] - w).max() for path, w in
                 bridge.flatten(jax.device_get(jstate.params)).items()}
        slack["stats"] = 2 * stats_err(jax.device_get(j32.batch_stats),
                                       jax.device_get(jstate.batch_stats))
        slack_loss = [2 * abs(a["loss"] - b["loss"]) for a, b in
                      zip(m32, want)]
    for g, w, extra in zip(got, want, slack_loss):
        assert set(g) == set(w)
        assert abs(g["loss"] - w["loss"]) <= 1e-5 * abs(w["loss"]) + extra
        if not extra:
            assert g["accuracy"] == w["accuracy"]
    compare_states(jstate, tstate, atol, slack)
    return tstate


def one_sgd_step(name):
    """One step, momentum and weight decay: loss, accuracy, every
    parameter and BatchNorm statistic."""
    jtx = optax.chain(optax.add_decayed_weights(WD),
                      optax.sgd(LR, momentum=MOMENTUM))
    check_steps(name, jtx, sgd(LR, momentum=MOMENTUM, weight_decay=WD), 1,
                atol=1e-6)


def three_steps_of_sgd_steplr(name):
    """The reference's SGD + StepLR: the learning rate drops tenfold
    before the third step (staircase, every 2 updates)."""
    jtx, ttx = sgd_steplr_pair()
    tstate = check_steps(name, jtx, ttx, 3, atol=1e-5)
    assert tstate.optimizer.param_groups[0]["lr"] == pytest.approx(LR / 10)


# the ResNet's cases are tests/test_torch_classifier_resnet.py's, which
# keeps each file's run short
@pytest.mark.parametrize("name", ["cnn", "mlp", "pyramidnet"])
def test_one_sgd_step_matches_jax(name):
    one_sgd_step(name)


def test_three_steps_of_sgd_steplr_match_jax():
    three_steps_of_sgd_steplr("pyramidnet")


def test_exponential_decay_matches_optax():
    for staircase in (True, False):
        want = optax.exponential_decay(0.1, 3, 0.5, staircase=staircase)
        got = exponential_decay(0.1, 3, 0.5, staircase=staircase)
        for count in range(10):
            assert got(count) == pytest.approx(float(want(count)), rel=1e-6)
    assert exponential_decay(0.3, 0, 0.1)(7) == 0.3


def test_eval_step_sums_with_a_mask_and_predict_step():
    """make_eval_step: masked sums in eval mode (the stored statistics;
    the model's train mode restored after); make_predict_step: logits and
    probabilities."""
    jstate, tstate, _ = pair("pyramidnet", optax.sgd(LR), sgd(LR))
    batch = batches("pyramidnet", 1)[0]
    batch["mask"] = (np.arange(8) % 3 != 0).astype(np.float32)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jax_eval_step()(jstate, jbatch)
    tstate.model.train()
    got = make_eval_step()(tstate, batch)
    assert tstate.model.training
    assert set(got) == set(want) == {"loss_sum", "correct_sum", "count"}
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5)
    assert float(got["count"]) == 5.0
    # the statistics were read, not updated
    compare_states(jstate, tstate, atol=0.0)
    unmasked = make_eval_step()(tstate, {"image": batch["image"],
                                         "label": batch["label"]})
    assert float(unmasked["count"]) == 8.0
    for probs in (False, True):
        want = np.asarray(jax_predict_step(probabilities=probs)(jstate,
                                                                 jbatch))
        got = make_predict_step(probabilities=probs)(tstate, batch)
        assert tstate.model.training
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
        if probs:
            np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, rtol=1e-6)
