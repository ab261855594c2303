"""The port's ``train_epoch(unroll=k)`` against the JAX package's, on the
CPU.

One flax tree (the MLP classifier; a 2-layer LM) is bridged into the
port, and the same numpy batches go through JAX's ``train_epoch`` with
``unroll=4`` and ``unroll=8`` (k steps as one ``lax.scan`` program) and
through the port's (k eager steps a bundle): ten batches, so the bundles
are 4, 4, 2 and 8, 2, each ending in a ragged tail.  A recorder passed as
``guard`` receives every drained per-step dict in both loops.

Tolerances (f32): per-step metrics and final parameters within atol
1e-5 and rtol 1e-5 of JAX's (summation order only; sgd keeps a
last-bit difference of a gradient at lr times its size).  Inside the
port ``unroll=k`` is bitwise ``unroll=1`` and ``sync_every_step=True``:
the same steps in the same order.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dtdl_tpu.data import loader as jloader
from dtdl_tpu.metrics import report as jreport
from dtdl_tpu.models import MLP as JaxMLP
from dtdl_tpu.models import transformer as jtr
from dtdl_tpu.parallel.strategy import SingleDevice
from dtdl_tpu.train import TrainState
from dtdl_tpu.train import make_lm_train_step as jax_lm_step
from dtdl_tpu.train import make_train_step as jax_train_step
from dtdl_tpu.train import train_epoch as jax_train_epoch
from dtdl_tpu_torch import bridge, models
from dtdl_tpu_torch.data.loader import DataLoader
from dtdl_tpu_torch.metrics.device import MetricsQueue
from dtdl_tpu_torch.metrics.report import Reporter
from dtdl_tpu_torch.models.transformer import transformer_lm
from dtdl_tpu_torch.resil import StepGuard
from dtdl_tpu_torch.train.loop import (bundle_batches, train_epoch,
                                       unroll_steps)
from dtdl_tpu_torch.train.optim import sgd
from dtdl_tpu_torch.train.state import init_state
from dtdl_tpu_torch.train.step import make_lm_train_step, make_train_step

torch.set_num_threads(1)

LR = 0.1
N_BATCHES, BATCH = 10, 8
ATOL = RTOL = 1e-5


class Recorder:
    """Takes every drained per-step dict, as a guard's ``observe`` does."""

    def __init__(self):
        self.steps = []

    def observe(self, vals):
        self.steps.append(dict(vals))


class ListSink:
    def __init__(self):
        self.payloads = []

    def write(self, payload):
        self.payloads.append(dict(payload))

    def close(self):
        pass


def mlp_data(seed=0):
    rng = np.random.default_rng(seed)
    n = N_BATCHES * BATCH
    return {"image": rng.normal(size=(n, 784)).astype(np.float32),
            "label": rng.integers(0, 10, n).astype(np.int32)}


def lm_data(seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 256, (N_BATCHES * 4, 17))
            .astype(np.int32)}


def mlp_pair():
    jm = JaxMLP(n_units=32)
    params = jax.device_get(fnn.unbox(jm.init(
        jax.random.PRNGKey(1), jnp.zeros((1, 784)))["params"]))
    jstate = TrainState.create(apply_fn=jm.apply, params=params,
                               tx=optax.sgd(LR))
    return jstate, params, jax_train_step(), mlp_port, make_train_step


def mlp_port(params):
    tm = models.MLP(n_units=32, device="cpu", seed=None)
    bridge.load_flax_params(tm, params, device="cpu")
    return init_state(tm, None, sgd(LR), device="cpu")


def lm_port(params):
    tm = transformer_lm("tiny", device="cpu", seed=None, dtype=torch.float32,
                        n_layers=2, max_seq=32, attn_impl="dense")
    bridge.load_flax_params(tm, params, device="cpu")
    return init_state(tm, None, sgd(LR), device="cpu")


def lm_pair():
    jm = jtr.transformer_lm("tiny", dtype=jnp.float32, n_layers=2,
                            max_seq=32, attn_impl="dense")
    params = jax.device_get(fnn.unbox(jm.init(
        jax.random.PRNGKey(2), jnp.zeros((1, 4), jnp.int32))["params"]))
    jstate = TrainState.create(apply_fn=jm.apply,
                               params=jax.tree.map(jnp.array, params),
                               tx=optax.sgd(LR))
    return jstate, params, jax_lm_step(), lm_port, make_lm_train_step


PAIRS = {"mlp": (mlp_pair, mlp_data, BATCH),
         "lm": (lm_pair, lm_data, 4)}


def run_port(make_state, params, make_step, data, batch, **kw):
    rec = Recorder()
    state = make_state(params)
    loader = DataLoader(data, batch, shuffle=False, device="cpu")
    state, means = train_epoch(make_step(), state, loader, guard=rec, **kw)
    return rec.steps, means, bridge.flatten(
        bridge.state_dict_to_flax(state.model))


@pytest.mark.parametrize("name", ["mlp", "lm"])
@pytest.mark.parametrize("unroll", [4, 8])
def test_unroll_matches_the_jax_loop(name, unroll):
    make_pair, make_data, batch = PAIRS[name]
    data = make_data()
    jstate, params, jstep, make_state, make_step = make_pair()
    jrec, jsink, tsink = Recorder(), ListSink(), ListSink()
    jstate, jmeans = jax_train_epoch(
        jstep, jstate, jloader.DataLoader(data, batch, shuffle=False),
        SingleDevice(), reporter=jreport.Reporter([jsink]), log_interval=3,
        unroll=unroll, guard=jrec)
    rec = Recorder()
    state = make_state(params)
    state, means = train_epoch(
        make_step(), state, DataLoader(data, batch, shuffle=False,
                                       device="cpu"),
        reporter=Reporter([tsink]), log_interval=3, unroll=unroll, guard=rec)
    assert len(rec.steps) == len(jrec.steps) == N_BATCHES
    for got, want in zip(rec.steps, jrec.steps):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=RTOL,
                                       err_msg=k)
    for k in jmeans:
        np.testing.assert_allclose(means[k], jmeans[k], atol=ATOL, rtol=RTOL)
    want = bridge.flatten(jax.device_get(jstate.params))
    got = bridge.flatten(bridge.state_dict_to_flax(state.model))
    assert set(got) == set(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=ATOL,
                                   rtol=RTOL, err_msg=path)
    # the boundaries fall on the same steps (a bundle's last), with the
    # same keys
    assert [p.get("step") for p in tsink.payloads] == \
        [p.get("step") for p in jsink.payloads]
    assert [set(p) for p in tsink.payloads] == [set(p) for p in jsink.payloads]


@pytest.mark.parametrize("name", ["mlp", "lm"])
@pytest.mark.parametrize("unroll", [3, 4])
def test_unroll_is_bitwise_one_step_at_a_time(name, unroll):
    """unroll=k (3: bundles 3, 3, 3, 1; 4: 4, 4, 2) against unroll=1 and
    the blocking loop, from the same weights: every per-step metric and
    every parameter bit for bit."""
    make_pair, make_data, batch = PAIRS[name]
    data = make_data(1)
    _, params, _, make_state, make_step = make_pair()
    base = run_port(make_state, params, make_step, data, batch)
    for kw in ({"unroll": unroll}, {"sync_every_step": True}):
        steps, means, flat = run_port(make_state, params, make_step, data,
                                      batch, **kw)
        assert steps == base[0], kw
        assert means == base[1], kw
        for path, leaf in base[2].items():
            assert np.array_equal(flat[path], leaf), (kw, path)


def test_metrics_queue_stacked_entries_split_in_step_order():
    """The mirror of tests/test_async_metrics.py's stacked-queue test."""
    q = MetricsQueue(lag=2)
    stacked = {"v": torch.arange(4.0), "w": torch.arange(4.0) * 10}
    popped = q.push(stacked, count=4)    # 4 > lag: pops itself
    assert [e["v"] for e in popped] == [0.0, 1.0, 2.0, 3.0]
    assert [e["w"] for e in popped] == [0.0, 10.0, 20.0, 30.0]
    assert len(q) == 0
    # a stacked entry counts its width toward lag; drain keeps step order
    q = MetricsQueue(lag=5)
    assert q.push({"v": torch.tensor(0.0)}) == []
    assert q.push({"v": torch.tensor([1.0, 2.0, 3.0])}, count=3) == []
    assert len(q) == 4
    assert q.push({"v": torch.tensor([4.0, 5.0])}, count=2) == [{"v": 0.0}]
    assert len(q) == 5
    assert [e["v"] for e in q.drain()] == [1.0, 2.0, 3.0, 4.0, 5.0]
    assert len(q) == 0 and q.drain() == []
    # the floats are the f32 values widened, as the per-step read gives
    x = torch.tensor([0.1, 1 / 3], dtype=torch.float32)
    q.push({"v": x}, count=2)
    assert [e["v"] for e in q.drain()] == [float(x[0]), float(x[1])]


def test_unroll_steps_stacks_the_bundle_and_bundles_are_ragged():
    calls = []

    def step(state, batch):
        calls.append(batch)
        return state + batch, {"loss": torch.tensor(float(batch)),
                               "n": torch.tensor(state)}

    bundled = unroll_steps(step, 3)
    state, m = bundled(10, (1, 2, 3))
    assert state == 16 and calls == [1, 2, 3]
    assert m["loss"].tolist() == [1.0, 2.0, 3.0]
    assert m["n"].tolist() == [10, 11, 13]
    assert list(bundle_batches(iter(range(7)), 3)) == [(0, 1, 2), (3, 4, 5),
                                                       (6,)]
    assert list(bundle_batches(iter([]), 3)) == []


def test_unroll_guardrails_carry_the_jax_messages():
    data = mlp_data()
    jstate, params, jstep, make_state, make_step = mlp_pair()
    jl = jloader.DataLoader(data, BATCH, shuffle=False)
    tl = DataLoader(data, BATCH, shuffle=False, device="cpu")
    state = make_state(params)
    for kw in ({"unroll": 0}, {"unroll": 2, "sync_every_step": True}):
        with pytest.raises(ValueError) as jerr:
            jax_train_epoch(jstep, jstate, jl, SingleDevice(), **kw)
        with pytest.raises(ValueError) as terr:
            train_epoch(make_step(), state, tl, **kw)
        assert str(terr.value) == str(jerr.value), kw
    with pytest.raises(ValueError, match="sync_every_step"):
        train_epoch(make_step(), state, tl, unroll=2, sync_every_step=True)


def test_step_guard_sees_every_step_of_a_bundle():
    """A NaN batch in the second bundle: the guard's step keeps the
    update out on the device, and the loop hands the guard every one of
    the ten steps, the bad one counted once."""
    data = mlp_data(2)
    data["image"][5 * BATCH] = np.nan          # step 5: bundle 2 of 4, 4, 2
    _, params, _, make_state, _ = mlp_pair()
    guard = StepGuard()
    state = make_state(params)
    before = {k: np.array(v) for k, v in bridge.flatten(
        bridge.state_dict_to_flax(state.model)).items()}
    state, _ = train_epoch(make_train_step(guard=guard), state,
                           DataLoader(data, BATCH, shuffle=False,
                                      device="cpu"),
                           guard=guard, unroll=4, log_interval=4)
    assert guard.n_steps == N_BATCHES and guard.n_bad == 1
    after = bridge.flatten(bridge.state_dict_to_flax(state.model))
    assert all(np.isfinite(v).all() for v in after.values())
    assert any(not np.array_equal(after[p], before[p]) for p in before)
    assert state.step == N_BATCHES - 1
