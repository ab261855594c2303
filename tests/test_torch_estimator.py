"""The port's TF1 Estimator (``dtdl_tpu_torch.train.estimator``) against
the JAX package's, on the CPU.

The JAX Estimator's initial weights (its own init from
``RunConfig.tf_random_seed``) are bridged into the port's MLP and written
as the port's step-0 snapshot in the port's ``model_dir``; the JAX side
then keeps its state in float64 (its params cast to f64 at build, the
MLP computing in f64, as ``tests/test_torch_classifier_train.py``
explains), the port in f32.  Both ``train(20)``, ``evaluate``,
``predict`` five examples, and run ``train_and_evaluate`` in two legs of
10 steps, from the same seeded data (a ragged eval tail included).

Tolerances (port f32 against JAX f64): parameters within 1e-5; eval
loss within 1e-6 relative; accuracy, ``global_step`` and ``class_ids``
equal; the predicted logits within 1e-5.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dtdl_tpu.data import DataLoader as JaxLoader
from dtdl_tpu.models import MLP as JaxMLP
from dtdl_tpu.train import Estimator as JaxEstimator
from dtdl_tpu.train import EstimatorSpec as JaxSpec
from dtdl_tpu.train import EvalSpec as JaxEvalSpec
from dtdl_tpu.train import ModeKeys as JaxModes
from dtdl_tpu.train import RunConfig as JaxConfig
from dtdl_tpu.train import TrainSpec as JaxTrainSpec
from dtdl_tpu.train import train_and_evaluate as jax_tae
from dtdl_tpu.train.state import TrainState as JaxState
from dtdl_tpu_torch import bridge
from dtdl_tpu_torch.ckpt import Checkpointer
from dtdl_tpu_torch.data.loader import DataLoader
from dtdl_tpu_torch.data.synthetic import class_pattern_images
from dtdl_tpu_torch.models import MLP
from dtdl_tpu_torch.parallel import DataParallel
from dtdl_tpu_torch.runtime import local_mesh
from dtdl_tpu_torch.train import (Estimator, EstimatorSpec, EvalSpec,
                                  ModeKeys, RunConfig, TrainSpec,
                                  train_and_evaluate)
from dtdl_tpu_torch.train.optim import sgd
from dtdl_tpu_torch.train.state import init_state

torch.set_num_threads(1)

N_TRAIN, N_TEST, BATCH = 256, 100, 32     # 100 at 32: a ragged tail


@pytest.fixture(autouse=True)
def x64():
    with jax.enable_x64():
        yield


def data():
    x, y = class_pattern_images(N_TRAIN + N_TEST, (784,), 10, seed=0,
                                noise=0.5)
    return (x[:N_TRAIN], y[:N_TRAIN]), (x[N_TRAIN:], y[N_TRAIN:])


def jax_model_fn(mode, params):
    tx = optax.sgd(0.05, momentum=0.9) if mode == JaxModes.TRAIN else None
    return JaxSpec(mode=mode, model=JaxMLP(n_units=32, dtype=jnp.float64),
                   tx=tx)


def port_model_fn(mode, params):
    tx = sgd(0.05, momentum=0.9) if mode == ModeKeys.TRAIN else None
    return EstimatorSpec(mode=mode, model=MLP(n_units=32, device="cpu",
                                              seed=None), tx=tx)


class JaxEstimator64(JaxEstimator):
    """The JAX Estimator with its state in float64."""

    def _build_state(self, spec, example):
        st = super()._build_state(spec, example)
        p = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), st.params)
        return JaxState.create(apply_fn=st.apply_fn, params=p, tx=st.tx)


def pair(tmp_path, save_every=1000):
    """(JAX estimator, port estimator, their input_fns): the port's
    model_dir holds the JAX init as its step-0 snapshot."""
    (x, y), (vx, vy) = data()
    cfg = dict(save_checkpoints_steps=save_every, log_step_count_steps=0)
    je = JaxEstimator64(jax_model_fn, str(tmp_path / "jax"),
                        JaxConfig(**cfg))
    spec = jax_model_fn(JaxModes.TRAIN, {})
    init = jax.device_get(JaxEstimator._build_state(
        je, spec, np.zeros((1, 784), np.float32)).params)
    model = bridge.load_flax_params(MLP(n_units=32, device="cpu", seed=None),
                                    init, device="cpu")
    Checkpointer(str(tmp_path / "port")).save(
        0, init_state(model, None, sgd(0.05, momentum=0.9), device="cpu"),
        wait=True)
    te = Estimator(port_model_fn, str(tmp_path / "port"), RunConfig(**cfg))
    fns = {
        "jax_train": lambda: JaxLoader({"image": x, "label": y}, BATCH,
                                       seed=0),
        "jax_eval": lambda: JaxLoader({"image": vx, "label": vy}, BATCH,
                                      seed=0, shuffle=False,
                                      drop_last=False),
        "train": lambda: DataLoader({"image": x, "label": y}, BATCH, seed=0,
                                    device="cpu"),
        "eval": lambda: DataLoader({"image": vx, "label": vy}, BATCH, seed=0,
                                   shuffle=False, drop_last=False,
                                   device="cpu"),
    }
    return je, te, fns


def latest_params(te):
    model = MLP(n_units=32, device="cpu", seed=None)
    st = init_state(model, None, sgd(0.05, momentum=0.9), device="cpu")
    te.ckpt.restore(st)
    return bridge.flatten(bridge.state_dict_to_flax(model))


def jax_latest_params(je):
    st = je._build_state(jax_model_fn(JaxModes.TRAIN, {}),
                         np.zeros((1, 784), np.float32))
    st, _ = je.ckpt.restore(st)
    return bridge.flatten(jax.device_get(st.params))


def close_params(te, je):
    got, want = latest_params(te), jax_latest_params(je)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)


def close_eval(got, want):
    assert got["global_step"] == want["global_step"]
    assert got["accuracy"] == pytest.approx(want["accuracy"], abs=1e-12)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)


def test_train_evaluate_predict_match_jax(tmp_path):
    je, te, fns = pair(tmp_path)
    assert te.latest_global_step() == 0
    je.train(fns["jax_train"], steps=20)
    te.train(fns["train"], steps=20)
    assert te.latest_global_step() == je.latest_global_step() == 20
    close_params(te, je)
    close_eval(te.evaluate(fns["eval"]), je.evaluate(fns["jax_eval"]))
    # steps= limits the batches, as TF1's evaluate(steps=N)
    close_eval(te.evaluate(fns["eval"], steps=2),
               je.evaluate(fns["jax_eval"], steps=2))
    got = list(itertools.islice(te.predict(fns["eval"]), 5))
    want = list(itertools.islice(je.predict(fns["jax_eval"]), 5))
    assert [p["class_ids"] for p in got] == [p["class_ids"] for p in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["logits"], w["logits"], atol=1e-5)
        np.testing.assert_allclose(g["probabilities"].sum(), 1.0, rtol=1e-5)
    # a ragged predict tail: every example once, the padding dropped
    assert len(list(te.predict(fns["eval"]))) == N_TEST
    # a max_steps at or below the global step does nothing
    te.train(fns["train"], max_steps=5)
    assert te.latest_global_step() == 20


def test_train_and_evaluate_in_legs_matches_jax(tmp_path):
    je, te, fns = pair(tmp_path, save_every=10)
    want = jax_tae(je, JaxTrainSpec(fns["jax_train"], max_steps=20),
                   JaxEvalSpec(fns["jax_eval"], steps=2))
    got = train_and_evaluate(te, TrainSpec(fns["train"], max_steps=20),
                             EvalSpec(fns["eval"], steps=2))
    close_eval(got, want)
    close_params(te, je)
    assert sorted(te.ckpt._list(te.ckpt._SNAP_RE)) == [0, 10, 20]
    # at max_steps a rerun restores and trains nothing
    assert train_and_evaluate(te, TrainSpec(fns["train"], max_steps=20),
                              EvalSpec(fns["eval"])) == {}


class SpyLoader(DataLoader):
    """Records the epochs the train loop walks via set_epoch."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.epochs = []

    def set_epoch(self, epoch):
        self.epochs.append(epoch)
        super().set_epoch(epoch)


def test_train_legs_walk_the_dataset(tmp_path):
    """Successive train() calls resume at the epoch and offset of the
    restored global step (tests/test_estimator.py's case)."""
    (x, y), _ = data()
    loader = SpyLoader({"image": x, "label": y}, 64, seed=0, device="cpu")
    est = Estimator(port_model_fn, str(tmp_path), RunConfig(
        save_checkpoints_steps=100, log_step_count_steps=0))
    est.train(lambda: loader, steps=2)   # batches 0-1 of epoch 0
    est.train(lambda: loader, steps=3)   # 2-3 of epoch 0, then 0 of epoch 1
    assert loader.epochs == [0, 0, 1]
    assert est.latest_global_step() == 5


def test_input_fn_pair_data_parallel_and_refusals(tmp_path):
    """input_fn may return a (features, labels) pair, TF1-style; the
    strategy may be DataParallel; an observer is ROADMAP A13."""
    (x, y), _ = data()
    est = Estimator(port_model_fn, str(tmp_path),
                    RunConfig(log_step_count_steps=0),
                    strategy=DataParallel(local_mesh()), device="cpu")
    est.train(lambda: (x, y), steps=3)
    assert est.latest_global_step() == 3
    r = est.evaluate(lambda: (x, y))
    assert r["global_step"] == 3 and np.isfinite(r["loss"])
    with pytest.raises(NotImplementedError, match="A13"):
        Estimator(port_model_fn, str(tmp_path), observer=object())
