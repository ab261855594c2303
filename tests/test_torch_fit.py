"""The port's Keras-style ``Model`` (``dtdl_tpu_torch.train.fit``) against
the JAX package's, on the CPU.

One flax variable tree per model (``tests/test_torch_classifier.py``'s
``random_tree``) goes into the JAX ``Model`` (its state in float64, as
``tests/test_torch_classifier_train.py`` explains) and, bridged, into the
port's ``Model`` (f32, ``compile(seed=None)`` keeps the bridged
weights); both ``fit`` 64 synthetic MNIST examples at batch 16 for two
shuffled epochs with validation on a ragged 37-example split, under
``compile("adam" | "sgd" | "rmsprop")``, optax's default rates.

Tolerances (port f32 against JAX f64): History losses within 1e-5
relative, accuracies exact; final parameters within 1e-5 absolute
(the bound ``tests/test_torch_classifier_train.py`` holds three SGD
steps to; here 8 steps at the default rates, 1e-3 for adam and rmsprop,
which move each parameter by about the rate per step).  ``rmsprop``
alone against ``optax.rmsprop`` over 5 steps in f32: within 1e-6
relative.  The ragged-tail evaluate is exact against a direct pass over
all examples (accuracy) and within 1e-6 relative (loss).
"""

import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dtdl_tpu import models as jmodels
from dtdl_tpu.train import Model as JaxModel
from dtdl_tpu_torch import bridge
from dtdl_tpu_torch.data.synthetic import synthetic_mnist
from dtdl_tpu_torch.metrics.report import TensorBoardSink
from dtdl_tpu_torch.obs import Observer
from dtdl_tpu_torch.train import (Callback, History, Model, ModelCheckpoint,
                                  PrintLR, TensorBoard)
from dtdl_tpu_torch.train.optim import rmsprop
from dtdl_tpu_torch.train.state import params_tree
from test_torch_classifier import random_tree
from test_torch_classifier_train import MODELS, jax_state, x64  # noqa: F401

torch.set_num_threads(1)

N_TRAIN, N_VAL, BATCH, EPOCHS = 64, 37, 16, 2


def data(name):
    (x, y), (vx, vy) = synthetic_mnist(n_train=N_TRAIN, n_test=N_VAL)
    x, vx = x.astype(np.float32) / 255.0, vx.astype(np.float32) / 255.0
    if name == "mlp":
        x, vx = x.reshape(len(x), -1), vx.reshape(len(vx), -1)
    else:
        x, vx = x.reshape(len(x), 28, 28, 1), vx.reshape(len(vx), 28, 28, 1)
    return (x, y.astype(np.int32)), (vx, vy.astype(np.int32))


JAX_MODULES = {"mlp": lambda: jmodels.MLP(n_units=32, dtype=jnp.float64),
               "cnn": lambda: jmodels.MnistCNN(dtype=jnp.float64)}


def model_pair(name, optimizer):
    v = random_tree(MODELS[name][1](), seed=2)
    jm = JaxModel(JAX_MODULES[name]())
    jm.compile(optimizer=optimizer)
    jm.state = jax_state(name, v, jm._tx)
    tm = bridge.load_flax_params(MODELS[name][1](), v["params"],
                                 device="cpu")
    return jm, Model(tm).compile(optimizer=optimizer, seed=None)


@pytest.mark.parametrize("name,optimizer", [
    ("mlp", "adam"), ("mlp", "sgd"), ("mlp", "rmsprop"),
    ("cnn", "adam"), ("cnn", "sgd"), ("cnn", "rmsprop")])
def test_fit_matches_the_jax_model(name, optimizer):
    (x, y), val = data(name)
    jm, tm = model_pair(name, optimizer)
    kw = dict(batch_size=BATCH, epochs=EPOCHS, validation_data=val,
              verbose=0, seed=3)
    jh = jm.fit(x, y, **kw)
    th = tm.fit(x, y, **kw)
    assert isinstance(th, History)
    assert sorted(th.history) == sorted(jh.history) == [
        "accuracy", "loss", "val_accuracy", "val_loss"]
    for key in ("loss", "val_loss"):
        np.testing.assert_allclose(th.history[key], jh.history[key],
                                   rtol=1e-5)
    for key in ("accuracy", "val_accuracy"):
        assert th.history[key] == pytest.approx(jh.history[key], abs=1e-12)
    want = bridge.flatten(jax.device_get(jm.state.params))
    got = bridge.flatten(bridge.state_dict_to_flax(tm.module))
    assert set(got) == set(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=0, atol=1e-5,
                                   err_msg=path)
    assert tm.state.step == jm.state.step == EPOCHS * (N_TRAIN // BATCH)


def test_fit_rejects_unknown_loss():
    model = Model(MODELS["mlp"][1]())
    with pytest.raises(ValueError, match="unsupported loss"):
        model.compile(loss="mse")
    # fit(observer=) is served (A13a): its spans and the epoch's window
    obs = Observer(trace=True, sentinel=None)
    model.compile().fit(*data("mlp")[0], verbose=0, observer=obs)
    names = {e["name"] for e in obs.tracer.to_chrome()["traceEvents"]}
    assert {"dispatch", "drain"} <= names
    assert obs.summary()["step_time_s_count"] == 1


def test_evaluate_ragged_tail_exact_and_predict():
    """37 examples at batch 16: the masked tail counts each example
    once; predict returns ordered probabilities for a ragged count."""
    _, (vx, vy) = data("cnn")
    v = random_tree(MODELS["cnn"][1](), seed=2)
    tm = bridge.load_flax_params(MODELS["cnn"][1](), v["params"],
                                 device="cpu")
    model = Model(tm).compile(seed=None)
    res = model.evaluate(vx, vy, batch_size=16, verbose=0)
    with torch.no_grad():
        logits = tm(torch.from_numpy(vx))
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(
        vy).long())
    acc = (logits.argmax(-1).numpy() == vy).mean()
    assert res["accuracy"] == acc
    assert res["loss"] == pytest.approx(float(loss), rel=1e-6)
    probs = model.predict(vx[:21], batch_size=8)
    assert probs.shape == (21, 10)
    np.testing.assert_allclose(probs, logits[:21].softmax(-1).numpy(),
                               rtol=1e-6, atol=1e-7)


def test_rmsprop_matches_optax():
    """optax.rmsprop(1e-3) at its defaults against the port's over 5 steps
    of one quadratic: nu and the parameters within 1e-6 relative."""
    rng = np.random.default_rng(0)
    w0 = rng.normal(size=(7, 5)).astype(np.float32)
    targets = [rng.normal(size=(7, 5)).astype(np.float32) for _ in range(5)]
    tx = optax.rmsprop(1e-3)
    jw = jnp.asarray(w0)
    jopt = tx.init(jw)
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = rmsprop(1e-3).init([p])
    for t in targets:
        g = jax.grad(lambda w: jnp.sum((w - t) ** 2 * 0.5))(jw)
        upd, jopt = tx.update(g, jopt, jw)
        jw = optax.apply_updates(jw, upd)
        p.grad = p.detach() - torch.from_numpy(t)
        opt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jw),
                               rtol=1e-6)
    np.testing.assert_allclose(opt.state[p]["nu"].numpy(),
                               np.asarray(jopt[0].nu), rtol=1e-6)
    # torch's own RMSprop is another function at these settings
    q = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    other = torch.optim.RMSprop([q], lr=1e-3)
    q.grad = q.detach() - torch.from_numpy(targets[0])
    other.step()
    p2 = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    mine = rmsprop(1e-3).init([p2])
    p2.grad = q.grad.clone()
    mine.step()
    assert not torch.allclose(q, p2)


def test_checkpoint_callback_load_latest_and_weights_io(tmp_path):
    (x, y), (vx, vy) = data("mlp")
    _, model = model_pair("mlp", "sgd")
    model.fit(x, y, batch_size=BATCH, epochs=3, verbose=0,
              callbacks=[ModelCheckpoint(str(tmp_path / "ck"), keep=2)])
    names = sorted(p.name for p in (tmp_path / "ck").iterdir())
    assert names == ["weights_epoch_0001.msgpack", "weights_epoch_0001."
                     "msgpack.manifest.json", "weights_epoch_0002.msgpack",
                     "weights_epoch_0002.msgpack.manifest.json"]
    trained = bridge.flatten(bridge.state_dict_to_flax(model.module))
    # restore-latest then evaluate, in a fresh model
    _, fresh = model_pair("mlp", "sgd")
    fresh._ensure_state()
    assert fresh.load_latest(str(tmp_path / "ck"))
    got = bridge.flatten(bridge.state_dict_to_flax(fresh.module))
    for path in trained:
        np.testing.assert_array_equal(got[path], trained[path])
    assert fresh.evaluate(vx, vy, batch_size=16, verbose=0) == \
        model.evaluate(vx, vy, batch_size=16, verbose=0)
    assert not fresh.load_latest(str(tmp_path / "empty"))
    model.save_weights(str(tmp_path / "final.msgpack"))
    _, other = model_pair("mlp", "sgd")
    with pytest.raises(ValueError, match="before load_weights"):
        other.load_weights(str(tmp_path / "final.msgpack"))
    other._ensure_state()
    other.load_weights(str(tmp_path / "final.msgpack"))
    got = bridge.flatten(bridge.state_dict_to_flax(other.module))
    for path in trained:
        np.testing.assert_array_equal(got[path], trained[path])
    # a full-state ModelCheckpoint snapshots the state each epoch
    model.fit(x, y, batch_size=BATCH, epochs=1, verbose=0,
              callbacks=[ModelCheckpoint(str(tmp_path / "full"),
                                         save_weights_only=False)])
    assert (tmp_path / "full" / "snapshot_0" / "_DTDL_COMMIT").exists()


class FakeWriter:
    def __init__(self, logdir):
        self.logdir, self.scalars, self.closed = logdir, [], False

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, value, step))

    def close(self):
        self.closed = True


def test_tensorboard_print_lr_and_callback_order(tmp_path, monkeypatch,
                                                 capsys):
    """The TensorBoard callback writes each epoch's float logs as
    ``epoch/<key>`` scalars through the writer that imports (a stand-in
    here, to keep the test off tensorflow's import); without a writer
    package the sink is a no-op.  PrintLR prints the schedule's rate."""
    fake = types.ModuleType("torch.utils.tensorboard")
    fake.SummaryWriter = FakeWriter
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", fake)
    (x, y), _ = data("mlp")
    _, model = model_pair("mlp", "sgd")
    events = []

    class Recorder(Callback):
        def on_train_begin(self):
            events.append("begin")

        def on_epoch_begin(self, epoch):
            events.append(f"epoch{epoch}")

        def on_epoch_end(self, epoch, logs):
            events.append(f"end{epoch}:{sorted(logs)}")

        def on_train_end(self):
            events.append("train_end")

    tb = TensorBoard(str(tmp_path / "logs"))
    model.fit(x, y, batch_size=BATCH, epochs=2, verbose=0,
              callbacks=[tb, Recorder(), PrintLR(lambda step: 0.5 / (1 + step))])
    assert events == ["begin", "epoch0", "end0:['accuracy', 'loss']",
                      "epoch1", "end1:['accuracy', 'loss']", "train_end"]
    w = tb.sink._writer
    assert w.closed and w.logdir == str(tmp_path / "logs")
    assert [(t, s) for t, _, s in w.scalars] == [
        ("epoch/loss", 0), ("epoch/accuracy", 0), ("epoch/loss", 1),
        ("epoch/accuracy", 1)]
    out = capsys.readouterr().out
    assert "Learning rate for epoch 1 is 0.1" in out      # step 4
    assert "Learning rate for epoch 2 is 0.0555" in out   # step 8
    for mod in ("torch.utils.tensorboard", "tensorboardX"):
        monkeypatch.setitem(sys.modules, mod, None)
    sink = TensorBoardSink(str(tmp_path / "none"))
    sink.write({"loss": 1.0})
    sink.close()
    assert sink._writer is None and not (tmp_path / "none").exists()
