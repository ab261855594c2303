"""The JAX package's orbax snapshots restored by the port, on the CPU.

JAX's ``Checkpointer.save`` writes a ``TrainState`` with orbax's
``StandardCheckpointer``; the port's ``Checkpointer.restore`` and
``restore_path`` read such a directory through ``tensorstore`` (never
``orbax``, which imports JAX) into a port ``TrainState``:

* a ``tiny`` LM (f32, dense attention) after 3 adamw steps in JAX,
  saved at step 3: the port's params, Adam moments (``exp_avg`` =
  ``mu``, ``exp_avg_sq`` = ``nu``), every parameter's Adam ``step`` and
  the state's ``step`` bitwise JAX's; one more step of each on one batch
  then agrees to :data:`NEXT_STEP_ATOL` (the gradients differ in their
  last bits by summation order, and lr is 1e-3);
* JAX's torn-snapshot rules: in a directory of committed snapshots, one
  without ``_DTDL_COMMIT`` is quarantined and restore-latest falls back
  to the previous; an explicit path needs no marker; a snapshot whose
  data will not read is a ``CheckpointCorruptError``;
* where ``tensorstore`` does not import (monkeypatched here; the card's
  machine), restoring a JAX snapshot raises ``NotImplementedError``
  naming it and ROADMAP A8b, and quarantines nothing.
"""

import os
import shutil
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dtdl_tpu.ckpt import Checkpointer as JaxCheckpointer
from dtdl_tpu.models import transformer as jtr
from dtdl_tpu.train import TrainState
from dtdl_tpu.train import make_lm_train_step as jax_step
from dtdl_tpu_torch import bridge
from dtdl_tpu_torch.ckpt import CheckpointCorruptError, Checkpointer
from dtdl_tpu_torch.models.transformer import transformer_lm
from dtdl_tpu_torch.train.optim import adamw
from dtdl_tpu_torch.train.state import init_state, state_to_tree
from dtdl_tpu_torch.train.step import make_lm_train_step

torch.set_num_threads(1)

MAX_SEQ, LR = 48, 1e-3
NEXT_STEP_ATOL = 1e-6


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, 256, (4, 33)).astype(np.int32)}
            for _ in range(n)]


def _port_state(seed=5):
    tm = transformer_lm("tiny", attn_impl="dense", device="cpu", seed=seed,
                        dtype=torch.float32, max_seq=MAX_SEQ)
    return init_state(tm, None, adamw(LR), device="cpu")


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX: 3 adamw steps, snapshots at steps 2 and 3 (both committed),
    then the 4th step's state."""
    jm = jtr.transformer_lm("tiny", attn_impl="dense", dtype=jnp.float32,
                            max_seq=MAX_SEQ)
    params = fnn.unbox(jm.init(jax.random.PRNGKey(2),
                               jnp.zeros((1, 4), jnp.int32))["params"])
    state = TrainState.create(apply_fn=jm.apply, params=params,
                              tx=optax.adamw(LR))
    step = jax_step()
    d = str(tmp_path_factory.mktemp("orbax") / "ck")
    ck = JaxCheckpointer(d)
    b = _batches(4)
    snaps = {}
    for i in range(3):
        state, _ = step(state, {"tokens": jnp.asarray(b[i]["tokens"])})
        if i >= 1:
            ck.save(i + 1, state, wait=True)
            snaps[i + 1] = jax.device_get(state)
    ck.close()
    after, _ = step(state, {"tokens": jnp.asarray(b[3]["tokens"])})
    return d, snaps, jax.device_get(after), b[3]


def _assert_restored(ts, js):
    """The port state ``ts`` holds the JAX state ``js`` bitwise."""
    tree = state_to_tree(ts)
    assert ts.step == int(js.step) == tree["step"]
    adam = js.opt_state[0]
    want = {"params": js.params, "exp_avg": adam.mu, "exp_avg_sq": adam.nu}
    got = {"params": tree["params"],
           "exp_avg": tree["opt_state"]["exp_avg"],
           "exp_avg_sq": tree["opt_state"]["exp_avg_sq"]}
    for name in want:
        w, g = bridge.flatten(want[name]), bridge.flatten(got[name])
        assert w.keys() == g.keys(), name
        for k in w:
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]),
                                          err_msg=f"{name}/{k}")
    steps = bridge.flatten(tree["opt_state"]["step"])
    assert steps and all(float(s) == float(adam.count)
                         for s in steps.values())


def test_restore_latest_is_bitwise_and_steps_on(jax_run):
    d, snaps, after, batch = jax_run
    ts, at = Checkpointer(d).restore(_port_state())
    assert at == 3
    _assert_restored(ts, snaps[3])
    ts, _ = make_lm_train_step()(ts, batch)
    assert ts.step == int(after.step) == 4
    got = bridge.flatten(bridge.state_dict_to_flax(ts.model))
    for k, w in bridge.flatten(after.params).items():
        np.testing.assert_allclose(got[k], np.asarray(w),
                                   atol=NEXT_STEP_ATOL, rtol=0, err_msg=k)


def test_explicit_path_needs_no_marker(jax_run, tmp_path):
    d, snaps, _, _ = jax_run
    src = os.path.join(str(tmp_path), "snapshot_2")
    shutil.copytree(os.path.join(d, "snapshot_2"), src)
    os.remove(os.path.join(src, "_DTDL_COMMIT"))
    ts = Checkpointer(str(tmp_path / "own")).restore_path(_port_state(), src)
    _assert_restored(ts, snaps[2])


def test_torn_snapshot_is_quarantined(jax_run, tmp_path):
    d, snaps, _, _ = jax_run
    work = str(tmp_path / "ck")
    shutil.copytree(d, work)
    os.remove(os.path.join(work, "snapshot_3", "_DTDL_COMMIT"))
    ts, at = Checkpointer(work).restore(_port_state())
    assert at == 2
    _assert_restored(ts, snaps[2])
    assert sorted(os.listdir(work)) == ["snapshot_2", "snapshot_3.corrupt"]


def test_unreadable_snapshot_is_a_corrupt_error(jax_run, tmp_path):
    d, _, _, _ = jax_run
    src = str(tmp_path / "snapshot_3")
    shutil.copytree(os.path.join(d, "snapshot_3"), src)
    data = [os.path.join(root, f) for root, _, files in os.walk(src)
            for f in files if os.sep + "d" + os.sep in root + os.sep]
    assert data
    for f in data:
        with open(f, "r+b") as fh:
            fh.truncate(8)
    with pytest.raises(CheckpointCorruptError, match="snapshot_3"):
        Checkpointer(str(tmp_path / "own")).restore_path(_port_state(), src)


def test_another_optimizer_is_a_mismatch(jax_run):
    from dtdl_tpu_torch.train.optim import sgd
    d, _, _, _ = jax_run
    tm = transformer_lm("tiny", attn_impl="dense", device="cpu", seed=0,
                        dtype=torch.float32, max_seq=MAX_SEQ)
    with pytest.raises(ValueError, match="structure does not match"):
        Checkpointer(d).restore(init_state(tm, None, sgd(0.1, momentum=0.9),
                                           device="cpu"))


def test_without_tensorstore_the_refusal_is_named(jax_run, monkeypatch,
                                                  tmp_path):
    d, _, _, _ = jax_run
    work = str(tmp_path / "ck")
    shutil.copytree(d, work)
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(NotImplementedError, match=r"tensorstore.*A8b"):
        Checkpointer(work).restore(_port_state())
    with pytest.raises(NotImplementedError, match="tensorstore"):
        Checkpointer(work).restore_path(
            _port_state(), os.path.join(work, "snapshot_2"))
    assert sorted(os.listdir(work)) == ["snapshot_2", "snapshot_3"]
