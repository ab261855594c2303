"""The port's checkpoint subsystem (``dtdl_tpu_torch.ckpt``): the snapshot
half against the JAX ``Checkpointer``, and its own behaviour as
``tests/test_ckpt.py`` and ``tests/test_resil.py`` pin the JAX one's.

* **Parity**: one JAX train state (a small PyramidNet with BatchNorm
  under adam, an MLP under sgd + momentum), two JAX steps, saved and
  restored by the JAX ``Checkpointer``; the same state bridged into the
  port (params, ``batch_stats``, optax's moments as torch's
  ``exp_avg``/``exp_avg_sq`` or ``momentum_buffer``, the count as Adam's
  ``step``), saved and restored by the port's.  The restored trees agree
  leaf for leaf under the same flax paths, exactly (f32 bits).
* **Behaviour**: weights round trip; epoch weights, latest and gc;
  snapshot resume equivalence (bitwise: 4 steps = 2 + save + restore +
  2, with the StepLR schedule crossing its drop after the restore);
  asynchronous save (a step right after ``save`` does not change the
  snapshot; visible to a fresh ``Checkpointer``); architecture and
  structure mismatch; gc never below ``keep`` during an async write;
  the rollback/supersede cases and a fresh run never superseding; torn
  writes (crash at ``ckpt.pre_rename`` and ``ckpt.pre_commit``, a
  truncated snapshot) quarantined and fallen back from; a legacy
  marker-less directory; the context manager flushing on an exception;
  a failed write raising.

Everything here is exact: the port's resumed state must be bitwise its
uninterrupted state.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dtdl_tpu.ckpt import Checkpointer as JaxCheckpointer
from dtdl_tpu.train import make_train_step as jax_train_step
from dtdl_tpu_torch import bridge
from dtdl_tpu_torch.ckpt import (CheckpointCorruptError, Checkpointer,
                                 load_weights, save_weights)
from dtdl_tpu_torch.ckpt.checkpoint import _validate_shapes
from dtdl_tpu_torch.models import MLP
from dtdl_tpu_torch.resil import FaultPlan, InjectedCrash
from dtdl_tpu_torch.train.optim import adam, exponential_decay, sgd
from dtdl_tpu_torch.train.state import (init_state, load_state_tree,
                                        params_tree, state_to_tree)
from dtdl_tpu_torch.train.step import make_train_step
from test_torch_classifier_train import MODELS, batches, jax_state
from test_torch_classifier import random_tree

torch.set_num_threads(1)

DIM, BS = 32, 8


def mk_state(seed=0, units=16, tx=None):
    return init_state(MLP(n_units=units, in_features=DIM, device="cpu",
                          seed=seed),
                      None, tx or sgd(0.1, momentum=0.9), device="cpu")


def mk_batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"image": rng.normal(size=(BS, DIM)).astype(np.float32),
             "label": rng.integers(0, 10, BS).astype(np.int64)}
            for _ in range(n)]


def flat(tree):
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else v) for k, v in bridge.flatten(tree).items()}


def assert_trees_equal(a, b):
    fa, fb = flat(a), flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        if isinstance(fa[k], np.ndarray):
            assert fa[k].dtype == fb[k].dtype, k
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
        else:
            assert fa[k] == fb[k], k


def assert_states_equal(a, b):
    assert_trees_equal(state_to_tree(a), state_to_tree(b))


# ---- parity with the JAX Checkpointer ---------------------------------------

PARITY = {
    # name -> (optax transform, port transform, torch slot per optax leaf)
    "pyramidnet": (lambda: optax.adam(1e-3), lambda: adam(1e-3),
                   {"mu": "exp_avg", "nu": "exp_avg_sq"}),
    "mlp": (lambda: optax.sgd(0.1, momentum=0.9),
            lambda: sgd(0.1, momentum=0.9), {"trace": "momentum_buffer"}),
}


@pytest.mark.parametrize("name", sorted(PARITY))
def test_snapshot_matches_the_jax_checkpointer(name, tmp_path):
    jtx, ttx, slots = PARITY[name]
    v = random_tree(MODELS[name][1](), spread=0.25)
    js = jax_state(name, v, jtx(), dtype=jnp.float32)
    step = jax_train_step()
    for b in batches(name, 2):
        js, _ = step(js, b)
    jck = JaxCheckpointer(str(tmp_path / "jax"))
    jck.save(2, js, wait=True)
    jrest, at = jck.restore(jax_state(name, v, jtx(), dtype=jnp.float32))
    jck.close()
    assert at == 2

    # the trained JAX state, bridged into the port as a snapshot tree
    jopt = jax.device_get(jrest.opt_state[0])
    tm = bridge.load_flax_params(MODELS[name][1](), jax.device_get(
        jrest.params), jax.device_get(jrest.batch_stats), device="cpu")
    ts = init_state(tm, None, ttx(), device="cpu")
    tree = state_to_tree(ts)
    tree["step"] = int(jrest.step)
    for jname, tname in slots.items():
        tree["opt_state"][tname] = jax.tree.map(
            lambda x: torch.from_numpy(np.array(x)), getattr(jopt, jname))
    if "mu" in slots:
        tree["opt_state"]["step"] = jax.tree.map(
            lambda _: torch.tensor(float(jopt.count)), jopt.mu)
    load_state_tree(ts, jax.tree.map(
        lambda x: torch.as_tensor(np.asarray(x)), tree))
    ck = Checkpointer(str(tmp_path / "port"))
    ck.save(2, ts, wait=True)
    fresh = init_state(MODELS[name][1](), None, ttx(), device="cpu")
    restored, at = Checkpointer(str(tmp_path / "port")).restore(fresh)
    assert at == 2 and restored is fresh
    got = flat(state_to_tree(restored))

    want = {"step": int(jrest.step)}
    want.update({f"params/{k}": v for k, v in
                 bridge.flatten(jax.device_get(jrest.params)).items()})
    if jrest.batch_stats is not None:
        want.update({f"batch_stats/{k}": v for k, v in bridge.flatten(
            jax.device_get(jrest.batch_stats)).items()})
    for jname, tname in slots.items():
        want.update({f"opt_state/{tname}/{k}": v for k, v in
                     bridge.flatten(getattr(jopt, jname)).items()})
    if "mu" in slots:
        want.update({f"opt_state/step/{k}": np.float32(jopt.count)
                     for k in bridge.flatten(jopt.mu)})
    else:
        assert got.pop("batch_stats") is None
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(w), err_msg=k)


# ---- tests/test_ckpt.py, for the port ---------------------------------------

def test_weights_roundtrip(tmp_path):
    state = mk_state()
    p = str(tmp_path / "w.msgpack")
    save_weights(p, params_tree(state.model))
    loaded = load_weights(p, params_tree(mk_state(seed=9).model))
    assert_trees_equal(params_tree(state.model), loaded)


def test_epoch_weights_latest_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for e in range(5):
        ck.save_weights_epoch(e, params_tree(mk_state(seed=e).model))
    params, epoch = ck.latest_weights(params_tree(mk_state().model))
    assert epoch == 4
    assert_trees_equal(params_tree(mk_state(seed=4).model), params)
    assert len(ck._list(ck._WEIGHT_RE)) == 2


@pytest.mark.parametrize("tx", ["sgd_steplr", "adam"])
def test_full_snapshot_resume_equivalence(tx, tmp_path):
    """4 steps == 2 steps, snapshot, restore into a fresh state, 2 more:
    bitwise params, optimizer state and step; the StepLR schedule (a
    drop every 3 updates) continues from the restored count."""
    make = {"sgd_steplr": lambda: sgd(exponential_decay(0.1, 3, 0.1, True),
                                      momentum=0.9, weight_decay=0.01),
            "adam": lambda: adam(1e-2)}[tx]
    step = make_train_step()
    b = mk_batches(4)
    ref = mk_state(tx=make())
    for i in range(4):
        step(ref, b[i])
    s = mk_state(tx=make())
    for i in range(2):
        step(s, b[i])
    ck = Checkpointer(str(tmp_path))
    ck.save(s.step, s)
    restored, at = ck.restore(mk_state(seed=3, tx=make()))
    assert at == 2 and restored.step == 2
    for i in range(2, 4):
        step(restored, b[i])
    assert_states_equal(ref, restored)
    if tx == "sgd_steplr":
        assert restored.optimizer.param_groups[0]["lr"] == \
            pytest.approx(0.01) and restored.optimizer.param_groups[0][
                "count"] == 4


def test_async_save_overlaps_training(tmp_path):
    """save() returns after the copy; a step issued at once does not
    change the snapshot; restore waits and round-trips exactly."""
    big = {"w": torch.arange(2_000_000, dtype=torch.float32).reshape(
        500, 4000), "step": 3}
    ck = Checkpointer(str(tmp_path / "async"))
    ck.save(3, big)
    big["w"].mul_(-1)                  # the live tensor moves on
    ck.wait_until_finished()
    like = {"w": torch.zeros(500, 4000), "step": 0}
    restored, step = ck.restore(like)
    assert step == 3 and restored["step"] == 3
    torch.testing.assert_close(restored["w"], -big["w"], rtol=0, atol=0)

    s = mk_state(tx=adam(1e-2))
    step_fn = make_train_step()
    step_fn(s, mk_batches(1)[0])
    want = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
            for k, v in bridge.flatten(state_to_tree(s)).items()}
    ck.save(1, s)
    step_fn(s, mk_batches(2)[1])       # the hazard: a step right after save
    got, _ = ck.restore(mk_state(seed=5, tx=adam(1e-2)))
    assert_trees_equal(bridge._nest(want), state_to_tree(got))


def test_async_snapshot_visible_to_fresh_checkpointer(tmp_path):
    state = mk_state()
    make_train_step()(state, mk_batches(1)[0])
    c1 = Checkpointer(str(tmp_path / "d"))
    c1.save(7, state)
    c1.wait_until_finished()
    restored, step = Checkpointer(str(tmp_path / "d")).restore(
        mk_state(seed=5))
    assert step == 7
    assert_states_equal(state, restored)


def test_mismatched_model_raises_value_error_naming_the_leaf(tmp_path):
    p = str(tmp_path / "w.msgpack")
    save_weights(p, {"q": {"kernel": np.zeros((256, 8, 32), np.float32)}})
    with pytest.raises(ValueError, match="(?s)does not match.*q/kernel"):
        load_weights(p, {"q": {"kernel": np.zeros((256, 2, 128),
                                                  np.float32)}})
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(5, mk_state(units=16), wait=True)
    with pytest.raises(ValueError, match="params/Dense_0/kernel"):
        ck.restore(mk_state(units=24))
    # a valid snapshot of another optimizer: a structure mismatch
    with pytest.raises(ValueError, match="structure"):
        ck.restore(mk_state(tx=adam(1e-3)))
    with pytest.raises(ValueError, match="structure"):
        _validate_shapes({"a": np.zeros(2), "b": np.zeros(2),
                          "c": np.zeros(2)},
                         {"a": np.zeros(2), "b": np.zeros(2)}, "origin")


def test_snapshot_gc_never_trims_below_keep_during_async_write(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2):
        os.makedirs(str(tmp_path / f"snapshot_{s}"))
    os.makedirs(str(tmp_path / "snapshot_3.tmp"))   # in flight: invisible
    ck._gc(ck._SNAP_RE, "snapshot_{}", protect=3)
    assert sorted(ck._list(ck._SNAP_RE)) == [1, 2]
    os.makedirs(str(tmp_path / "snapshot_3"))
    ck._gc(ck._SNAP_RE, "snapshot_{}")
    assert sorted(ck._list(ck._SNAP_RE)) == [2, 3]
    os.makedirs(str(tmp_path / "snapshot_1"))
    ck._gc(ck._SNAP_RE, "snapshot_{}", protect=1)
    assert 1 in ck._list(ck._SNAP_RE)
    # and through a real save: nothing durable goes before the new one is
    ck2 = Checkpointer(str(tmp_path / "real"), keep=2)
    state = mk_state()
    for s in (1, 2):
        ck2.save(s, state, wait=True)
    ck2.save(3, state)
    assert sorted(ck2._list(ck2._SNAP_RE))[:2] == [1, 2]
    ck2.wait_until_finished()
    assert sorted(ck2._list(ck2._SNAP_RE)) == [2, 3]


def test_rollback_resave_of_old_step_survives_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    state = mk_state()
    for s in (150, 200):
        ck.save(s, state, wait=True)
    ck.save(120, state, wait=True)
    assert os.path.isdir(str(tmp_path / "snapshot_120"))
    _, step = ck.restore(mk_state(seed=3), step=120)
    assert step == 120


def test_rollback_supersedes_stale_future_snapshots(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=3)
    state = mk_state()
    for s in (100, 150, 200):
        ck.save(s, state, wait=True)
    _, step = ck.restore(mk_state(seed=3), step=100)
    assert step == 100
    ck.save(110, state, wait=True)
    assert ck.latest_step() == 110
    assert not os.path.isdir(str(tmp_path / "snapshot_150"))
    assert not os.path.isdir(str(tmp_path / "snapshot_200"))
    ck.save(120, state, wait=True)
    assert sorted(ck._list(ck._SNAP_RE)) == [100, 110, 120]


def test_epoch_weights_rollback_supersedes_stale_futures(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=4)
    for e in range(4):
        ck.save_weights_epoch(e, params_tree(mk_state(seed=e).model))
    like = params_tree(mk_state().model)
    ck.latest_weights(like)
    ck.save_weights_epoch(1, params_tree(mk_state(seed=41).model))
    params, epoch = ck.latest_weights(like)
    assert epoch == 1
    assert_trees_equal(params_tree(mk_state(seed=41).model), params)
    assert sorted(ck._list(ck._WEIGHT_RE)) == [0, 1]


def test_fresh_run_never_supersedes_existing_snapshots(tmp_path):
    old = Checkpointer(str(tmp_path))
    state = mk_state()
    for s in (150, 200):
        old.save(s, state, wait=True)
    old.save_weights_epoch(7, params_tree(state.model))
    old.close()

    fresh = Checkpointer(str(tmp_path))
    fresh.save(10, state, wait=True)
    fresh.save_weights_epoch(0, params_tree(state.model))
    assert sorted(fresh._list(fresh._SNAP_RE)) == [10, 150, 200]
    assert sorted(fresh._list(fresh._WEIGHT_RE)) == [0, 7]
    other = Checkpointer(str(tmp_path) + "_other")
    other.save(90, state, wait=True)
    fresh.restore_path(mk_state(seed=3),
                       str(tmp_path) + "_other/snapshot_90")
    fresh.save(11, state, wait=True)
    assert sorted(fresh._list(fresh._SNAP_RE)) == [10, 11, 150, 200]
    _, step = fresh.restore(mk_state(seed=3), step=150)
    assert step == 150
    fresh.save_weights_epoch(1, params_tree(state.model))
    assert sorted(fresh._list(fresh._WEIGHT_RE)) == [0, 1, 7]
    fresh.save(160, state, wait=True)
    assert sorted(fresh._list(fresh._SNAP_RE)) == [10, 11, 150, 160]


# ---- tests/test_resil.py's torn writes, for the port -------------------------

def test_crash_between_tmp_write_and_rename_falls_back(tmp_path):
    ck = Checkpointer(str(tmp_path))
    p0 = params_tree(mk_state(seed=0).model)
    ck.save_weights_epoch(0, p0)
    with FaultPlan().at("ckpt.pre_rename", 0, "crash"):
        with pytest.raises(InjectedCrash):
            ck.save_weights_epoch(1, params_tree(mk_state(seed=1).model))
    assert os.path.exists(str(tmp_path / "weights_epoch_0001.msgpack.tmp"))
    restored, epoch = Checkpointer(str(tmp_path)).latest_weights(
        params_tree(mk_state(seed=9).model))
    assert epoch == 0
    assert_trees_equal(p0, restored)


def test_latest_weights_quarantines_corrupt_epoch_and_falls_back(tmp_path):
    ck = Checkpointer(str(tmp_path))
    p0 = params_tree(mk_state(seed=0).model)
    ck.save_weights_epoch(0, p0)
    ck.save_weights_epoch(1, params_tree(mk_state(seed=1).model))
    victim = str(tmp_path / "weights_epoch_0001.msgpack")
    blob = open(victim, "rb").read()
    with open(victim, "wb") as f:
        f.write(blob[:100])
    restored, epoch = ck.latest_weights(params_tree(mk_state(seed=9).model))
    assert epoch == 0
    assert_trees_equal(p0, restored)
    assert os.path.exists(victim + ".corrupt")
    assert not os.path.exists(victim)


def test_commit_crash_quarantines_and_falls_back(tmp_path):
    s1, s2 = mk_state(seed=1), mk_state(seed=2)
    ck = Checkpointer(str(tmp_path))
    ck.save(1, s1, wait=True)
    with FaultPlan().at("ckpt.pre_commit", 0, "crash"):
        with pytest.raises(InjectedCrash):
            ck.save(2, s2, wait=True)
    assert os.path.isdir(str(tmp_path / "snapshot_2"))   # durable but torn
    fresh = Checkpointer(str(tmp_path))
    assert fresh.latest_step() == 1
    restored, step = fresh.restore(mk_state(seed=9))
    assert step == 1
    assert_states_equal(s1, restored)
    assert os.path.isdir(str(tmp_path / "snapshot_2.corrupt"))
    with pytest.raises(CheckpointCorruptError):
        Checkpointer(str(tmp_path)).restore(mk_state(seed=9), step=2)


def test_truncated_snapshot_is_quarantined(tmp_path):
    s1 = mk_state(seed=1)
    ck = Checkpointer(str(tmp_path))
    ck.save(1, s1, wait=True)
    ck.save(2, mk_state(seed=2), wait=True)
    f = str(tmp_path / "snapshot_2" / "state.pt")
    blob = open(f, "rb").read()
    with open(f, "wb") as fh:
        fh.write(blob[:len(blob) // 2])
    restored, step = Checkpointer(str(tmp_path)).restore(mk_state(seed=9))
    assert step == 1
    assert_states_equal(s1, restored)
    assert os.path.isdir(str(tmp_path / "snapshot_2.corrupt"))


def test_legacy_marker_less_directory_restores(tmp_path):
    s = mk_state()
    ck = Checkpointer(str(tmp_path))
    ck.save(5, s, wait=True)
    os.remove(str(tmp_path / "snapshot_5" / "_DTDL_COMMIT"))
    fresh = Checkpointer(str(tmp_path))
    assert fresh.latest_step() == 5
    restored, step = fresh.restore(mk_state(seed=9))
    assert step == 5
    assert_states_equal(s, restored)
    assert os.path.isdir(str(tmp_path / "snapshot_5"))


def test_checkpointer_context_manager_flushes_on_exception(tmp_path):
    s = mk_state()
    with pytest.raises(RuntimeError, match="boom"):
        with Checkpointer(str(tmp_path)) as ck:
            ck.save(3, s)           # async — copied only
            raise RuntimeError("boom")
    fresh = Checkpointer(str(tmp_path))
    assert fresh.latest_step() == 3
    restored, step = fresh.restore(mk_state(seed=9))
    assert step == 3
    assert_states_equal(s, restored)


def test_failed_write_raises_and_commits_nothing(tmp_path, monkeypatch):
    ck = Checkpointer(str(tmp_path))

    def broken(*args, **kwargs):
        raise OSError("disk full")
    monkeypatch.setattr(torch, "save", broken)
    ck.save(4, mk_state())
    with pytest.raises(RuntimeError, match="snapshot write failed.*disk"):
        ck.wait_until_finished()
    monkeypatch.undo()
    assert ck.latest_step() is None
    assert Checkpointer(str(tmp_path)).restore(mk_state()) == (None, None)
