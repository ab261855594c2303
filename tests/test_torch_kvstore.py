"""The port's MXNet KVStore (``dtdl_tpu_torch.parallel.kvstore``) against
the JAX package's, on the CPU.

The control plane (``HostKVStore``, ``RetryingStore``,
``store_barrier``) runs one scripted sequence of calls on each package's
store: the same values and the same named errors with the same
messages.  The data plane runs in two real gloo processes spawned
through the port's launcher (this file as ``__main__``, as
``tests/test_torch_ddp.py`` does): push/pull sums and averages, the
``dist_async`` route, worker 0's ``init`` value, and three SGD steps of
the MLP under ``KVStoreStrategy`` against the port's own ``DataParallel``
(bitwise) and against the JAX ``KVStoreStrategy`` over a 2-device CPU
mesh on the same global batches (JAX in float64, as
``tests/test_torch_classifier_train.py`` explains; within 1e-5).
"""

import argparse
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from dtdl_tpu_torch import bridge, models  # noqa: E402
from dtdl_tpu_torch.launch.local import launch_local  # noqa: E402
from dtdl_tpu_torch.parallel import DataParallel, SingleDevice  # noqa: E402
from dtdl_tpu_torch.parallel import kvstore  # noqa: E402
from dtdl_tpu_torch.runtime import (build_mesh, initialize,  # noqa: E402
                                    process_index)
from dtdl_tpu_torch.train.optim import sgd  # noqa: E402
from dtdl_tpu_torch.train.state import init_state  # noqa: E402
from dtdl_tpu_torch.train.step import make_train_step  # noqa: E402

LR, MOMENTUM, STEPS, GLOBAL = 0.1, 0.9, 3, 8


def batches(seed=0):
    rng = np.random.default_rng(seed)
    return [{"image": rng.normal(size=(GLOBAL, 784)).astype(np.float32),
             "label": rng.integers(0, 10, GLOBAL).astype(np.int32)}
            for _ in range(STEPS)]


def stripe(batch, rank):
    per = GLOBAL // 2
    return {k: v[rank * per:(rank + 1) * per] for k, v in batch.items()}


# ---- the worker: one rank of the gloo world --------------------------------

def train(init, strategy, rank):
    tm = models.MLP(n_units=32, device="cpu", seed=None)
    bridge.load_flax_params(tm, init, device="cpu")
    state = strategy.replicate(init_state(
        tm, None, sgd(LR, momentum=MOMENTUM), device="cpu"))
    step = make_train_step(strategy)
    losses = []
    for b in batches():
        state, m = step(state, stripe(b, rank))
        losses.append(float(m["loss"]))
    return {"params": bridge.flatten(bridge.state_dict_to_flax(tm)),
            "losses": losses}


def worker(argv) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--coordinator")
    ap.add_argument("--num-processes", type=int)
    ap.add_argument("--process-id", type=int)
    a = ap.parse_args(argv)
    torch.set_num_threads(1)
    initialize(a.coordinator, a.num_processes, a.process_id, device="cpu",
               timeout_s=120)
    rank = process_index()
    init = torch.load(os.path.join(a.out, "init.pt"), weights_only=False)
    kv = kvstore.create("dist_sync")
    res = {"topology": (kv.kind, kv.rank, kv.num_workers,
                        kv.aggregation_width, kv.distributed)}
    x = torch.full((3,), rank + 1.0)
    res["sum"] = kv.push_pull("k", x).clone()
    res["in_place"] = x is kv.push_pull("k2", x)
    kv.push("t", {"a": torch.full((2,), 2.0 * rank), "b": [torch.ones(1)]})
    res["average"] = kv.pull("t", average=True)
    res["rescale"] = kvstore.KVStore("dist_sync", rescale=0.25).push_pull(
        "r", torch.full((2,), rank + 3.0))
    res["async"] = kvstore.create("dist_async").push_pull(
        "a", torch.full((2,), rank + 1.0), average=True)
    kv.init("w", {"v": np.arange(3) * (rank + 1)})
    res["init"] = kv.pull_init("w")
    res["strategy"] = type(kvstore.kvstore_strategy("dist_sync")).__name__
    res["kvs"] = train(init, kvstore.KVStoreStrategy(kv), rank)
    res["kvs_async"] = train(init, kvstore.kvstore_strategy(
        kvstore.create("dist_async")), rank)
    res["ddp"] = train(init, DataParallel(build_mesh()), rank)
    torch.save(res, os.path.join(a.out, f"rank{rank}.pt"))


if __name__ == "__main__":
    worker(sys.argv[1:])
    sys.exit(0)


# ---- the pytest side ---------------------------------------------------------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from dtdl_tpu.parallel import kvstore as jkv  # noqa: E402
from dtdl_tpu.runtime.bootstrap import \
    BarrierTimeoutError as JaxBarrierTimeout  # noqa: E402
from dtdl_tpu.train import make_train_step as jax_train_step  # noqa: E402
from dtdl_tpu_torch.runtime.bootstrap import BarrierTimeoutError  # noqa: E402
from test_torch_classifier import random_tree  # noqa: E402
from test_torch_classifier_train import jax_state  # noqa: E402


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---- control plane ------------------------------------------------------------

class Flaky:
    """A store whose next ``n`` calls raise the package's transient
    error."""

    def __init__(self, store, mod, n):
        self.store, self.mod, self.n = store, mod, n

    def __getattr__(self, name):
        fn = getattr(self.store, name)

        def call(*a, **kw):
            if self.n > 0:
                self.n -= 1
                raise self.mod.TransientStoreError("blip")
            return fn(*a, **kw)
        return call


def script(mod, barrier_error):
    """One sequence of control-plane calls; what each returned or the
    (error class name, message) it raised."""
    out = []

    def rec(fn, *a, **kw):
        try:
            out.append(("ok", fn(*a, **kw)))
        except Exception as e:   # the named errors are the contract
            name = ("BarrierTimeoutError" if isinstance(e, barrier_error)
                    else type(e).__name__)
            out.append((name, str(e)))

    s = mod.HostKVStore()
    rec(s.set, "a", 1)
    rec(s.get, "a")
    rec(s.get, "missing")
    rec(s.get, "missing", "dflt")
    rec(s.add, "n", 2)
    rec(s.add, "n")
    rec(s.wait, "a", 0.1)
    rec(s.wait, "never", 0.02)
    rec(s.keys, "")
    rec(lambda: s.age("a") is not None and s.age("a") >= 0)
    rec(s.age, "missing")
    rec(lambda: s.newest_age("") >= 0)
    rec(s.newest_age, "zzz")
    rec(s.delete, "a")
    rec(s.keys, "")
    rec(lambda: s.generation)
    rec(s.bump_generation, 0)
    rec(s.bump_generation, 0)
    rec(s.check_generation, 1)
    rec(s.check_generation, 0)
    snap = s.snapshot_state()
    rec(lambda: snap)
    t = mod.HostKVStore()
    t.restore_state(*snap)
    rec(lambda: (t.snapshot_state(), t.age("n") < 1.0))
    # a barrier over two ranks, the second arriving from a thread
    th = threading.Thread(target=mod.store_barrier,
                          args=(s, "b", [0, 1], 1, 1))
    th.start()
    rec(mod.store_barrier, s, "b", [0, 1], 0, 1, 5.0)
    th.join()
    rec(mod.store_barrier, s, "lonely", [0, 1], 0, 1, 0.03)
    rec(mod.store_barrier, s, "stale", [0, 1], 0, 0, 0.03)
    # a bounded retry budget over transient faults
    r = mod.RetryingStore(Flaky(s, mod, 2), retries=3, backoff_s=0.001)
    rec(r.set, "x", 5)
    rec(r.get, "x")
    r = mod.RetryingStore(Flaky(s, mod, 10), retries=2, backoff_s=0.001)
    rec(r.get, "x")
    rec(lambda: mod.RetryingStore(s, retries=-1))
    rec(lambda: issubclass(mod.StoreTimeoutError, mod.StoreError))
    return out


def test_control_plane_matches_jax():
    got = script(kvstore, BarrierTimeoutError)
    want = script(jkv, JaxBarrierTimeout)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w


def test_wait_wakes_on_set_and_times_out_on_time():
    s = kvstore.HostKVStore()
    threading.Timer(0.05, s.set, args=("k", 7)).start()
    assert s.wait("k", 5.0) == 7
    t0 = time.monotonic()
    with pytest.raises(kvstore.StoreTimeoutError, match="did not appear"):
        s.wait("never", 0.05)
    assert time.monotonic() - t0 < 1.0


# ---- data plane, one process -------------------------------------------------

def test_width1_store_applies_rescale_and_average():
    """A 1-replica store sums nothing and still scales."""
    kv = kvstore.KVStore("local", rescale=1.0 / 64)
    assert (kv.aggregation_width, kv.distributed, kv.num_workers,
            kv.rank) == (1, False, 1, 0)
    x = torch.full((4,), 64.0)
    np.testing.assert_allclose(kv.push_pull("g", x).numpy(), 1.0)
    y = torch.full((4,), 64.0)
    np.testing.assert_allclose(
        kvstore.KVStore("device").push_pull("g", y, average=True).numpy(),
        64.0)
    assert isinstance(kvstore.kvstore_strategy("local"), SingleDevice)
    assert isinstance(kvstore.kvstore_strategy(kvstore.create("device")),
                      SingleDevice)
    kv.init("w", {"a": np.ones(2)})
    np.testing.assert_array_equal(kv.pull_init("w")["a"], np.ones(2))
    with pytest.raises(ValueError, match="unknown kvstore kind"):
        kvstore.create("dist_banana")
    assert kvstore.VALID_KINDS == jkv.VALID_KINDS
    with pytest.raises(KeyError):
        kv.pull("never pushed")


# ---- data plane, two gloo ranks ----------------------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("kvstore")
    init = random_tree(models.MLP(n_units=32, device="cpu", seed=None),
                       seed=3)["params"]
    torch.save(init, out / "init.pt")
    rc = launch_local([os.path.abspath(__file__), "--out", str(out)],
                      nproc=2, port=free_port(), timeout=240,
                      env_extra={"OMP_NUM_THREADS": "1", "PYTHONPATH": REPO})
    assert rc == 0, f"the kvstore world exited with {rc}"
    return init, [torch.load(out / f"rank{r}.pt", weights_only=False)
                  for r in range(2)]


def test_push_pull_over_two_ranks(world):
    _, ranks = world
    for r, res in enumerate(ranks):
        assert res["topology"] == ("dist_sync", r, 2, 2, True)
        np.testing.assert_array_equal(res["sum"].numpy(), 3.0)
        assert res["in_place"]
        np.testing.assert_array_equal(res["average"]["a"].numpy(), 1.0)
        np.testing.assert_array_equal(res["average"]["b"][0].numpy(), 1.0)
        np.testing.assert_array_equal(res["rescale"].numpy(), 7.0 * 0.25)
        np.testing.assert_array_equal(res["async"].numpy(), 1.5)
        np.testing.assert_array_equal(res["init"]["v"], np.arange(3))
        assert res["strategy"] == "KVStoreStrategy"


def test_kvstore_strategy_is_bitwise_data_parallel(world):
    _, ranks = world
    for res in ranks:
        for run in ("kvs", "kvs_async"):
            assert res[run]["losses"] == res["ddp"]["losses"]
            for k, v in res["ddp"]["params"].items():
                np.testing.assert_array_equal(res[run]["params"][k], v)
    for k, v in ranks[0]["kvs"]["params"].items():
        np.testing.assert_array_equal(ranks[1]["kvs"]["params"][k], v)


def test_kvstore_strategy_matches_jax_kvstore_strategy(world, devices):
    init, ranks = world
    with jax.enable_x64():
        kvs = jkv.KVStoreStrategy(jkv.create(
            "dist_sync", mesh=Mesh(np.array(devices[:2]), ("data",))))
        state = kvs.replicate(jax_state("mlp", {"params": init},
                                        optax.sgd(LR, momentum=MOMENTUM)))
        step = jax_train_step(kvs)
        losses = []
        for b in batches():
            state, m = step(state, kvs.shard_batch(
                {"image": jnp.asarray(b["image"]),
                 "label": jnp.asarray(b["label"])}))
            losses.append(float(m["loss"]))
        want = bridge.flatten(jax.device_get(state.params))
    got = ranks[0]["kvs"]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    for k, v in want.items():
        np.testing.assert_allclose(got["params"][k], v, rtol=0, atol=1e-5,
                                   err_msg=k)
