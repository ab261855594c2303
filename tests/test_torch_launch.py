"""The port's distributed plumbing on the CPU: the launcher, rendezvous
and barrier, the mesh and strategy surface, the flag library and the
sharding helpers (against the JAX package's), the leader-only final
weights, the leader-gated CIFAR-10 download from a ``file://`` archive,
and both example twins over two gloo ranks.

Every multi-process case spawns real processes through
``dtdl_tpu_torch.launch.local`` on a free port; the pytest process never
joins a process group (the rendezvous retry test replaces
``init_process_group`` with a failing stand-in).  The twins run once per
module (``twins`` fixture) from a ``python -m`` launcher command line.
Sharding and config outputs must be equal to the JAX package's, not
close.
"""

import argparse
import json
import os
import random
import socket
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from dtdl_tpu.data import datasets as jdatasets
from dtdl_tpu.data import sharding as jsharding
from dtdl_tpu.parallel import SingleDevice as JaxSingleDevice
from dtdl_tpu.runtime import bootstrap as jbootstrap
from dtdl_tpu.utils import config as jconfig
from dtdl_tpu_torch import bridge
from dtdl_tpu_torch.ckpt import (CheckpointCorruptError, Checkpointer,
                                 load_weights, save_weights)
from dtdl_tpu_torch.data import datasets, sharding
from dtdl_tpu_torch.device import NoCudaDeviceError
from dtdl_tpu_torch.launch import local
from dtdl_tpu_torch.models import pyramidnet
from dtdl_tpu_torch.parallel import (AutoSharded, DataParallel,
                                     SingleDevice, check_strategy,
                                     choose_strategy, data_parallel_local,
                                     distributed_data_parallel)
from dtdl_tpu_torch.parallel.collectives import tree_digest
from dtdl_tpu_torch.runtime import (Mesh, bootstrap, build_mesh,
                                    describe_topology, hybrid_mesh,
                                    local_mesh, shrink_mesh)
from dtdl_tpu_torch.utils import config
from dtdl_tpu_torch.utils.random import host_rng, seed_everything
from test_data import _make_cifar_fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {"PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def script(tmp_path, body: str) -> str:
    path = tmp_path / "child.py"
    path.write_text(textwrap.dedent(body))
    return str(path)


# ---- the flag library and the sharding helpers, equal to JAX ---------------

def _parser(mod):
    p = mod.make_parser("x")
    mod.add_train_flags(p)
    mod.add_data_flags(p)
    mod.add_ckpt_flags(p)
    mod.add_topology_flags(p)
    mod.flag(p, "--dist-backend", default="ici")
    return p


@pytest.mark.parametrize("argv", [
    [],
    ["--batch_size", "256", "--lr", "0.05", "--epoch", "3", "--wd", "0"],
    ["-b", "32", "--dataset", "cifar10", "--dataset_dir", "/d",
     "--no-download", "--limit-train", "10", "-o", "out", "--no-save-model"],
    ["--init-method", "h:1", "--world_size", "4", "--rank", "2",
     "--mesh-shape", "4", "--platform", "cpu", "--dist_backend", "gloo"],
])
def test_config_parses_like_jax(argv):
    got = _parser(config).parse_args(argv)
    want = _parser(jconfig).parse_args(argv)
    assert vars(got) == vars(want)
    assert config.parse_mesh_shape(got) == jconfig.parse_mesh_shape(want)
    bad = argparse.Namespace(mesh_shape="4,2", mesh_axes="data")
    with pytest.raises(ValueError, match="does not match"):
        config.parse_mesh_shape(bad)


def test_sharding_helpers_equal_jax():
    arrays = {"x": np.arange(50).reshape(25, 2), "y": np.arange(25)}
    for shard in range(3):
        got = sharding.scatter_arrays(arrays, 3, shard, seed=4)
        want = jsharding.scatter_arrays(arrays, 3, shard, seed=4)
        for k in arrays:
            np.testing.assert_array_equal(got[k], want[k])
    g = sharding.GlobalBatchSampler(100, 12, seed=2)
    j = jsharding.GlobalBatchSampler(100, 12, seed=2)
    for step in (0, 7, 8, 20):
        np.testing.assert_array_equal(g.batch_indices(step),
                                      j.batch_indices(step))
        for world in (1, 2, 3, 4, 6):
            for i in range(world):
                np.testing.assert_array_equal(g.shard(step, i, world),
                                              j.shard(step, i, world))
    with pytest.raises(ValueError, match="does not divide"):
        g.check_world(5)
    for w in range(1, 9):
        assert sharding.elastic_global_batch(w, 3) == \
            jsharding.elastic_global_batch(w, 3)
    ok = [sharding.ShardedSampler(10, 3, i, remainder="drop")
          for i in range(3)]
    sharding.assert_no_overlap(ok)
    same = [sharding.ShardedSampler(10, 2, 0, remainder="drop")] * 2
    with pytest.raises(AssertionError, match="overlapping"):
        sharding.assert_no_overlap(same)


def test_seeding():
    g = seed_everything(3)
    assert isinstance(g, torch.Generator) and g.initial_seed() == 3
    assert np.random.randint(1 << 30) == np.random.RandomState(3).randint(1 << 30)
    r0, r1 = host_rng(g, 0), host_rng(g, 1)
    assert r0.initial_seed() != r1.initial_seed()
    assert host_rng(g, 1).initial_seed() == r1.initial_seed()
    assert host_rng(g).initial_seed() == r0.initial_seed()


# ---- bootstrap, mesh, strategy ---------------------------------------------

def test_backoff_and_rendezvous_retries(monkeypatch):
    for attempt in range(6):
        for u in (0.0, 0.3, 0.99):
            assert bootstrap.backoff_delay(attempt, 0.5, 3.0, u) == \
                jbootstrap.backoff_delay(attempt, 0.5, 3.0, u)
    calls, sleeps = [], []

    def refuse(**kw):
        calls.append(kw)
        raise RuntimeError("connection refused")

    monkeypatch.setattr(bootstrap.dist, "init_process_group", refuse)
    monkeypatch.setattr(bootstrap.time, "sleep", sleeps.append)
    random.seed(0)
    us = [random.random() for _ in range(3)]
    random.seed(0)
    with pytest.raises(RuntimeError, match="connection refused"):
        bootstrap.initialize("127.0.0.1:1", 2, 1, retries=3, backoff_s=0.5,
                             max_backoff_s=1.5, device="cpu")
    assert len(calls) == 4 and not bootstrap._initialized
    assert sleeps == [bootstrap.backoff_delay(i, 0.5, 1.5, u)
                      for i, u in enumerate(us)]
    kw = calls[0]
    assert (kw["backend"], kw["init_method"], kw["world_size"],
            kw["rank"]) == ("gloo", "tcp://127.0.0.1:1", 2, 1)


def test_initialize_refusals_and_single_process(monkeypatch):
    monkeypatch.delenv("DTDL_STORE_ADDR", raising=False)
    bootstrap.initialize(store_addr="h:9")         # one process: no world
    assert os.environ["DTDL_STORE_ADDR"] == "h:9"
    assert not torch.distributed.is_initialized()
    assert bootstrap.process_count() == 1 and bootstrap.is_leader()
    bootstrap.barrier("alone", timeout_s=0.1)      # no-op
    with pytest.raises(ValueError, match="coordinator"):
        bootstrap.initialize("", 2, 0, device="cpu")
    with pytest.raises(ValueError, match="nccl backend runs on the card"):
        bootstrap.initialize("h:1", 2, 0, device="cpu", backend="nccl")
    with pytest.raises(ValueError, match="'nccl' or 'gloo'"):
        bootstrap.initialize("h:1", 2, 0, device="cpu", backend="mpi")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDeviceError):      # the card by default
        bootstrap.initialize("h:1", 2, 0)


def test_mesh_and_strategy_surface():
    mesh = build_mesh()
    assert mesh.ranks == (0,) and mesh.group is None and \
        mesh.shape == {"data": 1}
    assert local_mesh().size == 1
    with pytest.raises(ValueError, match="needs 2 devices"):
        build_mesh((2,))
    # multi-axis meshes, the hybrid mesh, DP over a tuple of axes and the
    # compiler-partitioned strategy run
    grid = build_mesh((1, 1), ("data", "model"))
    assert grid.shape == {"data": 1, "model": 1} and grid.group is None
    assert grid.axis_group("model") is None and grid.line("model") == (0,)
    assert local_mesh(("a", "b")).shape == {"a": 1, "b": 1}
    hybrid = hybrid_mesh()
    assert hybrid.axis_names == ("dcn", "data") and hybrid.size == 1
    dp = DataParallel(hybrid, axis=("dcn", "data"))
    assert dp.num_replicas == 1 and dp.replicas.axis_names == ("dcn", "data")
    with pytest.raises(ValueError, match="mesh has no axis 'dcn'"):
        DataParallel(axis=("dcn", "data"))
    for call in (AutoSharded, lambda: choose_strategy("pjit")):
        s = call()
        assert isinstance(s, AutoSharded) and s.num_replicas == 1
    with pytest.raises(NotImplementedError, match="A13"):
        shrink_mesh(mesh, [0])
    assert isinstance(choose_strategy("auto"), SingleDevice)
    for name in ("dp", "ddp"):
        s = choose_strategy(name)
        assert isinstance(s, DataParallel) and s.num_replicas == 1
    assert data_parallel_local().num_replicas == 1
    assert distributed_data_parallel().mesh.axis_names == ("data",)
    with pytest.raises(ValueError, match="unknown strategy"):
        choose_strategy("zero")
    assert DataParallel(Mesh((0, 1))).per_replica_batch(64) == 32
    with pytest.raises(ValueError, match="not divisible by 3"):
        DataParallel(Mesh((0, 1, 2))).per_replica_batch(64)
    assert SingleDevice().per_replica_batch(64) == 64
    for wrong in (JaxSingleDevice(), object(), "dp"):
        with pytest.raises(TypeError, match="not a dtdl_tpu_torch strategy"):
            check_strategy(wrong)
    t = describe_topology("cpu")
    assert (t["platform"], t["num_processes"], t["process_index"]) == \
        ("cpu", 1, 0)


# ---- the launcher ----------------------------------------------------------

def test_launcher_appends_flags_and_stripes_cards(tmp_path, capfd):
    child = script(tmp_path, """
        import os, sys
        print("argv", sys.argv[1:], os.environ.get("CUDA_VISIBLE_DEVICES"),
              os.environ.get("OMP_NUM_THREADS"))
    """)
    port = free_port()
    assert local.launch_local([child, "--x", "1"], nproc=2, port=port,
                              devices_per_proc=2, timeout=60) == 0
    out = capfd.readouterr().out
    for i, cards in ((0, "0,1"), (1, "2,3")):
        want = (f"[rank {i}] argv ['--x', '1', '--coordinator', "
                f"'127.0.0.1:{port}', '--num-processes', '2', "
                f"'--process-id', '{i}'] {cards} ")
        assert want in out, out


def test_launcher_fails_fast_and_times_out(tmp_path):
    child = script(tmp_path, """
        import sys, time
        if sys.argv[-1] == "1":
            sys.exit(3)
        time.sleep(120)
    """)
    t0 = time.monotonic()
    assert local.launch_local([child], nproc=2, port=free_port(),
                              timeout=60) == 3
    assert time.monotonic() - t0 < 15     # not the sleeping rank's 120 s
    sleeper = script(tmp_path, "import time; time.sleep(120)\n")
    t0 = time.monotonic()
    assert local.launch_local([sleeper], nproc=2, port=free_port(),
                              timeout=2) == 124
    assert time.monotonic() - t0 < 20


def test_launcher_restarts_and_refusals(tmp_path):
    marker = tmp_path / "attempted"
    child = script(tmp_path, f"""
        import os, sys
        if sys.argv[-1] == "0" and not os.path.exists({str(marker)!r}):
            open({str(marker)!r}, "w").close()
            sys.exit(5)
    """)
    assert local.launch_local([child], nproc=2, port=free_port(),
                              timeout=60) == 5
    marker.unlink()
    assert local.launch_local([child], nproc=2, port=free_port(),
                              timeout=60, max_restarts=1) == 0
    for kw in ({"serve_store": True}, {"store_port": 1},
               {"store_wal_dir": "w"}):
        with pytest.raises(NotImplementedError, match="A13"):
            local.launch_local([child], **kw)
    with pytest.raises(SystemExit, match="no script"):
        local.main(["--nproc", "2", "--"])
    with pytest.raises(SystemExit, match="unknown launcher flag"):
        local.main(["--bogus"])


def test_barrier_timeout_is_named(tmp_path):
    """Two gloo ranks: a barrier both reach, then rank 1 leaves without
    the second one, and rank 0's bounded wait raises BarrierTimeoutError
    naming the barrier."""
    child = script(tmp_path, """
        import sys, time
        from dtdl_tpu_torch.runtime import bootstrap
        a = sys.argv
        bootstrap.initialize(a[-5], int(a[-3]), int(a[-1]), device="cpu",
                             timeout_s=60)
        bootstrap.barrier("both", timeout_s=30)
        print("passed both", flush=True)
        if bootstrap.process_index() == 1:
            time.sleep(3)
            sys.exit(0)
        try:
            bootstrap.barrier("late", timeout_s=1.0)
        except bootstrap.BarrierTimeoutError as e:
            print("raised", type(e).__name__, str(e)[:40], flush=True)
    """)
    out = subprocess.run(
        [sys.executable, "-m", "dtdl_tpu_torch.launch.local", "--nproc",
         "2", "--port", str(free_port()), "--timeout", "90", "--", child],
        capture_output=True, text=True, env={**os.environ, **ENV},
        cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.count("passed both") == 2
    assert "[rank 0] raised BarrierTimeoutError barrier 'late' timed out" \
        in out.stdout, out.stdout


# ---- final weights -----------------------------------------------------------

def test_weights_round_trip_corruption_and_mismatch(tmp_path):
    tree = {"Dense_0": {"kernel": torch.arange(6.0).reshape(2, 3),
                        "bias": np.ones(3, np.float32)},
            "Dense_1": {"kernel": torch.ones(3, 1, dtype=torch.bfloat16)}}
    path = str(tmp_path / "w" / "final.pt")
    assert save_weights(path, tree) == path
    back = load_weights(path, tree)
    assert tree_digest(back) == tree_digest(
        {"Dense_0": {"kernel": tree["Dense_0"]["kernel"],
                     "bias": torch.from_numpy(tree["Dense_0"]["bias"])},
         "Dense_1": tree["Dense_1"]})
    flat = bridge.flatten(tree)
    assert set(load_weights(path, flat)) == set(flat)
    manifest = json.loads(open(path + ".manifest.json").read())
    assert manifest["bytes"] == os.path.getsize(path)
    blob = open(path, "rb").read()
    open(path, "wb").write(blob[:-7])
    with pytest.raises(CheckpointCorruptError, match="truncated"):
        load_weights(path, tree)
    open(path, "wb").write(blob[:-1] + bytes([blob[-1] ^ 1]))
    with pytest.raises(CheckpointCorruptError, match="sha256"):
        load_weights(path, tree)
    os.remove(path + ".manifest.json")
    open(path, "wb").write(b"not a torch file")
    with pytest.raises(CheckpointCorruptError, match="bytes"):
        load_weights(path, tree)
    save_weights(path, tree)
    for like, match in (
            ({**flat, "Dense_0/kernel": torch.zeros(3, 2)}, "shape|\\(3, 2\\)"),
            ({**flat, "Dense_1/kernel": torch.ones(3, 1)}, "dtype"),
            ({k: v for k, v in flat.items() if k != "Dense_0/bias"},
             "structure")):
        with pytest.raises(ValueError, match=match):
            load_weights(path, like)
    ck = Checkpointer(str(tmp_path / "ck"))
    assert ck.save_final(tree).endswith("final.pt")
    # the snapshot half (per-epoch weights, state snapshots) works now
    assert ck.save_weights_epoch(0, tree).endswith("weights_epoch_0000.pt")
    back, epoch = ck.latest_weights(tree)
    assert epoch == 0 and tree_digest(back) == tree_digest(
        load_weights(path, tree))
    ck.save(1, tree, wait=True)
    back, step = ck.restore(tree)
    assert step == 1 and tree_digest(back) == tree_digest(
        load_weights(path, tree))


# ---- the CIFAR-10 download ---------------------------------------------------

def test_cifar10_downloads_from_file_url(tmp_path, monkeypatch):
    """load_cifar10's download=True path against a file:// archive: the
    same arrays as the JAX package's download; a bad checksum raises."""
    tgz, md5 = _make_cifar_fixture(tmp_path)
    monkeypatch.delenv("DTDL_OFFLINE", raising=False)
    monkeypatch.setattr(datasets, "CIFAR10_URL", tgz.as_uri())
    monkeypatch.setattr(datasets, "CIFAR10_MD5", md5)
    got = datasets.load_cifar10(str(tmp_path / "port"))
    want = jdatasets.load_cifar10(str(tmp_path / "port"), download=False)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    assert got[0][0].shape == (100, 32, 32, 3)
    with pytest.raises(IOError, match="checksum mismatch"):
        datasets.download_cifar10(str(tmp_path / "bad"), url=tgz.as_uri(),
                                  md5="0" * 32)


def test_download_lock_waits_for_live_winner(tmp_path, monkeypatch):
    import threading
    lock = tmp_path / ".cifar10.download.lock"
    lock.touch()

    def release_soon():
        time.sleep(1.5)
        lock.unlink()
    t = threading.Thread(target=release_soon)
    t.start()
    calls = []
    monkeypatch.setattr(datasets, "_find_cifar10_dir", lambda r: str(tmp_path))
    monkeypatch.setattr(datasets, "download_cifar10", calls.append)
    t0 = time.monotonic()
    datasets._download_locked(str(tmp_path), heartbeat=0.5, stale_after=30.0)
    t.join()
    assert time.monotonic() - t0 >= 1.0 and calls == []
    assert not lock.exists()


# ---- the twins over two gloo ranks -------------------------------------------

def _launch(args, timeout=200):
    return subprocess.run(
        [sys.executable, "-m", "dtdl_tpu_torch.launch.local", "--nproc",
         "2", "--port", str(free_port()), "--timeout", str(timeout - 20),
         "--", "-m", *args], capture_output=True, text=True,
        env={**os.environ, **ENV, "DTDL_OFFLINE": "1"}, cwd=REPO,
        timeout=timeout)


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("twins")
    _make_cifar_fixture(tmp)            # 100 train, 20 test images
    ddp = _launch(["dtdl_tpu_torch.examples.distributed_data_parallel",
                   "--platform", "cpu", "--dataset-dir",
                   str(tmp / "fixture_src"), "--batch-size", "8",
                   "--limit-train", "16", "--limit-test", "12",
                   "--epochs", "1", "--dtype", "float32",
                   "--log-interval", "1", "--out", str(tmp / "ddp")])
    lm = _launch(["dtdl_tpu_torch.examples.train_lm", "--strategy", "ddp",
                  "--platform", "cpu", "--batch-size", "64", "--seq-len",
                  "16", "--epochs", "1", "--log-interval", "16",
                  "--generate-tokens", "3", "--out", str(tmp / "lm")])
    return tmp, ddp, lm


def test_ddp_twin_two_ranks_leader_writes(twins):
    tmp, ddp, _ = twins
    assert ddp.returncode == 0, ddp.stdout[-3000:] + ddp.stderr[-3000:]
    out = ddp.stdout
    summaries = [json.loads(line.split("ddp_summary ", 1)[1])
                 for line in out.splitlines() if "ddp_summary " in line]
    assert sorted(s["rank"] for s in summaries) == [0, 1]
    assert {s["world"] for s in summaries} == {2}
    assert {s["steps"] for s in summaries} == {2}
    assert len({s["params_digest"] for s in summaries}) == 1
    assert len({s["batch_stats_digest"] for s in summaries}) == 1
    files = sorted(os.listdir(tmp / "ddp"))
    assert files == ["final.pt", "final.pt.manifest.json", "log.jsonl"]
    rows = [json.loads(x) for x in open(tmp / "ddp" / "log.jsonl")]
    assert [r.get("split") for r in rows][-2:] == ["train_epoch", "val"]
    assert "[rank 1]" not in "".join(x for x in out.splitlines()
                                     if "Epoch [" in x)
    assert out.count("leader saved weights") == 1
    like = bridge.state_dict_to_flax(pyramidnet(device="cpu", seed=None))
    back = load_weights(str(tmp / "ddp" / "final.pt"), like)
    assert tree_digest(back) == summaries[0]["params_digest"]


def test_lm_twin_two_ranks(twins):
    tmp, _, lm = twins
    assert lm.returncode == 0, lm.stdout[-3000:] + lm.stderr[-3000:]
    out = lm.stdout
    assert out.count("generated:") == 1 and "[rank 0] generated:" in out
    assert "tokens_per_sec" in out and "saved weights to" in out
    assert sorted(os.listdir(tmp / "lm")) == ["lm_final.pt",
                                              "lm_final.pt.manifest.json"]
