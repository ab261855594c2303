"""Elastic training in the port (dtdl_tpu_torch/resil/elastic.py,
runtime/mesh.py:shrink_mesh, the launcher's store and the elastic_train
twin) against the JAX package, on the CPU.

The contracts:

1. **the bitwise shrink**: four workers train the twin's MLP; rank 2 is
   crashed at step 5.  The survivors detect it by its lease, re-form at
   world 3 under generation 1, restore the last committed snapshot and
   finish with parameters bitwise equal to a fault-free world of 3
   restored from the same snapshot, and the timeline consumed every
   global batch exactly once (the effective-sample audit).
2. **the fence**: a stalled peer that wakes after the new world formed
   is refused by a named ``StaleGenerationError``.
3. **against JAX**: the port's per-worker sample logs of the same drill
   equal JAX's as index sets, and the summed gradients of the exchange
   agree with JAX's within 1e-6 for the same MLP weights and batches.
4. ``StepWatchdog`` names a hang, the Trainer's drain rides it, and on a
   gloo world of 2 with one rank stalled it raises ``PeerLostError``
   within its timeout; ``shrink_mesh`` on a gloo world of 4 with a rank
   gone: the survivors' groups form without it, and with the store's
   owner gone it fails fast by name.
5. **the subprocess drills** (each under 60 s): the launcher serving the
   store runs the twin's four processes, one SIGKILLed (bitwise against
   the in-process oracle from the same snapshot, zero lost); and a
   standalone coordinator SIGKILLed and restarted from its WAL mid-run
   (the world never shrinks), then an amnesiac restart refused by name.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import textwrap
import time

import jax
import numpy as np
import pytest
import torch

from dtdl_tpu import resil as jresil
from dtdl_tpu.data import sharding as jsharding
from dtdl_tpu.parallel import kvstore as jkv
from dtdl_tpu_torch import bridge
from dtdl_tpu_torch.data.sharding import GlobalBatchSampler
from dtdl_tpu_torch.examples import elastic_train as twin
from dtdl_tpu_torch.launch import local
from dtdl_tpu_torch.models import MLP
from dtdl_tpu_torch.obs import Observer
from dtdl_tpu_torch.parallel.kvstore import HostKVStore, RetryingStore
from dtdl_tpu_torch.parallel.tcpstore import (ServerEpochError,
                                              TCPStoreClient)
from dtdl_tpu_torch.resil import (ElasticConfig, ElasticWorker, FaultPlan,
                                  PeerLostError, StaleGenerationError,
                                  StepWatchdog, World, effective_sample_log,
                                  exchange_grads, peer_site, run_workers)
from dtdl_tpu_torch.runtime import Mesh, build_mesh, shrink_mesh
import test_elastic as je

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, GLOBAL_BATCH = 8, 12


def mk_cfg(**over):
    base = dict(heartbeat_s=0.03, watchdog_s=0.25, step_timeout_s=2.0,
                join_grace_s=0.2, rendezvous_timeout_s=8.0,
                snapshot_every=2)
    base.update(over)
    return ElasticConfig(**base)


PROBLEM = {}


def problem():
    if not PROBLEM:
        PROBLEM.update(twin.make_problem(0, "cpu"))
    return PROBLEM


def sampler():
    return GlobalBatchSampler(twin.N_EXAMPLES, GLOBAL_BATCH, seed=3)


def mk_workers(store, ranks, ckpt_dir=None, cfg=None, steps=STEPS,
               observer=None, smp=None):
    s = smp or sampler()
    return [ElasticWorker(RetryingStore(store), r, sampler=s,
                          total_steps=steps, cfg=cfg or mk_cfg(),
                          ckpt_dir=ckpt_dir, observer=observer,
                          audit_samples=True, **problem())
            for r in ranks]


def marks(worker, name):
    return [(t, info) for n, t, info in worker.events if n == name]


def assert_same_params(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def assert_zero_lost_zero_dup(eff, steps=STEPS):
    s = sampler()
    assert sorted(eff) == list(range(steps))
    for step, consumed in eff.items():
        np.testing.assert_array_equal(consumed,
                                      np.sort(s.batch_indices(step)))


# ---- the drills in one process ---------------------------------------------

@pytest.mark.elastic
@pytest.mark.faults
def test_kill_one_of_four_shrinks_bitwise_exact(tmp_path):
    cfg = mk_cfg()
    obs = Observer(trace=True, sentinel=None)
    plan = FaultPlan().at(peer_site(2, "step"), 5, "crash")
    with plan:
        ws = mk_workers(HostKVStore(), [0, 1, 2, 3],
                        ckpt_dir=str(tmp_path), cfg=cfg, observer=obs)
        run_workers(ws, timeout_s=60)
    assert plan.log == [(peer_site(2, "step"), 5, "crash")]
    victim, survivors = ws[2], [ws[0], ws[1], ws[3]]
    assert not victim.done and victim.error is not None
    for w in survivors:
        assert w.done and w.error is None
        assert w.world.generation == 1 and w.world.ranks == (0, 1, 3)
    detect = [marks(w, "peer_lost")[0][0] - victim.stopped_t
              for w in survivors]
    assert max(detect) < cfg.watchdog_s + 0.75 < cfg.step_timeout_s
    named = set()
    for w in survivors:
        named |= set(marks(w, "peer_lost")[0][1]["lost"])
    assert named == {2}
    names = {e["name"] for e in obs.tracer.to_chrome()["traceEvents"]
             if e.get("ph") == "i"}
    assert {"elastic_peer_lost", "elastic_rendezvous", "elastic_restore",
            "elastic_snapshot"} <= names

    restored = marks(survivors[0], "restore")[0][1]["step"]
    path = os.path.join(str(tmp_path), f"elastic_{restored:06d}.msgpack")
    assert os.path.exists(path) and 0 < restored < STEPS
    store_b = HostKVStore()
    store_b.set("ckpt/committed", {"step": restored, "path": path})
    ws_b = mk_workers(store_b, [0, 1, 3])
    run_workers(ws_b, timeout_s=60)
    for a, b in zip(survivors, ws_b):
        assert b.done
        assert_same_params(a.state["params"], b.state["params"])
    assert_zero_lost_zero_dup(effective_sample_log(ws))


@pytest.mark.elastic
@pytest.mark.faults
def test_stalled_peer_wakes_late_and_is_fenced_by_name(tmp_path):
    obs = Observer(trace=True, sentinel=None)
    plan = FaultPlan().at(peer_site(1, "step"), 3, "stall", seconds=2.0)
    with plan:
        ws = mk_workers(HostKVStore(), [0, 1, 2], ckpt_dir=str(tmp_path),
                        cfg=mk_cfg(step_timeout_s=0.6), steps=6,
                        observer=obs)
        run_workers(ws, timeout_s=60)
    staller, survivors = ws[1], [ws[0], ws[2]]
    for w in survivors:
        assert w.done and w.error is None
        assert w.world.ranks == (0, 2) and w.world.generation == 1
    assert staller.fenced and not staller.done
    assert isinstance(staller.error, StaleGenerationError)
    assert "fenced out" in str(staller.error)
    names = {e["name"] for e in obs.tracer.to_chrome()["traceEvents"]
             if e.get("ph") == "i"}
    assert "elastic_stale_fenced" in names


# ---- against JAX ------------------------------------------------------------

def _warm_jax():
    s = je._state0()
    g = jax.device_get(je.grad_fn(s, je.batch_fn(np.arange(4))))
    je.apply_fn(s, g, 3)


@pytest.mark.elastic
@pytest.mark.faults
def test_sample_logs_of_the_drill_equal_jax(tmp_path):
    """The kill-one-of-four drill in both packages (JAX's own problem
    there): every worker's log of consumed indices, keyed by
    (generation, step), is the same set in both."""
    _warm_jax()
    with jresil.FaultPlan().at(jresil.peer_site(2, "step"), 5, "crash"):
        jws = je.mk_workers(jkv.HostKVStore(), [0, 1, 2, 3],
                            ckpt_dir=str(tmp_path / "jax"))
        jresil.run_workers(jws, timeout_s=60)
    with FaultPlan().at(peer_site(2, "step"), 5, "crash"):
        tws = mk_workers(HostKVStore(), [0, 1, 2, 3],
                         ckpt_dir=str(tmp_path / "port"),
                         smp=GlobalBatchSampler(je.N, GLOBAL_BATCH, seed=3))
        run_workers(tws, timeout_s=60)
    assert je.GLOBAL_BATCH == GLOBAL_BATCH
    for jw, tw in zip(jws, tws):
        assert jw.done == tw.done and jw.rank == tw.rank
        want = {k: set(np.asarray(v).tolist())
                for k, v in jw.sample_log.items()}
        got = {k: set(np.asarray(v).tolist())
               for k, v in tw.sample_log.items()}
        if jw.rank != 2:
            assert got == want, jw.rank
    # the two samplers are one stream
    js = jsharding.GlobalBatchSampler(48, 12, seed=3)
    ts = GlobalBatchSampler(48, 12, seed=3)
    for step in range(9):
        for world in (1, 2, 3, 4):
            for i in range(world):
                np.testing.assert_array_equal(ts.shard(step, i, world),
                                              js.shard(step, i, world))


def test_summed_gradients_match_jax():
    """Three workers' gradients of JAX's drill MLP, the weights bridged
    into the port, through each package's exchange: the rank-ordered
    sums agree within 1e-6."""
    import threading
    state = je._state0()
    port = MLP(n_units=8, in_features=je.DIM, device="cpu", seed=None)
    bridge.load_flax_params(port, jax.device_get(state.params),
                            device="cpu")
    params = {k: v.detach().clone() for k, v in port.named_parameters()}
    world = (0, 1, 2)
    s = jsharding.GlobalBatchSampler(je.N, je.GLOBAL_BATCH, seed=3)
    cfg_j = jresil.ElasticConfig(heartbeat_s=0, step_timeout_s=10.0)
    cfg_t = ElasticConfig(heartbeat_s=0, step_timeout_s=10.0)
    jstore, tstore = jkv.HostKVStore(), HostKVStore()
    out = {}

    def member(r):
        idx = s.shard(0, r, len(world))
        jg = jax.device_get(je.grad_fn(state, je.batch_fn(idx)))
        out[("jax", r)] = jresil.exchange_grads(
            jstore, jresil.World(0, world, r), 0, jg, cfg_j)
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss = torch.nn.functional.cross_entropy(
            twin.mlp_logits(p, torch.from_numpy(je.X[idx])),
            torch.from_numpy(je.Y[idx]))
        g = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        out[("port", r)] = exchange_grads(
            tstore, World(0, world, r), 0,
            {k: v.numpy() for k, v in g.items()}, cfg_t)

    ts = [threading.Thread(target=member, args=(r,)) for r in world]
    [t.start() for t in ts]
    [t.join(30) for t in ts]
    for r in world:
        summed = MLP(n_units=8, in_features=je.DIM, device="cpu", seed=None)
        with torch.no_grad():
            for k, v in summed.named_parameters():
                v.copy_(torch.from_numpy(out[("port", r)][k]))
        got = bridge.flatten(bridge.state_dict_to_flax(summed))
        want = bridge.flatten(out[("jax", r)])
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                       err_msg=k)


# ---- watchdog and mesh ------------------------------------------------------

def test_step_watchdog_names_the_hang():
    wd = StepWatchdog(timeout_s=0.15, name="drain")
    assert wd.run(lambda: 41 + 1) == 42
    with pytest.raises(ZeroDivisionError):
        wd.run(lambda: 1 // 0)
    with pytest.raises(PeerLostError, match="drain did not settle"):
        wd.run(time.sleep, 0.6)
    assert wd.n_timeouts == 1


def test_trainer_drain_rides_the_watchdog(tmp_path):
    from dtdl_tpu_torch.train import Trainer
    tr = Trainer(None, lambda s, b: (s, {}), None, None,
                 out=str(tmp_path), watchdog=StepWatchdog(0.1))
    tr.metrics_queue.drain = lambda: time.sleep(0.5)     # the wedge
    with pytest.raises(PeerLostError, match="did not settle"):
        tr._drain_metrics()
    tr.metrics_queue.drain = lambda: []
    tr._drain_metrics()


def test_shrink_mesh_keeps_survivor_positions():
    mesh = Mesh((0, 1, 2, 3, 4, 5), ("data",))
    small = shrink_mesh(mesh, [0, 2, 5])
    assert small.shape == {"data": 3} and small.ranks == (0, 2, 5)
    grid = Mesh(tuple(range(6)), ("data", "model"), dims=(3, 2))
    assert shrink_mesh(grid, [2, 0]).ranks == (0, 1, 4, 5)
    assert shrink_mesh(grid, [1], axis="model").ranks == (1, 3, 5)
    with pytest.raises(ValueError, match="at least one survivor"):
        shrink_mesh(mesh, [])
    with pytest.raises(ValueError, match="outside axis"):
        shrink_mesh(mesh, [0, 11])
    with pytest.raises(ValueError, match="no axis"):
        shrink_mesh(mesh, [0], axis="pipe")
    assert shrink_mesh(build_mesh(), [0]).ranks == (0,)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


WORLD_CHILD = """
    import os, sys, time
    import torch, torch.distributed as dist
    torch.set_num_threads(1)
    from dtdl_tpu_torch.resil import PeerLostError, StepWatchdog
    from dtdl_tpu_torch.runtime import (ShrinkMeshError, build_mesh,
                                        initialize, shrink_mesh)
    a = sys.argv
    mode, rank, n = a[1], int(a[-1]), int(a[-3])
    initialize(a[-5], n, rank, device="cpu", timeout_s=30)
    t = torch.ones(1)
    dist.all_reduce(t)
    if mode == "watchdog":
        if rank == 1:
            time.sleep(3.0)          # the stalled peer
        else:
            t0 = time.monotonic()
            try:
                StepWatchdog(0.5, name="drain").run(dist.all_reduce, t)
                print("result no timeout", flush=True)
            except PeerLostError as e:
                print(f"result named {time.monotonic() - t0:.3f} {e}",
                      flush=True)
        os._exit(0)
    dead = int(mode)
    mesh = build_mesh((2, 2), ("data", "model"))
    dist.all_reduce(t)               # every rank is past build_mesh
    if rank == dead:
        os._exit(0)                  # gone, without a goodbye
    if dead == 0:                    # gone means its store is gone too
        from torch.distributed.distributed_c10d import _get_default_store
        store, t1 = _get_default_store(), time.monotonic()
        while time.monotonic() - t1 < 20:
            try:
                store.check(["gone"])
            except Exception:
                break
            time.sleep(0.02)
    keep = [p for p in range(2) if p != mesh.coords(dead)["data"]]
    try:
        small = shrink_mesh(mesh, keep)
        if small is None:
            print(f"result outside {rank}", flush=True)
        else:
            t = torch.full((1,), float(rank))
            dist.all_reduce(t, group=small.axis_group("model"))
            print(f"result shrunk {rank} {small.ranks} {small.dims} "
                  f"{t.item()}", flush=True)
    except ShrinkMeshError as e:
        print(f"result named {rank} {e}", flush=True)
    os._exit(0)
"""


def run_world(tmp_path, capfd, mode, nproc):
    child = tmp_path / "world_child.py"
    child.write_text(textwrap.dedent(WORLD_CHILD))
    env = {"PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                            "")}
    rc = local.launch_local([str(child), mode], nproc=nproc,
                            port=_free_port(), env_extra=env, timeout=50)
    out = capfd.readouterr().out
    assert rc == 0, out[-3000:]
    return [line.split("result ", 1)[1] for line in out.splitlines()
            if "] result " in line]


@pytest.mark.elastic
def test_shrink_mesh_on_a_gloo_world_of_four(tmp_path, capfd):
    """Rank 3 gone: the survivors of data position 0 form their groups
    alone and reduce over them (rank 2, its line's other member, is
    outside).  Rank 0 (the rendezvous store's owner) gone: the survivors
    fail fast with ShrinkMeshError, not a hang."""
    got = sorted(run_world(tmp_path, capfd, "3", 4))
    assert got == ["outside 2", "shrunk 0 (0, 1) (1, 2) 1.0",
                   "shrunk 1 (0, 1) (1, 2) 1.0"], got
    t0 = time.monotonic()
    got = sorted(run_world(tmp_path, capfd, "0", 4))
    assert [g.split()[:2] for g in got] == [["named", "2"], ["named", "3"],
                                            ["outside", "1"]], got
    assert all("store" in g for g in got[:2])
    assert time.monotonic() - t0 < 40


@pytest.mark.elastic
def test_step_watchdog_on_a_gloo_drain_with_a_stalled_rank(tmp_path,
                                                           capfd):
    got = run_world(tmp_path, capfd, "watchdog", 2)
    assert len(got) == 1 and got[0].startswith("named"), got
    waited = float(got[0].split()[1])
    assert 0.5 <= waited < 1.5 and "drain did not settle" in got[0]


# ---- the subprocess drills --------------------------------------------------

TWIN = ["-m", "dtdl_tpu_torch.examples.elastic_train", "--device", "cpu",
        "--steps", str(STEPS), "--batch-size", "3", "--heartbeat-s", "0.05",
        "--watchdog-s", "0.6", "--join-grace-s", "0.8"]


def child_env():
    return {"PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""),
            "OMP_NUM_THREADS": "1"}


def journals(out_dir, ranks):
    """The surviving timeline from the per-rank journals: for each step
    the highest generation applied, every rank's shard there."""
    top, logs = {}, {}
    for r in ranks:
        path = os.path.join(out_dir, f"samples_{r}.jsonl")
        for line in open(path) if os.path.exists(path) else ():
            rec = json.loads(line)
            logs[(r, rec["gen"], rec["step"])] = rec["idx"]
            top[rec["step"]] = max(top.get(rec["step"], rec["gen"]),
                                   rec["gen"])
    return {step: np.sort(np.concatenate(
        [np.asarray(logs[(r, gen, step)], int) for r in ranks
         if (r, gen, step) in logs])) for step, gen in top.items()}


def twin_sampler():
    return GlobalBatchSampler(twin.N_EXAMPLES, 4 * 3 * 3, seed=0)


@pytest.mark.subprocess
@pytest.mark.elastic
@pytest.mark.faults
def test_launcher_store_and_twin_survive_a_sigkilled_worker(tmp_path,
                                                            capfd):
    """``launch_local(serve_store=True, elastic=True)`` runs the twin's
    four worker processes; rank 2 is SIGKILLed at step 5.  The survivors
    re-form at world 3 and finish bitwise equal to the twin's problem
    run in-process from the same committed snapshot; zero samples lost
    or counted twice, the victim's flushed journal included."""
    ck, out = str(tmp_path / "ck"), str(tmp_path / "out")
    t0 = time.monotonic()
    rc = local.launch_local(
        TWIN + ["--ckpt-dir", ck, "--out-dir", out, "--kill-rank", "2",
                "--kill-at", "5"],
        nproc=4, port=_free_port(), env_extra=child_env(), timeout=55,
        serve_store=True, store_wal_dir=str(tmp_path / "wal"), elastic=True)
    log = capfd.readouterr().out
    assert rc == 0, log[-3000:]
    assert time.monotonic() - t0 < 60
    assert "rank 2 lost to signal 9" in log
    res = {r: json.load(open(os.path.join(out, f"result_{r}.json")))
           for r in (0, 1, 3)}
    assert not os.path.exists(os.path.join(out, "result_2.json"))
    for r in res.values():
        assert r["done"] and r["error"] is None
        assert r["generation"] == 1 and r["ranks"] == [0, 1, 3]
    assert set().union(*(r["lost"] for r in res.values())) == {2}
    restored = {r["restored_step"] for r in res.values()}
    assert len(restored) == 1
    restored = restored.pop()
    assert 0 < restored < STEPS
    eff = journals(out, (0, 1, 2, 3))
    s = twin_sampler()
    assert sorted(eff) == list(range(STEPS))
    for step, consumed in eff.items():
        np.testing.assert_array_equal(consumed,
                                      np.sort(s.batch_indices(step)))
    # the in-process oracle: the world of 3 from the same snapshot
    store = HostKVStore()
    store.set("ckpt/committed",
              {"step": restored,
               "path": os.path.join(ck, f"elastic_{restored:06d}.msgpack")})
    oracle = [ElasticWorker(RetryingStore(store), r, sampler=s,
                            total_steps=STEPS,
                            cfg=ElasticConfig(heartbeat_s=0,
                                              join_grace_s=0.2),
                            **twin.make_problem(0, "cpu"))
              for r in (0, 1, 3)]
    run_workers(oracle, timeout_s=30)
    for r in (0, 1, 3):
        final = torch.load(os.path.join(out, f"final_{r}.pt"))
        assert_same_params(final, oracle[0].state["params"])


def spawn_store(port, wal):
    p = subprocess.Popen(
        [sys.executable, "-m", "dtdl_tpu_torch.parallel.tcpstore",
         "--port", str(port), "--wal-dir", wal],
        env={**os.environ, **child_env()}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    line = p.stdout.readline()          # blocks until "STORE ready ..."
    assert "STORE ready" in line, line
    return p, line


@pytest.mark.subprocess
@pytest.mark.elastic
@pytest.mark.faults
def test_coordinator_sigkilled_restarts_from_wal_and_amnesia_is_refused(
        tmp_path, capfd):
    """A standalone coordinator (``python -m
    dtdl_tpu_torch.parallel.tcpstore``) serves the twin's three worker
    processes (the launcher exports its address); once a snapshot is
    committed it is SIGKILLed and restarted from its WAL: the workers
    ride the outage, the world never shrinks, no sample is lost.  A
    restart without the WAL is then refused by name."""
    import threading
    port, wal = _free_port(), str(tmp_path / "wal")
    out = str(tmp_path / "out")
    store_proc, _ = spawn_store(port, wal)
    addr = f"127.0.0.1:{port}"
    box = {}
    launch = threading.Thread(target=lambda: box.update(rc=local.launch_local(
        TWIN + ["--workers", "3", "--ckpt-dir", str(tmp_path / "ck"),
                "--out-dir", out, "--step-timeout-s", "20"],
        nproc=3, port=_free_port(), env_extra=child_env(), timeout=55,
        store_port=port, elastic=True)))
    t0 = time.monotonic()
    launch.start()
    try:
        watcher = TCPStoreClient(addr, reconnect_attempts=20,
                                 max_backoff_s=0.2)
        while watcher.get("ckpt/committed", None) is None:
            assert time.monotonic() - t0 < 40, "no snapshot committed"
            time.sleep(0.02)
        store_proc.kill()
        assert store_proc.wait(timeout=10) == -signal.SIGKILL
        store_proc, ready = spawn_store(port, wal)
        assert "recovered=True" in ready
        launch.join(60)
        assert not launch.is_alive()
        log = capfd.readouterr().out
        assert box["rc"] == 0, log[-3000:]
        res = [json.load(open(os.path.join(out, f"result_{r}.json")))
               for r in range(3)]
        for r in res:
            assert r["done"] and r["generation"] == 0
            assert r["ranks"] == [0, 1, 2]
        assert sum(r["reconnects"] for r in res) >= 1
        eff = journals(out, (0, 1, 2))
        s = GlobalBatchSampler(twin.N_EXAMPLES, 6 * 3, seed=0)
        assert sorted(eff) == list(range(STEPS))
        for step, consumed in eff.items():
            np.testing.assert_array_equal(consumed,
                                          np.sort(s.batch_indices(step)))
        # the watcher pinned the epoch; a restart without the WAL is
        # refused by name
        assert watcher.get("world/latest")[0] == 0
        store_proc.kill()
        store_proc.wait(timeout=10)
        store_proc, ready = spawn_store(port, str(tmp_path / "empty"))
        assert "recovered=False" in ready
        with pytest.raises(ServerEpochError, match="WITHOUT its WAL"):
            watcher.get("world/latest")
        assert time.monotonic() - t0 < 60
    finally:
        store_proc.kill()
        store_proc.wait(timeout=10)
        launch.join(5)
