"""SLURM launch in the port (``dtdl_tpu_torch.launch.slurm``) against the
JAX package's ``dtdl_tpu.launch.slurm``.

* The counterpart of each test of tests/test_slurm.py, on the port's
  module.
* Parity: ``expand_nodelist``, ``job_port``, ``from_env``,
  ``maybe_slurm``, ``store_port`` and ``store_addr_from_env`` equal the
  JAX functions' on the same environments, and the ``sbatch_script`` text
  (every option) equals JAX's but for the module names.
* The card binding: under the block distribution a node's tasks bind
  distinct cards; a cyclic layout is refused by name.
* Two gloo ranks on the CPU join one world from a faked SLURM environment
  alone: once through ``python -m dtdl_tpu_torch.launch.slurm --`` (the
  flags it appends) and once with ``examples.common.bootstrap`` reading
  the environment itself.  This file is the rank's ``__main__``.

Tolerance: exact.
"""

import json
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _worker() -> int:
    """One rank: bootstrap (the appended flags, or SLURM's environment),
    an all-reduce, and the rank's view written as JSON."""
    import argparse

    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from dtdl_tpu_torch.examples.common import bootstrap
    from dtdl_tpu_torch.runtime import process_count, process_index

    ap = argparse.ArgumentParser()
    ap.add_argument("--out")
    ap.add_argument("--coordinator", default="")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--platform", default="cpu")
    a = ap.parse_args()
    torch.set_num_threads(1)
    bootstrap(a)
    t = torch.tensor([float(process_index() + 1)])
    dist.all_reduce(t)
    with open(f"{a.out}.{process_index()}", "w") as f:
        json.dump({"rank": process_index(), "world": process_count(),
                   "sum": float(t), "flags": a.coordinator}, f)
    return 0


if __name__ == "__main__":
    sys.exit(_worker())

# ---- the pytest side --------------------------------------------------------

import pytest  # noqa: E402

from dtdl_tpu.launch import slurm as jslurm  # noqa: E402
from dtdl_tpu_torch.launch import slurm  # noqa: E402


@pytest.mark.parametrize("spec,expect", [
    ("c1", ["c1"]),
    ("c1,c2", ["c1", "c2"]),
    ("gpu[1-3]", ["gpu1", "gpu2", "gpu3"]),
    ("n[001-003]", ["n001", "n002", "n003"]),
    ("a[1-2,5],b7", ["a1", "a2", "a5", "b7"]),
    ("gpu[09-11]", ["gpu09", "gpu10", "gpu11"]),
    ("r[1-2]n[3]", ["r1n[3]", "r2n[3]"]),  # only the first bracket expands
    ("", []),
])
def test_expand_nodelist(spec, expect):
    assert slurm.expand_nodelist(spec) == expect
    assert slurm.expand_nodelist(spec) == jslurm.expand_nodelist(spec)


def fake_env(procid=1, ntasks=4, nodelist="gpu[1-2]", job="98765"):
    return {"SLURM_PROCID": str(procid), "SLURM_NTASKS": str(ntasks),
            "SLURM_JOB_NODELIST": nodelist, "SLURM_JOB_ID": job}


def test_from_env_derives_topology():
    coordinator, n, i = slurm.from_env(fake_env())
    host, port = coordinator.rsplit(":", 1)
    assert host == "gpu1"  # the first node hosts the coordinator
    assert n == 4 and i == 1
    assert 12800 <= int(port) < 12800 + 4096


def test_port_stable_per_job_distinct_across_jobs():
    a = slurm.job_port(fake_env(job="111"))
    b = slurm.job_port(fake_env(job="111"))
    c = slurm.job_port(fake_env(job="112"))
    assert a == b != c


def test_step_nodelist_preferred():
    env = {**fake_env(), "SLURM_STEP_NODELIST": "gpu2"}
    coordinator, _, _ = slurm.from_env(env)
    assert coordinator.startswith("gpu2:")


def test_maybe_slurm():
    assert slurm.maybe_slurm({}) is None
    assert slurm.maybe_slurm(fake_env(ntasks=1)) is None  # one task: local
    topo = slurm.maybe_slurm(fake_env(procid=3))
    assert topo == {"coordinator": topo["coordinator"],
                    "num_processes": 4, "process_id": 3}


def test_maybe_slurm_ignores_batch_step():
    """A script run directly in the sbatch batch script (no srun) is a
    1-task step even when the job asked for 4 tasks: it must not start a
    4-process world (it would wait for peers forever)."""
    env = {**fake_env(procid=0, ntasks=4), "SLURM_STEP_NUM_TASKS": "1"}
    assert slurm.maybe_slurm(env) is None
    env["SLURM_STEP_NUM_TASKS"] = "4"
    topo = slurm.maybe_slurm(env)
    assert topo is not None and topo["num_processes"] == 4


def test_sbatch_script_shape():
    text = slurm.sbatch_script(
        ["-m", "dtdl_tpu_torch.examples.distributed_data_parallel",
         "--batch-size", "256"], nodes=4, partition="gpu")
    assert text.startswith("#!/bin/bash")
    assert "#SBATCH --nodes=4" in text
    assert "#SBATCH --partition=gpu" in text
    assert "srun python -m dtdl_tpu_torch.launch.slurm -- -m " \
           "dtdl_tpu_torch.examples.distributed_data_parallel " \
           "--batch-size 256" in text


def test_emit_sbatch_cli(capsys):
    rc = slurm.main(["--emit-sbatch", "--nodes", "3", "--ntasks-per-node",
                     "8", "--", "train.py", "--lr", "0.1"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "#SBATCH --nodes=3" in out
    assert "#SBATCH --ntasks-per-node=8" in out
    assert "train.py --lr 0.1" in out


def test_sbatch_requeue_and_elastic_restart_flags():
    plain = slurm.sbatch_script(["t.py"])
    assert "--requeue" not in plain and "for attempt" not in plain
    text = slurm.sbatch_script(["t.py"], requeue=True, max_restarts=2)
    assert "#SBATCH --requeue" in text
    assert "#SBATCH --open-mode=append" in text
    # the restart loop wraps the same srun line, is bounded, and a job
    # that keeps failing still exits non-zero
    assert "for attempt in $(seq 0 2); do" in text
    assert "srun python -m dtdl_tpu_torch.launch.slurm -- t.py && exit 0" \
        in text
    assert text.rstrip().endswith("exit 1")


def test_emit_sbatch_cli_requeue_flags(capsys):
    rc = slurm.main(["--emit-sbatch", "--requeue", "--max-restarts",
                     "3", "--", "train.py"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "#SBATCH --requeue" in out
    assert "$(seq 0 3)" in out


def test_store_addr_from_env_matches_sbatch_arithmetic():
    env = fake_env(job="111")
    host, port = slurm.store_addr_from_env(env).rsplit(":", 1)
    assert host == "gpu1"
    assert int(port) == slurm.store_port(env)
    # the store band and the coordinator band are disjoint
    assert slurm.store_port(env) >= slurm._BASE_PORT + slurm._PORT_SPAN
    assert slurm.store_port(env) != slurm.job_port(fake_env(job="112"))


def test_sbatch_store_exports_addr_and_serves_wal_backed_store():
    plain = slurm.sbatch_script(["t.py"])
    assert "DTDL_STORE_ADDR" not in plain          # opt-in
    text = slurm.sbatch_script(["t.py"], store=True, max_restarts=1)
    assert 'export DTDL_STORE_ADDR="${head}:${store_port}"' in text
    assert "store_port=$((16896 + SLURM_JOB_ID % 4096))" in text
    assert "python -m dtdl_tpu_torch.parallel.tcpstore" in text
    assert "--wal-dir" in text
    assert "trap 'kill ${store_pid}" in text
    assert "grep -q 'STORE ready' store.log" in text
    assert text.index("STORE ready") < text.index("srun")
    # the store starts before the restart loop and spans its relaunches
    assert text.index("tcpstore") < text.index("for attempt")


def test_emit_sbatch_cli_store_flag(capsys):
    rc = slurm.main(["--emit-sbatch", "--store", "--", "train.py"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "DTDL_STORE_ADDR" in out
    assert "dtdl_tpu_torch.parallel.tcpstore" in out


# ---- parity with the JAX module --------------------------------------------

ENVS = [
    {},
    fake_env(),
    fake_env(procid=0, ntasks=1),
    fake_env(procid=7, ntasks=8, nodelist="n[001-004]", job="4242"),
    {**fake_env(procid=2), "SLURM_STEP_NUM_TASKS": "1"},
    {**fake_env(procid=2), "SLURM_STEP_NUM_TASKS": "4",
     "SLURM_STEP_NODELIST": "gpu[7-8]"},
    fake_env(job="job_5001"),
]


@pytest.mark.parametrize("env", ENVS, ids=range(len(ENVS)))
def test_env_functions_equal_jax(env):
    assert slurm.maybe_slurm(env) == jslurm.maybe_slurm(env)
    assert slurm.job_port(env) == jslurm.job_port(env)
    assert slurm.store_port(env) == jslurm.store_port(env)
    if "SLURM_PROCID" in env:
        assert slurm.from_env(env) == jslurm.from_env(env)
        assert slurm.store_addr_from_env(env) == \
            jslurm.store_addr_from_env(env)
    else:
        with pytest.raises(KeyError):
            slurm.from_env(env)


SBATCH = [
    dict(),
    dict(nodes=4, ntasks_per_node=8, partition="gpu", time_limit="02:00:00"),
    dict(requeue=True, max_restarts=2),
    dict(store=True, max_restarts=1, store_wal_dir="/scratch/wal"),
    dict(store=True, requeue=True, job_name="lm"),
]


@pytest.mark.parametrize("kw", SBATCH, ids=range(len(SBATCH)))
def test_sbatch_text_equals_jax_but_module_names(kw):
    args = ["train.py", "--lr", "0.1", "--name", "a b"]
    want = jslurm.sbatch_script(args, **kw)
    for mod in ("launch.slurm", "parallel.tcpstore"):
        want = want.replace(f"dtdl_tpu.{mod}", f"dtdl_tpu_torch.{mod}")
    assert slurm.sbatch_script(args, **kw) == want


def test_card_binding_block_vs_cyclic():
    """Block distribution, 4 tasks a node: rank % 4 is the local id, so
    ``process_id % device_count`` gives each task of a node its own card;
    a cyclic layout is refused, naming the distribution."""
    for procid in range(8):
        env = {**fake_env(procid=procid, ntasks=8),
               "SLURM_NTASKS_PER_NODE": "4", "SLURM_LOCALID": str(procid % 4)}
        assert slurm.card_binding_error(env) is None
    cyclic = {**fake_env(procid=2, ntasks=8), "SLURM_NTASKS_PER_NODE": "4",
              "SLURM_LOCALID": "1"}
    assert "--distribution=block" in slurm.card_binding_error(cyclic)
    assert slurm.card_binding_error(fake_env()) is None   # nothing to check


# ---- a world from SLURM's environment alone --------------------------------

def _free_job_id() -> int:
    """A job id whose coordinator port is free here."""
    for job in range(os.getpid() % 4096, os.getpid() % 4096 + 4096):
        port = slurm.job_port({"SLURM_JOB_ID": str(job)})
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        return job
    raise RuntimeError("no free coordinator port")


def _slurm_world(tmp_path, through_cli: bool) -> list:
    job = _free_job_id()
    out = str(tmp_path / "rank")
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                   SLURM_PROCID=str(rank), SLURM_NTASKS="2",
                   SLURM_JOB_NODELIST="localhost", SLURM_JOB_ID=str(job),
                   SLURM_NTASKS_PER_NODE="2", SLURM_LOCALID=str(rank))
        script = [os.path.abspath(__file__), "--out", out]
        cmd = ([sys.executable, "-m", "dtdl_tpu_torch.launch.slurm", "--",
                *script] if through_cli else [sys.executable, *script])
        procs.append(subprocess.Popen(cmd, cwd=REPO, env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    views = []
    for rank in range(2):
        with open(f"{out}.{rank}") as f:
            views.append(json.load(f))
    return views, slurm.job_port({"SLURM_JOB_ID": str(job)})


def test_cli_starts_a_gloo_world_from_slurm_env(tmp_path):
    views, port = _slurm_world(tmp_path, through_cli=True)
    for rank, v in enumerate(views):
        assert v == {"rank": rank, "world": 2, "sum": 3.0,
                     "flags": f"localhost:{port}"}


def test_bootstrap_joins_from_slurm_env_alone(tmp_path):
    views, _ = _slurm_world(tmp_path, through_cli=False)
    for rank, v in enumerate(views):
        # no --coordinator flag: maybe_slurm supplied the topology
        assert v == {"rank": rank, "world": 2, "sum": 3.0, "flags": ""}
