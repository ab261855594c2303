"""``caffe_train --gpu n`` below the world, on the CPU.

The JAX script trains data parallel over the first n chips
(``examples/caffe_train.py``); the port's twin trains over the first n
processes of its world (a ``sub_mesh``), and the processes outside it sit
the run out.  The Solver's snapshots meet at barriers of the sub-mesh's
processes only, so a process outside it leaves once the sub-mesh's groups
are made.

A gloo world of two runs ``caffe_train --gpu 1`` (this file is each
rank's ``__main__``, started through the port's launcher): LeNet for
:data:`ITERS` iterations, then ``--snapshot latest`` to
:data:`RESUMED`.  Rank 1 sits both runs out; rank 0's parameters after
each run are bitwise those of the same two runs in a world of one (in
the pytest process, which joins no process group), and so is its
snapshot's iteration.  The ranks leave as the tenancy world's do: they
meet on the rendezvous store, then ``os._exit``, process 0 last (ROADMAP
C10).
"""

import os
import pickle
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOLVER = os.path.join(REPO, "examples", "caffe", "lenet_solver.prototxt")
ITERS, RESUMED = 6, 10


def _argv(data: str, out: str, extra) -> list:
    return ["--platform", "cpu", "--solver", SOLVER, "--dataset-dir", data,
            "--out", out, "--gpu", "1", *extra]


RUNS = (("trained", ["--max-iter", str(ITERS)]),
        ("resumed", ["--max-iter", str(RESUMED), "--snapshot", "latest"]))


def _params(solver) -> dict:
    from dtdl_tpu_torch.bridge import flatten
    from dtdl_tpu_torch.train.state import params_tree
    return {"iteration": solver.iteration,
            "params": {k: v.cpu().numpy().copy() for k, v in
                       flatten(params_tree(solver.net)).items()}}


def _main() -> None:
    import argparse

    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist

    from dtdl_tpu_torch.examples import caffe_train
    ap = argparse.ArgumentParser()
    for name, kind in (("--io", str), ("--coordinator", str),
                       ("--num-processes", str), ("--process-id", str)):
        ap.add_argument(name, type=kind)
    a = ap.parse_args()
    torch.set_num_threads(1)
    topo = ["--coordinator", a.coordinator, "--num-processes",
            a.num_processes, "--process-id", a.process_id]
    out = {}
    for name, extra in RUNS:
        solver = caffe_train.main(
            _argv(os.path.join(a.io, "data"), os.path.join(a.io, "world"),
                  [*extra, *topo]))
        out[name] = None if solver is None else _params(solver)
    path = os.path.join(a.io, f"out_{dist.get_rank()}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(out, f)
    os.replace(path + ".tmp", path)
    store = dist.distributed_c10d._get_default_store()
    n, me = dist.get_world_size(), dist.get_rank()
    store.add("arrived", 1)
    while int(store.add("arrived", 0)) < n:
        time.sleep(0.01)
    if me:
        store.add("left", 1)
    else:
        while int(store.add("left", 0)) < n - 1:
            time.sleep(0.01)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


if __name__ == "__main__":
    _main()

# ---- the pytest side ---------------------------------------------------------

import subprocess  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from _torch_world import free_port  # noqa: E402
from dtdl_tpu_torch.data.synthetic import synthetic_mnist  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(rank outputs of the world of two, the world of one's outputs, the
    world's log)."""
    io = tmp_path_factory.mktemp("caffe_submesh")
    (train, test) = synthetic_mnist(n_train=512, n_test=256)
    os.makedirs(io / "data" / "mnist")
    np.savez(io / "data" / "mnist" / "mnist.npz", x_train=train[0],
             y_train=train[1], x_test=test[0], y_test=test[1])
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1",
           "DTDL_OFFLINE": "1"}
    with open(io / "world.log", "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "dtdl_tpu_torch.launch.local", "--nproc",
             "2", "--port", str(free_port()), "--timeout", "240", "--",
             os.path.abspath(__file__), "--io", str(io)],
            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)
        from dtdl_tpu_torch.examples import caffe_train
        one = {name: _params(caffe_train.main(_argv(
            str(io / "data"), str(io / "one"), extra)))
            for name, extra in RUNS}
        rc = proc.wait(300)
    text = (io / "world.log").read_text()
    assert rc == 0, text[-6000:]
    ranks = []
    for r in range(2):
        with open(io / f"out_{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks, one, text, io


def test_rank_outside_the_sub_mesh_sits_out(runs):
    ranks, _, text, io = runs
    assert ranks[1] == {"trained": None, "resumed": None}
    assert text.count("process 1 sits out: --gpu 1 trains over the first "
                      "1 of 2") == 2
    assert set(os.listdir(io / "world")) == {
        f"snapshot_{ITERS}", f"snapshot_{RESUMED}"}


@pytest.mark.parametrize("run", [name for name, _ in RUNS])
def test_rank0_is_bitwise_a_world_of_one(runs, run):
    """After ITERS iterations, and after ``--snapshot latest`` to
    RESUMED: the same iteration and every parameter bitwise."""
    ranks, one, _, _ = runs
    got, want = ranks[0][run], one[run]
    assert got["iteration"] == want["iteration"] == dict(
        trained=ITERS, resumed=RESUMED)[run]
    assert got["params"].keys() == want["params"].keys()
    for k, w in want["params"].items():
        np.testing.assert_array_equal(got["params"][k], w, err_msg=k)
