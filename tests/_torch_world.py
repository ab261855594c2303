"""Gloo worlds of port processes for the CPU parity tests of the 4D path.

A test module runs itself as ``__main__`` for the worker: the pytest
process writes the cases (numpy inputs) to ``in.pkl`` and starts the
world in the background through the port's launcher
(:class:`World`), computes the JAX oracle meanwhile, then reads each
rank's ``out_<rank>.pkl``.  The pytest process never joins a process
group.  :func:`serve` is the worker's side (it imports no JAX):
``initialize`` on the CPU, the mesh, one call of the module's case
function per case, the results and this rank's mesh coordinates
written back.
"""

from __future__ import annotations

import argparse
import os
import pickle
import socket
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class World:
    """``n`` processes of ``script`` (with ``--world-io DIR --world-mesh
    SHAPE --world-device D``) over the launcher, started at construction:
    on the CPU over gloo, or (``device="cuda"``) one card a rank over
    NCCL."""

    def __init__(self, script: str, shape, cases: dict, io_dir,
                 timeout: float = 300.0, device: str = "cpu"):
        self.n = int(np.prod(shape))
        self.io = str(io_dir)
        self.timeout = timeout
        os.makedirs(self.io, exist_ok=True)
        with open(os.path.join(self.io, "in.pkl"), "wb") as f:
            pickle.dump(cases, f)
        self.log = open(os.path.join(self.io, "world.log"), "w")
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "dtdl_tpu_torch.launch.local",
             "--nproc", str(self.n), "--port", str(free_port()),
             "--timeout", str(timeout), "--", script,
             "--world-io", self.io,
             "--world-mesh", ",".join(str(s) for s in shape),
             "--world-device", device],
            cwd=REPO, env=env, stdout=self.log, stderr=subprocess.STDOUT)
        self._outs = None

    def results(self) -> list:
        """Every rank's output, in rank order (waits for the world)."""
        if self._outs is None:
            try:
                rc = self.proc.wait(self.timeout + 30)
            finally:
                self.log.close()
            if rc != 0:
                with open(os.path.join(self.io, "world.log")) as f:
                    tail = f.read()[-6000:]
                raise AssertionError(f"the gloo world exited {rc}:\n{tail}")
            self._outs = []
            for r in range(self.n):
                with open(os.path.join(self.io, f"out_{r}.pkl"), "rb") as f:
                    self._outs.append(pickle.load(f))
        return self._outs


def assemble(outs, get, spec, shape) -> np.ndarray:
    """The global array whose blocks the ranks hold: ``get(out)`` is a
    rank's local block, ``spec`` the mesh axis of each dim (``None``:
    whole), ``shape`` the global shape.  Ranks holding the same block
    must agree on it exactly."""
    g = np.full(shape, np.nan, np.float64)
    for out in outs:
        loc = np.asarray(get(out), np.float64)
        idx = []
        for d in range(len(shape)):
            axis = spec[d] if d < len(spec) else None
            if axis is None:
                idx.append(slice(None))
            else:
                per = loc.shape[d]
                c = out["coords"][axis]
                idx.append(slice(c * per, (c + 1) * per))
        prev = g[tuple(idx)]
        seen = ~np.isnan(prev)
        if seen.any() and not np.array_equal(prev[seen], loc[seen]):
            raise AssertionError("replicas of one block differ")
        g[tuple(idx)] = loc
    assert not np.isnan(g).any(), "a block of the global array is missing"
    return g


def serve(run_case, axes) -> int:
    """The worker: one rank of the world, running every case of
    ``in.pkl`` through ``run_case(mesh, name, case)``."""
    import torch

    sys.path.insert(0, REPO)
    from dtdl_tpu_torch.runtime import build_mesh, initialize, process_index

    ap = argparse.ArgumentParser()
    for name, kind in (("--world-io", str), ("--world-mesh", str),
                       ("--world-device", str), ("--coordinator", str),
                       ("--num-processes", int), ("--process-id", int)):
        ap.add_argument(name, type=kind)
    a = ap.parse_args()
    torch.set_num_threads(1)
    initialize(a.coordinator, a.num_processes, a.process_id,
               device="cpu" if a.world_device == "cpu" else None)
    mesh = build_mesh(tuple(int(s) for s in a.world_mesh.split(",")), axes)
    with open(os.path.join(a.world_io, "in.pkl"), "rb") as f:
        cases = pickle.load(f)
    out = {"coords": mesh.coords(), "cases": {}}
    for name, case in cases.items():
        t0 = time.perf_counter()
        out["cases"][name] = run_case(mesh, name, case)
        out["cases"][name]["seconds"] = time.perf_counter() - t0
    path = os.path.join(a.world_io, f"out_{process_index()}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(out, f)
    os.replace(path + ".tmp", path)
    return 0


def leave(code: int) -> None:
    """End a world's rank without the gloo teardown (ROADMAP C10: its
    sockets closing while a peer's gloo threads still read them aborted
    a rank at interpreter exit, about one world in ten under load, every
    result already on disk).  The ranks meet on the rendezvous store,
    which no gloo socket serves: all arrive, the others leave, and
    process 0, which hosts the store, leaves last."""
    import torch.distributed as dist
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
    os._exit(code)


def run_megatron_case(mesh, name, case):
    """One 4D case on this rank (``case``: ``cfg`` kwargs without the
    dtype, the global numpy ``params``, global host ``batches``, ``opt``
    'sgd' or 'adamw' at ``lr``, or ``eval``): the losses and metrics of
    each step and the final local parameter shards, or the eval metrics
    of the first batch."""
    import torch

    from dtdl_tpu_torch.parallel import megatron as TM
    from dtdl_tpu_torch.train.optim import adamw, sgd

    cfg = TM.MegatronConfig(**case["cfg"], dtype=torch.float32)
    params = TM.place_params(mesh, cfg, case["params"], device="cpu")
    batches = [TM.shard_lm_batch(mesh, b, device="cpu")
               for b in case["batches"]]
    if case.get("eval"):
        b = batches[0]
        got = TM.make_megatron_eval_step(cfg, mesh)(
            params, b["tokens"], b["targets"], b["mask"])
        return {"eval": {k: float(v) for k, v in got.items()}}
    tx = sgd(case["lr"]) if case["opt"] == "sgd" else adamw(case["lr"])
    opt = TM.init_optimizer(cfg, mesh, tx, params)
    step = TM.make_megatron_train_step(cfg, mesh, tx)
    losses, metrics = [], []
    for b in batches:
        params, opt, loss, m = step(params, opt, b["tokens"], b["targets"],
                                    b["mask"])
        losses.append(float(loss))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"losses": losses, "metrics": metrics,
            "params": {p: a.detach().numpy() for p, a in TM._leaves(params)}}
