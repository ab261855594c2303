#!/usr/bin/env python
"""Elastic multi-process training over the TCP control-plane store, the
twin of examples/elastic_train.py.

Every worker holds a heartbeat lease in a TCP coordinator
(:mod:`dtdl_tpu_torch.parallel.tcpstore`) and exchanges its gradients
through it (numpy trees, summed in rank order); when a peer dies the
survivors see its lease expire, re-form a generation-fenced world,
restore the last committed snapshot and train on at the smaller world.
The coordinator itself recovers from a crash (WAL + snapshot), and an
amnesiac restart (no WAL) is refused by name through its epoch token.

Two ways to run it::

    # one command: an in-process coordinator, 4 worker threads, rank 3
    # crashed halfway
    python -m dtdl_tpu_torch.examples.elastic_train --demo

    # one coordinator (in the launcher) and one process per worker
    python -m dtdl_tpu_torch.launch.local --nproc 4 --serve-store -- \\
        -m dtdl_tpu_torch.examples.elastic_train --steps 20 \\
        --ckpt-dir /tmp/elastic

A worker process reaches the store through ``DTDL_STORE_ADDR`` (the
launcher sets it).  The model is the JAX script's MLP(32) over a seeded
512 x 32 dataset, every worker on the card unless ``--device cpu``.

For drills (the port's additions): ``--kill-rank R --kill-at N`` has
rank R's process killed by SIGKILL at the top of step N (launch with
``--elastic`` so the launcher lets the others run on), and ``--out-dir``
makes every worker flush the sample indices of each applied step to
``samples_<rank>.jsonl`` (they survive a SIGKILL) and write
``result_<rank>.json`` and its final parameters ``final_<rank>.pt``.
"""

import json
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from dtdl_tpu_torch.data.sharding import (GlobalBatchSampler,
                                          elastic_global_batch)
from dtdl_tpu_torch.device import resolve_device
from dtdl_tpu_torch.models import MLP
from dtdl_tpu_torch.parallel.kvstore import RetryingStore
from dtdl_tpu_torch.parallel.tcpstore import (TCPStoreClient, TCPStoreServer,
                                              connect, store_addr)
from dtdl_tpu_torch.resil import (ElasticConfig, ElasticWorker, FaultPlan,
                                  peer_site, run_workers)
from dtdl_tpu_torch.utils.config import flag, make_parser
from dtdl_tpu_torch.utils.random import seed_everything

N_EXAMPLES, DIM, LR = 512, 32, 0.1


def mlp_logits(params: dict, x: torch.Tensor) -> torch.Tensor:
    """The MLP's forward over a parameter dict (its ``named_parameters``
    names): functional, so worker threads share no module state."""
    h = F.relu(F.linear(x, params["fc1.weight"], params["fc1.bias"]))
    h = F.relu(F.linear(h, params["fc2.weight"], params["fc2.bias"]))
    return F.linear(h, params["fc3.weight"], params["fc3.bias"])


def make_problem(seed: int, device=None, params=None):
    """The functional triple an :class:`ElasticWorker` drives, plus its
    batch builder, over the seeded dataset every rank regenerates alike.
    ``params`` (a {name: tensor-like} dict) replaces the seeded weights.
    The state is ``{"params": {name: tensor}}``; ``apply_fn`` is
    ``sgd(0.1)`` on the mean gradient (the summed tree over the world's
    size), as optax applies it: ``p + (-lr) * (g / n)``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N_EXAMPLES, DIM)).astype(np.float32)
    y = rng.integers(0, 10, N_EXAMPLES)
    model = MLP(n_units=32, in_features=DIM, device=dev, seed=seed)
    p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    if params is not None:
        p0 = {k: torch.as_tensor(np.asarray(params[k]), dtype=torch.float32,
                                 device=dev).clone() for k in p0}
    state0 = {"params": p0}
    x_dev = torch.from_numpy(x).to(dev)
    y_dev = torch.from_numpy(y).to(dev)

    def grad_fn(state, batch):
        p = {k: v.detach().requires_grad_() for k, v in
             state["params"].items()}
        loss = F.cross_entropy(mlp_logits(p, batch["x"]), batch["y"])
        return dict(zip(p, torch.autograd.grad(loss, list(p.values()))))

    def apply_fn(state, grads, n):
        return {"params": {
            k: v + (-LR) * (torch.from_numpy(np.asarray(grads[k])).to(dev)
                            / float(n))
            for k, v in state["params"].items()}}

    def batch_fn(idx):
        idx = torch.from_numpy(np.asarray(idx)).to(dev)
        return {"x": x_dev[idx], "y": y_dev[idx]}

    problem = dict(init_fn=lambda: state0, grad_fn=grad_fn,
                   apply_fn=apply_fn, batch_fn=batch_fn)
    # warm the step before any watchdog is armed: a first call's set-up
    # inside the deadline reads as a wedged peer
    g = grad_fn(state0, batch_fn(np.arange(4)))
    apply_fn(state0, {k: v.cpu().numpy() for k, v in g.items()}, 2)
    return problem


def mk_worker(store, rank, args, problem, cls=None, **extra):
    cfg = ElasticConfig(heartbeat_s=args.heartbeat_s,
                        watchdog_s=args.watchdog_s,
                        step_timeout_s=args.step_timeout_s,
                        join_grace_s=args.join_grace_s,
                        snapshot_every=args.snapshot_every)
    sampler = GlobalBatchSampler(
        N_EXAMPLES, elastic_global_batch(args.workers,
                                         per_worker=args.batch_size),
        seed=args.seed)
    return (cls or ElasticWorker)(store, rank, sampler=sampler,
                                  total_steps=args.steps, cfg=cfg,
                                  ckpt_dir=args.ckpt_dir or None,
                                  **problem, **extra)


def params_digest(w) -> float:
    """The JAX script's digest: the sum of |first leaf| (fc1's weight)."""
    first = next(iter(w.state["params"].values()))
    return float(first.abs().double().sum())


def report(w):
    if w.world is None:
        print(f"[rank {w.rank}] joined no world: {w.error!r}", flush=True)
        return
    print(f"[rank {w.rank}] done={w.done} world=gen{w.world.generation}"
          f"/{list(w.world.ranks)} steps={w.step} "
          f"params_digest={params_digest(w):.6f}", flush=True)


def await_launch(store, rank: int, n: int, timeout_s: float) -> None:
    """Meet the launch's other ``n - 1`` workers through the store before
    the first rendezvous: processes start staggered by their imports and
    set-up, and a bootstrap world closes ``join_grace_s`` after its last
    joiner, so a slow starter would be fenced out of its own launch."""
    store.set(f"launch/ready/{rank}", 1)
    deadline = time.monotonic() + timeout_s
    for r in range(n):
        store.wait(f"launch/ready/{r}",
                   timeout_s=max(0.1, deadline - time.monotonic()))


def run_demo(args):
    """The whole machine in one process: a TCP coordinator, thread-hosted
    workers, and an injected crash of the last rank halfway."""
    server = TCPStoreServer(wal_dir=os.path.join(args.ckpt_dir, "wal")
                            if args.ckpt_dir else None).start()
    print(f"coordinator up at {server.addr} "
          f"(epoch {server.epoch[:8]}...)", flush=True)
    problem = make_problem(args.seed, args.device or None)
    workers = [
        mk_worker(RetryingStore(TCPStoreClient(server.addr), seed=r),
                  r, args, problem)
        for r in range(args.workers)]
    victim = args.workers - 1
    plan = FaultPlan().at(peer_site(victim, "step"),
                          max(1, args.steps // 2), "crash")
    try:
        with plan:
            run_workers(workers, timeout_s=300)
    finally:
        server.stop()
    survivors = [w for w in workers if w.rank != victim]
    dead = workers[victim]
    detect = min(t for w in survivors
                 for n, t, _ in w.events if n == "peer_lost") \
        - dead.stopped_t
    print(f"rank {victim} crashed at step {args.steps // 2}; survivors "
          f"detected in {detect:.3f}s (watchdog {args.watchdog_s}s), "
          f"re-formed, finished:", flush=True)
    for w in survivors:
        report(w)
    return workers


class JournalingWorker(ElasticWorker):
    """An ElasticWorker that flushes each applied step's consumed sample
    indices to a JSONL file: unlike the in-memory ``sample_log``, they
    survive the process being killed."""

    def __init__(self, *args, journal_path, **kwargs):
        super().__init__(*args, audit_samples=True, **kwargs)
        self._journal = open(journal_path, "a")

    def _mark(self, name, **info):
        super()._mark(name, **info)
        if name == "applied":
            gen, step = info["generation"], info["step"]
            self._journal.write(json.dumps(
                {"gen": int(gen), "step": int(step),
                 "idx": np.asarray(self.sample_log[(gen, step)]).tolist()})
                + "\n")
            self._journal.flush()


def write_result(w, store, out_dir):
    """``result_<rank>.json`` (how the worker ended) and its final
    parameters, ``final_<rank>.pt``."""
    restores = [info for n, _, info in w.events if n == "restore"]
    lost = [info for n, _, info in w.events if n == "peer_lost"]
    client = getattr(store, "store", store)
    result = {
        "rank": w.rank, "done": w.done, "fenced": w.fenced,
        "error": repr(w.error) if w.error is not None else None,
        "generation": w.world.generation if w.world else None,
        "ranks": list(w.world.ranks) if w.world else None,
        "step": w.step,
        "restored_step": restores[0]["step"] if restores else None,
        "lost": sorted(int(r) for info in lost
                       for r in info.get("lost", ())),
        "reconnects": client.metrics.summary().get("store_reconnects", 0)
        if hasattr(client, "metrics") else 0,
        "events": [(n, round(t, 6)) for n, t, _ in w.events],
    }
    if w.state is not None:
        torch.save({k: v.cpu() for k, v in w.state["params"].items()},
                   os.path.join(out_dir, f"final_{w.rank}.pt"))
    path = os.path.join(out_dir, f"result_{w.rank}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(result, f)
    os.replace(path + ".tmp", path)


def run_worker(args):
    """One worker process: connect to the store the launcher serves
    (``DTDL_STORE_ADDR``), join the world, train elastically."""
    addr = args.store_addr or store_addr()
    if not addr:
        raise SystemExit("no store: pass --store-addr, set "
                         "DTDL_STORE_ADDR, or launch via "
                         "`-m dtdl_tpu_torch.launch.local --serve-store`")
    rank = args.process_id
    if args.kill_at >= 0 and rank == args.kill_rank:
        FaultPlan().at(peer_site(rank, "step"), args.kill_at,
                       "sigkill").install()
    # transport budgets that ride a coordinator restart (a fresh
    # interpreter importing torch: seconds) without surfacing a
    # transient: the generation reads are never retried above the
    # client, so one reconnect budget (~20 s) must outlast the outage,
    # and its backoff stays short, so that the first beat after the
    # restart lands well inside the lease the recovery re-stamped
    store = connect(addr, retries=10, seed=rank, connect_timeout_s=2.0,
                    io_timeout_s=5.0, reconnect_attempts=100,
                    backoff_s=0.01, max_backoff_s=0.2, wait_slice_s=0.1,
                    rpc_retries=4)
    problem = make_problem(args.seed, args.device or None)
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        w = mk_worker(store, rank, args, problem, JournalingWorker,
                      journal_path=os.path.join(args.out_dir,
                                                f"samples_{rank}.jsonl"))
    else:
        w = mk_worker(store, rank, args, problem)
    if args.num_processes > 1:
        await_launch(store, rank, args.num_processes, timeout_s=120.0)
    w.run()
    report(w)
    if args.out_dir:
        write_result(w, store, args.out_dir)
    if w.error is not None:
        raise SystemExit(f"worker {rank} failed: {w.error!r}")
    return w


def main(argv=None):
    p = make_parser("Elastic training over the TCP control-plane store")
    flag(p, "--demo", action="store_true",
         help="single-command rehearsal: in-process coordinator, "
              "thread workers, one injected crash")
    flag(p, "--workers", type=int, default=4,
         help="world size (demo threads, or the launched nproc)")
    flag(p, "--steps", type=int, default=12)
    flag(p, "--batch-size", type=int, default=8,
         help="per-worker batch at full world (global batch is "
              "elastic_global_batch(workers, per_worker))")
    flag(p, "--ckpt-dir", default="",
         help="commit snapshots here (restores after a shrink)")
    flag(p, "--store-addr", default="",
         help="host:port of a running coordinator (default: "
              "$DTDL_STORE_ADDR)")
    flag(p, "--heartbeat-s", type=float, default=0.05)
    flag(p, "--watchdog-s", type=float, default=0.5)
    flag(p, "--step-timeout-s", type=float, default=30.0)
    flag(p, "--join-grace-s", type=float, default=0.5)
    flag(p, "--snapshot-every", type=int, default=2)
    flag(p, "--seed", type=int, default=0)
    flag(p, "--coordinator", default="")      # launcher-appended topology
    flag(p, "--num-processes", type=int, default=1)
    flag(p, "--process-id", type=int, default=0)
    flag(p, "--device", "--platform", default="",
         help="'cpu' runs on the CPU; the default is the CUDA card")
    flag(p, "--fake-devices", type=int, default=0)
    flag(p, "--kill-rank", type=int, default=-1,
         help="the rank whose process is SIGKILLed at --kill-at")
    flag(p, "--kill-at", type=int, default=-1,
         help="the step at whose top --kill-rank is SIGKILLed")
    flag(p, "--out-dir", default="",
         help="per-step sample journals, results and final parameters")
    args = p.parse_args(argv)
    if args.device not in ("", "cpu", "cuda", "gpu"):
        raise SystemExit(f"--device {args.device!r}: the port runs on the "
                         f"card (default) or the CPU ('cpu')")
    args.device = "cpu" if args.device == "cpu" else ""
    if args.fake_devices > 1:
        raise SystemExit("--fake-devices: a port process drives one device; "
                         "run more workers instead (--workers, or the "
                         "launcher's --nproc)")
    seed_everything(args.seed)
    if args.ckpt_dir:
        os.makedirs(args.ckpt_dir, exist_ok=True)
    if args.demo:
        return run_demo(args)
    if args.num_processes > 1:
        # the launched world IS the world: every rank sizes the sampler
        # from the launcher's nproc, not a stale --workers default
        args.workers = args.num_processes
    return run_worker(args)


if __name__ == "__main__":
    main()
