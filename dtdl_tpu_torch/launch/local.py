"""Local multi-process launcher, the port of dtdl_tpu/launch/local.py.

Spawns N processes of a training script (or ``-m module``) on this
host, each told the shared rendezvous address and its process id, with
rank-prefixed log streaming and fail-fast on a dead rank: the role of
``torch.multiprocessing.spawn`` and of the reference's one-shell-per-rank
procedure.

CLI::

    python -m dtdl_tpu_torch.launch.local --nproc 2 [--port 12355] \\
        [--devices-per-proc K] [--max-restarts R] [--timeout S] \\
        [--n-hosts H --host-index h --coordinator HOST:PORT] \\
        -- script.py --flags          (or: -- -m package.module --flags)

Each child gets ``--coordinator 127.0.0.1:PORT --num-processes N
--process-id i`` appended to its argv (the script hands them to
:func:`dtdl_tpu_torch.runtime.initialize`, which binds process i to card
``i % device_count``).

One host's share of a multi-host world (what
:mod:`dtdl_tpu_torch.launch.hosts` starts on every host):
``--n-hosts H --host-index h --coordinator HOST:PORT`` makes the world
``H·N`` processes, with this host's child i process ``h·N + i``, all
meeting at host 0's ``HOST:PORT``.  Without them a run is one host's, as
before.  ``devices_per_proc=K`` gives rank i the cards
``[i·K, (i+1)·K)`` through ``CUDA_VISIBLE_DEVICES``; a child that runs on
the CPU (``--platform cpu``) uses no card, and the stripe changes
nothing for it.  A child's ``OMP_NUM_THREADS`` defaults to this host's
cores divided by N.

The elastic control-plane store: ``--serve-store`` hosts a
:class:`~dtdl_tpu_torch.parallel.tcpstore.TCPStoreServer` in the
launcher process (which outlives any worker and spans restart attempts,
as a coordinator does; ``--store-wal-dir`` gives it a WAL for crash
recovery) and gives every child its address as ``DTDL_STORE_ADDR``
(``127.0.0.1:<store port>``, the rendezvous port + 1 by default), so a
worker reaches it with :func:`dtdl_tpu_torch.parallel.tcpstore.connect`.
``--store-port`` alone exports the address of a store the operator runs;
without either, a child sees only the variable it inherits.
``--elastic`` keeps the world running when a rank is lost to a signal
(an elastic world shrinks to its survivors through the store instead):
the launch then succeeds when every rank exited 0 or was killed, and at
least one exited 0; a rank's own non-zero exit still fails it.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time


def launch_local(script_args: list[str], nproc: int = 2, port: int = 12355,
                 env_extra: dict | None = None, timeout: float = 600.0,
                 devices_per_proc: int | None = None,
                 max_restarts: int = 0, store_port: int | None = None,
                 serve_store: bool = False,
                 store_wal_dir: str | None = None,
                 elastic: bool = False, n_hosts: int = 1,
                 host_index: int = 0, coordinator: str | None = None
                 ) -> int:
    """Spawn ``nproc`` processes of a script; non-zero if any rank failed.

    If any process dies — non-zero exit *or* a signal — the rest are
    terminated and the dying rank's code is returned; a world that
    outlives ``timeout`` seconds is killed and 124 returned.
    ``max_restarts`` relaunches the WHOLE world after a failed attempt
    (ranks resume from their own checkpoints), the checkpoint-restart
    model of synchronous data parallelism.

    ``serve_store=True`` serves the control-plane store here (WAL in
    ``store_wal_dir``) on ``store_port`` (default ``port + 1``) and
    exports ``DTDL_STORE_ADDR`` to the children; an explicit
    ``store_port`` alone exports the address without serving.  An
    address is never advertised unless a store is meant to listen
    there.  ``elastic=True``: a rank killed by a signal does not stop the
    others (module docstring).

    ``n_hosts``, ``host_index`` and ``coordinator`` (``HOST:PORT``, host
    0's) start this host's ``nproc`` ranks of an ``n_hosts·nproc`` world
    (module docstring); the store's address then names the coordinator's
    host.
    """
    if store_wal_dir is not None and not serve_store:
        raise ValueError("store_wal_dir is the served store's WAL: pass "
                         "serve_store=True with it")
    if not 0 <= host_index < n_hosts:
        raise ValueError(f"host_index {host_index} is not one of the "
                         f"{n_hosts} hosts")
    if n_hosts > 1 and not coordinator:
        raise ValueError("a multi-host world needs the coordinator's "
                         "address (HOST:PORT of host 0)")
    world = (n_hosts, host_index, coordinator or f"127.0.0.1:{port}")
    explicit = store_port is not None or serve_store
    store_port = store_port if store_port is not None else port + 1
    store_host = world[2].rsplit(":", 1)[0]
    store_addr = f"{store_host}:{store_port}" if explicit else None
    server = None
    if serve_store:
        from dtdl_tpu_torch.parallel.tcpstore import TCPStoreServer
        server = TCPStoreServer(port=store_port,
                                wal_dir=store_wal_dir).start()
        print(f"[launcher] store at {server.addr} (epoch "
              f"{server.epoch[:8]}, recovered={server.recovered})",
              flush=True)
    try:
        attempt = 0
        while True:
            rc = _launch_once(script_args, nproc, world, env_extra,
                              timeout, devices_per_proc, store_addr, elastic)
            if rc == 0 or attempt >= max_restarts:
                return rc
            attempt += 1
            print(f"[launcher] attempt {attempt}/{max_restarts}: "
                  f"relaunching all {nproc} ranks (resume from latest "
                  f"checkpoint)", flush=True)
    finally:
        if server is not None:
            server.stop()


def _stop(procs, grace: float = 10.0) -> None:
    """SIGTERM every live process, SIGKILL whatever outlives ``grace``."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.time() + grace
    for p in procs:
        try:
            p.wait(max(0.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            p.kill()


def _launch_once(script_args: list[str], nproc: int, world: tuple,
                 env_extra: dict | None, timeout: float,
                 devices_per_proc: int | None,
                 store_addr: str | None = None,
                 elastic: bool = False) -> int:
    """One attempt; ``world`` is ``(n_hosts, host_index, coordinator)``."""
    procs: list[subprocess.Popen] = []
    n_hosts, host_index, coordinator = world
    first = host_index * nproc          # this host's first global rank
    for i in range(nproc):
        env = dict(os.environ)
        if store_addr:
            env["DTDL_STORE_ADDR"] = store_addr
        if env_extra:
            env.update(env_extra)
        # each rank's intra-op threads get a share of the cores: N ranks
        # of full-width thread pools spin against each other at every
        # collective (60x slower CPU steps measured for 2 ranks on 8 cores)
        env.setdefault("OMP_NUM_THREADS",
                       str(max(1, len(os.sched_getaffinity(0)) // nproc)))
        if devices_per_proc is not None:
            env["CUDA_VISIBLE_DEVICES"] = ",".join(
                str(d) for d in range(i * devices_per_proc,
                                      (i + 1) * devices_per_proc))
        cmd = [sys.executable, *script_args,
               "--coordinator", coordinator,
               "--num-processes", str(n_hosts * nproc),
               "--process-id", str(first + i)]
        procs.append(subprocess.Popen(
            cmd, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, bufsize=1))

    def pump(i: int, p: subprocess.Popen):
        for line in p.stdout:  # blocking per-thread read; no buffer stalls
            print(f"[rank {first + i}] {line}", end="", flush=True)

    threads = [threading.Thread(target=pump, args=(i, p), daemon=True)
               for i, p in enumerate(procs)]
    for t in threads:
        t.start()

    deadline = time.time() + timeout
    first_failure = 0
    lost: set = set()
    try:
        while any(p.poll() is None for p in procs):
            if time.time() > deadline:
                print(f"[launcher] timeout after {timeout}s; killing",
                      flush=True)
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                first_failure = first_failure or 124
                break
            for i, p in enumerate(procs):
                rc = p.poll()
                if elastic and rc is not None and rc < 0:
                    if i not in lost:
                        lost.add(i)
                        print(f"[launcher] rank {first + i} lost to "
                              f"signal {-rc}; the others run on (elastic)",
                              flush=True)
                    continue
                if rc is not None and rc != 0 and not first_failure:
                    first_failure = rc
                    print(f"[launcher] rank {first + i} exited with "
                          f"{rc}; terminating remaining ranks", flush=True)
                    _stop(procs)
            time.sleep(0.1)
    finally:
        _stop(procs)        # nothing outlives the launcher
    rcs = [p.wait() for p in procs]
    for t in threads:
        t.join(timeout=5)
    if first_failure:
        return first_failure
    if elastic and any(rc == 0 for rc in rcs):
        return next((rc for rc in rcs if rc > 0), 0)
    return next((rc for rc in rcs if rc != 0), 0)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    nproc, port, devices, restarts, timeout = 2, 12355, None, 0, 600.0
    store_port, serve_store, store_wal, elastic = None, False, None, False
    n_hosts, host_index, coordinator = 1, 0, None
    while argv and argv[0] != "--":
        if argv[0] == "--nproc":
            nproc = int(argv[1]); argv = argv[2:]
        elif argv[0] == "--port":
            port = int(argv[1]); argv = argv[2:]
        elif argv[0] == "--devices-per-proc":
            devices = int(argv[1]); argv = argv[2:]
        elif argv[0] == "--max-restarts":
            restarts = int(argv[1]); argv = argv[2:]
        elif argv[0] == "--timeout":
            timeout = float(argv[1]); argv = argv[2:]
        elif argv[0] == "--store-port":
            store_port = int(argv[1]); argv = argv[2:]
        elif argv[0] == "--serve-store":
            serve_store = True; argv = argv[1:]
        elif argv[0] == "--store-wal-dir":
            store_wal = argv[1]; argv = argv[2:]
        elif argv[0] == "--elastic":
            elastic = True; argv = argv[1:]
        elif argv[0] == "--n-hosts":
            n_hosts = int(argv[1]); argv = argv[2:]
        elif argv[0] == "--host-index":
            host_index = int(argv[1]); argv = argv[2:]
        elif argv[0] == "--coordinator":
            coordinator = argv[1]; argv = argv[2:]
        else:
            raise SystemExit(f"unknown launcher flag {argv[0]} "
                             "(use: --nproc N --port P -- script.py ...)")
    if argv and argv[0] == "--":
        argv = argv[1:]
    if not argv:
        raise SystemExit("no script given; usage: python -m "
                         "dtdl_tpu_torch.launch.local --nproc 2 -- script.py")
    return launch_local(argv, nproc=nproc, port=port, timeout=timeout,
                        devices_per_proc=devices, max_restarts=restarts,
                        store_port=store_port, serve_store=serve_store,
                        store_wal_dir=store_wal, elastic=elastic,
                        n_hosts=n_hosts, host_index=host_index,
                        coordinator=coordinator)


if __name__ == "__main__":
    raise SystemExit(main())
