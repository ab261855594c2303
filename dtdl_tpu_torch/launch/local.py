"""Local multi-process launcher, the port of dtdl_tpu/launch/local.py.

Spawns N processes of a training script (or ``-m module``) on this
host, each told the shared rendezvous address and its process id, with
rank-prefixed log streaming and fail-fast on a dead rank: the role of
``torch.multiprocessing.spawn`` and of the reference's one-shell-per-rank
procedure.

CLI::

    python -m dtdl_tpu_torch.launch.local --nproc 2 [--port 12355] \\
        [--devices-per-proc K] [--max-restarts R] [--timeout S] \\
        -- script.py --flags          (or: -- -m package.module --flags)

Each child gets ``--coordinator 127.0.0.1:PORT --num-processes N
--process-id i`` appended to its argv (the script hands them to
:func:`dtdl_tpu_torch.runtime.initialize`, which binds process i to card
``i % device_count``).  ``devices_per_proc=K`` gives rank i the cards
``[i·K, (i+1)·K)`` through ``CUDA_VISIBLE_DEVICES``; a child that runs on
the CPU (``--platform cpu``) uses no card, and the stripe changes
nothing for it.  A child's ``OMP_NUM_THREADS`` defaults to this host's
cores divided by N.  The elastic control-plane store (``serve_store``,
``store_port``) is ROADMAP queue A13b.
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
                 store_wal_dir: str | None = None) -> int:
    """Spawn ``nproc`` processes of a script; non-zero if any rank failed.

    If any process dies — non-zero exit *or* a signal — the rest are
    terminated and the dying rank's code is returned; a world that
    outlives ``timeout`` seconds is killed and 124 returned.
    ``max_restarts`` relaunches the WHOLE world after a failed attempt
    (ranks resume from their own checkpoints), the checkpoint-restart
    model of synchronous data parallelism.
    """
    if serve_store or store_port is not None or store_wal_dir is not None:
        raise NotImplementedError(
            "the elastic control-plane store (serve_store, store_port, "
            "store_wal_dir) is ROADMAP queue A13b (resilience)")
    attempt = 0
    while True:
        rc = _launch_once(script_args, nproc, port, env_extra, timeout,
                          devices_per_proc)
        if rc == 0 or attempt >= max_restarts:
            return rc
        attempt += 1
        print(f"[launcher] attempt {attempt}/{max_restarts}: relaunching "
              f"all {nproc} ranks (resume from latest checkpoint)",
              flush=True)


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


def _launch_once(script_args: list[str], nproc: int, port: int,
                 env_extra: dict | None, timeout: float,
                 devices_per_proc: int | None) -> int:
    procs: list[subprocess.Popen] = []
    coordinator = f"127.0.0.1:{port}"
    for i in range(nproc):
        env = dict(os.environ)
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
               "--num-processes", str(nproc),
               "--process-id", str(i)]
        procs.append(subprocess.Popen(
            cmd, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, bufsize=1))

    def pump(i: int, p: subprocess.Popen):
        for line in p.stdout:  # blocking per-thread read; no buffer stalls
            print(f"[rank {i}] {line}", end="", flush=True)

    threads = [threading.Thread(target=pump, args=(i, p), daemon=True)
               for i, p in enumerate(procs)]
    for t in threads:
        t.start()

    deadline = time.time() + timeout
    first_failure = 0
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
                if rc is not None and rc != 0 and not first_failure:
                    first_failure = rc
                    print(f"[launcher] rank {i} exited with {rc}; "
                          "terminating remaining ranks", flush=True)
                    _stop(procs)
            time.sleep(0.1)
    finally:
        _stop(procs)        # nothing outlives the launcher
    rcs = [p.wait() for p in procs]
    for t in threads:
        t.join(timeout=5)
    if first_failure:
        return first_failure
    return next((rc for rc in rcs if rc != 0), 0)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    nproc, port, devices, restarts, timeout = 2, 12355, None, 0, 600.0
    store_port, serve_store, store_wal = None, False, None
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
                        store_wal_dir=store_wal)


if __name__ == "__main__":
    raise SystemExit(main())
