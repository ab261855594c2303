"""Multi-host launcher, the port's counterpart of dtdl_tpu/launch/tpu_vm.py.

The reference starts a multi-node job by hand, one shell a rank on each
node; the JAX package's launcher automates that for the hosts of a TPU
slice.  This one does it for GPU hosts: it discovers the worker hosts,
starts one command per host over ``ssh`` with host 0 as the coordinator,
prints every worker's log lines with ``[worker i host]`` in front, stops
the whole job when one worker dies (keeping that worker's exit code),
restarts the whole job up to ``--max-restarts`` times, and shows the exact
commands with ``--dry-run``.

CLI::

    python -m dtdl_tpu_torch.launch.hosts --workers h1,h2 \\
        [--nproc-per-host G] [--port 8476] [--workdir DIR] \\
        [--max-restarts R] [--dry-run] \\
        -- script.py --flags        (or: -- -m package.module --flags)

Host discovery: ``--workers h1,h2,...``, then the ``DTDL_WORKER_HOSTS``
environment variable (comma-separated), then ``localhost`` alone.

The difference from JAX: JAX runs one process per host, which drives the
host's chips; the port runs one process per card.  So each host runs the
port's local launcher (:mod:`dtdl_tpu_torch.launch.local`) for its G
ranks, told the number of hosts, its index and the coordinator's address
(``h1:PORT``), and rank ``local`` of host ``i`` is global process
``i·G + local`` of ``len(workers)·G``.  The remote command is ``cd
WORKDIR && python3 -m dtdl_tpu_torch.launch.local ...`` (the checkout at
the same path on every host, as a shared file system gives it).

Left out of JAX's launcher: its ``gcloud compute tpus tpu-vm ssh``
branch (``--gcloud``, ``--zone``) and the ``TPU_WORKER_HOSTNAMES``
variable, which name TPU-VM slices and mean nothing on GPU hosts.
"""

from __future__ import annotations

import argparse
import os
import shlex
import signal
import subprocess
import sys
import threading
import time

HOSTS_ENV = "DTDL_WORKER_HOSTS"
SSH = ("ssh", "-o", "BatchMode=yes", "{host}")
_LOCAL = ("localhost", "127.0.0.1")


def discover_workers(explicit: str = "") -> list[str]:
    """``explicit`` (comma-separated), else ``$DTDL_WORKER_HOSTS``, else
    ``["localhost"]``."""
    for source in (explicit, os.environ.get(HOSTS_ENV, "")):
        hosts = [w.strip() for w in source.split(",") if w.strip()]
        if hosts:
            return hosts
    return ["localhost"]


def build_commands(workers: list[str], script_args: list[str],
                   port: int = 8476, nproc_per_host: int = 1,
                   workdir: str | None = None, python: str = "python3",
                   remote=SSH, timeout: float | None = None
                   ) -> list[list[str]]:
    """One command line per worker host (host 0 is the coordinator).

    Each runs the port's local launcher for the host's ``nproc_per_host``
    ranks, with no time limit unless ``timeout`` (seconds) sets one, as
    JAX's launcher sets none; ``remote`` is the argv prefix that runs a
    shell command on a host (``ssh -o BatchMode=yes {host}`` by default;
    ``{host}`` is replaced).  A single ``localhost`` worker runs the local
    launcher directly, without a remote shell."""
    coordinator = f"{workers[0]}:{port}"
    workdir = workdir or os.getcwd()
    cmds = []
    for i, host in enumerate(workers):
        launcher = ["-m", "dtdl_tpu_torch.launch.local",
                    "--nproc", str(nproc_per_host),
                    "--n-hosts", str(len(workers)), "--host-index", str(i),
                    "--coordinator", coordinator, "--port", str(port),
                    "--timeout", str(timeout or float("inf")),
                    "--", *script_args]
        if len(workers) == 1 and host in _LOCAL:
            cmds.append([sys.executable, *launcher])
            continue
        shell = (f"cd {shlex.quote(workdir)} && "
                 + " ".join(shlex.quote(a) for a in (python, *launcher)))
        cmds.append([a.replace("{host}", host) for a in remote] + [shell])
    return cmds


def run(workers: list[str], cmds: list[list[str]],
        poll_interval: float = 2.0, max_restarts: int = 0,
        restart_delay: float = 10.0) -> int:
    """Start every worker, print their lines rank-prefixed, stop the job
    when one dies; returns 0 or the first failing worker's code.

    ``max_restarts`` relaunches the whole job after a failure (each rank
    resumes from its latest snapshot, the checkpoint-restart model).
    ``restart_delay`` seconds pass before each relaunch: a terminated ssh
    client does not end the remote process at once, and the old
    coordinator may still hold its port."""
    attempt = 0
    while True:
        rc = _run_once(workers, cmds, poll_interval)
        if rc == 0 or attempt >= max_restarts:
            return rc
        attempt += 1
        print(f"[launcher] attempt {attempt}/{max_restarts}: relaunching "
              f"{len(workers)} workers in {restart_delay:.0f}s (resume from "
              "the latest checkpoint)", flush=True)
        time.sleep(restart_delay)


def _stop(procs, grace: float = 10.0) -> None:
    """SIGTERM each live worker's process group, SIGKILL what outlives
    ``grace`` (a worker's group holds its shell, launcher and ranks)."""
    for p in procs:
        if p.poll() is None:
            _signal_group(p, signal.SIGTERM)
    deadline = time.time() + grace
    for p in procs:
        try:
            p.wait(max(0.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            _signal_group(p, signal.SIGKILL)
            p.wait()


def _signal_group(p, sig) -> None:
    try:
        os.killpg(p.pid, sig)
    except ProcessLookupError:
        pass


def _run_once(workers: list[str], cmds: list[list[str]],
              poll_interval: float) -> int:
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              bufsize=1, start_new_session=True)
             for cmd in cmds]

    def pump(i: int, p: subprocess.Popen):
        for line in p.stdout:
            print(f"[worker {i} {workers[i]}] {line}", end="", flush=True)

    threads = [threading.Thread(target=pump, args=(i, p), daemon=True)
               for i, p in enumerate(procs)]
    for t in threads:
        t.start()
    rc = 0
    try:
        while any(p.poll() is None for p in procs):
            for i, p in enumerate(procs):
                code = p.poll()
                if code is not None and code != 0 and not rc:
                    rc = code          # the first failing worker's code
                    print(f"[launcher] FATAL: worker {i} ({workers[i]}) "
                          f"exited with {code}; stopping the job",
                          flush=True)
                    _stop(procs)
            time.sleep(poll_interval)
    finally:
        _stop(procs)                   # nothing outlives the launcher
    rcs = [p.wait() for p in procs]
    for t in threads:
        t.join(timeout=5)
    return rc or next((c for c in rcs if c != 0), 0)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m dtdl_tpu_torch.launch.hosts",
        description="Launch a script over GPU hosts, one process a card")
    parser.add_argument("--workers", default="",
                        help=f"comma-separated worker hosts (default: "
                             f"${HOSTS_ENV} or localhost)")
    parser.add_argument("--nproc-per-host", type=int, default=1,
                        help="ranks (cards) on each host")
    parser.add_argument("--port", type=int, default=8476,
                        help="the coordinator's port on worker 0")
    parser.add_argument("--workdir", default=None,
                        help="the checkout's path on every host (default: "
                             "this directory)")
    parser.add_argument("--max-restarts", type=int, default=0,
                        help="relaunch the whole job up to N times after a "
                             "worker fails (checkpoint-restart)")
    parser.add_argument("--dry-run", action="store_true",
                        help="print each worker's command and exit")
    parser.add_argument("script", nargs=argparse.REMAINDER,
                        help="-- script.py --flags")
    args = parser.parse_args(argv)
    script = args.script[1:] if args.script[:1] == ["--"] else args.script
    if not script:
        parser.error("no script given (append: -- script.py --flags)")
    workers = discover_workers(args.workers)
    cmds = build_commands(workers, script, args.port, args.nproc_per_host,
                          args.workdir)
    if args.dry_run:
        for i, cmd in enumerate(cmds):
            print(f"[worker {i} {workers[i]}] "
                  + " ".join(shlex.quote(c) for c in cmd))
        return 0
    return run(workers, cmds, max_restarts=args.max_restarts)


if __name__ == "__main__":
    raise SystemExit(main())
