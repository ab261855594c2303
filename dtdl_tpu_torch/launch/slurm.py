"""SLURM launcher integration, the port of dtdl_tpu/launch/slurm.py.

Inside a SLURM allocation every task derives its coordinator,
num_processes and process_id for :func:`dtdl_tpu_torch.runtime.initialize`
from the environment SLURM already provides: no wrapper flags and no rank
arithmetic in user scripts.  The port runs one process a card, and
``initialize`` binds the card ``process_id % device_count``; under SLURM's
default block distribution with ``--ntasks-per-node`` at most the node's
card count, that gives each task of a node its own card
(:func:`card_binding_error` names the layouts where it would not).

Three surfaces:

* ``from_env(environ)``: (coordinator, num_processes, process_id) from
  SLURM_PROCID / SLURM_NTASKS / SLURM_JOB_NODELIST (the first node hosts
  the coordinator; the port is derived stably from SLURM_JOB_ID so
  concurrent jobs on a shared node don't collide).
* ``expand_nodelist``: SLURM's compressed hostlist syntax
  (``gpu[001-003,007],login1``) into an explicit host list.
* ``sbatch_script`` / the CLI: generate a ready-to-submit batch script,
  or (inside an allocation) exec the training script with the derived
  topology appended:  ``srun python -m dtdl_tpu_torch.launch.slurm --
  train.py --flags`` (a ``-m module`` works in place of the script).

:func:`dtdl_tpu_torch.examples.common.bootstrap` consults
:func:`maybe_slurm` when no coordinator is given, so every example script
is SLURM-launchable with no changes.
"""

from __future__ import annotations

import os
import re
import shlex
import sys

_BASE_PORT = 12800
_PORT_SPAN = 4096


def expand_nodelist(spec: str) -> list[str]:
    """Expand SLURM's compressed nodelist: ``a[1-3,05,9],b2`` -> hosts.

    Numeric ranges preserve zero-padding (``n[001-003]`` -> n001..n003).
    """
    hosts: list[str] = []
    # split on commas that are not inside brackets
    parts, depth, cur = [], 0, ""
    for ch in spec:
        if ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append(cur)
            cur = ""
        else:
            cur += ch
    if cur:
        parts.append(cur)
    for part in parts:
        m = re.fullmatch(r"([^\[\]]+)\[([^\]]+)\](.*)", part.strip())
        if not m:
            if part.strip():
                hosts.append(part.strip())
            continue
        prefix, body, suffix = m.groups()
        for item in body.split(","):
            if "-" in item:
                lo, hi = item.split("-", 1)
                width = len(lo) if lo.startswith("0") else 0
                for n in range(int(lo), int(hi) + 1):
                    hosts.append(f"{prefix}{n:0{width}d}{suffix}")
            else:
                hosts.append(f"{prefix}{item}{suffix}")
    return hosts


def job_port(environ=None) -> int:
    """Stable per-job coordinator port (concurrent jobs don't collide)."""
    environ = environ if environ is not None else os.environ
    job = environ.get("SLURM_JOB_ID", "0")
    return _BASE_PORT + (int(re.sub(r"\D", "", job) or 0) % _PORT_SPAN)


def from_env(environ=None) -> tuple[str, int, int]:
    """(coordinator, num_processes, process_id) from the SLURM environment.

    Task count comes from the *step* when present (srun sets
    SLURM_STEP_NUM_TASKS; the sbatch batch step runs as a 1-task step even
    when the job requests more), falling back to the job's SLURM_NTASKS.
    Raises KeyError outside an allocation — callers use `maybe_slurm()` for
    the optional form.
    """
    environ = environ if environ is not None else os.environ
    ntasks = int(environ.get("SLURM_STEP_NUM_TASKS")
                 or environ["SLURM_NTASKS"])
    procid = int(environ["SLURM_PROCID"])
    nodelist = (environ.get("SLURM_STEP_NODELIST")
                or environ["SLURM_JOB_NODELIST"])
    head = expand_nodelist(nodelist)[0]
    return f"{head}:{job_port(environ)}", ntasks, procid


def maybe_slurm(environ=None) -> dict | None:
    """Topology kwargs for `runtime.initialize` when running under a
    multi-task SLURM *step*; None otherwise.

    Counts tasks per the current step, not the job: a script run directly
    in an sbatch batch script (no srun) is a 1-task step even when the job
    requested --ntasks=4, and must stay single-process — initializing a
    4-process world there would block forever waiting for peers.
    """
    environ = environ if environ is not None else os.environ
    if "SLURM_PROCID" not in environ or "SLURM_NTASKS" not in environ:
        return None
    ntasks = int(environ.get("SLURM_STEP_NUM_TASKS")
                 or environ["SLURM_NTASKS"])
    if ntasks <= 1:
        return None
    coordinator, num_processes, process_id = from_env(environ)
    return {"coordinator": coordinator, "num_processes": num_processes,
            "process_id": process_id}


def card_binding_error(environ=None) -> str | None:
    """Why ``process_id % device_count`` would not give this task its own
    card, or None.  Under the block distribution a node's tasks hold
    consecutive ranks, so rank modulo the tasks per node is SLURM's own
    local id; a cyclic (or arbitrary) distribution breaks that and two
    tasks of a node would share a card."""
    environ = environ if environ is not None else os.environ
    per_node = environ.get("SLURM_NTASKS_PER_NODE")
    local = environ.get("SLURM_LOCALID")
    if not per_node or local is None or not per_node.isdigit():
        return None
    procid = int(environ["SLURM_PROCID"])
    if procid % int(per_node) != int(local):
        return (f"task {procid} is local task {local} of its node, but "
                f"binds card {procid} % device_count: use the block "
                f"distribution (srun --distribution=block) so each task "
                f"of a node gets its own card")
    return None


def store_port(environ=None) -> int:
    """Stable per-job control-plane store port, in its OWN band above
    the coordinator span (``_BASE_PORT + _PORT_SPAN + id % span``): a
    ``+1`` offset would land exactly on the NEXT job id's coordinator
    port, and sequentially-submitted jobs sharing a head node would
    collide — the very thing :func:`job_port` exists to prevent."""
    return job_port(environ) + _PORT_SPAN


def store_addr_from_env(environ=None) -> str:
    """The elastic control-plane store address under SLURM: the
    coordinator host (first node of the allocation) at
    :func:`store_port` — the same derivation the sbatch export below
    does in shell, so a task inside the allocation and the generated
    batch script can never disagree on where the store lives."""
    environ = environ if environ is not None else os.environ
    nodelist = (environ.get("SLURM_STEP_NODELIST")
                or environ["SLURM_JOB_NODELIST"])
    head = expand_nodelist(nodelist)[0]
    return f"{head}:{store_port(environ)}"


def sbatch_script(script_args: list[str], nodes: int = 2,
                  ntasks_per_node: int = 1, job_name: str = "dtdl_tpu",
                  time_limit: str = "01:00:00", partition: str = "",
                  requeue: bool = False, max_restarts: int = 0,
                  store: bool = False,
                  store_wal_dir: str = "$SLURM_SUBMIT_DIR/store_wal"
                  ) -> str:
    """A ready-to-submit sbatch file: ``nodes`` hosts with
    ``ntasks_per_node`` tasks each, one process a card (set it to the
    node's card count to use every card).

    Two recovery layers:

    * ``requeue=True``: ``#SBATCH --requeue`` (+ append-mode logs):
      node failures and preemptions put the whole job back in the
      queue; on re-run every rank resumes from its latest checkpoint
      (the Trainer/Estimator/Solver restore path).
    * ``max_restarts=N``: an in-allocation restart loop around
      ``srun``: a failed step is relaunched up to N times without
      going back through the scheduler queue (the launch.local
      ``max_restarts`` model, minutes cheaper than a requeue), bounded
      so a deterministic crash still fails the job loudly.

    ``store=True`` adds the multi-process control plane: the batch step
    (which runs on the allocation's first node, the coordinator host)
    exports ``DTDL_STORE_ADDR`` (head node, the per-job store band: the
    same arithmetic :func:`store_addr_from_env` does) and backgrounds a
    :mod:`dtdl_tpu_torch.parallel.tcpstore` coordinator with a WAL in
    ``store_wal_dir``.  The server lives outside the srun step, so it
    spans every in-allocation restart, and because the WAL survives even
    a requeue, a re-queued job's store recovers its generation and commit
    markers (clients refuse an amnesiac one by epoch, by name).
    """
    payload = " ".join(shlex.quote(a) for a in script_args)
    lines = [
        "#!/bin/bash",
        f"#SBATCH --job-name={job_name}",
        f"#SBATCH --nodes={nodes}",
        f"#SBATCH --ntasks-per-node={ntasks_per_node}",
        f"#SBATCH --time={time_limit}",
    ]
    if partition:
        lines.append(f"#SBATCH --partition={partition}")
    if requeue:
        lines += [
            "# requeue-on-failure: preempted/node-failed jobs re-enter",
            "# the queue and resume from their latest checkpoint",
            "#SBATCH --requeue",
            "#SBATCH --open-mode=append",
        ]
    srun = f"srun python -m dtdl_tpu_torch.launch.slurm -- {payload}"
    lines += [
        "",
        "# every task self-discovers coordinator/rank from SLURM_* env",
    ]
    if store:
        lines += [
            "# control-plane store: coordinator host (first node) at",
            "# the store port band; WAL-backed so a restart (or a",
            "# whole-job requeue) recovers keys/generation/leases",
            "head=$(scontrol show hostnames \"$SLURM_JOB_NODELIST\""
            " | head -n1)",
            f"store_port=$(({_BASE_PORT + _PORT_SPAN} + "
            f"SLURM_JOB_ID % {_PORT_SPAN}))",
            "export DTDL_STORE_ADDR=\"${head}:${store_port}\"",
            f"mkdir -p {store_wal_dir}",
            "python -m dtdl_tpu_torch.parallel.tcpstore --host 0.0.0.0 "
            "--port \"${store_port}\" "
            f"--wal-dir {store_wal_dir} > store.log 2>&1 &",
            "store_pid=$!",
            "trap 'kill ${store_pid} 2>/dev/null' EXIT",
            "# wait (bounded) for the coordinator's ready line: its",
            "# cold start (interpreter + imports on a shared FS) must",
            "# not race the workers' connect budgets",
            "for _ in $(seq 1 120); do",
            "    grep -q 'STORE ready' store.log 2>/dev/null && break",
            "    kill -0 ${store_pid} 2>/dev/null || "
            "{ cat store.log >&2; exit 1; }",
            "    sleep 1",
            "done",
        ]
    if max_restarts > 0:
        lines += [
            f"# elastic restart: up to {max_restarts} in-allocation",
            "# relaunches; ranks resume from their latest checkpoint",
            f"for attempt in $(seq 0 {max_restarts}); do",
            f"    {srun} && exit 0",
            "    echo \"[dtdl_tpu.slurm] attempt ${attempt} failed;"
            " relaunching\" >&2",
            "done",
            "exit 1",
            "",
        ]
    else:
        lines += [srun, ""]
    return "\n".join(lines)


def main(argv=None) -> int:
    """Inside an allocation: exec the script with derived topology flags.

    ``--emit-sbatch [--nodes N ...]`` writes a batch script to stdout
    instead (works anywhere, no SLURM needed).
    """
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["--emit-sbatch"]:
        argv = argv[1:]
        nodes, per_node, partition = 2, 1, ""
        requeue, max_restarts, store = False, 0, False
        while argv and argv[0] != "--":
            if argv[0] == "--nodes":
                nodes = int(argv[1]); argv = argv[2:]
            elif argv[0] == "--ntasks-per-node":
                per_node = int(argv[1]); argv = argv[2:]
            elif argv[0] == "--partition":
                partition = argv[1]; argv = argv[2:]
            elif argv[0] == "--requeue":
                requeue = True; argv = argv[1:]
            elif argv[0] == "--max-restarts":
                max_restarts = int(argv[1]); argv = argv[2:]
            elif argv[0] == "--store":
                store = True; argv = argv[1:]
            else:
                raise SystemExit(f"unknown flag {argv[0]}")
        script = argv[1:] if argv[:1] == ["--"] else argv
        if not script:
            raise SystemExit("no script given after --")
        print(sbatch_script(script, nodes=nodes, ntasks_per_node=per_node,
                            partition=partition, requeue=requeue,
                            max_restarts=max_restarts, store=store))
        return 0

    script = argv[1:] if argv[:1] == ["--"] else argv
    if not script:
        raise SystemExit(
            "usage: srun python -m dtdl_tpu_torch.launch.slurm -- "
            "script.py --flags\n"
            "   or: python -m dtdl_tpu_torch.launch.slurm --emit-sbatch -- "
            "script.py")
    coordinator, num_processes, process_id = from_env()
    bad = card_binding_error()
    if bad:
        raise SystemExit(bad)
    # NOTE: the store address is NOT auto-exported here — only the
    # sbatch `store=True` path exports DTDL_STORE_ADDR, because only
    # it actually launches a server.  Scripts that run their own
    # coordinator derive the canonical address via
    # :func:`store_addr_from_env`.
    cmd = [sys.executable, *script,
           "--coordinator", coordinator,
           "--num-processes", str(num_processes),
           "--process-id", str(process_id)]
    os.execv(sys.executable, cmd)


if __name__ == "__main__":
    raise SystemExit(main())
