"""The port's multi-host launcher (``dtdl_tpu_torch.launch.hosts``, the
counterpart of dtdl_tpu/launch/tpu_vm.py) and the local launcher's share
of a multi-host world, on the CPU.

The command builder, worker discovery and the restart on failure mirror
tests/test_launch.py's cases of the JAX launcher (its ssh flavour only).
A two-"host" world runs on this machine: the commands are built with a
local shell (``sh -c``) in place of ``ssh``, two hosts of one rank each,
each through the port's local launcher, running the DDP twin over gloo;
the ranks must report global process ids 0 and 1 of a world of 2 and
agree on their parameters bit for bit.  A dead worker stops the job, by
name and with its own exit code.
"""

import json
import os
import pathlib
import shlex
import sys
import textwrap
import time

import pytest

from dtdl_tpu.launch import tpu_vm
from dtdl_tpu_torch.launch import hosts, local
from test_data import _make_cifar_fixture
from test_torch_launch import ENV, REPO, free_port

SH = ("sh", "-c")


def test_command_builder_ssh_flavour():
    """The mirror of tests/test_launch.py's builder case: ssh with
    BatchMode, host 0 the coordinator, the host's index; each host starts
    the port's local launcher for its ranks."""
    cmds = hosts.build_commands(["h1", "h2"], ["train.py", "--lr", "0.1"],
                                port=1234, nproc_per_host=4,
                                workdir="/work/repo")
    jcmds = tpu_vm.build_commands(["h1", "h2"], ["train.py", "--lr", "0.1"],
                                  port=1234)
    assert cmds[0][:4] == jcmds[0][:4] == ["ssh", "-o", "BatchMode=yes",
                                           "h1"]
    assert cmds[1][3] == "h2" and len(cmds[1]) == 5
    for i, cmd in enumerate(cmds):
        remote = cmd[-1]
        assert remote.startswith("cd /work/repo && python3 -m "
                                 "dtdl_tpu_torch.launch.local ")
        argv = shlex.split(remote.split(" && ", 1)[1])
        assert argv[argv.index("--coordinator") + 1] == "h1:1234"
        assert argv[argv.index("--n-hosts") + 1] == "2"
        assert argv[argv.index("--host-index") + 1] == str(i)
        assert argv[argv.index("--nproc") + 1] == "4"
        # no time limit on a host's ranks, as JAX's launcher sets none
        assert argv[argv.index("--timeout") + 1] == "inf"
        assert argv[argv.index("--") + 1:] == ["train.py", "--lr", "0.1"]
    # one localhost worker runs the local launcher directly
    solo = hosts.build_commands(["localhost"], ["t.py"])
    assert solo == [[sys.executable, "-m", "dtdl_tpu_torch.launch.local",
                     "--nproc", "1", "--n-hosts", "1", "--host-index", "0",
                     "--coordinator", "localhost:8476", "--port", "8476",
                     "--timeout", "inf", "--", "t.py"]]


def test_discover_workers_from_the_environment(monkeypatch):
    """The mirror of tests/test_launch.py's discovery case, with the
    port's variable (TPU_WORKER_HOSTNAMES names TPU-VM slices)."""
    monkeypatch.delenv("TPU_WORKER_HOSTNAMES", raising=False)
    monkeypatch.setenv(hosts.HOSTS_ENV, "a, b,c")
    assert hosts.discover_workers() == ["a", "b", "c"]
    assert hosts.discover_workers("x,y") == ["x", "y"]
    monkeypatch.delenv(hosts.HOSTS_ENV)
    assert hosts.discover_workers() == ["localhost"]
    monkeypatch.setenv("TPU_WORKER_HOSTNAMES", "t1,t2")
    assert hosts.discover_workers() == ["localhost"]


def test_run_restarts_the_job_after_a_failure(tmp_path, capsys):
    """The mirror of tests/test_launch.py's restart case."""
    marker = tmp_path / "crashed_once"
    prog = textwrap.dedent(f"""
        import os, sys
        m = {str(marker)!r}
        if not os.path.exists(m):
            open(m, 'w').close()
            sys.exit(9)
        print('job recovered')
    """)
    cmds = [[sys.executable, "-c", prog] for _ in range(2)]
    rc = hosts.run(["h0", "h1"], cmds, poll_interval=0.1, max_restarts=1,
                   restart_delay=0.1)
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "relaunching 2 workers" in out
    # the second attempt: both workers find the marker
    again = out.split("relaunching 2 workers", 1)[1]
    assert "[worker 0 h0] job recovered" in again
    assert "[worker 1 h1] job recovered" in again
    # without a budget the failing code is the job's
    marker.unlink()
    assert hosts.run(["h0", "h1"], cmds, poll_interval=0.1) == 9


def test_dry_run_prints_each_worker_command(capsys, monkeypatch):
    monkeypatch.setenv(hosts.HOSTS_ENV, "gpu-a,gpu-b")
    assert hosts.main(["--nproc-per-host", "8", "--port", "9000",
                       "--workdir", "/srv/r", "--dry-run", "--", "-m",
                       "dtdl_tpu_torch.examples.train_lm"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2
    for i, (line, host) in enumerate(zip(lines, ("gpu-a", "gpu-b"))):
        assert line.startswith(f"[worker {i} {host}] ssh -o BatchMode=yes "
                               f"{host} ")
        assert f"--host-index {i}" in line and "--nproc 8" in line
        assert "--coordinator gpu-a:9000" in line
        assert line.endswith("-m dtdl_tpu_torch.examples.train_lm'")
    with pytest.raises(SystemExit):
        hosts.main(["--dry-run"])


def test_local_launcher_gives_global_process_ids(tmp_path, capfd):
    """Host 1 of 2, two ranks: its children are processes 2 and 3 of 4,
    meeting at the coordinator given; a one-host run is unchanged."""
    child = tmp_path / "child.py"
    child.write_text("import sys\nprint('argv', sys.argv[1:])\n")
    assert local.launch_local([str(child)], nproc=2, n_hosts=2,
                              host_index=1, coordinator="h0:7000",
                              timeout=60) == 0
    out = capfd.readouterr().out
    for g in (2, 3):
        assert (f"[rank {g}] argv ['--coordinator', 'h0:7000', "
                f"'--num-processes', '4', '--process-id', '{g}']") in out
    with pytest.raises(ValueError, match="coordinator"):
        local.launch_local([str(child)], n_hosts=2, host_index=1)
    with pytest.raises(ValueError, match="host_index"):
        local.launch_local([str(child)], n_hosts=2, host_index=2,
                           coordinator="h0:1")


def test_two_host_world_on_localhost_runs_the_ddp_twin(tmp_path, capfd):
    """Two "hosts" (this machine twice, a local shell for ssh), one rank
    each: the DDP twin trains over gloo as processes 0 and 1 of a world
    of 2, from the worker commands the launcher builds."""
    _make_cifar_fixture(tmp_path)
    cmds = hosts.build_commands(
        ["127.0.0.1", "127.0.0.1"],
        ["-m", "dtdl_tpu_torch.examples.distributed_data_parallel",
         "--platform", "cpu", "--dataset-dir", str(tmp_path / "fixture_src"),
         "--batch-size", "8", "--limit-train", "16", "--limit-test", "12",
         "--epochs", "1", "--dtype", "float32", "--log-interval", "1",
         "--out", str(tmp_path / "ddp")],
        port=free_port(), workdir=REPO, python=sys.executable, remote=SH,
        timeout=150)
    old = {k: os.environ.get(k) for k in (*ENV, "DTDL_OFFLINE")}
    os.environ.update({**ENV, "DTDL_OFFLINE": "1"})
    try:
        rc = hosts.run(["127.0.0.1", "127.0.0.1"], cmds, poll_interval=0.2)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out = capfd.readouterr().out
    assert rc == 0, out[-4000:]
    summaries = {}
    for line in out.splitlines():
        if "ddp_summary " in line:
            prefix, payload = line.split("ddp_summary ", 1)
            summaries[prefix.split("]")[0] + "]"] = json.loads(payload)
    assert set(summaries) == {"[worker 0 127.0.0.1]",
                              "[worker 1 127.0.0.1]"}, out[-3000:]
    assert summaries["[worker 0 127.0.0.1]"]["rank"] == 0
    assert summaries["[worker 1 127.0.0.1]"]["rank"] == 1
    assert {s["world"] for s in summaries.values()} == {2}
    assert len({s["params_digest"] for s in summaries.values()}) == 1
    assert "[worker 1 127.0.0.1] [rank 1]" in out


def test_a_dead_worker_stops_the_job_by_name(tmp_path, capsys):
    """Worker 1 exits 7 at once; worker 0 would sleep two minutes: the job
    stops within seconds, names worker 1 and returns its 7, and no
    process of worker 0 is left."""
    pidfile = tmp_path / "pid"
    sleeper = (f"import os, time; open({str(pidfile)!r}, 'w')"
               f".write(str(os.getpid())); time.sleep(120)")
    cmds = [["sh", "-c", f"{shlex.quote(sys.executable)} -c "
             f"{shlex.quote(sleeper)}"],
            [sys.executable, "-c", "import sys, time; time.sleep(0.5); "
                                   "sys.exit(7)"]]
    t0 = time.monotonic()
    rc = hosts.run(["node-a", "node-b"], cmds, poll_interval=0.1)
    assert rc == 7
    assert time.monotonic() - t0 < 15
    out = capsys.readouterr().out
    assert "FATAL: worker 1 (node-b) exited with 7" in out
    # worker 0's python, a grandchild under its shell, is gone
    pid = int(pidfile.read_text())
    deadline = time.monotonic() + 10
    while _alive(pid) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not _alive(pid)


def _alive(pid: int) -> bool:
    """Running: neither gone nor a zombie (an init that does not reap
    leaves those)."""
    try:
        stat = pathlib.Path(f"/proc/{pid}/stat").read_text()
    except FileNotFoundError:
        return False
    return stat.rsplit(") ", 1)[1][0] != "Z"
