"""The port's ``serve_fleet`` twin (examples/serve_fleet.py's), on the CPU
as a user runs it: the tiny LM over a health-checked Router.

* Run as its own process with ``--kill-replica-after`` (and with
  ``--disagg``): exit 0, the eviction line, zero requests lost, the
  accounting invariant.
* ``main(argv)`` in-process for the rolling restart and hedging: every
  request served, none failed.
* ``--help`` lists every flag of the JAX script in both spellings.
* The observability flags (``--trace``, ``--metrics-jsonl``,
  ``--metrics-port``, ``--slo-ttft-p99``, ``--slo-availability``), one at
  a time and together with a kill, at the default ``--watchdog``: the
  trace loads as Chrome JSON with one closed flow chain per request, the
  series sums to the books, the scrape line, the SLO verdicts, and the
  heartbeat line.
* The tenants' flags, as a process: ``--lora a,b --json-schema FILE
  --stream`` with replica 0's worker killed serves base and both
  adapters, loses nothing, and no stream parts from its request's tokens.
"""

import importlib
import json
import os
import re
import subprocess
import sys

import pytest
import torch

from test_torch_twins import _help

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, timeout=300):
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
    p = subprocess.run([sys.executable, "-m",
                        "dtdl_tpu_torch.examples.serve_fleet", "--platform",
                        "cpu", *args], cwd=REPO, env=env, text=True,
                       capture_output=True, timeout=timeout)
    assert p.returncode == 0, (p.stdout + p.stderr)[-4000:]
    return p.stdout


@pytest.mark.parametrize("extra", [[], ["--disagg", "--n-replicas", "3"]],
                         ids=["mixed", "disagg"])
def test_twin_fails_over_with_zero_lost(extra):
    out = _run(["--n-requests", "8", "--max-new-tokens", "6",
                "--kill-replica-after", "3", *extra])
    assert "fault armed: replica 0's worker dies at loop iteration 3" in out
    assert re.search(r"evicted replica 0 \([\d.]+ms after worker death\)",
                     out), out
    assert "requests lost: 0" in out and "[OK]" in out
    assert re.search(r"served 8/8 requests over \d replicas", out), out
    if extra:
        assert "disaggregation (prefill/decode/decode): migrations" in out


def test_twin_serves_tenants_through_a_kill(tmp_path):
    schema = tmp_path / "schema.json"
    schema.write_text('{"type": "object", "properties": '
                      '{"id": {"type": "integer"}, "ok": {"type": "boolean"}}}')
    lora = f"{tmp_path / 'a.msgpack'},{tmp_path / 'b.msgpack'}"
    out = _run(["--n-requests", "9", "--max-new-tokens", "24",
                "--lora", lora, "--lora-rank", "4", "--json-schema",
                str(schema), "--stream", "--kill-replica-after", "3"])
    assert out.count("--lora: saved demo adapter") == 2
    assert "requests lost: 0" in out and "[OK]" in out
    mix = re.search(r"multi-lora \(2 adapters, rank 4\): tokens by tenant: "
                    r"a\.msgpack=(\d+)  b\.msgpack=(\d+)  base=(\d+)", out)
    assert mix and all(int(n) > 0 for n in mix.groups()), out
    assert re.search(r"constrained \(.*schema\.json\): \d+/9 valid JSON",
                     out), out
    m = re.search(r"(\d+)/(\d+) clean streams token-exact; divergent "
                  r"streams: (\d+)", out)
    assert m and m[1] == m[2] and m[3] == "0", out


@pytest.mark.parametrize("extra", [["--rolling-restart"],
                                   ["--hedge-after", "0.0001"]],
                         ids=["rolling", "hedge"])
def test_twin_main_restarts_and_hedges(extra, capsys):
    from dtdl_tpu_torch.examples import serve_fleet
    reqs, s, _ = serve_fleet.main(["--platform", "cpu", "--n-requests", "6",
                                   "--max-new-tokens", "4", *extra])
    assert all(r.done and r.error is None and len(r.tokens) == 4
               for r in reqs)
    assert s["fleet_accounting_ok"] and s["fleet_requests_failed"] == 0
    if extra[0] == "--rolling-restart":
        assert s["fleet_restarts"] == 2
        assert "rolling restart done" in capsys.readouterr().out
    else:
        assert s["fleet_hedges"] >= 1


def test_twin_parses_help_with_the_jax_examples_flags(monkeypatch):
    monkeypatch.setenv("COLUMNS", "1000")
    port = importlib.import_module("dtdl_tpu_torch.examples.serve_fleet")
    got = set(re.findall(r"--[\w-]+", _help(port, "serve_fleet")))
    monkeypatch.syspath_prepend(os.path.join(REPO, "examples"))
    jax_twin = importlib.import_module("serve_fleet")
    want = set(re.findall(r"--[\w-]+", _help(jax_twin, "serve_fleet")))
    assert want <= got, sorted(want - got)
    words = [f[2:] for f in got if ("_" in f[2:] or "-" in f[2:])
             and not f.startswith("--no-")]
    assert words and all(f"--{w.replace('-', '_')}" in got and
                         f"--{w.replace('_', '-')}" in got for w in words)


# the observability flags, refused before A13a, each with its working
# output; every case runs at the default --watchdog (0.25 s)
OBS_FLAGS = {
    "trace": ["--trace", "{tmp}/fleet.json"],
    "metrics-jsonl": ["--metrics-jsonl", "{tmp}/series.jsonl"],
    "metrics-port": ["--metrics-port", "0"],
    "slo-ttft-p99": ["--slo-ttft-p99", "30"],
    "slo-availability": ["--slo-availability", "0.5"],
    "all": ["--trace", "{tmp}/fleet.json", "--metrics-jsonl",
            "{tmp}/series.jsonl", "--metrics-port", "0", "--slo-ttft-p99",
            "30", "--slo-availability", "0.5", "--kill-replica-after", "3"],
}


@pytest.mark.parametrize("case", list(OBS_FLAGS))
def test_twin_observability_flags(case, tmp_path, capsys):
    from dtdl_tpu_torch.examples import serve_fleet
    argv = [a.format(tmp=tmp_path) for a in OBS_FLAGS[case]]
    reqs, s, _ = serve_fleet.main(["--platform", "cpu", "--n-requests", "6",
                                   "--max-new-tokens", "4", *argv])
    out = capsys.readouterr().out
    assert all(r.done and r.error is None for r in reqs)
    assert "requests lost: 0" in out and "[OK]" in out
    assert re.search(r"heartbeat: longest gap of a current worker [\d.]+ ms "
                     r"\(watchdog 250 ms\)", out), out
    if case in ("trace", "all"):
        trace = json.load(open(tmp_path / "fleet.json"))["traceEvents"]
        names = {e["name"] for e in trace}
        assert {"route", "admit", "prefill", "harvest", "request_submitted",
                "request_dispatched", "request_done"} <= names
        assert re.search(r"timeline rid=\d+: .*request_submitted -> .*"
                         r"request_dispatched\[primary\].*request_done",
                         out), out
        assert f"trace written to {tmp_path}/fleet.json" in out
        flows = sorted((e for e in trace if e.get("cat") == "request"),
                       key=lambda e: e["ts"])
        for rid in {e["id"] for e in flows}:
            phs = [e["ph"] for e in flows if e["id"] == rid]
            assert phs[0] == "s" and phs.count("s") == 1 \
                and phs.count("f") == 1, phs
    if case in ("metrics-jsonl", "all"):
        pts = [json.loads(x) for x in open(tmp_path / "series.jsonl")]
        assert pts and sum(p.get("fleet_requests_finished", 0)
                           for p in pts) == 6
        assert f"snapshots -> {tmp_path}/series.jsonl" in out
    if case in ("metrics-port", "all"):
        assert re.search(r"scraping: curl http://127\.0\.0\.1:\d+/metrics",
                         out), out
    if case in ("slo-ttft-p99", "all"):
        assert "'slo_ttft_p99_ok': 1" in out and s["slo_ttft_p99_ok"] == 1
    if case in ("slo-availability", "all"):
        assert "'slo_availability_ok'" in out
        assert s["slo_breach_events"] == 0
    if case == "all":
        assert s["fleet_evictions"] == 1       # the kill, nothing else
