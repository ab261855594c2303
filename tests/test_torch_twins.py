"""The port's twins of the Keras and Chainer MNIST examples
(``dtdl_tpu_torch/examples``), run on the CPU as a user runs them.

Each twin runs as its own process (``python -m
dtdl_tpu_torch.examples.<twin> --platform cpu``; the multi-process
twins through ``dtdl_tpu_torch.launch.local --nproc 2`` over gloo), two
processes at a time, on a 256-example MNIST file in the Keras ``mnist.npz``
layout, with no tensorboard package importable (as on the card
machine: the TensorBoard callback is then a no-op).  Each must exit 0
and print its report; ``train_mnist`` then resumes from its snapshot.
Every twin parses ``--help``, and its flags include every flag of the
JAX example it twins, in both spellings.
"""

import gzip
import importlib
import io
import json
import os
import re
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

from dtdl_tpu_torch.data.synthetic import synthetic_mnist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TWINS = ("mnist_single", "mnist_mirror_strategy",
         "mnist_multi_worker_strategy", "train_mnist", "train_mnist_gpu",
         "train_mnist_multi")
KERAS = ["--epochs", "2", "--batch_size", "32", "--test_batchsize", "50"]
CHAINER = ["-b", "32", "-e", "2", "-u", "32"]


def _cmd(twin, args, nproc=1):
    mod = ["-m", f"dtdl_tpu_torch.examples.{twin}", "--platform", "cpu",
           *args]
    if nproc == 1:
        return [sys.executable, *mod]
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    return [sys.executable, "-m", "dtdl_tpu_torch.launch.local", "--nproc",
            str(nproc), "--port", str(port), "--timeout", "240", "--", *mod]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every twin's (exit code, output)."""
    root = tmp_path_factory.mktemp("twins")
    (train, test) = synthetic_mnist(n_train=256, n_test=100)
    os.makedirs(root / "data" / "mnist")
    np.savez(root / "data" / "mnist" / "mnist.npz", x_train=train[0],
             y_train=train[1], x_test=test[0], y_test=test[1])
    for pkg in ("tensorboard", "tensorboardX"):
        os.makedirs(root / "stub" / pkg)
        (root / "stub" / pkg / "__init__.py").write_text(
            "raise ImportError('no tensorboard package here')\n")
    env = {**os.environ, "PYTHONPATH": f"{root / 'stub'}{os.pathsep}{REPO}",
           "OMP_NUM_THREADS": "1", "DTDL_OFFLINE": "1"}
    data = ["--dataset-dir", str(root / "data")]
    jobs = {
        "mnist_single": _cmd("mnist_single", [
            *KERAS, *data, "--train_dir", str(root / "single")]),
        "mnist_mirror_strategy": _cmd("mnist_mirror_strategy", [
            *KERAS, *data, "--train_dir", str(root / "mirror")]),
        "mnist_multi_worker_strategy": _cmd("mnist_multi_worker_strategy", [
            *KERAS, *data, "--train_dir", str(root / "multiworker")], 2),
        "train_mnist": _cmd("train_mnist", [
            *CHAINER, *data, "-o", str(root / "chainer")]),
        "train_mnist_gpu": _cmd("train_mnist_gpu", [
            *CHAINER, *data, "-o", str(root / "gpu")]),
        "train_mnist_multi": _cmd("train_mnist_multi", [
            *CHAINER, *data, "-o", str(root / "multi")], 2),
    }
    out = {}
    # two processes at a time: the other test workers share the cores
    for wave in (("mnist_single", "train_mnist"),
                 ("mnist_mirror_strategy", "train_mnist_gpu"),
                 ("mnist_multi_worker_strategy",), ("train_mnist_multi",)):
        procs = {k: subprocess.Popen(jobs[k], cwd=root, env=env, text=True,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT)
                 for k in wave}
        for k, p in procs.items():
            text, _ = p.communicate(timeout=300)
            out[k] = (p.returncode, text)
    # resume train_mnist from its end-of-run snapshot for one more epoch
    snap = root / "chainer" / "snapshot_16"
    cmd = _cmd("train_mnist", [*CHAINER[:2], "-e", "3", *CHAINER[4:], *data,
                               "-o", str(root / "chainer"), "--resume",
                               str(snap)])
    p = subprocess.run(cmd, cwd=root, env=env, text=True,
                       capture_output=True, timeout=300)
    out["train_mnist --resume"] = (p.returncode, p.stdout + p.stderr)
    return root, out


def _ok(runs, key):
    rc, text = runs[1][key]
    assert rc == 0, text[-4000:]
    return text


def test_keras_twins_fit_checkpoint_and_evaluate_the_latest(runs):
    root = runs[0]
    for key, tdir in (("mnist_single", "single"),
                      ("mnist_mirror_strategy", "mirror")):
        text = _ok(runs, key)
        assert re.search(r"Epoch \[1\] \| loss: [\d.]+ \| accuracy: [\d.]+ "
                         r"\| val_loss: [\d.]+ \| val_accuracy", text), text
        assert re.search(r"Eval loss: [\d.]+, Eval Accuracy: [\d.]+", text)
        assert "TensorBoardSink is a no-op" in text
        assert sorted(p for p in os.listdir(root / tdir)
                      if p.endswith(".pt")) == ["weights_epoch_0000.pt",
                                                "weights_epoch_0001.pt"]
    assert "Mirrored DP over 1 local device(s)" in _ok(
        runs, "mnist_mirror_strategy")


def test_multi_worker_keras_twin_on_two_gloo_ranks(runs):
    text = _ok(runs, "mnist_multi_worker_strategy")
    assert "[rank 0] MultiWorker DP over 2 replicas" in text
    evals = re.findall(r"\[rank (\d)\] Eval loss: ([\d.e-]+), Eval "
                       r"Accuracy: ([\d.]+)", text)
    assert sorted(r for r, _, _ in evals) == ["0", "1"]
    assert evals[0][1:] == evals[1][1:]     # the synced eval on each rank
    assert os.path.exists(runs[0] / "multiworker" / "weights_epoch_0001.pt")


def test_chainer_twins_report_snapshot_and_resume(runs):
    root = runs[0]
    header = re.compile(r"epoch\s+iteration\s+loss\s+accuracy\s+val_loss\s+"
                        r"val_accuracy\s+elapsed_time")
    for key, out in (("train_mnist", "chainer"), ("train_mnist_gpu", "gpu")):
        text = _ok(runs, key)
        assert header.search(text), text
        assert re.search(r"^\s+2\s+16\s+[\d.]+", text, re.M), text
    assert "ParallelUpdater-style DP over 1 local device(s)" in _ok(
        runs, "train_mnist_gpu")
    assert (root / "gpu" / "snapshot_16" / "_DTDL_COMMIT").exists()
    assert (root / "gpu" / "train_step.graph.txt").exists()
    text = _ok(runs, "train_mnist --resume")
    assert re.search(r"^\s+3\s+24\s+[\d.]+", text, re.M), text
    lines = (root / "chainer" / "log.jsonl").read_text().splitlines()
    assert [int(re.search(r'"iteration": (\d+)', x)[1]) for x in lines] == \
        [8, 16, 24]


def test_chainer_multi_twin_on_two_gloo_ranks(runs):
    text = _ok(runs, "train_mnist_multi")
    assert "[rank 0] Num process (COMM_WORLD): 2" in text
    rows = re.findall(r"\[rank (\d)\]\s+2\s+16\s+", text)
    assert rows == ["0"]                    # leader-gated report
    assert (runs[0] / "multi" / "snapshot_16" / "_DTDL_COMMIT").exists()


def _help(module, argv0):
    buf = io.StringIO()
    old = sys.argv
    sys.argv = [argv0, "--help"]
    try:
        with redirect_stdout(buf), pytest.raises(SystemExit) as e:
            module.main()
    finally:
        sys.argv = old
    assert e.value.code == 0
    return buf.getvalue()


@pytest.mark.parametrize("twin", TWINS)
def test_twin_parses_help_with_the_jax_examples_flags(twin, monkeypatch):
    port = importlib.import_module(f"dtdl_tpu_torch.examples.{twin}")
    got = set(re.findall(r"--[\w-]+", _help(port, twin)))
    monkeypatch.syspath_prepend(os.path.join(REPO, "examples"))
    jax_twin = importlib.import_module(twin)
    want = set(re.findall(r"--[\w-]+", _help(jax_twin, twin)))
    assert want <= got, sorted(want - got)
    # every multi-word flag in both spellings (argparse's generated
    # --no-<flag> negation has one)
    words = [f[2:] for f in got if ("_" in f[2:] or "-" in f[2:])
             and not f.startswith("--no-")]
    assert words and all(f"--{w.replace('-', '_')}" in got and
                         f"--{w.replace('_', '-')}" in got for w in words)


def test_serve_lm_twin_serves_tenants(tmp_path, capsys):
    """serve_lm with --lora (two demo adapters written on first use),
    --json-schema and --stream on the tiny LM, paged: every request ends
    without error, its output legal for the schema's automaton, each
    stream closed and equal to its request's tokens, and the JAX
    script's report lines."""
    from dtdl_tpu_torch.examples import serve_lm
    schema = tmp_path / "schema.json"
    schema.write_text('{"type": "object", "properties": '
                      '{"id": {"type": "integer"}, "ok": {"type": "boolean"}}}')
    lora = f"{tmp_path / 'a.pt'},{tmp_path / 'b.pt'}"
    reqs, s, _ = serve_lm.main(
        ["--platform", "cpu", "--n-requests", "6", "--n-slots", "3",
         "--max-new-tokens", "30", "--page-size", "16", "--lora", lora,
         "--lora-rank", "4", "--json-schema", str(schema), "--stream"])
    out = capsys.readouterr().out
    assert all(r.done and r.error is None for r in reqs)
    dfa = reqs[0].grammar
    for r in reqs:
        assert dfa.walk(r.tokens) >= 0
        assert r.stream.closed and not r.stream.divergent
        assert r.stream.tokens == r.tokens
    assert [r.adapter for r in reqs[:3]] == [None] + lora.split(",")
    assert sorted(s["tokens_by_adapter"]) == sorted(
        ["base"] + lora.split(","))
    assert out.count("--lora: saved demo adapter") == 2
    assert re.search(r"multi-lora \(2 adapters, rank 4\): tokens by tenant: "
                     r"a\.pt=\d+  b\.pt=\d+  base=\d+  bank loads 2", out)
    assert re.search(r"--json-schema: \d+-state token DFA", out)
    assert re.search(r"constrained \(.*\): \d+/6 requests completed valid "
                     r"JSON", out)
    assert "stream req 0: +[" in out
    assert f"streaming: {s['stream_deliveries']} incremental" in out


def test_serve_lm_trace_writes_the_scheduler_trace(tmp_path, capsys):
    """serve_lm --trace (refused before A13a): the Chrome trace loads,
    holds the scheduler's spans and each request's admitted, first-token
    and finished events with a closed flow chain, and the twin prints the
    JAX script's trace line after its report."""
    from dtdl_tpu_torch.examples import serve_lm
    path = tmp_path / "serve.json.gz"
    reqs, s, _ = serve_lm.main(
        ["--platform", "cpu", "--n-requests", "5", "--n-slots", "2",
         "--max-new-tokens", "6", "--page-size", "16", "--trace",
         str(path)])
    out = capsys.readouterr().out
    assert all(r.done and r.error is None for r in reqs)
    assert f"trace written to {path}" in out
    assert re.search(r"ttft p50/p95/p99: [\d.]+ / [\d.]+ / [\d.]+ ms", out)
    with gzip.open(path, "rt") as f:
        trace = json.load(f)["traceEvents"]
    names = [e["name"] for e in trace]
    assert {"admit", "prefill", "dispatch", "harvest", "drain"} <= set(names)
    for n in ("request_admitted", "request_first_token", "request_finished"):
        assert names.count(n) == 5, n
    flows = [e["ph"] for e in trace if e.get("cat") == "request"]
    assert flows.count("s") == flows.count("f") == 5


def test_train_lm_trace_writes_spans_and_goodput(tmp_path, capsys):
    """train_lm --trace (refused before A13a): the log rows carry the
    goodput fields of each window, and the trace holds the data, dispatch
    and drain spans and the window-settled device track."""
    from dtdl_tpu_torch.examples import train_lm
    path = tmp_path / "train.json"
    train_lm.main(["--platform", "cpu", "--batch-size", "8", "--seq-len",
                   "16", "--epochs", "1", "--log-interval", "4",
                   "--trace", str(path), "--out", str(tmp_path / "out")])
    out = capsys.readouterr().out
    assert f"trace written to {path}" in out
    assert "tokens_per_sec" in out and "steps_per_sec" in out
    trace = json.load(open(path))["traceEvents"]
    names = [e["name"] for e in trace]
    assert {"data", "dispatch", "drain", "device"} <= set(names)
    assert names.count("dispatch") == names.count("data") > 0
    assert any(e.get("args", {}).get("name") == "device (window-settled)"
               for e in trace if e["ph"] == "M")
