"""The port's twins of the remaining JAX examples (``single_device``,
``data_parallel``, ``imagenet_resnet50``, ``serve_lm``, ``tf_estimator``,
``caffe_train``, ``mxnet_kvstore``), run on the CPU as a user runs them.

Each twin runs as its own process (``python -m
dtdl_tpu_torch.examples.<twin> --platform cpu``; ``mxnet_kvstore
--kv-store dist_sync`` also through ``dtdl_tpu_torch.launch.local
--nproc 2`` over gloo), a few at a time, at a tiny size: an 80-image
CIFAR-10 in the python-pickle layout, a 512-image MNIST in the Keras
``mnist.npz`` layout, ResNet-50 at 32 px and 8 classes, the ``tiny`` LM.
Each must exit 0 and print its JAX example's report line;
``caffe_train`` and ``tf_estimator`` then run again on their output
directory and resume.  Every twin parses ``--help`` with every flag of
its JAX example in both spellings, and each flag whose module is not
ported raises ``NotImplementedError`` naming its ROADMAP item.
"""

import importlib
import os
import pickle
import re
import socket
import subprocess
import sys

import numpy as np
import pytest

from dtdl_tpu_torch.data.synthetic import class_pattern_images, synthetic_mnist
from test_torch_twins import _help

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TWINS = ("single_device", "data_parallel", "imagenet_resnet50", "serve_lm",
         "tf_estimator", "caffe_train", "mxnet_kvstore")
SOLVER = os.path.join(REPO, "examples", "caffe", "lenet_solver.prototxt")


def _cmd(twin, args, nproc=1):
    mod = ["-m", f"dtdl_tpu_torch.examples.{twin}", "--platform", "cpu",
           *args]
    if nproc == 1:
        return [sys.executable, *mod]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    return [sys.executable, "-m", "dtdl_tpu_torch.launch.local", "--nproc",
            str(nproc), "--port", str(port), "--timeout", "240", "--", *mod]


def write_data(root):
    """A tiny CIFAR-10 (python pickle batches) and MNIST (Keras npz)."""
    cdir = root / "data" / "cifar-10-batches-py"
    os.makedirs(cdir)
    x, y = class_pattern_images(100, (32, 32, 3), 10, seed=5)
    x = (x * 255).astype(np.uint8).transpose(0, 3, 1, 2).reshape(100, -1)
    names = [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]
    for i, name in enumerate(names):
        rows = slice(16 * i, 16 * i + 16) if i < 5 else slice(80, 100)
        with open(cdir / name, "wb") as f:
            pickle.dump({b"data": x[rows], b"labels": y[rows].tolist()}, f)
    (train, test) = synthetic_mnist(n_train=512, n_test=256)
    os.makedirs(root / "data" / "mnist")
    np.savez(root / "data" / "mnist" / "mnist.npz", x_train=train[0],
             y_train=train[1], x_test=test[0], y_test=test[1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run's (exit code, output)."""
    root = tmp_path_factory.mktemp("faces")
    write_data(root)
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1",
           "DTDL_OFFLINE": "1"}
    data = ["--dataset-dir", str(root / "data")]
    cifar = [*data, "--epochs", "1", "--batch-size", "32", "--limit-train",
             "64", "--limit-test", "20", "--dtype", "float32"]
    lenet = ["--solver", SOLVER, *data, "--out", str(root / "caffe")]
    est = ["--train_steps", "40", "--save_checkpoints_steps", "20",
           "--batch_size", "32", "--limit-train", "256", "--limit-test",
           "128", *data, "--model_dir", str(root / "est")]
    mx = ["--batch-size", "64", "--num-epochs", "1", "--limit-train", "512",
          "--limit-test", "256", "--disp-batches", "4", *data]
    waves = [
        {"single_device": _cmd("single_device", [
            *cifar, "--out", str(root / "single")]),
         "data_parallel": _cmd("data_parallel", [
             *cifar, "--out", str(root / "dp")])},
        {"imagenet_resnet50": _cmd("imagenet_resnet50", [
            "--steps", "6", "--batch-size", "8", "--image-size", "32",
            "--num-classes", "8", "--train-examples", "64",
            "--warmup-steps", "2", "--log-interval", "3", "--dtype",
            "float32", *data]),
         "serve_lm": _cmd("serve_lm", [
             "--model-size", "tiny", "--n-requests", "5", "--n-slots", "2",
             "--max-new-tokens", "6", "--harvest-lag", "2", "--page-size",
             "16", "--shared-prefix", "16"]),
         "caffe_train": _cmd("caffe_train", [*lenet, "--max-iter", "40"])},
        {"tf_estimator": _cmd("tf_estimator", est),
         "mxnet_kvstore": _cmd("mxnet_kvstore", [
             "--kv-store", "device", *mx, "--out", str(root / "mx")]),
         "caffe_train --snapshot": _cmd("caffe_train", [
             *lenet, "--max-iter", "60", "--snapshot", "latest"])},
        {"tf_estimator again": _cmd("tf_estimator", est),
         "mxnet_kvstore dist_sync": _cmd("mxnet_kvstore", [
             "--kv-store", "dist_sync", *mx, "--out", str(root / "mx2")],
             nproc=2),
         "data_parallel sub-mesh": _cmd("data_parallel", [
             *cifar, "--gpu-nums", "2", "--out", str(root / "dp2")],
             nproc=4)},
    ]
    out = {}
    for wave in waves:
        procs = {k: subprocess.Popen(cmd, cwd=root, env=env, text=True,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT)
                 for k, cmd in wave.items()}
        for k, p in procs.items():
            text, _ = p.communicate(timeout=300)
            out[k] = (p.returncode, text)
    return root, out


def _ok(runs, key):
    rc, text = runs[1][key]
    assert rc == 0, text[-4000:]
    return text


def test_pyramidnet_twins_train_evaluate_and_save(runs):
    root = runs[0]
    for key, out in (("single_device", "single"), ("data_parallel", "dp")):
        text = _ok(runs, key)
        assert re.search(r"Epoch \[0\] \| \[0/2\] \| loss: [\d.]+ \| accuracy",
                         text), text
        assert re.search(r"Epoch \[0\] \| val_loss: [\d.]+ \| val_accuracy",
                         text), text
        assert os.path.exists(root / out / "final.pt")
    assert "DataParallel over 1 local device(s); global batch 32 -> " \
        "32/replica" in _ok(runs, "data_parallel")


def test_resnet50_twin_reports_throughput(runs):
    text = _ok(runs, "imagenet_resnet50")
    assert re.search(r"step 3/6 loss [\d.]+ acc [\d.]+ \| [\d,]+ samples/sec "
                     r"\([\d,]+/chip, 1 chips\) \| [\d.]+ ms/step", text), text
    assert re.search(r"step 6/6", text)
    assert re.search(r"final: train-pool acc [\d.]+", text)


def test_serve_lm_twin_serves(runs):
    text = _ok(runs, "serve_lm")
    assert re.search(r"served 5 requests in [\d.]+s", text), text
    assert re.search(r"ttft p50/p95/p99: [\d.]+ / [\d.]+ / [\d.]+ ms", text)
    assert re.search(r"paged kv \(page_size=16\): prefix hit rate \d+%",
                     text)


def test_caffe_twin_trains_tests_and_resumes(runs):
    root = runs[0]
    text = _ok(runs, "caffe_train")
    assert re.search(r"iter: 0 \| test_loss: [\d.]+ \| test_accuracy", text)
    assert re.search(r"final: \{'loss': [\d.]+, 'accuracy': [\d.]+\}", text)
    m = re.search(r"test: \{'test_loss': [\d.]+, 'test_accuracy': ([\d.]+)",
                  text)
    assert m and float(m[1]) > 0.5, text
    text = _ok(runs, "caffe_train --snapshot")
    assert "resume: ok (iter 40)" in text, text
    assert re.search(r"iter: 40 \| test_loss", text), text
    assert sorted(os.listdir(root / "caffe")) == ["snapshot_40",
                                                  "snapshot_60"]


def test_estimator_twin_trains_evaluates_predicts_and_resumes(runs):
    text = _ok(runs, "tf_estimator")
    m = re.search(r"final eval: \{'loss': [\d.]+, 'accuracy': ([\d.]+), "
                  r"'global_step': 40\.0\}", text)
    assert m and float(m[1]) > 0.5, text
    assert re.search(r"predictions: \[(\d, ){4}\d\] labels:", text)
    again = _ok(runs, "tf_estimator again")
    assert "final eval: {}" in again, again      # restored 40: no training
    assert "global_step/sec" not in again and "split" not in again
    assert re.search(r"predictions: \[(\d, ){4}\d\] labels:", again)


def test_mxnet_twin_fits_over_a_kvstore(runs):
    root = runs[0]
    text = _ok(runs, "mxnet_kvstore")
    assert "kvstore: kind=device rank=0 num_workers=1 width=1" in text
    assert re.search(r"Epoch\[0\] Batch \[7\]\tSpeed: [\d.]+ samples/sec"
                     r"\tloss=[\d.]+\taccuracy=[\d.]+", text), text
    assert re.search(r"Epoch\[0\] Train-accuracy=[\d.]+", text)
    assert re.search(r"Epoch\[0\] Validation-accuracy=[\d.]+", text), text
    assert os.path.exists(root / "mx" / "mxnet_cnn.pt")
    text = _ok(runs, "mxnet_kvstore dist_sync")
    for r in (0, 1):
        assert (f"[rank {r}] kvstore: kind=dist_sync rank={r} num_workers=2 "
                f"width=2") in text, text
    acc = re.findall(r"\[rank (\d)\] Epoch\[0\] Validation-accuracy="
                     r"([\d.]+)", text)
    assert sorted(r for r, _ in acc) == ["0", "1"] and acc[0][1] == acc[1][1]
    assert os.path.exists(root / "mx2" / "mxnet_cnn.pt")


@pytest.mark.parametrize("twin", TWINS)
def test_twin_parses_help_with_the_jax_examples_flags(twin, monkeypatch):
    monkeypatch.setenv("COLUMNS", "1000")     # no flag broken across lines
    port = importlib.import_module(f"dtdl_tpu_torch.examples.{twin}")
    got = set(re.findall(r"--[\w-]+", _help(port, twin)))
    monkeypatch.syspath_prepend(os.path.join(REPO, "examples"))
    jax_twin = importlib.import_module(twin)
    want = set(re.findall(r"--[\w-]+", _help(jax_twin, twin)))
    assert want <= got, sorted(want - got)
    words = [f[2:] for f in got if ("_" in f[2:] or "-" in f[2:])
             and not f.startswith("--no-")]
    assert words and all(f"--{w.replace('-', '_')}" in got and
                         f"--{w.replace('_', '-')}" in got for w in words)


# the spill flags (flag0, flag1), the tenants' flags (flag2-flag4) and
# --trace (flag5) are ported now, tested below and in test_torch_twins.py;
# the other case keeps its id
@pytest.mark.parametrize("flag,item", [
    (["--restore", "w.msgpack"], "A8b's remainder"),
], ids=["flag6-A8b's remainder"])
def test_serve_lm_refuses_unported_flags_by_item(flag, item):
    from dtdl_tpu_torch.examples import serve_lm
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue {item}"):
        serve_lm.main(["--platform", "cpu", *flag])


def test_serve_lm_spills_to_the_host_tier(capsys):
    """--spill-host-mb on a pool too small for the traffic: the evicted
    pages spill to the host tier and the twin prints the JAX script's kv
    spill line.  Every request shares the prefix, so the next request
    always pins it and nothing comes back (restores: tests/
    test_torch_kv_tiers.py)."""
    from dtdl_tpu_torch.examples import serve_lm
    reqs, s, _ = serve_lm.main(
        ["--platform", "cpu", "--page-size", "16", "--n-pages", "8",
         "--shared-prefix", "32", "--n-requests", "10", "--n-slots", "1",
         "--max-new-tokens", "4", "--spill-host-mb", "64"])
    assert all(r.done and r.error is None for r in reqs)
    assert s["pages_spilled"] > 0 and s["spill_bytes"] > 0
    assert s["pages_restored"] == 0 and s["prefill_tokens_saved"] > 0
    assert re.search(r"kv spill: spilled \d+ pages \(\d+ KiB\)  restored "
                     r"0 \(host 0 / disk 0 hits",
                     capsys.readouterr().out)


def test_serve_lm_spill_needs_the_prefix_cache():
    from dtdl_tpu_torch.examples import serve_lm
    with pytest.raises(ValueError, match="prefix_cache=True"):
        serve_lm.main(["--platform", "cpu", "--page-size", "16",
                       "--no-prefix-cache", "--spill-host-mb", "64"])
    with pytest.raises(ValueError, match="paged engine"):
        serve_lm.main(["--platform", "cpu", "--spill-host-mb", "64"])


def test_device_counts_above_the_world_raise():
    from dtdl_tpu_torch.examples import (caffe_train, data_parallel,
                                         single_device)
    with pytest.raises(NotImplementedError,
                       match=r"launch.local --nproc 2 .*distributed_data_"
                             r"parallel"):
        data_parallel.main(["--platform", "cpu", "--gpu-nums", "2"])
    with pytest.raises(NotImplementedError, match=r"launch.local --nproc 4"):
        caffe_train.main(["--platform", "cpu", "--solver", SOLVER,
                          "--gpu", "0,1,2,3"])
    with pytest.raises(SystemExit, match="exactly one device"):
        single_device.main(["--platform", "cpu", "--gpu-nums", "2"])


@pytest.mark.parametrize("n,match", [
    (2, None),
    (1, None),
    (8, r"launch.local --nproc 8"),
])
def test_device_counts_other_than_the_world_raise(monkeypatch, n, match):
    """Both twins' shared rule in a world of 4: a count below the world's
    is a sub-mesh and passes (``data_parallel`` trains over it, the
    sub-mesh run below), one above it needs more processes; 0 and 4
    pass."""
    from dtdl_tpu_torch.examples import data_parallel
    monkeypatch.setattr(data_parallel, "process_count", lambda: 4)
    data_parallel.check_device_count(0, "data_parallel")
    data_parallel.check_device_count(4, "data_parallel")
    if match is None:
        data_parallel.check_device_count(n, "caffe_train")
        return
    with pytest.raises(NotImplementedError, match=match):
        data_parallel.check_device_count(n, "caffe_train")


def test_data_parallel_trains_over_a_sub_mesh(runs):
    """``--gpu-nums 2`` in a gloo world of 4: ranks 0 and 1 train and
    evaluate data-parallel over the global batch (16 rows each), ranks 2
    and 3 sit the run out, and the world exits 0."""
    text = _ok(runs, "data_parallel sub-mesh")
    assert "DataParallel over 2 local device(s); global batch 32 -> " \
        "16/replica" in text
    for rank in (2, 3):
        assert f"process {rank} sits out: --gpu-nums 2" in text
    assert "val_accuracy" in text or "accuracy" in text
