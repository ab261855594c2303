"""The port's Chainer-style ``Trainer`` and its extensions
(``dtdl_tpu_torch.train.trainer``) against the JAX package's, on the CPU,
and its snapshot/resume.

* **Reports**: one flax MLP tree in both packages (the JAX state in
  float64, as ``tests/test_torch_classifier_train.py`` explains), the
  same 64 synthetic examples at batch 16 (4 iterations an epoch), an
  ``Evaluator`` over a ragged 37-example split, ``LogReport`` and
  ``PrintReport``: the same records (losses within 1e-5 relative,
  accuracies, epochs and iterations exact; ``elapsed_time`` is a clock)
  and the same table layout.
* **Resume**: a run stopped mid-epoch (iteration 6 of 4-iteration
  epochs) or at an epoch boundary (iteration 8), snapshotted, and taken
  up by a fresh ``Trainer`` and ``Checkpointer`` through ``resume()``,
  ends bitwise equal to the uninterrupted port run (params, Adam
  moments, step, the ``LogReport`` records), and within 1e-5 of the
  uninterrupted JAX run's parameters.  The ``tiny`` LM through
  ``make_lm_train_step`` the same (its JAX run in f32, bounded as
  ``tests/test_torch_train.py`` bounds adamw steps); SIGTERM mid-epoch
  through ``LoaderFaults`` and a ``PreemptionWatcher`` the same.
* **Two gloo ranks**: a ``DataParallel`` Trainer's snapshot/resume
  leaves every parameter bitwise equal across ranks and to the
  uninterrupted run, and only rank 0 writes (the ranks are spawned
  through ``dtdl_tpu_torch.launch.local``, running this file as
  ``__main__``; the worker imports no JAX).
* **Refusals**: ``guard=`` and ``watchdog=`` name ROADMAP A13b;
  ``observer=`` and ``exporter=`` are served (spans, goodput windows,
  one exporter point per drain and a forced final one); ``dump_graph``
  writes the module tree and never runs a step.
"""

import argparse
import json
import os
import socket
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from dtdl_tpu_torch import bridge  # noqa: E402
from dtdl_tpu_torch.data.loader import DataLoader  # noqa: E402
from dtdl_tpu_torch.data.sharding import ShardedSampler  # noqa: E402
from dtdl_tpu_torch.launch.local import launch_local  # noqa: E402
from dtdl_tpu_torch.models import MLP  # noqa: E402
from dtdl_tpu_torch.obs import (GoodputMeter, MetricsExporter,  # noqa: E402
                                Observer)
from dtdl_tpu_torch.parallel import DataParallel, SingleDevice  # noqa: E402
from dtdl_tpu_torch.parallel.collectives import tree_digest  # noqa: E402
from dtdl_tpu_torch.runtime import (build_mesh, initialize,  # noqa: E402
                                    process_index)
from dtdl_tpu_torch.train import (Evaluator, LogReport,  # noqa: E402
                                  PrintReport, ProgressSummary, Trainer,
                                  dump_graph, init_state, make_eval_step,
                                  make_train_step, snapshot)
from dtdl_tpu_torch.train.optim import adam  # noqa: E402
from dtdl_tpu_torch.train.state import state_to_tree  # noqa: E402

torch.set_num_threads(1)

N, BATCH, DIM = 64, 16, 48
PER_EPOCH = N // BATCH


def mlp_data(n=N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, DIM)).astype(np.float32)
    y = (x[:, :10].argmax(-1)).astype(np.int32)     # learnable labels
    return x, y


def port_mlp(tree=None, seed=1):
    m = MLP(n_units=24, in_features=DIM, device="cpu", seed=seed)
    if tree is not None:
        bridge.load_flax_params(m, tree, device="cpu")
    return m


def port_trainer(out, stop, tree=None, strategy=None, loader=None, **kw):
    strategy = strategy or SingleDevice()
    x, y = mlp_data()
    state = strategy.replicate(init_state(port_mlp(tree), None, adam(1e-2),
                                          device="cpu"))
    loader = loader or DataLoader({"image": x, "label": y}, BATCH, seed=5,
                                  device="cpu")
    return Trainer(state, make_train_step(strategy), loader, strategy,
                   stop_trigger=stop, out=str(out), **kw)


def records(log):
    return [{k: v for k, v in r.items() if k != "elapsed_time"}
            for r in log.records]


def assert_same_state(a, b):
    fa = bridge.flatten(state_to_tree(a))
    fb = bridge.flatten(state_to_tree(b))
    assert fa.keys() == fb.keys()
    for k in fa:
        if isinstance(fa[k], torch.Tensor):
            assert torch.equal(fa[k], fb[k]), k
        else:
            assert fa[k] == fb[k], k


# ---- against the JAX Trainer --------------------------------------------------

def jax_run(out, stop, tree, val, extensions=()):
    """The JAX Trainer over the same data from the same tree, f64."""
    import jax
    import jax.numpy as jnp
    import optax
    from dtdl_tpu.data.loader import DataLoader as JaxLoader
    from dtdl_tpu.models import MLP as JaxMLP
    from dtdl_tpu.parallel import SingleDevice as JaxSingle
    from dtdl_tpu.train import (Evaluator as JEvaluator, LogReport as JLog,
                                PrintReport as JPrint, TrainState,
                                Trainer as JTrainer,
                                make_eval_step as jeval,
                                make_train_step as jstep)
    with jax.enable_x64():
        x, y = mlp_data()
        state = TrainState.create(
            apply_fn=JaxMLP(n_units=24, dtype=jnp.float64).apply,
            params=jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree),
            tx=optax.adam(1e-2))
        strat = JaxSingle()
        tr = JTrainer(state, jstep(strat), JaxLoader(
            {"image": x, "label": y}, BATCH, seed=5), strat,
            stop_trigger=stop, out=str(out))
        log = JLog()
        if "eval" in extensions:
            vx, vy = val
            tr.extend(JEvaluator(jeval(strat), JaxLoader(
                {"image": vx, "label": vy}, BATCH, shuffle=False,
                drop_last=False), strat))
        tr.extend(log)
        if "print" in extensions:
            tr.extend(JPrint(["epoch", "iteration", "loss", "accuracy",
                              "val_loss", "val_accuracy"], log))
        tr.run()
        return tr, log


def test_log_and_print_report_match_the_jax_trainer(tmp_path, capsys):
    tree = bridge.state_dict_to_flax(port_mlp())
    val = mlp_data(37, seed=9)
    _, jlog = jax_run(tmp_path / "jax", (2, "epoch"), tree, val,
                      ("eval", "print"))
    jax_out = capsys.readouterr().out
    tr = port_trainer(tmp_path / "port", (2, "epoch"), tree)
    log = LogReport()
    tr.extend(Evaluator(make_eval_step(), DataLoader(
        {"image": val[0], "label": val[1]}, BATCH, shuffle=False,
        drop_last=False, device="cpu"), SingleDevice()))
    tr.extend(log)
    tr.extend(PrintReport(["epoch", "iteration", "loss", "accuracy",
                           "val_loss", "val_accuracy"], log))
    tr.run()
    out = capsys.readouterr().out
    got, want = records(log), records(jlog)
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    for g, w in zip(got, want):
        assert (g["epoch"], g["iteration"]) == (w["epoch"], w["iteration"])
        for k in ("loss", "val_loss"):
            assert g[k] == pytest.approx(w[k], rel=1e-5), k
        for k in ("accuracy", "val_accuracy"):
            assert g[k] == pytest.approx(w[k], abs=1e-12), k
    assert out.splitlines()[0] == jax_out.splitlines()[0]   # the header
    assert len(out.splitlines()) == len(jax_out.splitlines()) == 3
    lines = (tmp_path / "port" / "log.jsonl").read_text().splitlines()
    assert [json.loads(line)["iteration"] for line in lines] == [4, 8]


@pytest.mark.parametrize("stop,skip,epoch", [
    ((6, "iteration"), 2, 1),         # mid-epoch
    ((2, "epoch"), 0, 2)])            # epoch boundary (iteration 8)
def test_resume_is_bitwise_the_uninterrupted_run(tmp_path, stop, skip,
                                                 epoch):
    total = 12
    tree = bridge.state_dict_to_flax(port_mlp())
    ref = port_trainer(tmp_path / "a", (total, "iteration"), tree)
    ref_log = LogReport()
    ref.extend(ref_log, trigger=(2, "iteration"))
    ref.run()

    first = port_trainer(tmp_path / "b", stop, tree)
    first_log = LogReport()
    first.extend(first_log, trigger=(2, "iteration"))
    first.extend(snapshot(), trigger=stop)
    first.run()
    stop_at = first.iteration
    assert (first.epoch, first.iteration_in_epoch) == (epoch, skip)

    # a fresh Trainer from other weights: resume() must replace them
    second = port_trainer(tmp_path / "b", (total, "iteration"),
                          bridge.state_dict_to_flax(port_mlp(seed=7)))
    second_log = LogReport()
    second.extend(second_log, trigger=(2, "iteration"))
    assert second.resume()
    assert second.iteration == stop_at
    assert (second.epoch, second._skip_batches) == (epoch, skip)
    second.run()
    assert second.iteration == total and second.state.step == total
    assert_same_state(ref.state, second.state)
    assert records(second_log) == records(ref_log)

    # the uninterrupted JAX run from the same tree
    jtr, _ = jax_run(tmp_path / "jax", (total, "iteration"), tree, None)
    want = bridge.flatten(jtr.state.params)
    got = bridge.flatten(bridge.state_dict_to_flax(second.state.model))
    for path in want:
        np.testing.assert_allclose(got[path], np.asarray(want[path]),
                                   rtol=0, atol=1e-5, err_msg=path)


def test_tiny_lm_resume_is_bitwise_and_matches_jax(tmp_path):
    """The tiny LM (f32, dense attention) under adamw through
    make_lm_train_step: 5 iterations of 3-batch epochs uninterrupted
    against 2, snapshot, resume, 3 more; the JAX Trainer's run of the
    same tree and tokens within the adamw bound of
    tests/test_torch_train.py (atol 1e-5 on all but 0.1%, 2·lr per step
    on all)."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp
    import optax
    from dtdl_tpu.data.loader import DataLoader as JaxLoader
    from dtdl_tpu.models import transformer as jtr
    from dtdl_tpu.parallel import SingleDevice as JaxSingle
    from dtdl_tpu.train import (TrainState, Trainer as JTrainer,
                                make_lm_train_step as jlm_step)
    from dtdl_tpu_torch.models.transformer import transformer_lm
    from dtdl_tpu_torch.train.optim import adamw
    from dtdl_tpu_torch.train.step import make_lm_train_step

    lr, steps = 3e-3, 5
    jm = jtr.transformer_lm("tiny", dtype=jnp.float32, max_seq=48,
                            attn_impl="dense")
    params = jax.device_get(fnn.unbox(jm.init(
        jax.random.PRNGKey(2), jnp.zeros((1, 4), jnp.int32))["params"]))
    tokens = np.random.default_rng(4).integers(0, 256, (12, 33)).astype(
        np.int32)

    def port(out, stop, snap=None):
        tm = transformer_lm("tiny", device="cpu", seed=None,
                            dtype=torch.float32, max_seq=48,
                            attn_impl="dense")
        bridge.load_flax_params(tm, params, device="cpu")
        tr = Trainer(init_state(tm, None, adamw(lr), device="cpu"),
                     make_lm_train_step(), DataLoader(
                         {"tokens": tokens}, 4, seed=1, device="cpu"),
                     SingleDevice(), stop_trigger=(stop, "iteration"),
                     out=str(out))
        if snap:
            tr.extend(snapshot(), trigger=(snap, "iteration"))
        return tr

    ref = port(tmp_path / "a", steps)
    ref.run()
    port(tmp_path / "b", 2, snap=2).run()
    resumed = port(tmp_path / "b", steps)
    assert resumed.resume() and resumed._skip_batches == 2
    resumed.run()
    assert_same_state(ref.state, resumed.state)

    state = TrainState.create(apply_fn=jm.apply, params=jax.tree.map(
        jnp.array, params), tx=optax.adamw(lr, weight_decay=1e-4))
    jt = JTrainer(state, jlm_step(), JaxLoader({"tokens": tokens}, 4,
                                               seed=1), JaxSingle(),
                  stop_trigger=(steps, "iteration"),
                  out=str(tmp_path / "jax"))
    jt.run()
    want = bridge.flatten(jax.device_get(jt.state.params))
    got = bridge.flatten(bridge.state_dict_to_flax(resumed.state.model))
    n_far = n_all = 0
    for path, w in want.items():
        err = np.abs(got[path] - w)
        assert err.max() <= 2 * lr * steps, path
        n_far += int((err > 1e-5).sum())
        n_all += err.size
    assert n_far <= 1e-3 * n_all, (n_far, n_all)


def test_preemption_snapshot_then_exact_resume(tmp_path):
    """SIGTERM at the 5th batch (mid-epoch 1) → snapshot at that
    boundary → a fresh Trainer resumes and ends bitwise equal to an
    uninterrupted run."""
    from dtdl_tpu_torch.resil import (FaultPlan, LoaderFaults,
                                      PreemptionWatcher)
    x, y = mlp_data()
    plan = FaultPlan().at("loader", 5, "sigterm")
    with PreemptionWatcher() as watcher:
        loader = LoaderFaults(DataLoader({"image": x, "label": y}, BATCH,
                                         seed=5, device="cpu"), plan)
        t1 = port_trainer(tmp_path / "p", (2, "epoch"), loader=loader,
                          preempt=watcher)
        t1.run()
    assert t1.preempted and watcher.count == 1
    assert plan.log == [("loader", 5, "sigterm")]
    assert 0 < t1.iteration < 2 * PER_EPOCH
    assert (tmp_path / "p" / f"snapshot_{t1.iteration}" /
            "_DTDL_COMMIT").exists()

    t2 = port_trainer(tmp_path / "p", (2, "epoch"))
    assert t2.resume() and t2.iteration == t1.iteration
    t2.run()
    assert not t2.preempted and t2.epoch == 2
    ref = port_trainer(tmp_path / "ref", (2, "epoch"))
    ref.run()
    assert_same_state(ref.state, t2.state)


def test_refusals_dump_graph_and_progress_summary(tmp_path, capsys):
    for name in ("guard", "watchdog"):
        with pytest.raises(NotImplementedError, match="A13b"):
            port_trainer(tmp_path / name, (1, "epoch"), **{name: object()})
    obs = Observer(trace=True, sentinel=None,
                   goodput=GoodputMeter(samples_per_step=BATCH))
    points = []
    sink = type("ListSink", (), {"write": lambda self, p: points.append(p),
                                 "close": lambda self: None})()
    ex = MetricsExporter([sink], interval_s=0.0)
    ex.add_source("goodput", obs.goodput.export_window)
    tr = port_trainer(tmp_path / "obs", (1, "epoch"), observer=obs,
                      exporter=ex)
    tr.extend(LogReport(), trigger=(1, "epoch"))
    tr.run()
    names = [e["name"] for e in obs.tracer.to_chrome()["traceEvents"]]
    assert names.count("dispatch") == tr.iteration and "drain" in names
    # one point at the epoch's drain, one forced at the end of run()
    assert ex.n_snapshots == 2 == len(points)
    assert points[0]["goodput_steps"] == tr.iteration
    assert "goodput_steps" not in points[1]      # nothing settled since
    assert "samples_per_sec" in tr.observation
    x, y = mlp_data()
    tr = port_trainer(tmp_path / "g", (1, "epoch"))
    before = bridge.flatten(state_to_tree(tr.state))["params/Dense_0/kernel"]
    before = before.clone()
    ext = dump_graph({"image": x[:BATCH], "label": y[:BATCH]})
    ext(tr)
    text = (tmp_path / "g" / "train_step.graph.txt").read_text()
    assert "Dense_0/kernel  (48, 24)  torch.float32" in text
    assert "image  (16, 48)  float32" in text
    assert tr.state.step == 0 and torch.equal(
        before, bridge.flatten(state_to_tree(tr.state))[
            "params/Dense_0/kernel"])
    # a failure is logged, never raised
    broken = dump_graph({"image": None})
    broken(tr)
    tr.extend(ProgressSummary())
    tr.run()
    out = capsys.readouterr().out
    assert "Epoch [1]" in out and "epoch_time" in out


# ---- two gloo ranks -----------------------------------------------------------

def worker(argv):
    """One rank: an uninterrupted DataParallel Trainer run, then a run
    stopped mid-epoch with a snapshot and a fresh Trainer's resume; the
    digests and this rank's torch.save calls."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--out")
    ap.add_argument("--coordinator")
    ap.add_argument("--num-processes", type=int)
    ap.add_argument("--process-id", type=int)
    a = ap.parse_args(argv)
    initialize(a.coordinator, a.num_processes, a.process_id, device="cpu")
    saves = []
    real_save = torch.save
    torch.save = lambda *args, **kw: (saves.append(1), real_save(*args,
                                                                 **kw))[1]
    strategy = DataParallel(build_mesh())
    x, y = mlp_data()

    def run(out, stop, snap=None, resume=False):
        loader = DataLoader({"image": x, "label": y}, BATCH // 2,
                            sampler=ShardedSampler(N, 2, a.process_id,
                                                   seed=5), device="cpu")
        tr = port_trainer(out, (stop, "iteration"), strategy=strategy,
                          loader=loader)
        log = LogReport()
        tr.extend(log, trigger=(2, "iteration"))
        if snap:
            tr.extend(snapshot(), trigger=(snap, "iteration"))
        if resume:
            assert tr.resume()
        tr.run()
        return tr, log

    ref, ref_log = run(os.path.join(a.out, "ref"), 10)
    run(os.path.join(a.out, "b"), 6, snap=6)
    got, got_log = run(os.path.join(a.out, "b"), 10, resume=True)
    print("trainer_result " + json.dumps({
        "rank": process_index(),
        "ref": tree_digest(state_to_tree(ref.state)),
        "resumed": tree_digest(state_to_tree(got.state)),
        "same_log": records(got_log) == records(ref_log),
        "saves": len(saves)}), flush=True)


if __name__ == "__main__":
    worker(sys.argv[1:])
    sys.exit(0)


def test_two_gloo_ranks_resume_bitwise_and_only_rank0_writes(tmp_path,
                                                             capfd):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    rc = launch_local([os.path.abspath(__file__), "--out", str(tmp_path)],
                      nproc=2, port=port, timeout=300,
                      env_extra={"PYTHONPATH": REPO})
    out = capfd.readouterr().out
    assert rc == 0, out[-4000:]
    res = {r["rank"]: r for r in (
        json.loads(line.split("trainer_result ", 1)[1])
        for line in out.splitlines() if "trainer_result " in line)}
    assert sorted(res) == [0, 1], out[-4000:]
    assert res[0]["ref"] == res[1]["ref"] == res[0]["resumed"] == \
        res[1]["resumed"]
    assert res[0]["same_log"] and res[1]["same_log"]
    assert res[0]["saves"] == 1 and res[1]["saves"] == 0
    assert sorted(os.listdir(tmp_path / "b")) == [
        "log.jsonl", "snapshot_6", "snapshot_6.meta.json"]
