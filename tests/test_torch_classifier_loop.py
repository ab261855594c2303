"""The port's ``train_epoch`` and ``evaluate`` (and the reporter, its
sinks and the step timer) against the JAX package's, on the CPU.

Two epochs of a small PyramidNet over a 48-example synthetic CIFAR-10
split with the train transform (3 steps an epoch, log interval 2, the
``sgd_steplr`` chain of ``tests/test_torch_classifier_train.py`` with a
drop every epoch), then ``evaluate`` over a 37-example split at batch 16,
through both loops (the JAX one in float64, as that file explains),
asynchronous and blocking: the same report payloads (keys, steps and
metrics), and each example of the ragged split counted exactly once.
The loop's state must be, bit for bit, the one its step function gives
over the loader's batches without the loop.

Tolerances: drained metrics and the eval means within 1e-5 relative of
the JAX loop's; the eval of the ragged split exact against a direct
forward over the 37 examples (accuracy) and within 1e-5 (loss).
"""

import sys

import jax
import numpy as np
import pytest
import torch

from dtdl_tpu.data import loader as jloader
from dtdl_tpu.data import synthetic as jsynthetic
from dtdl_tpu.metrics import report as jreport
from dtdl_tpu.parallel.strategy import SingleDevice
from dtdl_tpu.train import (evaluate as jax_evaluate,
                            make_eval_step as jax_eval_step,
                            make_train_step as jax_train_step,
                            train_epoch as jax_train_epoch)
from dtdl_tpu.utils import timing as jtiming
from dtdl_tpu_torch.data import loader as tloader
from dtdl_tpu_torch.data.datasets import CIFAR10_MEAN, CIFAR10_STD
from dtdl_tpu_torch.data.loader import DataLoader, LimitBatches
from dtdl_tpu_torch.data.synthetic import synthetic_cifar10
from dtdl_tpu_torch.parallel import DataParallel
from dtdl_tpu_torch.parallel import SingleDevice as TorchSingleDevice
from dtdl_tpu_torch.runtime import local_mesh
from dtdl_tpu_torch.metrics.report import (Accumulator, JsonlSink, Reporter,
                                           StdoutSink, TensorBoardSink)
from dtdl_tpu_torch.obs import Observer
from dtdl_tpu_torch.train.loop import evaluate, train_epoch
from dtdl_tpu_torch.train.optim import sgd
from dtdl_tpu_torch.train.step import (make_eval_step, make_predict_step,
                                       make_train_step)
from dtdl_tpu_torch.utils.timing import StepTimer, fmt_timedelta
from test_torch_classifier_train import (LR, pair, sgd_steplr_pair,  # noqa: F401
                                         x64)
import optax

# small shapes: one intra-op thread each leaves the cores to the other
# test workers
torch.set_num_threads(1)


class ListSink:
    def __init__(self):
        self.payloads = []

    def write(self, payload):
        self.payloads.append(dict(payload))

    def close(self):
        pass


def loaders(module, transform_mod, data, batch=16, device=None):
    (xtr, ytr), (xte, yte) = data
    kw = {} if device is None else {"device": device}
    train = module.DataLoader(
        {"image": xtr, "label": ytr}, batch, seed=3,
        transform=transform_mod.cifar10_train_transform(CIFAR10_MEAN,
                                                        CIFAR10_STD), **kw)
    val = module.DataLoader(
        {"image": xte, "label": yte}, batch, shuffle=False, drop_last=False,
        transform=transform_mod.normalize_transform(CIFAR10_MEAN,
                                                    CIFAR10_STD), **kw)
    return train, val


@pytest.mark.parametrize("sync_every_step", [False, True])
def test_train_epoch_and_evaluate_match_the_jax_loop(sync_every_step):
    """Two epochs of 3 steps (log_interval 2) and a 37-example eval at
    batch 16 (the tail of 5 padded and masked), through both loops."""
    data = synthetic_cifar10(n_train=48, n_test=37)
    jdata = jsynthetic.synthetic_cifar10(n_train=48, n_test=37)
    for a, b in zip(jax.tree.leaves(data), jax.tree.leaves(jdata)):
        assert np.array_equal(a, b)
    jtx, ttx = sgd_steplr_pair(steps_per_epoch=3, step_epochs=1)
    jstate, tstate, _ = pair("pyramidnet", jtx, ttx)
    jtrain, jval = loaders(jloader, jloader, jdata)
    ttrain, tval = loaders(tloader, tloader, data, device="cpu")
    jsink, tsink = ListSink(), ListSink()
    jstep, tstep = jax_train_step(), make_train_step()
    for epoch in range(2):
        jstate, jmeans = jax_train_epoch(
            jstep, jstate, jtrain, SingleDevice(),
            reporter=jreport.Reporter([jsink]), epoch=epoch, log_interval=2,
            sync_every_step=sync_every_step)
        tstate, tmeans = train_epoch(
            tstep, tstate, ttrain, reporter=Reporter([tsink]), epoch=epoch,
            log_interval=2, sync_every_step=sync_every_step)
        assert set(tmeans) == set(jmeans) == {"loss", "accuracy"}
        for k in jmeans:
            assert tmeans[k] == pytest.approx(jmeans[k], rel=1e-5)
    jres = jax_evaluate(jax_eval_step(), jstate, jval, SingleDevice(),
                        reporter=jreport.Reporter([jsink]), epoch=1)
    tres = evaluate(make_eval_step(), tstate, tval,
                    reporter=Reporter([tsink]), epoch=1)
    for k in jres:
        assert tres[k] == pytest.approx(jres[k], rel=1e-5)
    assert len(tsink.payloads) == len(jsink.payloads)
    timing = {"batch_time", "epoch_time", "avg_batch_time"}
    for tp, jp in zip(tsink.payloads, jsink.payloads):
        assert set(tp) == set(jp)
        for k, v in jp.items():
            if k in timing:
                assert tp[k] >= 0.0
            elif isinstance(v, float):
                assert tp[k] == pytest.approx(v, rel=1e-5), k
            else:
                assert tp[k] == v, k
    steps = [p["step"] for p in tsink.payloads if "step" in p]
    assert steps == [0, 2, 0, 2]
    # the loop is plumbing: its state is the steps' own over the loader's
    # batches, bit for bit
    _, plain, _ = pair("pyramidnet", jtx, ttx)
    for epoch in range(2):
        ttrain.set_epoch(epoch)
        for batch in ttrain:
            plain, _ = tstep(plain, batch)
    for a, b in zip(plain.model.state_dict().values(),
                    tstate.model.state_dict().values()):
        assert torch.equal(a, b)


def test_evaluate_counts_a_ragged_tail_exactly_once():
    """37 examples at batch 16: 16 + 16 + 5 real rows, the last batch
    padded to 16 with its last row repeated and masked out; the accuracy
    and loss are the means over the 37 alone."""
    _, tstate, _ = pair("pyramidnet", optax.sgd(LR), sgd(LR))
    (_, _), (xte, yte) = synthetic_cifar10(n_train=1, n_test=37)
    seen = []

    def eval_step(state, batch):
        seen.append((len(batch["label"]), float(batch["mask"].sum())))
        return make_eval_step()(state, batch)

    val = DataLoader({"image": xte, "label": yte}, 16, shuffle=False,
                     drop_last=False, device="cpu")
    res = evaluate(eval_step, tstate, val)
    assert seen == [(16, 16.0), (16, 16.0), (16, 5.0)]
    tstate.model.eval()
    with torch.no_grad():
        logits = tstate.model(torch.from_numpy(xte))
    labels = torch.from_numpy(yte).long()
    want_acc = int((logits.argmax(-1) == labels).sum()) / 37
    want_loss = float(torch.nn.functional.cross_entropy(logits, labels))
    assert res["accuracy"] == pytest.approx(want_acc, abs=1e-12)
    assert res["loss"] == pytest.approx(want_loss, rel=1e-5)
    # a limited view evaluates its first batches only
    assert evaluate(make_eval_step(), tstate, LimitBatches(val, 1)) == \
        pytest.approx(evaluate(make_eval_step(), tstate, DataLoader(
            {"image": xte[:16], "label": yte[:16]}, 16, shuffle=False,
            device="cpu")))


def test_refusals_name_their_roadmap_items(tmp_path):
    _, tstate, _ = pair("mlp", optax.sgd(LR), sgd(LR))
    train = DataLoader({"image": np.zeros((8, 784), np.float32),
                        "label": np.zeros(8, np.int32)}, 4, device="cpu")
    step = make_train_step()
    # unroll is served (A5's module half): k steps a bundle, every one
    # of them drained
    _, means = train_epoch(step, tstate, train, unroll=2)
    assert set(means) == {"loss", "accuracy"}
    # the guard is served (A13b): the loop feeds it every drained step
    from dtdl_tpu_torch.resil import StepGuard
    guard = StepGuard()
    train_epoch(make_train_step(guard=guard), tstate, train, guard=guard)
    assert guard.n_steps == len(train) and guard.n_bad == 0
    # the observer is served (A13a): the loop's spans land on its trace
    obs = Observer(trace=True, sentinel=None)
    train_epoch(step, tstate, train, observer=obs)
    evaluate(make_eval_step(), tstate, train, observer=obs)
    names = [e["name"] for e in obs.tracer.to_chrome()["traceEvents"]]
    assert {"data", "dispatch", "drain"} <= set(names)
    # the port's own strategies are accepted; a JAX strategy object is not
    # one of them
    train_epoch(step, tstate, train, strategy=TorchSingleDevice())
    evaluate(make_eval_step(DataParallel(local_mesh())), tstate, train,
             strategy=DataParallel(local_mesh()))
    with pytest.raises(TypeError, match="not a dtdl_tpu_torch strategy"):
        train_epoch(step, tstate, train, strategy=SingleDevice())
    with pytest.raises(ValueError, match="unroll"):
        train_epoch(step, tstate, train, unroll=0)
    with pytest.raises(TypeError, match="not a dtdl_tpu_torch strategy"):
        evaluate(make_eval_step(), tstate, train, strategy=SingleDevice())
    for make in (make_train_step, make_eval_step, make_predict_step):
        make(TorchSingleDevice())
        make(DataParallel(local_mesh()))
        with pytest.raises(TypeError, match="not a dtdl_tpu_torch strategy"):
            make(SingleDevice())
    from dtdl_tpu_torch.resil import StepGuard
    _, m = make_train_step(guard=StepGuard())(tstate, next(iter(train)))
    assert float(m["bad_step"]) == 0.0 and float(m["grad_norm"]) > 0
    # profile_dir traces the epoch (utils.profiling); TensorBoardSink
    # without a writer package (as on the card machine) is a no-op
    train_epoch(step, tstate, train, profile_dir=str(tmp_path / "prof"))
    trace = (tmp_path / "prof" / "trace.json").read_text()
    assert "train_step#0" in trace and "train_step#1" in trace
    with pytest.MonkeyPatch.context() as mp:
        for mod in ("torch.utils.tensorboard", "tensorboardX"):
            mp.setitem(sys.modules, mod, None)
        with TensorBoardSink(str(tmp_path / "runs")) as tb:
            tb.write({"step": 0, "loss": 1.0})
    assert not (tmp_path / "runs").exists()


def test_reporter_sinks_timer_and_accumulator_match_jax(tmp_path, capsys):
    payload = {"epoch": 1, "step": 3, "steps_per_epoch": 9, "loss": 0.25,
               "accuracy": torch.tensor(0.5), "batch_time": 123.456}
    jpayload = {**payload, "accuracy": np.float32(0.5)}
    jreport.Reporter([jreport.StdoutSink("r0")]).report(jpayload)
    want = capsys.readouterr().out
    Reporter([StdoutSink("r0")]).report(payload)
    assert capsys.readouterr().out == want
    with Reporter([JsonlSink(str(tmp_path / "log.jsonl"))]) as rep:
        rep.report(payload)
    line = (tmp_path / "log.jsonl").read_text().splitlines()
    assert len(line) == 1 and '"accuracy": 0.5' in line[0]
    acc, jacc = Accumulator(), jreport.Accumulator()
    for m in ({"loss": 1.0}, {"loss": 2.0, "accuracy": 0.5}):
        acc.add(m, weight=2)
        jacc.add(m, weight=2)
    assert acc.means() == jacc.means()
    assert fmt_timedelta(3725.9) == jtiming.fmt_timedelta(3725.9)
    timer = StepTimer(blocking=False)
    for _ in range(4):
        timer.step()
    assert timer.total_steps == 4 and timer.last_step_s == 0.0
    assert timer.sync(torch.zeros(())) > 0.0
    assert timer.avg_step_s == pytest.approx(timer.last_step_s)
    blocking = StepTimer()
    assert blocking.step(torch.zeros(())) > 0.0 and blocking.total_steps == 1
