"""The port's step guard (dtdl_tpu_torch/resil/guard.py) against the JAX
package's, and its own contracts, on the CPU.

Against JAX (one flax tree bridged into both packages, the same numpy
batches, NaN batches injected with ``poison_batch`` and a
``grad_norm_limit`` that flags one finite step): the tiny LM (2 layers,
d_model 64, adamw, NaN in the mask; the JAX model's plain attention,
the port's flash attention in its plain CPU version) and a small
PyramidNet with BatchNorm (sgd + momentum, NaN images), f32 in both.
The ``bad_step`` flags are identical, ``grad_norm`` within rtol 1e-5
(NaN where JAX's is NaN), the losses within atol 1e-5; the drained
metrics fed to each package's guard under ``skip``, ``raise`` and
``rollback`` escalate and raise at the same steps with the same
exceptions.

The port's contracts, bitwise: guarded with no fault equals unguarded;
``skip`` equals the run with the bad batches dropped (the optimizer's
step counts, the moments and BatchNorm's statistics included); the guard
adds no host conversion to the step; ``train_epoch`` and the Trainer
feed it (``raise``, escalation, ``rollback`` to the last snapshot);
``window()`` feeds an exporter and the training SLOs; under
``DataParallel`` on a gloo world of 2 a NaN on one rank's batch is
flagged on both and the replicas stay bitwise equal.
"""

import functools
import os
import textwrap
import time

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dtdl_tpu import resil as jresil
from dtdl_tpu.models import transformer as jtr
from dtdl_tpu.train import (TrainState as JaxTrainState,
                            make_lm_train_step as jax_lm_step,
                            make_train_step as jax_train_step)
from dtdl_tpu_torch import bridge
from dtdl_tpu_torch.data.loader import DataLoader
from dtdl_tpu_torch.launch import local
from dtdl_tpu_torch.models import MLP
from dtdl_tpu_torch.models.transformer import transformer_lm
from dtdl_tpu_torch.obs import (GoodputMeter, MetricsExporter, SLOEvaluator,
                                default_train_slos)
from dtdl_tpu_torch.resil import (AnomalousStepError, FaultPlan,
                                  GuardEscalationError, GuardRollback,
                                  LoaderFaults, StepGuard, poison_batch)
from dtdl_tpu_torch.resil.guard import GuardDeviceError
from dtdl_tpu_torch.train import Trainer, snapshot
from dtdl_tpu_torch.train.loop import train_epoch
from dtdl_tpu_torch.train.optim import (adamw, exponential_decay,
                                        multi_steps, sgd)
from dtdl_tpu_torch.train.state import init_state, state_to_tree
from dtdl_tpu_torch.train.step import make_lm_train_step, make_train_step
from test_torch_classifier_train import MODELS, jax_state, pair
from test_torch_train import MAX_SEQ

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_STEPS = 6
POISONED = (1, 3)
LR = 1e-3


# ---- the two problems, in both packages ------------------------------------

@functools.lru_cache(maxsize=None)
def lm_params():
    jm = jtr.transformer_lm("tiny", dtype=jnp.float32, max_seq=MAX_SEQ)
    return jax.device_get(fnn.unbox(jm.init(
        jax.random.PRNGKey(2), jnp.zeros((1, 4), jnp.int32))["params"]))


def lm_batches(poisoned=POISONED):
    rng = np.random.default_rng(0)
    out = [{"tokens": rng.integers(0, 256, (4, 17)).astype(np.int32),
            "mask": np.ones((4, 16), np.float32)} for _ in range(N_STEPS)]
    return [poison_batch(b) if i in poisoned else b
            for i, b in enumerate(out)]


def bn_batches(poisoned=POISONED):
    _, _, shape, classes = MODELS["pyramidnet"]
    rng = np.random.default_rng(1)
    out = [{"image": rng.normal(size=shape).astype(np.float32),
            "label": rng.integers(0, classes, shape[0]).astype(np.int32)}
           for _ in range(N_STEPS)]
    return [poison_batch(b) if i in poisoned else b
            for i, b in enumerate(out)]


def port_lm():
    m = transformer_lm("tiny", device="cpu", seed=None,
                       dtype=torch.float32, max_seq=MAX_SEQ)
    bridge.load_flax_params(m, lm_params(), device="cpu")
    return init_state(m, None, adamw(LR), device="cpu")


@functools.lru_cache(maxsize=None)
def bn_tree():
    return pair("pyramidnet", optax.sgd(0.1, momentum=0.9),
                sgd(0.1, momentum=0.9))[2]


def port_bn():
    m = MODELS["pyramidnet"][1]()
    bridge.load_flax_params(m, bn_tree()["params"],
                            bn_tree().get("batch_stats"), device="cpu")
    return init_state(m, None, sgd(0.1, momentum=0.9), device="cpu")


PROBLEMS = {"lm": (port_lm, make_lm_train_step, lm_batches),
            "bn": (port_bn, make_train_step, bn_batches)}


def run_port(kind, guard=None, batches=None):
    make_state, make_step, mk_batches = PROBLEMS[kind]
    state = make_state()
    step = make_step(guard=guard)
    metrics = []
    for b in (mk_batches() if batches is None else batches):
        state, m = step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def run_jax(kind, guard):
    if kind == "lm":
        jm = jtr.transformer_lm("tiny", dtype=jnp.float32, max_seq=MAX_SEQ,
                                attn_impl="dense")
        state = JaxTrainState.create(
            apply_fn=jm.apply, params=jax.tree.map(jnp.array, lm_params()),
            tx=optax.adamw(LR, weight_decay=1e-4))
        step = jax_lm_step(guard=guard)
    else:
        state = jax_state("pyramidnet", bn_tree(),
                          optax.sgd(0.1, momentum=0.9), dtype=jnp.float32)
        step = jax_train_step(guard=guard)
    metrics = []
    for b in PROBLEMS[kind][2]():
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics


def limit_between(norms):
    """A grad-norm limit in the widest relative gap of the finite norms,
    so that at least one finite step is over it and no norm is near it."""
    finite = sorted(n for n in norms if np.isfinite(n))
    gaps = [(finite[i + 1] / finite[i], i) for i in range(len(finite) - 1)]
    _, i = max(gaps)
    return float(np.sqrt(finite[i] * finite[i + 1]))


def escalations(guard_cls, policy, metrics, errors):
    """Feed the drained dicts to a fresh guard of ``policy``; per step,
    the exception's class name (or None)."""
    g = guard_cls(policy, max_consecutive=2, max_rollbacks=1)
    out = []
    for vals in metrics:
        try:
            g.observe(vals)
            out.append(None)
        except errors as e:
            out.append(type(e).__name__)
    return out, g.summary()


@functools.lru_cache(maxsize=None)
def both_runs(kind):
    _, free = run_port(kind, StepGuard("skip", max_consecutive=99))
    limit = limit_between([m["grad_norm"] for m in free])
    _, got = run_port(kind, StepGuard("skip", grad_norm_limit=limit))
    want = run_jax(kind, jresil.StepGuard("skip", grad_norm_limit=limit))
    return got, want, limit


# ---- against JAX ------------------------------------------------------------

@pytest.mark.parametrize("kind", ["lm", "bn"])
def test_guard_flags_norms_losses_and_escalations_match_jax(kind):
    got, want, limit = both_runs(kind)
    flags = [m["bad_step"] for m in got]
    assert flags == [m["bad_step"] for m in want]
    # the two NaN batches and at least one finite step over the limit
    assert sum(flags) >= len(POISONED) + 1 and \
        all(flags[i] == 1.0 for i in POISONED), (flags, limit)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                   rtol=1e-5, equal_nan=True)
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=0, atol=1e-5,
                                   equal_nan=True)
    for policy in StepGuard.POLICIES:
        port = escalations(StepGuard, policy, got,
                           (AnomalousStepError, GuardEscalationError,
                            GuardRollback))
        jax_ = escalations(jresil.StepGuard, policy, want,
                           (jresil.AnomalousStepError,
                            jresil.GuardEscalationError,
                            jresil.guard.GuardRollback))
        assert port == jax_, (policy, port, jax_)
        assert any(port[0]), policy          # every policy escalates here


# ---- the port's contracts ---------------------------------------------------

def flat_state(state):
    tree = bridge.flatten(state_to_tree(state))
    return {k: (v.clone() if isinstance(v, torch.Tensor) else v)
            for k, v in tree.items()}


def assert_bitwise(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("kind", ["lm", "bn"])
def test_guard_no_fault_is_bitwise_unguarded(kind):
    clean = PROBLEMS[kind][2](poisoned=())
    s0, m0 = run_port(kind, None, clean)
    s1, m1 = run_port(kind, StepGuard("skip"), clean)
    assert [m["loss"] for m in m0] == [m["loss"] for m in m1]
    assert all(m["bad_step"] == 0.0 and np.isfinite(m["grad_norm"])
               for m in m1)
    assert_bitwise(flat_state(s0), flat_state(s1))
    assert s1.step == s0.step == N_STEPS


@pytest.mark.parametrize("kind", ["lm", "bn"])
def test_guard_skip_equals_dropping_bad_batches(kind):
    """Two NaN batches under ``skip``: the state (optimizer step counts,
    moments, BatchNorm statistics) is bitwise the run without them."""
    guard = StepGuard("skip", max_consecutive=5)
    s1, m1 = run_port(kind, guard)
    for vals in m1:
        guard.observe(vals)
    assert [m["bad_step"] for m in m1] == \
        [float(i in POISONED) for i in range(N_STEPS)]
    assert guard.n_bad == len(POISONED)
    clean = [b for i, b in enumerate(PROBLEMS[kind][2](poisoned=()))
             if i not in POISONED]
    s0, _ = run_port(kind, None, clean)
    got, want = flat_state(s1), flat_state(s0)
    assert_bitwise(got, want)
    assert s1.step == len(clean) == got["step"]
    if kind == "lm":    # adam's per-parameter step counters
        assert all(float(v) == len(clean) for k, v in got.items()
                   if k.startswith("opt_state/step/"))
    else:
        assert any(k.startswith("batch_stats/") for k in got)


def test_guard_grad_norm_limit_freezes_the_state():
    guard = StepGuard("skip", max_consecutive=100, grad_norm_limit=1e-12)
    s, m = run_port("lm", guard, lm_batches(poisoned=())[:3])
    assert all(x["bad_step"] == 1.0 for x in m)
    assert_bitwise(flat_state(s), flat_state(port_lm()))
    assert s.step == 0


class _Counter:
    """Counts the tensor-to-host conversions made while it is active."""

    NAMES = ("item", "__float__", "__int__", "__bool__", "tolist", "numpy")

    def __init__(self):
        self.n = 0

    def __enter__(self):
        self.saved = {n: getattr(torch.Tensor, n) for n in self.NAMES}
        for n, f in self.saved.items():
            def counted(t, *a, _f=f, **kw):
                self.n += 1
                return _f(t, *a, **kw)
            setattr(torch.Tensor, n, counted)
        return self

    def __exit__(self, *exc):
        for n, f in self.saved.items():
            setattr(torch.Tensor, n, f)


@pytest.mark.parametrize("kind", ["lm", "bn"])
def test_guard_adds_no_host_conversion(kind):
    """The guarded step converts nothing to the host that the unguarded
    one does not (torch's CPU Adam reads its own host step counter in
    both): the flag and the norm stay tensors until a drain."""
    counts = {}
    for on in (False, True):
        make_state, make_step, mk_batches = PROBLEMS[kind]
        state = make_state()
        step = make_step(guard=StepGuard("skip") if on else None)
        batches = mk_batches()
        with _Counter() as c:
            for b in batches:
                state, m = step(state, b)
        counts[on] = c.n
        assert all(isinstance(v, torch.Tensor) for v in m.values())
    assert counts[True] == counts[False], counts


def test_guard_refuses_host_state_by_name():
    def mlp_state(tx):
        return init_state(MLP(n_units=8, in_features=16, device="cpu"), 0,
                          tx, device="cpu")
    batch = {"image": np.zeros((4, 16), np.float32),
             "label": np.zeros(4, np.int32)}
    step = make_train_step(guard=StepGuard())
    for tx, match in ((sgd(exponential_decay(0.1, 2, 0.5)), "schedule"),
                      (multi_steps(sgd(0.1), 2), "MultiSteps")):
        with pytest.raises(GuardDeviceError, match=match):
            step(mlp_state(tx), batch)
    state = mlp_state(sgd(0.1, momentum=0.9))
    step(state, batch)
    p = state.optimizer.param_groups[0]["params"][0]
    state.optimizer.state[p]["host_count"] = 3
    with pytest.raises(GuardDeviceError, match="host_count"):
        step(state, batch)
    with pytest.raises(ValueError, match="unknown guard policy"):
        StepGuard("retry")
    with pytest.raises(ValueError, match="max_consecutive"):
        StepGuard(max_consecutive=0)


# ---- through the loops ------------------------------------------------------

BS, DIM, N_BATCHES = 8, 32, 8


def mk_loader(n_batches=N_BATCHES, seed=0):
    rng = np.random.default_rng(seed)
    n = n_batches * BS
    return DataLoader({"image": rng.normal(size=(n, DIM)).astype(np.float32),
                       "label": rng.integers(0, 10, n).astype(np.int64)},
                      BS, shuffle=False, device="cpu")


def mlp(seed=0):
    return init_state(MLP(n_units=16, in_features=DIM, device="cpu"), seed,
                      sgd(0.1, momentum=0.9), device="cpu")


@pytest.mark.faults
def test_train_epoch_feeds_the_guard():
    """``raise`` surfaces the first bad step from the loop's drain, and
    ``skip`` escalates after ``max_consecutive`` bad steps in a row."""
    guard = StepGuard("raise")
    plan = FaultPlan().at("loader", 1, "nan")
    with pytest.raises(AnomalousStepError, match="anomalous step"):
        train_epoch(make_train_step(guard=guard), mlp(),
                    LoaderFaults(mk_loader(6), plan), guard=guard)
    assert plan.log == [("loader", 1, "nan")]
    guard = StepGuard("skip", max_consecutive=3)
    plan = FaultPlan()
    for i in (2, 3, 4):
        plan.at("loader", i, "nan")
    with pytest.raises(GuardEscalationError, match="3 consecutive"):
        train_epoch(make_train_step(guard=guard), mlp(),
                    LoaderFaults(mk_loader(8), plan), guard=guard,
                    sync_every_step=True)
    # a clean epoch: every step observed, none bad
    guard = StepGuard("skip")
    state, means = train_epoch(make_train_step(guard=guard), mlp(),
                               mk_loader(), guard=guard, log_interval=3)
    assert guard.n_steps == N_BATCHES and guard.n_bad == 0
    assert {"loss", "accuracy", "bad_step", "grad_norm"} <= set(means)


def guarded_trainer(out, loader, guard):
    tr = Trainer(mlp(), make_train_step(guard=guard), loader, None,
                 stop_trigger=(1, "epoch"), out=str(out), guard=guard)
    tr.extend(snapshot(), trigger=(1, "iteration"))
    return tr


@pytest.mark.faults
def test_trainer_rollback_restores_last_good_snapshot(tmp_path):
    """A 2-step NaN burst trips ``rollback``: the Trainer restores the
    last good snapshot and replays; the burst is transient (the plan's
    counters are global), so the replayed batches train clean, and the
    run is bitwise the stream with only the first burst batch dropped.
    Without a snapshot the rollback escalates by name."""
    guard = StepGuard("rollback", max_consecutive=2)
    plan = FaultPlan().at("loader", 3, "nan").at("loader", 4, "nan")
    t1 = guarded_trainer(tmp_path / "a", LoaderFaults(mk_loader(), plan),
                         guard)
    t1.run()
    assert guard.n_rollbacks == 1 and guard.n_bad == 2
    assert t1.epoch == 1
    loader = mk_loader()
    loader.set_epoch(0)
    ref, step = mlp(), make_train_step()
    for i, b in enumerate(iter(loader)):
        if i != 3:
            ref, _ = step(ref, b)
    assert_bitwise(flat_state(ref), flat_state(t1.state))

    guard = StepGuard("rollback", max_consecutive=1)
    t2 = Trainer(mlp(), make_train_step(guard=guard),
                 LoaderFaults(mk_loader(), FaultPlan().at("loader", 2,
                                                          "nan")),
                 None, stop_trigger=(1, "epoch"), out=str(tmp_path / "b"),
                 guard=guard)
    with pytest.raises(GuardEscalationError, match="no snapshot"):
        t2.run()


def test_guard_window_feeds_the_exporter_and_train_slos():
    """StepGuard.window and GoodputMeter.export_window feed a
    MetricsExporter as the serve sources do, and default_train_slos judge
    step time and the bad-step ratio on the points."""
    guard = StepGuard(policy="skip", max_consecutive=100)
    meter = GoodputMeter(tokens_per_step=10, peak_flops=None)
    exporter = MetricsExporter(interval_s=0.0)
    exporter.add_source("guard", guard.window)
    exporter.add_source("goodput", meter.export_window)
    exporter.attach_slo(SLOEvaluator(default_train_slos(
        step_time_s=0.5, bad_step_ratio=0.25, window_s=10.0)))
    meter.window(4, 0.4)
    for _ in range(4):
        guard.observe({"bad_step": 0.0})
    p1 = exporter.sample(force=True)
    assert p1["guard_steps"] == 4 and p1["guard_bad_steps"] == 0
    assert p1["slo_step_time_ok"] == 1 and p1["slo_bad_steps_ok"] == 1
    meter.window(2, 2.0)
    guard.observe({"bad_step": 1.0})
    guard.observe({"bad_step": 1.0})
    p2 = exporter.sample(force=True)
    assert p2["guard_bad_steps"] == 2 and p2["guard_bad_step_ratio"] == 1.0
    assert p2["slo_step_time_ok"] == 0 and p2["slo_bad_steps_ok"] == 0
    assert p2["slo_bad_steps_burn"] > 1.0
    p3 = exporter.sample(force=True)
    assert p3["guard_steps"] == 0 and "slo_step_time_ok" not in p3
    assert guard.summary()["guard_bad_steps"] == 2
    exporter.close()


# ---- replica invariance under DataParallel (a gloo world of 2) --------------

WORLD_CHILD = """
    import json, sys
    import numpy as np, torch
    torch.set_num_threads(1)
    from dtdl_tpu_torch.models import MLP
    from dtdl_tpu_torch.parallel import DataParallel
    from dtdl_tpu_torch.parallel.collectives import tree_digest
    from dtdl_tpu_torch.resil import StepGuard, poison_batch
    from dtdl_tpu_torch.runtime import build_mesh, initialize
    from dtdl_tpu_torch.bridge import state_dict_to_flax
    from dtdl_tpu_torch.train import init_state, make_train_step
    from dtdl_tpu_torch.train.optim import sgd
    a = sys.argv
    rank = int(a[-1])
    initialize(a[-5], int(a[-3]), rank, device="cpu", timeout_s=60)
    dp = DataParallel(build_mesh())
    state = dp.replicate(init_state(MLP(n_units=16, in_features=32,
                                        device="cpu"), 0,
                                    sgd(0.1, momentum=0.9), device="cpu"))
    step = make_train_step(dp, guard=StepGuard("skip"))
    rng = np.random.default_rng(rank)
    flags = []
    for i in range(4):
        b = {"image": rng.normal(size=(8, 32)).astype(np.float32),
             "label": rng.integers(0, 10, 8)}
        if i == 2 and rank == 1:
            b = poison_batch(b)       # a NaN on one replica's rows only
        state, m = step(state, b)
        flags.append(float(m["bad_step"]))
    print("guard_result " + json.dumps({
        "flags": flags, "step": state.step,
        "digest": tree_digest(state_dict_to_flax(state.model))}),
        flush=True)
"""


def test_guard_is_replica_invariant_under_data_parallel(tmp_path, capfd):
    child = tmp_path / "child.py"
    child.write_text(textwrap.dedent(WORLD_CHILD))
    env = {"PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                            "")}
    t0 = time.monotonic()
    rc = local.launch_local([str(child)], nproc=2, port=_free_port(),
                            env_extra=env, timeout=90)
    out = capfd.readouterr().out
    assert rc == 0, out[-3000:]
    assert time.monotonic() - t0 < 90
    import json
    res = {}
    for line in out.splitlines():
        if "guard_result " in line:
            rank = int(line.split("]")[0].split()[-1])
            res[rank] = json.loads(line.split("guard_result ", 1)[1])
    assert sorted(res) == [0, 1], out[-3000:]
    assert res[0]["flags"] == res[1]["flags"] == [0.0, 0.0, 1.0, 0.0]
    assert res[0]["step"] == res[1]["step"] == 3
    assert res[0]["digest"] == res[1]["digest"]


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]

