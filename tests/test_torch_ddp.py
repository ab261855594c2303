"""The port's data-parallel training against the JAX package's, on the CPU.

Two real processes, spawned once per module through the port's launcher
(``dtdl_tpu_torch.launch.local``) on a free port, join a gloo world and
run this file as ``__main__`` (the worker below; it imports no JAX).
Each rank trains on its half of every global batch under
``DataParallel(build_mesh())`` and saves what it computed; the pytest
process itself never joins a process group.  The oracle runs here:
the JAX ``DataParallel`` over a 2-device mesh of conftest's virtual CPU
devices, and the JAX ``SingleDevice`` step on the global batch.

Cases: ``MLP``, ``MnistCNN`` and a small PyramidNet (per-replica
BatchNorm, mean-synced statistics), 3 SGD steps (momentum, weight
decay); the ``tiny`` LM, dense and MoE (routed, every second block),
2 sgd(0.1) steps on batches with a ragged mask (one row fully masked);
eval sums; ``evaluate`` over loaders of 9 and 5 examples; generate under
the strategy; every collective one by one; parameters and optimizer
state bitwise identical across ranks.

Tolerances: the classifiers run the JAX side in float64 (as
``tests/test_torch_classifier_train.py``, whose docstring says why) and
the LM in f32; the port is f32.  Parameters, BatchNorm statistics,
losses and eval sums within rtol 1e-4, atol 1e-5 (the tolerance of
``tests/test_train_step.py``'s DDP check); accuracies and counts exact;
tokens, digests and cross-rank state exact.
"""

import argparse
import os
import socket
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from dtdl_tpu_torch import bridge, models  # noqa: E402
from dtdl_tpu_torch.data.loader import DataLoader  # noqa: E402
from dtdl_tpu_torch.launch.local import launch_local  # noqa: E402
from dtdl_tpu_torch.models.transformer import (generate,  # noqa: E402
                                               transformer_lm)
from dtdl_tpu_torch.parallel import DataParallel, collectives  # noqa: E402
from dtdl_tpu_torch.runtime import (build_mesh, initialize,  # noqa: E402
                                    process_index)
from dtdl_tpu_torch.train.loop import evaluate  # noqa: E402
from dtdl_tpu_torch.train.optim import sgd  # noqa: E402
from dtdl_tpu_torch.train.state import init_state  # noqa: E402
from dtdl_tpu_torch.train.step import (make_eval_step,  # noqa: E402
                                       make_lm_train_step, make_train_step)

RTOL, ATOL = 1e-4, 1e-5
LR, MOMENTUM, WD = 0.1, 0.9, 0.05
STEPS, LM_STEPS = 3, 2
GLOBAL = 8          # global batch; 4 rows a rank

# name -> (port model maker, NHWC input shape of the global batch)
CLASSIFIERS = {
    "mlp": (lambda: models.MLP(n_units=32, device="cpu", seed=None),
            (GLOBAL, 784)),
    "cnn": (lambda: models.MnistCNN(device="cpu", seed=None),
            (GLOBAL, 28, 28, 1)),
    "pyramidnet": (lambda: models.PyramidNet(num_layers=2, alpha=12,
                                             device="cpu", seed=None),
                   (GLOBAL, 20, 20, 3)),
}
LM_MAX_SEQ = 48
MOE_CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, d_ff=64,
               n_experts=4, moe_dispatch="routed",
               capacity_factor=1.25, moe_every=2)
LMS = {"lm": ({}, 256), "lm_moe": (MOE_CFG, 64)}
EVAL_SPLIT = (9, 5)          # evaluate: examples on rank 0 and rank 1


def classifier_batches(name, n, seed=0):
    shape = CLASSIFIERS[name][1]
    rng = np.random.default_rng(seed)
    return [{"image": rng.normal(size=shape).astype(np.float32),
             "label": rng.integers(0, 10, shape[0]).astype(np.int32)}
            for _ in range(n)]


def lm_batches(vocab, n, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        mask = (rng.random((GLOBAL, 32)) > 0.3).astype(np.float32)
        mask[5] = 0.0       # a row with no target on rank 1
        out.append({"tokens": rng.integers(0, vocab, (GLOBAL, 33)).astype(
            np.int32), "mask": mask})
    return out


def eval_batch(name, seed=9):
    b = classifier_batches(name, 1, seed)[0]
    b["mask"] = np.array([1, 1, 0, 1, 1, 1, 1, 0], np.float32)
    return b


def stripe(batch, rank, n=2):
    per = len(next(iter(batch.values()))) // n
    return {k: v[rank * per:(rank + 1) * per] for k, v in batch.items()}


def unflat(flat):
    return bridge._nest({k: np.asarray(v) for k, v in flat.items()})


# ---- the worker: one rank of the gloo world --------------------------------

def _params(model):
    return bridge.flatten(bridge.state_dict_to_flax(model))


def _opt_state(state):
    return [v.clone() for p in state.model.parameters()
            for _, v in sorted(state.optimizer.state.get(p, {}).items())
            if isinstance(v, torch.Tensor)]


def run_classifier(name, init, strategy, rank):
    tm = CLASSIFIERS[name][0]()
    bridge.load_flax_params(tm, init["params"], init.get("batch_stats"),
                            device="cpu")
    state = strategy.replicate(init_state(
        tm, None, sgd(LR, momentum=MOMENTUM, weight_decay=WD),
        device="cpu"))
    step = make_train_step(strategy)
    metrics = []
    for batch in classifier_batches(name, STEPS):
        state, m = step(state, stripe(batch, rank))
        metrics.append({k: float(v) for k, v in m.items()})
    sums = make_eval_step(strategy)(state, stripe(eval_batch(name), rank))
    stats = bridge.state_dict_to_flax(tm, "batch_stats")
    return {"metrics": metrics, "params": _params(tm),
            "batch_stats": stats and bridge.flatten(stats),
            "opt_state": _opt_state(state),
            "eval": {k: float(v) for k, v in sums.items()},
            "step": state.step}


def run_lm(name, init, strategy, rank):
    cfg, vocab = LMS[name]
    tm = transformer_lm("tiny", device="cpu", seed=None, dtype=torch.float32,
                        max_seq=LM_MAX_SEQ, **cfg)
    bridge.load_flax_params(tm, init["params"], device="cpu")
    state = strategy.replicate(init_state(tm, None, sgd(0.1), device="cpu"))
    step = make_lm_train_step(strategy)
    metrics = []
    for batch in lm_batches(vocab, LM_STEPS):
        state, m = step(state, stripe(batch, rank))
        metrics.append({k: float(v) for k, v in m.items()})
    out = {"metrics": metrics, "params": _params(tm)}
    if name == "lm":
        prompt = np.random.default_rng(5).integers(0, vocab, (4, 5))
        out["generate"] = {
            "dp": generate(tm, prompt, 6, strategy=strategy).numpy(),
            "single": generate(tm, prompt, 6).numpy(),
            "dp_sampled": generate(
                tm, prompt, 6, temperature=1.0, strategy=strategy,
                generator=torch.Generator().manual_seed(1)).numpy(),
            "single_sampled": generate(
                tm, prompt, 6, temperature=1.0,
                generator=torch.Generator().manual_seed(1)).numpy()}
    return out


def run_evaluate(init, strategy, rank):
    """evaluate over loaders of 9 and 5 examples (batch 4): 3 and 2
    batches, each with a ragged tail; the counts the eval steps return."""
    tm = CLASSIFIERS["mlp"][0]()
    bridge.load_flax_params(tm, init["params"], device="cpu")
    state = init_state(tm, None, sgd(LR), device="cpu")
    rng = np.random.default_rng(11)
    images = rng.normal(size=(sum(EVAL_SPLIT), 784)).astype(np.float32)
    labels = rng.integers(0, 10, sum(EVAL_SPLIT)).astype(np.int32)
    lo = sum(EVAL_SPLIT[:rank])
    mine = slice(lo, lo + EVAL_SPLIT[rank])
    loader = DataLoader({"image": images[mine], "label": labels[mine]}, 4,
                        shuffle=False, drop_last=False, device="cpu")
    eval_step = make_eval_step(strategy)
    counts = []

    def counted(state, batch):
        sums = eval_step(state, batch)
        counts.append(float(sums["count"]))
        return sums

    means = evaluate(counted, state, loader, strategy)
    return {"means": means, "counts": counts, "images": images,
            "labels": labels}


def run_collectives(strategy, rank):
    mesh = strategy.mesh
    out = {"axis_index": collectives.axis_index(mesh)}
    tree = {"a": torch.tensor([rank + 1.0]), "b": [torch.tensor(2.0 * rank)]}
    out["sum"] = collectives.all_reduce_sum(tree, mesh)
    out["mean"] = collectives.all_reduce_mean(tree, mesh)
    out["tree_unchanged"] = float(tree["a"])
    out["gather"] = collectives.all_gather_batch(
        torch.full((2, 3), float(rank)), mesh)
    out["bcast"] = collectives.broadcast_from(
        torch.arange(3.0) + 10 * rank, root=1, mesh=mesh)
    grads = [torch.full((3,), rank + 1.0), torch.full((2, 2), 4.0 * rank),
             torch.full((5,), float(rank), dtype=torch.float64)]
    collectives.grad_sync(grads, mesh, bucket_bytes=16)   # several buckets
    out["grads"] = grads
    stats = [torch.full((2,), 2.0 * rank)]
    strategy.stats_sync(stats)
    out["stats"] = stats
    out["host_bcast"] = collectives.host_broadcast({"x": np.arange(3) * (rank + 1)})
    out["host_bcast_1"] = collectives.host_broadcast(
        {"x": np.arange(3) * (rank + 1)}, is_source=rank == 1)
    out["host_max"] = collectives.host_max(5 * rank + 1)
    out["max_sync"] = strategy.max_sync(rank + 3)
    collectives.assert_same_across_hosts({"w": torch.ones(3)}, "same")
    try:
        collectives.assert_same_across_hosts({"w": torch.full((3,), rank)},
                                             "weights")
        out["diverged_raised"] = None
    except AssertionError as e:
        out["diverged_raised"] = str(e)
    out["localize"] = collectives.localize(tree, mesh) is tree
    out["fold_rank"] = strategy.fold_rank(7)
    return out


def worker(argv) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--coordinator")
    ap.add_argument("--num-processes", type=int)
    ap.add_argument("--process-id", type=int)
    a = ap.parse_args(argv)
    torch.set_num_threads(1)
    initialize(a.coordinator, a.num_processes, a.process_id, device="cpu",
               timeout_s=120)
    rank = process_index()
    strategy = DataParallel(build_mesh())
    inputs = torch.load(os.path.join(a.out, "inputs.pt"), weights_only=False)
    res = {name: run_classifier(name, inputs[name], strategy, rank)
           for name in CLASSIFIERS}
    res.update({name: run_lm(name, inputs[name], strategy, rank)
                for name in LMS})
    res["evaluate"] = run_evaluate(inputs["mlp"], strategy, rank)
    res["collectives"] = run_collectives(strategy, rank)
    torch.save(res, os.path.join(a.out, f"rank{rank}.pt"))


if __name__ == "__main__":
    worker(sys.argv[1:])
    sys.exit(0)


# ---- the pytest side: inputs, the spawn, the JAX oracle ---------------------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import flax.linen as fnn  # noqa: E402
import optax  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from dtdl_tpu.models import transformer as jtr  # noqa: E402
from dtdl_tpu.parallel import DataParallel as JaxDataParallel  # noqa: E402
from dtdl_tpu.train import (TrainState, make_eval_step as jax_eval_step,  # noqa: E402
                            make_lm_train_step as jax_lm_step,
                            make_train_step as jax_train_step)
from test_torch_classifier import random_tree, stats_err  # noqa: E402
from test_torch_classifier_train import MODELS as JAX_MODELS  # noqa: E402


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def lm_init(name):
    cfg, _ = LMS[name]
    jm = jtr.transformer_lm("tiny", attn_impl="dense", dtype=jnp.float32,
                            max_seq=LM_MAX_SEQ, **cfg)
    params = jax.device_get(fnn.unbox(jax.jit(jm.init)(
        jax.random.PRNGKey(2), jnp.zeros((1, 4), jnp.int32))["params"]))
    return jm, params


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Inputs here, two gloo ranks through the launcher, their results."""
    out = tmp_path_factory.mktemp("ddp")
    inputs = {name: random_tree(CLASSIFIERS[name][0](), spread=0.25)
              for name in CLASSIFIERS}
    jms = {}
    for name in LMS:
        jms[name], params = lm_init(name)
        inputs[name] = {"params": params}
    torch.save(inputs, out / "inputs.pt")
    rc = launch_local([os.path.abspath(__file__), "--out", str(out)],
                      nproc=2, port=free_port(), timeout=240,
                      env_extra={"OMP_NUM_THREADS": "1",
                                 "PYTHONPATH": REPO})
    assert rc == 0, f"the DDP world exited with {rc}"
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    return inputs, jms, ranks


@pytest.fixture(scope="module")
def jmesh(devices):
    return Mesh(np.array(devices[:2]), ("data",))


def _jax_classifier(name, v, strategy):
    """The JAX step (float64) over the global batches under
    ``strategy`` (None: SingleDevice), and its eval sums."""
    from test_torch_classifier_train import jax_state
    with jax.enable_x64():
        jtx = optax.chain(optax.add_decayed_weights(WD),
                          optax.sgd(LR, momentum=MOMENTUM))
        state = jax_state(name, v, jtx)
        put = (lambda b: strategy.shard_batch(
            {k: jnp.asarray(x) for k, x in b.items()})) if strategy else \
            (lambda b: {k: jnp.asarray(x) for k, x in b.items()})
        if strategy:
            state = strategy.replicate(state)
        step = jax_train_step(strategy)
        metrics = []
        for batch in classifier_batches(name, STEPS):
            state, m = step(state, put(batch))
            metrics.append({k: float(x) for k, x in m.items()})
        sums = jax_eval_step(strategy)(state, put(eval_batch(name)))
        return (metrics, bridge.flatten(jax.device_get(state.params)),
                state.batch_stats and jax.device_get(state.batch_stats),
                {k: float(x) for k, x in sums.items()})


def _close_params(got, want, label):
    assert set(got) == set(want), label
    for path, w in want.items():
        np.testing.assert_allclose(got[path], np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=f"{label} {path}")


def _close_metrics(got, want):
    for g, w in zip(got, want, strict=True):
        assert set(g) == set(w)
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=RTOL)
        assert g["accuracy"] == pytest.approx(w["accuracy"], abs=1e-6)


@pytest.mark.parametrize("name", list(CLASSIFIERS))
def test_classifier_ddp_matches_jax_data_parallel(world, jmesh, name):
    inputs, _, ranks = world
    want_m, want_p, want_stats, want_eval = _jax_classifier(
        name, inputs[name], JaxDataParallel(jmesh))
    got = ranks[0][name]
    assert got["step"] == STEPS
    _close_metrics(got["metrics"], want_m)
    _close_params(got["params"], want_p, name)
    if want_stats is None:
        assert got["batch_stats"] is None
    else:      # per-replica BatchNorm, mean-synced running statistics
        assert stats_err(unflat(got["batch_stats"]), want_stats) <= ATOL
    for k, w in want_eval.items():
        np.testing.assert_allclose(got["eval"][k], w, rtol=RTOL, err_msg=k)
    assert got["eval"]["count"] == 6.0


@pytest.mark.parametrize("name", ["mlp", "cnn"])
def test_classifier_ddp_matches_single_device_global_batch(world, name):
    """Without BatchNorm, DDP on two halves is the large-batch step."""
    inputs, _, ranks = world
    want_m, want_p, _, _ = _jax_classifier(name, inputs[name], None)
    _close_metrics(ranks[1][name]["metrics"], want_m)
    _close_params(ranks[1][name]["params"], want_p, name)


@pytest.mark.parametrize("name", list(LMS))
def test_lm_ddp_ragged_mask_matches_jax_data_parallel(world, jmesh, name):
    """The loss scale num_replicas / global token count makes the mean of
    the per-replica gradients the global token mean, with rows of
    different token counts on the two ranks (one row fully masked)."""
    inputs, jms, ranks = world
    strategy = JaxDataParallel(jmesh)
    state = strategy.replicate(TrainState.create(
        apply_fn=jms[name].apply,
        params=jax.tree.map(jnp.array, inputs[name]["params"]),
        tx=optax.sgd(0.1)))
    step = jax_lm_step(strategy)
    want_m = []
    for batch in lm_batches(LMS[name][1], LM_STEPS):
        state, m = step(state, strategy.shard_batch(
            {k: jnp.asarray(v) for k, v in batch.items()}))
        want_m.append({k: float(v) for k, v in m.items()})
    got = ranks[0][name]
    for g, w in zip(got["metrics"], want_m, strict=True):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=ATOL,
                                       err_msg=k)
    _close_params(got["params"], bridge.flatten(jax.device_get(
        state.params)), name)


def test_ddp_state_stays_replicated(world):
    """After the steps every parameter, BatchNorm statistic and optimizer
    moment is bitwise the same on both ranks, and so are the metrics."""
    _, _, (r0, r1) = world
    for name in list(CLASSIFIERS) + list(LMS):
        for path, x in r0[name]["params"].items():
            assert np.array_equal(x, r1[name]["params"][path]), (name, path)
        assert r0[name]["metrics"] == r1[name]["metrics"], name
    for name in CLASSIFIERS:
        if r0[name]["batch_stats"] is not None:
            for path, x in r0[name]["batch_stats"].items():
                assert np.array_equal(x, r1[name]["batch_stats"][path])
        assert r0[name]["opt_state"] and all(
            torch.equal(a, b) for a, b in zip(r0[name]["opt_state"],
                                              r1[name]["opt_state"]))


def test_evaluate_counts_every_example_once(world):
    """Loaders of 9 and 5 examples at batch 4: rank 1 runs an all-masked
    third step so the world stays in step; the synced counts add to 14
    and the means are those of one pass over all 14 examples."""
    inputs, _, ranks = world
    got = ranks[0]["evaluate"]
    for r in ranks:
        assert r["evaluate"]["counts"] == [8.0, 4.0 + 1.0, 1.0]
        assert r["evaluate"]["means"] == got["means"]
    assert sum(got["counts"]) == 14.0
    with jax.enable_x64():
        from test_torch_classifier_train import jax_state
        state = jax_state("mlp", inputs["mlp"], optax.sgd(LR))
        sums = jax_eval_step()(state, {"image": jnp.asarray(got["images"]),
                                       "label": jnp.asarray(got["labels"])})
    assert float(sums["count"]) == 14.0
    np.testing.assert_allclose(got["means"]["loss"],
                               float(sums["loss_sum"]) / 14, rtol=RTOL)
    assert got["means"]["accuracy"] == pytest.approx(
        float(sums["correct_sum"]) / 14, abs=1e-9)


def test_generate_under_strategy_equals_single(world):
    _, _, ranks = world
    for r in ranks:
        gen = r["lm"]["generate"]
        assert gen["dp"].shape == (4, 11)
        np.testing.assert_array_equal(gen["dp"], gen["single"])
        np.testing.assert_array_equal(gen["dp_sampled"],
                                      gen["single_sampled"])
    np.testing.assert_array_equal(ranks[0]["lm"]["generate"]["dp"],
                                  ranks[1]["lm"]["generate"]["dp"])


def test_collectives_one_by_one(world):
    _, _, ranks = world
    for rank, r in enumerate(ranks):
        c = r["collectives"]
        assert c["axis_index"] == rank
        assert float(c["sum"]["a"]) == 3.0 and float(c["sum"]["b"][0]) == 2.0
        assert float(c["mean"]["a"]) == 1.5 and float(c["mean"]["b"][0]) == 1.0
        assert c["tree_unchanged"] == rank + 1.0
        np.testing.assert_array_equal(
            c["gather"].numpy(), np.repeat([0.0, 1.0], 2)[:, None] * np.ones(3))
        np.testing.assert_array_equal(c["bcast"].numpy(), [10.0, 11.0, 12.0])
        g = c["grads"]
        assert torch.equal(g[0], torch.full((3,), 1.5))
        assert torch.equal(g[1], torch.full((2, 2), 2.0))
        assert g[2].dtype == torch.float64 and torch.equal(
            g[2], torch.full((5,), 0.5, dtype=torch.float64))
        assert torch.equal(c["stats"][0], torch.full((2,), 1.0))
        np.testing.assert_array_equal(c["host_bcast"]["x"], [0, 1, 2])
        np.testing.assert_array_equal(c["host_bcast_1"]["x"], [0, 2, 4])
        assert c["host_max"] == 6 and c["max_sync"] == 4
        assert "weights diverged across hosts" in c["diverged_raised"]
        assert c["localize"]
    assert ranks[0]["collectives"]["fold_rank"] != \
        ranks[1]["collectives"]["fold_rank"]
