"""``AutoSharded`` in the port (dtdl_tpu_torch/parallel/strategy.py): the
compiler-partitioned strategy of tests/test_tensor_parallel.py, against
the JAX package's ``AutoSharded``.

A gloo world of 4 processes on a ``{data 2, model 2}`` mesh runs the
cases (this file is the worker as ``__main__``, tests/_torch_world.py the
harness; each rank takes its data rows of the global batch) while the
pytest process runs the JAX ``AutoSharded`` step, in float64 under
``jax.enable_x64`` (tests/test_torch_classifier_train.py's docstring: the
JAX f32 BatchNorm is too coarse to hold a gradient to), from the same
flax variables and batches:

* the per-leaf rule of tests/test_tensor_parallel.py (a Dense kernel
  whose width 4 divides on 'model', everything else whole), unchanged:
  3 SGD-momentum steps of the MLP, the hidden kernels held as blocks (a
  rank's fc1 weight is [16, 784]), the [32, 10] head whole, the losses
  and the gathered weights those of the JAX step on its ``{data 2,
  model 4}`` mesh, and so the eval step's sums over the global batch and
  each rank's predict rows;
* a small PyramidNet (BatchNorm after every conv) at a global batch of 8:
  2 steps with BatchNorm statistics over the global batch (one
  all-reduce of the sums over 'data'), the loss, every parameter and
  every statistic those of the JAX ``AutoSharded`` step over its 8
  devices; the same steps under ``DataParallel`` (statistics over each
  replica's 4 rows) land measurably further away.

Tolerances (port f32 against JAX f64): losses and eval sums within rtol
1e-5; MLP weights within atol 1e-5, its logits within 1e-4; PyramidNet parameters within atol 1e-5 and
statistics within 1e-5 of each BatchNorm's scale (``stats_err``).
"""

import sys

from _torch_world import World, serve

AXES = ("data", "model")
MESH = (2, 2)
LR, MOMENTUM = 0.1, 0.9


def rule(path, leaf):
    """tests/test_tensor_parallel.py's per-leaf spec: kernels with a
    'model'-divisible width (4 there) tensor-parallel, the rest whole."""
    shape = getattr(leaf, "shape", ())
    if len(shape) == 2 and shape[1] % 4 == 0:
        return (None, "model")
    return ()


def run_case(mesh, name, case):
    """One classifier case on this rank: the losses of its steps, the
    shapes of the blocks it holds, the whole weights (and statistics)
    after them."""
    import torch

    from dtdl_tpu_torch import bridge, models
    from dtdl_tpu_torch.parallel import AutoSharded, DataParallel
    from dtdl_tpu_torch.runtime.mesh import batch_sharded
    from dtdl_tpu_torch.train.optim import sgd
    from dtdl_tpu_torch.train.state import init_state
    from dtdl_tpu_torch.train.step import (make_eval_step, make_predict_step,
                                           make_train_step)

    if name.startswith("mlp"):
        model = models.MLP(n_units=32, device="cpu", seed=None)
        strategy = AutoSharded(mesh, param_spec=rule)
    else:
        model = models.PyramidNet(num_layers=2, alpha=12, device="cpu",
                                  seed=None)
        strategy = (AutoSharded(mesh) if name == "pyramidnet"
                    else DataParallel(mesh, axis="data"))
    bridge.load_flax_params(model, case["params"], case.get("batch_stats"),
                            device="cpu")
    state = strategy.replicate(init_state(
        model, None, sgd(LR, momentum=MOMENTUM), device="cpu"))
    step = make_train_step(strategy)
    losses = []
    for b in case["batches"]:
        state, metrics = step(state, {k: batch_sharded(mesh, v, "data",
                                                       device="cpu")
                                      for k, v in b.items()})
        losses.append(float(metrics["loss"]))
    out = {"losses": losses,
           "shapes": {n: tuple(p.shape) for n, p in model.named_parameters()}}
    with torch.no_grad():
        if name.startswith("mlp"):
            # each attribute read gathers the leaf's blocks
            out["params"] = {f"fc{i}": getattr(model, f"fc{i}").weight.numpy()
                             for i in (1, 2, 3)}
            rows = {k: batch_sharded(mesh, v, "data", device="cpu")
                    for k, v in case["batches"][0].items()}
            out["eval"] = {k: float(v) for k, v in
                           make_eval_step(strategy)(state, rows).items()}
            out["predict"] = make_predict_step(strategy)(state, rows).numpy()
        else:
            out["params"] = bridge.state_dict_to_flax(model)
            out["batch_stats"] = bridge.state_dict_to_flax(model,
                                                           "batch_stats")
    return out


if __name__ == "__main__":
    sys.exit(serve(run_case, AXES))

# ---- the pytest side (the JAX oracle) ---------------------------------------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import pytest  # noqa: E402
from jax.sharding import PartitionSpec  # noqa: E402

from dtdl_tpu import models as jmodels  # noqa: E402
from dtdl_tpu.parallel import AutoSharded as JaxAutoSharded  # noqa: E402
from dtdl_tpu.runtime.mesh import build_mesh as jax_mesh  # noqa: E402
from dtdl_tpu.train import TrainState  # noqa: E402
from dtdl_tpu.train import make_eval_step as jax_eval_step  # noqa: E402
from dtdl_tpu.train import make_predict_step as jax_predict_step  # noqa: E402
from dtdl_tpu.train import make_train_step as jax_train_step  # noqa: E402
from dtdl_tpu_torch import bridge, models  # noqa: E402
from test_torch_classifier import random_tree, stats_err  # noqa: E402

F64 = jnp.float64


def data(shape, n, seed):
    rng = np.random.default_rng(seed)
    return [{"image": rng.normal(size=shape).astype(np.float32),
             "label": rng.integers(0, 10, shape[0]).astype(np.int32)}
            for _ in range(n)]


CASES = {
    "mlp": {"params": random_tree(models.MLP(n_units=32, device="cpu",
                                             seed=None))["params"],
            "batches": data((16, 784), 3, 0)},
}
_PYR = random_tree(models.PyramidNet(num_layers=2, alpha=12, device="cpu",
                                     seed=None), spread=0.25)
for _name in ("pyramidnet", "pyramidnet-dp"):
    CASES[_name] = {"params": _PYR["params"],
                    "batch_stats": _PYR["batch_stats"],
                    "batches": data((8, 20, 20, 3), 2, 1)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return World(__file__, MESH, CASES, tmp_path_factory.mktemp("auto"))


def jax_run(jm, case, mesh, param_spec=None):
    """The JAX AutoSharded step's losses and final state, in f64 (and its
    eval sums and predict logits on the first batch after the steps)."""
    with jax.enable_x64():
        cast = lambda t: jax.tree.map(lambda a: jnp.asarray(a, F64), t)  # noqa: E731
        strategy = JaxAutoSharded(mesh, param_spec=param_spec)
        state = strategy.replicate(TrainState.create(
            apply_fn=jm.apply, params=cast(case["params"]),
            tx=optax.sgd(LR, momentum=MOMENTUM),
            batch_stats=(cast(case["batch_stats"])
                         if "batch_stats" in case else None)))
        step = jax_train_step(strategy)
        losses = []
        for b in case["batches"]:
            state, m = step(state, strategy.shard_batch(
                {"image": jnp.asarray(b["image"], F64),
                 "label": jnp.asarray(b["label"])}))
            losses.append(float(m["loss"]))
        b = strategy.shard_batch({"image": jnp.asarray(
            case["batches"][0]["image"], F64),
            "label": jnp.asarray(case["batches"][0]["label"])})
        ev = {k: float(v) for k, v in jax_eval_step(strategy)(state,
                                                              b).items()}
        logits = np.asarray(jax_predict_step(strategy)(state, b))
        return losses, jax.device_get(state), ev, logits


def test_per_leaf_spec_through_the_train_step(world, devices):
    def jax_rule(path, leaf):
        return PartitionSpec(*rule(path, leaf))
    want, st, ev, logits = jax_run(
        jmodels.MLP(n_units=32, dtype=F64), CASES["mlp"],
        jax_mesh(shape=(2, 4), axes=AXES, devices=devices), jax_rule)
    for o in world.results():
        out = dict(o["cases"]["mlp"], coords=o["coords"])
        np.testing.assert_allclose(out["losses"], want, rtol=1e-5)
        # [784, 32] and [32, 32] flax kernels split their width on
        # 'model'; the [32, 10] head and the biases whole
        shapes = out["shapes"]
        assert shapes["fc3.weight"] == (10, 32)
        assert shapes["fc1.parametrizations.weight.original"] == (16, 784)
        assert shapes["fc2.parametrizations.weight.original"] == (16, 32)
        assert shapes["fc1.bias"] == (32,)
        for i in (1, 2, 3):
            np.testing.assert_allclose(
                out["params"][f"fc{i}"],
                np.asarray(st.params[f"Dense_{i - 1}"]["kernel"]).T,
                atol=1e-5)
        # eval sums over the global batch and each rank's predict rows
        for k, v in ev.items():
            np.testing.assert_allclose(out["eval"][k], v, rtol=1e-5)
        d = out["coords"]["data"]
        np.testing.assert_allclose(out["predict"],
                                   logits[8 * d:8 * (d + 1)], atol=1e-4)


def test_global_batch_batchnorm_matches_jax(world):
    want, st, _, _ = jax_run(
        jmodels.PyramidNet(num_layers=2, alpha=12, dtype=F64),
        CASES["pyramidnet"], jax_mesh())
    wp = bridge.flatten(jax.device_get(st.params))
    errs = {}
    for name in ("pyramidnet", "pyramidnet-dp"):
        for out in (o["cases"][name] for o in world.results()):
            got = bridge.flatten(out["params"])
            errs[name] = (max(np.abs(got[k] - wp[k]).max() for k in wp),
                          stats_err(out["batch_stats"], st.batch_stats),
                          abs(out["losses"][-1] - want[-1]))
            if name == "pyramidnet":
                np.testing.assert_allclose(out["losses"], want, rtol=1e-5)
                assert errs[name][0] <= 1e-5 and errs[name][1] <= 1e-5, \
                    errs[name]
    # per-replica statistics are another function: further from JAX's
    for i in range(3):
        assert errs["pyramidnet-dp"][i] > 10 * errs["pyramidnet"][i], errs
