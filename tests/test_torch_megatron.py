"""The port's 4D-parallel train and eval steps against the JAX package's,
on the CPU, at the mesh ``{data 1, seq 2, pipe 2, model 2}``.

A gloo world of 8 processes, started once for the module through the
port's launcher (``tests/_torch_world.py``; this file is the worker as
``__main__``, and the worker imports no JAX), runs every case of
:func:`dtdl_tpu_torch.parallel.megatron.make_megatron_train_step` (or
the eval step) on its shards of the same numpy weights (``np.asarray``
of the JAX ``init_params``) and batches; the oracle is the JAX step on
``build_4d_mesh`` over conftest's 8 virtual CPU devices.  The parameters
after the step are assembled from the ranks' shards by
``param_specs`` (ranks holding the same block must agree bitwise).

Cases: the six ``(n_experts, schedule, dispatch)`` cases of
tests/test_megatron.py (one sgd(0.1) step, capacity 4.0 so routing
drops nothing), with the rotary embedding fused into the ring
(``fuse_rope=True`` on both sides); the eval step, dense and routed, on
a ragged mask.

Tolerances (f32): the loss within atol 1e-5, rtol 1e-5; every parameter
within ``PARAM_TOL`` of tests/test_megatron.py (atol 2e-4, rtol 2e-4);
the MoE aux loss within 1e-5; dropped fractions and token counts
exactly equal; eval loss within 1e-5, accuracy within 1e-6.
"""

import sys

import numpy as np

from _torch_world import World, assemble, run_megatron_case, serve

AXES = ("data", "seq", "pipe", "model")
MESH = (1, 2, 2, 2)
STEP_CASES = [(0, "1f1b", "dense"), (4, "1f1b", "dense"),
              (0, "gpipe", "dense"), (4, "gpipe", "dense"),
              (4, "1f1b", "routed"), (4, "gpipe", "routed")]
EVAL_CASES = [(0, "dense"), (4, "routed")]

if __name__ == "__main__":
    sys.exit(serve(run_megatron_case, AXES))

# ---- the pytest side (the JAX oracle) ---------------------------------------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import pytest  # noqa: E402

from dtdl_tpu.parallel import megatron as JM  # noqa: E402
from dtdl_tpu.runtime.mesh import build_mesh as jax_build_mesh  # noqa: E402
from dtdl_tpu_torch.parallel import megatron as TM  # noqa: E402

PARAM_TOL = dict(atol=2e-4, rtol=2e-4)


def cfg_kw(**kw):
    base = dict(vocab_size=64, d_model=32, n_heads=4, d_ff=64, n_stages=2,
                layers_per_stage=1, n_microbatches=2, max_seq=64,
                fuse_rope=True)
    base.update(kw)
    return base


def lm_batch(B=8, S=32, seed=0, vocab=64):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "targets": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "mask": np.ones((B, S), np.float32)}


def ragged(batch):
    batch["mask"][:, -5:] = 0.0
    batch["mask"][0, 3:] = 0.0
    return batch


def make_case(kw, batches, seed=0, opt="sgd", lr=0.1, evaluate=False):
    jc = JM.MegatronConfig(**kw, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, JM.init_params(
        jc, jax.random.PRNGKey(seed)))
    return {"cfg": kw, "params": params, "batches": batches, "opt": opt,
            "lr": lr, "eval": evaluate}


def jax_mesh(shape, devices):
    n = int(np.prod(shape))
    return jax_build_mesh(shape=shape, axes=JM.AXES, devices=devices[:n])


def jax_run(case, mesh):
    """The JAX step (or eval step) on the case: as run_megatron_case."""
    jc = JM.MegatronConfig(**case["cfg"], dtype=jnp.float32)
    params = JM.place_params(mesh, jc, case["params"])
    batches = [JM.shard_lm_batch(mesh, b) for b in case["batches"]]
    if case["eval"]:
        b = batches[0]
        got = JM.make_megatron_eval_step(jc, mesh)(
            params, b["tokens"], b["targets"], b["mask"])
        return {"eval": {k: float(v) for k, v in got.items()}}
    tx = optax.sgd(case["lr"]) if case["opt"] == "sgd" \
        else optax.adamw(case["lr"])
    opt_state = JM.init_optimizer(jc, mesh, tx, params)
    step = JM.make_megatron_train_step(jc, mesh, tx)
    losses, metrics = [], []
    for b in batches:
        params, opt_state, loss, m = step(params, opt_state, b["tokens"],
                                          b["targets"], b["mask"])
        losses.append(float(loss))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"losses": losses, "metrics": metrics,
            "params": jax.tree.map(np.asarray, jax.device_get(params))}


def check_case(world, name, case, mesh):
    """The port's world against the JAX step on ``case``."""
    want = jax_run(case, mesh)
    outs = world.results()
    got = [o["cases"][name] for o in outs]
    if case["eval"]:
        for g in got:
            np.testing.assert_allclose(g["eval"]["loss"],
                                       want["eval"]["loss"], atol=1e-5,
                                       rtol=1e-5)
            np.testing.assert_allclose(g["eval"]["accuracy"],
                                       want["eval"]["accuracy"], atol=1e-6)
            assert g["eval"]["n_tokens"] == want["eval"]["n_tokens"]
        return
    for g in got:
        np.testing.assert_allclose(g["losses"], want["losses"], atol=1e-5,
                                   rtol=1e-5)
        for mg, mw in zip(g["metrics"], want["metrics"]):
            assert mg.keys() == mw.keys()
            if "moe_dropped_frac" in mw:
                assert mg["moe_dropped_frac"] == mw["moe_dropped_frac"]
            if "moe_aux_loss" in mw:
                np.testing.assert_allclose(mg["moe_aux_loss"],
                                           mw["moe_aux_loss"], atol=1e-5,
                                           rtol=1e-5)
    cfg = TM.MegatronConfig(**case["cfg"])
    specs = dict(TM._leaves(TM.param_specs(cfg)))
    for path, ref in TM._leaves(want["params"]):
        full = assemble(outs, lambda o: o["cases"][name]["params"][path],
                        specs[path], ref.shape)
        np.testing.assert_allclose(full, ref, err_msg=path, **PARAM_TOL)


def step_name(n_experts, schedule, dispatch):
    return f"step-{n_experts}-{schedule}-{dispatch}"


def eval_name(n_experts, dispatch):
    return f"eval-{n_experts}-{dispatch}"


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cases = {}
    for e, sched, disp in STEP_CASES:
        kw = cfg_kw(n_experts=e, schedule=sched, moe_dispatch=disp,
                    capacity_factor=4.0)
        cases[step_name(e, sched, disp)] = make_case(kw, [lm_batch()])
    for e, disp in EVAL_CASES:
        kw = cfg_kw(n_experts=e, moe_dispatch=disp, capacity_factor=4.0)
        cases[eval_name(e, disp)] = make_case(kw, [ragged(lm_batch())],
                                              evaluate=True)
    return cases, World(__file__, MESH, cases,
                        tmp_path_factory.mktemp("megatron"))


@pytest.mark.parametrize("n_experts,schedule,dispatch", STEP_CASES)
def test_4d_step_matches_jax(world, devices, n_experts, schedule, dispatch):
    cases, w = world
    name = step_name(n_experts, schedule, dispatch)
    check_case(w, name, cases[name], JM.build_4d_mesh(devices))
    if n_experts and dispatch == "routed":
        assert w.results()[0]["cases"][name]["metrics"][0][
            "moe_dropped_frac"] == 0.0


@pytest.mark.parametrize("n_experts,dispatch", EVAL_CASES)
def test_4d_eval_step_matches_jax(world, devices, n_experts, dispatch):
    cases, w = world
    name = eval_name(n_experts, dispatch)
    check_case(w, name, cases[name], JM.build_4d_mesh(devices))
