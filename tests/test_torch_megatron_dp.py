"""The port's 4D step against the JAX package's on a data-parallel mesh
(``{data 2, seq 1, pipe 2, model 2}``, the ``4D[dp2]`` of
MULTICHIP_r05.json), and the parts of the 4D path that need no world.

A gloo world of 8 processes runs the cases as tests/test_torch_megatron.py
runs its own (this file is the worker as ``__main__``); at 'seq' 1 with
``fuse_rope=True`` the attend is ``flash_attention`` with the rotary
embedding fused (the card's path, K1-K3 there; the plain versions on the
CPU), against the JAX Pallas kernel in interpret mode.

Without a world: the port's one-process mesh ``(1, 1, 1, 1)`` (the
card's mesh) against the JAX step on one device; ``factor_mesh``,
``n_pipeline_ticks`` and ``bubble_fraction`` equal to JAX's over a grid;
``to_flax_params`` equal to JAX's (dense, ``virtual_stages=2``, MoE);
the port's ``TransformerLM`` from ``to_flax_model`` and the converted
weights against the JAX ``to_flax_model`` logits; the refusals.

Tolerances (f32): the loss within 1e-5; parameters within
``PARAM_TOL`` (2e-4); converted trees exactly equal; logits within atol
2e-5, rtol 1e-4 (tests/test_megatron.py's bridge test).
"""

import sys

from _torch_world import World, run_megatron_case, serve

AXES = ("data", "seq", "pipe", "model")
MESH = (2, 1, 2, 2)
DP_CASES = [(0, "1f1b", "dense"), (4, "gpipe", "routed")]

if __name__ == "__main__":
    sys.exit(serve(run_megatron_case, AXES))

# ---- the pytest side (the JAX oracle) ---------------------------------------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from dtdl_tpu.parallel import megatron as JM  # noqa: E402
from dtdl_tpu_torch.bridge import load_flax_params  # noqa: E402
from dtdl_tpu_torch.parallel import megatron as TM  # noqa: E402
from dtdl_tpu_torch.runtime.mesh import build_mesh  # noqa: E402
from dtdl_tpu_torch.train.optim import sgd  # noqa: E402
from test_torch_megatron import (PARAM_TOL, cfg_kw, check_case,  # noqa: E402
                                 jax_mesh, jax_run, lm_batch, make_case)


def dp_name(n_experts, schedule, dispatch):
    return f"dp-{n_experts}-{schedule}-{dispatch}"


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cases = {dp_name(*c): make_case(
        cfg_kw(n_experts=c[0], schedule=c[1], moe_dispatch=c[2],
               capacity_factor=4.0), [lm_batch(seed=21)], seed=22)
        for c in DP_CASES}
    return cases, World(__file__, MESH, cases,
                        tmp_path_factory.mktemp("dp2"))


@pytest.mark.parametrize("n_experts,schedule,dispatch", DP_CASES)
def test_dp2_mesh_step_matches_jax(world, devices, n_experts, schedule,
                                   dispatch):
    cases, w = world
    name = dp_name(n_experts, schedule, dispatch)
    check_case(w, name, cases[name], jax_mesh(MESH, devices))


@pytest.mark.parametrize("n_experts,schedule,dispatch", [
    (0, "1f1b", "dense"), (4, "1f1b", "routed")])
def test_world_of_one_matches_jax(devices, n_experts, schedule, dispatch):
    """The card's mesh, (1, 1, 1, 1), in this process: no group, every
    collective an identity, the flash attend with fused rope."""
    kw = cfg_kw(n_stages=1, n_microbatches=4, n_experts=n_experts,
                schedule=schedule, moe_dispatch=dispatch,
                capacity_factor=4.0)
    case = make_case(kw, [lm_batch(seed=4)], seed=5)
    want = jax_run(case, jax_mesh((1, 1, 1, 1), devices))
    mesh = build_mesh((1, 1, 1, 1), TM.AXES)
    assert mesh.group is None and mesh.axis_group(TM.AXES) is None
    cfg = TM.MegatronConfig(**kw, dtype=torch.float32)
    params = TM.place_params(mesh, cfg, case["params"], device="cpu")
    opt = TM.init_optimizer(cfg, mesh, sgd(0.1), params)
    b = TM.shard_lm_batch(mesh, case["batches"][0], device="cpu")
    params, _, loss, metrics = TM.make_megatron_train_step(
        cfg, mesh, sgd(0.1))(params, opt, b["tokens"], b["targets"],
                             b["mask"])
    np.testing.assert_allclose(float(loss), want["losses"][0], atol=1e-5,
                               rtol=1e-5)
    assert metrics.keys() == want["metrics"][0].keys()
    for (path, got), (_, ref) in zip(TM._leaves(params),
                                     TM._leaves(want["params"])):
        np.testing.assert_allclose(got.detach().numpy(), ref, err_msg=path,
                                   **PARAM_TOL)


def test_factor_mesh_ticks_and_bubble_equal_jax():
    for n in (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 64, 128, 256):
        assert TM.factor_mesh(n) == JM.factor_mesh(n)
    for S in (1, 2, 4):
        for M in (1, 2, 3, 4, 8, 16):
            for v in (1, 2):
                kw = dict(n_stages=S, n_microbatches=M, virtual_stages=v,
                          layers_per_stage=2)
                tc, jc = TM.MegatronConfig(**kw), JM.MegatronConfig(**kw)
                assert TM.n_pipeline_ticks(tc) == JM.n_pipeline_ticks(jc)
                assert TM.bubble_fraction(tc) == JM.bubble_fraction(jc)


BRIDGE_CASES = [(0, 1), (0, 2), (4, 1)]


def bridge_cfgs(n_experts, virtual):
    kw = cfg_kw(n_experts=n_experts, layers_per_stage=2,
                virtual_stages=virtual, moe_dispatch="dense")
    del kw["fuse_rope"]
    return (TM.MegatronConfig(**kw, dtype=torch.float32),
            JM.MegatronConfig(**kw, dtype=jnp.float32))


@pytest.mark.parametrize("n_experts,virtual", BRIDGE_CASES)
def test_to_flax_params_equals_jax(n_experts, virtual):
    tc, jc = bridge_cfgs(n_experts, virtual)
    params = jax.tree.map(np.asarray, JM.init_params(
        jc, jax.random.PRNGKey(0)))
    got = dict(TM._leaves(TM.to_flax_params(tc, params)))
    want = dict(TM._leaves(jax.tree.map(np.asarray,
                                        JM.to_flax_params(jc, params))))
    assert got.keys() == want.keys()
    for path, ref in want.items():
        np.testing.assert_array_equal(got[path], ref, err_msg=path)


@pytest.mark.parametrize("n_experts,virtual", BRIDGE_CASES)
def test_converted_model_logits_match_jax(n_experts, virtual):
    """The serving bridge: the port's TransformerLM from to_flax_model,
    loaded with to_flax_params, computes the JAX to_flax_model's logits."""
    tc, jc = bridge_cfgs(n_experts, virtual)
    params = jax.tree.map(np.asarray, JM.init_params(
        jc, jax.random.PRNGKey(1)))
    toks = np.random.default_rng(0).integers(0, tc.vocab_size, (2, 16))
    jlm = JM.to_flax_model(jc)
    want = jlm.apply({"params": JM.to_flax_params(jc, params)},
                     jnp.asarray(toks, jnp.int32))
    lm = TM.to_flax_model(tc, device="cpu")
    assert (lm.cfg.moe_every, lm.cfg.attn_impl, lm.cfg.dtype) == \
        (1, "dense", torch.float32)
    load_flax_params(lm, TM.to_flax_params(tc, params), device="cpu")
    with torch.no_grad():
        got = lm(torch.as_tensor(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)


def test_refusals_and_validation():
    mesh = build_mesh((1, 1, 1, 1), TM.AXES)
    cfg = TM.MegatronConfig(n_stages=1, dtype=torch.float32)
    # tensor-parallel serving is ported; rules without the mesh the
    # shards land on still raises, as the JAX serve_engine does
    with pytest.raises(ValueError, match="mesh"):
        TM.serve_engine(cfg, TM.init_params(cfg), rules="tp", device="cpu")
    eng = TM.serve_engine(cfg, TM.init_params(cfg), rules="tp", device="cpu",
                          mesh=build_mesh((1, 1), ("data", "model")))
    assert eng.compile_stats()["tp"] == {"rules": "tp",
                                         "mesh": {"data": 1, "model": 1}}
    with pytest.raises(ValueError, match="must equal mesh 'pipe'"):
        TM.make_megatron_train_step(TM.MegatronConfig(n_stages=2), mesh,
                                    sgd(0.1))
    with pytest.raises(ValueError, match="requires schedule='1f1b'"):
        TM.make_megatron_train_step(TM.MegatronConfig(
            n_stages=1, layers_per_stage=2, schedule="gpipe",
            virtual_stages=2), mesh, sgd(0.1))
    with pytest.raises(ValueError, match="unknown pipeline schedule"):
        TM.make_megatron_train_step(TM.MegatronConfig(
            n_stages=1, schedule="zb"), mesh, sgd(0.1))
    with pytest.raises(ValueError, match="n_microbatches"):
        params = TM.place_params(mesh, cfg, TM.init_params(cfg),
                                 device="cpu")
        b = TM.shard_lm_batch(mesh, lm_batch(B=3, vocab=256), device="cpu")
        TM.make_megatron_eval_step(cfg, mesh)(params, b["tokens"],
                                              b["targets"], b["mask"])
    with pytest.raises(ValueError, match="moe_top_k"):
        TM.MegatronConfig(n_experts=2, moe_top_k=3)


def test_serve_engine_greedy_equals_generate():
    """serve_engine wraps the port's engine around the converted model:
    its greedy tokens are the converted model's own generate."""
    from dtdl_tpu_torch.models.transformer import generate
    from dtdl_tpu_torch.serve.scheduler import Request, Scheduler
    cfg = TM.MegatronConfig(n_stages=1, layers_per_stage=2, max_seq=64,
                            dtype=torch.float32)
    params = TM.init_params(cfg, seed=3)
    engine = TM.serve_engine(cfg, params, n_slots=2, buckets=(8, 16),
                             page_size=16, device="cpu")
    prompts = [np.random.default_rng(i).integers(0, 256, n).tolist()
               for i, n in enumerate((3, 7))]
    reqs = [Request(p, 4) for p in prompts]
    Scheduler(engine, device="cpu").run(reqs)
    lm = TM.to_flax_model(cfg, device="cpu")
    load_flax_params(lm, TM.to_flax_params(cfg, params), device="cpu")
    for r, p in zip(reqs, prompts):
        want = generate(lm, np.asarray([p]), 4)[0, len(p):].tolist()
        assert r.done and r.tokens == want


def test_abstract_state_is_the_shards_restore_target(tmp_path):
    """abstract_state's trees have this rank's shard shapes, and a
    snapshot of a trained step restores into them bitwise."""
    from dtdl_tpu_torch.ckpt import Checkpointer
    from dtdl_tpu_torch.train.optim import adamw
    mesh = build_mesh((1, 1, 1, 1), TM.AXES)
    cfg = TM.MegatronConfig(n_stages=1, n_experts=4, dtype=torch.float32)
    params = TM.place_params(mesh, cfg, TM.init_params(cfg, 2),
                             device="cpu")
    tx = adamw(1e-3)
    opt = TM.init_optimizer(cfg, mesh, tx, params)
    b = TM.shard_lm_batch(mesh, lm_batch(vocab=256), device="cpu")
    TM.make_megatron_train_step(cfg, mesh, tx)(params, opt, b["tokens"],
                                               b["targets"], b["mask"])
    a_params, a_opt = TM.abstract_state(cfg, mesh, tx, device="cpu")
    assert [a.shape for _, a in TM._leaves(a_params)] == \
        [a.shape for _, a in TM._leaves(params)]
    assert TM.opt_state_specs(cfg) == TM.param_specs(cfg)
    with Checkpointer(str(tmp_path)) as ck:
        ck.save(1, {"params": params, "step": 1,
                    "opt_state": TM.opt_state_tree(params, opt)})
    snap, at = Checkpointer(str(tmp_path)).restore(
        {"params": a_params, "opt_state": a_opt, "step": 0})
    assert at == 1 and snap["step"] == 1
    for (path, got), (_, want) in zip(TM._leaves(snap["params"]),
                                      TM._leaves(params)):
        assert torch.equal(got, want), path
    live = dict(TM._leaves(TM.opt_state_tree(params, opt)))
    for path, got in TM._leaves(snap["opt_state"]):
        assert torch.equal(got, live[path]), path
