"""The port's GSPMD rule sets (dtdl_tpu_torch/parallel/tensor.py) against
the JAX package's (dtdl_tpu/parallel/tensor.py): the LM training face of
tests/test_tensor_parallel.py.

A gloo world of 4 processes on a ``{data 2, model 2}`` mesh runs the
cases (this file is the worker as ``__main__``, tests/_torch_world.py the
harness) while the pytest process computes the JAX oracle.  Every case
starts from the JAX model's own init (flax, ``PRNGKey(0)``), bridged as
numpy into each rank's shards (``init_sharded_lm(params=)``), and takes
the same numpy-seeded global batches (each rank its data rows):

* placement: every leaf's spec equals the JAX ``logical_shardings`` spec
  under each preset, and every rank's shard shape equals the JAX shard
  shape on a ``{data 2, model 2}`` JAX mesh;
* each preset's loss and every gradient (the ranks' shards gathered)
  against ``jax.grad`` of the JAX model's unsharded mean loss; ``ep`` on a
  routed MoE at capacity factor 0.5, where tokens drop;
* 3 adamw steps (on one batch) of every dense preset against JAX's own
  ``tp`` step
  (``make_sharded_lm_train_step``) on its 8-device ``{data 2, model 4}``
  mesh: the same global function on another mesh;
* ``fsdp`` and ``tp_fsdp``: each rank holds its leaves' bytes over the
  axes that split them (``fsdp``: half of all), and its Adam moments
  twice that;
* the sharded eval step (``tp``, ``ep``) against the unsharded
  evaluation, ``generate`` over the ``tp`` placement token-identical to the
  JAX unsharded ``generate``;
* dims that do not divide (vocab 251, d_ff 129 under ``tp_fsdp``): GSPMD
  pads them, the port holds them whole, and the loss and gradients equal
  the unsharded ones;
* the FSDP pair of collectives, ``all_gather`` and ``reduce_scatter``
  over 'data', with their transposes, exactly in f64.

The attention is ``attn_impl='flash'`` in the port (on the CPU the
kernel wrapper's plain version, on each rank's local heads) and dense in
JAX.  Tolerances (f32): losses within rtol 1e-5, every gradient within
atol 2e-6 + rtol 1e-4 of the JAX value (the two packages sum in other
orders), trajectories within rtol 2e-5, eval accuracy within 1e-6 and
tokens exactly.
"""

import sys

from _torch_world import World, serve

AXES = ("data", "model")
MESH = (2, 2)
DENSE = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_ff=128,
             max_seq=64)
MOE = dict(DENSE, n_experts=4, moe_every=1, moe_dispatch="routed",
           capacity_factor=0.5)
PAD = dict(DENSE, vocab_size=251, d_ff=129, n_layers=1)
PRESETS = ("replicated", "tp", "fsdp", "tp_fsdp")
LR, STEPS, BATCH, SEQ = 1e-3, 3, 8, 32


def collectives_case(mesh):
    """The FSDP pair over 'data' on this rank: values and gradients of
    ``all_gather`` (plain and invariant) and ``reduce_scatter`` of
    rank-numbered inputs under rank-numbered cotangents."""
    import torch

    from dtdl_tpu_torch.parallel.collectives import all_gather, reduce_scatter
    from dtdl_tpu_torch.runtime import process_index
    r = float(process_index() + 1)
    out = {}
    for kind in ("gather", "gather_invariant", "scatter"):
        x = torch.full((4 if kind == "scatter" else 2, 3), r,
                       dtype=torch.float64, requires_grad=True)
        y = (reduce_scatter(x, mesh, "data", 0) if kind == "scatter" else
             all_gather(x, mesh, "data", 0,
                        invariant=kind == "gather_invariant"))
        w = torch.arange(y.numel(), dtype=torch.float64).reshape(y.shape) * r
        (y * w).sum().backward()
        out[kind] = (y.detach().numpy(), x.grad.numpy())
    return out


def run_case(mesh, name, case):
    """One LM case on this rank: its shard shapes, the global loss and the
    gathered gradients at the initial weights, the eval metrics and
    generated tokens there when asked, the bytes it holds, and the
    losses of ``STEPS`` adamw steps."""
    import numpy as np
    import torch

    if name == "collectives":
        return collectives_case(mesh)

    from dtdl_tpu_torch.models.transformer import generate, transformer_lm
    from dtdl_tpu_torch.parallel import tensor as T
    from dtdl_tpu_torch.runtime.mesh import batch_sharded
    from dtdl_tpu_torch.train.optim import adamw

    model = transformer_lm("tiny", device="cpu", seed=None,
                           dtype=torch.float32, attn_impl="flash",
                           **case["cfg"])
    tx = adamw(LR)
    params, opt, sh = T.init_sharded_lm(model, mesh, tx, rules=case["rules"],
                                        device="cpu", params=case["params"])
    out = {"shapes": {p: tuple(a.shape)
                      for p, a in T.placed_parameters(params).items()}}
    rows = [batch_sharded(mesh, b, device="cpu") for b in case["batches"]]
    out["loss0"] = float(T.value_and_grad(params, rows[0]))
    out["grads"] = T.gather_params(params, grads=True)
    if case.get("eval"):
        ev = T.make_sharded_lm_eval_step(model, mesh, sh, case["rules"])
        out["eval"] = {k: float(v) for k, v in ev(params, rows[0]).items()}
    if case.get("prompt") is not None:
        out["generated"] = generate(params, case["prompt"], 6).numpy()
    step = T.make_sharded_lm_train_step(model, mesh, tx, sh, case["rules"])
    out["losses"] = []
    for b in rows:
        params, opt, loss = step(params, opt, b)
        out["losses"].append(float(loss))
    out["param_bytes"] = sum(a.numel() * a.element_size()
                             for a in T.placed_parameters(params).values())
    out["opt_bytes"] = sum(v.numel() * v.element_size()
                           for st in opt.state.values() for v in st.values()
                           if isinstance(v, torch.Tensor) and v.dim())
    return out


if __name__ == "__main__":
    sys.exit(serve(run_case, AXES))

# ---- the pytest side (the JAX oracle) ---------------------------------------

import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as JP  # noqa: E402

from dtdl_tpu.models.transformer import generate as jax_generate  # noqa: E402
from dtdl_tpu.models.transformer import transformer_lm as jax_lm  # noqa: E402
from dtdl_tpu.parallel import tensor as JT  # noqa: E402
from dtdl_tpu.runtime.mesh import build_mesh as jax_mesh  # noqa: E402
from dtdl_tpu_torch.bridge import flatten  # noqa: E402
from dtdl_tpu_torch.models.transformer import transformer_lm  # noqa: E402
from dtdl_tpu_torch.parallel import tensor as T  # noqa: E402

GRAD_TOL = dict(atol=2e-6, rtol=1e-4)
PROMPT = np.random.default_rng(3).integers(0, 256, (4, 5)).astype(np.int32)


def jax_model(cfg):
    return jax_lm("tiny", attn_impl="dense", dtype=jnp.float32, **cfg)


_INITS = {}


def jax_params(cfg):
    """(JAX model, boxed params, numpy params) of ``cfg`` from PRNGKey(0)."""
    key = tuple(sorted(cfg.items()))
    if key not in _INITS:
        jm = jax_model(cfg)
        boxed = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, SEQ), jnp.int32))
        _INITS[key] = (jm, boxed["params"],
                       jax.device_get(fnn.unbox(boxed["params"])))
    return _INITS[key]


def batches(seed, vocab):
    """One batch ``STEPS`` times, as the JAX tests train (so the loss
    falls)."""
    b = np.random.default_rng(seed).integers(0, vocab, (BATCH, SEQ + 1))
    return [b.astype(np.int32)] * STEPS


def case_of(cfg, rules, seed, **kw):
    return {"cfg": cfg, "rules": rules, "params": jax_params(cfg)[2],
            "batches": batches(seed, cfg["vocab_size"]), **kw}


CASES = {**{p: case_of(DENSE, p, 0, eval=(p == "tp"),
                       prompt=PROMPT if p == "tp" else None)
            for p in PRESETS},
         "ep": case_of(MOE, "ep", 1, eval=True),
         "pad": case_of(PAD, "tp_fsdp", 2),
         "collectives": {}}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return World(__file__, MESH, CASES, tmp_path_factory.mktemp("gspmd"))


def outs(world, name):
    return [o["cases"][name] for o in world.results()]


def jax_loss_and_grads(cfg, params, tokens):
    jm = jax_model(cfg)

    def loss_fn(p):
        logits = jm.apply({"params": p}, tokens[:, :-1]).astype(jnp.float32)
        lse = jax.nn.logsumexp(logits, -1)
        true = jnp.take_along_axis(logits, tokens[:, 1:, None], -1)[..., 0]
        return jnp.mean(lse - true)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(loss), flatten(jax.device_get(grads))


@pytest.mark.parametrize("rules", PRESETS + ("ep",))
def test_placement_and_shard_shapes_match_jax(world, devices, rules):
    cfg = MOE if rules == "ep" else DENSE
    _, boxed, _ = jax_params(cfg)
    mesh = jax_mesh(shape=MESH, axes=AXES, devices=devices[:4])
    want = flatten(JT.logical_shardings(mesh, boxed, rules))
    got = T.logical_shardings(None, transformer_lm(
        "tiny", device="cpu", seed=None, dtype=torch.float32, **cfg), rules)
    shapes = {p: a.shape for p, a in flatten(jax_params(cfg)[2]).items()}
    assert set(got) == set(want)
    for path, sharding in want.items():
        spec = tuple(sharding.spec) + (None,) * (len(shapes[path])
                                                 - len(sharding.spec))
        assert tuple(got[path]) == spec, path
        for out in outs(world, rules):
            assert out["shapes"][path] == sharding.shard_shape(
                shapes[path]), (path, out["shapes"][path])


@pytest.mark.parametrize("rules", PRESETS + ("ep", "pad"))
def test_preset_loss_and_grads_match_jax_unsharded(world, rules):
    """Loss and every gradient of the sharded step at the initial weights
    against the unsharded JAX model's (``ep``: a routed MoE whose
    capacity drops tokens; ``pad``: vocab and d_ff that 'model' does not
    divide, under ``tp_fsdp``)."""
    case = CASES[rules]
    loss, grads = jax_loss_and_grads(case["cfg"], case["params"],
                                     jnp.asarray(case["batches"][0]))
    for out in outs(world, rules):
        np.testing.assert_allclose(out["loss0"], loss, rtol=1e-5)
        assert set(out["grads"]) == set(grads)
        for path, g in grads.items():
            np.testing.assert_allclose(out["grads"][path], g, **GRAD_TOL,
                                       err_msg=f"{rules}: {path}")


def test_ep_case_drops_tokens():
    """The ``ep`` case's capacity factor drops tokens: its JAX loss is not
    the no-drop (dense-dispatch) model's on the same weights."""
    case = CASES["ep"]
    tokens = jnp.asarray(case["batches"][0])
    routed, _ = jax_loss_and_grads(case["cfg"], case["params"], tokens)
    dense, _ = jax_loss_and_grads(dict(case["cfg"], moe_dispatch="dense",
                                       capacity_factor=4.0),
                                  case["params"], tokens)
    assert abs(routed - dense) > 1e-4, (routed, dense)


@pytest.fixture(scope="module")
def jax_tp_losses(devices):
    """3 adamw steps of JAX's own tp step on its 8-device mesh."""
    mesh = jax_mesh(shape=(2, 4), axes=AXES, devices=devices)
    jm = jax_model(DENSE)
    tx = optax.adamw(LR)
    params, opt, sh = JT.init_sharded_lm(jm, mesh, tx,
                                         jnp.zeros((1, SEQ), jnp.int32),
                                         rules="tp")
    step = JT.make_sharded_lm_train_step(jm, mesh, tx, sh, rules="tp")
    losses = []
    for b in CASES["tp"]["batches"]:
        params, opt, loss = step(params, opt, jax.device_put(
            jnp.asarray(b), NamedSharding(mesh, JP("data"))))
        losses.append(float(loss))
    return losses


@pytest.mark.parametrize("rules", PRESETS)
def test_preset_trajectory_matches_jax_tp_step(world, jax_tp_losses, rules):
    assert CASES[rules]["batches"][0].tobytes() == \
        CASES["tp"]["batches"][0].tobytes()
    for out in outs(world, rules):
        np.testing.assert_allclose(out["losses"], jax_tp_losses, rtol=2e-5)
    assert jax_tp_losses[-1] < jax_tp_losses[0]


@pytest.mark.parametrize("rules", ["fsdp", "tp_fsdp", "replicated"])
def test_rank_bytes_are_the_shards(world, rules):
    """Each rank holds each leaf's bytes over the sizes of the axes that
    split it (under fsdp every leaf has an 'embed' dim that 'data'
    divides: exactly half of all bytes), and its Adam moments twice
    that."""
    leaves = flatten(CASES[rules]["params"])
    specs = T.logical_shardings(None, transformer_lm(
        "tiny", device="cpu", seed=None, dtype=torch.float32, **DENSE), rules)
    want = sum(a.size * 4 // np.prod([MESH[AXES.index(x)]
                                      for x in specs[p] if x])
               for p, a in leaves.items())
    total = sum(a.size * 4 for a in leaves.values())
    if rules != "tp_fsdp":
        assert want * (2 if rules == "fsdp" else 1) == total
    for out in outs(world, rules):
        assert out["param_bytes"] == want
        assert out["opt_bytes"] == 2 * out["param_bytes"]


@pytest.mark.parametrize("rules", ["tp", "ep"])
def test_sharded_eval_matches_unsharded(world, rules):
    case = CASES[rules]
    tokens = jnp.asarray(case["batches"][0])
    jm = jax_model(case["cfg"])
    logits = jm.apply({"params": case["params"]}, tokens[:, :-1])
    lse = jax.nn.logsumexp(logits, -1)
    true = jnp.take_along_axis(logits, tokens[:, 1:, None], -1)[..., 0]
    acc = float(jnp.mean(jnp.argmax(logits, -1) == tokens[:, 1:]))
    for out in outs(world, rules):
        np.testing.assert_allclose(out["eval"]["loss"],
                                   float(jnp.mean(lse - true)), rtol=1e-5)
        np.testing.assert_allclose(out["eval"]["accuracy"], acc, atol=1e-6)
        assert out["eval"]["n_tokens"] == BATCH * SEQ


def test_tp_generate_token_identical(world):
    want = np.asarray(jax_generate(jax_model(DENSE), CASES["tp"]["params"],
                                   jnp.asarray(PROMPT), 6))
    for out in outs(world, "tp"):
        np.testing.assert_array_equal(out["generated"], want)


def test_fsdp_gather_and_scatter_transposes(world):
    """all_gather's backward reduce-scatters (each rank's use differs),
    the invariant gather's keeps this rank's part (every rank uses the
    whole alike), and reduce_scatter's is all_gather: exact, in f64, on
    each 'data' line of the world ({data 2, model 2}: world ranks m and
    2 + m form the line of model coordinate m)."""
    for out in world.results():
        d, m = out["coords"]["data"], out["coords"]["model"]
        v = [m + 1.0, m + 3.0]                  # the line's inputs
        me = v[d]
        got = out["cases"]["collectives"]
        rows = slice(2 * d, 2 * d + 2)
        ar12 = np.arange(12.0).reshape(4, 3)
        ar6 = np.arange(6.0).reshape(2, 3)
        y, g = got["gather"]
        np.testing.assert_array_equal(y, np.repeat(v, 6).reshape(4, 3))
        np.testing.assert_array_equal(g, ar12[rows] * sum(v))
        y, g = got["gather_invariant"]
        np.testing.assert_array_equal(y, np.repeat(v, 6).reshape(4, 3))
        np.testing.assert_array_equal(g, ar12[rows] * me)
        y, g = got["scatter"]
        np.testing.assert_array_equal(y, np.full((2, 3), sum(v)))
        np.testing.assert_array_equal(g, np.concatenate([ar6 * v[0],
                                                         ar6 * v[1]]))
