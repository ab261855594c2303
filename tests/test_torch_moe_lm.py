"""The port's MoE language model against the JAX package's.

A tiny routed MoE LM (vocab 64, d_model 32, 2 layers, 2 heads, d_ff 64,
max_seq 48, 4 experts, capacity factor 1.25, f32) with MoE blocks every
layer (``moe_every=1``) or every second (``moe_every=2``); the flax params
are bridged into the port and the same numpy-seeded tokens go through
both packages: the cacheless forward, one train step of
``make_lm_train_step`` (Switch aux loss; dense and vocab-chunked head;
remat), ``generate``, the quantized experts, and the goodput FLOPs of
``base-moe8``.

Tolerances, each stated where it is used: f32 logits atol 1e-4 (matmul
and softmax summation orders over two layers, as
tests/test_torch_model.py); loss, accuracy and ``moe_aux_loss`` rtol
1e-5; parameters after one sgd(0.1) step atol 1e-6 (as
tests/test_torch_train.py); greedy tokens, quantized payloads and scales
and FLOP counts exact.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dtdl_tpu import quant as jq
from dtdl_tpu.models import transformer as jtr
from dtdl_tpu.obs import goodput as jgoodput
from dtdl_tpu.train import TrainState, make_lm_train_step as jax_step
from dtdl_tpu_torch import bridge, quant
from dtdl_tpu_torch.models import generate
from dtdl_tpu_torch.models.transformer import transformer_lm
from dtdl_tpu_torch.obs import goodput
from dtdl_tpu_torch.train.optim import sgd
from dtdl_tpu_torch.train.state import init_state
from dtdl_tpu_torch.train.step import make_lm_train_step

torch.set_num_threads(1)

VOCAB = 64
CFG = dict(vocab_size=VOCAB, d_model=32, n_layers=2, n_heads=2, d_ff=64,
           max_seq=48, n_experts=4, moe_dispatch="routed",
           capacity_factor=1.25)
ATOL = 1e-4
_PAIRS = {}


def moe_pair(moe_every, **over):
    """The JAX model (dense attention, f32) and params of the tiny MoE LM,
    and the port's model with those weights; cached per config."""
    key = (moe_every, tuple(sorted(over.items())))
    if key not in _PAIRS:
        cfg = dict(CFG, moe_every=moe_every, **over)
        jm = jtr.transformer_lm("tiny", attn_impl="dense", dtype=jnp.float32,
                                **cfg)
        params = jax.device_get(fnn.unbox(jax.jit(jm.init)(
            jax.random.PRNGKey(moe_every), jnp.zeros((1, 4), jnp.int32))
            ["params"]))
        tm = transformer_lm("tiny", device="cpu", seed=None,
                            dtype=torch.float32, **cfg)
        bridge.load_flax_params(tm, params, device="cpu")
        _PAIRS[key] = (jm, params, tm)
    return _PAIRS[key]


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, VOCAB, shape).astype(
        np.int32)


@pytest.mark.parametrize("moe_every", [1, 2])
def test_moe_blocks_and_bridge_names(moe_every):
    """MoE blocks where (i + 1) % moe_every == 0, as JAX builds them: the
    port's parameter names are the flax tree's paths leaf for leaf, and
    the bridge carries them back out unchanged."""
    _, params, tm = moe_pair(moe_every)
    flat = bridge.flatten(params)
    back = bridge.flatten(bridge.state_dict_to_flax(tm))
    assert sorted(back) == sorted(flat)
    for path, arr in flat.items():
        np.testing.assert_array_equal(back[path], np.asarray(arr), path)
    moe = [i for i in range(2) if f"block_{i}/moe/wi" in flat]
    assert moe == [i for i in range(2) if (i + 1) % moe_every == 0]
    assert back["block_1/moe/router/kernel"].shape == (32, 4)
    assert back["block_1/moe/wo"].shape == (4, 64, 32)
    assert tm.block_1.moe.router.kernel.dtype == torch.float32
    bad = dict(flat)
    bad["block_1/moe/wg"] = np.zeros((4, 32, 63), np.float32)
    with pytest.raises(bridge.BridgeError, match="block_1/moe/wg"):
        bridge.flax_to_state_dict(tm, _nest(bad))


def _nest(flat):
    out = {}
    for path, v in flat.items():
        *parents, leaf = path.split("/")
        node = out
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = v
    return out


@pytest.mark.parametrize("moe_every,dispatch", [(1, "routed"), (2, "routed"),
                                                (2, "dense")])
def test_moe_lm_logits_match_jax(moe_every, dispatch):
    """The cacheless forward (the port's flash path, plain on the CPU)
    against the JAX forward: routed with drops at capacity 1.25, and the
    dense oracle; atol 1e-4."""
    jm, params, tm = moe_pair(moe_every, moe_dispatch=dispatch)
    toks = _tokens(0, (2, 24))
    want = np.asarray(jax.jit(jm.apply)({"params": params},
                                        jnp.asarray(toks)))
    with torch.no_grad():
        got = tm(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def _run_jax(jm, params, batch, **kw):
    state = TrainState.create(apply_fn=jm.apply,
                              params=jax.tree.map(jnp.array, params),
                              tx=optax.sgd(0.1))
    state, m = jax_step(**kw)(state, {"tokens": jnp.asarray(batch)})
    return ({k: float(v) for k, v in m.items()},
            bridge.flatten(jax.device_get(state.params)))


@pytest.mark.parametrize("moe_every,weight,chunk,remat", [
    (2, 0.01, 0, False), (2, 0.0, 0, False), (2, 0.01, 32, False),
    (2, 0.01, 0, True), (1, 0.01, 0, False)])
def test_moe_train_step_matches_jax(moe_every, weight, chunk, remat):
    """One sgd(0.1) step: loss (with moe_aux_weight times the layer-mean
    aux), accuracy and moe_aux_loss within rtol 1e-5, every parameter
    after the step within atol 1e-6.  A weight of 0 still reports the
    metric; remat checkpoints each block and must not count an aux twice;
    the vocab-chunked head adds the same aux."""
    jm, params, _ = moe_pair(moe_every)
    batch = _tokens(10 + moe_every, (4, 33))
    want_m, want_p = _run_jax(jm.clone(remat=remat), params, batch,
                              moe_aux_weight=weight,
                              vocab_chunk_size=chunk)
    tm = transformer_lm("tiny", device="cpu", seed=None, dtype=torch.float32,
                        remat=remat, moe_every=moe_every, **CFG)
    bridge.load_flax_params(tm, params, device="cpu")
    state = init_state(tm, None, sgd(0.1), device="cpu")
    state, m = make_lm_train_step(moe_aux_weight=weight,
                                  vocab_chunk_size=chunk)(state,
                                                          {"tokens": batch})
    got_m = {k: float(v) for k, v in m.items()}
    assert sorted(got_m) == sorted(want_m) == ["accuracy", "loss",
                                               "moe_aux_loss"]
    for key, w in want_m.items():
        np.testing.assert_allclose(got_m[key], w, rtol=1e-5, err_msg=key)
    assert got_m["moe_aux_loss"] > 0
    got_p = bridge.flatten(bridge.state_dict_to_flax(tm))
    for path, w in want_p.items():
        np.testing.assert_allclose(got_p[path], np.asarray(w), atol=1e-6,
                                   err_msg=path)
    # the router trains (through the gates, and the aux when weighted)
    assert not np.array_equal(got_p["block_1/moe/router/kernel"],
                              params["block_1"]["moe"]["router"]["kernel"])


def test_serving_copy_keeps_the_router_f32():
    """bf16 compute over f32 weights: the serving copy holds the experts
    in bf16 and the router in f32 (JAX's router is an f32 Dense), and its
    forward returns the training model's logits exactly (both round the
    same f32 weights to bf16, one at each use, one once)."""
    tm = transformer_lm("tiny", device="cpu", moe_every=2, **CFG)
    twin = tm.compute_copy()
    assert tm.block_1.moe.wi.dtype == torch.float32
    assert twin.block_1.moe.wi.dtype == torch.bfloat16
    assert twin.block_1.moe.router.kernel.dtype == torch.float32
    toks = torch.from_numpy(_tokens(4, (1, 16)))
    with torch.no_grad():
        torch.testing.assert_close(twin(toks), tm(toks), rtol=0, atol=0)


def test_dense_model_reports_no_aux():
    tm = transformer_lm("tiny", device="cpu", dtype=torch.float32,
                        max_seq=48)
    state = init_state(tm, None, sgd(0.1), device="cpu")
    _, m = make_lm_train_step()(state, {"tokens": _tokens(1, (2, 9))})
    assert sorted(m) == ["accuracy", "loss"]
    with torch.no_grad():
        _, aux = tm(torch.from_numpy(_tokens(1, (1, 5))), return_aux=True)
    assert aux == []


@pytest.mark.parametrize("moe_every", [1, 2])
def test_moe_generate_matches_jax(moe_every):
    """Greedy generate over the dense decode cache: the prompt's prefill
    routes [2, 9] tokens (drops at capacity 1.25), each step [2, 1];
    tokens identical to the JAX generate."""
    jm, params, tm = moe_pair(moe_every)
    prompt = _tokens(20, (2, 9))
    want = np.asarray(jtr.generate(jm, params, jnp.asarray(prompt), 20))
    got = generate(tm, prompt, 20)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantized_experts_match_jax(mode):
    """quantize_params covers the expert weights (per-(expert, out-channel)
    scales [E, 1, out]) and leaves the router f32: the port's tree is
    JAX's, payloads and scales bitwise (fp8 through uint8); JAX's
    quantized tree crosses the bridge to the same state; the quantized
    forward within atol 1e-5 of JAX's quantized forward (same payloads)
    and within the stated budget of the float logits (5% of their range
    for int8, 15% for fp8, tests/test_torch_quant.py)."""
    jm, params, tm = moe_pair(2)
    wmode = True if mode == "int8" else "w8f"
    jq_params = jax.device_get(jq.quantize_params(jm, params, wmode))
    jtree = bridge.flatten(jq_params)
    ttree = quant.quantize_params(tm, tm.state_dict(), wmode)
    assert sorted(k.replace(".", "/") for k in ttree) == sorted(jtree)
    assert "block_1/moe/wi_scale" in jtree
    assert "block_1/moe/router/kernel_scale" not in jtree
    for name, t in ttree.items():
        j = jtree[name.replace(".", "/")]
        assert tuple(t.shape) == j.shape, name
        np.testing.assert_array_equal(_bits(t), _bits(j), err_msg=name)
    qm = tm.clone(quantize=wmode)
    bridge.load_flax_params(qm, jtree, device="cpu")
    for name, t in qm.state_dict().items():
        np.testing.assert_array_equal(_bits(t), _bits(ttree[name]),
                                      err_msg=name)
    toks = _tokens(3, (2, 12))
    with torch.no_grad():
        lf = tm(torch.from_numpy(toks)).numpy()
        lq = qm(torch.from_numpy(toks)).numpy()
    budget = (0.05 if mode == "int8" else 0.15) * np.abs(lf).max()
    assert np.abs(lq - lf).max() <= budget
    want = jax.jit(jm.clone(quantize=wmode).apply)(
        {"params": jq_params}, jnp.asarray(toks))
    np.testing.assert_allclose(lq, np.asarray(want), rtol=0, atol=1e-5)


def _bits(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.float8_e4m3fn:
            return x.view(torch.uint8).numpy()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    x = np.asarray(x)
    if x.dtype.itemsize == 1 and x.dtype != np.int8:
        return x.view(np.uint8)
    if x.dtype.name == "bfloat16":
        return x.view(np.int16)
    return x


def test_base_moe8_preset_and_flops_match_jax():
    """base-moe8's config field for field, and the goodput FLOPs (MoE
    layers at top_k x the dense MLP) equal to dtdl_tpu.obs.goodput's."""
    jm = jtr.transformer_lm("base-moe8", max_seq=4096)
    tcfg = transformer_lm("base-moe8", device="cpu", seed=None,
                          max_seq=4096).cfg
    for f in ("n_experts", "moe_every", "moe_dispatch", "capacity_factor",
              "moe_top_k", "moe_group_size", "d_model", "d_ff", "n_layers"):
        assert getattr(tcfg, f) == getattr(jm, f), f
    assert goodput.lm_train_flops(tcfg, 8, 4096) == \
        jgoodput.lm_train_flops(jm, 8, 4096)
    tcfg2 = transformer_lm("base-moe8", device="cpu", seed=None,
                           max_seq=4096, moe_top_k=2).cfg
    assert goodput.lm_forward_flops(tcfg2, 2, 64) == \
        jgoodput.lm_forward_flops(jm.clone(moe_top_k=2), 2, 64)
    # top-1 credits one expert per token: the dense base's FLOPs
    base = transformer_lm("base", device="cpu", seed=None).cfg
    assert goodput.lm_forward_flops(tcfg, 2, 64) == \
        goodput.lm_forward_flops(base, 2, 64)
