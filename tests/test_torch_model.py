"""The port's TransformerLM and weight bridge against the JAX package's.

One flax param tree (``tiny``-shaped, f32) is bridged into the port; the
cacheless forward and the paged decode forward must then give the JAX
logits.  Tolerance: atol 1e-4 on f32 logits (different matmul and softmax
summation orders across two layers).
"""

import jax
import jax.numpy as jnp
import flax.linen as fnn
import numpy as np
import pytest
import torch

from dtdl_tpu.models import transformer as jtr
from dtdl_tpu.serve import InferenceEngine as JaxEngine
from dtdl_tpu_torch import bridge
from dtdl_tpu_torch.models.transformer import transformer_lm
from dtdl_tpu_torch.serve.engine import InferenceEngine

# small shapes: one intra-op thread each leaves the cores to the other
# test workers
torch.set_num_threads(1)

ATOL = 1e-4
MAX_SEQ = 48          # the 'tiny' preset cut to a 48-token arena


@pytest.fixture(scope="module")
def pair():
    jm = jtr.transformer_lm("tiny", dtype=jnp.float32, max_seq=MAX_SEQ)
    params = jax.device_get(fnn.unbox(jm.init(
        jax.random.PRNGKey(1), jnp.zeros((1, 4), jnp.int32))["params"]))
    tm = transformer_lm("tiny", device="cpu", seed=None, dtype=torch.float32,
                        max_seq=MAX_SEQ)
    bridge.load_flax_params(tm, params, device="cpu")
    return jm, params, tm


def test_bridge_round_trip(pair):
    _, params, tm = pair
    back = bridge.flatten(bridge.state_dict_to_flax(tm))
    flat = bridge.flatten(params)
    assert sorted(back) == sorted(flat)
    for path, arr in flat.items():
        np.testing.assert_array_equal(back[path], np.asarray(arr), path)
    assert back["block_0/attn/q/kernel"].shape == (64, 4, 16)   # [d, H, D]
    assert back["block_0/attn/out/kernel"].shape == (4, 16, 64)  # [H, D, d]
    assert back["block_1/mlp/wo/kernel"].shape == (128, 64)      # [d_ff, d]


def test_bridge_names_the_bad_leaf(pair):
    _, params, tm = pair
    flat = bridge.flatten(params)

    def tree_without(path):
        return {k: v for k, v in flat.items() if k != path}

    def nest(d):
        out = {}
        for path, v in d.items():
            *parents, leaf = path.split("/")
            node = out
            for key in parents:
                node = node.setdefault(key, {})
            node[leaf] = v
        return out

    with pytest.raises(bridge.BridgeError, match="block_1/mlp/wg/kernel"):
        bridge.flax_to_state_dict(tm, nest(tree_without(
            "block_1/mlp/wg/kernel")))
    with pytest.raises(bridge.BridgeError, match="block_0/attn/bias"):
        bridge.flax_to_state_dict(tm, nest(
            {**flat, "block_0/attn/bias": np.zeros(3)}))
    bad = dict(flat)
    bad["ln_f/scale"] = np.zeros(31, np.float32)
    with pytest.raises(bridge.BridgeError, match="ln_f/scale"):
        bridge.flax_to_state_dict(tm, nest(bad))


def test_presets_match_jax():
    for size in ("tiny", "small", "base", "large", "base-hd128",
                 "base-moe8"):
        jcfg = jtr.transformer_lm(size)
        tcfg = transformer_lm(size, device="cpu", seed=None).cfg
        for f in ("vocab_size", "d_model", "n_layers", "n_heads", "d_ff",
                  "max_seq", "remat", "attn_impl", "n_experts", "moe_every",
                  "moe_dispatch", "capacity_factor", "moe_top_k",
                  "moe_group_size"):
            assert getattr(tcfg, f) == getattr(jcfg, f), (size, f)
        assert tcfg.head_dim == jcfg.head_dim
    assert transformer_lm("large", device="cpu", seed=None).cfg.remat
    # quantized projections are ported: int8 payloads beside f32 scales
    q = transformer_lm("tiny", device="cpu", quantize=True).state_dict()
    assert q["block_0.attn.q.kernel"].dtype == torch.int8
    assert q["block_0.attn.q.kernel_scale"].shape == (1, 4, 16)


@pytest.mark.parametrize("attn_impl", ["flash", "dense"])
def test_full_forward_logits_match_jax(pair, attn_impl):
    """The port's cacheless forward against the JAX model: flash (the
    port's CPU path is the kernel's plain version, JAX's its Pallas flash
    kernel in the interpreter) and dense attention on both sides."""
    jm, params, tm = pair
    if attn_impl == "dense":
        tm = transformer_lm("tiny", device="cpu", seed=None,
                            dtype=torch.float32, max_seq=MAX_SEQ,
                            attn_impl="dense")
        bridge.load_flax_params(tm, params, device="cpu")
    tokens = np.random.default_rng(0).integers(0, 256, (2, 24))
    want = np.asarray(jm.clone(attn_impl=attn_impl).apply(
        {"params": params}, jnp.asarray(tokens)))
    with torch.no_grad():
        got = tm(torch.as_tensor(tokens)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_paged_decode_logits_match_jax_engine(pair):
    """Prefill (with a padded bucket) and decode steps through the paged
    arena: the port's engine logits against the JAX engine's
    (``paged_kernel=False``), step for step, with one inactive slot."""
    jm, params, tm = pair
    jm = jm.clone(attn_impl="dense")
    prompt = np.random.default_rng(2).integers(0, 256, 11).tolist()
    row = np.zeros(6, np.int32)
    row[:2] = [3, 5]
    je = JaxEngine(jm, params, n_slots=2, buckets=(8, 16, 32), page_size=8,
                   paged_kernel=False)
    te = InferenceEngine(tm, n_slots=2, buckets=(8, 16, 32), page_size=8,
                         device="cpu")
    ja, jl = je.init_arena(), je.init_last_tokens()
    ta, tl = te.init_arena(), te.init_last_tokens()
    ja, jl, jlog = je.prefill(ja, jl, 0, prompt, page_row=row)
    ta, tl, tlog = te.prefill(ta, tl, 0, prompt, page_row=row)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL)
    active = np.asarray([True, False])
    zeros = np.zeros(2, np.float32)
    for step in range(6):
        tables = np.zeros((2, 6), np.int32)
        tables[0, :2] = [3, 5]
        tables[0, 2] = 7                      # the page position 16 needs
        ja, jl, jlog = je.decode(
            ja, jl, jnp.asarray(active), jax.random.PRNGKey(0),
            jnp.zeros(2), jnp.zeros(2, jnp.int32), jnp.ones(2),
            page_tables=tables.copy())
        ta, tl, tlog = te.decode(ta, tl, active, zeros,
                                 np.zeros(2, np.int32),
                                 np.ones(2, np.float32), tables.copy())
        np.testing.assert_allclose(tlog.numpy()[0], np.asarray(jlog)[0],
                                   atol=ATOL, err_msg=f"step {step}")
        assert int(tl[0]) == int(np.asarray(jl)[0])
    assert int(ta["index"][0]) == len(prompt) + 6
    assert int(ta["index"][1]) == 0           # inactive slots stay put


def test_f32_weights_under_bf16_compute_and_the_serving_copy(pair):
    """A bf16 model holds f32 weights, as flax does (the bridge loads f32
    into f32 exactly); the engine serves a compute-dtype copy taken once,
    so a decode step casts no weight."""
    _, params, _ = pair
    tm = transformer_lm("tiny", device="cpu", seed=None, max_seq=MAX_SEQ)
    assert tm.cfg.dtype == torch.bfloat16
    bridge.load_flax_params(tm, params, device="cpu")
    assert {p.dtype for p in tm.parameters()} == {torch.float32}
    flat = bridge.flatten(params)
    for name, p in tm.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      flat[name.replace(".", "/")])
    eng = InferenceEngine(tm, n_slots=2, buckets=(8, 16), page_size=8,
                          device="cpu")
    twin = eng.model
    assert twin is not tm and not any(p.requires_grad
                                      for p in twin.parameters())
    for name, p in twin.named_parameters():
        want = torch.float32 if name.endswith(".scale") else torch.bfloat16
        assert p.dtype == want, name
        ref = dict(tm.named_parameters())[name].detach().to(want)
        assert torch.equal(p, ref), name
    tokens = torch.as_tensor(np.random.default_rng(3).integers(0, 256,
                                                               (1, 12)))
    with torch.no_grad():
        torch.testing.assert_close(twin(tokens), tm(tokens), rtol=0, atol=0)
    f32 = transformer_lm("tiny", device="cpu", dtype=torch.float32)
    assert f32.compute_copy() is f32
