"""The port's LM training step against the JAX package's, on the CPU.

One flax param tree (``tiny``, f32) is bridged into the port; the same
numpy token batches then go through ``make_lm_train_step`` in both
packages (the JAX step under ``SingleDevice``, its flash attention in the
Pallas interpreter; the port's flash attention on the CPU takes the plain
versions of K1, K2 and K3).  Loss, accuracy and every parameter after the
steps are compared.

Tolerances, f32: loss and accuracy rtol 1e-5; parameters after one sgd
step atol 1e-6 (lr 0.1 times gradients that differ by summation order).
Adam divides by the root of the second moment, so where a gradient is
near zero its sign, and with it a whole lr-sized step, can flip on
last-bit differences: after three adamw steps the parameters agree to
atol 1e-5 on all but 0.1% of the elements and to 2·lr per step on all.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dtdl_tpu.models import transformer as jtr
from dtdl_tpu.obs import goodput as jgoodput
from dtdl_tpu.train import TrainState, make_lm_train_step as jax_step
from dtdl_tpu_torch import bridge
from dtdl_tpu_torch.device import NoCudaDeviceError
from dtdl_tpu_torch.models.transformer import transformer_lm
from dtdl_tpu_torch.obs import goodput
from dtdl_tpu_torch.parallel import AutoSharded
from dtdl_tpu_torch.train.optim import adam, adamw, sgd
from dtdl_tpu_torch.train.state import init_state
from dtdl_tpu_torch.train.step import make_lm_train_step

# small shapes: one intra-op thread each leaves the cores to the other
# test workers
torch.set_num_threads(1)

MAX_SEQ = 48


@pytest.fixture(scope="module")
def params():
    jm = jtr.transformer_lm("tiny", dtype=jnp.float32, max_seq=MAX_SEQ)
    return jax.device_get(fnn.unbox(jm.init(
        jax.random.PRNGKey(2), jnp.zeros((1, 4), jnp.int32))["params"]))


def _batches(n, b=4, s=33, mask=False, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        batch = {"tokens": rng.integers(0, 256, (b, s)).astype(np.int32)}
        if mask:
            batch["mask"] = (rng.random((b, s - 1)) > 0.3).astype(np.float32)
        out.append(batch)
    return out


def _run_jax(params, tx, batches, attn_impl="dense", **kw):
    jm = jtr.transformer_lm("tiny", dtype=jnp.float32, max_seq=MAX_SEQ,
                            attn_impl=attn_impl)
    state = TrainState.create(apply_fn=jm.apply,
                              params=jax.tree.map(jnp.array, params), tx=tx)
    step = jax_step(**kw)
    metrics = []
    for batch in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, bridge.flatten(jax.device_get(state.params))


def _run_torch(params, tx, batches, dtype=torch.float32, **kw):
    model_kw = {k: kw.pop(k) for k in ("attn_impl", "remat") if k in kw}
    tm = transformer_lm("tiny", device="cpu", seed=None, dtype=dtype,
                        max_seq=MAX_SEQ, **model_kw)
    bridge.load_flax_params(tm, params, device="cpu")
    state = init_state(tm, None, tx, device="cpu")
    step = make_lm_train_step(**kw)
    metrics = []
    for batch in batches:
        state, m = step(state, batch)
        assert all(isinstance(v, torch.Tensor) and v.dim() == 0
                   for v in m.values())
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, bridge.flatten(bridge.state_dict_to_flax(tm)), state


def _assert_metrics(got, want):
    for g, w in zip(got, want):
        for key in ("loss", "accuracy"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-5,
                                       err_msg=key)


@pytest.mark.parametrize("attn_impl", ["flash", "dense"])
def test_sgd_step_matches_jax(params, attn_impl):
    """One step, sgd(0.1): the port's flash path (plain K1/K2/K3) and its
    dense path against the JAX step with the same attention."""
    batches = _batches(1)
    want_m, want_p = _run_jax(params, optax.sgd(0.1), batches,
                              attn_impl=attn_impl)
    got_m, got_p, state = _run_torch(params, sgd(0.1), batches,
                                     attn_impl=attn_impl)
    assert state.step == 1
    _assert_metrics(got_m, want_m)
    assert sorted(got_p) == sorted(want_p)
    for path, w in want_p.items():
        np.testing.assert_allclose(got_p[path], np.asarray(w), atol=1e-6,
                                   err_msg=path)
        assert not np.array_equal(got_p[path], bridge.flatten(params)[path])


def test_masked_batch_matches_jax(params):
    batches = _batches(1, mask=True, seed=3)
    want_m, want_p = _run_jax(params, optax.sgd(0.1), batches)
    got_m, got_p, _ = _run_torch(params, sgd(0.1), batches,
                                 attn_impl="dense")
    _assert_metrics(got_m, want_m)
    for path, w in want_p.items():
        np.testing.assert_allclose(got_p[path], np.asarray(w), atol=1e-6,
                                   err_msg=path)


def test_adamw_steps_match_jax(params):
    """Three adamw steps with optax's defaults on both sides."""
    lr = 1e-3
    batches = _batches(3, seed=5)
    want_m, want_p = _run_jax(params, optax.adamw(lr), batches)
    got_m, got_p, state = _run_torch(params, adamw(lr), batches,
                                     attn_impl="dense")
    _assert_metrics(got_m, want_m)
    n_far = n_all = 0
    for path, w in want_p.items():
        diff = np.abs(got_p[path] - np.asarray(w))
        assert diff.max() <= 2 * lr * len(batches), path
        n_far += int((diff > 1e-5).sum())
        n_all += diff.size
    assert n_far <= 1e-3 * n_all, (n_far, n_all)
    group = state.optimizer.param_groups[0]
    assert group["weight_decay"] == 1e-4 and group["eps"] == 1e-8


def test_vocab_chunked_head_equals_the_dense_head(params):
    batches = _batches(1, seed=7)
    dense_m, dense_p, _ = _run_torch(params, sgd(0.1), batches)
    chunk_m, chunk_p, _ = _run_torch(params, sgd(0.1), batches,
                                     vocab_chunk_size=64)
    _assert_metrics(chunk_m, dense_m)
    for path, w in dense_p.items():
        np.testing.assert_allclose(chunk_p[path], w, atol=1e-6,
                                   err_msg=path)


def test_remat_equals_no_remat(params):
    batches = _batches(2, seed=8)
    plain_m, plain_p, _ = _run_torch(params, adam(1e-3), batches)
    remat_m, remat_p, _ = _run_torch(params, adam(1e-3), batches,
                                     remat=True)
    _assert_metrics(remat_m, plain_m)
    for path, w in plain_p.items():
        np.testing.assert_allclose(remat_p[path], w, atol=1e-6,
                                   err_msg=path)


def test_bf16_model_keeps_f32_weights_grads_and_moments(params):
    """bf16 compute over f32 master weights: parameters, gradients and
    Adam moments stay f32, and an update smaller than half a bf16 unit in
    the last place is kept, not rounded away."""
    _, got_p, state = _run_torch(params, adamw(1e-5), _batches(1),
                                 dtype=torch.bfloat16)
    before = bridge.flatten(params)
    moved_below_bf16 = 0
    for name, p in state.model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
        st = state.optimizer.state[p]
        assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.float32
        w0 = before[name.replace(".", "/")]
        delta = np.abs(got_p[name.replace(".", "/")] - w0)
        half_ulp = np.abs(w0) * 2.0 ** -9
        moved_below_bf16 += int(((delta > 0) & (delta < half_ulp)).sum())
    assert moved_below_bf16 > 0
    assert state.model.cfg.dtype == torch.bfloat16


def test_loss_falls_over_ten_steps():
    """The JAX package's own LM training check (test_transformer.py
    test_lm_training_loss_decreases): tiny, one layer, remat, bf16
    compute, adam(1e-3) on one batch."""
    tm = transformer_lm("tiny", n_layers=1, remat=True, device="cpu")
    state = init_state(tm, 0, adam(1e-3), device="cpu")
    step = make_lm_train_step()
    toks = np.random.default_rng(0).integers(0, 256, (4, 32))
    losses = []
    for _ in range(10):
        state, m = step(state, {"tokens": toks})
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.9, losses


def test_lm_flops_match_jax():
    for size, seq in (("tiny", 128), ("base", 4096)):
        jm = jtr.transformer_lm(size, max_seq=seq)
        tcfg = transformer_lm(size, device="cpu", seed=None,
                              max_seq=seq).cfg
        assert goodput.lm_train_flops(tcfg, 8, seq) == \
            jgoodput.lm_train_flops(jm, 8, seq)
        assert goodput.lm_forward_flops(tcfg, 2, 64) == \
            jgoodput.lm_forward_flops(jm, 2, 64)


def test_unported_options_raise_by_name(monkeypatch):
    # a strategy is the port's object, not its name; pjit-style
    # partitioning is ported: on one process its step is the
    # single-device step
    with pytest.raises(TypeError, match="not a dtdl_tpu_torch strategy"):
        make_lm_train_step(strategy="dp")
    toks = {"tokens": np.random.default_rng(0).integers(0, 256, (2, 9))}
    losses = []
    for strategy in (AutoSharded(), None):
        m = transformer_lm("tiny", device="cpu", dtype=torch.float32)
        state = init_state(m, None, sgd(0.1), device="cpu")
        _, metrics = make_lm_train_step(strategy=strategy)(state, toks)
        losses.append(float(metrics["loss"]))
    assert losses[0] == losses[1]
    with pytest.raises(NotImplementedError, match="A13"):
        make_lm_train_step(guard=object())
    tm = transformer_lm("tiny", device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="runs on"):
        init_state(tm, 0, sgd(0.1), device="meta")
    with pytest.raises(ValueError, match="nesterov"):
        sgd(0.1, nesterov=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDeviceError):
        init_state(tm, 0, sgd(0.1))
    assert goodput.peak_flops_per_chip() is None
