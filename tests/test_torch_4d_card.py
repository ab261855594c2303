"""The 4D-parallel step on the card: the one-process mesh ``(1, 1, 1, 1)``
through kernels K1-K3.

These need the card: they carry the ``cuda`` marker and skip, with the
reason, where no CUDA device is visible.  On the card: ``python -m
pytest tests/test_torch_4d_card.py -m cuda``.

1. One 1F1B sgd(0.1) step of a 2-layer f32 config (d_model 128, 2 heads
   of 64, seq 256, 2 microbatches) against the port's single-device
   ``make_lm_train_step`` on ``to_flax_model`` (flash attention) with the
   weights ``to_flax_params`` converts: the loss within 1e-5 and every
   parameter within atol 2e-4, rtol 2e-4 (tests/test_megatron.py's
   ``PARAM_TOL``); K1 launched 2·M·L times (the forward, then its
   recompute at the backward tick), K2 and K3 M·L times.
2. The same step with ``fuse_rope=True`` (K1-K3) and ``False``
   (apply_rope and the plain ring attend): parameters within the same
   tolerance, and no kernel launched by the unfused step.
3. With four cards, an NCCL world of four processes (this file as the
   ranks' ``__main__``, tests/_torch_world.py) at ``{pipe 2, model 2}``
   (K1-K3) and ``{seq 2, model 2}`` (the fused ring over NCCL hops): the
   same step's parameters, assembled from the ranks' shards, against
   the single-device step, within the same tolerance.  It skips below
   four cards; on a four-card host: ``python3 -m pytest
   tests/test_torch_4d_card.py -m cuda -k nccl``.
"""

import sys

import numpy as np
import pytest
import torch

from dtdl_tpu_torch import kernels
from dtdl_tpu_torch.bridge import load_flax_params, state_dict_to_flax
from dtdl_tpu_torch.parallel import megatron as M
from dtdl_tpu_torch.runtime.mesh import build_mesh
from dtdl_tpu_torch.train.optim import sgd
from dtdl_tpu_torch.train.state import init_state
from dtdl_tpu_torch.train.step import make_lm_train_step

from _torch_world import World, assemble, serve  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = dict(atol=2e-4, rtol=2e-4)
B, S = 4, 256
NCCL_MESHES = [(1, 1, 2, 2), (1, 2, 1, 2)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the 4D step's attend runs the "
                    "hand-written kernels, which have no CPU path")
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build()
    return torch.device("cuda")


def config(**kw):
    return M.MegatronConfig(**{
        **dict(vocab_size=512, d_model=128, n_heads=2, d_ff=256, n_stages=1,
               layers_per_stage=2, max_seq=S, n_microbatches=2,
               dtype=torch.float32), **kw})


def batch(seed=0):
    toks = np.random.default_rng(seed).integers(0, 512, (B, S + 1))
    return toks, {"tokens": toks[:, :-1].astype(np.int32),
                  "targets": toks[:, 1:].astype(np.int32),
                  "mask": np.ones((B, S), np.float32)}


def step_4d(cfg, params, host):
    mesh = build_mesh((1, 1, 1, 1), M.AXES)
    p = M.place_params(mesh, cfg, params)
    opt = M.init_optimizer(cfg, mesh, sgd(0.1), p)
    b = M.shard_lm_batch(mesh, host)
    kernels.reset_launches()
    p, _, loss, _ = M.make_megatron_train_step(cfg, mesh, sgd(0.1))(
        p, opt, b["tokens"], b["targets"], b["mask"])
    torch.cuda.synchronize()
    return float(loss), p, dict(kernels.LAUNCHES)


def single_device_step(cfg, params, toks):
    """(loss, flax tree) of the single-device step on to_flax_model."""
    lm = M.to_flax_model(cfg, attn_impl="flash")
    load_flax_params(lm, M.to_flax_params(cfg, params))
    state = init_state(lm, None, sgd(0.1))
    state, metrics = make_lm_train_step()(state, {"tokens": toks})
    return float(metrics["loss"]), dict(M._leaves(state_dict_to_flax(lm)))


def check_flax(cfg, params_4d, want):
    for path, x in M._leaves(M.to_flax_params(cfg, params_4d)):
        np.testing.assert_allclose(x, want[path], err_msg=path, **TOL)


def test_4d_step_matches_the_single_device_step(card):
    cfg = config(fuse_rope="auto")
    params = M.init_params(cfg, seed=0)
    toks, host = batch()
    loss, p4, launches = step_4d(cfg, params, host)
    L, Mb = cfg.n_layers, cfg.n_microbatches
    assert launches["flash_fwd"] == 2 * Mb * L
    assert launches["flash_bwd_dq"] == launches["flash_bwd_dkv"] == Mb * L
    want_loss, want = single_device_step(cfg, params, toks)
    np.testing.assert_allclose(want_loss, loss, atol=1e-5, rtol=1e-5)
    check_flax(cfg, p4, want)


def test_fused_and_unfused_rope_steps_agree(card):
    params = M.init_params(config(), seed=1)
    _, host = batch(1)
    lf, pf, lf_launch = step_4d(config(fuse_rope=True), params, host)
    lu, pu, lu_launch = step_4d(config(fuse_rope=False), params, host)
    assert lf_launch["flash_fwd"] > 0 and lu_launch["flash_fwd"] == 0
    np.testing.assert_allclose(lf, lu, atol=1e-5, rtol=1e-5)
    for (path, a), (_, b) in zip(M._leaves(pf), M._leaves(pu)):
        np.testing.assert_allclose(a.detach().cpu().numpy(),
                                   b.detach().cpu().numpy(), err_msg=path,
                                   **TOL)


def run_nccl_case(mesh, name, case):
    """One rank of the NCCL world: the step on this rank's shards."""
    cfg = config(**case["cfg"])
    p = M.place_params(mesh, cfg, case["params"])
    opt = M.init_optimizer(cfg, mesh, sgd(0.1), p)
    b = M.shard_lm_batch(mesh, case["batch"])
    kernels.reset_launches()
    p, _, loss, _ = M.make_megatron_train_step(cfg, mesh, sgd(0.1))(
        p, opt, b["tokens"], b["targets"], b["mask"])
    torch.cuda.synchronize()
    return {"loss": float(loss), "launches": dict(kernels.LAUNCHES),
            "params": {k: a.detach().cpu().numpy()
                       for k, a in M._leaves(p)}}


@pytest.mark.parametrize("shape", NCCL_MESHES)
def test_4d_step_over_nccl_matches_the_single_device_step(card, tmp_path,
                                                          shape):
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards: an NCCL world of one process a card")
    kw = dict(n_stages=shape[2], layers_per_stage=2 // shape[2])
    cfg = config(**kw)
    params = M.init_params(cfg, seed=2)
    toks, host = batch(2)
    case = {"cfg": kw, "params": {k: v for k, v in params.items()},
            "batch": host}
    outs = World(__file__, shape, {"step": case}, tmp_path,
                 device="cuda").results()
    got = [o["cases"]["step"] for o in outs]
    want_loss, want = single_device_step(cfg, params, toks)
    for g in got:
        np.testing.assert_allclose(g["loss"], want_loss, atol=1e-5,
                                   rtol=1e-5)
        assert (g["launches"]["flash_fwd"] > 0) == (shape[1] == 1)
    specs = dict(M._leaves(M.param_specs(cfg)))
    full = {}
    for path, ref in M._leaves(params):
        full[path] = assemble(outs, lambda o: o["cases"]["step"]["params"][
            path], specs[path], tuple(ref.shape))
    nest = {"embed": full["embed"], "ln_f": full["ln_f"],
            "blocks": {k.split("/", 1)[1]: v for k, v in full.items()
                       if k.startswith("blocks/")}}
    check_flax(cfg, nest, want)


if __name__ == "__main__":
    sys.exit(serve(run_nccl_case, M.AXES))
