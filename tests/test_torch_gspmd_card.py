"""The GSPMD rule sets on the card (dtdl_tpu_torch/parallel/tensor.py,
``InferenceEngine(mesh=, rules=)``), through kernels K1-K4.

These need the card: they carry the ``cuda`` marker and skip, with the
reason, where no CUDA device is visible.  On the card: ``python -m
pytest tests/test_torch_gspmd_card.py -m cuda``.

1. The one-process mesh ``(data 1, model 1)``: one ``tp`` sgd(0.1) step
   of a 2-layer f32 LM (d_model 128, 4 heads of 32, seq 256) through
   K1-K3 against the single-device ``make_lm_train_step``: the loss
   within 1e-5 and every parameter within atol 2e-4, rtol 2e-4 (the 4D
   card test's tolerance); the engine on that mesh through K4 (decode,
   and verify windows for the speculative half of the requests), greedy
   tokens equal to the single-placement engine's.
2. With four cards, an NCCL world of four processes (this file as the
   ranks' ``__main__``, tests/_torch_world.py): the ``tp_fsdp`` step at
   ``{data 2, model 2}`` (each rank 2 of the 4 heads and half of every
   'embed' dim, the blocks checkpointed), its parameters gathered from
   the ranks' shards, against the single-device step within the same
   tolerance; and tensor-parallel serving at ``{data 1, model 4}`` (one
   head a rank, each attending its own ``[n_pages, 1, 16, 32]`` pool
   through K4) token-identical to the single engine (f32, greedy).  It
   checks correctness only and times nothing; it skips below four cards.
   On a four-card host: ``python3 -m pytest tests/test_torch_gspmd_card.py
   -m cuda -k nccl``.
"""

import sys

import numpy as np
import pytest
import torch

from dtdl_tpu_torch import kernels
from dtdl_tpu_torch.bridge import flatten, state_dict_to_flax
from dtdl_tpu_torch.models.transformer import transformer_lm
from dtdl_tpu_torch.parallel import tensor as T
from dtdl_tpu_torch.runtime.mesh import batch_sharded, build_mesh
from dtdl_tpu_torch.serve import InferenceEngine, Request, Scheduler
from dtdl_tpu_torch.train.optim import sgd
from dtdl_tpu_torch.train.state import init_state
from dtdl_tpu_torch.train.step import make_lm_train_step

from _torch_world import World, serve  # noqa: E402

pytestmark = pytest.mark.cuda

AXES = ("data", "model")
TOL = dict(atol=2e-4, rtol=2e-4)
B, S = 4, 256
CFG = dict(vocab_size=512, d_model=128, n_layers=2, n_heads=4, d_ff=256,
           max_seq=S, dtype=torch.float32)
PROMPTS = [np.random.default_rng(5).integers(0, 512, n).tolist()
           for n in (20, 70, 33, 129)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the sharded step's attend and the "
                    "engine's run the hand-written kernels, which have no "
                    "CPU path")
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build()
    return torch.device("cuda")


def tokens(seed=0):
    return np.random.default_rng(seed).integers(0, 512, (B, S + 1))


def sharded_step(mesh, rules, toks, device=None):
    """One sharded sgd(0.1) step: (loss, the whole weights gathered,
    launches)."""
    host = transformer_lm("tiny", device="cpu", seed=0, **CFG)
    params, opt, sh = T.init_sharded_lm(host, mesh, sgd(0.1), rules=rules,
                                        device=device)
    kernels.reset_launches()
    _, _, loss = T.make_sharded_lm_train_step(host, mesh, None, sh, rules)(
        params, opt, batch_sharded(mesh, toks, device=device))
    torch.cuda.synchronize()
    return float(loss), T.gather_params(params), dict(kernels.LAUNCHES)


def single_step(toks):
    lm = transformer_lm("tiny", seed=0, **CFG)
    state = init_state(lm, None, sgd(0.1))
    _, m = make_lm_train_step()(state, {"tokens": toks})
    return float(m["loss"]), flatten(state_dict_to_flax(lm))


def served(model, **kw):
    """Greedy tokens of ``PROMPTS`` (every other one speculative: K4's
    verify windows) through an engine of ``kw``, and the engine."""
    eng = InferenceEngine(model, n_slots=2, page_size=16, **kw)
    reqs = [Request(list(p), 8, speculate=2 * (i % 2))
            for i, p in enumerate(PROMPTS)]
    Scheduler(eng, harvest_lag=2).run(reqs)
    assert all(r.error is None for r in reqs)
    return [r.tokens for r in reqs], eng


def test_world_of_one_matches_the_single_device_step(card):
    toks = tokens()
    loss, got, launches = sharded_step(build_mesh((1, 1), AXES), "tp", toks)
    assert launches["flash_fwd"] == CFG["n_layers"]
    assert launches["flash_bwd_dq"] == launches["flash_bwd_dkv"] == \
        CFG["n_layers"]
    want_loss, want = single_step(toks)
    np.testing.assert_allclose(loss, want_loss, atol=1e-5, rtol=1e-5)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, err_msg=path, **TOL)
    model = transformer_lm("tiny", seed=0, **CFG)
    kernels.reset_launches()
    tp, eng = served(model, mesh=build_mesh((1, 1), AXES), rules="tp")
    assert kernels.LAUNCHES["paged_attention"] > 0
    assert eng.compile_stats()["tp"] == {"rules": "tp",
                                         "mesh": {"data": 1, "model": 1}}
    assert tp == served(model)[0]


def run_nccl_case(mesh, name, case):
    """One rank of the NCCL world."""
    if name == "train":
        loss, params, launches = sharded_step(mesh, "tp_fsdp",
                                              case["tokens"])
        return {"loss": loss, "params": params, "launches": launches}
    model = transformer_lm("tiny", device="cpu", seed=0, **CFG)
    kernels.reset_launches()
    toks, eng = served(model, mesh=build_mesh((1, 4), AXES), rules="tp")
    torch.cuda.synchronize()
    pool = eng.init_arena()["block_0"]["attn"]["pages_key"]
    return {"tokens": toks, "k4": kernels.LAUNCHES["paged_attention"],
            "pool": tuple(pool.shape)}


@pytest.fixture(scope="module")
def nccl_world(tmp_path_factory):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four cards: an NCCL world of one process a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build()
    cases = {"train": {"tokens": tokens(1)}, "serve": {}}
    return World(__file__, (2, 2), cases, tmp_path_factory.mktemp("nccl"),
                 device="cuda").results()


def test_tp_fsdp_over_nccl_matches_the_single_device_step(card, nccl_world):
    want_loss, want = single_step(tokens(1))
    for out in (o["cases"]["train"] for o in nccl_world):
        np.testing.assert_allclose(out["loss"], want_loss, atol=1e-5,
                                   rtol=1e-5)
        # checkpointed blocks: K1 in the forward and again in the backward
        assert out["launches"]["flash_fwd"] == 2 * CFG["n_layers"]
        for path, w in want.items():
            np.testing.assert_allclose(out["params"][path], w, err_msg=path,
                                       **TOL)


def test_tp_serving_over_nccl_token_identical(card, nccl_world):
    want, _ = served(transformer_lm("tiny", seed=0, **CFG))
    for out in (o["cases"]["serve"] for o in nccl_world):
        assert out["k4"] > 0 and out["pool"][1] == 1, out
        assert out["tokens"] == want


if __name__ == "__main__":
    sys.exit(serve(run_nccl_case, AXES))
