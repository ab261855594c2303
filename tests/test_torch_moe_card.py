"""The MoE LM through the hand-written kernels on the card.

These need the card (K1-K4 have no CPU mode): they carry the ``cuda``
marker and skip, with the reason, where no CUDA device is visible.  On
the card: ``python -m pytest tests/test_torch_moe_card.py -m cuda``.

A tiny routed MoE LM (vocab 256, d_model 64, 2 layers, 4 experts in
block 1, capacity factor 1.25, f32).  Tolerances: the train step through
K1-K3 against the same step through dense attention, loss within 1e-5
and parameters after sgd(0.1) within 1e-6 (as
tests/test_torch_kernels.py); greedy tokens identical between the K4 and
the plain engines.
"""

import numpy as np
import pytest
import torch

from dtdl_tpu_torch import kernels
from dtdl_tpu_torch.models.transformer import transformer_lm
from dtdl_tpu_torch.serve import (InferenceEngine, NGramDraft, Request,
                                  Scheduler)
from dtdl_tpu_torch.train.optim import sgd
from dtdl_tpu_torch.train.state import init_state
from dtdl_tpu_torch.train.step import make_lm_train_step

MOE = dict(n_experts=4, moe_every=2, moe_dispatch="routed")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the hand-written kernels have no "
                    "CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_moe_train_step_flash_matches_dense(cuda):
    """One step of the MoE LM through K1, K2 and K3 against dense
    attention: the same loss, aux value and updated parameters."""
    toks = np.random.default_rng(1).integers(0, 256, (2, 65))
    out = {}
    for impl in ("flash", "dense"):
        model = transformer_lm("tiny", dtype=torch.float32, attn_impl=impl,
                               seed=None, device=cuda, **MOE)
        state = init_state(model, 4, sgd(0.1), device=cuda)
        kernels.reset_launches()
        state, m = make_lm_train_step()(state, {"tokens": toks})
        out[impl] = ({k: float(v) for k, v in m.items()},
                     dict(kernels.LAUNCHES),
                     {n: p.detach() for n, p in model.named_parameters()})
    (mf, launches, pf), (md, _, pd) = out["flash"], out["dense"]
    assert launches["flash_fwd"] == launches["flash_bwd_dq"] == \
        launches["flash_bwd_dkv"] == 2
    for key in ("loss", "moe_aux_loss"):
        assert abs(mf[key] - md[key]) <= 1e-5, key
    for name in pd:
        torch.testing.assert_close(pf[name], pd[name], atol=1e-6, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("run", ["plain", "chunked", "spec"])
def test_moe_engine_tokens_kernel_vs_plain(cuda, run):
    """The MoE LM served through K4 and through the plain attend, whole
    prompt, chunked (8 tokens a step) and speculative (n-gram, k=4):
    identical greedy tokens."""
    model = transformer_lm("tiny", seed=3, dtype=torch.float32, max_seq=64,
                           device=cuda, **MOE)
    rng = np.random.default_rng(2)
    traffic = [(rng.integers(0, 256, int(n)).tolist(), 8)
               for n in rng.integers(3, 40, 5)]
    out = {}
    for flag in (True, False):
        eng = InferenceEngine(model, n_slots=2, page_size=8,
                              paged_kernel=flag, device=cuda)
        reqs = [Request(p, m, speculate=4 if run == "spec" else 0)
                for p, m in traffic]
        kernels.reset_launches()
        Scheduler(eng, harvest_lag=2, draft=NGramDraft(), device=cuda,
                  chunk_tokens=8 if run == "chunked" else None).run(reqs)
        assert (kernels.LAUNCHES["paged_attention"] > 0) == flag
        out[flag] = [r.tokens for r in reqs]
    assert out[True] == out[False]
