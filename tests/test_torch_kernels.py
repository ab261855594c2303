"""The hand-written CUDA kernels against their plain PyTorch versions.

These need the card (a CUDA kernel has no CPU mode): they carry the
``cuda`` marker and skip, with the reason, where no CUDA device is
visible.  On the card: ``python -m pytest tests/test_torch_kernels.py -m
cuda``.  ``chip_smoke.py`` runs the same comparisons at the serving
path's full shapes.

Tolerances: f32 atol 2e-5 (summation order, online vs one-shot softmax);
bf16 atol 1e-2 + rtol 1e-2 (the weights are rounded to bf16 before P·V at
another normalization, and the output is rounded to bf16).  The backward
kernels (K2, K3) against their plain versions on the same lse and delta:
f32 atol 1e-4 + rtol 1e-4 (summation order over up to 200 keys); bf16
atol 2^-5 of the tensor's median |want| (about 4 bf16 ulps of a typical
element) + rtol 2e-2 (ds and p are rounded to bf16 before their
products, a score that differs in its last f32 bits can round the other
way, and the outputs are rounded to bf16: one ulp is at most 2^-7 of the
value).  The absolute term follows each tensor's scale, so a kernel that
wrote zeros for the small gradients would fail.
"""

import math

import numpy as np
import pytest
import torch

from dtdl_tpu_torch import kernels
from dtdl_tpu_torch.models.transformer import transformer_lm
from dtdl_tpu_torch.ops.attention import (flash_attention_reference,
                                          flash_bwd_dkv, flash_bwd_dq,
                                          flash_bwd_reference, flash_fwd)
from dtdl_tpu_torch.ops.paged_attention import (paged_attention,
                                                paged_attention_reference)
from dtdl_tpu_torch.ops.rope import rope_frequencies, rope_rows
from dtdl_tpu_torch.serve.engine import InferenceEngine
from dtdl_tpu_torch.serve.scheduler import Request, Scheduler
from dtdl_tpu_torch.train.optim import sgd
from dtdl_tpu_torch.train.state import init_state
from dtdl_tpu_torch.train.step import make_lm_train_step

# small shapes: one intra-op thread each leaves the cores to the other
# test workers
torch.set_num_threads(1)

TOL = {torch.float32: dict(atol=2e-5, rtol=0.0),
       torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}
# (atol, share of the tensor's median |want| added to atol, rtol)
BWD_TOL = {torch.float32: (1e-4, 0.0, 1e-4),
           torch.bfloat16: (0.0, 2**-5, 2e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the hand-written kernels have no "
                    "CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s_new", [1, 5, 40])
def test_paged_kernel_matches_plain(cuda, dtype, s_new):
    gen = torch.Generator(device=cuda).manual_seed(s_new)
    b, h, d, page, n_ptab = 3, 2, 64, 8, 8
    pk = torch.randn(b * n_ptab + 1, h, page, d, generator=gen,
                     device=cuda).to(dtype)
    pv = torch.randn(pk.shape, generator=gen, device=cuda).to(dtype)
    table = (1 + torch.randperm(b * n_ptab, generator=gen, device=cuda)
             ).reshape(b, n_ptab).to(torch.int32)
    pos = torch.tensor([0, 9, 20], dtype=torch.int32, device=cuda)
    active = torch.tensor([True, True, False], device=cuda)
    q = torch.randn(b, h, s_new, d, generator=gen, device=cuda).to(dtype)
    kernels.reset_launches()
    got = paged_attention(q, pk, pv, table, pos, active, scale=0.125)
    assert kernels.LAUNCHES["paged_attention"] == 1
    want = paged_attention_reference(q, pk, pv, table, pos, active,
                                     scale=0.125)
    torch.testing.assert_close(got, want, **TOL[dtype])
    assert bool((got[2] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("sq,sk", [(64, 64), (40, 100)])
def test_flash_kernel_matches_plain(cuda, causal, rope, sq, sk):
    gen = torch.Generator(device=cuda).manual_seed(7)
    d = 32
    q, k, v = (torch.randn(2, 2, s, d, generator=gen, device=cuda)
               for s in (sq, sk, sk))
    tabs = ropet = None
    if rope:
        cos, sin = rope_frequencies(d, 128, device=cuda)
        ropet = (cos, sin)
        pos_q = (torch.arange(sq, device=cuda) + sk - sq).clamp(min=0)
        tabs = rope_rows(cos, sin, pos_q) + rope_rows(
            cos, sin, torch.arange(sk, device=cuda))
    o, lse = flash_fwd(q.reshape(4, sq, d), k.reshape(4, sk, d),
                       v.reshape(4, sk, d), tabs, scale=1 / math.sqrt(d),
                       causal=causal)
    want_o, want_lse = flash_attention_reference(q, k, v, causal=causal,
                                                 rope=ropet)
    torch.testing.assert_close(o.reshape(2, 2, sq, d), want_o,
                               **TOL[torch.float32])
    torch.testing.assert_close(lse.reshape(2, 2, sq), want_lse, atol=2e-4,
                               rtol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("sq,sk,d", [(64, 64, 32), (40, 100, 64),
                                     (100, 40, 16), (200, 200, 128)])
def test_flash_bwd_kernels_match_plain(cuda, dtype, causal, rope, sq, sk, d):
    """K2 and K3 against flash_bwd_reference on the same residuals; the
    (100, 40) causal cases hold rows that see no key."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    bh = 4
    q, k, v, do = (torch.randn(bh, s, d, generator=gen, device=cuda)
                   .to(dtype) for s in (sq, sk, sk, sq))
    scale = 1 / math.sqrt(d)
    tabs = None
    if rope:
        cos, sin = rope_frequencies(d, 256, device=cuda)
        pos_q = (torch.arange(sq, device=cuda) + sk - sq).clamp(min=0)
        tabs = rope_rows(cos, sin, pos_q) + rope_rows(
            cos, sin, torch.arange(sk, device=cuda))
    o, lse = flash_fwd(q.cpu(), k.cpu(), v.cpu(),
                       None if tabs is None else tuple(t.cpu() for t in tabs),
                       scale=scale, causal=causal)
    o, lse = o.to(cuda), lse.to(cuda)
    delta = (do.float() * o.float()).sum(-1)
    kernels.reset_launches()
    dq = flash_bwd_dq(q, k, v, do, lse, delta, tabs, scale=scale,
                      causal=causal)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, tabs, scale=scale,
                           causal=causal)
    assert kernels.LAUNCHES["flash_bwd_dq"] == 1
    assert kernels.LAUNCHES["flash_bwd_dkv"] == 1
    want = flash_bwd_reference(q, k, v, do, lse, delta, tabs, scale=scale,
                               causal=causal)
    atol, share, rtol = BWD_TOL[dtype]
    for got, ref in zip((dq, dk, dv), want):
        assert got.dtype == dtype and bool(torch.isfinite(got).all())
        median = float(ref.float().abs().median())
        torch.testing.assert_close(got, ref, atol=atol + share * median,
                                   rtol=rtol)


@pytest.mark.cuda
def test_engine_tokens_kernel_vs_plain(cuda):
    """A tiny f32 model served through the kernel and through the plain
    version gives identical greedy tokens."""
    model = transformer_lm("tiny", seed=3, dtype=torch.float32,
                           max_seq=64, device=cuda)
    rng = np.random.default_rng(0)
    traffic = [(rng.integers(0, 256, int(n)).tolist(), 6)
               for n in rng.integers(3, 30, 5)]
    out = {}
    for flag in (True, False):
        eng = InferenceEngine(model, n_slots=2, page_size=8,
                              paged_kernel=flag, device=cuda)
        reqs = [Request(p, m) for p, m in traffic]
        Scheduler(eng, harvest_lag=2, device=cuda).run(reqs)
        out[flag] = [r.tokens for r in reqs]
    assert out[True] == out[False]


@pytest.mark.cuda
def test_train_step_flash_matches_dense(cuda):
    """One tiny f32 training step through K1, K2 and K3 against the same
    step through dense attention (plain autograd), same weights: loss
    within 1e-5, parameters after sgd(0.1) within 1e-6."""
    toks = np.random.default_rng(1).integers(0, 256, (2, 65))
    out = {}
    for impl in ("flash", "dense"):
        model = transformer_lm("tiny", dtype=torch.float32, attn_impl=impl,
                               seed=None, device=cuda)
        state = init_state(model, 4, sgd(0.1), device=cuda)
        kernels.reset_launches()
        state, metrics = make_lm_train_step()(state, {"tokens": toks})
        out[impl] = (float(metrics["loss"]), dict(kernels.LAUNCHES),
                     {n: p.detach() for n, p in model.named_parameters()})
    (lf, launches, pf), (ld, _, pd) = out["flash"], out["dense"]
    assert launches["flash_fwd"] == launches["flash_bwd_dq"] == \
        launches["flash_bwd_dkv"] == 2
    assert abs(lf - ld) <= 1e-5
    for name in pd:
        torch.testing.assert_close(pf[name], pd[name], atol=1e-6, rtol=0)
