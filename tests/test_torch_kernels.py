"""The hand-written CUDA kernels against their plain PyTorch versions.

These need the card (a CUDA kernel has no CPU mode): they carry the
``cuda`` marker and skip, with the reason, where no CUDA device is
visible.  On the card: ``python -m pytest tests/test_torch_kernels.py -m
cuda``.  ``chip_smoke.py`` runs the same comparisons at the serving
path's full shapes.

Tolerances: f32 atol 2e-5 (summation order, online vs one-shot softmax);
bf16 atol 1e-2 + rtol 1e-2 (the weights are rounded to bf16 before P·V at
another normalization, and the output is rounded to bf16).
"""

import math

import numpy as np
import pytest
import torch

from dtdl_tpu_torch import kernels
from dtdl_tpu_torch.models.transformer import transformer_lm
from dtdl_tpu_torch.ops.attention import flash_attention_reference, flash_fwd
from dtdl_tpu_torch.ops.paged_attention import (paged_attention,
                                                paged_attention_reference)
from dtdl_tpu_torch.ops.rope import rope_frequencies, rope_rows
from dtdl_tpu_torch.serve.engine import InferenceEngine
from dtdl_tpu_torch.serve.scheduler import Request, Scheduler

# small shapes: one intra-op thread each leaves the cores to the other
# test workers
torch.set_num_threads(1)

TOL = {torch.float32: dict(atol=2e-5, rtol=0.0),
       torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}


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
