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
from dtdl_tpu_torch.ops.attention import (_rotate, flash_attention_reference,
                                          flash_bwd, flash_bwd_dkv,
                                          flash_bwd_dq, flash_bwd_reference,
                                          flash_fwd, rope_rotate)
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
@pytest.mark.parametrize("page", [8, 16, 32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s_new", [1, 5, 17, 40, 65, 257])
def test_paged_kernel_matches_plain(cuda, dtype, s_new, page):
    """Every body: decode (S = 1), verify (5), and bf16 S > 16 through the
    prefill body at the edges of its 64-row tiles (17, 40, 65, 257) over
    pages of one to eight swizzle atoms; f32 on the CUDA cores."""
    gen = torch.Generator(device=cuda).manual_seed(s_new)
    b, h, d = 3, 2, 64
    n_ptab = -(-(20 + s_new) // page) + 1
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
@pytest.mark.parametrize("sq,sk", [(64, 64), (40, 100), (100, 40)])
def test_flash_kernel_matches_plain(cuda, causal, rope, sq, sk):
    """K1's f32 body; causal (100, 40) holds rows that see no key, which
    weight every key alike as in the plain version."""
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


# the edges of the bf16 bodies' tiles (K1: 128 q rows x 128 keys; K3: 128
# keys x 64 q rows): exact multiples, ragged, cross, rows that see no key
EDGE_SHAPES = [(128, 128), (256, 256), (200, 200), (160, 320), (320, 160)]


def _rope_case(cuda, d, sq, sk):
    cos, sin = rope_frequencies(d, 512, device=cuda)
    pos_q = (torch.arange(sq, device=cuda) + sk - sq).clamp(min=0)
    tabs = rope_rows(cos, sin, pos_q) + rope_rows(
        cos, sin, torch.arange(sk, device=cuda))
    return (cos, sin), tabs


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("sq,sk", EDGE_SHAPES)
def test_flash_bf16_kernel_tile_edges(cuda, d, causal, rope, sq, sk):
    """K1's wgmma body against its plain version at every head dim."""
    gen = torch.Generator(device=cuda).manual_seed(13)
    q, k, v = (torch.randn(2, 2, s, d, generator=gen, device=cuda)
               .to(torch.bfloat16) for s in (sq, sk, sk))
    ropet, tabs = _rope_case(cuda, d, sq, sk) if rope else (None, None)
    kernels.reset_launches()
    o, lse = flash_fwd(q.reshape(4, sq, d), k.reshape(4, sk, d),
                       v.reshape(4, sk, d), tabs, scale=1 / math.sqrt(d),
                       causal=causal)
    assert kernels.LAUNCHES["flash_fwd"] == 1
    assert kernels.LAUNCHES["rope_rows"] == (2 if rope else 0)
    want_o, want_lse = flash_attention_reference(q, k, v, causal=causal,
                                                 rope=ropet)
    torch.testing.assert_close(o.reshape(2, 2, sq, d), want_o,
                               **TOL[torch.bfloat16])
    torch.testing.assert_close(lse.reshape(2, 2, sq), want_lse, atol=2e-4,
                               rtol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("sq,sk", EDGE_SHAPES)
def test_flash_bwd_bf16_kernels_tile_edges(cuda, d, causal, rope, sq, sk):
    """K3's wgmma body (and K2 beside it) against the plain versions, and
    K3 bitwise equal to itself from run to run."""
    gen = torch.Generator(device=cuda).manual_seed(17)
    q, k, v, do = (torch.randn(4, s, d, generator=gen, device=cuda)
                   .to(torch.bfloat16) for s in (sq, sk, sk, sq))
    scale = 1 / math.sqrt(d)
    tabs = _rope_case(cuda, d, sq, sk)[1] if rope else None
    o, lse = flash_fwd(q.cpu(), k.cpu(), v.cpu(),
                       None if tabs is None else tuple(t.cpu() for t in tabs),
                       scale=scale, causal=causal)
    o, lse = o.to(cuda), lse.to(cuda)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta, tabs)
    got = (flash_bwd_dq(*args, scale=scale, causal=causal),
           *flash_bwd_dkv(*args, scale=scale, causal=causal))
    again = flash_bwd_dkv(*args, scale=scale, causal=causal)
    want = flash_bwd_reference(*args, scale=scale, causal=causal)
    atol, share, rtol = BWD_TOL[torch.bfloat16]
    for g, ref in zip(got, want):
        assert bool(torch.isfinite(g).all())
        median = float(ref.float().abs().median())
        torch.testing.assert_close(g, ref, atol=atol + share * median,
                                   rtol=rtol)
    assert torch.equal(got[1], again[0]) and torch.equal(got[2], again[1])


def _on_grid(x):
    """``x`` rounded to multiples of 1/8.  A row that sees no key weights
    every key with p = 1, so its ds = (dp - delta)·scale is of dp's size,
    far above the tensor's median; where the kernel's dp and the plain
    version's differ in their last f32 bit, ds can round to bf16 one ulp
    apart, and that ulp times |k| exceeds the median-scaled tolerance.
    With dO and v on this grid, dp = dO·vᵀ is exact in both (each product
    has at most 12 significant bits, the sum stays below 2^24 of the
    grid), so the comparison sees the kernel and not the summation
    order."""
    return ((x.float() * 8).round() / 8).to(x.dtype)


# the edges of K2's bf16 tile (128 q rows x 128 keys): whole row tiles over
# half a key tile (128/64) and over whole ones (256/128), a ragged row and
# key tail (130/70), one tile that holds rows that see no key beside rows
# that do (causal 130/70 and 200/100), and cross attention (64/192)
DQ_EDGE_SHAPES = [(128, 64), (256, 128), (130, 70), (200, 100), (64, 192)]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("sq,sk", DQ_EDGE_SHAPES)
def test_flash_bwd_dq_bf16_kernel_tile_edges(cuda, d, causal, rope, sq, sk):
    """K2's wgmma body against its plain version at every head dim, and
    bitwise equal to itself from run to run; flash_bwd runs the rope
    pre-pass once for K2 and K3 together."""
    gen = torch.Generator(device=cuda).manual_seed(23)
    q, k, v, do = (torch.randn(4, s, d, generator=gen, device=cuda)
                   .to(torch.bfloat16) for s in (sq, sk, sk, sq))
    if causal and sq > sk:
        v, do = _on_grid(v), _on_grid(do)
    scale = 1 / math.sqrt(d)
    tabs = _rope_case(cuda, d, sq, sk)[1] if rope else None
    o, lse = flash_fwd(q.cpu(), k.cpu(), v.cpu(),
                       None if tabs is None else tuple(t.cpu() for t in tabs),
                       scale=scale, causal=causal)
    o, lse = o.to(cuda), lse.to(cuda)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta, tabs)
    kernels.reset_launches()
    got = flash_bwd(*args, scale=scale, causal=causal)
    assert kernels.LAUNCHES["flash_bwd_dq"] == 1
    assert kernels.LAUNCHES["flash_bwd_dkv"] == 1
    assert kernels.LAUNCHES["rope_rows"] == (2 if rope else 0)
    again = flash_bwd_dq(*args, scale=scale, causal=causal)
    want = flash_bwd_reference(*args, scale=scale, causal=causal)
    atol, share, rtol = BWD_TOL[torch.bfloat16]
    for g, ref in zip(got, want):
        assert bool(torch.isfinite(g).all())
        median = float(ref.float().abs().median())
        torch.testing.assert_close(g, ref, atol=atol + share * median,
                                   rtol=rtol)
    assert torch.equal(got[0], again)


# (b, s_new, pos): decode with n_splits > 1 (rows of every length), splits
# of which many are empty (small positions, many splits), verify windows,
# and a batch big enough that each row takes one split
PAGED_SPLIT_CASES = [
    ("decode-splits", 8, 1, [100, 250, 400, 550, 700, 850, 1000, 1050]),
    ("decode-empty-splits", 8, 1, [0, 1, 2, 3, 5, 8, 15, 16]),
    ("verify-splits", 8, 5, [0, 1, 2, 30, 50, 80, 150, 160]),
    ("decode-one-split", 80, 1, list(range(0, 800, 10))),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,b,s_new,pos", PAGED_SPLIT_CASES,
                         ids=[c[0] for c in PAGED_SPLIT_CASES])
def test_paged_decode_splits_repeat_bitwise(cuda, name, b, s_new, pos):
    """K4's bf16 decode body, its split partials merged in the same launch:
    within tolerance of the plain version, and three calls in a row
    bitwise equal (the arrival counters come back to zero)."""
    from dtdl_tpu_torch.ops.paged_attention import kv_splits
    gen = torch.Generator(device=cuda).manual_seed(29)
    h, d, page, n_ptab = 4, 128, 16, 68
    pk = torch.randn(b * n_ptab + 1, h, page, d, generator=gen,
                     device=cuda).to(torch.bfloat16)
    pv = torch.randn(pk.shape, generator=gen, device=cuda).to(torch.bfloat16)
    table = (1 + torch.randperm(b * n_ptab, generator=gen, device=cuda)
             ).reshape(b, n_ptab).to(torch.int32)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=cuda)
    active = torch.ones(b, dtype=torch.bool, device=cuda)
    q = torch.randn(b, h, s_new, d, generator=gen, device=cuda).to(
        torch.bfloat16)
    n = kv_splits(b, h, s_new, n_ptab,
                  torch.cuda.get_device_properties(cuda).multi_processor_count)
    assert (n == 1) == (name == "decode-one-split")
    kernels.reset_launches()
    outs = [paged_attention(q, pk, pv, table, pos_t, active, scale=0.088)
            for _ in range(3)]
    assert kernels.LAUNCHES["paged_attention"] == 3
    want = paged_attention_reference(q, pk, pv, table, pos_t, active,
                                     scale=0.088)
    torch.testing.assert_close(outs[0], want, **TOL[torch.bfloat16])
    assert all(torch.equal(outs[0], o) for o in outs[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_verify_geometry_in_an_engine_batch(cuda, dtype):
    """K4 at the verify geometry of an engine batch: 8 rows of S = 5, the
    serving pool (4 heads of 128, page 16), one inactive row (its table
    all garbage page 0) and one window crossing from page 0 of its table
    into page 1 (rows 14..18).  Within tolerance of the plain version,
    one launch a call, and the split-merge arrival counters back to zero
    after each of three calls, which are bitwise equal."""
    from dtdl_tpu_torch.ops import paged_attention as pa
    gen = torch.Generator(device=cuda).manual_seed(31)
    b, h, s_new, d, page, n_ptab = 8, 4, 5, 128, 16, 128
    pk = torch.randn(b * n_ptab + 1, h, page, d, generator=gen,
                     device=cuda).to(dtype)
    pv = torch.randn(pk.shape, generator=gen, device=cuda).to(dtype)
    table = (1 + torch.randperm(b * n_ptab, generator=gen, device=cuda)
             ).reshape(b, n_ptab).to(torch.int32)
    table[5] = 0
    pos = torch.tensor([100, 14, 400, 550, 700, 300, 1000, 1045],
                       dtype=torch.int32, device=cuda)
    active = torch.tensor([True] * 5 + [False] + [True] * 2, device=cuda)
    q = torch.randn(b, h, s_new, d, generator=gen, device=cuda).to(dtype)
    kernels.reset_launches()
    outs = []
    for _ in range(3):
        outs.append(paged_attention(q, pk, pv, table, pos, active,
                                    scale=0.088))
        torch.cuda.synchronize()
        assert all(int(c.abs().sum()) == 0 for c in pa._COUNTERS.values())
    assert kernels.LAUNCHES["paged_attention"] == 3
    want = paged_attention_reference(q, pk, pv, table, pos, active,
                                     scale=0.088)
    torch.testing.assert_close(outs[0], want, **TOL[dtype])
    assert torch.equal(outs[0][5], torch.zeros_like(outs[0][5]))
    assert all(torch.equal(outs[0], o) for o in outs[1:])


@pytest.mark.cuda
def test_engine_spec_tokens_kernel_vs_plain(cuda):
    """Speculative traffic on a tiny f32 model: the kernel engine's
    verify steps and the plain version's give identical greedy tokens,
    equal to plain decode, and every verify step launches K4 once per
    layer."""
    from dtdl_tpu_torch.serve import NGramDraft
    model = transformer_lm("tiny", seed=3, dtype=torch.float32,
                           max_seq=64, device=cuda)
    rng = np.random.default_rng(1)
    traffic = [(np.resize(rng.integers(0, 256, 4), int(n)).tolist(), 12)
               for n in rng.integers(6, 30, 5)]
    out = {}
    for flag, spec in ((True, 4), (False, 4), (True, 0)):
        eng = InferenceEngine(model, n_slots=2, page_size=8,
                              paged_kernel=flag, device=cuda)
        verify, calls = eng.verify, []

        def counted(*args, **kwargs):
            before = kernels.LAUNCHES["paged_attention"]
            res = verify(*args, **kwargs)
            calls.append(kernels.LAUNCHES["paged_attention"] - before)
            return res

        eng.verify = counted
        reqs = [Request(p, m, speculate=spec) for p, m in traffic]
        Scheduler(eng, harvest_lag=2, draft=NGramDraft(),
                  device=cuda).run(reqs)
        out[flag, spec] = [r.tokens for r in reqs]
        if spec:
            assert calls, "no verify step ran"
            n_layers = model.cfg.n_layers if flag else 0
            assert calls == [n_layers] * len(calls)
    assert out[True, 4] == out[False, 4] == out[True, 0]


# chunked prefill's windows (S = k_prog + 1 up to 257 at chunk_tokens=256,
# and speculate=16's S = 17) at the engine batch B = 8, per-row positions,
# two rows inactive, pages of 8-64 keys; with int8 and fp8 pools
# (quantized by the port's kv_quantize) and bf16 ones, some with NaN in
# every page no active row can see (the scales of a quantized pool)
CHUNK_CASES = [("S33-bf16", 33, None, False, 16),
               ("S257-bf16", 257, None, False, 16),
               ("S257-int8", 257, "int8", False, 16),
               ("S33-fp8-nan-dead", 33, "fp8", True, 16),
               ("S17-bf16", 17, None, False, 16),
               ("S65-bf16-page8", 65, None, False, 8),
               ("S257-bf16-page32", 257, None, False, 32),
               ("S257-bf16-page64", 257, None, False, 64),
               ("S65-int8-nan-dead-page8", 65, "int8", True, 8),
               ("S257-fp8-nan-dead-page64", 257, "fp8", True, 64),
               ("S65-bf16-nan-dead-page32", 65, None, True, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("name,s_new,kv,nan_dead,page", CHUNK_CASES,
                         ids=[c[0] for c in CHUNK_CASES])
def test_paged_chunk_windows_b8(cuda, name, s_new, kv, nan_dead, page):
    """K4 through its prefill body at chunk geometries, every case split
    (n_splits > 1): within tolerance of the plain version (on clean
    pools), inactive rows zero and finite, one launch a call, three calls
    bitwise equal and the split counters back to zero."""
    from dtdl_tpu_torch.ops import paged_attention as pa
    from dtdl_tpu_torch.quant import kv_quantize
    gen = torch.Generator(device=cuda).manual_seed(s_new)
    b, h, d = 8, 4, 128
    n_ptab = 2048 // page
    kf = torch.randn(b * n_ptab + 1, h, page, d, generator=gen, device=cuda)
    vf = torch.randn(kf.shape, generator=gen, device=cuda)
    table = (1 + torch.randperm(b * n_ptab, generator=gen, device=cuda)
             ).reshape(b, n_ptab).to(torch.int32)
    pos_l = [0, 16, 250, 700, 1000, 1500, 30, 1790][:b]
    pos = torch.tensor(pos_l, dtype=torch.int32, device=cuda)
    active = torch.tensor([True, True, False, True, True, True, False, True],
                          device=cuda)
    q = torch.randn(b, h, s_new, d, generator=gen, device=cuda).to(
        torch.bfloat16)
    ks = vs = None
    if kv is None:
        pk, pv = kf.to(torch.bfloat16), vf.to(torch.bfloat16)
    else:
        dt = torch.int8 if kv == "int8" else torch.float8_e4m3fn
        (pk, ks), (pv, vs) = kv_quantize(kf, dt), kv_quantize(vf, dt)
    want = paged_attention_reference(q, pk, pv, table, pos, active,
                                     scale=0.088, key_scale=ks,
                                     value_scale=vs)
    if nan_dead:
        live = {0}
        for i in range(b):
            if active[i]:
                live.update(table[i, :(pos_l[i] + s_new - 1) // page + 1]
                            .tolist())
        dead = [p for p in range(kf.shape[0]) if p not in live]
        if kv is None:
            pk, pv = pk.clone(), pv.clone()
            pk[dead] = float("nan")
            pv[dead] = float("nan")
        else:
            ks, vs = ks.clone(), vs.clone()
            ks[dead] = float("nan")
            vs[dead] = float("nan")
    assert pa.kv_splits(b, h, s_new, n_ptab, torch.cuda.get_device_properties(
        cuda).multi_processor_count) > 1
    kernels.reset_launches()
    outs = []
    for n in range(1, 4):
        outs.append(paged_attention(q, pk, pv, table, pos, active,
                                    scale=0.088, key_scale=ks,
                                    value_scale=vs))
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["paged_attention"] == n
        assert all(int(c.abs().sum()) == 0 for c in pa._COUNTERS.values())
    got = outs[0]
    assert bool(torch.isfinite(got).all())
    assert bool((got[~active] == 0).all())
    torch.testing.assert_close(got, want, **TOL[torch.bfloat16])
    assert all(torch.equal(got, o) for o in outs[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [None, "int8", "fp8"])
def test_engine_chunked_quant_tokens_kernel_vs_plain(cuda, kv):
    """A tiny f32 model with int8 weights and chunked prefill (8 tokens a
    step) over f32, int8 or fp8 pools: the kernel engine and the plain
    version's give identical greedy tokens, equal to the kernel engine's
    whole-prompt run."""
    model = transformer_lm("tiny", seed=3, dtype=torch.float32,
                           max_seq=64, device=cuda)
    rng = np.random.default_rng(2)
    traffic = [(rng.integers(0, 256, int(n)).tolist(), 6)
               for n in rng.integers(3, 40, 5)]
    out = {}
    for flag, chunk in ((True, 8), (False, 8), (True, None)):
        eng = InferenceEngine(model, n_slots=2, page_size=8,
                              paged_kernel=flag, quantize_weights=True,
                              kv_dtype=kv, device=cuda)
        reqs = [Request(p, m) for p, m in traffic]
        Scheduler(eng, harvest_lag=2, chunk_tokens=chunk,
                  device=cuda).run(reqs)
        out[flag, chunk] = [r.tokens for r in reqs]
    assert out[True, 8] == out[False, 8] == out[True, None]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("positions", ["default", "explicit"])
def test_rope_prepass_bitwise(cuda, dtype, d, positions):
    """The rope pre-pass is bitwise the plain _rotate."""
    gen = torch.Generator(device=cuda).manual_seed(19)
    s = 200
    x = torch.randn(6, s, d, generator=gen, device=cuda).to(dtype)
    cos, sin = rope_frequencies(d, 4096, device=cuda)
    pos = (torch.arange(s, device=cuda) if positions == "default" else
           torch.randperm(4096, generator=gen, device=cuda)[:s].sort().values)
    c, sn = rope_rows(cos, sin, pos)
    kernels.reset_launches()
    got = rope_rotate(x, c, sn)
    assert kernels.LAUNCHES["rope_rows"] == 1
    assert torch.equal(got, _rotate(x, c, sn))


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
