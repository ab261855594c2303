"""Tenancy through kernel K4 on the card against the plain path on the
CPU.

These need the card (K4 has no CPU mode): they carry the ``cuda`` marker
and skip, with the reason, where no CUDA device is visible.  On the card:
``python -m pytest tests/test_torch_tenant_card.py -m cuda``.

A 2-layer LM at base width (d_model 512, 4 heads of 128, vocab 32000,
f32) with random weights from one seed, built on the card and on the CPU,
rank-8 LoRA adapters saved once.  Tolerance: greedy tokens identical
between the card (K4, the LoRA delta on the card, the packed masks
unpacked there) and the CPU (the plain attend), in serving and in the
window of one masked, adapted verify step (its emitted counts too).
"""

import numpy as np
import pytest
import torch

from dtdl_tpu_torch import kernels
from dtdl_tpu_torch.ckpt.checkpoint import save_weights
from dtdl_tpu_torch.models.transformer import transformer_lm
from dtdl_tpu_torch.serve import (InferenceEngine, Request, Scheduler,
                                  TokenStream, adapter_template, byte_vocab,
                                  compile_regex)

RANK = 8
EOS = 31999


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: kernel K4 has no CPU mode")
    return torch.device("cuda")


def _model(device):
    return transformer_lm("base", n_layers=2, max_seq=512,
                          dtype=torch.float32, seed=5, device=device)


def _adapters(model, tmp_path):
    rng = np.random.default_rng(9)
    out = []
    for name in ("a", "b"):
        tpl = adapter_template(model, RANK)
        path = str(tmp_path / name)
        save_weights(path, {b: {"attn": {n: rng.normal(0, 0.05, x.shape)
                                         .astype(np.float32)
                                         for n, x in sub["attn"].items()}}
                            for b, sub in tpl.items()})
        out.append(path)
    return out


def _serve(model, device, paths, mode):
    dfa = compile_regex(r"[a-z]+( [a-z]+)*", byte_vocab(32000), eos_id=EOS)
    rng = np.random.default_rng(4)
    shared = rng.integers(0, 32000, 32).tolist()
    eng = InferenceEngine(model, n_slots=4, page_size=16, device=device,
                          lora_rank=RANK, lora_adapters=3)
    kw = {"chunk_tokens": 32} if mode == "chunked" else {}
    sched = Scheduler(eng, harvest_lag=2, device=device, **kw)
    reqs = []
    for i, adapter in enumerate([paths[0], paths[1], None, paths[0],
                                 paths[1], None]):
        prompt = shared + rng.integers(0, 32000, 9 + 7 * i).tolist()
        constrained = i % 2 == 1
        reqs.append(sched.submit(Request(
            prompt, 12, adapter=adapter,
            speculate=4 if mode == "spec" else 0,
            grammar=dfa if constrained else None,
            eos_id=EOS if constrained else None, stream=TokenStream())))
    kernels.reset_launches()
    sched.run()
    return reqs, dict(kernels.LAUNCHES), sched.metrics.summary()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["plain", "spec", "chunked"])
def test_tenant_serving_on_card_matches_cpu(cuda, tmp_path, mode):
    """Adapters a, b and base, half the requests under a grammar, all
    streamed, sharing a 32-token prefix: the card's greedy tokens (K4 in
    every attend) equal the CPU's plain path's."""
    paths = _adapters(_model("cpu"), tmp_path)
    got, launches, s = _serve(_model(cuda), cuda, paths, mode)
    want, _, _ = _serve(_model("cpu"), torch.device("cpu"), paths, mode)
    assert launches.get("paged_attention", 0) > 0
    for g, w in zip(got, want):
        assert g.error is None and w.error is None
        assert g.tokens == w.tokens
        assert g.stream.closed and g.stream.tokens == g.tokens
        if g.grammar is not None:
            assert g.grammar.walk(g.tokens) >= 0
    assert set(s["tokens_by_adapter"]) == {"base", *paths}


@pytest.mark.cuda
def test_masked_adapted_verify_window_on_card(cuda, tmp_path):
    """One verify step of width 5 over two slots (adapter rows 1 and 2),
    with a random mask per position: the window's tokens and emitted
    counts equal the CPU's."""
    out = {}
    for dev in (cuda, torch.device("cpu")):
        model = _model(dev)
        paths = _adapters(model, tmp_path / dev.type)
        eng = InferenceEngine(model, n_slots=2, page_size=16, device=dev,
                              lora_rank=RANK, lora_adapters=3)
        aids = [eng.adapter_bank.acquire(p) for p in paths]
        arena, last = eng.init_arena(), eng.init_last_tokens()
        rng = np.random.default_rng(6)
        tables = np.zeros((2, eng.n_ptab), np.int32)
        tables[0, :4], tables[1, :4] = range(1, 5), range(5, 9)
        for slot in range(2):
            prompt = rng.integers(0, 32000, 40).tolist()
            arena, last, _ = eng.prefill(arena, last, slot, prompt,
                                         page_row=tables[slot],
                                         adapter_id=aids[slot])
        allowed = rng.random((2, 5, 32000)) < 0.5
        drafts = rng.integers(0, 32000, (2, 4)).astype(np.int32)
        knobs = (np.zeros(2, np.float32), np.zeros(2, np.int32),
                 np.ones(2, np.float32))
        kernels.reset_launches()
        _, _, toks, n_em = eng.verify(arena, last, drafts, [4, 4],
                                      [True, True], *knobs, tables,
                                      adapter_ids=aids, allowed=allowed)
        out[dev.type] = (toks.cpu(), n_em.cpu(),
                         kernels.LAUNCHES.get("paged_attention", 0))
    assert torch.equal(out["cuda"][0], out["cpu"][0])
    assert torch.equal(out["cuda"][1], out["cpu"][1])
    assert out["cuda"][2] == 2          # one K4 launch a layer
