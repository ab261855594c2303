"""The port's data pipeline against the JAX package's, on the CPU.

The synthetic token generators, the sampler and the loader are numpy in
both packages; the port keeps its own copy, and for the same seeds it must
give the same arrays, the same indices and the same batches in the same
order (exact equality).  The port's loader puts its batches on a device:
the card unless asked for ``device="cpu"``.
"""

import numpy as np
import pytest
import torch

from dtdl_tpu.data import loader as jloader
from dtdl_tpu.data import sharding as jsharding
from dtdl_tpu.data import synthetic as jsyn
from dtdl_tpu_torch.data import loader as tloader
from dtdl_tpu_torch.data import sharding as tsharding
from dtdl_tpu_torch.data import synthetic as tsyn
from dtdl_tpu_torch.device import NoCudaDeviceError


@pytest.mark.parametrize("kw", [
    dict(n_seqs=5, seq_len=40),
    dict(n_seqs=3, seq_len=17, vocab_size=32000, seed=3, branch=2),
    dict(n_seqs=4, seq_len=9, seed=1, noise_seed=99),
])
def test_markov_tokens_match_jax(kw):
    want = jsyn.markov_tokens(**kw)
    got = tsyn.markov_tokens(**kw)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_synthetic_lm_matches_jax():
    for a, b in zip(tsyn.synthetic_lm(20, 6, seq_len=33, vocab_size=500,
                                      seed=2),
                    jsyn.synthetic_lm(20, 6, seq_len=33, vocab_size=500,
                                      seed=2)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,shards,remainder,shuffle", [
    (10, 1, "pad", True), (10, 3, "pad", True), (10, 3, "drop", True),
    (7, 2, "pad", False)])
def test_sharded_sampler_matches_jax(n, shards, remainder, shuffle):
    for shard in range(shards):
        kw = dict(num_shards=shards, shard_id=shard, shuffle=shuffle,
                  seed=5, remainder=remainder)
        j = jsharding.ShardedSampler(n, **kw)
        t = tsharding.ShardedSampler(n, **kw)
        assert len(t) == len(j)
        for epoch in (0, 1, 4):
            j.set_epoch(epoch)
            t.set_epoch(epoch)
            np.testing.assert_array_equal(t.indices(), j.indices())
            assert list(t) == list(j)
    with pytest.raises(ValueError, match="shard_id"):
        tsharding.ShardedSampler(4, 2, 2)


def test_data_loader_batches_match_jax():
    """Same batches in the same order over two epochs, a resumed
    iteration (iter_from) and a keyed transform; the port's batches are
    tensors on the asked device."""
    tokens = tsyn.markov_tokens(23, 12, 64, seed=4)
    labels = np.arange(23, dtype=np.int32)

    def transform(rng, batch):
        return {**batch, "noise": rng.integers(0, 1000, len(batch["label"]))}

    def make(mod, sampler_mod, **kw):
        return mod.DataLoader({"tokens": tokens, "label": labels}, 4,
                              sampler=sampler_mod.ShardedSampler(
                                  23, seed=9), transform=transform, **kw)
    j = make(jloader, jsharding)
    t = make(tloader, tsharding, device="cpu")
    assert len(t) == len(j) == 5
    for epoch in (0, 1):
        j.set_epoch(epoch)
        t.set_epoch(epoch)
        jb, tb = list(j), list(t)
        assert len(tb) == len(jb)
        for a, b in zip(tb, jb):
            assert set(a) == set(b) == {"tokens", "label", "noise"}
            for key in b:
                assert isinstance(a[key], torch.Tensor)
                assert a[key].device.type == "cpu"
                np.testing.assert_array_equal(a[key].numpy(), b[key])
    for a, b in zip(t.iter_from(3), j.iter_from(3)):
        np.testing.assert_array_equal(a["tokens"].numpy(), b["tokens"])


def test_data_loader_runs_on_the_card_by_default(monkeypatch):
    tokens = tsyn.markov_tokens(8, 5, 16)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDeviceError):
        tloader.DataLoader({"tokens": tokens}, 2)
    with pytest.raises(ValueError, match="0 batches"):
        tloader.DataLoader({"tokens": tokens}, 16, device="cpu")


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_prefetch_to_device_keeps_the_jax_order_and_depth(depth):
    """``put`` runs ``depth`` batches ahead of the consumer in both
    packages, in order; the port's loader has its batches on the device
    already, and the prefetch hands on the very tensors ``put`` returns
    (no second copy)."""
    def trace(module):
        log = []

        def put(b):
            log.append(("put", b["i"]))
            return b
        out = []
        for b in module.prefetch_to_device(iter([{"i": i} for i in range(5)]),
                                           put, depth):
            log.append(("got", b["i"]))
            out.append(b)
        return log, out

    assert trace(tloader)[0] == trace(jloader)[0]
    loader = tloader.DataLoader({"x": np.arange(12.0).reshape(6, 2)}, 2,
                                shuffle=False, device="cpu")
    seen = []
    got = list(tloader.prefetch_to_device(
        iter(loader), lambda b: seen.append(b["x"]) or b, depth))
    assert len(got) == len(seen) == 3
    assert all(a is b for a, b in zip((b["x"] for b in got), seen))
    np.testing.assert_array_equal(torch.cat([b["x"] for b in got]).numpy(),
                                  np.arange(12.0).reshape(6, 2))
