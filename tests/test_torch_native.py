"""The port's native C++ runtime (``dtdl_tpu_torch.native``) and its
``NativeDataLoader`` against the JAX package's.

* The counterpart of each test of tests/test_native.py: the batch
  pipeline's order, shuffle, normalization, augmentation, epochs and
  length, the IDX reader, the topology probe, the ``or_python``
  fallback, sampler-driven epochs and the refusal of an out-of-range
  sampler index.
* Parity: both packages build the same C++ source (the port from its own
  copy, into ``build/native/``); the port's batches (tensors on the CPU)
  are bitwise the JAX loader's numpy batches for the same seed, sampler
  and augmentation, and the IDX reader's arrays are the JAX reader's.
* The build: keyed by the source's hash, one library for many processes
  building at once, and ``DTDL_NATIVE_CACHE`` honoured.
* ``cifar_loaders`` with ``--num-workers > 0`` takes the native loader
  over the same ``ShardedSampler`` and prints which loader it got.

Tolerance: bitwise, but normalization against numpy (atol 1e-6, as the
JAX test).
"""

import argparse
import gzip
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from dtdl_tpu import native as jnative
from dtdl_tpu.data.native_loader import NativeDataLoader as JaxNativeLoader
from dtdl_tpu.data.native_loader import read_idx_native as jax_read_idx
from dtdl_tpu.data.sharding import ShardedSampler as JaxSampler
from dtdl_tpu_torch import native
from dtdl_tpu_torch.data.loader import DataLoader
from dtdl_tpu_torch.data.native_loader import (NativeDataLoader,
                                               read_idx_native)
from dtdl_tpu_torch.data.sharding import ShardedSampler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _data(n=64, h=8, w=8, c=3, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, h, w, c)).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int32))


def _np(batch):
    return {k: v.numpy() for k, v in batch.items()}


def loader(*args, **kw):
    return NativeDataLoader(*args, device="cpu", **kw)


def test_order_matches_python_loader_unshuffled():
    images, labels = _data()
    nat = loader(images, labels, 16, shuffle=False)
    py = DataLoader({"image": images, "label": labels}, 16, shuffle=False,
                    device="cpu")
    n = 0
    for nb, pb in zip(nat, py):
        assert isinstance(nb["image"], torch.Tensor)
        assert nb["image"].device.type == "cpu"
        assert torch.equal(nb["image"], pb["image"])
        assert torch.equal(nb["label"], pb["label"])
        n += 1
    assert n == 4
    nat.close()


def test_shuffle_is_deterministic_and_complete():
    images, _ = _data()
    labels = np.arange(64, dtype=np.int32)     # identify samples by label

    def epoch_labels(ld, epoch):
        ld.set_epoch(epoch)
        return np.concatenate([b["label"].numpy() for b in ld])

    a = loader(images, labels, 16, shuffle=True, seed=3)
    b = loader(images, labels, 16, shuffle=True, seed=3)
    e0a, e0b = epoch_labels(a, 0), epoch_labels(b, 0)
    np.testing.assert_array_equal(e0a, e0b)    # same seed, same order
    assert sorted(e0a.tolist()) == list(range(64))  # a permutation
    assert not np.array_equal(e0a, epoch_labels(a, 1))   # epochs differ
    a.close(), b.close()


def test_normalization():
    images, labels = _data(c=3)
    mean, std = [0.5, 0.4, 0.3], [0.2, 0.3, 0.4]
    nat = loader(images, labels, 16, shuffle=False, mean=mean, std=std)
    batch = _np(next(iter(nat)))
    expected = (images[:16] - np.asarray(mean, np.float32)) / \
        np.asarray(std, np.float32)
    np.testing.assert_allclose(batch["image"], expected, atol=1e-6)
    nat.close()


def test_augmentation_deterministic_and_valid():
    images, labels = _data(n=32, h=8, w=8)
    a = loader(images, labels, 8, shuffle=False, augment=True, seed=5)
    b = loader(images, labels, 8, shuffle=False, augment=True, seed=5)
    ba, bb = _np(next(iter(a))), _np(next(iter(b)))
    np.testing.assert_array_equal(ba["image"], bb["image"])
    np.testing.assert_array_equal(ba["label"], labels[:8])
    assert not np.array_equal(ba["image"], images[:8])
    a.close(), b.close()


def test_multiple_epochs_and_len():
    images, labels = _data(n=50)
    nat = loader(images, labels, 16, shuffle=True)
    assert len(nat) == 3                       # drop_last
    for epoch in range(3):
        nat.set_epoch(epoch)
        assert sum(1 for _ in nat) == 3
    nat.close()


def _write_idx(path, arr, gz):
    header = struct.pack(">HBB", 0, 0x08, arr.ndim) + \
        struct.pack(">" + "I" * arr.ndim, *arr.shape)
    blob = header + arr.tobytes()
    with (gzip.open(path, "wb") if gz else open(path, "wb")) as f:
        f.write(blob)


def test_idx_native_reader(tmp_path):
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (10, 4, 4)).astype(np.uint8)
    labels = rng.integers(0, 10, 10).astype(np.uint8)
    for gz, suffix in ((True, ".gz"), (False, "")):
        ip = str(tmp_path / f"im.idx3-ubyte{suffix}")
        lp = str(tmp_path / f"lb.idx1-ubyte{suffix}")
        _write_idx(ip, images, gz)
        _write_idx(lp, labels, gz)
        out_i, out_l = read_idx_native(ip), read_idx_native(lp)
        np.testing.assert_allclose(out_i, images.astype(np.float32) / 255.0,
                                   atol=1e-6)
        np.testing.assert_array_equal(out_l, labels.astype(np.int32))
        # the JAX reader's arrays, bit for bit
        np.testing.assert_array_equal(out_i, jax_read_idx(ip))
        np.testing.assert_array_equal(out_l, jax_read_idx(lp))
    assert read_idx_native(str(tmp_path / "missing.idx")) is None


def test_topology_probe():
    t = native.topology()
    assert t["native"] is True
    assert t["cpus"] >= 1
    assert t["host"]
    assert t == jnative.topology()


def test_or_python_fallback(monkeypatch):
    monkeypatch.setenv("DTDL_DISABLE_NATIVE", "1")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    images, labels = _data()
    ld = NativeDataLoader.or_python(images, labels, 16, shuffle=False,
                                    device="cpu")
    assert isinstance(ld, DataLoader)
    batch = next(iter(ld))
    np.testing.assert_array_equal(batch["image"].numpy(), images[:16])
    assert native.topology()["native"] is False
    with pytest.raises(RuntimeError, match="or_python"):
        NativeDataLoader(images, labels, 16, device="cpu")


def test_sampler_driven_epochs_match_python_loader():
    """With the same ShardedSampler the native and Python loaders emit
    the same batches and re-derive the global permutation each epoch."""
    images, _ = _data(n=60)
    labels = np.arange(60, dtype=np.int32)

    def epochs(ld, n=2):
        out = []
        for e in range(n):
            ld.set_epoch(e)
            out.append(np.concatenate([b["label"].numpy() for b in ld]))
        return out

    nat = loader(images, labels, 8, sampler=ShardedSampler(60, 2, 0, seed=5))
    py = DataLoader({"image": images, "label": labels}, 8,
                    sampler=ShardedSampler(60, 2, 0, seed=5), device="cpu")
    for ne, pe in zip(epochs(nat), epochs(py)):
        np.testing.assert_array_equal(ne, pe)
    e0, e1 = epochs(nat)
    assert sorted(e0.tolist()) != e0.tolist()  # shuffled
    assert e0.tolist() != e1.tolist()          # reshuffled per epoch
    nat.close()


def test_start_epoch_indices_rejects_out_of_range():
    images, labels = _data(n=16)

    class BadSampler:
        def set_epoch(self, e):
            pass

        def indices(self):
            return np.array([0, 5, 99], np.int64)  # 99 >= 16

        def __len__(self):
            return 3

    nat = loader(images, labels, 2, sampler=BadSampler())
    with pytest.raises(RuntimeError, match="out of range"):
        list(iter(nat))
    nat.close()


# ---- parity with the JAX loader ---------------------------------------------

PARITY = {
    "plain": dict(shuffle=False),
    "shuffled": dict(shuffle=True, seed=11),
    "augment-normalize": dict(shuffle=True, seed=3, augment=True,
                              mean=[0.49, 0.48, 0.45], std=[0.25, 0.24, 0.26],
                              n_threads=3),
    "sampler": dict(seed=5, augment=True, mean=[0.5, 0.4, 0.3],
                    std=[0.2, 0.3, 0.4], sampler=(2, 1, 9)),
}


@pytest.mark.parametrize("name", PARITY)
def test_batches_bitwise_equal_jax(name):
    kw = dict(PARITY[name])
    images, labels = _data(n=72, h=32, w=32)
    jkw = dict(kw)
    if "sampler" in kw:
        n, i, s = kw["sampler"]
        kw["sampler"] = ShardedSampler(72, n, i, seed=s)
        jkw["sampler"] = JaxSampler(72, n, i, seed=s)
    ours = loader(images, labels, 12, **kw)
    theirs = JaxNativeLoader(images, labels, 12, **jkw)
    assert len(ours) == len(theirs)
    for epoch in range(2):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        got = [_np(b) for b in ours]
        want = list(theirs)
        assert len(got) == len(want) == len(ours)
        for g, w in zip(got, want):
            assert g["image"].dtype == np.float32
            np.testing.assert_array_equal(g["image"], w["image"])
            np.testing.assert_array_equal(g["label"], w["label"])
    ours.close()
    theirs.close()


# ---- the build --------------------------------------------------------------

def test_build_is_keyed_cached_and_locked(tmp_path):
    """Four processes build into an empty ``DTDL_NATIVE_CACHE`` at once:
    one library named by the source's hash, no temporaries left, and
    every process loads it.  Without the variable the library lives in
    ``build/native/`` of the checkout."""
    import hashlib
    assert native.BUILD_DIR == __import__("pathlib").Path(
        REPO, "build", "native")
    tag = hashlib.sha256(native.SRC.read_bytes()).hexdigest()[:16]
    cache = tmp_path / "cache"
    code = ("import sys; sys.path.insert(0, %r); "
            "from dtdl_tpu_torch import native; "
            "print(native.available(), native.lib_path())" % REPO)
    env = dict(os.environ, DTDL_NATIVE_CACHE=str(cache))
    env.pop("DTDL_DISABLE_NATIVE", None)
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              stdout=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = {p.communicate(timeout=300)[0].strip() for p in procs}
    assert all(p.returncode == 0 for p in procs)
    lib = f"libdtdl_native_{tag}.so"
    assert outs == {f"True {cache / lib}"}
    assert sorted(f for f in os.listdir(cache)
                  if not f.startswith(".")) == [lib]


def test_cifar_loaders_take_the_native_loader(tmp_path, capsys):
    from dtdl_tpu_torch.examples.common import cifar_loaders
    from test_data import _make_cifar_fixture
    _make_cifar_fixture(tmp_path)            # 100 train, 20 test images
    args = argparse.Namespace(dataset_dir=str(tmp_path / "fixture_src"),
                              download=False,
                              batch_size=8, num_workers=2, limit_train=0,
                              limit_test=0)
    train, val = cifar_loaders(args, seed=4, device="cpu")
    assert isinstance(train, NativeDataLoader)
    assert "train loader: NativeDataLoader (2 workers)" in \
        capsys.readouterr().out
    args.num_workers = 0
    py, _ = cifar_loaders(args, seed=4, device="cpu")
    assert isinstance(py, DataLoader)
    # the same sampler stripe: the same labels in the same order
    train.set_epoch(1)
    py.set_epoch(1)
    got = np.concatenate([b["label"].numpy() for b in train])
    want = np.concatenate([b["label"].numpy() for b in py])
    np.testing.assert_array_equal(got, want)
    assert next(iter(train))["image"].shape == (8, 32, 32, 3)
    train.close()
