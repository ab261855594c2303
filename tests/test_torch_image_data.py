"""The port's image data path against the JAX package's, on the CPU.

The port keeps numpy copies of the JAX package's framework-free data
code, so everything here is held bit for bit (``np.array_equal``): the
synthetic MNIST and CIFAR-10 stand-ins, the CIFAR-10 train transform
(random crop with padding 4, flip, normalize) and the normalize transform
for one rng, the loader's batches (tensors on the CPU against the JAX
loader's numpy), ``LimitBatches`` and ``resume_iter``; CIFAR-10 read from
pickled batches and MNIST from IDX files that the test writes; the
offline fallback (the same synthetic arrays, the same loud warning); and
the port's refusal to download.
"""

import gzip
import logging
import os
import pickle
import struct

import numpy as np
import pytest
import torch

from dtdl_tpu.data import datasets as jdatasets
from dtdl_tpu.data import idx as jidx
from dtdl_tpu.data import loader as jloader
from dtdl_tpu.data import synthetic as jsynthetic
from dtdl_tpu_torch.data import datasets, idx, loader, synthetic
from test_data import _make_cifar_fixture

torch.set_num_threads(1)


def equal_trees(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            equal_trees(x, y)
    else:
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_synthetic_images_match_jax():
    equal_trees(synthetic.class_pattern_images(20, (8, 8, 3), 10, 3,
                                               noise_seed=4),
                jsynthetic.class_pattern_images(20, (8, 8, 3), 10, 3,
                                                noise_seed=4))
    equal_trees(synthetic.synthetic_mnist(n_train=30, n_test=10),
                jsynthetic.synthetic_mnist(n_train=30, n_test=10))
    equal_trees(synthetic.synthetic_cifar10(n_train=30, n_test=10),
                jsynthetic.synthetic_cifar10(n_train=30, n_test=10))
    equal_trees(synthetic.synthetic_cifar10(n_train=30, n_test=10, seed=9),
                jsynthetic.synthetic_cifar10(n_train=30, n_test=10, seed=9))


def test_transforms_match_jax():
    (x, y), _ = synthetic.synthetic_cifar10(n_train=16, n_test=1)
    batch = {"image": x, "label": y}
    for make in ("cifar10_train_transform", "normalize_transform"):
        got = getattr(loader, make)(datasets.CIFAR10_MEAN,
                                    datasets.CIFAR10_STD)(
            np.random.default_rng(5), batch)
        want = getattr(jloader, make)(jdatasets.CIFAR10_MEAN,
                                      jdatasets.CIFAR10_STD)(
            np.random.default_rng(5), batch)
        assert set(got) == set(want)
        for k in want:
            equal_trees(got[k], want[k])
    equal_trees(datasets.normalize_cifar10(x), jdatasets.normalize_cifar10(x))
    equal_trees(datasets.CIFAR10_MEAN, jdatasets.CIFAR10_MEAN)
    equal_trees(datasets.CIFAR10_STD, jdatasets.CIFAR10_STD)


def test_loader_batches_limit_and_resume_match_jax():
    (x, y), _ = synthetic.synthetic_cifar10(n_train=40, n_test=1)
    arrays = {"image": x, "label": y}
    tf = loader.cifar10_train_transform(datasets.CIFAR10_MEAN,
                                        datasets.CIFAR10_STD)
    jtf = jloader.cifar10_train_transform(jdatasets.CIFAR10_MEAN,
                                          jdatasets.CIFAR10_STD)
    tl = loader.DataLoader(arrays, 8, seed=2, transform=tf, device="cpu")
    jl = jloader.DataLoader(arrays, 8, seed=2, transform=jtf)
    for epoch in (0, 1):
        tl.set_epoch(epoch)
        jl.set_epoch(epoch)
        got, want = list(tl), list(jl)
        assert len(got) == len(want) == len(tl) == 5
        for g, w in zip(got, want):
            assert all(isinstance(v, torch.Tensor) for v in g.values())
            for k in w:
                equal_trees(g[k].numpy(), w[k])
    limited = list(loader.LimitBatches(tl, 2))
    assert len(limited) == 2 and loader.LimitBatches(tl, 2).batch_size == 8
    assert len(list(loader.LimitBatches(tl, 0))) == 5
    for skip in (0, 3):
        got = list(loader.resume_iter(tl, skip))
        want = list(jloader.resume_iter(jl, skip))
        assert len(got) == len(want) == 5 - skip
        for g, w in zip(got, want):
            equal_trees(g["image"].numpy(), w["image"])
    # a loader without iter_from: the skipped batches are drawn and dropped
    plain = [{"i": np.array([j])} for j in range(4)]
    assert [b["i"][0] for b in loader.resume_iter(plain, 1)] == [1, 2, 3]


def write_idx(path, arr, code):
    header = struct.pack(">HBB", 0, code, arr.ndim) + struct.pack(
        ">" + "I" * arr.ndim, *arr.shape)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(header + arr.tobytes())


def test_idx_reader_and_mnist_files_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (12, 28, 28)).astype(np.uint8)
    labels = rng.integers(0, 10, 12).astype(np.uint8)
    big = rng.integers(-5, 5, (3, 4)).astype(">i4")
    write_idx(str(tmp_path / "big.idx"), big, 0x0C)
    equal_trees(idx.read_idx(str(tmp_path / "big.idx")),
                jidx.read_idx(str(tmp_path / "big.idx")))
    mdir = tmp_path / "mnist"
    mdir.mkdir()
    for name, arr, code in (
            ("train-images-idx3-ubyte.gz", images, 0x08),
            ("train-labels-idx1-ubyte.gz", labels, 0x08),
            ("t10k-images-idx3-ubyte", images[:4], 0x08),
            ("t10k-labels-idx1-ubyte", labels[:4], 0x08)):
        write_idx(str(mdir / name), arr, code)
    pair = idx.load_idx_pair(str(mdir / "train-images-idx3-ubyte.gz"),
                             str(mdir / "train-labels-idx1-ubyte.gz"))
    equal_trees(pair, jidx.load_idx_pair(
        str(mdir / "train-images-idx3-ubyte.gz"),
        str(mdir / "train-labels-idx1-ubyte.gz")))
    assert pair[1].dtype == np.int32
    got = datasets.load_mnist(str(tmp_path))
    assert os.path.exists(mdir / "mnist_cache.npz")     # parse once
    equal_trees(got, jdatasets.load_mnist(str(tmp_path)))
    equal_trees(datasets.load_mnist(str(tmp_path), flatten=True),
                jdatasets.load_mnist(str(tmp_path), flatten=True))
    assert got[0][0].shape == (12, 28, 28, 1) and got[0][0].max() <= 1.0
    with pytest.raises(ValueError, match="length|!="):
        idx.load_idx_pair(str(mdir / "train-images-idx3-ubyte.gz"),
                          str(mdir / "t10k-labels-idx1-ubyte"))
    (tmp_path / "bad.idx").write_bytes(b"\x01\x02\x08\x01" + b"\0" * 8)
    with pytest.raises(ValueError, match="not an IDX file"):
        idx.read_idx(str(tmp_path / "bad.idx"))
    short = struct.pack(">HBB", 0, 0x08, 1) + struct.pack(">I", 9) + b"\0"
    (tmp_path / "short.idx").write_bytes(short)
    with pytest.raises(ValueError, match="payload"):
        idx.read_idx(str(tmp_path / "short.idx"))
    # the Keras npz layout
    kdir = tmp_path / "keras" / "mnist"
    kdir.mkdir(parents=True)
    np.savez(kdir / "mnist.npz", x_train=images, y_train=labels,
             x_test=images[:3], y_test=labels[:3])
    equal_trees(datasets.load_mnist(str(tmp_path / "keras")),
                jdatasets.load_mnist(str(tmp_path / "keras")))


def test_cifar10_from_pickled_batches_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    cdir = tmp_path / "cifar-10-batches-py"
    cdir.mkdir()
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(cdir / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (3, 3072)).astype(
                np.uint8), b"labels": list(rng.integers(0, 10, 3))}, f)
    got = datasets.load_cifar10(str(tmp_path), download=False)
    equal_trees(got, jdatasets.load_cifar10(str(tmp_path), download=False))
    assert got[0][0].shape == (15, 32, 32, 3) and got[1][0].shape == (3, 32,
                                                                      32, 3)
    # present batches need no download, so download=True is no refusal
    equal_trees(datasets.load_dataset("cifar10", str(tmp_path),
                                      download=True), got)


@pytest.fixture
def small_fallback(monkeypatch):
    """Both packages' fallbacks at a few images (the defaults are 60000)."""
    for mod in (synthetic, jsynthetic):
        for name in ("synthetic_cifar10", "synthetic_mnist"):
            full = getattr(mod, name)
            monkeypatch.setattr(mod, name, lambda full=full, **kw: full(
                n_train=12, n_test=4, **kw))


def test_offline_fallback_matches_jax(tmp_path, small_fallback, caplog):
    assert os.environ.get("DTDL_OFFLINE")
    with caplog.at_level(logging.WARNING):
        got = datasets.load_cifar10(str(tmp_path))
    assert "SYNTHETIC DATA IN USE" in caplog.text and str(tmp_path) in \
        caplog.text
    port_msg = [r.getMessage() for r in caplog.records
                if r.name == "dtdl_tpu_torch"]
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        want = jdatasets.load_cifar10(str(tmp_path))
    jax_msg = [r.getMessage() for r in caplog.records
               if r.name == "dtdl_tpu"]
    assert port_msg == jax_msg and len(port_msg) == 1
    equal_trees(got, want)
    equal_trees(datasets.load_dataset("mnist", str(tmp_path)),
                jdatasets.load_dataset("mnist", str(tmp_path)))
    equal_trees(datasets.load_dataset("synthetic", str(tmp_path)),
                jdatasets.load_dataset("synthetic", str(tmp_path)))
    equal_trees(datasets.load_dataset("synthetic_lm", n_train=4, n_test=2,
                                      seq_len=8),
                jdatasets.load_dataset("synthetic_lm", n_train=4, n_test=2,
                                       seq_len=8))
    with pytest.raises(ValueError, match="unknown dataset"):
        datasets.load_dataset("imagenet")


def test_download_is_refused_by_name(tmp_path, monkeypatch, small_fallback):
    """The download is ported now: ``download=True`` (the default) fetches
    the archive, here from a ``file://`` URL (never the network), and
    reads the same arrays as the JAX package reads from what it wrote."""
    tgz, md5 = _make_cifar_fixture(tmp_path)
    monkeypatch.delenv("DTDL_OFFLINE", raising=False)
    monkeypatch.setattr(datasets, "CIFAR10_URL", tgz.as_uri())
    monkeypatch.setattr(datasets, "CIFAR10_MD5", md5)
    got = datasets.load_cifar10(str(tmp_path / "a"))
    equal_trees(got, jdatasets.load_cifar10(str(tmp_path / "a"),
                                            download=False))
    equal_trees(datasets.load_dataset("cifar10", str(tmp_path / "b"),
                                      download=True), got)
    # download=False takes the loud fallback without the environment flag
    equal_trees(datasets.load_cifar10(str(tmp_path / "c"), download=False),
                synthetic.synthetic_cifar10())


def test_cache_npz_parses_once(tmp_path):
    calls = []

    def maker():
        calls.append(1)
        return {"a": np.arange(3)}
    path = str(tmp_path / "sub" / "c.npz")
    for _ in range(2):
        equal_trees(idx.cache_npz(path, maker)["a"], np.arange(3))
    assert calls == [1]
