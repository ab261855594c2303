"""Dataset registry, the port of dtdl_tpu/data/datasets.py: MNIST,
CIFAR-10, synthetic.

``load_dataset(name, root)`` returns NHWC float32 images in [0, 1] with
int32 labels, ``(train_images, train_labels), (test_images,
test_labels)``: MNIST from IDX files (gzipped or not) or a Keras npz
under ``root/mnist``; CIFAR-10 from the python pickle batches under
``root``; and, when the files are absent, the JAX package's loud
deterministic synthetic fallback (the same arrays, the same warning).

The JAX ``load_cifar10(download=True)`` fetches the archive when the
batches are missing, the leader alone, the other processes waiting at a
barrier.  That needs the network and ROADMAP queue A9's leader barrier,
so here it raises by name; with ``download=False`` or ``DTDL_OFFLINE``
set the missing batches mean the synthetic fallback, as in JAX.
"""

from __future__ import annotations

import logging
import os
import pickle

import numpy as np

from dtdl_tpu_torch.data import idx, synthetic

log = logging.getLogger("dtdl_tpu_torch")

# standard IDX file names (and the reference's variants)
_MNIST_FILES = {
    "train_images": ("train-images-idx3-ubyte.gz", "train-images.idx3-ubyte.gz"),
    "train_labels": ("train-labels-idx1-ubyte.gz", "train-labels.idx1-ubyte.gz"),
    "test_images": ("t10k-images-idx3-ubyte.gz", "t10k-images.idx3-ubyte.gz"),
    "test_labels": ("t10k-labels-idx1-ubyte.gz", "t10k-labels.idx1-ubyte.gz"),
}

_CIFAR_BATCHES = [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]

CIFAR10_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR10_STD = np.array([0.2470, 0.2435, 0.2616], np.float32)


def _find(root: str, names) -> str | None:
    for n in names:
        for cand in (os.path.join(root, n), os.path.join(root, n[:-3])):
            if os.path.exists(cand):
                return cand
    return None


def load_mnist(root: str = "./datasets", flatten: bool = False):
    """MNIST from IDX/gz or npz under ``root``/mnist; synthetic fallback."""
    mdir = os.path.join(root, "mnist")
    npz = os.path.join(mdir, "mnist.npz")
    paths = {k: _find(mdir, v) for k, v in _MNIST_FILES.items()}
    if all(paths.values()):
        def maker():
            tr_i, tr_l = idx.load_idx_pair(paths["train_images"],
                                           paths["train_labels"])
            te_i, te_l = idx.load_idx_pair(paths["test_images"],
                                           paths["test_labels"])
            return {"x_train": tr_i, "y_train": tr_l,
                    "x_test": te_i, "y_test": te_l}
        z = idx.cache_npz(os.path.join(mdir, "mnist_cache.npz"), maker)
        train = (z["x_train"], z["y_train"])
        test = (z["x_test"], z["y_test"])
    elif os.path.exists(npz):
        with np.load(npz) as z:      # the Keras layout
            train = (z["x_train"], z["y_train"])
            test = (z["x_test"], z["y_test"])
    else:
        log.warning(
            "=== SYNTHETIC DATA IN USE === MNIST files not found under %s; "
            "training on DETERMINISTIC SYNTHETIC images. Loss/accuracy are "
            "NOT comparable to real MNIST.", mdir)
        train, test = synthetic.synthetic_mnist()

    def prep(images, labels):
        images = np.asarray(images, np.float32)
        if images.max() > 1.5:  # raw 0-255 pixels
            images = images / 255.0
        if images.ndim == 3:
            images = images[..., None]
        if flatten:
            images = images.reshape(images.shape[0], -1)
        return images, np.asarray(labels, np.int32)

    return prep(*train), prep(*test)


def _find_cifar10_dir(root: str) -> str | None:
    """A directory counts only when every batch file is in it."""
    for cand in ("cifar-10-batches-py", "cifar10", "."):
        d = os.path.join(root, cand)
        if all(os.path.exists(os.path.join(d, n)) for n in _CIFAR_BATCHES):
            return d
    return None


def load_cifar10(root: str = "./datasets", download: bool = True):
    """CIFAR-10 from the python pickle batches under ``root`` (or its
    ``cifar-10-batches-py``/``cifar10`` directory); the synthetic
    fallback, loudly, when they are missing and ``download`` is off or
    ``DTDL_OFFLINE`` is set.  Missing batches with ``download`` on raise
    :class:`NotImplementedError`: fetching them is ROADMAP queue A9."""
    if os.environ.get("DTDL_OFFLINE"):
        download = False     # CI / air-gapped: never touch the network
    cdir = _find_cifar10_dir(root)
    if cdir is None and download:
        raise NotImplementedError(
            f"CIFAR-10 batches not found under {root!r}, and fetching them "
            f"(download=True) needs the network and the leader barrier of "
            f"ROADMAP queue A9 (distributed); place the extracted "
            f"cifar-10-batches-py under the root, or pass download=False "
            f"(or set DTDL_OFFLINE) for the synthetic stand-in")
    if cdir is None:
        log.warning(
            "=== SYNTHETIC DATA IN USE === CIFAR-10 not found under %s and "
            "download failed/disabled; training on DETERMINISTIC SYNTHETIC "
            "images. Loss/accuracy are NOT comparable to real CIFAR-10 — "
            "place cifar-10-python.tar.gz under the dataset root or enable "
            "network access.", root)
        return synthetic.synthetic_cifar10()

    def read_batch(name):
        # the batches are the dataset's own python pickles, read from the
        # dataset root the caller names
        with open(os.path.join(cdir, name), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        images = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        return images, np.asarray(d[b"labels"], np.int32)

    parts = [read_batch(f"data_batch_{i}") for i in range(1, 6)]
    tr_i = np.concatenate([p[0] for p in parts]).astype(np.float32) / 255.0
    tr_l = np.concatenate([p[1] for p in parts])
    te_i, te_l = read_batch("test_batch")
    te_i = te_i.astype(np.float32) / 255.0
    return (tr_i, tr_l), (te_i, te_l)


def normalize_cifar10(images: np.ndarray) -> np.ndarray:
    """Channel normalization with the CIFAR-10 statistics."""
    return (images - CIFAR10_MEAN) / CIFAR10_STD


def load_dataset(name: str, root: str = "./datasets", **kwargs):
    if name == "mnist":
        return load_mnist(root, **kwargs)
    if name == "cifar10":
        return load_cifar10(root, **kwargs)
    if name == "synthetic":
        return synthetic.synthetic_mnist(**kwargs)
    if name == "synthetic_lm":
        return synthetic.synthetic_lm(**kwargs)
    raise ValueError(f"unknown dataset {name!r}")
