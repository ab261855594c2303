"""Dataset registry, the port of dtdl_tpu/data/datasets.py: MNIST,
CIFAR-10, synthetic.

``load_dataset(name, root)`` returns NHWC float32 images in [0, 1] with
int32 labels, ``(train_images, train_labels), (test_images,
test_labels)``: MNIST from IDX files (gzipped or not) or a Keras npz
under ``root/mnist``; CIFAR-10 from the python pickle batches under
``root``; and, when the files are absent, the JAX package's loud
deterministic synthetic fallback (the same arrays, the same warning).

``load_cifar10(download=True)`` fetches the archive when the batches are
missing, as the JAX one does: the leader alone downloads (MD5-checked,
atomic extraction), the other processes wait at a barrier, and a process
that still sees no batches after it (a disk of its own) retries under an
exclusive lock file.  Only if that fails too, or with ``download=False``
or ``DTDL_OFFLINE`` set, do the missing batches mean the loud synthetic
fallback.
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


CIFAR10_URL = "https://www.cs.toronto.edu/~kriz/cifar-10-python.tar.gz"
CIFAR10_MD5 = "c58f30108f718f92721af3b95e74349a"  # torchvision's tgz_md5


def download_cifar10(root: str, url: str | None = None,
                     md5: str | None = None) -> str:
    """Fetch, checksum-verify, and extract the CIFAR-10 python batches.

    Parity with the reference's ``CIFAR10(root, download=True)``
    (reference pytorch/single_gpu.py:57,
    pytorch/distributed_data_parallel.py:85): idempotent (skips the fetch
    when the verified archive is already present), MD5-checked with the
    same constant torchvision pins, atomic (.part rename).  Returns the
    extracted ``cifar-10-batches-py`` directory.
    """
    import hashlib
    import shutil
    import tarfile
    import urllib.request

    url = url or CIFAR10_URL
    md5 = md5 or CIFAR10_MD5
    os.makedirs(root, exist_ok=True)
    tgz = os.path.join(root, "cifar-10-python.tar.gz")
    if not os.path.exists(tgz):
        log.info("downloading CIFAR-10 from %s to %s", url, tgz)
        tmp = tgz + ".part"
        with urllib.request.urlopen(url, timeout=120) as r, \
                open(tmp, "wb") as f:
            shutil.copyfileobj(r, f)
        os.replace(tmp, tgz)
    h = hashlib.md5()
    with open(tgz, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    if h.hexdigest() != md5:
        os.remove(tgz)
        raise IOError(f"CIFAR-10 archive checksum mismatch: got "
                      f"{h.hexdigest()}, want {md5} — corrupt download "
                      f"removed, retry")
    # atomic extraction: unpack into a scratch dir, verify every batch
    # file, then one os.replace — an interrupted run can never leave a
    # half-extracted cifar-10-batches-py that later loads partially
    scratch = tgz + ".extract"
    shutil.rmtree(scratch, ignore_errors=True)
    with tarfile.open(tgz, "r:gz") as tf:
        tf.extractall(scratch, filter="data")
    src = os.path.join(scratch, "cifar-10-batches-py")
    missing = [n for n in _CIFAR_BATCHES
               if not os.path.exists(os.path.join(src, n))]
    if missing:
        shutil.rmtree(scratch, ignore_errors=True)
        raise IOError(f"archive extracted but missing {missing}")
    out = os.path.join(root, "cifar-10-batches-py")
    shutil.rmtree(out, ignore_errors=True)   # replace any partial leftover
    os.replace(src, out)
    shutil.rmtree(scratch, ignore_errors=True)
    return out


def _download_locked(root: str, heartbeat: float = 15.0,
                     stale_after: float = 120.0) -> None:
    """download_cifar10 guarded by an exclusive lockfile: the winner
    fetches, everyone else sharing this filesystem polls for the result.

    **Liveness, not a wall clock**: the winner touches the lock's mtime
    every ``heartbeat`` seconds from a daemon thread, and pollers wait for
    as long as they keep *observing the mtime change* (judged against a
    local monotonic clock, so cross-host clock skew and NFS attribute-cache
    lag cannot make a live lock look stale) — a live download can
    legitimately run for hours and every rank still converges on the same
    real dataset (no poller ever gives up on a live winner and silently
    trains on synthetic data while the winner trains on real CIFAR-10).
    Only a lock whose heartbeat has stopped for ``stale_after`` of local
    observation (a hard-killed owner) is reaped.  Every poller exit —
    winner finished, lock reaped here or by a peer — loops back into
    acquisition, where the already-downloaded check under the lock decides
    whether any work remains: a transiently-vanished lock can never strand
    one rank on the synthetic fallback while its peers get real data.
    Reap removal goes through rename-then-unlink, which narrows (but does
    not close) the check-to-remove race against a fresh lock re-created at
    the same path; the fallout of losing that race is a duplicate download
    attempt, and the checksum + atomic extract keep the result correct.
    """
    import threading
    import time
    os.makedirs(root, exist_ok=True)
    lock = os.path.join(root, ".cifar10.download.lock")

    def _reap():
        try:
            victim = f"{lock}.stale.{os.getpid()}.{time.time_ns()}"
            os.rename(lock, victim)   # narrows (not closes) the race
            os.unlink(victim)
            log.warning("removed stale dataset download lock %s", lock)
        except OSError:
            pass   # already gone / lost the rename race

    while True:
        try:
            fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            break   # winner
        except FileExistsError:
            pass
        # Loser: poll while the winner's heartbeat keeps the lock's mtime
        # *changing*.  Staleness is judged by locally-observed mtime change
        # against a local monotonic clock — never by (now - mtime), which
        # compares this host's wall clock against an mtime stamped by the
        # winner's host (cross-host clock skew or NFS attribute-cache lag
        # would reap a live lock).  The cost: an orphan lock takes
        # ``stale_after`` of observation before it is reaped.
        last_mtime = None
        last_change = time.monotonic()
        stale = False
        while True:
            try:
                m = os.path.getmtime(lock)
            except OSError:
                break   # lock vanished: winner finished OR another poller
                        # reaped it — re-enter acquisition; a finished
                        # download is caught under the lock (dir re-scan)
            if m != last_mtime:
                last_mtime, last_change = m, time.monotonic()
            elif time.monotonic() - last_change > stale_after:
                stale = True
                break   # heartbeat stopped: hard-killed owner
            time.sleep(1.0)
        if stale:
            _reap()
        continue    # retry acquisition; the dataset check below decides
                    # whether any downloading is actually left to do
    stop = threading.Event()

    def _beat():
        while not stop.wait(heartbeat):
            try:
                os.utime(lock)
            except OSError:
                return
    beater = threading.Thread(target=_beat, daemon=True)
    beater.start()
    try:
        os.close(fd)
        if _find_cifar10_dir(root) is None:
            download_cifar10(root)
    finally:
        stop.set()
        beater.join()
        try:
            os.unlink(lock)
        except OSError:
            pass


def _find_cifar10_dir(root: str) -> str | None:
    """A directory counts only when every batch file is in it."""
    for cand in ("cifar-10-batches-py", "cifar10", "."):
        d = os.path.join(root, cand)
        if all(os.path.exists(os.path.join(d, n)) for n in _CIFAR_BATCHES):
            return d
    return None


def load_cifar10(root: str = "./datasets", download: bool = True,
                 keep_train: int | None = None,
                 keep_test: int | None = None):
    """CIFAR-10 from the python pickle batches under ``root`` (or its
    ``cifar-10-batches-py``/``cifar10`` directory).

    When the batches are missing and ``download=True``, they are fetched
    and checksum-verified first — **leader-gated**: in a multi-process
    world only process 0 downloads and extracts, everyone else waits at a
    barrier and re-scans, so ranks sharing a dataset root never race on
    the archive.  A process that still finds no batches (the leader's
    download landed on another filesystem, or failed) retries into its
    own root under :func:`_download_locked`.  Only if that fails too
    (e.g. no network egress) does the LOUD deterministic synthetic
    fallback engage; ``download=False`` or ``DTDL_OFFLINE`` go to it
    directly.  ``keep_train``/``keep_test`` return only the splits' first
    examples (the synthetic stand-in then makes only those, the same
    values as the whole set's).
    """
    from dtdl_tpu_torch.runtime.bootstrap import barrier, is_leader

    if os.environ.get("DTDL_OFFLINE"):
        download = False     # CI / air-gapped: never touch the network
    cdir = _find_cifar10_dir(root)
    if download:
        # every process takes this path (the barrier is collective even
        # for ranks that already see the extracted directory)
        if cdir is None and is_leader():
            try:
                download_cifar10(root)
            except Exception as e:  # no egress / bad mirror: loud fallback
                log.error("CIFAR-10 download failed (%s: %s)",
                          type(e).__name__, e)
        barrier("cifar10_download")
        cdir = _find_cifar10_dir(root)
        if cdir is None:
            try:
                _download_locked(root)
            except Exception as e:
                log.error("CIFAR-10 local download failed (%s: %s)",
                          type(e).__name__, e)
            cdir = _find_cifar10_dir(root)
    if cdir is None:
        log.warning(
            "=== SYNTHETIC DATA IN USE === CIFAR-10 not found under %s and "
            "download failed/disabled; training on DETERMINISTIC SYNTHETIC "
            "images. Loss/accuracy are NOT comparable to real CIFAR-10 — "
            "place cifar-10-python.tar.gz under the dataset root or enable "
            "network access.", root)
        return synthetic.synthetic_cifar10(keep_train=keep_train,
                                           keep_test=keep_test)

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
    return ((tr_i[:keep_train], tr_l[:keep_train]),
            (te_i[:keep_test], te_l[:keep_test]))


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
