"""Host-side batch loader and image transforms, the port of
dtdl_tpu/data/loader.py.

Batches are cut from in-memory numpy arrays in the order of a
:class:`~dtdl_tpu_torch.data.sharding.ShardedSampler` (the same batches,
in the same order, as the JAX loader for the same seed), transformed on
the host, and put on the device through pinned memory with a
non-blocking copy, so the next batch travels while the card works.  The
device is the card unless the caller asks for ``device="cpu"``.

The transforms are the JAX package's vectorized numpy ones (the same
arrays for the same rng): CIFAR-10's random crop with padding 4,
horizontal flip and normalization, and normalization alone.
"""

from __future__ import annotations

import itertools
from collections import deque
from typing import Callable

import numpy as np

from dtdl_tpu_torch.data.sharding import ShardedSampler
from dtdl_tpu_torch.device import resolve_device, upload


class DataLoader:
    """Minibatch iterator over a dict of equal-length arrays, yielding
    dicts of tensors on ``device``.

    ``batch_size`` is the size of the batches this loader emits.
    Deterministic: shuffling derives from (seed, epoch) via the sampler.
    ``transform(rng, batch) -> batch`` runs per batch on the numpy arrays,
    with an rng keyed by (seed, epoch, batch index).
    """

    def __init__(self, arrays: dict, batch_size: int,
                 sampler: ShardedSampler | None = None, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True,
                 transform: Callable | None = None, device=None):
        n = len(next(iter(arrays.values())))
        for k, v in arrays.items():
            if len(v) != n:
                raise ValueError(f"array {k!r} length {len(v)} != {n}")
        self.arrays = arrays
        self.batch_size = batch_size
        self.sampler = sampler or ShardedSampler(n, shuffle=shuffle, seed=seed)
        self.drop_last = drop_last
        self.transform = transform
        self.device = resolve_device(device)
        self._epoch = 0
        if len(self) == 0:
            raise ValueError(
                f"0 batches: {len(self.sampler)} examples with batch_size "
                f"{batch_size}" + (" and drop_last=True" if drop_last else ""))

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch
        self.sampler.set_epoch(epoch)

    def __len__(self) -> int:
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        yield from self.iter_from(0)

    def iter_from(self, start_batch: int):
        """Iterate beginning at batch ``start_batch`` of this epoch; the
        skip happens at the index level, so no skipped batch is cut."""
        idx = np.asarray(self.sampler.indices())
        n_full = len(idx) // self.batch_size
        stop = n_full * self.batch_size if self.drop_last else len(idx)
        for b, start in enumerate(range(start_batch * self.batch_size, stop,
                                        self.batch_size),
                                  start=start_batch):
            take = idx[start:start + self.batch_size]
            batch = {k: v[take] for k, v in self.arrays.items()}
            if self.transform is not None:
                rng = np.random.default_rng(
                    (self.sampler.seed, self._epoch, b, 7))
                batch = self.transform(rng, batch)
            yield {k: upload(v, self.device) for k, v in batch.items()}


def resume_iter(loader, skip: int):
    """Iterator over ``loader`` from batch ``skip`` of the current epoch:
    ``iter_from`` where the loader has it, else the skipped batches are
    drawn and dropped."""
    if not skip:
        return iter(loader)
    if hasattr(loader, "iter_from"):
        return loader.iter_from(skip)
    return (b for j, b in enumerate(iter(loader)) if j >= skip)


class LimitBatches:
    """First-``n``-batches view of a loader (``n=0``: no limit)."""

    def __init__(self, loader, n: int):
        self.loader, self.n = loader, n

    @property
    def batch_size(self):
        return self.loader.batch_size

    def __len__(self) -> int:
        n = len(self.loader)
        return min(self.n, n) if self.n else n

    def __iter__(self):
        it = iter(self.loader)
        return itertools.islice(it, self.n) if self.n else it


def prefetch_to_device(iterator, put: Callable, depth: int = 2):
    """Issue ``put`` (e.g. ``strategy.shard_batch``) ``depth`` batches
    ahead of the consumer, in order.  The port's loader has put each
    batch on the device already (a non-blocking copy), so ``put`` runs on
    device tensors and copies nothing again; pulling ahead queues batch
    N+1's copy before batch N's step is consumed, as the JAX loader's
    asynchronous ``device_put`` does."""
    buf = deque()
    for item in iterator:
        buf.append(put(item))
        if len(buf) >= depth:
            yield buf.popleft()
    while buf:
        yield buf.popleft()


def cifar10_train_transform(mean, std):
    """Random crop (pad 4) + horizontal flip + normalize, vectorized
    over the batch (torchvision's RandomCrop(32, padding=4),
    RandomHorizontalFlip, ToTensor, Normalize)."""
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)

    def transform(rng, batch):
        x = batch["image"]
        b, h, w, c = x.shape
        padded = np.pad(x, ((0, 0), (4, 4), (4, 4), (0, 0)), mode="constant")
        ys = rng.integers(0, 9, b)
        xs = rng.integers(0, 9, b)
        row_idx = ys[:, None] + np.arange(h)[None, :]
        col_idx = xs[:, None] + np.arange(w)[None, :]
        out = padded[np.arange(b)[:, None, None], row_idx[:, :, None],
                     col_idx[:, None, :], :]
        flip = rng.random(b) < 0.5
        out[flip] = out[flip, :, ::-1, :]
        out = (out - mean) / std
        return {**batch, "image": out.astype(np.float32)}

    return transform


def normalize_transform(mean, std):
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)

    def transform(rng, batch):
        del rng
        x = (batch["image"] - mean) / std
        return {**batch, "image": x.astype(np.float32)}

    return transform
