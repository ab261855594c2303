"""Host-side batch loader, the port of dtdl_tpu/data/loader.py:DataLoader.

Batches are cut from in-memory numpy arrays in the order of a
:class:`~dtdl_tpu_torch.data.sharding.ShardedSampler` (the same batches,
in the same order, as the JAX loader for the same seed), transformed on
the host, and put on the device through pinned memory with a
non-blocking copy, so the next batch travels while the card works.  The
device is the card unless the caller asks for ``device="cpu"``.
"""

from __future__ import annotations

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
