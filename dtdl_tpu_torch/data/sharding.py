"""Deterministic dataset sharding across processes, the port's copy of
dtdl_tpu/data/sharding.py (numpy only: the same indices for the same
seed, epoch and world): :class:`ShardedSampler`, :func:`scatter_arrays`,
:class:`GlobalBatchSampler`, :func:`elastic_global_batch` and
:func:`assert_no_overlap`.

Every process computes the same global permutation from (seed, epoch)
and takes its own contiguous stripe.  ``pad`` wraps indices so all
shards are equal (``DistributedSampler``'s behavior), ``drop`` truncates
to the largest even multiple.
"""

from __future__ import annotations

import numpy as np


class ShardedSampler:
    """Per-process view of a globally shuffled index space."""

    def __init__(self, num_examples: int, num_shards: int = 1,
                 shard_id: int = 0, shuffle: bool = True, seed: int = 0,
                 remainder: str = "pad"):
        if not 0 <= shard_id < num_shards:
            raise ValueError(f"shard_id {shard_id} not in [0, {num_shards})")
        if remainder not in ("pad", "drop"):
            raise ValueError("remainder must be 'pad' or 'drop'")
        self.num_examples = num_examples
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.shuffle = shuffle
        self.seed = seed
        self.remainder = remainder
        self.epoch = 0
        if remainder == "pad":
            self.shard_size = -(-num_examples // num_shards)
        else:
            self.shard_size = num_examples // num_shards

    def set_epoch(self, epoch: int) -> None:
        """Reshuffle deterministically per epoch."""
        self.epoch = epoch

    def global_permutation(self) -> np.ndarray:
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            perm = rng.permutation(self.num_examples)
        else:
            perm = np.arange(self.num_examples)
        total = self.shard_size * self.num_shards
        if self.remainder == "pad" and total > self.num_examples:
            perm = np.concatenate([perm, perm[: total - self.num_examples]])
        else:
            perm = perm[:total]
        return perm

    def indices(self) -> np.ndarray:
        """This shard's indices for the current epoch (contiguous stripe)."""
        perm = self.global_permutation()
        start = self.shard_id * self.shard_size
        return perm[start:start + self.shard_size]

    def __iter__(self):
        return iter(self.indices())

    def __len__(self) -> int:
        return self.shard_size


def scatter_arrays(arrays: dict, num_shards: int, shard_id: int,
                   shuffle: bool = True, seed: int = 0) -> dict:
    """Materialize this process's shard of a dict of arrays.

    Functional equivalent of ``chainermn.scatter_dataset(..., shuffle=True)``
    (reference chainer/train_mnist_multi.py:91-92) without the wire transfer:
    all hosts derive the same permutation, each keeps only its stripe.
    """
    n = len(next(iter(arrays.values())))
    sampler = ShardedSampler(n, num_shards, shard_id, shuffle=shuffle,
                             seed=seed, remainder="drop")
    idx = sampler.indices()
    return {k: v[idx] for k, v in arrays.items()}


class GlobalBatchSampler:
    """World-size-*agnostic* batch order for elastic training.

    :class:`ShardedSampler` partitions each epoch's permutation into
    per-worker stripes, so the sample→step mapping changes with the
    world size — a mid-epoch shrink would re-deal the remaining stream
    and silently drop or double-count samples.  This sampler removes
    world size from the *order*: global step ``i`` always consumes the
    same ``global_batch`` indices of the same per-epoch permutation
    (same ``(seed, epoch)`` derivation as :class:`ShardedSampler`),
    regardless of how many workers exist.  Workers take contiguous
    equal slices of each global batch (:meth:`shard`), so after a
    shrink the survivors re-slice the *identical* remaining stream:
    every global step's samples are consumed exactly once across the
    whole elastic timeline — zero lost, zero double-counted.

    ``global_batch`` must divide by every world size the run can shrink
    to; :meth:`check_world` enforces it by name at rendezvous time
    instead of letting a ragged split corrupt the stream later.
    """

    def __init__(self, num_examples: int, global_batch: int,
                 shuffle: bool = True, seed: int = 0):
        if global_batch < 1 or global_batch > num_examples:
            raise ValueError(
                f"global_batch {global_batch} not in [1, {num_examples}]")
        self.num_examples = num_examples
        self.global_batch = global_batch
        self.shuffle = shuffle
        self.seed = seed
        # drop-last semantics: a partial trailing batch would change
        # width across the epoch boundary and break the equal-slice rule
        self.batches_per_epoch = num_examples // global_batch
        self._perm_cache: tuple | None = None     # (epoch, permutation)

    def check_world(self, world_size: int) -> None:
        if world_size < 1 or self.global_batch % world_size:
            raise ValueError(
                f"global_batch {self.global_batch} does not divide over "
                f"a world of {world_size} worker(s) — pick a global "
                f"batch divisible by every world size the run may "
                f"shrink to")

    def batch_indices(self, step: int) -> np.ndarray:
        """The global batch consumed at global step ``step`` — a pure
        function of (seed, step), never of the world.

        The epoch permutation is cached (keyed by epoch), so the O(N)
        shuffle is paid once per epoch, not once per step — the hot
        loop's cost is the O(global_batch) slice.  The cache is one
        atomically-swapped (epoch, perm) tuple, so thread-hosted
        workers sharing a sampler can never read a torn pair (worst
        case across an epoch boundary is a redundant recompute of the
        same deterministic permutation)."""
        epoch, within = divmod(step, self.batches_per_epoch)
        cached = self._perm_cache
        if cached is None or cached[0] != epoch:
            if self.shuffle:
                rng = np.random.default_rng((self.seed, epoch))
                perm = rng.permutation(self.num_examples)
            else:
                perm = np.arange(self.num_examples)
            cached = (epoch, perm)
            self._perm_cache = cached
        start = within * self.global_batch
        return cached[1][start:start + self.global_batch]

    def shard(self, step: int, index: int, world_size: int) -> np.ndarray:
        """Worker ``index``-of-``world_size``'s slice of step ``step``'s
        global batch (contiguous, equal; the slices concatenate back to
        exactly :meth:`batch_indices`)."""
        self.check_world(world_size)
        if not 0 <= index < world_size:
            raise ValueError(f"index {index} not in [0, {world_size})")
        per = self.global_batch // world_size
        batch = self.batch_indices(step)
        return batch[index * per:(index + 1) * per]


def elastic_global_batch(max_world: int, per_worker: int = 1) -> int:
    """Smallest global batch divisible by EVERY world size the run can
    shrink to (1..max_world), scaled by ``per_worker`` — lcm(1..W), the
    divisibility :meth:`GlobalBatchSampler.check_world` demands."""
    lcm = 1
    for w in range(2, max_world + 1):
        lcm = lcm * w // np.gcd(lcm, w)
    return int(lcm) * per_worker


def assert_no_overlap(samplers) -> None:
    """Test helper: shards must partition the index space (no overlap)."""
    seen = set()
    for s in samplers:
        ix = set(int(i) for i in s.indices())
        if seen & ix and s.remainder == "drop":
            raise AssertionError("overlapping shards")
        seen |= ix
