"""Deterministic dataset sharding across processes, the port's copy of
dtdl_tpu/data/sharding.py:ShardedSampler (numpy only, the same indices
for the same seed and epoch).

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
