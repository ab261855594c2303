"""Deterministic seeding, the port of dtdl_tpu/utils/random.py.

One call fans a root seed out to Python's ``random``, numpy and torch and
returns a root :class:`torch.Generator` (the JAX module returns a PRNG
key); :func:`host_rng` derives a per-process generator from it, as the
JAX one folds the process index into the key.
"""

from __future__ import annotations

import random as _pyrandom

import numpy as np
import torch


def seed_everything(seed: int) -> torch.Generator:
    """Seed python/numpy/torch RNGs and return a root CPU generator."""
    _pyrandom.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def host_rng(gen: torch.Generator,
             process_index: int | None = None) -> torch.Generator:
    """A per-process generator (host-local shuffling, augmentation),
    independent across processes and a pure function of (the root seed,
    ``process_index``; default: this process's rank)."""
    if process_index is None:
        from dtdl_tpu_torch.runtime.bootstrap import process_index as rank
        process_index = rank()
    seed = np.random.SeedSequence(
        [gen.initial_seed(), process_index]).generate_state(2, np.uint64)
    return torch.Generator().manual_seed(int(seed[0] >> np.uint64(1)))
