"""Deterministic synthetic token data, the port's copy of the LM part of
dtdl_tpu/data/synthetic.py (numpy only, the same arrays for the same
seed).

The Markov chain is learnable: each token has only ``branch`` plausible
successors, so a trained LM's cross entropy approaches log(branch) <
log(vocab).
"""

from __future__ import annotations

import numpy as np


def markov_tokens(n_seqs: int, seq_len: int, vocab_size: int = 256,
                  seed: int = 7, branch: int = 4,
                  noise_seed: int | None = None):
    """Token sequences [n_seqs, seq_len] int32 from a sparse first-order
    Markov chain whose successor table is fixed by ``seed``; the draws
    come from ``noise_seed`` (``seed`` when None)."""
    chain_rng = np.random.default_rng(seed)
    successors = chain_rng.integers(
        0, vocab_size, size=(vocab_size, branch)).astype(np.int32)
    rng = np.random.default_rng(seed if noise_seed is None else noise_seed)
    tokens = np.empty((n_seqs, seq_len), np.int32)
    tokens[:, 0] = rng.integers(0, vocab_size, n_seqs)
    choices = rng.integers(0, branch, size=(n_seqs, seq_len))
    for t in range(1, seq_len):
        tokens[:, t] = successors[tokens[:, t - 1], choices[:, t]]
    return tokens


def synthetic_lm(n_train: int = 4096, n_test: int = 512, seq_len: int = 128,
                 vocab_size: int = 256, seed: int = 7):
    """(train, test) token arrays of one chain, with different draws."""
    tr = markov_tokens(n_train, seq_len, vocab_size, seed, noise_seed=seed + 10)
    te = markov_tokens(n_test, seq_len, vocab_size, seed, noise_seed=seed + 11)
    return tr, te
