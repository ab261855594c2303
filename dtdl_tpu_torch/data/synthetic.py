"""Deterministic synthetic datasets, the port's copy of
dtdl_tpu/data/synthetic.py (numpy only, the same arrays for the same
seed): the stand-ins for MNIST and CIFAR-10 when their files are absent,
and the LM's token data.

Both are learnable.  An image is its class's fixed pattern plus noise, so
a classifier can reach high train accuracy; in the Markov chain each
token has only ``branch`` plausible successors, so a trained LM's cross
entropy approaches log(branch) < log(vocab).
"""

from __future__ import annotations

import numpy as np


def class_pattern_images(n: int, shape: tuple[int, ...], num_classes: int,
                         seed: int, noise: float = 0.25,
                         noise_seed: int | None = None,
                         keep: int | None = None):
    """Images = a fixed per-class pattern + gaussian noise, squashed into
    [0, 1]; labels balanced.  ``seed`` fixes the patterns (the task),
    ``noise_seed`` the draw: a dataset's train and test splits share
    ``seed`` and differ in ``noise_seed``.  ``keep`` makes only the first
    ``keep`` of the ``n`` examples, the same values as the whole set's
    (the labels are shuffled over all ``n``; the noise is drawn in order,
    so a shorter draw is the longer one's prefix)."""
    patterns = np.random.default_rng(seed).normal(
        size=(num_classes,) + shape).astype(np.float32)
    rng = np.random.default_rng(seed if noise_seed is None else noise_seed)
    labels = np.arange(n, dtype=np.int32) % num_classes
    rng.shuffle(labels)
    if keep is not None:
        labels = labels[:min(keep, n)]
    images = patterns[labels] + noise * rng.normal(
        size=(len(labels),) + shape).astype(np.float32)
    images = 1.0 / (1.0 + np.exp(-images))
    return images.astype(np.float32), labels


def synthetic_mnist(n_train: int = 60000, n_test: int = 10000,
                    seed: int = 1234):
    tr = class_pattern_images(n_train, (28, 28, 1), 10, seed,
                              noise_seed=seed + 10)
    te = class_pattern_images(n_test, (28, 28, 1), 10, seed,
                              noise_seed=seed + 11)
    return tr, te


def synthetic_cifar10(n_train: int = 50000, n_test: int = 10000,
                      seed: int = 4321, keep_train: int | None = None,
                      keep_test: int | None = None):
    """``keep_train``/``keep_test``: only the splits' first examples, the
    same values as the whole splits' (see :func:`class_pattern_images`)."""
    tr = class_pattern_images(n_train, (32, 32, 3), 10, seed,
                              noise_seed=seed + 10, keep=keep_train)
    te = class_pattern_images(n_test, (32, 32, 3), 10, seed,
                              noise_seed=seed + 11, keep=keep_test)
    return tr, te


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
