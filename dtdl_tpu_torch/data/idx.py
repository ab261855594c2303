"""IDX (MNIST) file parser, the port's copy of dtdl_tpu/data/idx.py
(numpy only): one ``np.frombuffer`` over the payload, and parse-once npz
caching."""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

_IDX_DTYPES = {
    0x08: np.uint8, 0x09: np.int8, 0x0B: np.dtype(">i2"),
    0x0C: np.dtype(">i4"), 0x0D: np.dtype(">f4"), 0x0E: np.dtype(">f8"),
}


def read_idx(path: str) -> np.ndarray:
    """Parse one IDX file (optionally gzipped) into a numpy array."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        zero, dtype_code, ndim = struct.unpack(">HBB", f.read(4))
        if zero != 0 or dtype_code not in _IDX_DTYPES:
            raise ValueError(f"{path}: not an IDX file (magic {zero:#x} "
                             f"dtype {dtype_code:#x})")
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=_IDX_DTYPES[dtype_code])
    if data.size != int(np.prod(shape)):
        raise ValueError(f"{path}: payload {data.size} != shape {shape}")
    return data.reshape(shape)


def load_idx_pair(images_path: str, labels_path: str):
    """Load an (images, labels) IDX pair, validated to match in length."""
    images = read_idx(images_path)
    labels = read_idx(labels_path)
    if images.shape[0] != labels.shape[0]:
        raise ValueError(
            f"images {images.shape[0]} != labels {labels.shape[0]}")
    return images, labels.astype(np.int32)


def cache_npz(cache_path: str, maker) -> dict:
    """The arrays in ``cache_path`` if it exists, else ``maker()``'s,
    written there first (atomically, through a temporary file)."""
    if os.path.exists(cache_path):
        with np.load(cache_path) as z:
            return dict(z)
    arrays = maker()
    os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
    np.savez_compressed(cache_path + ".tmp.npz", **arrays)
    os.replace(cache_path + ".tmp.npz", cache_path)
    return arrays
