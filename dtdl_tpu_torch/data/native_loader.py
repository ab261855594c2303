"""NativeDataLoader: the C++ producer/consumer batch pipeline behind the
port's loader protocol, the port of dtdl_tpu/data/native_loader.py.

Shuffle, pad-4 crop/flip augmentation and normalization run in C++ worker
threads (dtdl_tpu_torch/native/src/dtdl_native.cpp) into a bounded queue,
so the Python step loop only copies ready batches; each batch then goes
to the device through :func:`~dtdl_tpu_torch.device.upload` (pinned
staging, a non-blocking copy), as :class:`~dtdl_tpu_torch.data.loader.
DataLoader`'s do.  The device is the card unless the caller asks for
``device="cpu"``.

``NativeDataLoader.or_python(...)`` is the documented fallback of this
API: the Python loader, with the same sampler and the reference's
transforms, when the native toolchain is unavailable.
"""

from __future__ import annotations

import ctypes

import numpy as np

from dtdl_tpu_torch import native
from dtdl_tpu_torch.data.loader import (DataLoader, cifar10_train_transform,
                                        normalize_transform)
from dtdl_tpu_torch.device import resolve_device, upload

SHUFFLE = 1
AUGMENT_CROP_FLIP = 2
NORMALIZE = 4


class NativeDataLoader:
    """Iterates dict batches ``{'image': f32 [B, H, W, C], 'label': i32
    [B]}`` of tensors on ``device``.

    Batch content depends only on (seed, epoch, batch index), never on
    the worker threads' timing.  With a ``sampler`` (a
    :class:`~dtdl_tpu_torch.data.sharding.ShardedSampler`) every epoch
    feeds this process's stripe of a globally reshuffled permutation and
    the C++ side only augments and batches; without one it shuffles the
    whole local array itself."""

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 batch_size: int, shuffle: bool = True, seed: int = 0,
                 augment: bool = False, mean=None, std=None,
                 depth: int = 4, n_threads: int = 4, sampler=None,
                 device=None):
        lib = native.load()
        if lib is None:
            raise RuntimeError("native library unavailable; use "
                               "NativeDataLoader.or_python(...)")
        self._lib = lib
        self.device = resolve_device(device)
        if images.ndim == 2:   # flattened features -> [N, F, 1, 1]
            images = images[:, :, None, None]
        if images.ndim == 3:
            images = images[..., None]
        # own C-contiguous copies; the C side borrows these pointers
        self._images = np.ascontiguousarray(images, np.float32)
        self._labels = np.ascontiguousarray(labels, np.int32)
        n, h, w, c = self._images.shape
        self.batch_size = batch_size
        self._shape = (h, w, c)
        flags = (SHUFFLE if shuffle else 0) | \
                (AUGMENT_CROP_FLIP if augment else 0) | \
                (NORMALIZE if mean is not None else 0)
        mean_arr = np.ascontiguousarray(
            np.broadcast_to(np.asarray(
                mean if mean is not None else 0.0, np.float32), (c,)))
        std_arr = np.ascontiguousarray(
            np.broadcast_to(np.asarray(
                std if std is not None else 1.0, np.float32), (c,)))
        self._keepalive = (mean_arr, std_arr)
        self._h = lib.dtdl_loader_create(
            self._images.ctypes.data_as(ctypes.c_void_p),
            self._labels.ctypes.data_as(ctypes.c_void_p),
            n, h, w, c, batch_size, depth, n_threads, flags, seed,
            mean_arr.ctypes.data_as(ctypes.c_void_p),
            std_arr.ctypes.data_as(ctypes.c_void_p))
        if not self._h:
            raise RuntimeError("dtdl_loader_create failed")
        self._epoch = 0
        self._n = n
        self._sampler = sampler

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch
        if self._sampler is not None:
            self._sampler.set_epoch(epoch)

    def __len__(self) -> int:
        if self._sampler is not None:
            return len(self._sampler) // self.batch_size
        return self._n // self.batch_size

    def __iter__(self):
        lib, h = self._lib, self._h
        if self._sampler is not None:
            idx = np.ascontiguousarray(self._sampler.indices(), np.int64)
            if idx.size and (idx.min() < 0 or idx.max() >= self._n):
                raise RuntimeError(
                    f"sampler index out of range [0, {self._n})")
            rc = lib.dtdl_loader_start_epoch_indices(
                h, self._epoch, idx.ctypes.data_as(ctypes.c_void_p), len(idx))
            if rc != 0:
                raise RuntimeError("dtdl_loader_start_epoch_indices failed")
        else:
            lib.dtdl_loader_start_epoch(h, self._epoch)
        hh, w, c = self._shape
        img = np.empty((self.batch_size, hh, w, c), np.float32)
        lab = np.empty((self.batch_size,), np.int32)
        # the staging arrays are refilled per batch: a CPU tensor would
        # alias them, while the card's upload copies into pinned memory
        own = self.device.type == "cpu"
        while lib.dtdl_loader_next(
                h, img.ctypes.data_as(ctypes.c_void_p),
                lab.ctypes.data_as(ctypes.c_void_p)):
            yield {"image": upload(img.copy() if own else img, self.device),
                   "label": upload(lab.copy() if own else lab, self.device)}

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.dtdl_loader_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    @staticmethod
    def or_python(images, labels, batch_size, shuffle=True, seed=0,
                  augment=False, mean=None, std=None, sampler=None,
                  device=None, **kw):
        """The native pipeline when it builds, the Python
        :class:`DataLoader` otherwise.  Both honour ``sampler``, so the
        choice of loader never changes which examples a process trains
        on."""
        if native.available():
            try:
                return NativeDataLoader(images, labels, batch_size,
                                        shuffle=shuffle, seed=seed,
                                        augment=augment, mean=mean, std=std,
                                        sampler=sampler, device=device, **kw)
            except RuntimeError:
                pass
        transform = None
        if augment and mean is not None:
            transform = cifar10_train_transform(mean, std)
        elif mean is not None:
            transform = normalize_transform(mean, std)
        return DataLoader({"image": np.asarray(images, np.float32),
                           "label": np.asarray(labels, np.int32)},
                          batch_size, shuffle=shuffle, seed=seed,
                          transform=transform, sampler=sampler,
                          device=device)


def read_idx_native(path: str):
    """IDX(.gz) reader through the native zlib path; None if unavailable.

    Returns images as float32 scaled to [0, 1] (u8 payloads) or labels
    int32, as numpy arrays."""
    lib = native.load()
    if lib is None:
        return None
    is_gz = 1 if path.endswith(".gz") else 0
    dims = (ctypes.c_int64 * 4)()
    ndim = lib.dtdl_idx_header(path.encode(), is_gz, dims)
    if ndim < 0:
        return None
    shape = tuple(int(dims[i]) for i in range(ndim))
    count = int(np.prod(shape))
    if ndim == 1:   # labels
        out = np.empty(shape, np.int32)
        rc = lib.dtdl_idx_read_i32(path.encode(), is_gz,
                                   out.ctypes.data_as(ctypes.c_void_p), count)
    else:
        out = np.empty(shape, np.float32)
        rc = lib.dtdl_idx_read_f32(path.encode(), is_gz,
                                   out.ctypes.data_as(ctypes.c_void_p),
                                   count, 1.0 / 255.0)
    return out if rc == 0 else None
