"""Final-weights checkpoints, the port of the first half of
dtdl_tpu/ckpt/checkpoint.py: ``save_weights`` / ``load_weights`` and
``Checkpointer(directory).save_final``.

A weights file is ``torch.save`` of a flat ``{flax path: tensor}`` dict
(``"block_0/attn/q/kernel"``, ``"Conv_0/kernel"``: the names and layouts
of :func:`dtdl_tpu_torch.bridge.state_dict_to_flax`, flattened by
:func:`dtdl_tpu_torch.bridge.flatten`), read back with
``torch.load(weights_only=True)``.  The JAX package writes flax msgpack
blobs; reading those here, and the snapshot half (``save`` /
``restore`` of the whole train state, its commit marker,
``save_weights_epoch``, ``latest_weights``), are ROADMAP queue A8b.

Writes are **leader-gated** (process 0 writes, every process then meets
at a barrier), **atomic** (``.tmp`` then rename, for the blob and for its
manifest) and **checksummed**: ``<path>.manifest.json`` holds the byte
length and sha256, and a blob that disagrees with it raises
:class:`CheckpointCorruptError`; a valid file whose leaves do not fit
the model raises ``ValueError``.
"""

from __future__ import annotations

import hashlib
import io
import json
import os

import numpy as np
import torch

from dtdl_tpu_torch.bridge import _nest, flatten
from dtdl_tpu_torch.runtime.bootstrap import barrier, is_leader


class CheckpointCorruptError(RuntimeError):
    """A checkpoint artifact is torn, truncated, or fails its checksum.

    Distinct from the architecture-mismatch ``ValueError`` (a *valid*
    checkpoint for a different model)."""

    def __init__(self, path: str, nbytes: int | None, reason: str):
        self.path = path
        self.nbytes = nbytes
        size = "unknown size" if nbytes is None else f"{nbytes} bytes"
        super().__init__(f"corrupt checkpoint {path} ({size}): {reason}")


def _manifest_path(path: str) -> str:
    return path + ".manifest.json"


def _flat(tree) -> dict:
    return flatten(tree) if any(isinstance(v, dict) for v in tree.values()) \
        else dict(tree)


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().contiguous()
    return torch.from_numpy(np.ascontiguousarray(x))


def _atomic_write(path: str, data: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def save_weights(path: str, tree) -> str:
    """Write a weights tree (nested or flat dicts of tensors or numpy
    arrays under flax paths) as ``torch.save`` of its flat dict, on the
    leader only; every process returns after the write."""
    if is_leader():
        buf = io.BytesIO()
        torch.save({k: _tensor(v) for k, v in _flat(tree).items()}, buf)
        blob = buf.getvalue()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        _atomic_write(path, blob)
        manifest = {"bytes": len(blob),
                    "sha256": hashlib.sha256(blob).hexdigest()}
        _atomic_write(_manifest_path(path), json.dumps(manifest).encode())
    barrier("save_weights")
    return path


def load_weights(path: str, like):
    """The weights at ``path`` in the structure of ``like`` (nested or
    flat dicts; CPU tensors as leaves).

    **Integrity-checked**: when the manifest exists, the blob's byte
    length and sha256 must match it, and a blob ``torch.load`` cannot
    read raises :class:`CheckpointCorruptError` naming the path and byte
    length.  **Shape-validated**: a missing or extra leaf, or a leaf of
    another shape or dtype than ``like``'s, raises ``ValueError``."""
    with open(path, "rb") as f:
        blob = f.read()
    mpath = _manifest_path(path)
    if os.path.exists(mpath):
        with open(mpath) as f:
            manifest = json.load(f)
        if len(blob) != manifest.get("bytes"):
            raise CheckpointCorruptError(
                path, len(blob),
                f"manifest says {manifest.get('bytes')} bytes — truncated "
                f"or torn write")
        if hashlib.sha256(blob).hexdigest() != manifest.get("sha256"):
            raise CheckpointCorruptError(
                path, len(blob), "sha256 mismatch against manifest")
    try:
        restored = torch.load(io.BytesIO(blob), weights_only=True)
    except Exception as e:
        raise CheckpointCorruptError(
            path, len(blob), f"{type(e).__name__}: {e}") from e
    if not isinstance(restored, dict):
        raise CheckpointCorruptError(path, len(blob),
                                     "not a flat {path: tensor} dict")
    want = _flat(like)
    _validate_shapes(restored, want, path)
    out = {k: restored[k] for k in want}
    return out if want.keys() == like.keys() else _nest(out)


def _dtype_name(x) -> str | None:
    dt = getattr(x, "dtype", None)
    if dt is None:
        return None
    return str(dt).replace("torch.", "") if isinstance(dt, torch.dtype) \
        else np.dtype(dt).name


def _validate_shapes(restored: dict, like: dict, origin: str) -> None:
    """Raise ``ValueError`` when the leaves' paths, shapes or dtypes
    disagree with ``like``'s."""
    missing = sorted(set(like) - set(restored))
    extra = sorted(set(restored) - set(like))
    if missing or extra:
        raise ValueError(
            f"checkpoint {origin} tree structure does not match the model: "
            f"missing {missing[:5]}, extra {extra[:5]}")
    bad = []
    for path, want in like.items():
        got = restored[path]
        if tuple(got.shape) != tuple(np.shape(want)):
            bad.append(f"{path}: checkpoint {tuple(got.shape)} vs model "
                       f"{tuple(np.shape(want))}")
        elif _dtype_name(want) and _dtype_name(got) != _dtype_name(want):
            bad.append(f"{path}: checkpoint dtype {_dtype_name(got)} vs "
                       f"model {_dtype_name(want)}")
    if bad:
        raise ValueError(
            f"checkpoint {origin} does not match the model architecture "
            f"({len(bad)} mismatched leaves):\n  " + "\n  ".join(bad[:10]))


class Checkpointer:
    """Directory-managed checkpoints; the port writes the final weights
    (``final.pt``) and refuses the snapshot half by name."""

    def __init__(self, directory: str):
        self.directory = directory
        if is_leader():
            os.makedirs(directory, exist_ok=True)
        barrier("ckpt_mkdir")

    def save_final(self, params) -> str:
        return save_weights(os.path.join(self.directory, "final.pt"), params)

    def _snapshot(self, *args, **kwargs):
        raise NotImplementedError(
            "train-state snapshots (save/restore, per-epoch weights, "
            "restore-latest) are ROADMAP queue A8b")

    save = restore = save_weights_epoch = latest_weights = _snapshot
