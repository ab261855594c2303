"""Checkpoint / resume, the port of dtdl_tpu/ckpt/checkpoint.py: the
reference's three checkpoint shapes.

1. **final-weights export**: ``save_weights`` / ``load_weights`` and
   ``Checkpointer.save_final`` (``final.pt``);
2. **per-epoch weights + restore-latest** (Keras ``ModelCheckpoint`` +
   ``tf.train.latest_checkpoint``): ``Checkpointer.save_weights_epoch`` /
   ``latest_weights`` (``weights_epoch_0003.pt``);
3. **full train-state snapshot with resume** (Chainer ``snapshot`` +
   ``--resume``): ``Checkpointer.save`` / ``restore`` of the whole
   :class:`~dtdl_tpu_torch.train.state.TrainState` (params, optimizer
   state, BatchNorm statistics, step; ``snapshot_12/state.pt``), or of
   any tree of tensors.

A weights file is ``torch.save`` of a flat ``{flax path: tensor}`` dict
(``"block_0/attn/q/kernel"``, ``"Conv_0/kernel"``: the names and layouts
of :func:`dtdl_tpu_torch.bridge.state_dict_to_flax`); a snapshot is
``torch.save`` of the nested tree of
:func:`dtdl_tpu_torch.train.state.state_to_tree` (flax paths and
layouts, each leaf in its own dtype).  Both are read back with
``torch.load(weights_only=True)``: tensors, ints, floats and ``None`` in
plain dicts, no pickled objects.  The JAX package writes flax msgpack
blobs and orbax snapshots; reading those is ROADMAP queue A8b.

Writes are **leader-gated** (process 0 writes, every process then meets
at a barrier) and **atomic** (a weights file and its manifest go to
``.tmp`` then rename; a snapshot is written into ``snapshot_N.tmp/`` and
renamed when complete).  **Snapshots save asynchronously**, as orbax's:
``save`` copies every tensor off the live state (into pinned host
buffers with non-blocking copies behind a CUDA event, or CPU clones)
and returns; a writer thread waits on the event and writes, never
touching the live tensors, so the steps after ``save`` cannot change
the snapshot.  ``wait_until_finished`` joins the writer and then writes
each durable snapshot's **commit marker** (``_DTDL_COMMIT``).

**Integrity**: ``<path>.manifest.json`` holds a weights file's byte
length and sha256, and a blob that disagrees with it raises
:class:`CheckpointCorruptError`; restore-latest **quarantines** a torn
entry (a weights file that fails its manifest or will not load; a
snapshot without its commit marker, in a directory that holds committed
ones, or that will not load) to ``<name>.corrupt`` and falls back to the
previous good one.  A valid checkpoint whose leaves do not fit the model
raises ``ValueError`` naming the leaf.  The torn-write windows are the
fault-injection sites ``ckpt.pre_rename`` and ``ckpt.pre_commit``
(:mod:`dtdl_tpu_torch.resil.faults`).
"""

from __future__ import annotations

import hashlib
import io
import json
import logging
import os
import re
import shutil
import threading

import numpy as np
import torch

from dtdl_tpu_torch.bridge import _nest, flatten
from dtdl_tpu_torch.resil.faults import fire as _fault
from dtdl_tpu_torch.runtime.bootstrap import barrier, is_leader

log = logging.getLogger("dtdl_tpu_torch")

# commit marker written inside a snapshot dir once it is durable; a dir
# without it is torn (the process died between the rename and here)
_COMMIT_MARKER = "_DTDL_COMMIT"
_SNAPSHOT_FILE = "state.pt"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint artifact is torn, truncated, or fails its checksum.

    Distinct from the architecture-mismatch ``ValueError`` (a *valid*
    checkpoint for a different model): corruption is quarantined and
    fallen back from; a mismatch is a caller error that must propagate."""

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


def _unflat(flat: dict, like) -> dict:
    """``flat`` in the shape of ``like`` (flat or nested)."""
    return flat if _flat(like).keys() == like.keys() else _nest(flat)


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
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
        _fault("ckpt.pre_rename")   # the torn-write window, injectable
        os.replace(tmp, path)
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
    return _unflat({k: restored[k] for k in want}, like)


def _dtype_name(x) -> str | None:
    dt = getattr(x, "dtype", None)
    if dt is None:
        return None
    return str(dt).replace("torch.", "") if isinstance(dt, torch.dtype) \
        else np.dtype(dt).name


def _validate_shapes(restored: dict, like: dict, origin: str) -> None:
    """Raise ``ValueError`` when the flat trees' paths, shapes or dtypes
    disagree (a ``None`` or int leaf must be one in both)."""
    missing = sorted(set(like) - set(restored))
    extra = sorted(set(restored) - set(like))
    if missing or extra:
        raise ValueError(
            f"checkpoint {origin} tree structure does not match the model: "
            f"missing {missing[:5]}, extra {extra[:5]}")
    bad = []
    for path, want in like.items():
        got = restored[path]
        if (want is None) != (got is None) or \
                hasattr(want, "shape") != hasattr(got, "shape"):
            bad.append(f"{path}: checkpoint {type(got).__name__} vs model "
                       f"{type(want).__name__}")
        elif want is None or not hasattr(want, "shape"):
            continue
        elif tuple(got.shape) != tuple(want.shape):
            bad.append(f"{path}: checkpoint {tuple(got.shape)} vs model "
                       f"{tuple(want.shape)}")
        elif _dtype_name(got) != _dtype_name(want):
            bad.append(f"{path}: checkpoint dtype {_dtype_name(got)} vs "
                       f"model {_dtype_name(want)}")
    if bad:
        raise ValueError(
            f"checkpoint {origin} does not match the model architecture "
            f"({len(bad)} mismatched leaves):\n  " + "\n  ".join(bad[:10]))


def _stage(tree):
    """A copy of every tensor of ``tree`` (flat) that no later step can
    change: CUDA tensors into pinned host buffers by non-blocking copies
    (returned with the CUDA event that completes them), CPU tensors and
    numpy arrays as CPU clones, other leaves as they are."""
    flat = _flat(tree)
    out, event = {}, None
    for k, v in flat.items():
        if isinstance(v, torch.Tensor):
            v = v.detach()
            if v.is_cuda:
                buf = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                buf.copy_(v, non_blocking=True)
                event = event or torch.cuda.Event()
            else:
                buf = v.clone(memory_format=torch.contiguous_format)
            out[k] = buf
        elif isinstance(v, np.ndarray):
            out[k] = torch.from_numpy(np.array(v))
        else:
            out[k] = v
    if event is not None:
        event.record()
    return out, event


def _place(got: dict, like: dict) -> dict:
    """Restored leaves placed as ``like``'s: a tensor on its device, a
    numpy array as numpy, other leaves as read."""
    out = {}
    for k, want in like.items():
        v = got[k]
        if isinstance(want, torch.Tensor):
            v = v.to(want.device)
        elif isinstance(want, np.ndarray):
            v = v.numpy()
        out[k] = v
    return out


class Checkpointer:
    """Directory-managed checkpoints: per-epoch weights + full-state
    snapshots.

    Layout under ``directory``::

        weights_epoch_0003.pt       (shape 2: per-epoch weights)
        snapshot_12/                (shape 3: the full state at step 12,
                                     with _DTDL_COMMIT once durable)
        snapshot_12.meta.json       (the Trainer's sidecar)
        final.pt                    (shape 1: final weights export)

    A context manager: ``with Checkpointer(...) as ck:`` flushes (every
    in-flight snapshot durable and committed) and closes on any exit,
    exceptions included.

    ``per_process=True`` makes every process the writer of its own
    ``directory`` (the 4D engine's shards, one directory a rank); the
    barriers stay, so every process still saves and restores together.
    """

    _WEIGHT_RE = re.compile(r"weights_epoch_(\d+)\.pt$")
    _SNAP_RE = re.compile(r"snapshot_(\d+)$")

    def __init__(self, directory: str, keep: int | None = None,
                 per_process: bool = False):
        self.directory = directory
        self.keep = keep
        self._writes = per_process or is_leader()
        self._last_saved_step = None   # protected from gc until superseded
        # rollback detection: _supersede (deleting entries ABOVE a save)
        # only after this run restored from THIS directory's timeline, and
        # tracked per checkpoint shape (see _supersede)
        self._restored_snapshot = False
        self._restored_weights = False
        # steps saved async whose commit marker is not yet written
        self._pending_commit: set[int] = set()
        self._writer: threading.Thread | None = None
        self._write_error: BaseException | None = None
        if self._writes:
            os.makedirs(directory, exist_ok=True)
        barrier("ckpt_mkdir")

    def __enter__(self) -> "Checkpointer":
        return self

    def __exit__(self, *exc) -> bool:
        try:
            self.wait_until_finished()
        finally:
            self.close()
        return False

    # -- the writer -----------------------------------------------------------

    def _join(self) -> None:
        """Wait for the in-flight snapshot write; re-raise its error."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        err, self._write_error = self._write_error, None
        if err is not None:
            raise RuntimeError(f"snapshot write failed: {err}") from err

    def _write(self, path: str, flat: dict, event) -> None:
        try:
            if event is not None:
                event.synchronize()
            tmp = path + ".tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            with open(os.path.join(tmp, _SNAPSHOT_FILE), "wb") as f:
                torch.save(_nest(flat), f)
                f.flush()
                os.fsync(f.fileno())
            if os.path.isdir(path):      # a re-save of this step
                shutil.rmtree(path)
            os.replace(tmp, path)
        except Exception as e:           # re-raised by _join
            self._write_error = e

    def wait_until_finished(self) -> None:
        """Block until every in-flight snapshot is durable and committed,
        then trim to ``keep``; the last-saved step stays protected (a
        rollback re-save of an old step must not be deleted the moment it
        lands).  Trimming happens only when this process saved
        something."""
        self._join()
        self._commit_pending()
        if self._last_saved_step is not None:
            self._gc(self._SNAP_RE, "snapshot_{}",
                     protect=self._last_saved_step)

    def _commit_pending(self) -> None:
        """Write the commit marker of every now-durable snapshot, the last
        (and injectable, ``ckpt.pre_commit``) step of a save; every
        process then passes a barrier before any of them can list or
        restore."""
        if not self._pending_commit:
            return
        for step in sorted(self._pending_commit):
            path = os.path.join(self.directory, f"snapshot_{step}")
            if self._writes and os.path.isdir(path):
                _fault("ckpt.pre_commit")   # torn-finalize window
                marker = os.path.join(path, _COMMIT_MARKER)
                tmp = marker + ".tmp"
                with open(tmp, "w") as f:
                    json.dump({"step": step}, f)
                os.replace(tmp, marker)
        self._pending_commit.clear()
        barrier("ckpt_commit")

    def close(self) -> None:
        """Join the writer (no commit: a snapshot not flushed by
        ``wait_until_finished`` stays uncommitted)."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None

    # -- shape 2: per-epoch weights ------------------------------------------

    def _quarantine(self, victim: str, err: Exception) -> None:
        """Move a corrupt artifact out of the regexes' sight
        (``<name>.corrupt``), keeping it for inspection; leader-gated."""
        log.warning("quarantining corrupt checkpoint %s: %s", victim, err)
        if not self._writes:
            return
        for src in (victim, victim + ".manifest.json"):
            if os.path.exists(src):
                try:
                    os.replace(src, src + ".corrupt")
                except OSError:   # never let cleanup mask the fallback
                    pass

    def save_weights_epoch(self, epoch: int, params) -> str:
        path = os.path.join(self.directory, f"weights_epoch_{epoch:04d}.pt")
        save_weights(path, params)
        if self._restored_weights:
            self._supersede(self._WEIGHT_RE, "weights_epoch_{:04d}.pt", epoch)
        self._gc(self._WEIGHT_RE, "weights_epoch_{:04d}.pt", protect=epoch)
        return path

    def latest_weights(self, like):
        """Restore-latest: ``(weights, epoch)``, or ``(None, None)``.  A
        torn epoch file is quarantined and the next-older one tried; an
        architecture mismatch (``ValueError``) propagates."""
        for epoch in sorted(self._list(self._WEIGHT_RE), reverse=True):
            path = os.path.join(self.directory,
                                f"weights_epoch_{epoch:04d}.pt")
            try:
                restored = load_weights(path, like)
            except CheckpointCorruptError as e:
                self._quarantine(path, e)
                continue
            except FileNotFoundError:
                # multi-process race: the leader quarantined this epoch
                # between our listing and the open
                continue
            self._restored_weights = True
            return restored, epoch
        return None, None

    # -- shape 3: full train-state snapshot ------------------------------------

    def save(self, step: int, state, wait: bool = False) -> str:
        """Snapshot ``state`` (a TrainState, or a tree of tensors / numpy
        arrays / ints) as step ``step``.

        **Asynchronous**: returns once every tensor is copied off the
        live state (a previous write in flight is joined first); the
        write overlaps the next steps, and the commit marker lands at
        :meth:`wait_until_finished` (``wait=True`` calls it)."""
        path = os.path.abspath(
            os.path.join(self.directory, f"snapshot_{step}"))
        # train/ imports this module (fit, trainer): import its state here
        from dtdl_tpu_torch.train.state import TrainState, state_to_tree
        self._join()
        writer = None
        if self._writes:
            tree = state_to_tree(state) if isinstance(state, TrainState) \
                else state
            flat, event = _stage(tree)
            writer = threading.Thread(
                target=self._write, args=(path, flat, event),
                name=f"ckpt-snapshot-{step}", daemon=True)
        self._last_saved_step = step
        self._pending_commit.add(step)
        # a save below existing ids after this run restored from this
        # directory is a rollback: the higher ids are a stale future
        if self._restored_snapshot:
            self._supersede(self._SNAP_RE, "snapshot_{}", step)
        # trimmed over the durable snapshots before the write starts, so
        # `keep` durable ones stay through the write window however fast
        # the writer renames; the excess goes at wait_until_finished
        self._gc(self._SNAP_RE, "snapshot_{}", protect=step)
        if writer is not None:
            self._writer = writer
            writer.start()
        if wait:
            self.wait_until_finished()
        return path

    def _read(self, path: str) -> dict:
        f = os.path.join(path, _SNAPSHOT_FILE)
        if not os.path.isfile(f):
            raise CheckpointCorruptError(path, None,
                                         f"no {_SNAPSHOT_FILE} inside")
        try:
            return torch.load(f, map_location="cpu", weights_only=True)
        except Exception as e:
            raise CheckpointCorruptError(
                path, os.path.getsize(f), f"{type(e).__name__}: {e}") from e

    def _apply(self, like, tree: dict, origin: str):
        """Validate ``tree`` against ``like`` and return the restored
        state: a TrainState loaded in place, or a new tree placed as
        ``like``'s leaves."""
        from dtdl_tpu_torch.train.state import (TrainState, load_state_tree,
                                                state_to_tree)
        if not isinstance(tree, dict):
            raise CheckpointCorruptError(origin, None, "not a tree of tensors")
        got = flatten(tree)
        if isinstance(like, TrainState):
            _validate_shapes(got, flatten(state_to_tree(like)), origin)
            return load_state_tree(like, tree)
        want = _flat(like)
        _validate_shapes(got, want, origin)
        return _unflat(_place(got, want), like)

    def restore(self, like, step: int | None = None):
        """Restore the latest (or given-step) snapshot into ``like``'s
        shape; ``(state, step)``, or ``(None, None)`` without a snapshot.

        Restore-latest walks the snapshots newest first, quarantining any
        torn one (no commit marker, or unreadable) and falling back to
        the previous.  The marker is required only in a marker-aware
        directory (one with at least one committed snapshot): a legacy
        directory with no markers restores normally.  An explicit
        ``step=`` raises :class:`CheckpointCorruptError` instead; an
        architecture mismatch (``ValueError``) always propagates."""
        self.wait_until_finished()
        steps = self._list(self._SNAP_RE)
        if not steps:
            return None, None
        require_marker = any(self._committed(s) for s in steps)
        if step is not None:
            return self._restore_step(like, step, require_marker)
        for s in sorted(steps, reverse=True):
            try:
                return self._restore_step(like, s, require_marker)
            except CheckpointCorruptError as e:
                self._quarantine(os.path.join(self.directory,
                                              f"snapshot_{s}"), e)
        return None, None

    def _committed(self, step: int) -> bool:
        return os.path.exists(os.path.join(
            self.directory, f"snapshot_{step}", _COMMIT_MARKER))

    def _restore_step(self, like, step: int, require_marker: bool = True):
        path = os.path.abspath(
            os.path.join(self.directory, f"snapshot_{step}"))
        if not os.path.isdir(path):
            raise CheckpointCorruptError(path, None, "snapshot missing")
        if require_marker and not self._committed(step):
            raise CheckpointCorruptError(
                path, None, "no commit marker — the writing process died "
                "before the snapshot was finalized (torn write)")
        restored = self._apply(like, self._read(path), path)
        self._restored_snapshot = True
        return restored, step

    def latest_step(self) -> int | None:
        """Step of the newest COMMITTED snapshot (a legacy marker-less
        directory reports its newest), ``None`` without one."""
        self.wait_until_finished()
        steps = self._list(self._SNAP_RE)
        committed = [s for s in steps if self._committed(s)]
        if committed:
            return max(committed)
        return max(steps) if steps else None

    def restore_path(self, like, path: str):
        """Restore from an explicit snapshot path (``--resume <path>``):
        no commit-marker requirement, read failures as the named
        :class:`CheckpointCorruptError`."""
        self.wait_until_finished()
        abspath = os.path.abspath(path.rstrip("/"))
        restored = self._apply(like, self._read(abspath), abspath)
        # only a snapshot of THIS directory makes a later low save a
        # rollback of its timeline
        if (os.path.dirname(abspath) == os.path.abspath(self.directory)
                and self._SNAP_RE.search(os.path.basename(abspath))):
            self._restored_snapshot = True
        return restored

    # -- shape 1: final weights ----------------------------------------------

    def save_final(self, params) -> str:
        return save_weights(os.path.join(self.directory, "final.pt"), params)

    # -- housekeeping ---------------------------------------------------------

    def _list(self, regex) -> list[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(m.group(1)) for m in map(
            regex.search, os.listdir(self.directory)) if m)

    def _gc(self, regex, fmt, protect: int | None = None) -> None:
        """Remove all but the ``keep`` newest entries; ``protect`` (the id
        just saved) is never a victim."""
        if self.keep is None or not self._writes:
            return
        for old in self._list(regex)[:-self.keep]:
            if old != protect:
                self._delete(fmt, old)

    def _supersede(self, regex, fmt, just_saved: int) -> None:
        """Delete every durable entry with an id ABOVE ``just_saved``: the
        stale future of a timeline abandoned by a rollback restore.
        Callers gate it on having restored this shape from THIS
        directory: a fresh run saving low ids into an existing directory,
        or one warm-started from another directory, is not a rollback."""
        if not self._writes:
            return
        for old in self._list(regex):
            if old > just_saved:
                self._delete(fmt, old)

    def _delete(self, fmt, entry_id: int) -> None:
        victim = os.path.join(self.directory, fmt.format(entry_id))
        if os.path.isdir(victim):
            shutil.rmtree(victim)
        elif os.path.exists(victim):
            os.remove(victim)
        for side in (victim + ".meta.json", _manifest_path(victim)):
            if os.path.exists(side):
                os.remove(side)
