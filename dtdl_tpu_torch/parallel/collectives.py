"""Collectives over a :class:`~dtdl_tpu_torch.runtime.mesh.Mesh`, the port
of dtdl_tpu/parallel/collectives.py.

The JAX helpers emit XLA collectives inside a ``shard_map``ped step and
name a mesh axis; these run ``torch.distributed`` collectives eagerly in
the mesh's process group (NCCL on the card, gloo on the CPU or when
asked for by name), and on a one-replica mesh they are identities.  A
tree is a tensor or nested dicts/lists/tuples of tensors.

``grad_sync`` flattens a gradient set into buckets (``bucket_bytes``,
25 MiB as torch DDP's default) and mean-allreduces each bucket in one
call, as the reference's DDP does from its gradient hooks; it runs after
the backward, not overlapped with it.

JAX's ``localize`` casts replicated parameters to per-replica varying
values inside ``shard_map`` so that their gradients stay per-replica;
eager autograd gives per-process gradients already, and the port's
``localize`` is an identity.  ``pvary_like`` (shard_map's varying-axis
typing of scan carries) has no counterpart.

Host-level helpers run over the world's gloo host group:
``host_broadcast``, ``assert_same_across_hosts``, ``host_max``.
"""

from __future__ import annotations

import hashlib
import pickle

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_unflatten

from dtdl_tpu_torch.runtime.bootstrap import (host_group, process_count,
                                              process_index)
from dtdl_tpu_torch.runtime.mesh import Mesh, build_mesh

BUCKET_BYTES = 25 << 20


def _mesh(mesh: Mesh | None) -> Mesh:
    return build_mesh() if mesh is None else mesh


def _buckets(tensors, cap: int):
    """Consecutive runs of same-dtype, same-device tensors of at most
    ``cap`` bytes (a larger tensor is a bucket of its own)."""
    groups: dict = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for ts in groups.values():
        cur, size = [], 0
        for t in ts:
            nbytes = t.numel() * t.element_size()
            if cur and size + nbytes > cap:
                yield cur
                cur, size = [], 0
            cur.append(t)
            size += nbytes
        if cur:
            yield cur


def _bucketed_(tensors, run, cap: int) -> None:
    """``run(flat)`` on each bucket flattened into one buffer, in place,
    the results copied back into ``tensors``."""
    for bucket in _buckets(tensors, cap):
        if len(bucket) == 1 and bucket[0].is_contiguous():
            run(bucket[0].view(-1))
            continue
        flat = torch.cat([t.reshape(-1) for t in bucket])
        run(flat)
        offset = 0
        for t in bucket:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def reduce_(tensors, mesh: Mesh | None = None, mean: bool = False,
            bucket_bytes: int = BUCKET_BYTES) -> None:
    """Sum- (or mean-) allreduce ``tensors`` in place, bucketed."""
    mesh = _mesh(mesh)
    if mesh.group is None:
        return
    n = mesh.size

    def run(flat):
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
        if mean:
            flat.div_(n)

    _bucketed_(list(tensors), run, bucket_bytes)


def broadcast_(tensors, root: int = 0, mesh: Mesh | None = None,
               bucket_bytes: int = BUCKET_BYTES) -> None:
    """Overwrite ``tensors`` with replica ``root``'s, in place, bucketed."""
    mesh = _mesh(mesh)
    if mesh.group is None:
        return
    src = mesh.ranks[root]
    _bucketed_(list(tensors),
               lambda flat: dist.broadcast(flat, src=src, group=mesh.group),
               bucket_bytes)


def localize(tree, mesh: Mesh | None = None):
    """Identity: eager gradients are per-process already (see the module
    docstring)."""
    return tree


def grad_sync(grads, mesh: Mesh | None = None,
              bucket_bytes: int = BUCKET_BYTES):
    """Mean-allreduce a list of gradient tensors in place, bucketed; the
    list is returned."""
    grads = list(grads)
    reduce_(grads, mesh, mean=True, bucket_bytes=bucket_bytes)
    return grads


def _tree_reduce(tree, mesh, mean):
    leaves, spec = tree_flatten(tree)
    out = [x.clone() for x in leaves]
    reduce_(out, mesh, mean=mean)
    return tree_unflatten(out, spec)


def all_reduce_sum(tree, mesh: Mesh | None = None):
    return _tree_reduce(tree, mesh, mean=False)


def all_reduce_mean(tree, mesh: Mesh | None = None):
    return _tree_reduce(tree, mesh, mean=True)


def _gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    if x.is_cuda and dist.get_backend(mesh.group) == "gloo":
        # gloo gathers host tensors only: stage through the CPU
        return _gather(x.cpu(), mesh).to(x.device)
    parts = [torch.empty_like(x) for _ in mesh.ranks]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    return torch.cat(parts)


def all_gather_batch(tree, mesh: Mesh | None = None):
    """Every replica's rows concatenated in replica order along dim 0 (the
    global batch), on every replica.  The shapes must agree."""
    mesh = _mesh(mesh)
    if mesh.group is None:
        return tree
    leaves, spec = tree_flatten(tree)
    return tree_unflatten([_gather(x, mesh) for x in leaves], spec)


def broadcast_from(tree, root: int = 0, mesh: Mesh | None = None):
    """Replica ``root``'s value on every replica (a new tree)."""
    leaves, spec = tree_flatten(tree)
    out = [x.clone() for x in leaves]
    broadcast_(out, root, mesh)
    return tree_unflatten(out, spec)


def axis_index(mesh: Mesh | None = None) -> int:
    """This process's position along the mesh's axis."""
    return _mesh(mesh).ranks.index(process_index())


# ---- host-level utilities ---------------------------------------------------

def _host_bytes(x) -> bytes:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        return x.reshape(-1).view(torch.uint8).numpy().tobytes() \
            if x.numel() else b""
    if isinstance(x, np.ndarray):
        return np.ascontiguousarray(x).tobytes()
    return pickle.dumps(x)


def tree_digest(tree) -> str:
    """sha256 over a tree's leaves' bytes (and their order): equal trees
    give equal digests, on any process."""
    h = hashlib.sha256()
    leaves, spec = tree_flatten(tree)
    h.update(repr(spec).encode())
    for x in leaves:
        h.update(_host_bytes(x))
    return h.hexdigest()


def host_broadcast(tree, is_source: bool | None = None):
    """A host tree (numpy arrays, Python values) from the source process
    (process 0 unless ``is_source`` marks another) on every process.
    No-op for a single process."""
    if process_count() == 1:
        return tree
    if is_source is None:
        is_source = process_index() == 0
    flags = [None] * process_count()
    dist.all_gather_object(flags, bool(is_source), group=host_group())
    if sum(flags) != 1:
        raise ValueError(f"host_broadcast needs exactly one source, got "
                         f"{sum(flags)}")
    box = [tree]
    dist.broadcast_object_list(box, src=flags.index(True),
                               group=host_group())
    return box[0]


def assert_same_across_hosts(tree, name: str = "value") -> None:
    """Raise when ``tree`` differs between processes (compared by
    :func:`tree_digest`)."""
    if process_count() == 1:
        return
    digests = [None] * process_count()
    dist.all_gather_object(digests, tree_digest(tree), group=host_group())
    if len(set(digests)) != 1:
        raise AssertionError(f"{name} diverged across hosts: {digests}")


def host_max(value: int) -> int:
    """The largest ``value`` over the processes."""
    if process_count() == 1:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=host_group())
    return int(t)
