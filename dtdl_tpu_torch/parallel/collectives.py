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

The axis collectives are what ``shard_map`` code writes inside the 4D
step (:mod:`dtdl_tpu_torch.parallel.megatron`), named after the ``lax``
operations and run over a set of mesh axes (this process's line group,
:meth:`~dtdl_tpu_torch.runtime.mesh.Mesh.axis_group`).  Each is a
``torch.autograd.Function`` whose backward is the transpose JAX's
VMA-typed autodiff takes:

| operation | forward | backward |
| --- | --- | --- |
| ``ppermute(x, mesh, axis, perm)`` | send along ``perm`` | send along the inverse |
| ``all_to_all(x, mesh, axis, split, concat)`` | all-to-all | the reverse all-to-all |
| ``psum(x, mesh, axes)`` (a varying value made invariant; Megatron's *g*) | sum | identity |
| ``copy_to(x, mesh, axes)`` (an invariant value used as varying, JAX's implicit ``pvary``; Megatron's *f*) | identity | sum |
| ``pmax``, ``pmin`` | max, min | none (taken on detached values) |
| ``all_gather(x, mesh, axis, dim)`` (an FSDP weight before its use) | gather | ``reduce_scatter`` |
| ``all_gather(..., invariant=True)`` (a shard every rank uses alike) | gather | this rank's part |
| ``reduce_scatter(x, mesh, axis, dim)`` | sum, this rank's part | gather |

``axis_index`` and ``axis_size`` of a mesh are plain ints.  Over axes of
size 1 (the card's one-process mesh) every one is an identity.  A ring
hop runs as one ``batch_isend_irecv`` of its send and its receive, so
neighbours cannot deadlock; gloo moves CUDA tensors through the host.
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


def axis_index(mesh: Mesh | None = None, axes=None) -> int:
    """This process's position along ``axes`` of the mesh (all of its
    axes by default)."""
    mesh = _mesh(mesh)
    return mesh.axis_index(mesh.axis_names if axes is None else axes)


def axis_size(mesh: Mesh, axes) -> int:
    """The number of processes along ``axes`` of the mesh."""
    return mesh.axis_size(axes)


# ---- differentiable axis collectives (the shard_map vocabulary) ------------

def _host_staged(x: torch.Tensor, group, run) -> torch.Tensor:
    """``run(x)`` on the host when gloo must move a CUDA tensor."""
    if x.is_cuda and dist.get_backend(group) == "gloo":
        return run(x.cpu()).to(x.device)
    return run(x)


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM):
    def run(t):
        t = t.contiguous().clone()
        dist.all_reduce(t, op=op, group=group)
        return t
    return _host_staged(x, group, run)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def psum(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """Sum over ``axes``; the gradient passes through unchanged (the
    transpose of a psum whose result every rank uses alike)."""
    group = mesh.axis_group(axes)
    return x if group is None else _PSum.apply(x, group)


def copy_to(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """Identity; the gradient is summed over ``axes`` (the transpose of
    using one value on every rank of ``axes``)."""
    group = mesh.axis_group(axes)
    return x if group is None else _CopyTo.apply(x, group)


def pmax(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """Max over ``axes`` of a detached value."""
    group = mesh.axis_group(axes)
    x = x.detach()
    return x if group is None else _all_reduce(x, group, dist.ReduceOp.MAX)


def pmin(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """Min over ``axes`` of a detached value."""
    group = mesh.axis_group(axes)
    x = x.detach()
    return x if group is None else _all_reduce(x, group, dist.ReduceOp.MIN)


def _permute(x: torch.Tensor, line, me: int, perm) -> torch.Tensor:
    """Send ``x`` to ``line[perm[me]]`` and receive from the rank whose
    pair ends at ``me`` in one ``batch_isend_irecv`` (zeros when none
    does)."""
    dst = dict(perm)
    src = {d: s for s, d in perm}
    x = x.contiguous()
    if dst.get(me) == me:
        return x.clone()
    out = torch.zeros_like(x)
    ops = []
    if me in dst:
        ops.append(dist.P2POp(dist.isend, x, line[dst[me]]))
    if me in src:
        ops.append(dist.P2POp(dist.irecv, out, line[src[me]]))
    for work in dist.batch_isend_irecv(ops) if ops else ():
        work.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.mesh, ctx.axis = mesh, axis
        ctx.perm = [(d, s) for s, d in perm]
        return _ppermute(x, mesh, axis, perm)

    @staticmethod
    def backward(ctx, g):
        return _ppermute(g, ctx.mesh, ctx.axis, ctx.perm), None, None, None


def _ppermute(x, mesh, axis, perm):
    group = mesh.axis_group(axis)
    line = mesh.line(axis)
    me = mesh.axis_index(axis)
    return _host_staged(x, group,
                        lambda t: _permute(t, line, me, perm))


def ppermute(x: torch.Tensor, mesh: Mesh, axis: str, perm) -> torch.Tensor:
    """``lax.ppermute``: ``perm`` is a list of (source, destination)
    positions along ``axis``; a position that no pair reaches gets
    zeros.  Differentiable (the backward sends along the inverse)."""
    if mesh.axis_group(axis) is None:
        return x
    return _PPermute.apply(x, mesh, axis, [tuple(p) for p in perm])


def _a2a(x: torch.Tensor, group, n: int, split: int, concat: int):
    parts = torch.stack(x.chunk(n, dim=split)).contiguous()

    def run(t):
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=group)
        return out
    got = _host_staged(parts, group, run)
    return torch.cat(list(got.unbind(0)), dim=concat)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, split, concat):
        ctx.args = (group, n, concat, split)
        return _a2a(x, group, n, split, concat)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, *ctx.args), None, None, None, None


def all_to_all(x: torch.Tensor, mesh: Mesh, axis: str, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """``lax.all_to_all(..., tiled=True)``: ``x`` split into
    ``axis_size`` parts along ``split_axis``, part j sent to position j,
    the received parts concatenated along ``concat_axis`` in position
    order.  Differentiable (the backward is the reverse all-to-all)."""
    group = mesh.axis_group(axis)
    if group is None:
        return x
    n = mesh.axis_size(axis)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of size "
                         f"{x.shape[split_axis]} does not split over {n}")
    return _AllToAll.apply(x, group, n, split_axis % x.dim(),
                           concat_axis % x.dim())


def _tiled_gather(x: torch.Tensor, group, n: int, dim: int):
    def run(t):
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=group)
        return torch.cat(parts, dim=dim)
    return _host_staged(x, group, run)


def _tiled_scatter(x: torch.Tensor, group, n: int, dim: int, me: int):
    """Part ``me`` (this rank's position) along ``dim`` of the sum over
    ``group``."""
    def run(t):
        parts = [p.contiguous() for p in t.chunk(n, dim=dim)]
        out = torch.empty_like(parts[0])
        if t.device.type == "cpu":
            # gloo has no reduce_scatter: the sum, then this rank's part
            full = t.contiguous().clone()
            dist.all_reduce(full, group=group)
            return full.chunk(n, dim=dim)[me].contiguous()
        dist.reduce_scatter(out, parts, group=group)
        return out
    return _host_staged(x, group, run)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, dim, me, invariant):
        ctx.args = (group, n, dim, me, invariant)
        return _tiled_gather(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        group, n, dim, me, invariant = ctx.args
        part = (g.chunk(n, dim=dim)[me].contiguous() if invariant
                else _tiled_scatter(g, group, n, dim, me))
        return part, None, None, None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, dim, me):
        ctx.args = (group, n, dim)
        return _tiled_scatter(x, group, n, dim, me)

    @staticmethod
    def backward(ctx, g):
        return _tiled_gather(g, *ctx.args), None, None, None, None


def all_gather(x: torch.Tensor, mesh: Mesh, axis, dim: int = 0, *,
               invariant: bool = False) -> torch.Tensor:
    """``lax.all_gather(..., tiled=True)`` along ``axis``: every rank's
    ``x`` concatenated along ``dim`` in position order.  The backward is
    :func:`reduce_scatter` (each rank's use of the whole differs, as an
    FSDP weight's on its own rows); with ``invariant`` every rank uses
    the whole alike (a replicated computation) and the backward takes
    this rank's part of the cotangent, summing nothing."""
    group = mesh.axis_group(axis)
    if group is None:
        return x
    return _AllGather.apply(x, group, mesh.axis_size(axis), dim % x.dim(),
                            mesh.axis_index(axis), invariant)


def reduce_scatter(x: torch.Tensor, mesh: Mesh, axis, dim: int = 0
                   ) -> torch.Tensor:
    """``lax.psum_scatter(..., tiled=True)``: the sum over ``axis``, this
    rank's part of it along ``dim``.  The backward is :func:`all_gather`.
    (The group's rank order is its position order: every line group is
    made from its ranks in position order.)"""
    group = mesh.axis_group(axis)
    if group is None:
        return x
    n = mesh.axis_size(axis)
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of size {x.shape[dim]} "
                         f"does not split over {n}")
    return _ReduceScatter.apply(x, group, n, dim % x.dim(),
                                mesh.axis_index(axis))


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


def host_op(t: torch.Tensor, mesh: Mesh, run) -> None:
    """``run(t, group)`` for a host tensor ``t`` over ``mesh``'s processes,
    in place: on the world's gloo host group when the mesh is the world,
    else on the mesh's group (through the card when that group is
    NCCL)."""
    if mesh.size == process_count():
        run(t, host_group())
    elif dist.get_backend(mesh.group) == "gloo":
        run(t, mesh.group)
    else:
        d = t.cuda()
        run(d, mesh.group)
        t.copy_(d.cpu())


def host_max(value: int) -> int:
    """The largest ``value`` over the processes."""
    if process_count() == 1:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=host_group())
    return int(t)
