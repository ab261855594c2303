"""The device mesh over the process world, the port of
dtdl_tpu/runtime/mesh.py.

A port process drives one device, so a mesh is a set of processes laid
out along named axes: :class:`Mesh` holds the world ranks in row-major
order over its ``dims``, so the rank at coordinate ``c`` is
``ranks[ravel(c)]``, as the JAX mesh holds its devices in a
``devices.reshape(shape)`` array.  A collective over a set of axes runs
in the process group of this process's *line* over them: the ranks that
share every other coordinate.  ``build_mesh`` makes those groups once,
on every rank and in the same order (``dist.new_group`` is collective
over the world), for every set of axes whose size is above 1; a set of
size 1, and any mesh of a single process without a world, has no group
and its collectives are identities.

``build_mesh()`` puts every process on the ``data`` axis (the
reference's allreduce world); ``build_mesh(shape, axes)`` is a multi-axis
mesh (the 4D engine's ``('data', 'seq', 'pipe', 'model')``);
``local_mesh()`` is this process's own device, one replica;
``sub_mesh(ranks)`` one axis over some of the world's processes;
``hybrid_mesh`` leads with a ``dcn`` axis over launcher hosts or
synthetic slices; ``shrink_mesh`` keeps the survivors' positions along
one axis after peers are lost, its groups made by the survivors alone.
``replicated`` and ``batch_sharded`` place a host array: each returns
this process's part of it as a tensor.
"""

from __future__ import annotations

import itertools
import math
import socket
from dataclasses import dataclass, field

import numpy as np
import torch.distributed as dist

from dtdl_tpu_torch.device import resolve_device, upload
from dtdl_tpu_torch.runtime.bootstrap import (host_group, process_count,
                                              process_index)

DATA_AXIS = "data"
MODEL_AXIS = "model"
DCN_AXIS = "dcn"


@dataclass(frozen=True)
class Mesh:
    """Processes along named axes.  ``ranks`` are the world ranks in
    row-major order over ``dims`` (one axis of ``len(ranks)`` when
    ``dims`` is None); ``group`` is the process group of the whole mesh,
    ``None`` for a mesh of one process with no world.  ``groups`` maps a
    set of axes (those of size above 1) to this process's group over its
    line, as :func:`build_mesh` made them.  ``host_group`` is a gloo group
    over the processes of a :func:`sub_mesh`, for its barriers and a
    tensor-parallel engine's control plane (the mesh's own group where
    the world is gloo); a mesh of the whole world uses the world's host
    group instead."""
    ranks: tuple[int, ...]
    axis_names: tuple[str, ...] = (DATA_AXIS,)
    group: object = None
    dims: tuple[int, ...] | None = None
    groups: dict = field(default_factory=dict, compare=False, repr=False)
    host_group: object = field(default=None, compare=False, repr=False)

    def __post_init__(self):
        dims = (len(self.ranks),) if self.dims is None else self.dims
        object.__setattr__(self, "dims", tuple(int(d) for d in dims))
        object.__setattr__(self, "ranks", tuple(self.ranks))
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        if len(self.dims) != len(self.axis_names):
            raise ValueError(f"mesh dims {self.dims} do not match axes "
                             f"{self.axis_names}")
        if math.prod(self.dims) != len(self.ranks):
            raise ValueError(f"mesh dims {self.dims} need "
                             f"{math.prod(self.dims)} ranks, have "
                             f"{len(self.ranks)}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return len(self.ranks)

    def _axes(self, axes) -> tuple[str, ...]:
        """``axes`` (a name or a tuple) as a tuple in mesh order."""
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in names if a not in self.axis_names]
        if unknown:
            raise ValueError(f"mesh has no axis {unknown[0]!r} (axes: "
                             f"{self.axis_names})")
        return tuple(a for a in self.axis_names if a in names)

    def coords(self, rank: int | None = None) -> dict:
        """The coordinate of ``rank`` (this process) on every axis."""
        rank = process_index() if rank is None else rank
        at = np.unravel_index(self.ranks.index(rank), self.dims)
        return {a: int(i) for a, i in zip(self.axis_names, at)}

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self._axes(axes))

    def axis_index(self, axes, rank: int | None = None) -> int:
        """The position of ``rank`` (this process) along ``axes``,
        row-major over them in mesh order."""
        axes = self._axes(axes)
        c = self.coords(rank)
        return int(np.ravel_multi_index([c[a] for a in axes],
                                         [self.shape[a] for a in axes])) \
            if axes else 0

    def line(self, axes, rank: int | None = None) -> tuple[int, ...]:
        """The world ranks that share every coordinate off ``axes`` with
        ``rank`` (this process), in :meth:`axis_index` order."""
        axes = self._axes(axes)
        c = self.coords(rank)
        grid = np.asarray(self.ranks).reshape(self.dims)
        at = tuple(slice(None) if a in axes else c[a]
                   for a in self.axis_names)
        return tuple(int(r) for r in grid[at].reshape(-1))

    def axis_group(self, axes):
        """This process's group over ``axes``; ``None`` when their size is
        1 or there is no world (the collectives are then identities)."""
        live = frozenset(a for a in self._axes(axes) if self.shape[a] > 1)
        if not live or self.group is None:
            return None
        if live == frozenset(a for a in self.axis_names
                             if self.shape[a] > 1):
            return self.group
        return self.groups[live]

    def along(self, axes) -> "Mesh":
        """The mesh of this process's line over ``axes`` (its ranks, those
        axes, their group)."""
        axes = self._axes(axes)
        return Mesh(self.line(axes), axes, self.axis_group(axes),
                    tuple(self.shape[a] for a in axes))


def _line_groups(ranks, dims, axis_names) -> dict:
    """Every line group of a multi-axis mesh, made on every process in
    one order; returns this process's group for each set of axes."""
    me = process_index()
    grid = np.asarray(ranks).reshape(dims)
    live = [i for i, d in enumerate(dims) if d > 1]
    out = {}
    for n in range(1, len(live)):
        for sub in itertools.combinations(live, n):
            # put the subset's axes last: each row is one line
            rest = [i for i in range(len(dims)) if i not in sub]
            lines = np.transpose(grid, rest + list(sub)).reshape(
                -1, math.prod(dims[i] for i in sub))
            for line in lines:
                g = dist.new_group([int(r) for r in line])
                if me in line:
                    out[frozenset(axis_names[i] for i in sub)] = g
    return out


def build_mesh(shape: tuple[int, ...] | None = None,
               axes: tuple[str, ...] | None = None) -> Mesh:
    """Every process of the world laid out along ``axes`` (``data`` for
    one axis; ``axis1``, ... after it by default).  ``shape`` must
    multiply to the world size; each process's line groups are made
    here."""
    n = process_count()
    shape = (n,) if shape is None else tuple(int(s) for s in shape)
    if axes is None:
        axes = (DATA_AXIS,) + tuple(f"axis{i}" for i in range(1, len(shape)))
    axes = tuple(axes)
    if len(axes) != len(shape):
        raise ValueError(f"mesh shape {shape} does not match axes {axes}")
    if math.prod(shape) != n:
        raise ValueError(
            f"mesh shape {shape} needs {math.prod(shape)} devices, have {n}")
    ranks = tuple(range(n))
    if not dist.is_initialized():
        return Mesh(ranks, axes, None, shape)
    return Mesh(ranks, axes, dist.group.WORLD, shape,
                _line_groups(ranks, shape, axes))


def local_mesh(axes: tuple[str, ...] = (DATA_AXIS,)) -> Mesh:
    """This process's devices: one replica, no collectives.  The JAX
    mesh of a process's local devices is ``nn.DataParallel``'s world; a
    port process drives one card, and the launcher's one process per
    card (``build_mesh``) takes nn.DataParallel's place."""
    axes = tuple(axes)
    return Mesh((process_index(),), axes, None, (1,) * len(axes))


def hybrid_mesh(ici_shape: tuple[int, ...] | None = None,
                ici_axes: tuple[str, ...] = (DATA_AXIS,),
                dcn_axis: str = DCN_AXIS,
                num_slices: int | None = None) -> Mesh:
    """Multi-slice mesh: a leading ``dcn_axis`` over slices, ``ici_axes``
    within.  A slice is a launcher host (the processes that share a host
    name), or, with ``num_slices``, one of that many equal runs of
    consecutive ranks (synthetic slices, as the JAX mesh splits devices
    without slice metadata).  ``DataParallel(mesh, axis=(dcn_axis,) +
    ici_axes)`` is then hierarchical data parallelism over all of it."""
    n = process_count()
    hosts = [socket.gethostname()]
    if n > 1:
        hosts = [None] * n
        dist.all_gather_object(hosts, socket.gethostname(),
                               group=host_group())
    names = list(dict.fromkeys(hosts))
    if num_slices is not None and len(names) > 1 and \
            num_slices != len(names):
        raise ValueError(f"num_slices={num_slices} conflicts with the "
                         f"{len(names)} launcher hosts")
    if len(names) > 1:
        groups = [[r for r in range(n) if hosts[r] == h] for h in names]
    else:
        num_slices = num_slices or 1
        if n % num_slices:
            raise ValueError(f"{n} devices not divisible into {num_slices} "
                             f"slices")
        per = n // num_slices
        groups = [list(range(i * per, (i + 1) * per))
                  for i in range(num_slices)]
    per = len(groups[0])
    if any(len(g) != per for g in groups):
        raise ValueError(f"unequal slice sizes {[len(g) for g in groups]}")
    ici_shape = (per,) if ici_shape is None else tuple(ici_shape)
    if math.prod(ici_shape) != per:
        raise ValueError(f"ici shape {ici_shape} needs "
                         f"{math.prod(ici_shape)} devices/slice, have {per}")
    ranks = tuple(r for g in groups for r in g)
    dims = (len(groups),) + ici_shape
    axes = (dcn_axis,) + tuple(ici_axes)
    if not dist.is_initialized():
        return Mesh(ranks, axes, None, dims)
    return Mesh(ranks, axes, dist.group.WORLD, dims,
                _line_groups(ranks, dims, axes))


def sub_mesh(ranks, axis: str = DATA_AXIS) -> Mesh | None:
    """The one-axis mesh of the world ``ranks`` (a data-parallel mesh
    over fewer processes than the world): its group is made on every
    process (``dist.new_group`` is collective over the world), and the
    mesh comes back on its members, ``None`` on the others.  Beside an
    NCCL world a gloo group over the same processes carries the mesh's
    barriers (``bootstrap.barrier(mesh=)``) and a tensor-parallel
    engine's control plane, as the world's host group does the world's.
    Every call makes new groups, so two sub-meshes over the same
    processes (two tensor-parallel engines driven apart) share none."""
    ranks = tuple(int(r) for r in ranks)
    group = host = None
    if dist.is_initialized():
        group = host = dist.new_group(list(ranks))
        if dist.get_backend() != "gloo":
            host = dist.new_group(list(ranks), backend="gloo")
    if process_index() not in ranks:
        return None
    if len(ranks) == 1:
        return Mesh(ranks, (axis,), None)
    return Mesh(ranks, (axis,), group, host_group=host)


class ShrinkMeshError(RuntimeError):
    """The survivors could not form their process group: the world's
    rendezvous store is gone (it lives in process 0, the coordinator
    address's owner), so no group can be made without a new world."""


# survivor groups by their world ranks: torch names a group made with
# local synchronization after its ranks, so each set is made once
_SURVIVOR_GROUPS: dict = {}


def _survivor_group(ranks: tuple):
    """A process group over ``ranks`` that only its members make
    (``use_local_synchronization``): a lost peer never has to join."""
    if ranks not in _SURVIVOR_GROUPS:
        _SURVIVOR_GROUPS[ranks] = dist.new_group(
            list(ranks), use_local_synchronization=True)
    return _SURVIVOR_GROUPS[ranks]


def shrink_mesh(mesh: Mesh, survivors, axis: str = DATA_AXIS) -> Mesh | None:
    """``mesh`` keeping only the ``survivors`` coordinates along ``axis``:
    the process-group half of shrink-to-survivors elastic training.  The
    new mesh's ``axis`` spans exactly the surviving positions, every
    other axis keeps its extent, and its collectives run in groups that
    hold no lost peer.

    ``survivors`` are positions along ``axis`` (as in JAX), not ranks.
    Only the surviving processes call this: ``dist.new_group`` is
    collective over the whole world, and a dead peer cannot join it, so
    every group here is made with local synchronization (by its members
    alone) over the world's rendezvous store.  A process outside the
    survivors gets ``None``; when the store's owner (process 0) is among
    the lost, the construction fails fast and raises
    :class:`ShrinkMeshError` by name."""
    names = mesh.axis_names
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r} (axes: {names})")
    ax = names.index(axis)
    extent = mesh.dims[ax]
    surv = sorted(set(int(s) for s in survivors))
    if not surv:
        raise ValueError("shrink_mesh needs at least one survivor")
    bad = [s for s in surv if not 0 <= s < extent]
    if bad:
        raise ValueError(f"survivor position(s) {bad} outside axis "
                         f"{axis!r} of extent {extent}")
    grid = np.take(np.asarray(mesh.ranks).reshape(mesh.dims), surv, axis=ax)
    ranks = tuple(int(r) for r in grid.reshape(-1))
    dims = tuple(grid.shape)
    if mesh.group is None or not dist.is_initialized():
        return Mesh(ranks, names, None, dims)
    me = process_index()
    if me not in ranks:
        return None
    try:
        group = _survivor_group(ranks) if len(ranks) > 1 else None
        groups = {}
        live = [i for i, d in enumerate(dims) if d > 1]
        small = Mesh(ranks, names, None, dims)
        for n in range(1, len(live)):
            for sub in itertools.combinations(live, n):
                key = frozenset(names[i] for i in sub)
                groups[key] = _survivor_group(small.line(tuple(key), me))
    except RuntimeError as e:   # c10d DistNetworkError and kin
        raise ShrinkMeshError(
            f"the survivors {list(ranks)} could not form their process "
            f"group ({type(e).__name__}: {e}); the world's rendezvous "
            f"store lives in process 0 — if it was lost, start a new "
            f"world") from e
    return Mesh(ranks, names, group, dims, groups)


def replicated(mesh: Mesh, array, device=None):
    """The whole host ``array`` on this process's device (``None``: the
    card), as every replica holds a replicated array."""
    return upload(np.asarray(array), resolve_device(device))


def batch_sharded(mesh: Mesh, array, axis=DATA_AXIS, device=None):
    """This process's rows of the host ``array``: its leading dim split
    evenly over ``axis`` (a name or a tuple of names), the part at this
    process's :meth:`Mesh.axis_index`."""
    array = np.asarray(array)
    n = mesh.axis_size(axis)
    if array.shape[0] % n:
        raise ValueError(f"leading dim {array.shape[0]} not divisible by "
                         f"{n} shards on {axis!r}")
    per = array.shape[0] // n
    i = mesh.axis_index(axis)
    return upload(array[i * per:(i + 1) * per], resolve_device(device))
