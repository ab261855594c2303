"""The device mesh over the process world, the port of
dtdl_tpu/runtime/mesh.py along its data axis.

A port process drives one device, so a mesh is a set of processes: the
:class:`Mesh` names its axis, the ranks along it and the
``torch.distributed`` group its collectives run in.  ``build_mesh()``
puts every process of the world on the ``data`` axis (the reference's
allreduce world); ``local_mesh()`` is this process's own device, one
replica, as ``jax.local_devices()`` is in a process that owns one.  A
mesh with more than one axis, ``hybrid_mesh`` (slices over a DCN axis)
and ``shrink_mesh`` (elastic shrink to survivors) are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch.distributed as dist

from dtdl_tpu_torch.runtime.bootstrap import process_count, process_index

DATA_AXIS = "data"


@dataclass(frozen=True)
class Mesh:
    """Processes along named axes.  ``group`` is the process group of the
    axis's collectives, ``None`` for a one-replica mesh with no world
    (its collectives are identities)."""
    ranks: tuple[int, ...]
    axis_names: tuple[str, ...] = (DATA_AXIS,)
    group: object = None

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: len(self.ranks)}

    @property
    def size(self) -> int:
        return len(self.ranks)


def _one_axis(shape, axes) -> None:
    if (shape is not None and len(shape) > 1) or \
            (axes is not None and len(axes) > 1):
        raise NotImplementedError(
            f"mesh shape {shape} / axes {axes}: axes beyond 'data' (tensor, "
            f"pipeline, sequence, expert) are ROADMAP queue A11 (4D "
            f"parallelism); the port's mesh is the data axis")


def build_mesh(shape: tuple[int, ...] | None = None,
               axes: tuple[str, ...] | None = None) -> Mesh:
    """Every process of the world on one axis (``data`` by default).
    ``shape`` (one entry) must equal the world size."""
    _one_axis(shape, axes)
    n = process_count()
    if shape is not None and int(np.prod(shape)) != n:
        raise ValueError(
            f"mesh shape {tuple(shape)} needs {int(np.prod(shape))} devices, "
            f"have {n}")
    axes = tuple(axes) if axes else (DATA_AXIS,)
    group = dist.group.WORLD if dist.is_initialized() else None
    return Mesh(tuple(range(n)), axes, group)


def local_mesh(axes: tuple[str, ...] = (DATA_AXIS,)) -> Mesh:
    """This process's devices: one replica, no collectives.  The JAX
    mesh of a process's local devices is ``nn.DataParallel``'s world; a
    port process drives one card, and the launcher's one process per
    card (``build_mesh``) takes nn.DataParallel's place."""
    _one_axis(None, axes)
    return Mesh((process_index(),), tuple(axes), None)


def hybrid_mesh(*args, **kwargs):
    raise NotImplementedError(
        "hybrid_mesh (a DCN axis over slices, ICI axes within) is ROADMAP "
        "queue A11 (4D parallelism)")


def shrink_mesh(*args, **kwargs):
    raise NotImplementedError(
        "shrink_mesh (shrink-to-survivors elastic training) is ROADMAP "
        "queue A13 (operations)")
