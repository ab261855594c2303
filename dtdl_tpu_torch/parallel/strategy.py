"""Parallelism strategies, the port of dtdl_tpu/parallel/strategy.py.

A strategy owns the mesh and the hooks the train, eval and predict steps
call around their per-replica compute: ``grad_sync`` (before the
optimizer update), ``stats_sync`` (the new BatchNorm running
statistics), ``metric_sync`` / ``sum_sync`` (train means, eval sums),
``shard_batch`` and ``replicate`` (where batches and the state live).

| reference                                     | JAX package                   | here                          |
|-----------------------------------------------|-------------------------------|-------------------------------|
| single-device loop                            | ``SingleDevice``              | ``SingleDevice``              |
| nn.DataParallel / MirroredStrategy            | ``DataParallel(local_mesh())``| one process per card: ``DataParallel(local_mesh())`` is one replica |
| DistributedDataParallel / ChainerMN           | ``DataParallel(build_mesh())``| ``DataParallel(build_mesh())`` over the process world |
| (compiler-partitioned, sync BN)               | ``AutoSharded``               | not ported (ROADMAP A11)      |

``DataParallel`` keeps the JAX step's numbers, not torch DDP's: each
replica computes on its own rows with per-replica BatchNorm statistics,
the gradients are mean-allreduced (bucketed), every replica applies the
same update, and the new running statistics are mean-allreduced too, so
the replicated state stays bitwise identical across replicas (torch DDP
instead broadcasts rank 0's buffers).  The model is never wrapped in
``torch.nn.parallel.DistributedDataParallel``.

``grad_sync`` and ``stats_sync`` work in place on the tensors the model
holds (its ``.grad`` and its statistic buffers) and return them;
``metric_sync`` and ``sum_sync`` return new trees.  In a port process
the loader already cuts this process's rows of the global batch (a
per-process :class:`~dtdl_tpu_torch.data.sharding.ShardedSampler`, as
the JAX multi-process path does), so ``shard_batch`` passes the batch
on; the step puts it on the process's device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from dtdl_tpu_torch.parallel import collectives
from dtdl_tpu_torch.runtime.bootstrap import host_group, process_count
from dtdl_tpu_torch.runtime.mesh import (DATA_AXIS, Mesh, build_mesh,
                                         local_mesh)


class Strategy:
    """Base: single logical device semantics."""

    mesh: Mesh | None = None
    axis: str | None = None

    def grad_sync(self, grads):
        return grads

    def metric_sync(self, tree):
        return tree

    def sum_sync(self, tree):
        """Sum-allreduce (for exact count-weighted eval metrics)."""
        return tree

    def stats_sync(self, stats):
        return stats

    def max_sync(self, n: int) -> int:
        """The largest ``n`` over the replicas (host side)."""
        return n

    def fold_rank(self, seed: int) -> int:
        """Decorrelate a seed across replicas (identity off-mesh)."""
        return seed

    def shard_batch(self, batch):
        return batch

    def replicate(self, state):
        return state

    @property
    def num_replicas(self) -> int:
        return 1

    def per_replica_batch(self, global_batch_size: int) -> int:
        """``--batch-size`` is GLOBAL and splits over the world's
        replicas (the reference divided by the local device count only,
        which changes the global batch as nodes are added)."""
        n = self.num_replicas
        if global_batch_size % n:
            raise ValueError(
                f"global batch {global_batch_size} not divisible by "
                f"{n} replicas")
        return global_batch_size // n


class SingleDevice(Strategy):
    """One device, no collectives."""


class MeshStrategy(Strategy):
    """Shared mesh-bearing behavior.  ``axis`` names the mesh's axis; a
    tuple of axes (hierarchical DP over a hybrid mesh) is ROADMAP A11."""

    def __init__(self, mesh: Mesh | None = None, axis: str = DATA_AXIS):
        if isinstance(axis, tuple):
            raise NotImplementedError(
                f"axis {axis}: data parallelism over several mesh axes "
                f"(a hybrid mesh) is ROADMAP queue A11 (4D parallelism)")
        self.mesh = mesh if mesh is not None else build_mesh()
        if axis not in self.mesh.axis_names:
            raise ValueError(f"mesh has no axis {axis!r} (axes: "
                             f"{self.mesh.axis_names})")
        self.axis = axis

    @property
    def num_replicas(self) -> int:
        return self.mesh.size


class DataParallel(MeshStrategy):
    """Allreduce data parallelism over the mesh's processes (DP over
    ``local_mesh()``, DDP over ``build_mesh()``)."""

    def grad_sync(self, grads):
        return collectives.grad_sync(grads, self.mesh)

    def metric_sync(self, tree):
        return collectives.all_reduce_mean(tree, self.mesh)

    def sum_sync(self, tree):
        return collectives.all_reduce_sum(tree, self.mesh)

    def stats_sync(self, stats):
        stats = list(stats)
        collectives.reduce_(stats, self.mesh, mean=True)
        return stats

    def max_sync(self, n: int) -> int:
        return collectives.host_max(n) if self.mesh.group is not None else n

    def fold_rank(self, seed: int) -> int:
        # each replica draws its own dropout mask, like per-rank DDP workers
        return int(np.random.SeedSequence(
            [seed, collectives.axis_index(self.mesh)]).generate_state(1)[0])

    def replicate(self, state):
        """Replica 0's parameters, buffers (BatchNorm statistics),
        optimizer state and step on every replica, in place."""
        if self.mesh.group is None:
            return state
        model, opt = state.model, state.optimizer
        tensors = [p.data for p in model.parameters()]
        tensors += [b for b in model.buffers()]
        for p in model.parameters():
            tensors += [v for _, v in sorted(opt.state.get(p, {}).items())
                        if isinstance(v, torch.Tensor)]
        on_dev = [t for t in tensors if t.device.type != "cpu"]
        on_host = [t for t in tensors if t.device.type == "cpu"]
        step = torch.tensor([state.step], dtype=torch.int64)
        collectives.broadcast_(on_dev, 0, self.mesh)
        for t in on_host + [step]:      # host tensors ride the gloo group
            dist.broadcast(t, src=self.mesh.ranks[0], group=host_group())
        state.step = int(step)
        return state


class AutoSharded(MeshStrategy):
    """Compiler-partitioned strategy (pjit style): not ported."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "AutoSharded (pjit-style partitioning: global-batch sync "
            "BatchNorm, per-leaf parameter sharding) is ROADMAP queue A11 "
            "(4D parallelism); DataParallel is the port's DDP")


def data_parallel_local() -> DataParallel:
    """Data parallelism over this process's devices (one replica)."""
    return DataParallel(local_mesh())


def distributed_data_parallel() -> DataParallel:
    """Allreduce DP over the process world (DistributedDataParallel)."""
    return DataParallel(build_mesh())


def choose_strategy(name: str = "auto", mesh: Mesh | None = None) -> Strategy:
    """'single' | 'dp' | 'ddp' | 'auto' (ddp with more than one process,
    else single); 'pjit' is ROADMAP A11."""
    if name == "auto":
        name = "ddp" if process_count() > 1 else "single"
    if name == "single":
        return SingleDevice()
    if name == "dp":
        return DataParallel(mesh if mesh is not None else local_mesh())
    if name == "ddp":
        return DataParallel(mesh if mesh is not None else build_mesh())
    if name == "pjit":
        return AutoSharded(mesh)
    raise ValueError(f"unknown strategy {name!r}")


def check_strategy(strategy) -> Strategy:
    """``None`` -> :class:`SingleDevice`; a port strategy as it is;
    anything else (a JAX strategy, a name) raises ``TypeError``."""
    if strategy is None:
        return SingleDevice()
    if not isinstance(strategy, Strategy):
        raise TypeError(
            f"strategy {strategy!r} is not a dtdl_tpu_torch strategy; build "
            f"one with dtdl_tpu_torch.parallel.choose_strategy(name) or "
            f"DataParallel(mesh)")
    return strategy
