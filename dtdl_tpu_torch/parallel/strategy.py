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
| (compiler-partitioned, sync BN)               | ``AutoSharded``               | ``AutoSharded``: DP over the global batch, BatchNorm statistics over it, parameters placed per leaf |

``DataParallel`` keeps the JAX step's numbers, not torch DDP's: each
replica computes on its own rows with per-replica BatchNorm statistics,
the gradients are mean-allreduced (bucketed), every replica applies the
same update, and the new running statistics are mean-allreduced too, so
the replicated state stays bitwise identical across replicas (torch DDP
instead broadcasts rank 0's buffers).  The model is never wrapped in
``torch.nn.parallel.DistributedDataParallel``.

``axis`` may be a tuple of mesh axes, hierarchical data parallelism
over a :func:`~dtdl_tpu_torch.runtime.mesh.hybrid_mesh` (``('dcn',
'data')``): the replicas are this process's line over those axes
(``replicas``, a :class:`Mesh` of its own), and every collective runs in
its group.

``AutoSharded`` computes the JAX jit-over-the-global-batch function:
each process computes its rows, BatchNorm takes its statistics over the
*global* batch (``models/norm.py``, one differentiable all-reduce of the
sums), and every parameter lives where ``param_spec`` places it (the
rank's block of each sharded leaf, gathered at each read), so one step
equals the single-device step on the global batch, where
``DataParallel``'s BatchNorm normalizes by each replica's own rows.

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
from dtdl_tpu_torch.runtime.bootstrap import process_count
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

    def bind(self, state) -> None:
        """Called by every step with its state (``AutoSharded`` places the
        state on the first call)."""

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
    """Shared mesh-bearing behavior.  ``axis`` names the mesh axis the
    replicas lie along, or a tuple of them (hierarchical DP over a hybrid
    mesh); ``replicas`` is the mesh of this process's line over it."""

    def __init__(self, mesh: Mesh | None = None,
                 axis: str | tuple[str, ...] = DATA_AXIS):
        self.mesh = mesh if mesh is not None else build_mesh()
        self.replicas = self.mesh.along(axis)
        self.axis = axis

    @property
    def num_replicas(self) -> int:
        return self.replicas.size


class DataParallel(MeshStrategy):
    """Allreduce data parallelism over the mesh's processes (DP over
    ``local_mesh()``, DDP over ``build_mesh()``)."""

    def grad_sync(self, grads):
        return collectives.grad_sync(grads, self.replicas)

    def metric_sync(self, tree):
        return collectives.all_reduce_mean(tree, self.replicas)

    def sum_sync(self, tree):
        return collectives.all_reduce_sum(tree, self.replicas)

    def stats_sync(self, stats):
        stats = list(stats)
        collectives.reduce_(stats, self.replicas, mean=True)
        return stats

    def max_sync(self, n: int) -> int:
        if self.replicas.group is None:
            return n
        t = torch.tensor([int(n)], dtype=torch.int64)
        collectives.host_op(t, self.replicas, lambda x, g: dist.all_reduce(
            x, op=dist.ReduceOp.MAX, group=g))
        return int(t)

    def fold_rank(self, seed: int) -> int:
        # each replica draws its own dropout mask, like per-rank DDP workers
        return int(np.random.SeedSequence(
            [seed, collectives.axis_index(self.replicas)]).generate_state(1)[0])

    def replicate(self, state):
        """Replica 0's parameters, buffers (BatchNorm statistics),
        optimizer state and step on every replica, in place."""
        if self.replicas.group is not None:
            _broadcast_state(state, self.replicas)
        return state


def _broadcast_state(state, mesh: Mesh) -> None:
    """The state of ``mesh``'s first process (parameters, buffers,
    optimizer state, step) on every process of it, in place."""
    model, opt = state.model, state.optimizer
    tensors = [p.data for p in model.parameters()]
    tensors += [b for b in model.buffers()]
    for p in model.parameters():
        tensors += [v for _, v in sorted(opt.state.get(p, {}).items())
                    if isinstance(v, torch.Tensor)]
    on_dev = [t for t in tensors if t.device.type != "cpu"]
    on_host = [t for t in tensors if t.device.type == "cpu"]
    step = torch.tensor([state.step], dtype=torch.int64)
    collectives.broadcast_(on_dev, 0, mesh)
    for t in on_host + [step]:      # host tensors ride the gloo group
        collectives.host_op(t, mesh, lambda x, g: dist.broadcast(
            x, src=mesh.ranks[0], group=g))
    state.step = int(step)


class _DictKey:
    """A jax ``DictKey`` path entry: ``.key``, printed ``['key']``."""

    def __init__(self, key):
        self.key = key

    def __str__(self) -> str:
        return f"[{self.key!r}]"

    __repr__ = __str__


class _GetAttrKey:
    """A jax ``GetAttrKey`` path entry: ``.name``, printed ``.name``."""

    def __init__(self, name):
        self.name = name

    def __str__(self) -> str:
        return f".{self.name}"

    __repr__ = __str__


class LeafShape:
    """What a per-leaf ``param_spec`` sees of a leaf: its flax-layout
    ``shape``, ``ndim`` and ``dtype`` (as a ``ShapeDtypeStruct``)."""

    def __init__(self, shape, dtype):
        self.shape, self.dtype = tuple(shape), dtype
        self.ndim = len(self.shape)


class AutoSharded(DataParallel):
    """Compiler-partitioned strategy (pjit style), the port of the JAX
    ``AutoSharded``: data parallelism over ``axis`` with the global-batch
    function (BatchNorm statistics over the whole batch) and per-leaf
    parameter placement on a mesh that may carry more axes (``model``).

    ``param_spec`` is one ``PartitionSpec`` (a tuple of mesh axes or
    ``None``, :class:`~dtdl_tpu_torch.parallel.tensor.PartitionSpec`) for
    every parameter, or a callable ``(path, leaf) -> spec`` over the
    TrainState tree's flax key paths (``.params``, ``['Dense_0']``,
    ``['kernel']`` entries with ``.name``/``.key``) and flax-layout
    leaves (:class:`LeafShape`), so a JAX rule works unchanged; the
    optimizer state is made on each parameter's block and so follows it.
    The placement binds on the first step, or at :meth:`replicate`, and
    stays: the optimizer updates the blocks in place.  A sharded leaf is
    gathered at each read (its gradient reduce-scattered over ``axis``,
    or kept to this rank's part over another axis, where every rank
    computes alike); BatchNorm statistics stay whole."""

    def __init__(self, mesh: Mesh | None = None,
                 axis: str = DATA_AXIS, param_spec=None):
        super().__init__(mesh, axis)
        self.param_spec = param_spec if param_spec is not None else ()
        self._placed = None           # the model the placement is bound to
        self._sharded_on_axis = []    # per parameter, in model order

    @property
    def _per_leaf(self) -> bool:
        return callable(self.param_spec) and \
            not isinstance(self.param_spec, tuple)

    def _spec(self, keys, shape, dtype):
        if not self._per_leaf:
            return tuple(self.param_spec)
        path = (_GetAttrKey(keys[0]),) + tuple(_DictKey(k) for k in keys[1:])
        return tuple(self.param_spec(path, LeafShape(shape, dtype)))

    def bind(self, state) -> None:
        """Place ``state`` if it is not placed yet (once per model)."""
        if self._placed is not state.model:
            self.replicate(state)

    def replicate(self, state):
        """The mesh's first process's state on every process, then
        each parameter cut to this rank's block of its spec and gathered
        at each read; BatchNorm set to the global batch."""
        from torch.nn.utils import parametrize

        from dtdl_tpu_torch.bridge import _classifier_leaves, _flax_layout
        from dtdl_tpu_torch.models.layers import Classifier
        from dtdl_tpu_torch.models.norm import BatchNorm
        from dtdl_tpu_torch.parallel.tensor import _Gather, block_of
        if self._placed is state.model:
            return state
        model = state.model
        if self.mesh.group is not None:
            # one root over the whole mesh: the lines of the other axes
            # hold the same state too
            _broadcast_state(state, self.mesh)
        if isinstance(model, Classifier):
            leaves = {key: (coll, path, kind) for (coll, path), (key, kind)
                      in _classifier_leaves(model).items()}
        else:
            leaves = {name: ("params", name.replace(".", "/"), None)
                      for name, _ in model.named_parameters()}
        own = {**dict(model.named_parameters()),
               **dict(model.named_buffers())}
        modules = dict(model.named_modules())
        on_axis = set()
        for name, p in list(model.named_parameters()):
            coll, path, kind = leaves[name]
            flax_spec = self._spec([coll] + path.split("/"),
                                   _flax_layout(kind, tuple(p.shape)) if kind
                                   else tuple(p.shape), p.dtype)
            spec = [None] * p.dim()
            order = (2, 3, 1, 0) if kind == "conv" else \
                (1, 0) if kind == "dense" else tuple(range(p.dim()))
            for i, axis in enumerate(flax_spec):
                spec[order[i]] = axis
            for d, a in enumerate(spec):
                if a is not None and p.shape[d] % self.mesh.shape[a]:
                    raise ValueError(
                        f"param_spec places {coll}/{path} dim {d} (size "
                        f"{p.shape[d]}) on {a!r} of size "
                        f"{self.mesh.shape[a]}, which does not divide it")
            dims = [(d, a, a != self.axis) for d, a in enumerate(spec)
                    if a is not None and self.mesh.shape[a] > 1]
            if any(not inv for _, _, inv in dims):
                on_axis.add(id(p))
            if dims:
                with torch.no_grad():
                    p.data = block_of(p.data, spec, self.mesh).contiguous()
                owner, _, leaf = name.rpartition(".")
                parametrize.register_parametrization(
                    modules[owner], leaf, _Gather(self.mesh, dims),
                    unsafe=True)
        for key, (coll, path, _) in leaves.items():
            if coll == "batch_stats" and any(self._spec(
                    [coll] + path.split("/"), tuple(own[key].shape),
                    own[key].dtype)):
                raise ValueError(f"param_spec shards the BatchNorm "
                                 f"statistic {path}; the port keeps them "
                                 f"whole")
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.sync = (self.mesh, self.axis)
        # in the order the steps list the gradients (parametrized leaves
        # move to the end of their module's)
        self._sharded_on_axis = [id(p) in on_axis for p in model.parameters()]
        self._placed = model
        return state

    def grad_sync(self, grads):
        """The mean over ``axis`` of each gradient: all-reduced for a leaf
        held whole on it, divided for one that came back
        reduce-scattered."""
        grads = list(grads)
        n = self.num_replicas
        whole = [g for g, s in zip(grads, self._sharded_on_axis) if not s]
        collectives.reduce_(whole, self.replicas, mean=True)
        for g, s in zip(grads, self._sharded_on_axis):
            if s:
                g.div_(n)
        return grads

    def stats_sync(self, stats):
        # the statistics were taken over the global batch already
        return list(stats)


def data_parallel_local() -> DataParallel:
    """Data parallelism over this process's devices (one replica)."""
    return DataParallel(local_mesh())


def distributed_data_parallel() -> DataParallel:
    """Allreduce DP over the process world (DistributedDataParallel)."""
    return DataParallel(build_mesh())


def choose_strategy(name: str = "auto", mesh: Mesh | None = None) -> Strategy:
    """'single' | 'dp' | 'ddp' | 'pjit' | 'auto' (ddp with more than one
    process, else single)."""
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
