"""KVStore, the MXNet gradient-aggregation surface, the port of
dtdl_tpu/parallel/kvstore.py.

MXNet's distributed idiom is the key-value store: workers ``push``
gradients keyed by parameter name, the store aggregates (sums) them,
across the process's devices for ``local``/``device`` stores and across
the workers for ``dist_*``, and workers ``pull`` the aggregate back
before the optimizer update.  ``KVStoreStrategy`` plugs the store into
the step as its gradient sync, the role ``kvstore=`` plays in
``mxnet.mod.Module.fit``.

The data plane.  JAX stages ``push`` inside a traced step and sums with
``lax.psum`` over a one-process multi-device mesh; a port process drives
one card (:mod:`dtdl_tpu_torch.runtime.mesh`), so ``pull`` is an eager
sum-allreduce (bucketed, :func:`~dtdl_tpu_torch.parallel.collectives.
reduce_`) over the mesh's process group, in place on the pushed tensors
(the gradients the update then reads), followed by the scale in their
dtype: ``average=True`` divides by ``aggregation_width`` (bitwise the
``DataParallel`` mean), else the constructor's ``rescale`` multiplies.
A ``local``/``device`` store is the process's own card, width 1: the
sum is the value, and the scale still applies.  ``dist_*`` spans the
launcher's world; ``dist_async`` routes to the same synchronous sum, as
in JAX.  Like MXNet, aggregation is a sum and normalization explicit.

The control plane (:class:`HostKVStore`, :func:`store_barrier`,
:class:`RetryingStore` and the named :class:`StoreError`s) is the JAX
module's host-side store, copied: set/get/wait/add/delete with
store-side ages and generation fencing, which elastic training runs on.
"""

from __future__ import annotations

import threading
import time

import numpy as np
from torch.utils._pytree import tree_flatten, tree_unflatten

from dtdl_tpu_torch.parallel import collectives
from dtdl_tpu_torch.parallel.strategy import (DataParallel, SingleDevice,
                                              Strategy)
from dtdl_tpu_torch.runtime.bootstrap import (BarrierTimeoutError,
                                              backoff_delay, process_count,
                                              process_index)
from dtdl_tpu_torch.runtime.mesh import DATA_AXIS, build_mesh, local_mesh

VALID_KINDS = ("local", "device", "dist_sync", "dist_device_sync", "dist_async")


# ---------------------------------------------------------------------------
# host-side control-plane store
#
# The KVStore below is the data plane (a sum over the mesh's processes).
# Elastic training also needs a control plane the collectives cannot
# provide: a host-side key-value surface for heartbeat leases,
# rendezvous membership, commit markers and generation fencing, which
# must keep working while the data-plane world is broken.  HostKVStore is
# that surface, one logical store per training cluster.  Every failure
# path is named: StoreTimeoutError for a bounded wait,
# BarrierTimeoutError for a barrier, StaleGenerationError for a fenced
# epoch, StoreRetriesExhaustedError when RetryingStore burns its retry
# budget on transient faults.
# ---------------------------------------------------------------------------


class StoreError(RuntimeError):
    """Base class for host-store failures (all named, never silent)."""


class TransientStoreError(StoreError):
    """A retryable store failure (connection blip, leader election in
    the backing service).  :class:`RetryingStore` retries exactly this
    class; anything else propagates immediately."""


class StoreTimeoutError(StoreError):
    """A bounded :meth:`HostKVStore.wait` expired without the key."""


class StoreRetriesExhaustedError(StoreError):
    """:class:`RetryingStore` burned its whole retry budget on
    transient faults — the store (or the network to it) is down, not
    blinking.  Carries the last transient error as ``__cause__``."""


class StaleGenerationError(StoreError):
    """A generation-fenced operation arrived with a stale epoch: the
    world has re-formed since this worker last participated.  A stale
    peer waking from a stall gets THIS, by name, instead of silently
    corrupting (or hanging) the new world."""


_MISSING = object()


class HostKVStore:
    """Thread-safe host-side coordination store (see block comment).

    Every ``set`` records a store-side monotonic stamp, so lease ages
    (:meth:`age`) are judged on ONE clock — worker clock skew can never
    fake a live peer.  ``generation`` is the cluster epoch: it only
    moves through :meth:`bump_generation` (compare-and-swap, so N
    survivors proposing concurrently coalesce onto one new epoch) and
    every epoch-carrying op goes through :meth:`check_generation`.
    """

    def __init__(self):
        self._cond = threading.Condition(threading.Lock())
        self._data: dict[str, object] = {}
        self._stamp: dict[str, float] = {}
        self._gen = 0

    # ---- the five verbs ----------------------------------------------

    def set(self, key: str, value) -> None:
        with self._cond:
            self._data[key] = value
            self._stamp[key] = time.monotonic()
            self._cond.notify_all()

    def get(self, key: str, default=_MISSING):
        with self._cond:
            if key in self._data:
                return self._data[key]
        if default is _MISSING:
            raise KeyError(key)
        return default

    def wait(self, key: str, timeout_s: float):
        """Block until ``key`` exists; named timeout instead of a hang."""
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while key not in self._data:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._cond.wait(remaining):
                    if key in self._data:      # woke on the final notify
                        break
                    raise StoreTimeoutError(
                        f"store key {key!r} did not appear within "
                        f"{timeout_s}s")
            return self._data[key]

    def add(self, key: str, delta: int = 1) -> int:
        """Atomic integer counter; returns the post-increment value."""
        with self._cond:
            value = int(self._data.get(key, 0)) + delta
            self._data[key] = value
            self._stamp[key] = time.monotonic()
            self._cond.notify_all()
            return value

    def delete(self, key: str) -> None:
        with self._cond:
            self._data.pop(key, None)
            self._stamp.pop(key, None)

    # ---- queries ------------------------------------------------------

    def keys(self, prefix: str = "") -> list[str]:
        with self._cond:
            return sorted(k for k in self._data if k.startswith(prefix))

    def age(self, key: str):
        """Seconds since ``key`` was last set (store clock), or None if
        the key has never been set — the lease-expiry primitive."""
        with self._cond:
            stamp = self._stamp.get(key)
        return None if stamp is None else time.monotonic() - stamp

    def newest_age(self, prefix: str):
        """Age of the most recently set key under ``prefix`` (None when
        empty) — how long a rendezvous round has been quiet."""
        with self._cond:
            stamps = [s for k, s in self._stamp.items()
                      if k.startswith(prefix)]
        return None if not stamps else time.monotonic() - max(stamps)

    # ---- state transfer (the WAL/snapshot hooks of the TCP server) ---

    def snapshot_state(self) -> tuple[dict, int]:
        """Consistent copy of (data, generation) — what a coordinator
        snapshot must persist.  Stamps are deliberately NOT part of the
        state: lease ages are judged on the live store's clock, and a
        recovered store re-stamps everything at recovery time (see
        :meth:`restore_state`)."""
        with self._cond:
            return dict(self._data), self._gen

    def restore_state(self, data: dict, gen: int) -> None:
        """Install recovered state.  Every key is re-stamped *now*: a
        store cannot judge lease staleness across its own outage, so
        recovery resets every age to zero — strictly conservative (no
        peer is declared dead because the COORDINATOR was down); a peer
        that really died during the outage stops beating and is
        re-detected one watchdog period after recovery."""
        with self._cond:
            self._data = dict(data)
            now = time.monotonic()
            self._stamp = {k: now for k in self._data}
            self._gen = int(gen)
            self._cond.notify_all()

    # ---- generation fencing ------------------------------------------

    @property
    def generation(self) -> int:
        with self._cond:
            return self._gen

    def bump_generation(self, expected: int) -> int:
        """Compare-and-swap epoch bump: advances only if the store is
        still at ``expected`` (so concurrent survivors proposing a
        re-rendezvous coalesce onto ONE new epoch).  Returns the
        current generation either way."""
        with self._cond:
            if self._gen == expected:
                self._gen = expected + 1
                self._cond.notify_all()
            return self._gen

    def check_generation(self, gen: int) -> None:
        with self._cond:
            current = self._gen
        if current != gen:
            raise StaleGenerationError(
                f"generation {gen} is stale: the store is at generation "
                f"{current} — this worker's world has been superseded")


def store_barrier(store, name: str, ranks, rank: int, gen: int = 0,
                  timeout_s: float = 30.0, poll_s: float = 0.01) -> None:
    """Generation-fenced barrier over a host store.

    Arrival keys carry the epoch, and the fence is checked both at
    arrival and while waiting: a stale-epoch arrival (or an epoch that
    advances mid-wait — the world re-formed without us) raises
    :class:`StaleGenerationError` by name, and a dead peer surfaces as
    the same named :class:`~dtdl_tpu_torch.runtime.bootstrap.
    BarrierTimeoutError` the device-plane barrier uses — never a hang.

    The poll is **deadline-sliced**: each sleep is bounded by the
    remaining budget, never a full fixed ``poll_s`` — a sub-watchdog
    ``timeout_s`` must expire ON TIME, not overshoot by a poll period
    (a barrier armed with a 50 ms budget inside a 200 ms watchdog that
    silently waited 1 s would defeat the watchdog arithmetic of the
    elastic layer's failure model).
    """
    store.check_generation(gen)
    store.set(f"bar/{gen}/{name}/{rank}", True)
    deadline = time.monotonic() + timeout_s
    while True:
        missing = [r for r in ranks
                   if store.get(f"bar/{gen}/{name}/{r}", None) is None]
        if not missing:
            return
        store.check_generation(gen)
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise BarrierTimeoutError(
                f"store barrier {name!r} (generation {gen}) timed out "
                f"after {timeout_s}s waiting for rank(s) {missing}")
        time.sleep(min(poll_s, remaining))


class RetryingStore:
    """Bounded-retry facade over a host store.

    Every verb is retried on :class:`TransientStoreError` with
    exponential backoff and seeded jitter (deterministic schedules for
    tests; jitter de-synchronizes a thundering herd of survivors
    hammering a recovering store).  The budget is BOUNDED: exhaustion
    raises :class:`StoreRetriesExhaustedError` naming the op and
    attempt count, with the last transient error chained.  Fencing and
    timeout errors are never retried — they are verdicts, not blips.
    """

    def __init__(self, store, retries: int = 5, backoff_s: float = 0.005,
                 max_backoff_s: float = 0.25, jitter: float = 0.5,
                 seed: int = 0):
        if retries < 0:
            raise ValueError(f"retries must be >= 0, got {retries}")
        self.store = store
        self.retries = retries
        self.backoff_s = backoff_s
        self.max_backoff_s = max_backoff_s
        self.jitter = jitter
        self._rng = np.random.default_rng(seed)

    def _call(self, op: str, *args, **kwargs):
        last = None
        for attempt in range(self.retries + 1):
            try:
                return getattr(self.store, op)(*args, **kwargs)
            except TransientStoreError as e:
                last = e
                if attempt < self.retries:
                    time.sleep(backoff_delay(
                        attempt, self.backoff_s, self.max_backoff_s,
                        float(self._rng.random()), self.jitter))
        raise StoreRetriesExhaustedError(
            f"store.{op} failed after {self.retries + 1} attempts; last "
            f"transient error: {last}") from last

    # the verbs + queries, each through the bounded-retry path
    def set(self, key, value):
        return self._call("set", key, value)

    def get(self, key, default=_MISSING):
        if default is _MISSING:
            return self._call("get", key)
        return self._call("get", key, default)

    def wait(self, key, timeout_s):
        return self._call("wait", key, timeout_s)

    def add(self, key, delta=1):
        return self._call("add", key, delta)

    def delete(self, key):
        return self._call("delete", key)

    def keys(self, prefix=""):
        return self._call("keys", prefix)

    def age(self, key):
        return self._call("age", key)

    def newest_age(self, prefix):
        return self._call("newest_age", prefix)

    # fencing delegates un-retried: a verdict must not be re-asked
    @property
    def generation(self):
        return self.store.generation

    def bump_generation(self, expected):
        return self.store.bump_generation(expected)

    def check_generation(self, gen):
        return self.store.check_generation(gen)


class KVStore:
    """MXNet-style key-value store over a mesh's processes.

    ``push`` stages this worker's value (a tensor or a tree of tensors)
    for a key and ``pull`` returns the cross-worker sum, in place on the
    pushed tensors, scaled (see the module docstring); ``init`` /
    ``pull_init`` hold host-level initial values, MXNet's ``kv.init(key,
    value)`` handshake where worker 0's value wins."""

    def __init__(self, kind: str = "local", axis: str = DATA_AXIS,
                 mesh=None, rescale: float | None = None):
        if kind not in VALID_KINDS:
            raise ValueError(
                f"unknown kvstore kind {kind!r}; one of {VALID_KINDS}")
        self.kind = kind
        self.axis = axis
        if mesh is None:
            mesh = (build_mesh() if kind.startswith("dist")
                    else local_mesh())
        self.mesh = mesh
        self._staged: dict[str, object] = {}
        self._init: dict[str, object] = {}
        self.rescale = rescale

    # ---- topology (MXNet kv.rank / kv.num_workers) -------------------------

    @property
    def rank(self) -> int:
        """This worker process's rank (MXNet's ``kv.rank``, for host-side
        data sharding ``data[rank::num_workers]``)."""
        return process_index()

    @property
    def num_workers(self) -> int:
        """Worker processes (MXNet: 1 for local/device stores, the dist
        world size for dist_*)."""
        return process_count() if self.kind.startswith("dist") else 1

    @property
    def aggregation_width(self) -> int:
        """Replicas summed by push/pull: the store's mesh-axis size."""
        return self.mesh.shape[self.axis]

    @property
    def distributed(self) -> bool:
        return self.aggregation_width > 1

    # ---- host-level init ---------------------------------------------------

    def init(self, key: str, value) -> None:
        """Register an initial value; worker 0's copy wins across hosts."""
        self._init[key] = collectives.host_broadcast(value)

    def pull_init(self, key: str):
        return self._init[key]

    # ---- push/pull ---------------------------------------------------------

    def push(self, key: str, value) -> None:
        """Stage this worker's contribution for ``key``."""
        self._staged[key] = value

    def pull(self, key: str, average: bool = False):
        """Aggregate the last pushed value across the store's workers.

        A **sum**, the MXNet contract; normalization is ``average=True``
        (divide by ``aggregation_width``) or the constructor's
        ``rescale``.  A width-1 store sums nothing and still scales, the
        same numbers on 1 worker as on N.  The pushed tensors are
        reduced and scaled in place and returned in the pushed
        structure."""
        value = self._staged.pop(key)
        leaves, spec = tree_flatten(value)
        if self.distributed:
            collectives.reduce_(leaves, self.mesh)
        for t in leaves:
            if average:
                t.div_(self.aggregation_width)
            elif self.rescale is not None and self.rescale != 1.0:
                t.mul_(self.rescale)
        return tree_unflatten(leaves, spec)

    def push_pull(self, key: str, value, average: bool = False):
        """One-shot push+pull (MXNet's fused ``pushpull``)."""
        self.push(key, value)
        return self.pull(key, average=average)


class KVStoreStrategy(DataParallel):
    """DataParallel whose gradient sync goes through a :class:`KVStore`:
    ``kvstore=`` in ``Module.fit``, the store owning aggregation and the
    strategy the rest.  A ``local``/``device`` store is this process's
    card; ``dist_*`` spans the launcher's world."""

    def __init__(self, kv: KVStore):
        super().__init__(kv.mesh, kv.axis)
        self.kv = kv

    def grad_sync(self, grads):
        return self.kv.push_pull("grad", grads, average=True)


def create(kind: str = "local", mesh=None, axis: str = DATA_AXIS) -> KVStore:
    """``mxnet.kv.create`` equivalent."""
    return KVStore(kind, axis=axis, mesh=mesh)


def kvstore_strategy(kv: KVStore | str = "local", mesh=None) -> Strategy:
    """Strategy for ``Module.fit(kvstore=...)``: :class:`SingleDevice`
    when the store spans one replica, else KVStore-backed data
    parallelism.  Takes a store or a kind string."""
    if isinstance(kv, str):
        kv = create(kv, mesh=mesh)
    if kv.aggregation_width == 1:
        return SingleDevice()
    return KVStoreStrategy(kv)
