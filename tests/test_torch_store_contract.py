"""The port's control-plane store contract, the port of
tests/test_store_contract.py: every test runs over both of the port's
backends through one fixture,

* ``host``: the in-process :class:`HostKVStore` (threads sharing one
  dict);
* ``tcp``: a :class:`TCPStoreServer` on localhost with a
  :class:`TCPStoreClient` over stdlib sockets
  (``dtdl_tpu_torch/parallel/tcpstore.py``),

and the elastic primitives (heartbeat leases, ``dead_peers``,
``rendezvous``, ``exchange_grads``) run over both, so the five verbs,
the ages and the generation CAS are the whole contract
``dtdl_tpu_torch/resil/elastic.py`` needs.  The same assertions as the
JAX suite's; the timing bounds are its own (a 0.15 s barrier and a 0.1 s
wait expire well inside 0.6 and 0.5 s).  The stores are framework-free
on both sides; the cross-wired cases (a JAX client against the port's
server and the reverse) are in tests/test_torch_tcpstore.py.
"""

import threading
import time

import numpy as np
import pytest

from dtdl_tpu_torch.parallel.kvstore import (HostKVStore, RetryingStore,
                                       StaleGenerationError,
                                       StoreRetriesExhaustedError,
                                       StoreTimeoutError,
                                       TransientStoreError, store_barrier)
from dtdl_tpu_torch.parallel.tcpstore import TCPStoreClient, TCPStoreServer
from dtdl_tpu_torch.resil import (ElasticConfig, PeerLostError,
                            RendezvousError, World, dead_peers,
                            exchange_grads, rendezvous)
from dtdl_tpu_torch.resil.elastic import HeartbeatLease
from dtdl_tpu_torch.runtime.bootstrap import BarrierTimeoutError

BACKENDS = ("host", "tcp")


@pytest.fixture(params=BACKENDS)
def make_store(request):
    """Factory for a fresh, empty store of the parameterized backend.
    For ``tcp`` each call starts its own localhost server; the client
    returned is the drop-in object (per-thread connections, so the
    multi-threaded scenarios below share one client per logical store,
    as the elastic workers do)."""
    servers = []

    def factory(**client_kw):
        if request.param == "host":
            return HostKVStore()
        srv = TCPStoreServer().start()
        servers.append(srv)
        return TCPStoreClient(srv.addr, **client_kw)

    factory.backend = request.param
    yield factory
    for s in servers:
        s.stop()


class FlakyStore:
    """Seeded transient-failure wrapper: each op fails with
    ``TransientStoreError`` with probability ``rate`` (deterministic
    per seed) — the harness for the RetryingStore contract, over
    either backend."""

    def __init__(self, store, rate=0.5, seed=0):
        self.store = store
        self.rate = rate
        self._rng = np.random.default_rng(seed)
        self.failures = 0

    def __getattr__(self, name):
        inner = getattr(self.store, name)
        if not callable(inner):
            return inner

        def wrapped(*a, **kw):
            if self._rng.random() < self.rate:
                self.failures += 1
                raise TransientStoreError(f"injected blip in {name}")
            return inner(*a, **kw)
        return wrapped

    @property
    def generation(self):
        return self.store.generation


# ---------------------------------------------------------------------------
# the five verbs + store-side lease stamps
# ---------------------------------------------------------------------------


def test_verbs_and_lease_ages(make_store):
    s = make_store()
    s.set("a", {"x": 1})
    assert s.get("a") == {"x": 1}
    assert s.get("missing", None) is None
    with pytest.raises(KeyError):
        s.get("missing")
    assert s.add("ctr") == 1 and s.add("ctr", 2) == 3
    s.delete("a")
    assert s.get("a", None) is None
    s.set("p/1", 1)
    s.set("p/2", 2)
    assert s.keys("p/") == ["p/1", "p/2"]
    # store-side stamps: ages are judged on ONE clock (the server's,
    # for tcp — a client's clock skew can never fake a live peer)
    assert s.age("nope") is None and s.newest_age("q/") is None
    assert 0 <= s.age("p/2") < 1.0
    assert 0 <= s.newest_age("p/") <= s.age("p/1")


def test_values_roundtrip_numpy_trees(make_store):
    """Gradient trees (the exchange payload) survive the backend: what
    comes back equals what went in, bit for bit."""
    s = make_store()
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": np.float64(0.25), "meta": (1, "adam")}
    s.set("g", tree)
    out = s.get("g")
    np.testing.assert_array_equal(out["w"], tree["w"])
    assert out["w"].dtype == np.float32
    assert out["b"] == tree["b"] and out["meta"] == (1, "adam")


def test_wait_blocks_and_times_out_by_name(make_store):
    s = make_store()
    with pytest.raises(StoreTimeoutError, match="did not appear"):
        s.wait("k", timeout_s=0.05)
    threading.Timer(0.05, lambda: s.set("k", 7)).start()
    assert s.wait("k", timeout_s=2.0) == 7


# ---------------------------------------------------------------------------
# generation CAS + fencing + the fenced barrier
# ---------------------------------------------------------------------------


def test_generation_cas_coalesces_and_fences(make_store):
    s = make_store()
    assert s.generation == 0
    # N survivors proposing concurrently land on ONE new epoch
    assert s.bump_generation(0) == 1
    assert s.bump_generation(0) == 1       # stale proposal: no-op
    s.check_generation(1)
    with pytest.raises(StaleGenerationError, match="generation 0 is "
                                                   "stale"):
        s.check_generation(0)


def test_store_barrier_fences_stale_epoch_and_names_dead_peers(
        make_store):
    s = make_store()
    # a stale-epoch ARRIVAL is rejected by name (never corrupts the
    # current world's barrier)
    s.bump_generation(0)
    with pytest.raises(StaleGenerationError):
        store_barrier(s, "sync", ranks=(0, 1), rank=0, gen=0)
    # happy path at the current epoch
    done = []

    def arrive(r):
        store_barrier(s, "sync", ranks=(0, 1), rank=r, gen=1,
                      timeout_s=5.0)
        done.append(r)

    ts = [threading.Thread(target=arrive, args=(r,)) for r in (0, 1)]
    [t.start() for t in ts]
    [t.join(10) for t in ts]
    assert sorted(done) == [0, 1]
    # a dead peer surfaces as the named barrier timeout, not a hang
    with pytest.raises(BarrierTimeoutError, match=r"rank\(s\) \[3\]"):
        store_barrier(s, "sync2", ranks=(0, 3), rank=0, gen=1,
                      timeout_s=0.1)
    # an epoch bumped MID-WAIT fences the waiter out by name
    t = threading.Timer(0.05, lambda: s.bump_generation(1))
    t.start()
    with pytest.raises(StaleGenerationError):
        store_barrier(s, "sync3", ranks=(0, 9), rank=0, gen=1,
                      timeout_s=5.0)


# ---------------------------------------------------------------------------
# RetryingStore: bounded retries over either backend
# ---------------------------------------------------------------------------


def test_retrying_store_bounded_retries_succeed_then_exhaust(make_store):
    # rate 0.5, seed 0: transient blips succeed within the budget
    flaky = FlakyStore(make_store(), rate=0.5, seed=0)
    rs = RetryingStore(flaky, retries=5, backoff_s=0.001, seed=1)
    for i in range(20):
        rs.set(f"k{i}", i)
        assert rs.get(f"k{i}") == i
    assert rs.add("ctr") == 1
    assert flaky.failures > 0            # the schedule really injected
    # a permanently down store exhausts the bounded budget BY NAME,
    # chaining the last transient error
    dead = FlakyStore(make_store(), rate=1.0, seed=2)
    rs2 = RetryingStore(dead, retries=3, backoff_s=0.001, seed=1)
    with pytest.raises(StoreRetriesExhaustedError,
                       match="after 4 attempts") as ei:
        rs2.get("k", None)
    assert isinstance(ei.value.__cause__, TransientStoreError)
    assert dead.failures == 4
    # verdicts are never retried: fencing passes straight through
    clean = RetryingStore(make_store(), retries=3, backoff_s=0.001)
    with pytest.raises(StaleGenerationError):
        clean.check_generation(5)


# ---------------------------------------------------------------------------
# elastic primitives: leases, rendezvous, exchange — over both backends
# ---------------------------------------------------------------------------


def test_heartbeat_lease_and_dead_peers(make_store):
    store = make_store()
    lease = HeartbeatLease(store, 0, heartbeat_s=0.02).start()
    try:
        assert dead_peers(store, [0], watchdog_s=0.3) == ()
        # a rank that never beat is dead from the start
        assert dead_peers(store, [0, 7], watchdog_s=0.3) == (7,)
    finally:
        lease.stop()
    time.sleep(0.35)
    assert dead_peers(store, [0], watchdog_s=0.3) == (0,)


def test_rendezvous_forms_world_and_fences_late_joiner(make_store):
    store = make_store()
    cfg = ElasticConfig(join_grace_s=0.1, rendezvous_timeout_s=5.0)
    got = {}

    def join(rank):
        got[rank] = rendezvous(store, rank, cfg)

    ts = [threading.Thread(target=join, args=(r,)) for r in (0, 1)]
    [t.start() for t in ts]
    [t.join(10) for t in ts]
    assert got[0].ranks == got[1].ranks == (0, 1)
    assert got[0].generation == 0
    assert got[0].is_leader and not got[1].is_leader
    # a worker arriving after bootstrap closed is refused BY NAME
    with pytest.raises(StaleGenerationError, match="fenced out"):
        rendezvous(store, 2, cfg)


def test_rendezvous_below_min_world_fails_by_name(make_store):
    store = make_store()
    cfg = ElasticConfig(min_world=2, join_grace_s=0.05,
                        rendezvous_timeout_s=0.4)
    with pytest.raises(RendezvousError, match="min_world"):
        rendezvous(store, 0, cfg)


def test_exchange_sums_in_rank_order(make_store):
    store = make_store()
    cfg = ElasticConfig(heartbeat_s=0, step_timeout_s=5.0)
    outs = {}

    def member(rank):
        w = World(0, (0, 1, 2), rank)
        outs[rank] = exchange_grads(
            store, w, 0, {"g": np.full(2, float(rank + 1), np.float32)},
            cfg)

    ts = [threading.Thread(target=member, args=(r,)) for r in range(3)]
    [t.start() for t in ts]
    [t.join(10) for t in ts]
    for r in range(3):
        np.testing.assert_array_equal(outs[r]["g"],
                                      np.full(2, 6.0, np.float32))


def test_exchange_deadline_names_the_missing_peer(make_store):
    """Wedged-peer path: lease checks off, the other rank never posts —
    the step aborts at the deadline naming exactly the missing rank."""
    store = make_store()
    world = World(0, (0, 1), 0)
    cfg = ElasticConfig(heartbeat_s=0, step_timeout_s=0.2, poll_s=0.02)
    with pytest.raises(PeerLostError) as ei:
        exchange_grads(store, world, 0, {"w": np.ones(2, np.float32)},
                       cfg)
    assert ei.value.lost == (1,)
    assert "deadline" in str(ei.value)


# ---------------------------------------------------------------------------
# the deadline-slicing fix (satellite): sub-watchdog timeouts expire
# ON TIME, never a full poll period late
# ---------------------------------------------------------------------------


def test_barrier_timeout_does_not_overshoot_by_poll_period(make_store):
    """A 0.15s barrier budget with a 2s poll interval must still expire
    at ~0.15s: the sleep is sliced by the remaining budget.  Before the
    fix this waited the full ``poll_s`` — a sub-watchdog barrier could
    overshoot its own watchdog."""
    s = make_store()
    t0 = time.monotonic()
    with pytest.raises(BarrierTimeoutError):
        store_barrier(s, "b", ranks=(0, 1), rank=0, gen=0,
                      timeout_s=0.15, poll_s=2.0)
    elapsed = time.monotonic() - t0
    assert elapsed < 0.6, f"barrier overshot its budget: {elapsed:.3f}s"


def test_wait_timeout_does_not_overshoot(make_store):
    """Same bound for ``wait``: a 0.1s budget expires at ~0.1s on both
    backends (the TCP client slices its server-side waits by the
    remaining budget, so the last slice is short, not a full
    ``wait_slice_s``)."""
    s = make_store()
    t0 = time.monotonic()
    with pytest.raises(StoreTimeoutError):
        s.wait("never", timeout_s=0.1)
    elapsed = time.monotonic() - t0
    assert elapsed < 0.5, f"wait overshot its budget: {elapsed:.3f}s"
