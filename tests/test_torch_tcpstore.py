"""The port's TCP control-plane store (dtdl_tpu_torch/parallel/
tcpstore.py), the port of tests/test_tcpstore.py, plus its wire
compatibility with the JAX package's store.

The contracts, as the JAX suite's:

1. **only transients for the retry layer**: a connection dying under
   the k-th RPC, a blackholed request, a torn reply frame all surface as
   (subclasses of) ``TransientStoreError``; verdicts
   (``StoreTimeoutError``, ``StaleGenerationError``, ``ServerEpochError``)
   pass straight through.  Every edge is injected through ``store_site``.
2. **coordinator crash recovery**: the server killed mid-reply comes
   back from its WAL with keys, generation and epoch intact (lease ages
   re-stamped); compaction never double-applies an ``add``.
3. **the epoch fence**: a server restarted without its WAL is refused
   by name (``ServerEpochError``).
4. **the drill**: a 3-worker elastic world trains through the store
   while the coordinator is crashed and restarted: the world does not
   shrink, and the sample accounting stays exact.
5. **cross-wired** (the port's own cases): the JAX ``TCPStoreClient``
   against the port's server and the port's client against the JAX
   server, through the five verbs, the generation CAS, a torn frame and
   an amnesiac restart.  Both modules are framework-free; the frames
   and the numpy payloads are the same bytes.
"""

import os
import threading
import time

import numpy as np
import pytest

from dtdl_tpu_torch.data.sharding import GlobalBatchSampler
from dtdl_tpu_torch.obs import MetricsExporter, Observer
from dtdl_tpu_torch.parallel.kvstore import (RetryingStore,
                                       TransientStoreError)
from dtdl_tpu_torch.parallel.tcpstore import (STORE_ADDR_ENV, ServerEpochError,
                                        TCPStoreClient, TCPStoreServer,
                                        TornFrameError, connect)
from dtdl_tpu_torch.resil import (ElasticConfig, ElasticWorker, FaultPlan,
                            effective_sample_log, run_workers,
                            store_site)


@pytest.fixture
def server(tmp_path):
    """One WAL-backed server; the test restarts it at will.  Every
    server started through the factory is stopped at teardown."""
    started = []

    def factory(port=0, wal_dir=None, **kw):
        srv = TCPStoreServer(port=port, wal_dir=wal_dir, **kw).start()
        started.append(srv)
        return srv

    yield factory
    for s in started:
        s.stop()


def mk_client(addr, **kw):
    base = dict(connect_timeout_s=1.0, io_timeout_s=2.0,
                reconnect_attempts=4, backoff_s=0.005,
                max_backoff_s=0.05, wait_slice_s=0.1)
    base.update(kw)
    return TCPStoreClient(addr, **base)


def test_store_site_spelling():
    assert store_site("rpc") == "store.rpc"
    assert store_site("reply") == "store.reply"
    with pytest.raises(ValueError, match="unknown store fault point"):
        store_site("frame")


# ---------------------------------------------------------------------------
# socket-level fault injection: every edge a transient, by construction
# ---------------------------------------------------------------------------

@pytest.mark.faults
def test_disconnect_at_kth_rpc_reconnects_transparently(server):
    """The connection dies under exactly the k-th RPC.  For an
    IDEMPOTENT op the client reconnects and re-sends — the caller
    never sees the blip (only the books do); ``add`` is
    at-most-once-ambiguous, so IT surfaces the transient for the
    policy layer (RetryingStore) to own the at-least-once decision."""
    srv = server()
    obs = Observer(trace=True, sentinel=None)
    c = mk_client(srv.addr, observer=obs)
    c.set("k", 41)
    plan = FaultPlan().at(store_site("rpc"), 0, "raise")
    with plan:
        assert c.get("k") == 41             # transparent re-send
    assert plan.log == [(store_site("rpc"), 0, "raise")]
    m = c.metrics.summary()
    assert m["store_reconnects"] >= 1
    assert m["store_transient_errors"] >= 1
    names = {e["name"] for e in obs.tracer.to_chrome()["traceEvents"]
             if e.get("ph") == "i"}
    assert "store_reconnect" in names
    # the non-idempotent verb surfaces the SAME failure as a transient
    with FaultPlan().at(store_site("rpc"), 0, "raise"):
        with pytest.raises(TransientStoreError):
            c.add("ctr")
    # and through RetryingStore even that blip is invisible
    rs = RetryingStore(mk_client(srv.addr), retries=3, backoff_s=0.001)
    with FaultPlan().at(store_site("rpc"), 1, "raise"):
        rs.set("j", 7)
        assert rs.get("j") == 7


@pytest.mark.faults
def test_blackholed_rpc_times_out_into_transient(server):
    """The network eats the request: nothing is sent, the client's IO
    deadline expires — a bounded transient, never a hang."""
    srv = server()
    c = mk_client(srv.addr, io_timeout_s=0.15)
    c.set("k", 1)
    t0 = time.monotonic()
    with FaultPlan().at(store_site("rpc"), 0, "blackhole"):
        with pytest.raises(TransientStoreError):
            c.add("ctr")                    # non-idempotent: surfaces
    assert time.monotonic() - t0 < 2.0      # the IO deadline, not a hang
    assert c.metrics.summary()["store_timeouts"] >= 1
    assert c.get("k") == 1


@pytest.mark.faults
def test_torn_reply_frame_detected_by_name(server):
    srv = server()
    obs = Observer(trace=True, sentinel=None)
    c = mk_client(srv.addr, observer=obs)
    c.set("k", 5)
    # the server tears the reply to the add: half a frame, then EOF —
    # detected BY NAME (and still a TransientStoreError subclass, so a
    # policy layer that accepts at-least-once adds can retry it)
    with FaultPlan().at(store_site("reply"), 0, "torn"):
        with pytest.raises(TornFrameError):
            c.add("ctr")
    assert isinstance(TornFrameError("x"), TransientStoreError)
    assert c.get("k") == 5                      # connection recovered
    assert c.metrics.summary()["store_torn_frames"] == 1
    names = {e["name"] for e in obs.tracer.to_chrome()["traceEvents"]
             if e.get("ph") == "i"}
    assert "store_torn_frame" in names


def test_connect_refused_exhausts_bounded_backoff():
    c = TCPStoreClient("127.0.0.1:1", connect_timeout_s=0.2,
                       reconnect_attempts=2, backoff_s=0.001,
                       max_backoff_s=0.01)
    with pytest.raises(TransientStoreError, match="after 3 attempts"):
        c.get("k", None)


# ---------------------------------------------------------------------------
# WAL crash recovery + the epoch fence
# ---------------------------------------------------------------------------

@pytest.mark.faults
def test_coordinator_crash_recovers_from_wal(server, tmp_path):
    wal = str(tmp_path / "wal")
    srv = server(wal_dir=wal)
    port = srv.port
    c = mk_client(srv.addr)
    c.set("world/latest", (0, (0, 1)))
    c.add("ctr", 3)
    c.bump_generation(0)
    c.set("hb/0", 1)
    epoch0 = c.server_epoch
    # the coordinator dies mid-reply of the NEXT mutation: write-ahead
    # means the mutation is already applied + logged when the reply is
    # lost, so the retry after recovery is an idempotent re-set
    plan = FaultPlan().at(store_site("reply"), 0, "crash")
    with plan:
        with pytest.raises(TransientStoreError):
            c.set("committed", {"step": 4})
    assert srv.stopped.wait(5.0)
    assert plan.log == [(store_site("reply"), 0, "crash")]

    srv2 = server(port=port, wal_dir=wal)
    assert srv2.recovered and srv2.epoch == epoch0
    rs = RetryingStore(c, retries=6, backoff_s=0.01, max_backoff_s=0.1)
    # clients re-attach within their deadline; state is intact,
    # including the mutation whose reply the crash ate
    assert rs.get("world/latest") == (0, (0, 1))
    assert rs.get("ctr") == 3
    assert rs.get("committed") == {"step": 4}
    assert rs.generation == 1
    # lease ages re-stamped at recovery: nobody reads as dead because
    # the COORDINATOR was down
    assert 0 <= rs.age("hb/0") < 2.0
    assert c.server_epoch == epoch0


@pytest.mark.faults
def test_walless_restart_refused_by_epoch_name(server, tmp_path):
    srv = server(wal_dir=str(tmp_path / "wal_a"))
    port = srv.port
    obs = Observer(trace=True, sentinel=None)
    c = mk_client(srv.addr, observer=obs)
    c.set("k", 1)
    srv.stop(abort=True)
    # the server comes back WITHOUT its WAL: fresh epoch, empty state
    server(port=port, wal_dir=str(tmp_path / "wal_b"))
    rs = RetryingStore(c, retries=5, backoff_s=0.01)
    with pytest.raises(ServerEpochError, match="WITHOUT its WAL"):
        rs.get("k")                   # a verdict: NOT retried, named
    assert c.metrics.summary()["store_epoch_refusals"] >= 1
    names = {e["name"] for e in obs.tracer.to_chrome()["traceEvents"]
             if e.get("ph") == "i"}
    assert "store_epoch_refused" in names


def test_wal_compaction_never_double_applies(server, tmp_path):
    wal = str(tmp_path / "wal")
    srv = server(wal_dir=wal, snapshot_every=4)
    port = srv.port
    c = mk_client(srv.addr)
    for _ in range(10):
        c.add("ctr")                  # crosses two compactions
    c.bump_generation(0)
    srv.stop(abort=True)
    srv2 = server(port=port, wal_dir=wal, snapshot_every=4)
    assert srv2.recovered
    rs = RetryingStore(c, retries=6, backoff_s=0.01)
    assert rs.get("ctr") == 10        # seq filter: replay ∩ snapshot = ∅
    assert rs.generation == 1


def test_wal_exclude_prefixes_trades_durability_for_amplification(
        server, tmp_path):
    """The write-amplification lever: excluded (transient) prefixes
    are applied but never logged or snapshotted — they serve reads
    live and deliberately do NOT survive a coordinator restart."""
    wal = str(tmp_path / "wal")
    srv = server(wal_dir=wal, wal_exclude_prefixes=("g/",),
                 snapshot_every=2)
    port = srv.port
    c = mk_client(srv.addr)
    c.set("g/0/3/1", np.ones(4, np.float32))    # step-plane: transient
    c.set("ckpt/committed", {"step": 3})        # control-plane: durable
    for i in range(4):
        c.set(f"k{i}", i)                       # crosses a compaction
    np.testing.assert_array_equal(c.get("g/0/3/1"), np.ones(4))
    srv.stop(abort=True)
    srv2 = server(port=port, wal_dir=wal, wal_exclude_prefixes=("g/",))
    assert srv2.recovered
    rs = RetryingStore(c, retries=6, backoff_s=0.01)
    assert rs.get("ckpt/committed") == {"step": 3}
    assert [rs.get(f"k{i}") for i in range(4)] == list(range(4))
    assert rs.get("g/0/3/1", None) is None      # did not survive


def test_torn_wal_tail_truncates_replay(server, tmp_path):
    wal = str(tmp_path / "wal")
    srv = server(wal_dir=wal, snapshot_every=10 ** 6)
    port = srv.port
    c = mk_client(srv.addr)
    for i in range(5):
        c.set(f"k{i}", i)
    srv.stop(abort=True)
    # the crash happened mid-append: a torn record at the WAL tail
    with open(os.path.join(wal, "wal.log"), "ab") as f:
        f.write(b"\x00\x00\x01\x00partial")
    srv2 = server(port=port, wal_dir=wal)
    rs = RetryingStore(c, retries=6, backoff_s=0.01)
    assert [rs.get(f"k{i}") for i in range(5)] == list(range(5))


# ---------------------------------------------------------------------------
# wiring + observability
# ---------------------------------------------------------------------------

def test_connect_helper_reads_env(server, monkeypatch):
    srv = server()
    monkeypatch.setenv(STORE_ADDR_ENV, srv.addr)
    rs = connect(retries=2, backoff_s=0.001)
    assert isinstance(rs, RetryingStore)
    rs.set("via_env", True)
    assert rs.get("via_env") is True
    monkeypatch.delenv(STORE_ADDR_ENV)
    with pytest.raises(ValueError, match="no store address"):
        connect()


def test_client_metrics_are_an_exporter_window_source(server):
    srv = server()
    c = mk_client(srv.addr)
    for i in range(8):
        c.set(f"k{i}", i)
    exp = MetricsExporter(interval_s=0.0)
    exp.add_source("", c.metrics.window)
    p1 = exp.sample(force=True)
    assert p1["store_rpcs"] >= 8
    assert p1["store_rpc_p99_ms"] > 0
    # window deltas: an idle window reports zero new RPCs
    p2 = exp.sample(force=True)
    assert p2["store_rpcs"] == 0
    # cumulative books untouched by windowing
    assert c.metrics.summary()["store_rpcs"] >= 8
    exp.close()


# ---------------------------------------------------------------------------
# THE tier-1 coordinator-crash drill: an elastic world rides out a
# coordinator kill + restart mid-run, through real sockets
# ---------------------------------------------------------------------------

# tiny pure-host training problem: rank-ordered float64 sums keep the
# timeline bitwise deterministic (the torch step's bitwise shrink is
# tests/test_torch_elastic.py's)
N, DIM, GBATCH, STEPS = 48, 8, 12, 8
_RNG = np.random.default_rng(0)
X = _RNG.normal(size=(N, DIM))
Y = _RNG.normal(size=(N,))


def init_fn():
    return {"w": np.zeros(DIM, np.float64)}


def grad_fn(state, batch):
    err = batch["x"] @ state["w"] - batch["y"]
    return {"w": batch["x"].T @ err}


def apply_fn(state, total, world_size):
    return {"w": state["w"] - 0.05 * total["w"] / world_size}


def batch_fn(idx):
    return {"x": X[idx], "y": Y[idx]}


def mk_worker(store, rank, ckpt_dir, cfg, steps=STEPS):
    return ElasticWorker(store, rank, init_fn=init_fn, grad_fn=grad_fn,
                         apply_fn=apply_fn, batch_fn=batch_fn,
                         sampler=GlobalBatchSampler(N, GBATCH, seed=3),
                         total_steps=steps, cfg=cfg, ckpt_dir=ckpt_dir,
                         audit_samples=True)


@pytest.mark.elastic
@pytest.mark.faults
def test_e2e_coordinator_killed_and_restarted_mid_run(server, tmp_path):
    """3 workers train through the TCP store; ``store_site('reply',
    'crash')`` kills the coordinator at its 120th reply (mid-training
    by construction: the run makes >400 replies).  A restarter thread
    brings it back from the WAL the moment ``stopped`` fires — no
    sleeps as synchronization.  Workers ride the outage inside their
    retry budgets: the run completes, the world NEVER shrinks
    (coordinator downtime is not peer death — the recovery re-stamp
    guarantees it), and the consumed-sample accounting is exact."""
    wal = str(tmp_path / "wal")
    srv = server(wal_dir=wal)
    port = srv.port
    cfg = ElasticConfig(heartbeat_s=0.03, watchdog_s=1.0,
                        step_timeout_s=15.0, join_grace_s=0.2,
                        rendezvous_timeout_s=20.0, snapshot_every=2)
    clients = [mk_client(srv.addr, reconnect_attempts=8,
                         max_backoff_s=0.1) for _ in range(3)]
    ws = [mk_worker(RetryingStore(c, retries=10, backoff_s=0.01,
                                  max_backoff_s=0.1, seed=r), r,
                    str(tmp_path / "ck"), cfg)
          for r, c in enumerate(clients)]
    os.makedirs(str(tmp_path / "ck"), exist_ok=True)

    restarted = []

    def restarter():
        if srv.stopped.wait(30.0):
            restarted.append(server(port=port, wal_dir=wal))

    rt = threading.Thread(target=restarter, daemon=True)
    rt.start()
    plan = FaultPlan().at(store_site("reply"), 120, "crash")
    with plan:
        run_workers(ws, timeout_s=90)
    rt.join(5)

    assert plan.log == [(store_site("reply"), 120, "crash")]
    assert restarted and restarted[0].recovered
    for w in ws:
        assert w.done and w.error is None
        # the coordinator outage must NOT read as peer death: the
        # bootstrap world survives at generation 0, full size
        assert w.world.generation == 0 and w.world.ranks == (0, 1, 2)
    # clients really crossed the outage (at least one reconnect rode it)
    assert sum(c.metrics.summary()["store_reconnects"]
               for c in clients) >= 1
    # zero lost, zero double-counted across the coordinator outage
    eff = effective_sample_log(ws)
    sampler = GlobalBatchSampler(N, GBATCH, seed=3)
    assert sorted(eff) == list(range(STEPS))
    for step, consumed in eff.items():
        np.testing.assert_array_equal(
            consumed, np.sort(sampler.batch_indices(step)))


# ---------------------------------------------------------------------------
# cross-wired: a JAX client against the port's server, and the reverse
# ---------------------------------------------------------------------------

import types  # noqa: E402

import dtdl_tpu.parallel.kvstore as jax_kv  # noqa: E402
import dtdl_tpu.parallel.tcpstore as jax_tcp  # noqa: E402
import dtdl_tpu.resil.faults as jax_faults  # noqa: E402
import dtdl_tpu_torch.parallel.kvstore as port_kv  # noqa: E402
import dtdl_tpu_torch.parallel.tcpstore as port_tcp  # noqa: E402
import dtdl_tpu_torch.resil.faults as port_faults  # noqa: E402

# direction -> (client's tcpstore, client's kvstore (its errors), the
# server's tcpstore, the server's fault harness)
WIRES = {"jax_client-port_server": (jax_tcp, jax_kv, port_tcp, port_faults),
         "port_client-jax_server": (port_tcp, port_kv, jax_tcp, jax_faults)}


@pytest.fixture(params=sorted(WIRES))
def wired(request):
    client_tcp, client_kv, server_tcp, server_faults = WIRES[request.param]
    started = []

    def start(port=0, wal_dir=None):
        srv = server_tcp.TCPStoreServer(port=port, wal_dir=wal_dir).start()
        started.append(srv)
        return srv

    def client(addr, **kw):
        base = dict(connect_timeout_s=1.0, io_timeout_s=2.0,
                    reconnect_attempts=3, backoff_s=0.005,
                    max_backoff_s=0.05, wait_slice_s=0.1)
        base.update(kw)
        return client_tcp.TCPStoreClient(addr, **base)

    yield types.SimpleNamespace(start=start, client=client, kv=client_kv,
                                tcp=client_tcp, faults=server_faults)
    for s in started:
        s.stop()


def test_cross_wired_five_verbs_ages_and_numpy_trees(wired):
    c = wired.client(wired.start().addr)
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": np.float64(0.25), "meta": (1, "adam")}
    c.set("g/0/0/1", tree)
    out = c.get("g/0/0/1")
    np.testing.assert_array_equal(out["w"], tree["w"])
    assert out["w"].dtype == np.float32
    assert out["b"] == tree["b"] and out["meta"] == (1, "adam")
    assert c.get("missing", None) is None
    with pytest.raises(KeyError):
        c.get("missing")
    assert c.add("ctr") == 1 and c.add("ctr", 2) == 3
    c.delete("g/0/0/1")
    assert c.get("g/0/0/1", None) is None
    c.set("hb/0", 1)
    c.set("hb/1", 1)
    assert c.keys("hb/") == ["hb/0", "hb/1"]
    assert 0 <= c.newest_age("hb/") <= c.age("hb/0") < 1.0
    with pytest.raises(wired.kv.StoreTimeoutError, match="did not appear"):
        c.wait("never", timeout_s=0.05)
    threading.Timer(0.05, lambda: c.set("late", 7)).start()
    assert c.wait("late", timeout_s=2.0) == 7


def test_cross_wired_generation_cas_and_fence(wired):
    c = wired.client(wired.start().addr)
    assert c.generation == 0
    assert c.bump_generation(0) == 1
    assert c.bump_generation(0) == 1           # a stale proposal: no-op
    c.check_generation(1)
    with pytest.raises(wired.kv.StaleGenerationError, match="stale"):
        c.check_generation(0)


def test_cross_wired_torn_frame_is_named(wired):
    """The server (of the other package) tears its reply to an ``add``:
    the client names it with its own TornFrameError, then recovers."""
    c = wired.client(wired.start().addr)
    c.set("k", 5)
    with wired.faults.FaultPlan().at(wired.faults.store_site("reply"), 0,
                                     "torn"):
        with pytest.raises(wired.tcp.TornFrameError):
            c.add("ctr")
    assert c.get("k") == 5
    assert c.metrics.summary()["store_torn_frames"] == 1


def test_cross_wired_wal_restart_resumes_and_amnesia_is_refused(
        wired, tmp_path):
    """A server of the other package restarted from its WAL keeps the
    client's epoch and state; one restarted without it is refused by
    name with the client's ServerEpochError."""
    wal = str(tmp_path / "wal")
    srv = wired.start(wal_dir=wal)
    port = srv.port
    c = wired.client(srv.addr)
    c.set("ckpt/committed", {"step": 4, "path": "p"})
    c.bump_generation(0)
    epoch = c.server_epoch
    srv.stop(abort=True)
    srv2 = wired.start(port=port, wal_dir=wal)
    assert srv2.recovered and srv2.epoch == epoch
    rs = wired.kv.RetryingStore(c, retries=6, backoff_s=0.01)
    assert rs.get("ckpt/committed") == {"step": 4, "path": "p"}
    assert rs.generation == 1
    srv2.stop(abort=True)
    wired.start(port=port, wal_dir=str(tmp_path / "elsewhere"))
    with pytest.raises(wired.tcp.ServerEpochError, match="WITHOUT its WAL"):
        rs.get("ckpt/committed")
