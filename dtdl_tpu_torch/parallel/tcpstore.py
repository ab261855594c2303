"""TCP control-plane store, the port's copy of
dtdl_tpu/parallel/tcpstore.py: the multi-process backing of the
five-verb store protocol, with a crash-recoverable coordinator.

The elastic training plane (:mod:`dtdl_tpu_torch.resil.elastic`) runs
over :class:`~dtdl_tpu_torch.parallel.kvstore.HostKVStore` (threads
sharing one dict) or over this store: the same five verbs (set / get /
wait / add / delete), store-side age stamps, the generation CAS and the
fenced ``store_barrier``, held to one contract by
tests/test_torch_store_contract.py.  The module is framework-free (the
stdlib and numpy), and its frames are the JAX module's byte for byte, so
a JAX client can use a port server and a port client a JAX server; values
on the wire are plain Python and numpy trees, never tensors.

* **wire protocol** — length-prefixed frames (4-byte big-endian length
  + pickled payload) over plain stdlib sockets.  A short read is a
  *torn frame*, detected and named (:class:`TornFrameError`) — never a
  silent mis-parse.  Pickle is acceptable here for the same reason it
  is in PyTorch's TCPStore: the control plane lives inside the
  training cluster's trust boundary (bind to the cluster-internal
  interface; this is not an internet-facing service).
* **client** (:class:`TCPStoreClient`) — drops in wherever
  ``HostKVStore`` is accepted: the five verbs, the queries, and the
  generation surface, each one RPC.  Every RPC has a connect deadline
  and an IO deadline; connection failures (refused, reset, timed out,
  torn) close the socket, reconnect with bounded jittered backoff
  (:func:`~dtdl_tpu_torch.runtime.bootstrap.backoff_delay` — THE formula),
  and surface only :class:`~dtdl_tpu_torch.parallel.kvstore.
  TransientStoreError`, so the :class:`RetryingStore` semantics carry
  over: transients are retried, verdicts
  (:class:`StoreTimeoutError`, :class:`StaleGenerationError`,
  :class:`ServerEpochError`) never are.  ``wait`` is deadline-sliced:
  the server blocks at most ``wait_slice_s`` per RPC and the client
  re-issues with the *remaining* budget, so a sub-watchdog timeout
  expires on time instead of overshooting by a poll period, and a
  coordinator outage mid-wait surfaces as a transient the caller's
  retry budget absorbs.  Sockets are **per-thread** (a heartbeat
  daemon and the step loop share one client object without locking —
  each thread holds its own connection).
* **server** (:class:`TCPStoreServer`) — a thread-per-connection
  acceptor over one :class:`HostKVStore` (the contract's reference
  implementation IS the server's state), with coordinator crash
  recovery:

  - every mutation (set / add / delete / generation bump) is appended
    to a WAL *before* it is applied; a periodic snapshot compacts the
    log (records carry sequence numbers, so a crash between snapshot
    and truncate never double-applies an ``add``);
  - a restarted server rehydrates keys + generation from snapshot +
    WAL, **re-stamping every lease at recovery time** — the store
    cannot judge staleness across its own outage, so recovery is
    conservative: nobody is declared dead because the *coordinator*
    was down (a peer that really died stops beating and is
    re-detected one watchdog period later);
  - a **server epoch** token is minted at first boot and persisted
    with the state.  A server that comes back *without* its WAL mints
    a fresh epoch; clients pin the epoch at first contact and every
    reconnect re-handshakes it, so an amnesiac coordinator is refused
    by name (:class:`ServerEpochError` — a verdict, never retried)
    instead of silently rejoined with empty state (which would read
    as "every peer is dead and the generation is 0" — the exact
    split-brain this token exists to prevent).

Every socket-level edge is deterministically injectable through
:func:`~dtdl_tpu_torch.resil.faults.store_site` (disconnect at the k-th RPC,
torn reply frame, blackholed request, connect-refused, coordinator
crash mid-reply), and the client keeps RPC latency tails
(obs/hist.py) plus reconnect/timeout/torn counters exportable as a
``MetricsExporter`` window source.
"""

from __future__ import annotations

import os
import pickle
import socket
import struct
import threading
import time
import uuid
from typing import Optional

import numpy as np

from dtdl_tpu_torch.obs.hist import LogHistogram
from dtdl_tpu_torch.obs.observer import NULL_OBSERVER
from dtdl_tpu_torch.parallel.kvstore import (
    HostKVStore, RetryingStore, StaleGenerationError, StoreError,
    StoreTimeoutError, TransientStoreError,
)
from dtdl_tpu_torch.resil.faults import (InjectedCrash, InjectedFault, fire,
                                   store_site)
from dtdl_tpu_torch.runtime.bootstrap import backoff_delay

_MISSING = object()

# env var every launcher threads through to its workers (launch/local
# sets it on children, launch/slurm exports it from the sbatch script,
# runtime.initialize(store_addr=...) publishes it) — one spelling, so
# `connect()` below works identically under every launch path
STORE_ADDR_ENV = "DTDL_STORE_ADDR"


class TornFrameError(TransientStoreError):
    """A frame arrived torn: the peer closed (or the connection died)
    mid-frame, leaving a partial length prefix or payload.  Named so a
    half-written reply is never mis-parsed as data — and transient,
    because a reconnect re-establishes framing from a clean boundary."""


class ServerEpochError(StoreError):
    """The server's epoch token does not match the one this client
    pinned at first contact: the coordinator restarted WITHOUT its WAL
    and is running with amnesiac state.  A verdict, never retried —
    rejoining an empty store would read as "all peers dead, generation
    0" and corrupt every survivor's view.  The operator must restore
    the WAL (or restart the world)."""


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------

_LEN = struct.Struct(">I")
MAX_FRAME = 256 * 1024 * 1024        # sanity bound: a corrupt length
                                     # prefix must not allocate the heap


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            if buf:
                raise TornFrameError(
                    f"connection closed mid-frame: got {len(buf)} of "
                    f"{n} bytes")
            raise ConnectionError("connection closed")
        buf += chunk
    return bytes(buf)


def send_frame(sock: socket.socket, obj) -> None:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_LEN.pack(len(payload)) + payload)


def recv_frame(sock: socket.socket):
    header = _recv_exact(sock, _LEN.size)
    (n,) = _LEN.unpack(header)
    if n > MAX_FRAME:
        raise TornFrameError(
            f"frame length {n} exceeds the {MAX_FRAME}-byte bound — "
            f"corrupt length prefix or desynchronized framing")
    return pickle.loads(_recv_exact(sock, n))


# verdicts crossing the wire: (kind tag on the wire) <-> (named error)
_ERR_TO_WIRE = {
    StoreTimeoutError: "timeout",
    StaleGenerationError: "stale",
    KeyError: "key",
    ValueError: "value",
    ServerEpochError: "epoch",
}
_WIRE_TO_ERR = {v: k for k, v in _ERR_TO_WIRE.items()}


# ---------------------------------------------------------------------------
# client-side metrics (satellite: store observability)
# ---------------------------------------------------------------------------


class StoreClientMetrics:
    """Host-side books of one :class:`TCPStoreClient`: RPC latency
    tails in a fixed-memory :class:`LogHistogram` plus the failure
    counters (reconnects, IO timeouts, torn frames, transient errors,
    epoch refusals).  ``window()`` returns counter *deltas* since the
    last window with the tails as current-value gauges — the same
    delta-vs-gauge split the serve metrics feed a ``MetricsExporter``
    with; ``summary()`` stays cumulative."""

    COUNTERS = ("rpcs", "reconnects", "timeouts", "torn_frames",
                "transient_errors", "epoch_refusals")

    def __init__(self):
        self.hist = LogHistogram()
        self._lock = threading.Lock()
        self._counts = {k: 0 for k in self.COUNTERS}
        self._last = {k: 0 for k in self.COUNTERS}

    def observe(self, seconds: float) -> None:
        with self._lock:
            self._counts["rpcs"] += 1
            self.hist.add(seconds)

    def count(self, name: str) -> None:
        with self._lock:
            self._counts[name] += 1

    def window(self) -> dict:
        with self._lock:
            out = {}
            for k in self.COUNTERS:
                out[f"store_{k}"] = self._counts[k] - self._last[k]
                self._last[k] = self._counts[k]
            if self.hist.n:
                out["store_rpc_p50_ms"] = round(self.hist.p50 * 1e3, 6)
                out["store_rpc_p95_ms"] = round(self.hist.p95 * 1e3, 6)
                out["store_rpc_p99_ms"] = round(self.hist.p99 * 1e3, 6)
            return out

    def summary(self) -> dict:
        with self._lock:
            out = {f"store_{k}": v for k, v in self._counts.items()}
            out.update(self.hist.summary(prefix="store_rpc_", unit=1e3))
            return out


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------


class TCPStoreClient:
    """Socket client for :class:`TCPStoreServer` — a drop-in for
    :class:`HostKVStore` (module docstring).  Thread-safe via
    per-thread connections; wrap in :class:`RetryingStore` for the
    bounded-retry facade exactly as with the host store."""

    def __init__(self, addr: str, *, connect_timeout_s: float = 2.0,
                 io_timeout_s: float = 5.0, reconnect_attempts: int = 8,
                 backoff_s: float = 0.02, max_backoff_s: float = 0.5,
                 jitter: float = 0.5, seed: int = 0,
                 wait_slice_s: float = 0.25, rpc_retries: int = 2,
                 observer=None,
                 metrics: Optional[StoreClientMetrics] = None):
        host, _, port = addr.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"store address must be host:port, "
                             f"got {addr!r}")
        self.addr = addr
        self._host, self._port = host, int(port)
        self.connect_timeout_s = connect_timeout_s
        self.io_timeout_s = io_timeout_s
        self.reconnect_attempts = reconnect_attempts
        self.backoff_s = backoff_s
        self.max_backoff_s = max_backoff_s
        self.jitter = jitter
        self.wait_slice_s = wait_slice_s
        self.rpc_retries = rpc_retries
        self.observer = observer or NULL_OBSERVER
        self.metrics = metrics or StoreClientMetrics()
        # the jitter rng is shared across threads (per-thread sockets,
        # ONE client) and np.random.Generator is not thread-safe —
        # draws are serialized so concurrent reconnects (hb daemon +
        # step loop after a coordinator restart) can't corrupt the
        # state or break the seeded-determinism contract
        self._rng = np.random.default_rng(seed)
        self._rng_lock = threading.Lock()
        self._local = threading.local()
        # the pinned server epoch: set at first successful handshake,
        # checked on every reconnect (None until first contact)
        self.server_epoch: Optional[str] = None
        self._epoch_lock = threading.Lock()

    # ---- connection management ---------------------------------------

    def _connect(self) -> socket.socket:
        """One connect + epoch handshake, with bounded jittered backoff
        across attempts.  Raises :class:`TransientStoreError` when the
        budget exhausts, :class:`ServerEpochError` (a verdict) when the
        server answers with a foreign epoch."""
        last: Optional[BaseException] = None
        for attempt in range(self.reconnect_attempts + 1):
            sock = None
            try:
                fire(store_site("connect"))
                sock = socket.create_connection(
                    (self._host, self._port),
                    timeout=self.connect_timeout_s)
                sock.settimeout(self.io_timeout_s)
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY,
                                1)
                with self._epoch_lock:
                    expected = self.server_epoch
                send_frame(sock, ("hello", (expected,)))
                epoch = self._decode(recv_frame(sock))
                with self._epoch_lock:
                    if self.server_epoch is None:
                        self.server_epoch = epoch
                return sock
            except ServerEpochError:
                if sock is not None:
                    sock.close()
                self.metrics.count("epoch_refusals")
                self.observer.event("store_epoch_refused",
                                    addr=self.addr)
                raise
            except (InjectedFault, OSError, TornFrameError,
                    pickle.UnpicklingError, EOFError) as e:
                if sock is not None:
                    sock.close()
                last = e
                if attempt < self.reconnect_attempts:
                    with self._rng_lock:
                        u = float(self._rng.random())
                    time.sleep(backoff_delay(
                        attempt, self.backoff_s, self.max_backoff_s,
                        u, self.jitter))
        raise TransientStoreError(
            f"could not connect to store at {self.addr} after "
            f"{self.reconnect_attempts + 1} attempts; last error: "
            f"{last}") from last

    def _sock(self) -> socket.socket:
        sock = getattr(self._local, "sock", None)
        if sock is None:
            sock = self._connect()
            self._local.sock = sock
        return sock

    def _drop(self) -> None:
        sock = getattr(self._local, "sock", None)
        if sock is not None:
            try:
                sock.close()
            finally:
                self._local.sock = None

    def close(self) -> None:
        """Close THIS thread's connection (others close on their own
        thread, or with the process)."""
        self._drop()

    # ---- the RPC core -------------------------------------------------

    def _decode(self, resp):
        if not isinstance(resp, tuple) or not resp:
            raise TornFrameError(f"malformed response frame: {resp!r}")
        if resp[0] == "ok":
            return resp[1]
        if resp[0] == "err":
            _, kind, msg = resp
            # NOTE: a server-side StoreTimeoutError here is a VERDICT
            # (a wait slice expiring is normal polling), not an IO
            # failure — the timeouts counter tracks only socket-level
            # deadline expiries
            raise _WIRE_TO_ERR.get(kind, StoreError)(msg)
        raise TornFrameError(f"malformed response frame: {resp!r}")

    def _rpc(self, op: str, *args, deadline_extra: float = 0.0):
        """One RPC with transport-level resilience.  IDEMPOTENT ops
        (everything except ``add`` — ``set``/``delete`` overwrite,
        reads re-read, ``bump_generation`` is a CAS whose re-send is a
        stale-proposal no-op) are transparently re-sent up to
        ``rpc_retries`` times after a successful reconnect, so a
        coordinator blip under a *generation read* — which the outer
        :class:`RetryingStore` deliberately never retries, because the
        verdict an op RETURNS must not be re-asked — does not kill the
        caller.  ``add`` is at-most-once-ambiguous (the reply may have
        died after the increment applied), so it is never re-sent
        here and surfaces the transient to the caller's policy layer,
        which owns the at-least-once decision."""
        retries = self.rpc_retries if op != "add" else 0
        last: Optional[BaseException] = None
        for attempt in range(retries + 1):
            sock = self._sock()
            t0 = time.perf_counter()
            try:
                fault = fire(store_site("rpc"))  # may raise InjectedFault
                blackhole = (fault is not None
                             and fault.kind == "blackhole")
                if deadline_extra:
                    sock.settimeout(self.io_timeout_s + deadline_extra)
                try:
                    if not blackhole:  # injected: the network ate it
                        send_frame(sock, (op, args))
                    resp = recv_frame(sock)
                finally:
                    if deadline_extra:
                        sock.settimeout(self.io_timeout_s)
                # latency is recorded for COMPLETED round trips only —
                # a failed attempt's reconnect/backoff time would smear
                # recovery cost into the RPC tails — and `wait` slices
                # are excluded from the histogram entirely: the server
                # HOLDS a wait on purpose, so its duration measures the
                # caller's polling budget, not transport health (the
                # number the heartbeat-period arithmetic divides by)
                if op == "wait":
                    self.metrics.count("rpcs")
                else:
                    self.metrics.observe(time.perf_counter() - t0)
                return self._decode(resp)
            except (InjectedFault, OSError, TornFrameError,
                    pickle.UnpicklingError, EOFError) as e:
                last = e
                torn = isinstance(e, TornFrameError)
                self._drop()
                self.metrics.count("transient_errors")
                if torn:
                    self.metrics.count("torn_frames")
                    self.observer.event("store_torn_frame", op=op,
                                        addr=self.addr)
                if isinstance(e, socket.timeout):
                    self.metrics.count("timeouts")
                # reconnect NOW (bounded backoff inside): coordinator
                # downtime within the budget stays transparent, and an
                # amnesiac restart surfaces the epoch verdict
                # immediately instead of hiding behind a transient
                try:
                    self._local.sock = self._connect()
                    self.metrics.count("reconnects")
                    self.observer.event("store_reconnect", op=op,
                                        addr=self.addr)
                except TransientStoreError as ce:
                    # could not re-attach within the bounded budget:
                    # no point re-sending, surface the transient
                    raise TransientStoreError(
                        f"store rpc {op!r} to {self.addr} failed and "
                        f"reconnect exhausted: {ce}") from e
        if isinstance(last, TornFrameError):
            raise last                 # named: torn frames stay torn
        raise TransientStoreError(
            f"store rpc {op!r} to {self.addr} failed: {last}") from last

    # ---- the five verbs ----------------------------------------------

    def set(self, key: str, value) -> None:
        self._rpc("set", key, value)

    def get(self, key: str, default=_MISSING):
        try:
            return self._rpc("get", key)
        except KeyError:
            if default is _MISSING:
                raise
            return default

    def wait(self, key: str, timeout_s: float):
        """Deadline-sliced blocking wait (module docstring): the server
        blocks at most ``wait_slice_s`` per RPC, the client re-issues
        with the remaining budget — expiry is on time, never a full
        slice late, and a coordinator blip mid-wait is a transient for
        the caller's retry budget, not a lost wait."""
        deadline = time.monotonic() + timeout_s
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise StoreTimeoutError(
                    f"store key {key!r} did not appear within "
                    f"{timeout_s}s")
            s = min(remaining, self.wait_slice_s)
            try:
                return self._rpc("wait", key, s, deadline_extra=s)
            except StoreTimeoutError:
                continue               # slice expired; budget may not have

    def add(self, key: str, delta: int = 1) -> int:
        return self._rpc("add", key, delta)

    def delete(self, key: str) -> None:
        self._rpc("delete", key)

    # ---- queries ------------------------------------------------------

    def keys(self, prefix: str = "") -> list:
        return self._rpc("keys", prefix)

    def age(self, key: str):
        return self._rpc("age", key)

    def newest_age(self, prefix: str):
        return self._rpc("newest_age", prefix)

    # ---- generation fencing ------------------------------------------

    @property
    def generation(self) -> int:
        return self._rpc("generation")

    def bump_generation(self, expected: int) -> int:
        return self._rpc("bump_generation", expected)

    def check_generation(self, gen: int) -> None:
        self._rpc("check_generation", gen)


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------


class TCPStoreServer:
    """Threaded TCP coordinator over one :class:`HostKVStore`, with WAL
    + snapshot crash recovery and the server-epoch token (module
    docstring).  ``wal_dir=None`` runs in-memory only (unit tests, or
    deployments that prefer a fresh world over recovery — note the
    epoch token still protects clients from a silent state wipe across
    a restart)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 wal_dir: Optional[str] = None,
                 snapshot_every: int = 512, wal_fsync: bool = False,
                 wal_exclude_prefixes: tuple = (), observer=None):
        self.host = host
        self.port = port
        self.wal_dir = wal_dir
        self.snapshot_every = snapshot_every
        # flush-per-append survives PROCESS death (the page cache has
        # the bytes — the SIGKILL drills rely on exactly this);
        # wal_fsync=True additionally survives HOST/power loss at a
        # per-mutation fsync cost, for deployments where an acked
        # commit marker must be durable against the machine, not just
        # the process (snapshots are always fsynced either way)
        self.wal_fsync = wal_fsync
        # keys under these prefixes are applied but NOT logged — the
        # write-amplification lever for high-churn step-plane traffic
        # (an elastic world routes full gradient trees through
        # `g/{gen}/{step}/{rank}` sets).  The trade is restart
        # transparency: un-logged keys do not survive a coordinator
        # restart, so excluding "g/" means a crash mid-exchange costs
        # the world one re-form (survivors' waits expire and they
        # re-rendezvous) instead of riding through invisibly.  The
        # DEFAULT logs everything: "hb/" must be recovered or
        # dead_peers reads never-beat-at-all as dead right after a
        # restart, and the drills pin full transparency.
        self.wal_exclude_prefixes = tuple(wal_exclude_prefixes)
        self.observer = observer or NULL_OBSERVER
        self.store = HostKVStore()
        self.epoch: Optional[str] = None
        self.recovered = False
        self.replayed_records = 0
        self.stopped = threading.Event()
        self._listener: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._conns: list[socket.socket] = []
        self._conn_lock = threading.Lock()
        self._wal_lock = threading.Lock()
        self._wal_file = None
        self._seq = 0
        self._since_snapshot = 0

    # ---- WAL + snapshot ----------------------------------------------

    @property
    def _snap_path(self):
        return os.path.join(self.wal_dir, "snapshot.pkl")

    @property
    def _wal_path(self):
        return os.path.join(self.wal_dir, "wal.log")

    def _recover(self) -> None:
        """Rehydrate state: snapshot first, then replay WAL records
        with seq > the snapshot's (so a crash between snapshot and WAL
        truncation never double-applies an ``add`` or a bump).  A torn
        WAL tail — the crash happened mid-append — truncates the replay
        at the last complete record, exactly like a torn frame."""
        if self.wal_dir is None:
            self.epoch = uuid.uuid4().hex
            return
        os.makedirs(self.wal_dir, exist_ok=True)
        snap_seq = 0
        had_state = False
        if os.path.exists(self._snap_path):
            with open(self._snap_path, "rb") as f:
                snap = pickle.load(f)
            self.epoch = snap["epoch"]
            self.store.restore_state(snap["data"], snap["gen"])
            snap_seq = self._seq = snap["seq"]
            had_state = True
        if os.path.exists(self._wal_path):
            with open(self._wal_path, "rb") as f:
                while True:
                    header = f.read(_LEN.size)
                    if len(header) < _LEN.size:
                        break                      # clean EOF / torn tail
                    (n,) = _LEN.unpack(header)
                    payload = f.read(n)
                    if len(payload) < n:
                        break                      # torn tail: stop here
                    try:
                        seq, op, args = pickle.loads(payload)
                    except Exception:
                        break                      # corrupt tail record
                    had_state = True
                    if seq <= snap_seq:
                        continue                   # already in snapshot
                    try:
                        self._apply(op, args)
                    except Exception:
                        # the record is write-ahead: it was logged even
                        # if the LIVE apply then failed (e.g. add() on
                        # a non-integer value — the client got the
                        # error).  Skipping reproduces the live store's
                        # state; crashing here would brick every future
                        # recovery on one poison record.
                        pass
                    self._seq = seq
                    self.replayed_records += 1
        if self.epoch is None:
            self.epoch = uuid.uuid4().hex
        if had_state:
            self.recovered = True
            self.observer.event(
                "store_wal_recovered", epoch=self.epoch,
                generation=self.store.generation,
                n_keys=len(self.store.keys()),
                replayed=self.replayed_records)
        # compact now (persists a fresh epoch on first boot, and makes
        # restart-after-restart recovery start from a dense snapshot);
        # _write_snapshot leaves the truncated WAL open for appends
        self._write_snapshot()

    def _apply(self, op: str, args):
        """The one mutation dispatch — shared by live requests
        (:meth:`_log_and_apply`) and WAL replay, so the two paths can
        never drift on a verb."""
        if op == "set":
            return self.store.set(*args)
        if op == "add":
            return self.store.add(*args)
        if op == "delete":
            return self.store.delete(*args)
        if op == "bump_generation":
            return self.store.bump_generation(*args)
        raise ValueError(f"unknown mutation op {op!r}")

    def _write_snapshot(self) -> None:
        if self.wal_dir is None:
            return
        data, gen = self.store.snapshot_state()
        if self.wal_exclude_prefixes:
            # excluded (transient) keys stay out of snapshots too, so
            # "does not survive a restart" holds whichever durability
            # path recovery takes
            data = {k: v for k, v in data.items()
                    if not (isinstance(k, str)
                            and k.startswith(self.wal_exclude_prefixes))}
        tmp = self._snap_path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump({"epoch": self.epoch, "data": data, "gen": gen,
                         "seq": self._seq}, f,
                        protocol=pickle.HIGHEST_PROTOCOL)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._snap_path)
        # truncate the WAL only AFTER the snapshot is durable; a crash
        # in between just replays records the seq filter skips
        if self._wal_file is not None:
            self._wal_file.close()
        self._wal_file = open(self._wal_path, "wb")
        self._since_snapshot = 0

    def _log_and_apply(self, op: str, args):
        """Write-ahead, then apply, then return the op's result —
        serialized so the WAL order IS the apply order."""
        key = args[0] if args else ""
        logged = not (isinstance(key, str)
                      and key.startswith(self.wal_exclude_prefixes)) \
            if self.wal_exclude_prefixes else True
        with self._wal_lock:
            if self._wal_file is not None and logged:
                self._seq += 1
                payload = pickle.dumps(
                    (self._seq, op, args),
                    protocol=pickle.HIGHEST_PROTOCOL)
                self._wal_file.write(_LEN.pack(len(payload)) + payload)
                self._wal_file.flush()
                if self.wal_fsync:
                    os.fsync(self._wal_file.fileno())
            result = self._apply(op, args)
            if logged:
                self._since_snapshot += 1
            if (self._wal_file is not None
                    and self._since_snapshot >= self.snapshot_every):
                self._write_snapshot()
            return result

    # ---- lifecycle ----------------------------------------------------

    def start(self) -> "TCPStoreServer":
        self._recover()
        self._listener = socket.socket(socket.AF_INET,
                                       socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET,
                                  socket.SO_REUSEADDR, 1)
        self._listener.bind((self.host, self.port))
        self.port = self._listener.getsockname()[1]
        self._listener.listen(128)
        self.stopped.clear()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="tcpstore-accept",
            daemon=True)
        self._accept_thread.start()
        return self

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"

    def stop(self, abort: bool = False) -> None:
        """Shut the server down.  ``abort=True`` is the crash shape
        (the ``store_site('reply', 'crash')`` path lands here): every
        connection is killed mid-whatever, nothing is flushed beyond
        what the WAL already holds — recovery is the WAL's job, which
        is the point."""
        if self.stopped.is_set():
            return
        self.stopped.set()
        listener, self._listener = self._listener, None
        if listener is not None:
            # shutdown BEFORE close: on Linux, close() alone does not
            # wake a thread blocked in accept() — the kernel socket
            # would stay alive inside the syscall and hold the port
            # hostage against the restarted coordinator's bind
            try:
                listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                listener.close()
            except OSError:
                pass
        with self._conn_lock:
            conns, self._conns = list(self._conns), []
        for c in conns:
            try:
                c.close()
            except OSError:
                pass
        with self._wal_lock:
            if self._wal_file is not None:
                if not abort:
                    self._wal_file.flush()
                self._wal_file.close()
                self._wal_file = None
        t = self._accept_thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=2.0)

    def __enter__(self) -> "TCPStoreServer":
        return self.start() if self._listener is None else self

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    # ---- serving ------------------------------------------------------

    def _accept_loop(self) -> None:
        listener = self._listener       # stop() nulls the attribute
        while not self.stopped.is_set():
            try:
                conn, _ = listener.accept()
            except OSError:
                return                         # listener closed: done
            conn.settimeout(None)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._conn_lock:
                self._conns.append(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             name="tcpstore-conn", daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            hello_done = False
            while not self.stopped.is_set():
                try:
                    req = recv_frame(conn)
                except (ConnectionError, TornFrameError, OSError,
                        pickle.UnpicklingError, EOFError):
                    return
                resp = self._dispatch(req, hello_done)
                if (not hello_done and isinstance(req, tuple)
                        and len(req) == 2 and req[0] == "hello"
                        and resp[0] == "ok"):
                    hello_done = True
                try:
                    fault = fire(store_site("reply"))
                except InjectedCrash:
                    # the coordinator dies mid-reply: abort the whole
                    # server from this handler thread — nothing else
                    # is sent, every client sees a dead socket
                    self.stop(abort=True)
                    return
                except InjectedFault:
                    return                     # drop just this conn
                if fault is not None and fault.kind == "torn":
                    payload = pickle.dumps(
                        resp, protocol=pickle.HIGHEST_PROTOCOL)
                    frame = _LEN.pack(len(payload)) + payload
                    try:
                        conn.sendall(frame[:max(1, len(frame) // 2)])
                    except OSError:
                        pass
                    return                     # tear: half a frame, EOF
                if fault is not None and fault.kind == "blackhole":
                    continue                   # reply eaten; client
                                               # times out
                try:
                    send_frame(conn, resp)
                except OSError:
                    return
        finally:
            try:
                conn.close()
            except OSError:
                pass
            with self._conn_lock:
                if conn in self._conns:
                    self._conns.remove(conn)

    def _dispatch(self, req, hello_done: bool):
        try:
            if not isinstance(req, tuple) or len(req) != 2:
                raise ValueError(f"malformed request: {req!r}")
            op, args = req
            if op == "hello":
                (expected,) = args
                if expected is not None and expected != self.epoch:
                    raise ServerEpochError(
                        f"server epoch mismatch at {self.addr}: client "
                        f"pinned {expected}, server is {self.epoch} — "
                        f"the coordinator restarted WITHOUT its WAL; "
                        f"refusing to silently rejoin amnesiac state")
                return ("ok", self.epoch)
            if not hello_done:
                raise ValueError(
                    f"first request must be the hello handshake, "
                    f"got {op!r}")
            if op in ("set", "add", "delete", "bump_generation"):
                return ("ok", self._log_and_apply(op, args))
            if op == "get":
                return ("ok", self.store.get(*args))
            if op == "wait":
                key, timeout_s = args
                return ("ok", self.store.wait(key, timeout_s))
            if op == "keys":
                return ("ok", self.store.keys(*args))
            if op == "age":
                return ("ok", self.store.age(*args))
            if op == "newest_age":
                return ("ok", self.store.newest_age(*args))
            if op == "generation":
                return ("ok", self.store.generation)
            if op == "check_generation":
                return ("ok", self.store.check_generation(*args))
            raise ValueError(f"unknown store op {op!r}")
        except tuple(_ERR_TO_WIRE) as e:
            kind = next(k for cls, k in _ERR_TO_WIRE.items()
                        if isinstance(e, cls))
            msg = e.args[0] if e.args else str(e)
            return ("err", kind, msg)
        except Exception as e:      # never let one request kill a conn
            return ("err", "store", f"{type(e).__name__}: {e}")


# ---------------------------------------------------------------------------
# wiring helpers + the standalone coordinator CLI
# ---------------------------------------------------------------------------


def store_addr(default: str = "") -> str:
    """The store address the launcher threaded through
    (``DTDL_STORE_ADDR``), or ``default``."""
    return os.environ.get(STORE_ADDR_ENV, default)


def connect(addr: Optional[str] = None, retries: int = 5, seed: int = 0,
            observer=None, **client_kw) -> RetryingStore:
    """One-call client wiring: ``TCPStoreClient`` wrapped in the
    :class:`RetryingStore` facade (bounded retries on transients,
    verdicts pass through) — the store object an ``ElasticWorker``
    takes verbatim.  ``addr`` defaults to ``DTDL_STORE_ADDR``.

    **`add` is at-least-once under this facade.**  The transport layer
    never re-sends an `add` (its reply dying leaves the increment
    ambiguous), but the retry facade re-asks on the surfaced
    transient, so a coordinator blip can double-count.  Build exact
    protocol counters from CAS (``bump_generation``) or overwrites
    (``set``) — the elastic protocol does; treat ``add`` as a
    statistics verb."""
    addr = addr or store_addr()
    if not addr:
        raise ValueError(
            f"no store address: pass addr= or set {STORE_ADDR_ENV} "
            f"(launchers thread it through automatically)")
    client = TCPStoreClient(addr, seed=seed, observer=observer,
                            **client_kw)
    return RetryingStore(client, retries=retries, seed=seed)


def main(argv=None) -> int:
    """Standalone coordinator:  ``python -m dtdl_tpu_torch.parallel.tcpstore
    --port 12801 --wal-dir /path/to/wal``.  Prints ``STORE ready
    addr=...`` once listening (launch scripts wait on that line) and
    serves until SIGTERM/SIGINT."""
    import argparse
    import signal

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--wal-dir", default=None)
    p.add_argument("--snapshot-every", type=int, default=512)
    p.add_argument("--wal-fsync", action="store_true",
                   help="fsync every WAL append (durable against host "
                        "power loss, not just process death)")
    a = p.parse_args(argv)
    server = TCPStoreServer(host=a.host, port=a.port, wal_dir=a.wal_dir,
                            snapshot_every=a.snapshot_every,
                            wal_fsync=a.wal_fsync).start()
    print(f"STORE ready addr={server.addr} epoch={server.epoch} "
          f"recovered={server.recovered}", flush=True)

    def _stop(signum, frame):
        server.stop()

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    server.stopped.wait()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
