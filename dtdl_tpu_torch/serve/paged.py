"""Host-side page bookkeeping for the block-paged KV arena and its spill
tiers, the port's own copy of dtdl_tpu/serve/paged.py (framework-free:
policy over integers and host numpy payloads; nothing here touches torch).

* **Page allocation**: a free list over physical pages 1..n_pages-1.  Page
  0 is the reserved garbage page: every unmapped page-table entry points
  at it, and the attend routes inactive rows' writes there, so a stale
  table row never corrupts a live page.
* **Prefix caching**: page i of a prompt is keyed by the chained hash of
  tokens ``[0, (i+1)·page_size)``; a new prompt maps the longest cached
  run read-only (refcounted) and prefills only the suffix.  Hits are
  capped at ``(prompt_len - 1) // page_size`` pages so the write frontier
  is always a private page.  Eviction is LRU over refcount-zero cached
  pages.

When neither the free list nor the evictable set can supply a page,
:class:`PagePoolExhaustedError` is raised; the scheduler turns it into
admission backpressure or a named shed.

**The spill hierarchy.**  With a :class:`HostPageStore` attached
(Scheduler ``spill_host_bytes=``/``spill_dir=``), eviction becomes
*demotion*: the allocator records every evicted ``(chain_hash, page)`` in
:attr:`PageAllocator.pending_spills` and the scheduler extracts the
payloads to host memory (one batched ``extract_pages_batch`` sync per
admission or growth burst, never one per page) BEFORE the pages are
rewritten.  Host-store overflow demotes further to :class:`DiskPageStore`,
one mmap'd spill file of fixed-size records with a sha256 manifest; a torn
or corrupt record is QUARANTINED by name and the read falls back to
recompute, never a crash or a corrupt decode.  Everything stays
content-addressed by the chain hash, so a spilled payload is valid as
long as the weights are, across an engine-failure containment too.

A payload is a nested dict of host numpy arrays keyed as the arena
(``block_i/attn/pages_key`` ...), each leaf ``[n_pages, ...]``; the port's
bf16 and fp8 pools travel as their raw bits (uint16, uint8), which the
stores carry like any other dtype.
"""

from __future__ import annotations

import hashlib
import json
import mmap
import os
from collections import OrderedDict, deque
from typing import Callable, Optional, Sequence

import numpy as np

GARBAGE_PAGE = 0


def adapter_salt(adapter: Optional[str]) -> Optional[int]:
    """The chain salt of the pages a LoRA ``adapter`` computes (None for
    the base model): a stable 64-bit digest of its name, the same in
    every process, so the disk tier's records stay findable."""
    if adapter is None:
        return None
    return int.from_bytes(hashlib.blake2b(adapter.encode(),
                                          digest_size=8).digest(), "little")


def page_chain_hashes(tokens: Sequence[int], page_size: int,
                      salt: Optional[int] = None) -> list[int]:
    """Chained hashes of every FULL page of ``tokens`` — entry i keys
    tokens [0, (i+1)·page_size), so equal hash i means equal whole
    prefix, which is exactly the K/V-reuse condition.  Module-level so
    the fleet Router can compute the SAME keys its replicas' allocators
    publish (the prefix directory speaks this hash space).

    ``salt`` (:func:`adapter_salt`) starts the chain of a request served
    under a LoRA adapter: its k/v deltas make its K/V differ from another
    adapter's on the same tokens, so pages are shared only between
    requests of one adapter.  The JAX package keys by tokens alone and
    maps pages across adapters (ROADMAP C5).  Without a salt the hashes
    are the JAX package's."""
    out, h = [], (0 if salt is None else salt)
    for i in range(len(tokens) // page_size):
        h = hash((h, tuple(int(t)
                           for t in tokens[i * page_size:(i + 1) * page_size])))
        out.append(h)
    return out


class PagePoolExhaustedError(RuntimeError):
    """Every usable page is pinned by a live request (nothing evictable).

    Raised by :meth:`PageAllocator.alloc`; the scheduler converts it
    into backpressure at admission (the request waits for retirements)
    or a named shed of a mid-flight request that outgrew the pool
    (``Request.error`` set, its pages freed, the run continues).
    """


class PageAllocator:
    """Free-list page allocator + chained-hash prefix cache (see module
    docstring).  Page 0 is reserved as the garbage page and never
    allocated."""

    def __init__(self, n_pages: int, page_size: int,
                 prefix_cache: bool = True):
        if n_pages < 2:
            raise ValueError(f"n_pages must be >= 2 (page 0 is the "
                             f"reserved garbage page), got {n_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.n_pages = n_pages
        self.page_size = page_size
        self.prefix_cache = prefix_cache
        self._free: deque[int] = deque(range(1, n_pages))
        self._ref: dict[int, int] = {}          # page -> live references
        self._cached: dict[int, int] = {}       # chain hash -> page
        self._page_hash: dict[int, int] = {}    # page -> chain hash
        # refcount-0 cached pages, least-recently-released first
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        # counters for ServeMetrics / bench receipts
        self.prefix_hit_pages = 0
        self.prefix_miss_pages = 0
        self.evictions = 0
        # spill tier: when a consumer opts in, every evicted
        # (chain_hash, page) is recorded here INSTEAD of silently
        # forgotten; the scheduler drains the list with ONE batched
        # extract before dispatching anything that rewrites the pages
        # (alloc() itself stays device-free and sync-free)
        self.record_evictions = False
        self.pending_spills: list[tuple[int, int]] = []

    # ---- accounting ---------------------------------------------------

    @property
    def pages_in_use(self) -> int:
        """Pages currently referenced by at least one live slot."""
        return len(self._ref)

    @property
    def available(self) -> int:
        """Pages an alloc() could return right now (free + evictable)."""
        return len(self._free) + len(self._lru)

    @property
    def capacity(self) -> int:
        """Usable pages (the pool minus the reserved garbage page)."""
        return self.n_pages - 1

    # ---- allocation ---------------------------------------------------

    def alloc(self) -> int:
        """One private page (refcount 1), evicting the LRU refcount-zero
        cached page if the free list is dry."""
        if self._free:
            page = self._free.popleft()
        elif self._lru:
            page, _ = self._lru.popitem(last=False)
            h = self._page_hash.pop(page)
            del self._cached[h]
            self.evictions += 1
            if self.record_evictions:
                self.pending_spills.append((h, page))
        else:
            raise PagePoolExhaustedError(
                f"page pool exhausted: all {self.capacity} pages "
                f"(page_size={self.page_size}) are pinned by live "
                f"requests")
        self._ref[page] = 1
        return page

    def acquire(self, page: int) -> None:
        """Add a reference to a cached page (a prefix hit mapping it
        read-only into another slot's table)."""
        if page not in self._ref:
            self._lru.pop(page, None)        # was evictable; now pinned
            self._ref[page] = 1
        else:
            self._ref[page] += 1

    def release(self, page: int) -> None:
        """Drop one reference; at zero a cached page becomes evictable
        (kept warm for future hits), a private page frees immediately."""
        n = self._ref[page] - 1
        if n > 0:
            self._ref[page] = n
            return
        del self._ref[page]
        if page in self._page_hash:
            self._lru[page] = None           # most-recently released
        else:
            self._free.append(page)

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)

    # ---- the prefix cache ---------------------------------------------

    def page_hashes(self, tokens: Sequence[int],
                    adapter: Optional[str] = None) -> list[int]:
        """Chained hashes of every FULL page of ``tokens`` computed under
        LoRA ``adapter`` (None: the base model; see
        :func:`page_chain_hashes` — one hash space shared with the
        fleet prefix directory)."""
        return page_chain_hashes(tokens, self.page_size,
                                 adapter_salt(adapter))

    def match_prefix(self, prompt: Sequence[int],
                     adapter: Optional[str] = None) -> list[int]:
        """Longest cached run of full prompt pages from page 0 computed
        under the same ``adapter``, capped at ``(len(prompt) - 1) //
        page_size`` so at least one prompt token is always prefilled (the
        write frontier stays private and the first output token has a
        program to come from).  Returns the physical pages WITHOUT
        acquiring them."""
        if not self.prefix_cache:
            return []
        cap = (len(prompt) - 1) // self.page_size
        pages = []
        for h in self.page_hashes(prompt, adapter)[:cap]:
            page = self._cached.get(h)
            if page is None:
                break
            pages.append(page)
        return pages

    def register(self, h: int, page: int) -> None:
        """Publish a freshly-prefilled full prompt page under its chain
        hash.  First writer wins — a hash already cached keeps its
        original page (the contents are identical by construction, and
        re-pointing would orphan the original's refcounts)."""
        if not self.prefix_cache or h in self._cached:
            return
        self._cached[h] = page
        self._page_hash[page] = h

    def cached_pages(self) -> int:
        return len(self._cached)

    def reset(self) -> None:
        """Forget everything — the engine-failure containment path: a
        re-initialized arena invalidates every cached page's contents,
        so serving a stale hit would be silent corruption."""
        self._free = deque(range(1, self.n_pages))
        self._ref.clear()
        self._cached.clear()
        self._page_hash.clear()
        self._lru.clear()
        # pending spills reference arena contents that the containment
        # re-init just destroyed — extracting them now would spill
        # garbage under a valid hash (silent corruption); drop them.
        # Pages ALREADY spilled to the host/disk tiers stay valid: their
        # payloads are host copies, content-addressed by chain hash.
        self.pending_spills.clear()


# ---------------------------------------------------------------------------
# the spill tiers: host DRAM (tier 2) over an mmap'd disk file (tier 3)
# ---------------------------------------------------------------------------

def _flat_leaves(tree) -> list[tuple[tuple, np.ndarray]]:
    """Deterministic (key-sorted) flattening of a nested-dict pytree of
    host arrays into ``[(path, leaf), ...]``.  The extract/inject
    payloads are plain nested dicts of numpy arrays (the arena's page
    leaves after the engine's extract) — int8/fp8 payloads and their
    scale leaves flatten as-is, no dtype special-casing."""
    out: list[tuple[tuple, np.ndarray]] = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        else:
            # audit: ok[host-sync-asarray] spill payloads are already host memory (extract_pages output)
            out.append((path, np.asarray(node)))

    walk(tree, ())
    return out


def _unflatten(pairs) -> dict:
    """Inverse of :func:`_flat_leaves` for nested-dict payloads."""
    out: dict = {}
    for path, leaf in pairs:
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = leaf
    return out


def concat_payloads(payloads) -> dict:
    """One payload of the pages of several, in order."""
    first = payloads[0]
    return {k: (concat_payloads([p[k] for p in payloads])
                if isinstance(v, dict)
                else np.concatenate([p[k] for p in payloads], axis=0))
            for k, v in first.items()}


def slice_payload(tree, i: int) -> dict:
    """Page ``i`` of a payload as a one-page payload."""
    return {k: (slice_payload(v, i) if isinstance(v, dict)
                else v[i:i + 1]) for k, v in tree.items()}


def payload_nbytes(payload) -> int:
    """Host bytes one page payload occupies (sum over leaves)."""
    return sum(leaf.nbytes for _, leaf in _flat_leaves(payload))


class SpillCorruptEntryError(RuntimeError):
    """A disk spill record failed its integrity check (torn write,
    bit rot, truncated file).  Never raised through the serving path —
    :meth:`DiskPageStore.get` QUARANTINES the record (slot never reused,
    entry dropped, this error appended to ``quarantine_log`` by name)
    and returns a miss, so the caller falls back to recompute-prefill.
    Same discipline as the checkpoints' corrupt-file handling: a bad
    artifact is named and isolated, never served."""

    def __init__(self, path: str, slot: int, reason: str):
        super().__init__(
            f"corrupt KV spill entry: {path} slot {slot}: {reason}")
        self.path = path
        self.slot = slot
        self.reason = reason


class DiskPageStore:
    """Tier 3: fixed-record mmap'd spill file + sidecar manifest.

    Every page payload of one engine has identical geometry, so the
    spill file is an array of fixed-size records — ``put`` pins the
    leaf spec (paths/shapes/dtypes) from the first payload and rejects
    anything else.  Integrity follows the checkpoint manifest
    idiom: record bytes are written (and flushed) FIRST, then the
    sidecar ``<file>.manifest.json`` — ``{"record_bytes", "spec",
    "entries": {hash: {"slot", "bytes", "sha256"}}}`` — is replaced
    atomically (``.tmp`` + ``os.replace``), so a crash between the two
    leaves a manifest describing the OLD record and the sha256 check at
    read flags the torn write.  A failed check quarantines the slot
    (never reused — the medium is suspect there) and the entry reads as
    a miss → recompute, never a crash and never wrong tokens.

    Eviction is LRU over entries when ``byte_budget`` is set; freed
    slots are reused before the file grows.  All host-side numpy — no
    torch, no device syncs."""

    def __init__(self, directory: str, byte_budget: Optional[int] = None,
                 on_drop: Optional[Callable[[int], None]] = None):
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, "kv_spill.bin")
        self.manifest_path = self.path + ".manifest.json"
        self.byte_budget = byte_budget
        self.on_drop = on_drop
        self._spec: Optional[list] = None   # [(path, shape, dtype), ...]
        self.record_bytes = 0
        self._slots: dict[int, int] = {}    # chain hash -> record slot
        self._sha: dict[int, str] = {}      # chain hash -> sha256 hex
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        self._free_slots: list[int] = []
        self._n_slots = 0                   # records the file holds room for
        self._quarantined: set[int] = set()
        self._fh = None
        self._mm: Optional[mmap.mmap] = None
        # counters / receipts
        self.puts = 0
        self.hits = 0
        self.corrupt_entries = 0
        self.drops = 0
        self.quarantine_log: list[SpillCorruptEntryError] = []

    def __len__(self) -> int:
        return len(self._slots)

    def __contains__(self, h: int) -> bool:
        return h in self._slots

    @property
    def bytes_used(self) -> int:
        return len(self._slots) * self.record_bytes

    # ---- file plumbing ------------------------------------------------

    def _remap(self, n_slots: int) -> None:
        """Grow the spill file to ``n_slots`` records and (re)mmap it."""
        if self._fh is None:
            self._fh = open(self.path, "a+b")
        size = max(1, n_slots * self.record_bytes)
        if self._mm is not None:
            self._mm.close()
        os.ftruncate(self._fh.fileno(), size)
        self._mm = mmap.mmap(self._fh.fileno(), size)
        self._n_slots = n_slots

    def _write_manifest(self) -> None:
        manifest = {
            "record_bytes": self.record_bytes,
            "spec": [[list(p), list(s), d] for p, s, d in (self._spec or [])],
            "entries": {str(h): {"slot": s, "bytes": self.record_bytes,
                                 "sha256": self._sha[h]}
                        for h, s in self._slots.items()},
        }
        tmp = self.manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, self.manifest_path)

    def _quarantine(self, h: int, slot: int, reason: str) -> None:
        err = SpillCorruptEntryError(self.path, slot, reason)
        self.quarantine_log.append(err)
        self._quarantined.add(slot)          # slot never reused
        self._slots.pop(h, None)
        self._sha.pop(h, None)
        self._lru.pop(h, None)
        self.corrupt_entries += 1
        self._write_manifest()

    # ---- the store ----------------------------------------------------

    def put(self, h: int, payload) -> bool:
        """Demote one page payload to disk.  Returns False (payload
        dropped) when the geometry does not match the pinned spec or the
        budget cannot hold even one record."""
        if h in self._slots:
            self._lru.move_to_end(h)
            return True
        leaves = _flat_leaves(payload)
        spec = [(p, tuple(a.shape), str(a.dtype)) for p, a in leaves]
        if self._spec is None:
            self._spec = spec
            self.record_bytes = sum(a.nbytes for _, a in leaves)
            if self.byte_budget is not None \
                    and self.record_bytes > self.byte_budget:
                self._spec, self.record_bytes = None, 0
                return False
        elif spec != self._spec:
            return False
        blob = b"".join(np.ascontiguousarray(a).tobytes() for _, a in leaves)
        # reclaim: free slots first, then LRU eviction under the budget
        while (self.byte_budget is not None and not self._free_slots
               and (len(self._slots) + 1) * self.record_bytes
               > self.byte_budget and self._lru):
            old, _ = self._lru.popitem(last=False)
            self._free_slots.append(self._slots.pop(old))
            del self._sha[old]
            self.drops += 1
            if self.on_drop is not None:
                self.on_drop(old)
        if self._free_slots:
            slot = self._free_slots.pop()
        elif (self.byte_budget is not None
              and (len(self._slots) + 1) * self.record_bytes
              > self.byte_budget):
            return False                     # budget full of pinned slots
        else:
            slot = self._n_slots
            self._remap(self._n_slots + 1)
        # record bytes first (flushed), manifest second (atomic replace):
        # a crash in between leaves a manifest whose sha256 disagrees
        # with the half-written record — caught and quarantined at read
        off = slot * self.record_bytes
        self._mm[off:off + self.record_bytes] = blob
        self._mm.flush()
        self._slots[h] = slot
        self._sha[h] = hashlib.sha256(blob).hexdigest()
        self._lru[h] = None
        self.puts += 1
        self._write_manifest()
        return True

    def get(self, h: int):
        """One page payload back, or None on miss / integrity failure
        (the corrupt path quarantines and the caller recomputes)."""
        slot = self._slots.get(h)
        if slot is None:
            return None
        off = slot * self.record_bytes
        try:
            blob = bytes(self._mm[off:off + self.record_bytes])
        except (ValueError, OSError, IndexError) as e:
            self._quarantine(h, slot, f"short read ({e})")
            return None
        if len(blob) != self.record_bytes:
            self._quarantine(
                h, slot, f"short read ({len(blob)}/{self.record_bytes} "
                         f"bytes)")
            return None
        if hashlib.sha256(blob).hexdigest() != self._sha[h]:
            self._quarantine(
                h, slot, "sha256 mismatch (torn or corrupt spill entry)")
            return None
        self._lru.move_to_end(h)
        self.hits += 1
        pairs, off2 = [], 0
        for path, shape, dtype in self._spec:
            count = int(np.prod(shape, dtype=np.int64))
            arr = np.frombuffer(blob, dtype=dtype, count=count,
                                offset=off2).reshape(shape)
            pairs.append((path, arr))
            off2 += count * np.dtype(dtype).itemsize
        return _unflatten(pairs)

    def close(self) -> None:
        if self._mm is not None:
            self._mm.close()
            self._mm = None
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class HostPageStore:
    """Tier 2: bounded host-DRAM page store keyed by chain hash.

    LRU over whole page payloads under ``byte_budget``; overflow
    DEMOTES to the optional :class:`DiskPageStore` instead of dropping
    (tier 3), and only a disk-side drop (or no disk tier) actually
    forgets a prefix — reported through ``on_drop`` so the fleet
    directory learns the replica no longer holds it.  ``get`` is
    non-destructive (the entry stays warm for other requests; a
    restored page ALSO re-enters the HBM cache via register, and the
    two copies are harmless duplicates — content-addressing makes them
    identical by construction)."""

    def __init__(self, byte_budget: int,
                 disk: Optional[DiskPageStore] = None,
                 on_drop: Optional[Callable[[int], None]] = None):
        if byte_budget < 0:
            raise ValueError(f"byte_budget must be >= 0, got {byte_budget}")
        self.byte_budget = byte_budget
        self.disk = disk
        self.on_drop = on_drop
        if disk is not None and on_drop is not None:
            disk.on_drop = on_drop
        self._entries: "OrderedDict[int, tuple]" = OrderedDict()
        self._bytes = 0
        # counters for ServeMetrics / bench receipts
        self.spilled_pages = 0
        self.spilled_bytes = 0
        self.host_hits = 0
        self.disk_hits = 0
        self.demotions = 0
        self.drops = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, h: int) -> bool:
        return h in self._entries or (self.disk is not None
                                      and h in self.disk)

    def holds(self, h: int):
        """Which tier claims this hash: ``"host"``, ``"disk"``, or None.
        A "disk" claim is pre-integrity-check — the subsequent
        :meth:`get` may still quarantine it and miss."""
        if h in self._entries:
            return "host"
        if self.disk is not None and h in self.disk:
            return "disk"
        return None

    @property
    def bytes_used(self) -> int:
        return self._bytes

    def _demote(self, h: int, payload) -> None:
        if self.disk is not None and self.disk.put(h, payload):
            self.demotions += 1
        else:
            self.drops += 1
            if self.on_drop is not None:
                self.on_drop(h)

    def put(self, h: int, payload) -> None:
        """Admit one spilled page under its chain hash (most recently
        used); evicts LRU entries into the disk tier to stay under the
        byte budget.  A payload larger than the whole budget demotes
        straight to disk."""
        if h in self._entries:
            self._entries.move_to_end(h)
            return
        nbytes = payload_nbytes(payload)
        self.spilled_pages += 1
        self.spilled_bytes += nbytes
        if nbytes > self.byte_budget:
            self._demote(h, payload)
            return
        self._entries[h] = (payload, nbytes)
        self._bytes += nbytes
        while self._bytes > self.byte_budget and len(self._entries) > 1:
            old, (old_payload, old_nbytes) = self._entries.popitem(last=False)
            self._bytes -= old_nbytes
            self._demote(old, old_payload)

    def get(self, h: int):
        """One page payload back (host tier first, then disk), or None
        — the caller falls back to recompute-prefill.  A disk hit is
        promoted back into the host tier (it is hot again)."""
        hit = self._entries.get(h)
        if hit is not None:
            self._entries.move_to_end(h)
            self.host_hits += 1
            return hit[0]
        if self.disk is not None:
            payload = self.disk.get(h)
            if payload is not None:
                self.disk_hits += 1
                if payload_nbytes(payload) <= self.byte_budget:
                    self._entries[h] = (payload, payload_nbytes(payload))
                    self._bytes += payload_nbytes(payload)
                    while (self._bytes > self.byte_budget
                           and len(self._entries) > 1):
                        old, (op, on) = self._entries.popitem(last=False)
                        self._bytes -= on
                        self._demote(old, op)
                return payload
        return None
