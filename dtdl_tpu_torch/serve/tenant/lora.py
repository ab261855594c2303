"""Batched multi-LoRA, the port of dtdl_tpu/serve/tenant/lora.py: a
device-resident adapter bank and its host registry.

One decode, verify or prefill step serves many fine-tunes by making the
adapter identity data: every LoRA factor lives stacked in a
``[n_adapters, ...]`` bank on the card, and each slot carries an int32
adapter id by which the attention layers gather their rows
(``index_select`` along axis 0, :meth:`~dtdl_tpu_torch.models.
transformer.Attention.forward`).  Row 0 is reserved for the all-zeros
base adapter, so un-adapted requests run with a zero delta (and a step
whose rows are all base skips the delta, which is exactly zero).

Host side, :class:`AdapterBank` is a refcounted name -> row registry with
LRU eviction.  Adapters hot-load from disk through the manifest-checked
:func:`dtdl_tpu_torch.ckpt.checkpoint.load_weights`, so a truncated or
bit-flipped adapter raises ``CheckpointCorruptError`` instead of serving
garbage.  When every row is pinned by a live request, ``acquire`` raises
:class:`AdapterBankFullError` and the scheduler sheds that request.  The
fleet's replicas share one engine and so one bank: the registry takes a
lock, and a row's upload goes on the card's stream after the steps
already queued there, so a step in flight that still reads an evicted
row finishes before the row is overwritten.

The trees keep the JAX package's layout, ``{"block_i": {"attn": {leaf:
array}}}`` with the leaves of :data:`LORA_LEAVES`: ``{q,k,v}_a``
[d_model, r], ``{q,k,v}_b`` [r, H, D], ``out_a`` [H, D, r], ``out_b``
[r, d_model].  The bank's head-sharded placement for a tensor-parallel
engine (JAX ``bank_pspecs``) is ROADMAP queue A12a's follow-up.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from dtdl_tpu_torch.ckpt.checkpoint import load_weights
from dtdl_tpu_torch.device import upload

__all__ = [
    "AdapterBankFullError",
    "AdapterBank",
    "LORA_LEAVES",
    "adapter_template",
    "init_bank",
    "merge_adapter",
    "bank_nbytes",
]

# per-block leaves: A/B factor pairs of the q/k/v projections and of the
# output projection; the delta is B(A(x)) with the rank contracted between
LORA_LEAVES = ("q_a", "q_b", "k_a", "k_b", "v_a", "v_b", "out_a", "out_b")


def _leaf_shape(name: str, d: int, h: int, dh: int, r: int) -> Tuple[int, ...]:
    if name.endswith("_a") and name != "out_a":
        return (d, r)
    if name == "out_a":
        return (h, dh, r)
    if name == "out_b":
        return (r, d)
    return (r, h, dh)          # q_b / k_b / v_b


class AdapterBankFullError(RuntimeError):
    """Every adapter row is pinned by a live request."""

    def __init__(self, name: str, capacity: int) -> None:
        super().__init__(
            f"adapter bank full: cannot load {name!r}, all "
            f"{capacity - 1} rows are referenced by live requests")
        self.name = name
        self.capacity = capacity


def _dims(model) -> Tuple[int, int, int, List[str]]:
    """(d_model, n_heads, head_dim, block names) of a ``TransformerLM``."""
    cfg = model.cfg
    return (cfg.d_model, cfg.n_heads, cfg.head_dim,
            [f"block_{i}" for i in range(cfg.n_layers)])


def adapter_template(model, rank: int, dtype=np.float32) -> dict:
    """Host zeros tree in the on-disk single-adapter layout ``{"block_i":
    {"attn": {leaf: array}}}``: what ``save_weights`` stores and what
    ``acquire`` validates a load against."""
    d, h, dh, blocks = _dims(model)
    return {b: {"attn": {n: np.zeros(_leaf_shape(n, d, h, dh, rank),
                                     dtype=dtype)
                         for n in LORA_LEAVES}}
            for b in blocks}


def init_bank(model, rank: int, n_adapters: int, dtype=torch.float32,
              device=None) -> dict:
    """Zeros bank on ``device`` (the model's by default): every leaf
    gains a leading ``[n_adapters]`` axis; row 0 is the base (all-zeros)
    adapter and is never evicted."""
    d, h, dh, blocks = _dims(model)
    dev = model.device if device is None else torch.device(device)
    return {b: {"attn": {n: torch.zeros((n_adapters,)
                                        + _leaf_shape(n, d, h, dh, rank),
                                        dtype=dtype, device=dev)
                         for n in LORA_LEAVES}}
            for b in blocks}


def _t(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.asarray(x))


@torch.no_grad()
def merge_adapter(model, adapter):
    """The math oracle: one adapter folded into the dense q/k/v/out
    kernels, ``kernel + A @ B`` (the product in the factors' dtype, cast
    to the kernel's), so batched gathered execution can be held against
    a merged-weights model.  ``model`` a ``TransformerLM`` (returns a
    merged clone on its device) or its ``state_dict`` (returns a merged
    copy)."""
    is_model = isinstance(model, torch.nn.Module)
    params = dict(model.state_dict() if is_model else model)
    for b, sub in adapter.items():
        leaves = sub["attn"]
        for proj in ("q", "k", "v", "out"):
            key = f"{b}.attn.{proj}.kernel"
            k = params[key]
            a, bb = _t(leaves[f"{proj}_a"]), _t(leaves[f"{proj}_b"])
            if proj == "out":
                delta = torch.einsum("her,rd->hed", a, bb)
            else:
                delta = torch.einsum("dr,rhe->dhe", a, bb)
            params[key] = k + delta.to(device=k.device, dtype=k.dtype)
    if not is_model:
        return params
    twin = model.clone()
    twin.load_state_dict(params)
    return twin.requires_grad_(False)


def bank_nbytes(bank) -> int:
    """Bytes of every leaf of the bank."""
    if isinstance(bank, dict):
        return sum(bank_nbytes(v) for v in bank.values())
    return int(bank.numel() * bank.element_size())


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


class AdapterBank:
    """Refcounted host registry over the device-resident bank.

    ``acquire(path)`` returns the int row id for the adapter at ``path``
    (``None`` -> 0, the base row), loading it through the manifest-checked
    checkpoint path on first use and evicting the least-recently-used
    unreferenced row when full.  ``release(aid)`` decrements; rows are
    only reclaimable at refcount 0.  Thread-safe: the fleet's replicas
    share one bank."""

    def __init__(self, bank, template, observer=None) -> None:
        self.bank = bank
        self.template = template
        leaf = next(_leaves(bank))[1]
        self.capacity = int(leaf.shape[0])
        # adapter_loaded / adapter_evicted land on its trace (JAX's args)
        self.observer = observer
        self._lock = threading.RLock()
        self._by_name: Dict[str, int] = {}
        self._name_of: Dict[int, str] = {}
        self._refs: Dict[int, int] = {}
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        self._free: List[int] = list(range(1, self.capacity))
        self.n_loads = 0
        self.n_evictions = 0

    # -- registry -------------------------------------------------------
    def acquire(self, path: Optional[str]) -> int:
        if path is None:
            return 0
        with self._lock:
            aid = self._by_name.get(path)
            if aid is not None:
                self._refs[aid] += 1
                self._lru.pop(aid, None)
                self._lru[aid] = None
                return aid
            # load before taking a row: a corrupt file costs no eviction
            adapter = load_weights(path, like=self.template)
            aid = self._grab_row(path)
            self._upload(aid, adapter)
            self._by_name[path] = aid
            self._name_of[aid] = path
            self._refs[aid] = 1
            self._lru[aid] = None
            self.n_loads += 1
            if self.observer is not None:
                self.observer.event("adapter_loaded", adapter=path, row=aid)
            return aid

    def release(self, aid: int) -> None:
        if aid == 0:
            return
        with self._lock:
            self._refs[aid] -= 1

    def _grab_row(self, name: str) -> int:
        if self._free:
            return self._free.pop()
        for aid in self._lru:               # oldest first
            if self._refs.get(aid, 0) == 0:
                return self._evict(aid)
        raise AdapterBankFullError(name, self.capacity)

    def _evict(self, aid: int) -> int:
        old = self._name_of.pop(aid)
        del self._by_name[old]
        del self._refs[aid]
        del self._lru[aid]
        self.n_evictions += 1
        if self.observer is not None:
            self.observer.event("adapter_evicted", adapter=old, row=aid)
        # no zeroing: the incoming adapter overwrites the whole row before
        # any slot references it, and the stream orders the upload after
        # every step already queued that read the old row
        return aid

    def _upload(self, aid: int, adapter) -> None:
        for path, dst in _leaves(self.bank):
            src = adapter
            for k in path:
                src = src[k]
            src = np.ascontiguousarray(
                src.numpy() if isinstance(src, torch.Tensor) else src)
            dst[aid].copy_(upload(src, dst.device, dst.dtype),
                           non_blocking=True)

    # -- introspection --------------------------------------------------
    def resident(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._by_name)

    def refcount(self, path: str) -> int:
        with self._lock:
            aid = self._by_name.get(path)
            return 0 if aid is None else self._refs[aid]
