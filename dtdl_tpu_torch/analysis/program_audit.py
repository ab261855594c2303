"""The program audit: what one call of a step actually does, the port's
counterpart of dtdl_tpu/analysis/jaxpr_audit.py and hlo_audit.py.

JAX traces a program and reads its jaxpr and compiled HLO.  An eager
PyTorch step has neither: its program is the sequence of operations one
call dispatches.  :func:`audit_program` runs the call once under a
``TorchDispatchMode`` census, which sees every operation that reaches the
dispatcher (autograd's backward included), and reports:

* ``collectives``: calls into the port's own collectives
  (dtdl_tpu_torch/parallel/collectives.py), under JAX's primitive names
  with the bytes of their results: ``psum`` (``psum``, ``copy_to``'s
  backward, a bucketed ``grad_sync`` or tree reduce), ``pmax``, ``pmin``,
  ``ppermute``, ``all_to_all``, ``all_gather`` and ``psum_scatter``.  The
  counterpart of JAX's ``jaxpr_collectives``.
* ``c10d_collectives``: the ``c10d`` operations actually issued
  (``allreduce_``, ``allgather_``, ``send``, ...), count and bytes of
  their tensor payloads; the counterpart of ``hlo_collectives``.
* ``host_syncs``: scalar reads (``_local_scalar_dense``) and operations
  whose output size needs the host (``nonzero``, ``masked_select``,
  ``unique``, a boolean index, ...): each waits for the card.
* ``d2h_copies``: copies from the card to the host.
* ``h2d_uploads``: copies from the host to the card (a receipt, not a
  contract: the engines upload their host knobs every step).
* ``bf16_to_f32_casts``: bf16 -> f32 conversions.
* ``storage_kept``: the storages of the tensors ``kept()`` names (a train
  state's parameters and optimizer moments, an engine's KV pools) are the
  same before and after the call: the state was updated in place, the
  counterpart of JAX's ``donation_ok``.

On the card the call also runs under
``torch.cuda.set_sync_debug_mode("error")``: a synchronizing CUDA call
raises, and the audit reports it (``cuda_syncs``).  Run a warm-up call
first (``warmup``): a first call takes the caching allocators' first
blocks and the kernels' scratch, which the steady state does not.

Findings: ``program-host-sync``, ``program-d2h-copy``,
``program-cuda-sync``, ``program-storage-moved``.
"""

from __future__ import annotations

import dataclasses
import threading

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from dtdl_tpu_torch.analysis.findings import Finding

#: operations that wait for the card (their output size, or value, is
#: needed on the host)
SYNC_OPS = frozenset({"_local_scalar_dense", "nonzero", "masked_select",
                      "_unique", "_unique2", "unique_dim",
                      "unique_consecutive", "equal", "is_nonzero",
                      "bincount", "repeat_interleave"})

#: the port-level collectives: (module function, JAX's primitive name)
_COLLECTIVE_FNS = (("_ppermute", "ppermute"), ("_a2a", "all_to_all"),
                   ("_tiled_gather", "all_gather"), ("_gather", "all_gather"),
                   ("_tiled_scatter", "psum_scatter"), ("reduce_", "psum"))


@dataclasses.dataclass
class ProgramAudit:
    """Findings and census of one audited call."""

    name: str
    findings: list
    census: dict


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(y) for y in x)
    return 0


def _device_of(x):
    return x.device.type if isinstance(x, torch.Tensor) else None


def _bump(book: dict, key: str, nbytes: int) -> None:
    ent = book.setdefault(key, {"count": 0, "bytes": 0})
    ent["count"] += 1
    ent["bytes"] += int(nbytes)


class _Census(TorchDispatchMode):
    """Books the census of every operation dispatched while active."""

    def __init__(self):
        super().__init__()
        self.c10d: dict = {}
        self.syncs: dict = {}
        self.d2h = self.h2d = self.casts = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        op = func._opname
        if func.namespace == "c10d":
            _bump(self.c10d, op, _c10d_payload(op, args))
        elif op in SYNC_OPS or (op == "index" and _bool_index(args)):
            self.syncs[op] = self.syncs.get(op, 0) + 1
        elif op in ("_to_copy", "copy_"):
            src, dst = ((args[0], out) if op == "_to_copy"
                        else (args[1], args[0]))
            a, b = _device_of(src), _device_of(dst)
            if a == "cuda" and b == "cpu":
                self.d2h += 1
            elif a == "cpu" and b == "cuda":
                self.h2d += 1
            if (isinstance(src, torch.Tensor)
                    and isinstance(dst, torch.Tensor)
                    and src.dtype == torch.bfloat16
                    and dst.dtype == torch.float32):
                self.casts += 1
        return out


def _bool_index(args) -> bool:
    """``aten.index`` with a boolean mask: its output size is the mask's
    count, read on the host."""
    idx = args[1] if len(args) > 1 else ()
    return any(isinstance(t, torch.Tensor) and t.dtype == torch.bool
               for t in (idx or ()))


# the tensor argument that holds a c10d operation's payload
_PAYLOAD_ARG = {"allgather_": 1, "allgather_into_tensor_coalesced_": 1,
                "_allgather_base_": 1, "reduce_scatter_": 1,
                "_reduce_scatter_base_": 1, "alltoall_base_": 1,
                "alltoall_": 1}


def _c10d_payload(op: str, args) -> int:
    i = _PAYLOAD_ARG.get(op, 0)
    return _nbytes(args[i]) if len(args) > i else 0


class _CollectiveCounter:
    """Counts calls into the port's collectives while installed: the
    module functions of dtdl_tpu_torch/parallel/collectives.py are
    wrapped (each looks its helpers up at call time, so the autograd
    functions' forwards and backwards go through the wrappers), and a
    call inside another counted call is not counted again."""

    def __init__(self):
        self.book: dict = {}
        self._local = threading.local()
        self._saved: list = []

    def _wrap(self, mod, fname, prim):
        fn = getattr(mod, fname)

        def counted(*args, **kwargs):
            depth = getattr(self._local, "depth", 0)
            self._local.depth = depth + 1
            try:
                out = fn(*args, **kwargs)
            finally:
                self._local.depth = depth
            if depth == 0 and not (fname == "reduce_"
                                   and _no_group(mod, args, kwargs)):
                if fname == "_all_reduce":
                    op = args[2] if len(args) > 2 else kwargs.get("op")
                    name = {"max": "pmax", "min": "pmin"}.get(
                        str(op).rsplit(".", 1)[-1].lower(), "psum")
                else:
                    name = prim
                _bump(self.book, name, _nbytes(args[0]) if out is None
                      else _nbytes(out))
            return out

        self._saved.append((mod, fname, fn))
        setattr(mod, fname, counted)

    def __enter__(self):
        from dtdl_tpu_torch.parallel import collectives as C
        self._wrap(C, "_all_reduce", "psum")
        for fname, prim in _COLLECTIVE_FNS:
            self._wrap(C, fname, prim)
        return self

    def __exit__(self, *exc):
        for mod, fname, fn in reversed(self._saved):
            setattr(mod, fname, fn)
        self._saved.clear()
        return False


def _no_group(mod, args, kwargs) -> bool:
    """``reduce_`` over a one-process mesh returns at once: no call."""
    mesh = args[1] if len(args) > 1 else kwargs.get("mesh")
    return mod._mesh(mesh).group is None


def _storages(tensors) -> list:
    return [t.untyped_storage().data_ptr() for t in tensors]


def audit_program(fn, *, name: str = "program", kept=None, warmup: int = 1
                  ) -> ProgramAudit:
    """Run ``fn()`` ``warmup`` times, then once more under the census and
    return its :class:`ProgramAudit`.

    ``kept()`` (optional) returns the tensors whose storages the call must
    keep.  Where the card is in use, the audited call runs under
    ``set_sync_debug_mode("error")``: a synchronizing CUDA call then ends
    the call and is reported."""
    for _ in range(warmup):
        fn()
    check = torch.cuda.is_available() and torch.cuda.is_initialized()
    if check:
        torch.cuda.synchronize()
    before = _storages(kept()) if kept is not None else None
    census_mode = _Census()
    cuda_syncs = []
    with _CollectiveCounter() as counter:
        with census_mode:
            if check:
                torch.cuda.set_sync_debug_mode("error")
            try:
                fn()
            except RuntimeError as e:
                if not check or "synchroniz" not in str(e):
                    raise
                cuda_syncs.append(str(e).splitlines()[0])
            finally:
                if check:
                    torch.cuda.set_sync_debug_mode("default")
    if check:
        torch.cuda.synchronize()
    after = _storages(kept()) if kept is not None else None
    kept_ok = before == after
    census = {
        "collectives": {k: counter.book[k] for k in sorted(counter.book)},
        "c10d_collectives": {k: census_mode.c10d[k]
                             for k in sorted(census_mode.c10d)},
        "host_syncs": sum(census_mode.syncs.values()),
        "host_sync_ops": dict(sorted(census_mode.syncs.items())),
        "d2h_copies": census_mode.d2h,
        "h2d_uploads": census_mode.h2d,
        "bf16_to_f32_casts": census_mode.casts,
        "storage_kept": kept_ok,
        "cuda_syncs": len(cuda_syncs),
    }
    findings = []
    if census["host_syncs"]:
        findings.append(Finding(
            "program-host-sync", name, 0,
            f"{census['host_syncs']} host sync(s) in one call: "
            f"{census['host_sync_ops']}"))
    if census["d2h_copies"]:
        findings.append(Finding(
            "program-d2h-copy", name, 0,
            f"{census['d2h_copies']} copy(ies) from the card to the host "
            f"in one call"))
    for msg in cuda_syncs:
        findings.append(Finding("program-cuda-sync", name, 0, msg))
    if not kept_ok:
        moved = sum(a != b for a, b in zip(before, after)) + abs(
            len(before) - len(after))
        findings.append(Finding(
            "program-storage-moved", name, 0,
            f"{moved} of {len(before)} kept storages replaced by the call "
            f"(the state is copied, not updated in place)"))
    return ProgramAudit(name=name, findings=findings, census=census)
