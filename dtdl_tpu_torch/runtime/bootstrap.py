"""Process bootstrap and rendezvous, the port of dtdl_tpu/runtime/bootstrap.py.

The JAX module maps the reference's rendezvous mechanisms onto
``jax.distributed.initialize(coordinator, num_processes, process_id)``;
here they map onto ``torch.distributed.init_process_group`` with a
``tcp://coordinator`` init method: one process per card, each bound to
its card (``torch.cuda.set_device``) before NCCL starts.

The collective backend follows the device: ``nccl`` on the card, ``gloo``
on the CPU; ``gloo`` on the card only when asked for by name (gloo
all-reduces and broadcasts CUDA tensors, which lets two processes share
one card, where NCCL refuses them).  Beside an NCCL world a gloo group
over the same processes carries the host-level operations (barriers,
object broadcasts and gathers), as they are host operations in JAX too.
Nothing falls back: a failed rendezvous or backend start raises.
"""

from __future__ import annotations

import atexit
import logging
import os
import random
import socket
import time
from datetime import timedelta

import torch
import torch.distributed as dist

from dtdl_tpu_torch.device import NoCudaDeviceError

log = logging.getLogger("dtdl_tpu_torch")

_initialized = False
_host_group = None      # gloo group over the world, for host operations


def backoff_delay(attempt: int, backoff_s: float, max_backoff_s: float,
                  u: float, jitter: float = 0.5) -> float:
    """THE backoff formula — ``min(backoff_s·2^attempt, max_backoff_s)``
    stretched by ``(1 + jitter·u)`` with ``u ∈ [0, 1)`` supplied by the
    caller's rng (seeded in tests keeps retry schedules deterministic;
    the jitter de-syncs a herd of workers retrying together)."""
    return min(backoff_s * (2 ** attempt), max_backoff_s) * \
        (1.0 + jitter * u)


def _bind_device(process_id: int, device) -> torch.device:
    """This process's device: the card ``process_id % device_count`` (or
    the one ``device`` names), made current; or the CPU by name."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"the port runs on 'cuda' or 'cpu', got {device!r}")
    if not torch.cuda.is_available():
        raise NoCudaDeviceError(
            "no CUDA device is visible to this process; pass device='cpu' "
            "(--platform cpu) to run the process world on the CPU")
    index = dev.index if dev.index is not None else \
        process_id % torch.cuda.device_count()
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def initialize(coordinator: str = "", num_processes: int = 1,
               process_id: int = 0, retries: int = 0, backoff_s: float = 1.0,
               max_backoff_s: float = 15.0, store_addr: str = "",
               device=None, backend: str | None = None,
               timeout_s: float = 300.0) -> None:
    """Join (or create) the multi-process world.

    No-op for single-process runs (no coordinator, one process).  For
    multi-process, every process calls this with the same coordinator
    address (``host:port`` of process 0's rendezvous store) and its own
    ``process_id``.  ``device`` is where this process runs (``None``: the
    card ``process_id % device_count``; ``"cpu"``), ``backend`` the
    collective library (``None``: ``nccl`` on the card, ``gloo`` on the
    CPU).  ``timeout_s`` bounds the rendezvous and every collective.

    ``retries`` bounds re-attempts of the rendezvous itself, with the
    JAX module's exponential backoff plus jitter; the last failure is
    raised as it came.  ``store_addr`` is published as
    ``DTDL_STORE_ADDR``, even for a single process, as in JAX.  The
    world is torn down at exit.
    """
    global _initialized, _host_group
    if store_addr:
        os.environ["DTDL_STORE_ADDR"] = store_addr
    if num_processes <= 1 and not coordinator:
        return
    if _initialized:
        return
    if not coordinator:
        raise ValueError(
            "--coordinator host:port is required when --num-processes > 1 "
            "(the reference's --init-method tcp://...)")
    dev = _bind_device(process_id, device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend is 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend runs on the card; the CPU takes "
                         "gloo")
    kwargs = dict(backend=backend, init_method=f"tcp://{coordinator}",
                  world_size=num_processes, rank=process_id,
                  timeout=timedelta(seconds=timeout_s))
    if backend == "nccl":
        kwargs["device_id"] = dev     # NCCL starts here, not at first use
    for attempt in range(retries + 1):
        log.info("rendezvous: coordinator=%s process %d/%d (host %s, %s on "
                 "%s)%s", coordinator, process_id, num_processes,
                 socket.gethostname(), backend, dev,
                 f" [attempt {attempt + 1}/{retries + 1}]" if retries
                 else "")
        try:
            dist.init_process_group(**kwargs)
            break
        except Exception as e:
            if attempt >= retries:
                raise
            delay = backoff_delay(attempt, backoff_s, max_backoff_s,
                                  random.random())
            log.warning("rendezvous attempt %d failed (%s); retrying "
                        "in %.2fs", attempt + 1, e, delay)
            time.sleep(delay)
    _host_group = (dist.group.WORLD if backend == "gloo"
                   else dist.new_group(backend="gloo"))
    _initialized = True
    atexit.register(_shutdown)


def _shutdown() -> None:
    global _initialized, _host_group
    if _initialized:
        try:
            dist.destroy_process_group()
        except Exception:  # pragma: no cover - best-effort teardown
            pass
        _initialized = False
        _host_group = None


def process_count() -> int:
    """Processes in the world (1 without a rendezvous)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 without a rendezvous)."""
    return dist.get_rank() if dist.is_initialized() else 0


def host_group():
    """The gloo group over the world for host operations (``None`` for
    a single process)."""
    return _host_group


def is_leader() -> bool:
    """True on process 0 — the single writer for checkpoints and logs."""
    return process_index() == 0


class BarrierTimeoutError(RuntimeError):
    """A cross-process barrier did not complete within its timeout — some
    peer process is dead, hung, or partitioned.  The error names the
    barrier and the budget so the launcher can kill or replace the job
    instead of the whole world stalling on one dead process."""


# default timeout for every barrier in the process (seconds); 0 / unset
# keeps the block-until-the-collective-timeout behavior, callers can still
# pass an explicit timeout_s per call
_DEFAULT_TIMEOUT = float(os.environ.get("DTDL_BARRIER_TIMEOUT_S", "0")) or None


def barrier(name: str = "barrier", timeout_s: float | None = None,
            mesh=None) -> None:
    """Cross-process sync point over the host group (no-op for a single
    process).  ``mesh``, a mesh over fewer processes than the world
    (:func:`~dtdl_tpu_torch.runtime.mesh.sub_mesh`), makes it span that
    mesh's processes only, over its host group: a run on a sub-mesh meets
    its own barriers while the processes outside it have left.

    ``timeout_s`` (or the process-wide ``DTDL_BARRIER_TIMEOUT_S``
    default) bounds the wait: on expiry, or when a peer's connection
    drops, a named :class:`BarrierTimeoutError` is raised (gloo's
    ``monitored_barrier``, which names the ranks that did not arrive).
    Treat it as fatal for this process: the world's collectives are out
    of step after it.
    """
    group = _host_group
    if mesh is not None and mesh.size < process_count():
        if mesh.size <= 1:
            return
        if mesh.host_group is None:
            raise ValueError(f"barrier {name!r}: the mesh over {mesh.ranks} "
                             f"has no host group (make it with sub_mesh)")
        group = mesh.host_group
    elif process_count() <= 1:
        return
    timeout_s = timeout_s if timeout_s is not None else _DEFAULT_TIMEOUT
    if timeout_s is None:
        dist.barrier(group=group)
        return
    try:
        dist.monitored_barrier(group=group,
                               timeout=timedelta(seconds=timeout_s))
    except RuntimeError as e:
        raise BarrierTimeoutError(
            f"barrier {name!r} timed out after {timeout_s}s — a peer "
            f"process is unreachable or dead ({e})") from e
