"""Native (C++) host runtime, bound via ctypes: the port of
dtdl_tpu/native/__init__.py.

``src/dtdl_native.cpp`` is the port's own copy of the JAX package's source
(the same C ABI and determinism contract): a threaded batch pipeline, a
zlib IDX reader and a host topology probe.  It is compiled at first use
with the system toolchain (``g++ -O3 -std=c++17 -shared -fPIC -pthread
... -lz``) into ``build/native/`` at the repository root, one library per
source hash, or into ``DTDL_NATIVE_CACHE`` where that is set.  Processes
that build at once (test workers, the ranks of a world) take turns on a
lock file in that directory: the first builds and the others find its
library.  ``DTDL_DISABLE_NATIVE`` turns the library off.  Call sites gate
on :func:`available`; :func:`topology` answers without it.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import subprocess
from pathlib import Path

log = logging.getLogger("dtdl_tpu_torch")

SRC = Path(__file__).resolve().parent / "src" / "dtdl_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_LIB = None
_TRIED = False


def _build_dir() -> Path:
    d = Path(os.environ.get("DTDL_NATIVE_CACHE") or BUILD_DIR)
    d.mkdir(parents=True, exist_ok=True)
    return d


def lib_path() -> Path:
    """Where the library for the current source lives (built or not)."""
    tag = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    return _build_dir() / f"libdtdl_native_{tag}.so"


def _compile(out: Path) -> bool:
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp), "-lz"]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        log.warning("native build failed to run: %s", e)
        return False
    if r.returncode != 0:
        log.warning("native build failed:\n%s", r.stderr[-2000:])
        return False
    os.replace(tmp, out)
    return True


def build() -> Path | None:
    """The library's path, compiled first unless it exists; None when
    the toolchain failed."""
    path = lib_path()
    with open(path.parent / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)     # released when the file closes
        if path.exists() or _compile(path):
            return path
    return None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    lib.dtdl_loader_create.restype = c.c_void_p
    lib.dtdl_loader_create.argtypes = [
        c.c_void_p, c.c_void_p, c.c_int64, c.c_int, c.c_int, c.c_int,
        c.c_int, c.c_int, c.c_int, c.c_int, c.c_uint64,
        c.c_void_p, c.c_void_p]
    lib.dtdl_loader_start_epoch.argtypes = [c.c_void_p, c.c_int]
    lib.dtdl_loader_start_epoch_indices.restype = c.c_int
    lib.dtdl_loader_start_epoch_indices.argtypes = [
        c.c_void_p, c.c_int, c.c_void_p, c.c_int64]
    lib.dtdl_loader_next.restype = c.c_int
    lib.dtdl_loader_next.argtypes = [c.c_void_p, c.c_void_p, c.c_void_p]
    lib.dtdl_loader_n_batches.restype = c.c_int64
    lib.dtdl_loader_n_batches.argtypes = [c.c_void_p]
    lib.dtdl_loader_destroy.argtypes = [c.c_void_p]
    lib.dtdl_idx_header.restype = c.c_int
    lib.dtdl_idx_header.argtypes = [c.c_char_p, c.c_int, c.c_void_p]
    lib.dtdl_idx_read_f32.restype = c.c_int
    lib.dtdl_idx_read_f32.argtypes = [c.c_char_p, c.c_int, c.c_void_p,
                                      c.c_int64, c.c_float]
    lib.dtdl_idx_read_i32.restype = c.c_int
    lib.dtdl_idx_read_i32.argtypes = [c.c_char_p, c.c_int, c.c_void_p,
                                      c.c_int64]
    lib.dtdl_topology.restype = c.c_int
    lib.dtdl_topology.argtypes = [c.c_char_p, c.c_int]
    return lib


def load() -> ctypes.CDLL | None:
    """Compile (once) and load the native library; None if unavailable."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("DTDL_DISABLE_NATIVE"):
        return None
    path = build()
    if path is None:
        return None
    try:
        _LIB = _bind(ctypes.CDLL(str(path)))
    except OSError as e:
        log.warning("native library load failed: %s", e)
        _LIB = None
    return _LIB


def available() -> bool:
    return load() is not None


def topology() -> dict:
    """Host topology probe (cpus, memory, hostname) for the launchers."""
    lib = load()
    if lib is None:
        import multiprocessing
        import socket
        return {"host": socket.gethostname(),
                "cpus": multiprocessing.cpu_count(), "mem_gb": None,
                "native": False}
    buf = ctypes.create_string_buffer(512)
    n = lib.dtdl_topology(buf, len(buf))
    if n < 0:
        return {"native": False}
    import json
    d = json.loads(buf.value.decode())
    d["native"] = True
    return d
