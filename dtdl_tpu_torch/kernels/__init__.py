"""Build and bind the port's hand-written Hopper kernels.

Each ``dtdl_tpu_torch/csrc/*.cu`` is compiled by its own ``nvcc`` process
(all started together) for ``sm_90a`` and the objects are linked into one
shared library with a plain C interface,
``build/kernels/libdtdl_tpu_torch_kernels.so`` at the repository root,
loaded with :mod:`ctypes`.  The build happens at first use and again
whenever the hash of the sources and flags changes; it reads nothing but
the sources in the checkout.  A failed build raises
:class:`KernelBuildError`; a launch that the CUDA runtime refuses raises
:class:`KernelLaunchError` with the runtime's message.

Every entry point launches on the caller's stream and allocates nothing:
the wrappers in :mod:`dtdl_tpu_torch.ops` check shapes, types and
contiguity, allocate the outputs and count launches in :data:`LAUNCHES`.
Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "libdtdl_tpu_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

# Launch counts per kernel: each wrapper adds one where it launches its
# kernel, and nowhere else, so a run can show that its path went through
# the kernels (reset with reset_launches()).
LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "rope_rows": 0, "paged_attention": 0}

# Element codes of the C interface (csrc/attn_common.cuh ElemKind).
F32, BF16, INT8, FP8_E4M3 = 0, 1, 2, 3

# The compilers' output of the last build (filled by build()).
BUILD_LOG: list[str] = []


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source; the message holds its output."""


class KernelLaunchError(RuntimeError):
    """The CUDA runtime refused a launch (bad geometry, too much shared
    memory, ...); the message names the kernel and the runtime's error."""


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_NVCC_FALLBACK = "/usr/local/cuda/bin/nvcc"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or _NVCC_FALLBACK
    if not os.path.exists(nvcc):
        raise KernelBuildError(
            f"nvcc not found on PATH or at {_NVCC_FALLBACK}; the kernels "
            f"build only where the CUDA toolkit is installed")
    return nvcc


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_digest() -> str:
    """sha256 over the flags and every source and header in ``csrc/``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()


def build(verbose: bool = False) -> Path:
    """Compile and link the library unless an up-to-date one exists;
    returns its path.  ``verbose`` adds ``-Xptxas -v`` (register and
    spill counts) and forces a rebuild, so :data:`BUILD_LOG` holds it.
    Processes that build at once (the ranks of a data-parallel world)
    take turns on a lock file in the build directory: the first builds,
    the others find its library up to date."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)     # released when the file closes
        return _build_locked(verbose)


def _build_locked(verbose: bool) -> Path:
    digest = source_digest()
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    if lib.exists() and stamp.exists() and stamp.read_text() == digest \
            and not verbose:
        return lib
    nvcc = _nvcc()
    extra = ("-Xptxas", "-v") if verbose else ()
    jobs = []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}.{digest[:16]}.o"
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-I", str(CSRC), "-c", str(src),
               "-o", str(obj)]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for src, obj, proc in jobs:
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{src.name} (exit {proc.returncode}):\n{out}")
    if failed:
        raise KernelBuildError("nvcc failed on " + "\n".join(failed))
    tmp = BUILD_DIR / f"{LIB_NAME}.{os.getpid()}.tmp"
    link = subprocess.run(
        [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
         *(str(o) for _, o, _ in jobs), "-ldl", "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise KernelBuildError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib)
    stamp.write_text(digest)
    BUILD_LOG[:] = log + [link.stdout]
    return lib


_lib = None
_lib_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            handle.dtdl_paged_attention.argtypes = (
                [_P] * 12 + [_I] * 10 + [_F, _P])
            handle.dtdl_paged_attention.restype = _I
            handle.dtdl_flash_fwd.argtypes = [_P] * 9 + [_I] * 6 + [_F, _P]
            handle.dtdl_flash_fwd.restype = _I
            handle.dtdl_flash_bwd_dq.argtypes = [_P] * 11 + [_I] * 6 + [_F, _P]
            handle.dtdl_flash_bwd_dq.restype = _I
            handle.dtdl_flash_bwd_dkv.argtypes = [_P] * 12 + [_I] * 6 + [_F, _P]
            handle.dtdl_flash_bwd_dkv.restype = _I
            handle.dtdl_rope_rows.argtypes = [_P] * 4 + [_I] * 4 + [_P]
            handle.dtdl_rope_rows.restype = _I
            handle.dtdl_error_string.argtypes = [_I]
            handle.dtdl_error_string.restype = ctypes.c_char_p
            _lib = handle
        return _lib


def check(name: str, code: int) -> None:
    """Raise :class:`KernelLaunchError` for a nonzero cudaError_t."""
    if code != 0:
        msg = lib().dtdl_error_string(code).decode()
        raise KernelLaunchError(f"{name}: CUDA error {code} ({msg})")
