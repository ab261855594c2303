"""Where the port runs: on the CUDA card, unless the caller asks for the CPU.

Every entry point of the port (``transformer_lm``, ``InferenceEngine``,
``Scheduler``, ``bridge.load_flax_params``) takes ``device=`` and resolves
it here.  ``None`` means the card.  With no CUDA device visible that is an
error, :class:`NoCudaDeviceError`, never a quiet fall back to the CPU: a
run on the CPU is asked for by name (``device="cpu"``), as the CPU tests
do.
"""

from __future__ import annotations

import numpy as np
import torch


class NoCudaDeviceError(RuntimeError):
    """The port was asked to run on the card, and no CUDA device is
    visible to this process.  Pass ``device="cpu"`` to run on the CPU."""


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device; ``"cpu"``/``"cuda[:n]"``/a
    :class:`torch.device` as given.  Raises :class:`NoCudaDeviceError`
    when the card is wanted and absent."""
    if device is None:
        if not torch.cuda.is_available():
            raise NoCudaDeviceError(
                "no CUDA device is visible to this process; the port runs on "
                "the card by default, pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise NoCudaDeviceError(
                f"device {device!r} asked for, but no CUDA device is "
                f"visible to this process")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"the port runs on 'cuda' or 'cpu', got {device!r}")
    return dev


def upload(array, device, dtype=None) -> torch.Tensor:
    """Host numpy -> ``device`` without waiting for the card: a pinned
    staging copy and a non-blocking transfer (a plain ``.to`` from
    pageable memory would synchronize the stream)."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if dtype is not None:
        t = t.to(dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t
