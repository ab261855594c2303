"""Topology discovery and description, the port of
dtdl_tpu/runtime/topology.py over ``torch.cuda`` and ``torch.distributed``.

Each process drives one device: the world's devices are its processes'.
On the card the description carries the name and power limit that
``nvidia-smi`` reports, where the JAX one carries the TPU's ICI
coordinates.
"""

from __future__ import annotations

import subprocess

import torch

from dtdl_tpu_torch.device import resolve_device
from dtdl_tpu_torch.runtime.bootstrap import process_count, process_index


def nvidia_smi_line() -> str:
    """``name, power.limit`` of the visible cards as nvidia-smi gives
    them, or why it could not be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out.stdout.strip() or f"nvidia-smi: {out.stderr.strip()}"


def describe_topology(device=None) -> dict:
    """This process's view of the world; ``device`` as every entry point
    takes it (``None``: the card)."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    info = {
        "platform": "gpu" if on_card else "cpu",
        "device_kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "num_devices": process_count(),
        "num_local_devices": 1,
        "num_processes": process_count(),
        "process_index": process_index(),
    }
    if on_card:
        info["visible_cards"] = torch.cuda.device_count()
        info["card"] = nvidia_smi_line()
    return info


def banner(device=None) -> str:
    """Human-readable topology banner, printed by the leader at startup."""
    t = describe_topology(device)
    lines = [
        "==========================================",
        f" platform        : {t['platform']} ({t['device_kind']})",
        f" global devices  : {t['num_devices']}",
        f" local devices   : {t['num_local_devices']}",
        f" processes       : {t['num_processes']} (this = {t['process_index']})",
    ]
    if "card" in t:
        lines.append(f" card            : {t['card']}")
    lines.append("==========================================")
    return "\n".join(lines)
