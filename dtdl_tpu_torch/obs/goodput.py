"""Analytic model FLOPs and the card's peak: the numerator and the
denominator of a training run's MFU.  The port's copy of the LM part of
dtdl_tpu/obs/goodput.py (``lm_forward_flops``, ``lm_train_flops``) and a
``peak_flops_per_chip`` keyed on the CUDA device's name.

The convention is the JAX package's: matmul-only model FLOPs, causal
attention counted at the computed half, the backward at twice the
forward, recompute (remat, the flash backward's second pass over the
scores) never credited, elementwise work never counted.
"""

from __future__ import annotations

from typing import Optional

import torch

# Dense bf16 tensor-core peak FLOP/s by device-name substring, from
# NVIDIA's data sheet: the H100 SXM, which names itself "H100 80GB HBM3".
_PEAK_BF16 = {"H100 80GB HBM3": 989e12}


def peak_flops_per_chip() -> Optional[float]:
    """bf16 dense peak of the current CUDA device, or None when there is
    no card or its name is not in the table."""
    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name()
    return next((v for k, v in _PEAK_BF16.items() if k in name), None)


def lm_forward_flops(cfg, batch: int, seq: int) -> float:
    """Matmul-only FLOPs of one dense LM forward over ``seq`` positions.
    ``cfg`` is an :class:`~dtdl_tpu_torch.models.transformer.LMConfig`
    or a model holding one (``.cfg``)."""
    cfg = getattr(cfg, "cfg", cfg)
    t = seq
    qkvo = 4 * 2 * batch * t * cfg.d_model * (cfg.n_heads * cfg.head_dim)
    attn = 2 * 2 * batch * cfg.n_heads * t * t * cfg.head_dim * 0.5
    mlp = 3 * 2 * batch * t * cfg.d_model * cfg.d_ff
    head = 2 * batch * t * cfg.d_model * cfg.vocab_size
    return cfg.n_layers * (qkvo + attn + mlp) + head


def lm_train_flops(cfg, batch: int, seq: int) -> float:
    """Matmul-only model FLOPs of one LM train step: the forward over the
    ``seq - 1`` predicted positions, times 3 (backward at twice the
    forward)."""
    return 3.0 * lm_forward_flops(cfg, batch, seq - 1)
