"""Analytic model FLOPs and the card's peak: the numerator and the
denominator of a training run's MFU.  The port's copy of the LM part of
dtdl_tpu/obs/goodput.py (``lm_forward_flops``, ``lm_train_flops``, MoE
layers at their activated experts), a ``peak_flops_per_chip`` keyed on
the CUDA device's name, and ``window_fields``, the per-window row fields
of the JAX ``GoodputMeter`` (the meter itself, with the Observer, is
ROADMAP queue A13).

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
    """Matmul-only FLOPs of one LM forward over ``seq`` positions.
    ``cfg`` is an :class:`~dtdl_tpu_torch.models.transformer.LMConfig`
    or a model holding one (``.cfg``).  An MoE layer counts its activated
    expert compute, ``moe_top_k`` times the dense MLP; the router,
    dispatch and capacity padding are not credited."""
    cfg = getattr(cfg, "cfg", cfg)
    t = seq
    qkvo = 4 * 2 * batch * t * cfg.d_model * (cfg.n_heads * cfg.head_dim)
    attn = 2 * 2 * batch * cfg.n_heads * t * t * cfg.head_dim * 0.5
    mlp = 3 * 2 * batch * t * cfg.d_model * cfg.d_ff
    head = 2 * batch * t * cfg.d_model * cfg.vocab_size
    n_moe = cfg.n_layers // cfg.moe_every if cfg.n_experts else 0
    return (cfg.n_layers * (qkvo + attn) + (cfg.n_layers - n_moe) * mlp
            + n_moe * cfg.moe_top_k * mlp + head)


def lm_train_flops(cfg, batch: int, seq: int) -> float:
    """Matmul-only model FLOPs of one LM train step: the forward over the
    ``seq - 1`` predicted positions, times 3 (backward at twice the
    forward)."""
    return 3.0 * lm_forward_flops(cfg, batch, seq - 1)


def window_fields(steps: int, seconds: float, *,
                  flops_per_step: Optional[float] = None,
                  tokens_per_step: Optional[float] = None,
                  samples_per_step: Optional[float] = None,
                  peak_flops: Optional[float] = None) -> dict:
    """The JAX ``GoodputMeter``'s fields for one settled window of
    ``steps`` steps in ``seconds`` (same names, same rounding; empty if
    degenerate): steps_per_sec, tokens_per_sec, samples_per_sec,
    achieved_tflops and, with ``peak_flops``, mfu."""
    if steps <= 0 or seconds <= 0:
        return {}
    out = {"steps_per_sec": round(steps / seconds, 3)}
    if tokens_per_step:
        out["tokens_per_sec"] = round(tokens_per_step * steps / seconds, 1)
    if samples_per_step:
        out["samples_per_sec"] = round(samples_per_step * steps / seconds, 2)
    if flops_per_step:
        achieved = flops_per_step * steps / seconds
        out["achieved_tflops"] = round(achieved / 1e12, 4)
        if peak_flops:
            out["mfu"] = round(achieved / peak_flops, 4)
    return out
