"""Analytic model FLOPs and the card's peak: the numerator and the
denominator of a training run's MFU.  The port's copy of the LM part of
dtdl_tpu/obs/goodput.py (``lm_forward_flops``, ``lm_train_flops``, MoE
layers at their activated experts) and of its Caffe part
(``netspec_flops``), a ``peak_flops_per_chip`` keyed on
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


# ---------------------------------------------------------------------------
# CNN FLOPs from a Caffe netspec
# ---------------------------------------------------------------------------

def _pair(param, key: str, default: int) -> tuple:
    v = param.get_scalar(key, None)
    if v is None:
        return (int(param.get_scalar(key + "_h", default)),
                int(param.get_scalar(key + "_w", default)))
    return int(v), int(v)


def _caffe_pool_out(size: int, k: int, s: int, pad: int) -> int:
    # Caffe sizes pooling with CEIL (models/netspec.py pads to match)
    out = -(-(size + 2 * pad - k) // s) + 1
    if pad and (out - 1) * s >= size + pad:
        out -= 1
    return max(out, 1)


def netspec_flops(specs, input_shape, phase: str = "TRAIN",
                  backward: bool = False) -> float:
    """Matmul/conv-only analytic FLOPs of one forward pass of one example
    through a parsed Caffe net (``models.netspec.parse_net`` LayerSpecs,
    or a prototxt path / Message).

    ``input_shape`` is one example's (H, W, C).  Elementwise layers
    (ReLU/LRN/Dropout/Softmax) and pooling count 0, the MFU-numerator
    convention; ``backward=True`` adds the backward at twice the forward
    (one train step = 3x forward).  Multiply by the batch size for a
    step's total."""
    from dtdl_tpu_torch.models.netspec import parse_net
    from dtdl_tpu_torch.utils.prototxt import Message, parse_file

    if isinstance(specs, str):
        specs = parse_net(parse_file(specs))
    elif isinstance(specs, Message):
        specs = parse_net(specs)

    h, w, c = (int(x) for x in input_shape)
    flat = None                      # set once an InnerProduct flattens
    total = 0.0
    for spec in specs:
        if not spec.in_phase(phase):
            continue
        p = spec.params
        if spec.type == "Convolution":
            cp = p.get_scalar("convolution_param", Message())
            kh, kw = _pair(cp, "kernel_size", 3)
            sh, sw = _pair(cp, "stride", 1)
            ph, pw = _pair(cp, "pad", 0)
            cout = int(cp.get_scalar("num_output"))
            group = int(cp.get_scalar("group", 1))
            oh = (h + 2 * ph - kh) // max(sh, 1) + 1
            ow = (w + 2 * pw - kw) // max(sw, 1) + 1
            total += 2.0 * kh * kw * (c // group) * cout * oh * ow
            if bool(cp.get_scalar("bias_term", True)):
                total += float(cout * oh * ow)
            h, w, c, flat = oh, ow, cout, None
        elif spec.type == "Pooling":
            pp = p.get_scalar("pooling_param", Message())
            if bool(pp.get_scalar("global_pooling", False)):
                h = w = 1
                continue
            kh, kw = _pair(pp, "kernel_size", 2)
            sh, sw = _pair(pp, "stride", 1)
            ph, pw = _pair(pp, "pad", 0)
            h = _caffe_pool_out(h, kh, max(sh, 1), ph)
            w = _caffe_pool_out(w, kw, max(sw, 1), pw)
        elif spec.type == "InnerProduct":
            ip = p.get_scalar("inner_product_param", Message())
            nin = flat if flat is not None else h * w * c
            nout = int(ip.get_scalar("num_output"))
            total += 2.0 * nin * nout
            if bool(ip.get_scalar("bias_term", True)):
                total += float(nout)
            flat = nout
        elif spec.type == "Flatten":
            flat = h * w * c
        # Data/ReLU/LRN/Dropout/Softmax/losses: 0 by convention
    return total * (3.0 if backward else 1.0)
