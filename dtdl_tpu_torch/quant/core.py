"""Symmetric int8 and fp8 quantization for serving (weights and KV), the
port of dtdl_tpu/quant/core.py.

**Weights**: every matmul kernel of the transformer (attention q/k/v/out,
SwiGLU wi/wg/wo, MoE expert wi/wg/wo) is stored as an int8 tensor plus an
f32 scale per OUTPUT feature (``scale_c = max|w[..., c]| / 127``; per
expert and output feature for the experts), or, for ``'w8f'``, as a
float8_e4m3fn tensor plus a bf16 scale (``max / 448``).  The scale is
constant along the contracted dims, so it factors out of the product:
``x @ (q·s) == (x @ q)·s`` (:class:`~dtdl_tpu_torch.quant.layers.QuantLinear`).
The embedding, the norm scales and the MoE routers stay as they are.

**KV**: each new K/V row gets a scale from its own max (write-once, so an
append-only page never needs rescaling): int8 payload with an f32 scale,
or fp8 with a bf16 scale, per (row or page, head, position).

The fp8 traps, carried from the JAX file: a cast to fp8 overflows to NaN
rather than saturating, so every fp8 quantizer clips to ±448 in f32
first; the stored bf16 scale must be exactly the divisor, so each scale is
rounded through bf16 before the divide.  All-zero channels and rows get
scale 1.  int8 rounds half to even (``torch.round``, as ``jnp.round``).

Parameters here are the port's ``state_dict`` layout: a flat mapping from
dotted names (``block_0.attn.q.kernel``) to tensors.  A quantized tree
keeps every name and adds a ``<name>_scale`` sibling beside each
quantized kernel, the schema of the JAX package's ``quantize_params``
with ``.`` for ``/``.
"""

from __future__ import annotations

import math
from collections.abc import Mapping

import torch

#: suffix linking a quantized tensor to its scale
SCALE_SUFFIX = "_scale"


class Fp8UnsupportedError(ValueError):
    """fp8 asked for in a configuration that cannot serve it (fp8 weights
    under a mesh whose rules are not a named preset), raised by name at
    engine construction."""

FP8_DTYPE = torch.float8_e4m3fn
FP8_MAX = 448.0


def canon_kv_dtype(kv_dtype):
    """Normalize a ``kv_dtype`` argument: ``None`` (K/V at the model
    dtype), int8 (``"int8"``/``torch.int8``) or fp8 (``"fp8"``,
    ``"float8_e4m3fn"``, ``torch.float8_e4m3fn``); anything else raises
    a ValueError naming ``kv_dtype``."""
    if kv_dtype is None:
        return None
    if kv_dtype in ("int8", torch.int8):
        return torch.int8
    if kv_dtype in ("fp8", "float8_e4m3fn", FP8_DTYPE):
        return FP8_DTYPE
    raise ValueError(f"kv_dtype must be None (model dtype), int8 or fp8, "
                     f"got {kv_dtype!r}")


def kv_scale_dtype(kv_dtype):
    """Scale dtype of a quantized KV arena: f32 for int8, bf16 for fp8
    (None for an unquantized arena)."""
    kv_dtype = canon_kv_dtype(kv_dtype)
    if kv_dtype is None:
        return None
    return torch.bfloat16 if kv_dtype == FP8_DTYPE else torch.float32


def canon_weight_quant(mode):
    """Normalize a ``quantize_weights`` argument: ``False``/``None`` ->
    ``False``; ``True``/``"int8"``/``torch.int8`` -> ``True`` (int8);
    ``"w8f"``/``"fp8"``/``torch.float8_e4m3fn`` -> ``"w8f"``.  Anything
    else raises a ValueError naming ``quantize_weights``."""
    if mode is None or mode is False:
        return False
    if mode is True or mode in ("int8", torch.int8):
        return True
    if mode in ("w8f", "fp8", FP8_DTYPE):
        return "w8f"
    raise ValueError(f"quantize_weights must be False, True/'int8' or "
                     f"'w8f' (fp8), got {mode!r}")


def weight_dtypes(mode):
    """(payload, scale) dtypes of a quantized weight for ``mode`` (a
    :func:`canon_weight_quant` value): int8 + f32 or fp8 + bf16."""
    if mode == "w8f":
        return FP8_DTYPE, torch.bfloat16
    return torch.int8, torch.float32


def quantize_tensor(w, scale_shape, dtype=torch.int8):
    """Symmetric per-channel quantization of one weight tensor.

    ``scale_shape`` is ``w.shape`` with every contracted (input) dim set
    to 1.  int8 returns ``(q int8, scale f32)`` with ``|w - q·scale| <=
    scale/2``; float8_e4m3fn divides by the bf16-rounded ``max/448`` and
    clips to ±448 before the cast, returning a bf16 scale.  All-zero
    channels get scale 1."""
    w = torch.as_tensor(w)
    if len(scale_shape) != w.dim() or any(
            s not in (1, d) for s, d in zip(scale_shape, w.shape)):
        raise ValueError(f"scale shape {tuple(scale_shape)} does not "
                         f"broadcast against weight shape {tuple(w.shape)}")
    axes = tuple(i for i, s in enumerate(scale_shape) if s == 1)
    w32 = w.float()
    amax = w32.abs().amax(dim=axes, keepdim=True) if axes else w32.abs()
    one = torch.ones((), dtype=torch.float32, device=w.device)
    if dtype == FP8_DTYPE:
        scale = torch.where(amax > 0, amax / FP8_MAX, one)
        scale = scale.to(torch.bfloat16).float()
        q = (w32 / scale).clamp(-FP8_MAX, FP8_MAX).to(FP8_DTYPE)
        return q, scale.to(torch.bfloat16)
    if dtype != torch.int8:
        raise ValueError(f"quantize_tensor supports int8 or fp8 payloads, "
                         f"got {dtype}")
    scale = torch.where(amax > 0, amax / 127.0, one)
    q = torch.round(w32 / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def _sites(model) -> dict:
    """{state_dict name of each matmul weight: the keepdims shape of its
    scale, 1 on every contracted dim}, read off the model's modules: a
    weight module's ``kernel`` contracts its first ``n_in`` dims; an MoE
    block's expert weights [E, in, out] (``EXPERT_WEIGHTS``) take a scale
    per (expert, out-channel), [E, 1, out].  The MoE router is neither."""
    out = {}
    for name, m in model.named_modules():
        prefix = f"{name}." if name else ""
        if hasattr(m, "n_in"):
            shape = m.kernel.shape
            out[prefix + "kernel"] = (1,) * m.n_in + tuple(shape[m.n_in:])
        for leaf in getattr(m, "EXPERT_WEIGHTS", ()):
            e, _, d_out = getattr(m, leaf).shape
            out[prefix + leaf] = (e, 1, d_out)
    return out


def quantize_params(model, params, mode=True) -> dict:
    """A float ``state_dict`` -> the quantized one of
    ``model.clone(quantize=mode)``: each matmul kernel of ``model`` (the
    model the params belong to, quantized or not) becomes the payload
    under its own name plus a ``<name>_scale`` sibling in the keepdims
    per-output-feature layout; every other entry passes through.  A tree
    that already carries a scale sibling raises (re-quantizing an int8
    payload as if it were weights would be silent garbage), as does a
    missing or unexpected entry.  ``mode`` is a :func:`canon_weight_quant`
    value (``True`` int8, ``'w8f'`` fp8)."""
    payload, _ = weight_dtypes(canon_weight_quant(mode) or True)
    sites = _sites(model)
    expected = {n for n, _ in model.named_parameters()
                if not n.endswith(SCALE_SUFFIX)}
    missing = sorted(expected - set(params))
    if missing:
        raise ValueError(f"params are missing {missing[0]}")
    out = {}
    for name, w in params.items():
        if name.endswith(SCALE_SUFFIX) and name[:-len(SCALE_SUFFIX)] in params:
            raise ValueError(f"params already carry {name}: the tree is "
                             f"already quantized")
        if name not in expected:
            raise ValueError(f"unexpected params entry {name}")
        if name not in sites:
            out[name] = w
            continue
        q, s = quantize_tensor(w, sites[name], dtype=payload)
        out[name], out[name + SCALE_SUFFIX] = q, s
    return out


def dequantize_params(qparams) -> dict:
    """Inverse of :func:`quantize_params` up to the rounding: every
    ``(q, <name>_scale)`` pair becomes the f32 ``q · scale``."""
    out = {}
    for name, val in qparams.items():
        if name.endswith(SCALE_SUFFIX) and name[:-len(SCALE_SUFFIX)] in qparams:
            continue
        scale = qparams.get(name + SCALE_SUFFIX)
        out[name] = val if scale is None else val.float() * scale.float()
    return out


def kv_quantize(x, dtype=torch.int8):
    """Per-(…, position) symmetric quantization of K/V rows ``[..., D]``:
    ``(q [..., D], scale [...])`` with ``x ≈ q · scale[..., None]``, the
    scale from the row's own max.  int8: f32 scale, ``round(x / scale)``;
    fp8: bf16 scale, the row divided by the bf16-rounded scale and
    clipped to ±448 before the cast."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1)
    one = torch.ones((), dtype=torch.float32, device=x.device)
    if dtype == FP8_DTYPE:
        scale = torch.where(amax > 0, amax / FP8_MAX, one)
        scale = scale.to(torch.bfloat16).float()
        q = (x32 / scale[..., None]).clamp(-FP8_MAX, FP8_MAX).to(FP8_DTYPE)
        return q, scale.to(torch.bfloat16)
    scale = torch.where(amax > 0, amax / 127.0, one)
    return torch.round(x32 / scale[..., None]).to(torch.int8), scale


def tree_bytes(tree) -> int:
    """Total bytes of a nested mapping whose leaves are tensors or
    ``(shape, dtype)`` pairs (the port's ``*_shapes`` layout)."""
    if isinstance(tree, Mapping):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    shape, dtype = tree
    itemsize = torch.empty((), dtype=dtype).element_size()
    return int(math.prod(shape)) * itemsize
