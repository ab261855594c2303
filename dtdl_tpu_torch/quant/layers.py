"""Weight-only quantized linear layer, the port of dtdl_tpu/quant/layers.py.

:class:`QuantLinear` stands where the transformer's float weight module
stands (same module path, same ``kernel`` name and shape) and adds a
``kernel_scale`` in the keepdims per-output-feature layout, so a quantized
``state_dict`` keeps the float one's names (dtdl_tpu_torch/quant/core.py).
The forward is the scale-fused product of ``QuantDenseGeneral``::

    y = (x @ q.to(dtype)) * scale

The JAX product converts the payload inside XLA's fused matmul read; here
``q.to(dtype)`` materializes the weight in the compute dtype before
``torch.matmul``, an extra write and read of the weight per call (the cost
``PERF.md`` records; a hand-written int8/fp8-weight GEMM is later work).
The scale is constant along the contracted dims, so the output multiply is
exactly the dequantized product.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from dtdl_tpu_torch.quant.core import weight_dtypes


class QuantLinear(nn.Module):
    """A quantized weight of shape ``[*in_dims, *out_dims]`` whose first
    ``n_in`` dims are contracted: ``kernel`` (int8, or float8_e4m3fn for
    ``mode='w8f'``) and ``kernel_scale`` ``[1, …, 1, *out_dims]`` (f32, or
    bf16 for fp8).  Neither trains: both are frozen parameters, filled by
    ``load_state_dict`` from :func:`~dtdl_tpu_torch.quant.quantize_params`
    (initially zeros and ones)."""

    def __init__(self, *shape, n_in: int = 1, mode=True, device=None):
        super().__init__()
        payload, scale_dtype = weight_dtypes(mode)
        self.n_in = n_in
        self.kernel = nn.Parameter(
            torch.zeros(shape, dtype=payload, device=device),
            requires_grad=False)
        self.kernel_scale = nn.Parameter(
            torch.ones((1,) * n_in + tuple(shape[n_in:]), dtype=scale_dtype,
                       device=device), requires_grad=False)

    def forward(self, x, dtype):
        """``x`` [..., prod(in_dims)] -> [..., prod(out_dims)] in ``dtype``:
        the product in the compute dtype, the f32 scale on its output."""
        k = self.kernel
        w = k.reshape(math.prod(k.shape[:self.n_in]), -1).to(dtype)
        y = torch.matmul(x.to(dtype), w)
        return (y.float() * self.kernel_scale.reshape(-1).float()).to(dtype)
