"""Conv and Dense layers with flax's initializers and compute dtype, and
the classifiers' shared base.

A flax ``nn.Conv``/``nn.Dense`` built with ``dtype=bfloat16`` keeps its
params in f32 and casts the input and the kernel to bf16 at each use;
:class:`Conv` and :class:`Dense` do the same (``.to(dtype)`` at use, no
global autocast), so training updates f32 master weights.  Their weights
are in torch's layouts, ``[out, in, kh, kw]`` and ``[out, in]``;
:mod:`dtdl_tpu_torch.bridge` transposes flax's ``HWIO`` and ``[in, out]``
kernels onto them.  A conv weight is held in ``torch.channels_last``
memory, so its bf16 copy is already in the layout cuDNN wants for the
channels_last activations.

Initializers, as flax draws them (the values come from a CPU
``torch.Generator``, so one seed gives the same weights on every device):

* ``"conv"``: ``variance_scaling(2.0, "fan_out", "truncated_normal")``,
  the ``conv_init`` of ``pyramidnet.py``/``resnet.py``: a normal of
  variance 2 / (out·kh·kw), divided by 0.8796 (the std of a unit normal
  truncated at ±2) and truncated at ±2 of its std;
* ``"lecun"``: flax's default kernel init, ``lecun_normal``, variance 1 /
  fan-in (in·kh·kw), truncated the same way; biases start at 0.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from dtdl_tpu_torch.device import resolve_device
from dtdl_tpu_torch.models.norm import BatchNorm

# std of a unit normal truncated to [-2, 2] (flax's variance_scaling)
_TRUNC_STD = 0.87962566103423978


def _draw(param, fan: int, scale: float, gen) -> None:
    std = math.sqrt(scale / fan) / _TRUNC_STD
    t = torch.empty(param.shape, dtype=torch.float32)
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=gen)
    param.copy_(t)


class Conv(nn.Module):
    """flax ``nn.Conv(cout, (k, k), strides=stride, padding=padding)`` on
    NCHW input; ``padding`` an int (flax's symmetric int padding, 0 for
    VALID)."""

    def __init__(self, cin: int, cout: int, k: int, *, stride: int = 1,
                 padding: int = 0, bias: bool = False, init: str = "conv",
                 dtype=torch.float32, device=None):
        super().__init__()
        self.stride, self.padding, self.init, self.dtype = (stride, padding,
                                                            init, dtype)
        self.weight = nn.Parameter(torch.empty(
            cout, cin, k, k, device=device).to(
                memory_format=torch.channels_last))
        self.bias = (nn.Parameter(torch.zeros(cout, device=device))
                     if bias else None)

    def reset(self, gen) -> None:
        cout, cin, kh, kw = self.weight.shape
        if self.init == "conv":
            _draw(self.weight, cout * kh * kw, 2.0, gen)
        else:
            _draw(self.weight, cin * kh * kw, 1.0, gen)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x, self.weight.to(self.dtype), b, self.stride,
                        self.padding)


class Dense(nn.Module):
    """flax ``nn.Dense(cout)`` (lecun-normal kernel, zero bias)."""

    def __init__(self, cin: int, cout: int, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, device=device))
        self.bias = nn.Parameter(torch.zeros(cout, device=device))

    def reset(self, gen) -> None:
        _draw(self.weight, self.weight.shape[1], 1.0, gen)
        self.bias.zero_()

    def forward(self, x):
        return F.linear(x, self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class Classifier(nn.Module):
    """Base of the four classifiers: the device, the seeded init and the
    NHWC entry.  Subclasses set ``self.dtype`` and build their layers on
    ``self._dev``."""

    def __init__(self, dtype, device):
        super().__init__()
        self.dtype = dtype
        self._dev = resolve_device(device)

    @property
    def device(self) -> torch.device:
        return self._dev

    def init_weights(self, seed: int = 0) -> "Classifier":
        """flax's initial values, drawn from ``seed`` layer by layer in
        module order; BatchNorm at scale ``scale_init``, bias 0, mean 0,
        var 1."""
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (Conv, Dense)):
                    m.reset(gen)
                elif isinstance(m, BatchNorm):
                    m.reset()
        return self

    def nchw(self, x):
        """An NHWC image batch (numpy's and the JAX models' layout) as
        logical NCHW in channels_last memory, the same bytes, in the
        compute dtype."""
        if x.dim() == 3:                     # [B, H, W] grey images
            x = x[..., None]
        if x.dim() != 4:
            raise ValueError(f"want NHWC images [B, H, W, C], got shape "
                             f"{tuple(x.shape)}")
        return x.permute(0, 3, 1, 2).to(
            self.dtype, memory_format=torch.channels_last)
