"""BatchNorm with flax.linen.BatchNorm's semantics, for the classifiers.

flax (``linen/normalization.py``) and torch differ where a port that looks
right would not:

* the stored variance: flax keeps the *biased* batch variance, f32
  E[x²] - E[x]² clipped at 0 (``_compute_stats``); torch's
  ``nn.BatchNorm2d`` and ``F.batch_norm(training=True)`` fold the
  *unbiased* n/(n-1) variance into ``running_var``;
* the momentum: flax's 0.9 weighs the old statistic
  (``ra ← 0.9·ra + 0.1·batch``), torch's 0.1 the new one.

So :class:`BatchNorm` normalizes with the batch statistics through
``aten.native_batch_norm`` with no running buffers (two kernels each
way on the card, the batch mean and the inverse deviation 1/√(var + eps)
come back beside the output) and updates its own ``mean``/``var`` under
``no_grad`` from them: var = invstd⁻² - eps, the biased variance up to f32
rounding (about 2.4e-7·(1 + eps/var) relative: below 1e-6 unless var <
4e-6), clipped at 0.  The kernel takes the variance about the mean
(Welford), where flax takes E[x²] - E[x]²: the same value, rounded less.
Eval normalizes with the stored statistics.  Training or eval follows the
module's ``training`` flag.

Parameters and statistics are f32, as flax keeps them
(``param_dtype``, ``force_float32_reductions``); a bf16 input is
normalized in f32 inside the kernel and comes out bf16, as flax's
``dtype=bfloat16`` BatchNorm does.  The names are flax's: params
``scale``/``bias``, statistics ``mean``/``var``.  The input is NCHW (the
classifiers' logical layout, held in ``torch.channels_last`` memory,
which the kernel keeps).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over dim 1."""

    def __init__(self, features: int, *, momentum: float = 0.9,
                 eps: float = 1e-5, scale_init: float = 1.0, device=None):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.scale_init = scale_init
        kw = dict(dtype=torch.float32, device=device)
        self.scale = nn.Parameter(torch.full((features,), scale_init, **kw))
        self.bias = nn.Parameter(torch.zeros(features, **kw))
        self.register_buffer("mean", torch.zeros(features, **kw))
        self.register_buffer("var", torch.ones(features, **kw))

    def reset(self) -> None:
        """flax's init: scale ``scale_init`` (ResNet zeroes each block's
        last), bias 0, mean 0, var 1."""
        with torch.no_grad():
            self.scale.fill_(self.scale_init)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.mean, self.var, self.scale,
                                self.bias, False, 0.0, self.eps)
        y, mean, invstd = torch.ops.aten.native_batch_norm(
            x, self.scale, self.bias, None, None, True, 0.0, self.eps)
        with torch.no_grad():
            var = invstd.pow(-2).sub_(self.eps).clamp_(min=0.0)
            torch._foreach_mul_([self.mean, self.var], self.momentum)
            torch._foreach_add_([self.mean, self.var], [mean, var],
                                alpha=1.0 - self.momentum)
        return y
