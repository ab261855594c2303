"""ResNet-50 v1.5, the port of dtdl_tpu/models/resnet.py.

Bottleneck blocks (1x1, 3x3 with the stride (v1.5), 1x1 x4, each conv
followed by BN; the block's last BN starts at scale 0), a projection
(1x1 conv with the stride, BN) where the block changes the shape, a
7x7/2 stem with BN and ReLU, a 3x3/2 max pool with padding 1 (padding
never wins a max), a global mean pool and a Dense head.  NHWC input,
channels_last activations, ``dtype`` compute with f32 params and
statistics, f32 logits, as :mod:`~dtdl_tpu_torch.models.pyramidnet`.

``s2d_stem``: the JAX model can compute its stem in space-to-depth form
(``SpaceToDepthStem``, an even-sized input regrouped to [N, H/2, W/2, 12]
against the 7x7 kernel zero-padded to 8x8 and regrouped to 4x4x12), which
is the same function as the 7x7/2 conv and keeps the kernel's [7, 7, 3,
64] shape; only its parameter path differs (``SpaceToDepthStem_0`` for
``Conv_0``).  The port computes the stem as the 7x7/2 conv either way and
keeps the flag for the bridge, which maps either path onto ``stem``.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dtdl_tpu_torch.models.layers import Classifier, Conv, Dense
from dtdl_tpu_torch.models.norm import BatchNorm


class BottleneckBlock(nn.Module):
    def __init__(self, in_channels: int, filters: int, stride: int = 1, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        conv = dict(dtype=dtype, device=device)
        self.conv1 = Conv(in_channels, filters, 1, **conv)
        self.bn1 = BatchNorm(filters, device=device)
        self.conv2 = Conv(filters, filters, 3, stride=stride, padding=1,
                          **conv)
        self.bn2 = BatchNorm(filters, device=device)
        self.conv3 = Conv(filters, filters * 4, 1, **conv)
        self.bn3 = BatchNorm(filters * 4, scale_init=0.0, device=device)
        # JAX projects where the residual's shape differs from the output's;
        # in ResNet a strided block also widens, so the channels decide
        self.proj = self.proj_bn = None
        if in_channels != filters * 4:
            self.proj = Conv(in_channels, filters * 4, 1, stride=stride,
                             **conv)
            self.proj_bn = BatchNorm(filters * 4, device=device)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.proj is None else self.proj_bn(self.proj(x))
        return F.relu(y + residual)


class ResNet(Classifier):
    """NHWC images -> f32 logits over ``num_classes``."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 num_classes: int = 1000, dtype=torch.float32,
                 s2d_stem: bool = False, *, device=None,
                 seed: int | None = 0):
        super().__init__(dtype, device)
        self.stage_sizes, self.s2d_stem = tuple(stage_sizes), s2d_stem
        dev = self.device
        self.stem = Conv(3, 64, 7, stride=2, padding=3, dtype=dtype,
                         device=dev)
        self.stem_bn = BatchNorm(64, device=dev)
        blocks, cin = [], 64
        for i, n_blocks in enumerate(self.stage_sizes):
            for j in range(n_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(BottleneckBlock(cin, 64 * 2 ** i, stride,
                                              dtype=dtype, device=dev))
                cin = 64 * 2 ** i * 4
        self.blocks = nn.ModuleList(blocks)
        self.fc = Dense(cin, num_classes, dtype=dtype, device=dev)
        if seed is not None:
            self.init_weights(seed)

    def forward(self, x):
        x = F.relu(self.stem_bn(self.stem(self.nchw(x))))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for block in self.blocks:
            x = block(x)
        return self.fc(x.mean((2, 3))).float()


ResNet50 = partial(ResNet, stage_sizes=(3, 4, 6, 3))


def resnet50(dtype=torch.float32, num_classes: int = 1000,
             s2d_stem: bool = False, *, device=None,
             seed: int | None = 0) -> ResNet:
    """ResNet-50 (the JAX factory) on ``device`` (the card unless
    ``device="cpu"``), weights from ``seed``."""
    return ResNet50(num_classes=num_classes, dtype=dtype, s2d_stem=s2d_stem,
                    device=device, seed=seed)
