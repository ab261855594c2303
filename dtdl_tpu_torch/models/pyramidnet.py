"""PyramidNet-110 (alpha=270) for CIFAR-10, the port of
dtdl_tpu/models/pyramidnet.py.

Pre-activation residual blocks (BN, conv3x3(stride), BN, ReLU, conv3x3,
BN) with parameter-free shortcuts that zero-pad the new channels and, on
downsampling, average 2x2 windows; the width grows by addrate = alpha /
(3·num_layers) a block, a fractional running width rounded per block
(Python's ``round``, as the JAX model), with ``num_layers - 1`` blocks a
stage: 51 blocks, widths 16, 21, 26, ... 271 for the default model.

Layout: the input is NHWC, permuted once to logical NCHW in
``torch.channels_last`` memory (the same bytes), and every activation
stays channels_last (the shortcut's pads and pool, BN, the residual add),
so cuDNN never transposes around a conv.  The shortcut pads odd H/W with
a zero row/column and then averages 2x2 windows, each over 4 values, the
zeros counted: JAX's pad-then-pool, not ``AvgPool2d(ceil_mode=True)``,
which divides an edge window by its in-bounds count.

Compute dtype: ``dtype`` (f32 or bf16) for the input, the activations and
each conv/Dense at use; f32 params and BN statistics; f32 logits.
``channel_align > 1`` rounds each block's width up to that multiple (the
JAX option, default 1 = the reference's widths).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dtdl_tpu_torch.models.layers import Classifier, Conv, Dense
from dtdl_tpu_torch.models.norm import BatchNorm


class IdentityPadding(nn.Module):
    """Zero-pad ``add_channels`` channels; on stride 2, pad odd H/W by one
    zero row/column and average 2x2 windows (each divided by 4)."""

    def __init__(self, add_channels: int, stride: int = 1):
        super().__init__()
        self.add_channels, self.stride = add_channels, stride

    def forward(self, x):
        if self.add_channels > 0:
            x = F.pad(x, (0, 0, 0, 0, 0, self.add_channels))
        if self.stride == 2:
            h, w = x.shape[2], x.shape[3]
            if h % 2 or w % 2:
                x = F.pad(x, (0, w % 2, 0, h % 2))
            x = F.avg_pool2d(x, 2, 2)
        return x


class ResidualBlock(nn.Module):
    """BN-conv-BN-ReLU-conv-BN plus the padded identity."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 *, dtype=torch.float32, device=None):
        super().__init__()
        conv = dict(padding=1, dtype=dtype, device=device)
        self.shortcut = IdentityPadding(out_channels - in_channels, stride)
        self.bn1 = BatchNorm(in_channels, device=device)
        self.conv1 = Conv(in_channels, out_channels, 3, stride=stride, **conv)
        self.bn2 = BatchNorm(out_channels, device=device)
        self.conv2 = Conv(out_channels, out_channels, 3, **conv)
        self.bn3 = BatchNorm(out_channels, device=device)

    def forward(self, x):
        out = self.conv1(self.bn1(x))
        out = self.conv2(F.relu(self.bn2(out)))
        return self.bn3(out) + self.shortcut(x)


class PyramidNet(Classifier):
    """Additive PyramidNet for 32x32 inputs: NHWC images -> f32 logits."""

    def __init__(self, num_layers: int = 18, alpha: int = 270,
                 num_classes: int = 10, channel_align: int = 1,
                 dtype=torch.float32, *, device=None, seed: int | None = 0):
        super().__init__(dtype, device)
        self.num_layers, self.alpha = num_layers, alpha
        self.channel_align = channel_align
        dev = self.device
        self.stem = Conv(3, 16, 3, padding=1, dtype=dtype, device=dev)
        self.stem_bn = BatchNorm(16, device=dev)

        def width(ch: float) -> int:
            a = channel_align
            return -(-int(round(ch)) // a) * a

        addrate = alpha / (3.0 * num_layers)
        blocks, in_ch = [], 16.0
        for stage_stride in (1, 2, 2):
            stride = stage_stride
            for _ in range(num_layers - 1):
                out_ch = in_ch + addrate
                blocks.append(ResidualBlock(width(in_ch), width(out_ch),
                                            stride, dtype=dtype, device=dev))
                in_ch, stride = out_ch, 1
        self.blocks = nn.ModuleList(blocks)
        final = blocks[-1].bn3.scale.numel() if blocks else 16
        self.bn_final = BatchNorm(final, device=dev)
        self.fc = Dense(final, num_classes, dtype=dtype, device=dev)
        if seed is not None:
            self.init_weights(seed)

    def forward(self, x):
        x = self.stem_bn(self.stem(self.nchw(x)))
        for block in self.blocks:
            x = block(x)
        x = F.relu(self.bn_final(x)).mean((2, 3))   # global average pool
        return self.fc(x).float()


def pyramidnet(dtype=torch.float32, num_classes: int = 10,
               channel_align: int = 1, *, device=None,
               seed: int | None = 0) -> PyramidNet:
    """PyramidNet-110, alpha 270 (the JAX factory), on ``device`` (the
    card unless ``device="cpu"``), weights from ``seed``."""
    return PyramidNet(num_layers=18, alpha=270, num_classes=num_classes,
                      channel_align=channel_align, dtype=dtype,
                      device=device, seed=seed)
