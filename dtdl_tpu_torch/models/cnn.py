"""MNIST 3-conv CNN, the port of dtdl_tpu/models/cnn.py.

Conv 32 3x3 VALID + ReLU, MaxPool 2, Conv 64 3x3 VALID + ReLU, MaxPool 2,
Conv 64 3x3 VALID + ReLU, Flatten, Dense 64 + ReLU, Dense ``num_classes``
logits (f32).  The convs carry a bias (flax's default) and lecun-normal
kernels.  The flatten is in NHWC order (h, w, c), as the JAX model
flattens, so ``fc1``'s rows are ``Dense_0``'s as they stand.  flax infers
``Dense_0``'s width at init; here it follows from ``image_size`` (28).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dtdl_tpu_torch.models.layers import Classifier, Conv, Dense


class MnistCNN(Classifier):
    def __init__(self, num_classes: int = 10, dtype=torch.float32, *,
                 image_size: int = 28, device=None, seed: int | None = 0):
        super().__init__(dtype, device)
        kw = dict(bias=True, init="lecun", dtype=dtype, device=self.device)
        self.conv1 = Conv(1, 32, 3, **kw)
        self.conv2 = Conv(32, 64, 3, **kw)
        self.conv3 = Conv(64, 64, 3, **kw)
        side = ((image_size - 2) // 2 - 2) // 2 - 2
        self.fc1 = Dense(side * side * 64, 64, dtype=dtype,
                         device=self.device)
        self.fc2 = Dense(64, num_classes, dtype=dtype, device=self.device)
        if seed is not None:
            self.init_weights(seed)

    def forward(self, x):
        x = self.nchw(x)
        x = F.max_pool2d(F.relu(self.conv1(x)), 2, 2)
        x = F.max_pool2d(F.relu(self.conv2(x)), 2, 2)
        x = F.relu(self.conv3(x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # NHWC order
        x = F.relu(self.fc1(x))
        return self.fc2(x).float()
