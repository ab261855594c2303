"""3-layer MLP for MNIST, the port of dtdl_tpu/models/mlp.py.

Three Dense layers (``n_units`` wide, ReLU) to ``n_out`` logits, the
input flattened first in its own order (an NHWC image as numpy holds
it).  flax infers the input width at init; here it is ``in_features``
(784, MNIST flattened).  Logits come back f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dtdl_tpu_torch.models.layers import Classifier, Dense


class MLP(Classifier):
    def __init__(self, n_units: int = 1000, n_out: int = 10,
                 dtype=torch.float32, *, in_features: int = 784,
                 device=None, seed: int | None = 0):
        super().__init__(dtype, device)
        kw = dict(dtype=dtype, device=self.device)
        self.fc1 = Dense(in_features, n_units, **kw)
        self.fc2 = Dense(n_units, n_units, **kw)
        self.fc3 = Dense(n_units, n_out, **kw)
        if seed is not None:
            self.init_weights(seed)

    def forward(self, x):
        x = x.reshape(x.shape[0], -1).to(self.dtype)
        x = F.relu(self.fc1(x))
        x = F.relu(self.fc2(x))
        return self.fc3(x).float()
