"""Train state, the port of dtdl_tpu/train/state.py.

The JAX :class:`TrainState` is an immutable pytree (step, params,
opt_state, batch_stats) that every step replaces.  Here the parameters
live in the model and the optimizer state in a ``torch.optim``
optimizer, and :meth:`TrainState.apply_gradients` updates both in place
where JAX returns a new state: PyTorch keeps one copy of the weights and
moments instead of a donated old and a new one.  A classifier's BatchNorm
statistics live in its BN modules' buffers, which a train-mode forward
updates; :attr:`TrainState.batch_stats` shows them in the flax tree
shape.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from dtdl_tpu_torch.bridge import batch_stats_view
from dtdl_tpu_torch.device import resolve_device
from dtdl_tpu_torch.train.optim import Transform


@dataclass
class TrainState:
    step: int
    model: torch.nn.Module           # the params
    optimizer: torch.optim.Optimizer  # the opt_state

    @property
    def batch_stats(self) -> dict | None:
        """The model's BatchNorm statistics as the flax ``batch_stats``
        tree of its live buffers; ``None`` for a model without BatchNorm
        (the LM, the MLP, the CNN)."""
        return batch_stats_view(self.model)

    def apply_gradients(self) -> "TrainState":
        """One optimizer update from the gradients the parameters hold
        (``.grad``), and step + 1: in place, where JAX's
        ``apply_gradients`` returns a new state."""
        self.optimizer.step()
        self.step += 1
        return self


def init_state(model, seed: int | None, tx: Transform,
               device=None) -> TrainState:
    """Weights of ``model`` from ``seed`` (an explicit CPU
    ``torch.Generator``, so one seed gives the same weights on every
    device; a classifier as the JAX ``conv_init``/flax defaults draw
    them, BatchNorm statistics reset; ``None`` keeps the weights the
    model holds, e.g. after a bridge load) and the optimizer ``tx`` over
    them.  ``device`` must be the model's (``None`` = the card, as for
    every entry point)."""
    dev = resolve_device(device)
    if dev != model.device:
        raise ValueError(f"the model lives on {model.device}, the state was "
                         f"asked for {dev}")
    if seed is not None:
        model.init_weights(seed)
    model.train()
    return TrainState(step=0, model=model,
                      optimizer=tx.init(model.parameters()))
