"""Flax parameters -> the port's ``state_dict``.

The JAX package's :class:`TransformerLM` params are a nested dict (the
``params`` collection, unboxed); given as nested dicts of numpy arrays
they map onto :class:`dtdl_tpu_torch.models.transformer.TransformerLM`
leaf for leaf, because the port keeps the flax names and layouts:

========================================  ===========================
flax path                                 layout
========================================  ===========================
``embed``                                 [vocab, d_model]
``block_{i}/attn/{q,k,v}/kernel``         [d_model, H, D] DenseGeneral
``block_{i}/attn/out/kernel``             [H, D, d_model] DenseGeneral
``block_{i}/mlp/{wi,wg}/kernel``          [d_model, d_ff] Dense
``block_{i}/mlp/wo/kernel``               [d_ff, d_model] Dense
``block_{i}/{ln_attn,ln_mlp}/scale``,
``ln_f/scale``                            [d_model]
========================================  ===========================

A missing or extra leaf, or a shape that differs, raises
:class:`BridgeError` naming the path.  Nothing here imports JAX: the
caller hands over numpy arrays (``jax.device_get`` of the tree).
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from dtdl_tpu_torch.device import resolve_device
from dtdl_tpu_torch.models.transformer import TransformerLM


class BridgeError(ValueError):
    """A flax tree that does not fit the model; the message names the
    path."""


def flatten(tree, prefix: str = "") -> dict:
    """Nested dicts -> {"block_0/attn/q/kernel": array, ...}."""
    out = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            out.update(flatten(val, path))
        else:
            out[path] = val
    return out


def flax_to_state_dict(model: TransformerLM, params) -> dict:
    """The ``state_dict`` for ``model`` from a flax param tree, each
    tensor in the dtype and on the device of the model's parameter."""
    flat = flatten(params)
    own = dict(model.named_parameters())
    expected = {name.replace(".", "/"): name for name in own}
    missing = sorted(set(expected) - set(flat))
    extra = sorted(set(flat) - set(expected))
    if missing:
        raise BridgeError(f"flax tree is missing {missing[0]!r}"
                          f"{f' (and {len(missing) - 1} more)' if len(missing) > 1 else ''}")
    if extra:
        raise BridgeError(f"flax tree has a leaf the model does not: "
                          f"{extra[0]!r}"
                          f"{f' (and {len(extra) - 1} more)' if len(extra) > 1 else ''}")
    state = {}
    for path, name in expected.items():
        arr = np.asarray(flat[path])
        param = own[name]
        if tuple(arr.shape) != tuple(param.shape):
            raise BridgeError(f"{path}: flax shape {tuple(arr.shape)} but the "
                              f"model wants {tuple(param.shape)}")
        state[name] = torch.from_numpy(np.array(arr, np.float32)).to(
            device=param.device, dtype=param.dtype)
    return state


def state_dict_to_flax(model: TransformerLM) -> dict:
    """The inverse direction: the model's parameters as a nested dict of
    f32 numpy arrays under the flax paths."""
    tree: dict = {}
    for name, param in model.named_parameters():
        *parents, leaf = name.split(".")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = param.detach().float().cpu().numpy()
    return tree


def load_flax_params(model: TransformerLM, params, device=None
                     ) -> TransformerLM:
    """Load a flax param tree into ``model`` in place and return it.
    ``device`` must match the model's (``None`` = the card, as for every
    entry point of the port)."""
    dev = resolve_device(device)
    if dev != model.device:
        raise ValueError(f"model lives on {model.device}, asked to load "
                         f"onto {dev}")
    model.load_state_dict(flax_to_state_dict(model, params), strict=True)
    return model
