"""Reading the JAX package's orbax snapshots into the port's state.

The JAX ``Checkpointer.save`` writes a ``TrainState`` with orbax's
``StandardCheckpointer``: a directory holding ``_METADATA`` (JSON: every
leaf's key path and value type, and whether the arrays live in an OCDBT
key-value store and as zarr v2 or v3) and the arrays themselves, one
zarr array per leaf under the key path joined by dots
(``params.block_0.attn.q.kernel``, ``opt_state.0.mu.embed``).

The arrays are read through ``tensorstore`` directly, because ``orbax``
imports JAX.  ``tensorstore`` is imported only when a snapshot is read;
where it does not import (the card's machine), reading a snapshot raises
``NotImplementedError`` naming it and ROADMAP A8b, with no fallback.

:func:`state_tree` maps the JAX ``TrainState`` onto the tree of
:func:`dtdl_tpu_torch.train.state.state_to_tree` for a port state: the
params and ``batch_stats`` under their flax paths as they stand, and the
optax state onto the torch optimizer's slots (``scale_by_adam``'s
``mu``/``nu`` as ``exp_avg``/``exp_avg_sq`` and its ``count`` as each
parameter's ``step``; ``trace`` as ``momentum_buffer``; a schedule's
``count`` as the param groups' ``count``).  Every value is carried bit
for bit; what maps onto nothing raises ``ValueError``.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

METADATA = "_METADATA"


def is_orbax_snapshot(path: str) -> bool:
    return os.path.isfile(os.path.join(path, METADATA))


def require_tensorstore():
    """The ``tensorstore`` module, or the named refusal."""
    try:
        import tensorstore
    except ImportError as e:
        raise NotImplementedError(
            "reading an orbax snapshot of the JAX package needs the "
            "tensorstore package, which does not import here (ROADMAP A8b: "
            "orbax snapshots are read only where tensorstore imports)") from e
    return tensorstore


def read_tree(path: str) -> dict:
    """The snapshot at ``path`` as nested dicts of numpy arrays (``None``
    where orbax stored no value), keyed as the JAX pytree's key path."""
    ts = require_tensorstore()
    with open(os.path.join(path, METADATA)) as f:
        meta = json.load(f)
    base = os.path.abspath(path) + "/"
    kv = ({"driver": "ocdbt", "base": f"file://{base}"}
          if meta.get("use_ocdbt", True) else {"driver": "file", "path": base})
    driver = "zarr3" if meta.get("use_zarr3") else "zarr"
    tree: dict = {}
    for entry in meta["tree_metadata"].values():
        keys = [str(k["key"]) for k in entry["key_metadata"]]
        value = entry["value_metadata"]
        if value.get("skip_deserialize") or value["value_type"] == "None":
            leaf = None
        else:
            spec = {"driver": driver,
                    "kvstore": {**kv, "path": ".".join(keys) + "/"}}
            leaf = np.asarray(ts.open(spec, open=True).result()
                              .read().result())
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return tree


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree if tree.flags.c_contiguous
                                else tree.copy(order="C"))
    return tree


def _optax_states(opt_state) -> list:
    """The optax states of a chain (a dict of ``"0"``, ``"1"``, ...), or
    of a single transform, that hold anything."""
    if isinstance(opt_state, dict) and opt_state and all(
            k.isdigit() for k in opt_state):
        return [s for k in sorted(opt_state, key=int)
                for s in _optax_states(opt_state[k])]
    return [] if opt_state is None else [opt_state]


def state_tree(raw: dict, like: dict) -> dict:
    """The JAX ``TrainState`` tree ``raw`` (from :func:`read_tree`) as the
    port's snapshot tree shaped as ``like`` (``state_to_tree`` of the
    state to restore into)."""
    want = like["opt_state"]
    opt: dict = {}
    for s in _optax_states(raw.get("opt_state")):
        keys = set(s) if isinstance(s, dict) else set()
        if keys == {"count", "mu", "nu"}:
            opt["exp_avg"], opt["exp_avg_sq"] = s["mu"], s["nu"]
            step = want.get("step", {})
            count = float(np.asarray(s["count"]))
            opt["step"] = _like_scalars(step, count)
        elif keys == {"trace"}:
            opt["momentum_buffer"] = s["trace"]
        elif keys == {"count"}:
            opt["count"] = int(np.asarray(s["count"]))
        else:
            raise ValueError(
                f"the snapshot's optax state with leaves {sorted(keys)} has "
                f"no counterpart in the port's optimizers (adam/adamw "
                f"moments, sgd momentum, a schedule's count)")
    return {"step": int(np.asarray(raw["step"])),
            "params": _tensors(raw["params"]),
            "opt_state": _tensors(opt),
            "batch_stats": _tensors(raw.get("batch_stats"))}


def _like_scalars(like, value: float):
    """``value`` at every leaf of ``like`` (Adam's per-parameter steps),
    each a 0-d CPU tensor of that leaf's dtype."""
    if isinstance(like, dict):
        return {k: _like_scalars(v, value) for k, v in like.items()}
    return torch.tensor(value, dtype=like.dtype)
