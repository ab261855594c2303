"""Flax parameters (and BatchNorm statistics) -> the port's ``state_dict``.

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
``block_{i}/moe/router/kernel``           [d_model, E] Dense, f32
``block_{i}/moe/{wi,wg}``                 [E, d_model, d_ff]
``block_{i}/moe/wo``                      [E, d_ff, d_model]
``block_{i}/{ln_attn,ln_mlp}/scale``,
``ln_f/scale``                            [d_model]
========================================  ===========================

A quantized JAX tree (``quant.quantize_params``) maps onto a model built
with ``quantize=``: each quantized kernel keeps its path and gains a
``<path>_scale`` sibling (an MoE expert weight's ``moe/wi_scale`` [E, 1,
d_ff], ...), both carried bit for bit.  An int8 payload
crosses as int8; an fp8 one (an ml_dtypes ``float8_e4m3fn`` array) crosses
as its uint8 bytes, viewed as ``torch.float8_e4m3fn``, never through a
float cast; bf16 scales cross exactly through f32.

The classifiers (:class:`MLP`, :class:`MnistCNN`, :class:`PyramidNet`,
:class:`ResNet`) keep readable module names and torch's layouts, and this
module owns the map onto flax's auto names: a conv kernel ``HWIO`` is
the weight ``[O, I, kh, kw]``, a Dense kernel ``[in, out]`` the weight
``[out, in]``, biases and BatchNorm ``scale``/``bias`` (params) and
``mean``/``var`` (the ``batch_stats`` collection) carry across as they
stand:

==============================================  ==========================
flax path                                       port module
==============================================  ==========================
MLP ``Dense_{0,1,2}``                           ``fc{1,2,3}``
MnistCNN ``Conv_{0,1,2}``, ``Dense_{0,1}``      ``conv{1,2,3}``, ``fc{1,2}``
PyramidNet ``Conv_0``, ``BatchNorm_0``          ``stem``, ``stem_bn``
``ResidualBlock_{i}/BatchNorm_{0,1,2}``         ``blocks.{i}.bn{1,2,3}``
``ResidualBlock_{i}/Conv_{0,1}``                ``blocks.{i}.conv{1,2}``
``BatchNorm_1``, ``Dense_0``                    ``bn_final``, ``fc``
ResNet ``Conv_0`` or ``SpaceToDepthStem_0``     ``stem`` (either path)
``BatchNorm_0``, ``Dense_0``                    ``stem_bn``, ``fc``
``BottleneckBlock_{i}/Conv_{0,1,2}``            ``blocks.{i}.conv{1,2,3}``
``BottleneckBlock_{i}/BatchNorm_{0,1,2}``       ``blocks.{i}.bn{1,2,3}``
``BottleneckBlock_{i}/{Conv_3,BatchNorm_3}``    ``blocks.{i}.{proj,proj_bn}``
CaffeNet ``<layer name>`` (Conv, Dense)         ``layers.<layer name>``
==============================================  ==========================

A missing or extra leaf, or a shape or payload type that differs, raises
:class:`BridgeError` naming the path.  Nothing here imports JAX: the
caller hands over numpy arrays (``jax.device_get`` of the tree).

KV page payloads (what the engines' ``extract_pages`` return and their
``inject_pages`` take) cross in both directions by
:func:`jax_pages_to_torch` and :func:`torch_pages_to_jax`.  Both packages
key a payload as the arena, ``block_{i}/attn/pages_key`` (and
``pages_value``, ``pages_key_scale``, ``pages_value_scale``), and both
lay each leaf out ``[n_pages, H, page_size, head_dim]`` (scales
``[n_pages, H, page_size]``), so no leaf is transposed: the converters
change only how a dtype numpy lacks is carried.  The JAX payload holds
ml_dtypes ``bfloat16``/``float8_e4m3fn`` arrays, the port's their bits
(uint16, uint8).
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from dtdl_tpu_torch.device import resolve_device
from dtdl_tpu_torch.models.cnn import MnistCNN
from dtdl_tpu_torch.models.layers import Classifier, Conv
from dtdl_tpu_torch.models.mlp import MLP
from dtdl_tpu_torch.models.netspec import CaffeNet
from dtdl_tpu_torch.models.norm import BatchNorm
from dtdl_tpu_torch.models.pyramidnet import PyramidNet
from dtdl_tpu_torch.models.resnet import ResNet


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


def _check_leaves(expected, flat, what: str = "flax tree") -> None:
    missing = sorted(set(expected) - set(flat))
    extra = sorted(set(flat) - set(expected))
    if missing:
        raise BridgeError(f"{what} is missing {missing[0]!r}"
                          f"{f' (and {len(missing) - 1} more)' if len(missing) > 1 else ''}")
    if extra:
        raise BridgeError(f"{what} has a leaf the model does not: "
                          f"{extra[0]!r}"
                          f"{f' (and {len(extra) - 1} more)' if len(extra) > 1 else ''}")


def flax_to_state_dict(model, params, batch_stats=None) -> dict:
    """The ``state_dict`` for ``model`` from a flax param tree (and, for
    a classifier with BatchNorm, its ``batch_stats`` tree), each tensor
    in the dtype and on the device of the model's own."""
    if isinstance(model, Classifier):
        return _classifier_state_dict(model, params, batch_stats)
    if batch_stats:
        raise BridgeError("the LM has no BatchNorm statistics, but a "
                          "batch_stats tree was given")
    flat = flatten(params)
    own = dict(model.named_parameters())
    expected = {name.replace(".", "/"): name for name in own}
    _check_leaves(expected, flat)
    state = {}
    for path, name in expected.items():
        arr = np.asarray(flat[path])
        param = own[name]
        if tuple(arr.shape) != tuple(param.shape):
            raise BridgeError(f"{path}: flax shape {tuple(arr.shape)} but the "
                              f"model wants {tuple(param.shape)}")
        state[name] = _to_tensor(path, arr, param)
    return state


def _to_tensor(path, arr, param):
    """One flax leaf as a tensor of ``param``'s dtype and device: a
    quantized payload bit for bit, a float through f32."""
    if param.dtype in (torch.int8, torch.float8_e4m3fn):
        want = "int8" if param.dtype == torch.int8 else "float8_e4m3fn"
        if arr.dtype.name != want:
            raise BridgeError(f"{path}: flax payload {arr.dtype.name} but the "
                              f"model wants {want}")
        t = torch.from_numpy(np.ascontiguousarray(arr).view(
            np.int8 if want == "int8" else np.uint8))
        if want != "int8":
            t = t.view(torch.float8_e4m3fn)
        return t.to(param.device)
    return torch.from_numpy(np.array(arr, np.float32)).to(
        device=param.device, dtype=param.dtype)


def _module_paths(model: Classifier, stem: str | None = None) -> dict:
    """Port module name -> flax module path.  ``stem`` names a ResNet's
    stem path (``Conv_0`` or ``SpaceToDepthStem_0``; default by the
    model's ``s2d_stem``)."""
    if isinstance(model, MLP):
        return {f"fc{i + 1}": f"Dense_{i}" for i in range(3)}
    if isinstance(model, CaffeNet):
        return {f"layers.{name}": name for name in model.layers}
    if isinstance(model, MnistCNN):
        return {"conv1": "Conv_0", "conv2": "Conv_1", "conv3": "Conv_2",
                "fc1": "Dense_0", "fc2": "Dense_1"}
    if isinstance(model, PyramidNet):
        paths = {"stem": "Conv_0", "stem_bn": "BatchNorm_0",
                 "bn_final": "BatchNorm_1", "fc": "Dense_0"}
        for i in range(len(model.blocks)):
            for port, name in (("bn1", "BatchNorm_0"), ("conv1", "Conv_0"),
                               ("bn2", "BatchNorm_1"), ("conv2", "Conv_1"),
                               ("bn3", "BatchNorm_2")):
                paths[f"blocks.{i}.{port}"] = f"ResidualBlock_{i}/{name}"
        return paths
    if isinstance(model, ResNet):
        if stem is None:
            stem = "SpaceToDepthStem_0" if model.s2d_stem else "Conv_0"
        paths = {"stem": stem, "stem_bn": "BatchNorm_0", "fc": "Dense_0"}
        for i, block in enumerate(model.blocks):
            names = [(f"conv{j + 1}", f"Conv_{j}") for j in range(3)]
            names += [(f"bn{j + 1}", f"BatchNorm_{j}") for j in range(3)]
            if block.proj is not None:
                names += [("proj", "Conv_3"), ("proj_bn", "BatchNorm_3")]
            for port, name in names:
                paths[f"blocks.{i}.{port}"] = f"BottleneckBlock_{i}/{name}"
        return paths
    raise TypeError(f"no flax name map for {type(model).__name__}")


def _classifier_leaves(model: Classifier, stem: str | None = None) -> dict:
    """(collection, flax leaf path) -> (state_dict key, layout), layout
    "conv" (HWIO <-> OIHW), "dense" ([in, out] <-> [out, in]) or "vec"."""
    modules = dict(model.named_modules())
    leaves = {}
    for port, path in _module_paths(model, stem).items():
        m = modules[port]
        if isinstance(m, BatchNorm):
            for leaf in ("scale", "bias"):
                leaves["params", f"{path}/{leaf}"] = (f"{port}.{leaf}", "vec")
            for leaf in ("mean", "var"):
                leaves["batch_stats", f"{path}/{leaf}"] = (f"{port}.{leaf}",
                                                           "vec")
            continue
        leaves["params", f"{path}/kernel"] = (
            f"{port}.weight", "conv" if isinstance(m, Conv) else "dense")
        if m.bias is not None:
            leaves["params", f"{path}/bias"] = (f"{port}.bias", "vec")
    return leaves


# torch layout -> flax layout: OIHW -> HWIO, [out, in] -> [in, out]
_FLAX_ORDER = {"conv": (2, 3, 1, 0), "dense": (1, 0)}


def _flax_layout(kind: str, x):
    """A torch-layout weight (tensor, or its shape) in flax's layout."""
    order = _FLAX_ORDER.get(kind)
    if order is None:
        return x
    if isinstance(x, tuple):
        return tuple(x[i] for i in order)
    return x.permute(order)


def _classifier_state_dict(model, params, batch_stats) -> dict:
    stem = ("SpaceToDepthStem_0" if isinstance(model, ResNet)
            and "SpaceToDepthStem_0" in params else None)
    leaves = _classifier_leaves(model, stem)
    own = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    state = {}
    for coll, tree in (("params", params), ("batch_stats", batch_stats)):
        want = {path: v for (c, path), v in leaves.items() if c == coll}
        if want and tree is None:
            raise BridgeError(f"the model has BatchNorm statistics "
                              f"({len(want)} leaves); pass the flax "
                              f"batch_stats tree")
        flat = flatten(tree or {})
        _check_leaves(want, flat, f"flax {coll} tree")
        for path, (key, kind) in want.items():
            arr = np.asarray(flat[path], np.float32)
            t = own[key]
            shape = _flax_layout(kind, tuple(t.shape))
            if tuple(arr.shape) != shape:
                raise BridgeError(f"{coll} {path}: flax shape "
                                  f"{tuple(arr.shape)} but the model wants "
                                  f"{shape}")
            if kind in _FLAX_ORDER:
                arr = arr.transpose(np.argsort(_FLAX_ORDER[kind]))
            state[key] = torch.from_numpy(np.array(arr)).to(t.device)
    return state


def _nest(flat: dict) -> dict:
    """{"a/b/c": x} -> {"a": {"b": {"c": x}}}."""
    tree: dict = {}
    for path, val in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = val
    return tree


def batch_stats_view(model) -> dict | None:
    """A classifier's BatchNorm statistics as a flax ``batch_stats`` tree
    of its live buffers (no copy); ``None`` for a model without
    BatchNorm."""
    if not isinstance(model, Classifier):
        return None
    own = dict(model.named_buffers())
    flat = {path: own[key] for (coll, path), (key, _)
            in _classifier_leaves(model).items() if coll == "batch_stats"}
    return _nest(flat) if flat else None


def state_dict_to_flax(model, collection: str = "params") -> dict | None:
    """The inverse direction: the model's ``params`` (or, for
    ``collection="batch_stats"``, its BatchNorm statistics; ``None`` for
    a model without) as a nested dict of f32 numpy arrays under the flax
    paths and in flax's layouts."""
    if collection not in ("params", "batch_stats"):
        raise ValueError(f"collection is 'params' or 'batch_stats', got "
                         f"{collection!r}")
    if isinstance(model, Classifier):
        own = {**dict(model.named_parameters()),
               **dict(model.named_buffers())}
        flat = {path: _flax_layout(kind, own[key].detach()).float().cpu()
                .numpy() for (coll, path), (key, kind)
                in _classifier_leaves(model).items() if coll == collection}
        return _nest(flat) if flat else None
    if collection == "batch_stats":
        return None
    return _nest({name.replace(".", "/"): p.detach().float().cpu().numpy()
                  for name, p in model.named_parameters()})


def load_flax_params(model, params, batch_stats=None, device=None):
    """Load a flax param tree (and a classifier's ``batch_stats``) into
    ``model`` in place and return it.  ``device`` must match the model's
    (``None`` = the card, as for every entry point of the port)."""
    dev = resolve_device(device)
    if dev != model.device:
        raise ValueError(f"model lives on {model.device}, asked to load "
                         f"onto {dev}")
    model.load_state_dict(flax_to_state_dict(model, params, batch_stats),
                          strict=True)
    return model


# KV page payloads: dtypes numpy lacks, by ml_dtypes name -> the port's
# carrier of their bits
_PAYLOAD_BITS = {"bfloat16": np.uint16, "float8_e4m3fn": np.uint8}


def _map_payload(tree, fn, path=()):
    if not isinstance(tree, Mapping):
        return fn("/".join(path), tree)
    return {k: _map_payload(v, fn, path + (str(k),)) for k, v in tree.items()}


def jax_pages_to_torch(data) -> dict:
    """A JAX engine's ``extract_pages`` payload (host numpy leaves, as
    ``jax.device_get`` gives them) as the port's: bf16 and fp8 leaves as
    their bits, every other leaf as it is."""
    def conv(path, arr):
        arr = np.asarray(arr)
        bits = _PAYLOAD_BITS.get(arr.dtype.name)
        return (np.ascontiguousarray(arr).view(bits) if bits is not None
                else arr)
    return _map_payload(data, conv)


def torch_pages_to_jax(data, like) -> dict:
    """The port's page payload as a JAX engine's: ``like`` is a tree with
    the JAX leaves' dtypes at the same paths (a JAX payload, or the JAX
    arena's leaves); bit carriers are viewed back as those dtypes, other
    leaves must match them already."""
    flat_like = flatten(like)

    def conv(path, arr):
        if path not in flat_like:
            raise BridgeError(f"{path}: the JAX tree has no such leaf")
        want = np.asarray(flat_like[path]).dtype
        arr = np.asarray(arr)
        if arr.dtype == want:
            return arr
        if _PAYLOAD_BITS.get(want.name) == arr.dtype.type:
            return np.ascontiguousarray(arr).view(want)
        raise BridgeError(f"{path}: payload {arr.dtype.name} cannot carry "
                          f"the JAX leaf's {want.name}")
    return _map_payload(data, conv)
