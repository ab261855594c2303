"""Caffe NetParameter -> an ``nn.Module``, the port of
dtdl_tpu/models/netspec.py.

A Caffe net is a prototxt list of ``layer { }`` messages wired by named
blobs (bottom/top).  :func:`parse_net` reads them into
:class:`LayerSpec`s; :class:`CaffeNet` runs them in order, the blobs in a
dict keyed by top/bottom names, the TRAIN or TEST phase taken from the
module's mode (``model.train()`` / ``model.eval()``, the JAX
``train=`` flag), ``include { phase: ... }`` honored.  The output is the
bottom blob of the SoftmaxWithLoss/Softmax/Accuracy layer (the logits;
the step folds softmax into the loss), else the last blob computed, in
f32.

Layer types: Data/Input (shape declaration only; batches come from the
data pipeline), Convolution (grouped, dilated, per-dim kernel, stride and
pad), Pooling (MAX/AVE, global), InnerProduct, ReLU (leaky), Sigmoid,
TanH, Dropout, LRN (across channels), Flatten; Softmax, SoftmaxWithLoss
and Accuracy mark the logits.  Any other type raises
``NotImplementedError`` naming the layer.

Layout: the input is NHWC (the JAX models' layout; [B, H, W] adds a
channel, [B, D] stays a vector), NCHW in channels_last memory inside;
InnerProduct and Flatten flatten in NHWC order (h, w, c) as the JAX
module does, so a bridged kernel's rows stand as they are, and a 4-D
output comes back NHWC.  flax sizes its parameters at init from an
example input; here the parameters are made at construction, so
:class:`CaffeNet` takes one example's ``input_shape`` and walks the TEST
phase (the JAX init's) once on it.

Pooling is Caffe's, not torch's ceil mode: the output size is
ceil((H + 2p - k) / s) + 1, less one when the last window would start at
or past H + p, and the input is padded explicitly to that extent
(:func:`_caffe_pool_pad`): with the dtype's lowest value for MAX, with
zeros for AVE, whose divisor counts the window clipped to [-p, H + p).
LRN divides alpha by ``local_size`` over the channel window that ends
at c + size // 2 (a cumulative sum, as :func:`_lrn` in JAX).

Fillers (weight_filler/bias_filler): constant, uniform, gaussian, xavier,
msra, positive_unitball, with Caffe's defaults, each drawn in flax's
layout from the model's seeded ``torch.Generator`` and held to JAX by
its statistics, not its values; an absent filler is flax's default
(lecun-normal kernel, zero bias).  Dropout draws its masks from torch's
generator (the JAX step folds its own key), so a TRAIN-phase Dropout
net matches JAX in distribution only.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field

import torch
import torch.nn.functional as F
from torch import nn

from dtdl_tpu_torch.models.layers import Classifier, Conv, Dense, _draw
from dtdl_tpu_torch.utils.prototxt import Message, parse


@dataclass
class LayerSpec:
    name: str
    type: str
    bottoms: list[str]
    tops: list[str]
    params: Message
    phases: list[str] = field(default_factory=list)  # [] = both

    def in_phase(self, phase: str) -> bool:
        return not self.phases or phase in self.phases


# layer types that only declare data/labels, skipped during execution
_DATA_TYPES = {"Data", "Input", "MemoryData", "HDF5Data", "ImageData"}
# layer types resolved by the training step, not the forward pass
_LOSS_TYPES = {"SoftmaxWithLoss", "Accuracy"}


def _phases(layer: Message) -> list[str]:
    return [str(inc.get_scalar("phase", "")).upper()
            for inc in layer.getlist("include")]


def parse_net(msg: Message) -> list[LayerSpec]:
    """NetParameter message -> ordered LayerSpecs (layer order is the
    execution order, as in Caffe's upgraded NetParameter)."""
    specs = []
    for layer in msg.getlist("layer") + msg.getlist("layers"):
        specs.append(LayerSpec(
            name=str(layer.get_scalar("name", f"layer{len(specs)}")),
            type=str(layer.get_scalar("type", "")),
            bottoms=[str(b) for b in layer.getlist("bottom")],
            tops=[str(t) for t in layer.getlist("top")],
            params=layer,
            phases=_phases(layer),
        ))
    return specs


def _pair(param: Message, key: str, default=0):
    """Caffe's kernel_size/stride/pad/dilation: scalar or per-dim (h, w)."""
    vals = param.getlist(key)
    if not vals:
        h = param.get_scalar(key + "_h", default)
        w = param.get_scalar(key + "_w", default)
        return int(h), int(w)
    if len(vals) == 1:
        return int(vals[0]), int(vals[0])
    return int(vals[0]), int(vals[1])


# ---- fillers -----------------------------------------------------------------

def _fans(shape) -> tuple[float, float]:
    """flax's fan-in and fan-out of a kernel in flax's layout (``HWIO``
    or ``[in, out]``); a vector has none, as in flax."""
    if len(shape) <= 1:
        raise ValueError(
            f"Can't compute input and output sizes of a {len(shape)}-"
            f"dimensional weights tensor with default in_axis. Must be at "
            f"least 2D or specify in_axis explicitly.")
    receptive = math.prod(shape) / shape[-2] / shape[-1]
    return shape[-2] * receptive, shape[-1] * receptive


_VARIANCE_MODES = {"FAN_IN": 0, "FAN_OUT": 1, "AVERAGE": 2}


def _filler_draw(f: Message, shape, gen) -> torch.Tensor:
    """One Caffe FillerParameter's draw, an f32 CPU tensor of the flax
    layout ``shape``."""
    t = str(f.get_scalar("type", "constant"))
    if t == "constant":
        return torch.full(shape, float(f.get_scalar("value", 0.0)))
    if t == "uniform":
        lo = float(f.get_scalar("min", 0.0))
        hi = float(f.get_scalar("max", 1.0))
        return lo + (hi - lo) * torch.rand(shape, generator=gen)
    if t == "gaussian":
        mean = float(f.get_scalar("mean", 0.0))
        std = float(f.get_scalar("std", 1.0))
        return mean + std * torch.randn(shape, generator=gen)
    if t in ("xavier", "msra"):
        fan_in, fan_out = _fans(shape)
        mode = _VARIANCE_MODES.get(
            str(f.get_scalar("variance_norm", "FAN_IN")).upper(), 0)
        n = (fan_in, fan_out, (fan_in + fan_out) / 2)[mode]
        if t == "xavier":     # uniform on [-sqrt(3/n), sqrt(3/n)]
            limit = math.sqrt(3.0 / n)
            return limit * (2 * torch.rand(shape, generator=gen) - 1)
        return math.sqrt(2.0 / n) * torch.randn(shape, generator=gen)
    if t == "positive_unitball":
        x = torch.rand(shape, generator=gen)
        flat = x.reshape(-1, shape[-1])
        return (flat / flat.sum(dim=0)).reshape(shape)
    raise NotImplementedError(f"Caffe filler type {t!r}")


def _fill(param: nn.Parameter, spec: Message, key: str, flax_shape, to_torch,
          gen, default) -> None:
    f = spec.get_scalar(key, None)
    if f is None:
        default()
        return
    param.copy_(to_torch(_filler_draw(f, flax_shape, gen)))


class CaffeConv(Conv):
    """A Convolution layer: flax ``nn.Conv`` with per-dim kernel, stride
    and padding, dilation and groups (kernel ``[out, in/group, kh, kw]``
    here, ``HWIO`` in flax)."""

    def __init__(self, cin, p: Message, *, dtype, device):
        nn.Module.__init__(self)
        kh, kw = _pair(p, "kernel_size", 3)
        sh, sw = _pair(p, "stride", 1)
        ph, pw = _pair(p, "pad", 0)
        dh, dw = _pair(p, "dilation", 1)
        cout = int(p.get_scalar("num_output"))
        self.groups = int(p.get_scalar("group", 1))
        self.stride = (max(sh, 1), max(sw, 1))
        self.padding = (ph, pw)
        self.dilation = (max(dh, 1), max(dw, 1))
        self.dtype, self.init, self.spec = dtype, "lecun", p
        self.weight = nn.Parameter(torch.empty(
            cout, cin // self.groups, kh, kw, device=device).to(
                memory_format=torch.channels_last))
        self.bias = (nn.Parameter(torch.zeros(cout, device=device))
                     if bool(p.get_scalar("bias_term", True)) else None)

    def reset(self, gen) -> None:
        cout, cin_g, kh, kw = self.weight.shape
        _fill(self.weight, self.spec, "weight_filler", (kh, kw, cin_g, cout),
              lambda t: t.permute(3, 2, 0, 1), gen,
              lambda: _draw(self.weight, cin_g * kh * kw, 1.0, gen))
        if self.bias is not None:
            _fill(self.bias, self.spec, "bias_filler", (cout,),
                  lambda t: t, gen, self.bias.zero_)

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x, self.weight.to(self.dtype), b, self.stride,
                        self.padding, self.dilation, self.groups)


class CaffeInnerProduct(Dense):
    """An InnerProduct layer: flax ``nn.Dense`` (weight ``[out, in]``,
    ``[in, out]`` in flax), with or without a bias."""

    def __init__(self, cin, p: Message, *, dtype, device):
        nn.Module.__init__(self)
        cout = int(p.get_scalar("num_output"))
        self.dtype, self.spec = dtype, p
        self.weight = nn.Parameter(torch.empty(cout, cin, device=device))
        self.bias = (nn.Parameter(torch.zeros(cout, device=device))
                     if bool(p.get_scalar("bias_term", True)) else None)

    def reset(self, gen) -> None:
        cout, cin = self.weight.shape
        _fill(self.weight, self.spec, "weight_filler", (cin, cout),
              lambda t: t.t(), gen,
              lambda: _draw(self.weight, cin, 1.0, gen))
        if self.bias is not None:
            _fill(self.bias, self.spec, "bias_filler", (cout,),
                  lambda t: t, gen, self.bias.zero_)

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x, self.weight.to(self.dtype), b)


# ---- the functional layers ---------------------------------------------------

def _caffe_pool_pad(H: int, k: int, s: int, p: int) -> tuple[int, int]:
    """(lo, hi) padding reproducing Caffe's ceil-mode pooled output size:
    out = ceil((H + 2p - k) / s) + 1, less one if the last window would
    start beyond the padded image (Caffe's clip rule); the hi padding
    extends the input exactly to the last window's end."""
    out = -(-(H + 2 * p - k) // s) + 1
    if p > 0 and (out - 1) * s >= H + p:
        out -= 1
    hi = max(0, (out - 1) * s + k - H - p)
    return p, hi


def _pool(x, p: Message):
    """Caffe Pooling on NCHW ``x`` (see the module docstring)."""
    H, W = x.shape[2], x.shape[3]
    if bool(p.get_scalar("global_pooling", False)):
        (kh, kw), (sh, sw), (ph, pw) = (H, W), (1, 1), (0, 0)
    else:
        kh, kw = _pair(p, "kernel_size", 2)
        sh, sw = _pair(p, "stride", 1)
        ph, pw = _pair(p, "pad", 0)
        sh, sw = max(sh, 1), max(sw, 1)
    (hlo, hhi), (wlo, whi) = (_caffe_pool_pad(H, kh, sh, ph),
                              _caffe_pool_pad(W, kw, sw, pw))
    window, strides = (kh, kw), (sh, sw)
    if str(p.get_scalar("pool", "MAX")).upper() == "AVE":
        # divisor: 1 over the countable extent [-p, H + p), 0 on the ceil
        # overhang beyond it
        count_h, count_w = min(hhi, ph), min(whi, pw)
        ones = torch.ones((1, 1, H, W), dtype=x.dtype, device=x.device)
        ones = F.pad(ones, (wlo, count_w, hlo, count_h), value=1.0)
        ones = F.pad(ones, (0, whi - count_w, 0, hhi - count_h))
        num = F.avg_pool2d(F.pad(x, (wlo, whi, hlo, hhi)), window, strides)
        den = F.avg_pool2d(ones, window, strides)
        return num / den
    x = F.pad(x, (wlo, whi, hlo, hhi), value=torch.finfo(x.dtype).min)
    return F.max_pool2d(x, window, strides)


def _lrn(x, size: int, alpha: float, beta: float, k: float):
    """Local response normalization across channels (dim 1 of NCHW): a
    channel-axis box sum through cumulative sums, as the JAX module."""
    half = size // 2
    sq = F.pad(x.square(), (0, 0, 0, 0, half + 1, half))
    csum = sq.cumsum(dim=1)
    C = x.shape[1]
    window = csum[:, size:size + C] - csum[:, :C]
    return x / (k + alpha / size * window).pow(beta)


def _flat_nhwc(x):
    """[B, ...] -> [B, features], an NCHW map flattened in NHWC order."""
    if x.dim() == 4:
        x = x.permute(0, 2, 3, 1)
    return x.reshape(x.shape[0], -1)


class CaffeNet(Classifier):
    """A parsed Caffe layer graph as one module (see the module
    docstring).  ``input_shape`` is one example's shape (NHWC ``(H, W,
    C)``, ``(H, W)`` or a vector's ``(D,)``); the parameter layers are
    made by one TEST-phase walk over it.  ``seed`` draws the fillers
    (``None`` leaves the parameters uninitialized, as for a bridge
    load)."""

    def __init__(self, net_text: str, input_shape, dtype=torch.float32, *,
                 device=None, seed: int | None = 0):
        super().__init__(dtype, device)
        self.net_text = net_text
        self.specs = parse_net(parse(net_text))
        self.input_shape = tuple(int(d) for d in input_shape)
        self.layers = nn.ModuleDict()
        self._build = True
        with torch.no_grad():
            self._walk(torch.zeros((1,) + self.input_shape,
                                   device=self.device), "TEST")
        self._build = False
        if seed is not None:
            self.init_weights(seed)

    def _layer(self, spec: LayerSpec, x):
        """The parameter module of ``spec``, made from ``x``'s shape on
        the build walk."""
        if spec.name not in self.layers:
            if not self._build:
                raise KeyError(
                    f"Caffe layer {spec.name!r} has no parameters: it is "
                    f"not in the TEST phase the net was built from")
            kw = dict(dtype=self.dtype, device=self.device)
            if spec.type == "Convolution":
                m = CaffeConv(x.shape[1], spec.params.get_scalar(
                    "convolution_param", Message()), **kw)
            else:
                m = CaffeInnerProduct(x.shape[1], spec.params.get_scalar(
                    "inner_product_param", Message()), **kw)
            self.layers[spec.name] = m
        return self.layers[spec.name]

    def _apply(self, spec: LayerSpec, x, train: bool):
        t = spec.type
        if t == "Convolution":
            return self._layer(spec, x)(x)
        if t == "Pooling":
            return _pool(x, spec.params.get_scalar("pooling_param",
                                                   Message()))
        if t == "InnerProduct":
            if x.dim() > 2:
                x = _flat_nhwc(x)
            return self._layer(spec, x)(x)
        if t == "ReLU":
            p = spec.params.get_scalar("relu_param", Message())
            slope = float(p.get_scalar("negative_slope", 0.0))
            return F.leaky_relu(x, slope) if slope else F.relu(x)
        if t == "Sigmoid":
            return torch.sigmoid(x)
        if t == "TanH":
            return torch.tanh(x)
        if t == "Dropout":
            p = spec.params.get_scalar("dropout_param", Message())
            return F.dropout(x, float(p.get_scalar("dropout_ratio", 0.5)),
                             training=train)
        if t == "LRN":
            p = spec.params.get_scalar("lrn_param", Message())
            return _lrn(x, size=int(p.get_scalar("local_size", 5)),
                        alpha=float(p.get_scalar("alpha", 1e-4)),
                        beta=float(p.get_scalar("beta", 0.75)),
                        k=float(p.get_scalar("k", 1.0)))
        if t == "Flatten":
            return _flat_nhwc(x)
        raise NotImplementedError(f"Caffe layer type {t!r} ({spec.name})")

    def _walk(self, x, phase: str):
        if x.dim() == 3:
            x = x[..., None]                     # [B, H, W] -> NHWC
        if x.dim() == 4:
            x = x.permute(0, 3, 1, 2).to(memory_format=torch.channels_last)
        x = x.to(self.dtype)
        train = phase == "TRAIN"
        blobs: dict = {}
        logits_blob = None
        for spec in self.specs:
            if not spec.in_phase(phase):
                continue
            if spec.type in _DATA_TYPES:
                for top in spec.tops:
                    if top != "label":
                        blobs[top] = x
                continue
            if spec.type in _LOSS_TYPES or spec.type == "Softmax":
                if spec.bottoms:
                    logits_blob = spec.bottoms[0]
                continue
            bottom = blobs[spec.bottoms[0]] if spec.bottoms else x
            blobs[spec.tops[0] if spec.tops else spec.name] = \
                self._apply(spec, bottom, train)
        if logits_blob is not None and logits_blob in blobs:
            out = blobs[logits_blob]
        else:                                    # no loss layer
            out = list(blobs.values())[-1] if blobs else x
        if out.dim() == 4:
            out = out.permute(0, 2, 3, 1)        # NHWC, as the JAX net
        return out.float()

    def forward(self, x):
        return self._walk(x, "TRAIN" if self.training else "TEST")


def build_net(path_or_text: str, dtype=torch.float32, *, input_shape,
              device=None, seed: int | None = 0) -> CaffeNet:
    """A net prototxt (a file path, or the prototxt text itself) as a
    :class:`CaffeNet` for examples of ``input_shape``.  Raises on a net
    that defines no layers."""
    if os.path.exists(path_or_text):
        with open(path_or_text) as f:
            text = f.read()
    else:
        text = path_or_text
    if not parse_net(parse(text)):
        raise ValueError("net prototxt defines no layers")
    return CaffeNet(text, input_shape, dtype, device=device, seed=seed)
