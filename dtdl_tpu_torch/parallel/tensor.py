"""GSPMD rule sets over the port's process mesh, the port of
dtdl_tpu/parallel/tensor.py.

The JAX package names every ``TransformerLM`` parameter's dims with flax
*logical axes* and maps them onto mesh axes by a swappable rule set; jit
then shards the step and XLA's SPMD partitioner inserts the collectives.
Here every rank is a process holding its shards of each leaf, and the
collectives the partitioner would insert are written out
(:mod:`dtdl_tpu_torch.parallel.collectives`) around the port's own
``TransformerLM`` modules, which run unchanged on the local shards:

* the rule presets (``RULE_PRESETS``, the JAX table over the port's
  ``data``/``model`` axes) and the logical-axis table of the port's LM
  leaves, keyed by the flat flax paths :func:`dtdl_tpu_torch.bridge.flatten`
  uses (``block_0/attn/q/kernel``), resolved to a spec per leaf as flax
  resolves them (:func:`logical_to_mesh`: rules in order, an axis used once
  per leaf, so under ``tp`` an expert weight's ``mlp`` dim wins the
  ``model`` axis over its ``expert`` dim);
* **heads on model** (Megatron attention): q/k/v hold H/tp heads and are
  column-parallel (``copy_to`` on the block's input, *f*), the local heads
  attend (flash K1-K3 in training, K4 over the rank's own head-sharded
  pool in serving), ``out`` is row-parallel (``psum`` after it, *g*);
* **mlp on model**: the SwiGLU ``wi``/``wg`` column- and ``wo``
  row-parallel, the same *f*/*g* pair; a routed MoE whose experts are
  ``mlp``-sharded takes it around its expert products;
* **vocab on model**: the embedding looks up its V/tp rows (a masked
  gather, then ``psum``) and the tied head gives vocab-sharded logits
  whose logsumexp and true logit combine by ``pmax``/``psum``
  (``megatron._lse_and_true_logit``), the argmax by ``pmax``/``pmin``;
  serving gathers the logits before sampling, so every rank samples from
  bitwise-equal logits;
* **expert on model** (``ep``): the routing groups of the JAX model
  (``g = min(group_size or 1024, S)`` tokens of a batch row, capacity
  ``ceil(cf·g·k/E)``) are split over ``model``, each rank dispatches its
  share of the groups, a token ``all_to_all`` takes each expert's slots to
  its owner and back, and the groups' outputs are gathered: the global
  function, dropped tokens included;
* **embed on data** (``fsdp``): every such leaf is all-gathered over
  ``data`` at each read (a ``torch.nn.utils.parametrize`` gather), and,
  since the blocks are then checkpointed, again for the backward; its
  gradient comes back reduce-scattered, and the optimizer state lives on
  the shard, so each rank's parameter and moment bytes are 1/n;
* a dim placed on ``model`` that no pattern above consumes (the router's
  ``expert`` dim, a dense-dispatch MoE's experts) is gathered for a
  replicated use (``all_gather(invariant=True)``: the backward keeps this
  rank's part of the gradient);
* every leaf held whole over ``data`` sums its gradient over ``data``
  after the backward (each rank's loss is its rows' share of the global
  mean, so the sum is the global gradient).

A dim whose size its axis does not divide (``vocab % tp``, ``embed %
data``) is held whole on that axis: GSPMD pads it, and both compute the
same function.  Batches are sharded on ``data`` (the ``batch`` rule).
"""

from __future__ import annotations

import re
from dataclasses import replace

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import parametrize

from dtdl_tpu_torch.device import resolve_device, upload
from dtdl_tpu_torch.parallel.collectives import (all_gather, all_to_all,
                                                 copy_to, pmax, pmin, psum,
                                                 reduce_)
from dtdl_tpu_torch.quant.core import SCALE_SUFFIX, _sites
from dtdl_tpu_torch.runtime.mesh import DATA_AXIS, MODEL_AXIS, Mesh

RULE_PRESETS = {
    "replicated": (
        ("batch", DATA_AXIS),
        ("vocab", None), ("embed", None), ("heads", None),
        ("head_dim", None), ("mlp", None), ("expert", None),
    ),
    "tp": (
        ("batch", DATA_AXIS),
        ("vocab", MODEL_AXIS), ("embed", None), ("heads", MODEL_AXIS),
        ("head_dim", None), ("mlp", MODEL_AXIS), ("expert", MODEL_AXIS),
    ),
    "fsdp": (
        ("batch", DATA_AXIS),
        ("vocab", None), ("embed", DATA_AXIS), ("heads", None),
        ("head_dim", None), ("mlp", None), ("expert", None),
    ),
    "tp_fsdp": (
        ("batch", DATA_AXIS),
        ("vocab", MODEL_AXIS), ("embed", DATA_AXIS), ("heads", MODEL_AXIS),
        ("head_dim", None), ("mlp", MODEL_AXIS), ("expert", MODEL_AXIS),
    ),
    "ep": (
        ("batch", DATA_AXIS),
        ("vocab", MODEL_AXIS), ("embed", None), ("heads", MODEL_AXIS),
        ("head_dim", None), ("mlp", None), ("expert", MODEL_AXIS),
    ),
}


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``'s shape: one mesh axis name (or
    ``None``: whole) per leading dim of a leaf."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


# the flax logical axes of each TransformerLM leaf (dtdl_tpu/models/
# transformer.py's _part names), by flat flax path
_LOGICAL = (
    (r"embed", ("vocab", "embed")),
    (r"(block_\d+/ln_(attn|mlp)|ln_f)/scale", ("embed",)),
    (r"block_\d+/attn/[qkv]/kernel", ("embed", "heads", "head_dim")),
    (r"block_\d+/attn/out/kernel", ("heads", "head_dim", "embed")),
    (r"block_\d+/mlp/w[ig]/kernel", ("embed", "mlp")),
    (r"block_\d+/mlp/wo/kernel", ("mlp", "embed")),
    (r"block_\d+/moe/router/kernel", ("embed", "expert")),
    (r"block_\d+/moe/w[ig]", ("expert", "embed", "mlp")),
    (r"block_\d+/moe/wo", ("expert", "mlp", "embed")),
)


def _rule_list(rules) -> list:
    return list(RULE_PRESETS[rules] if isinstance(rules, str) else rules)


def logical_axes(path: str) -> tuple:
    """The logical-axis names the JAX model declares for the leaf at flat
    flax ``path``."""
    for pattern, names in _LOGICAL:
        if re.fullmatch(pattern, path):
            return names
    raise KeyError(f"no logical axes for TransformerLM leaf {path!r}")


def logical_to_mesh(names, rules) -> PartitionSpec:
    """flax's resolution of logical names to mesh axes: the rules in
    order, each assigning its axis to the first dim of its name unless
    that dim is taken or the axis already shards another dim; a dim no
    rule reaches is whole."""
    out = [None] * len(names)
    taken = [False] * len(names)
    for logical, axis in _rule_list(rules):
        if logical not in names:
            continue
        pos = list(names).index(logical)
        if not taken[pos] and (axis is None or axis not in out):
            out[pos], taken[pos] = axis, True
    return PartitionSpec(*out)


def _param_paths(model) -> dict:
    """{flat flax path: parameter} of the port's TransformerLM."""
    return {name.replace(".", "/"): p for name, p in model.named_parameters()}


def logical_shardings(mesh: Mesh, model, rules="tp") -> dict:
    """``{flat flax path: PartitionSpec}`` for every parameter of the
    port's float ``TransformerLM`` under ``rules`` (a preset name or a
    rules sequence): the specs the JAX ``logical_shardings`` gives its
    boxed tree.  ``mesh`` names the axes; whether a dim divides is
    :func:`placement`'s question."""
    del mesh
    return {path: logical_to_mesh(logical_axes(path), rules)
            for path in _param_paths(model)}


def quant_logical_shardings(mesh: Mesh, model, rules="tp",
                            mode=True) -> dict:
    """The specs of a ``quantize_params`` tree of ``model`` (quantized or
    float; ``mode`` is accepted for the JAX signature: int8 and fp8 trees
    shard alike): each quantized kernel keeps its float twin's spec, each
    ``<name>_scale`` sibling shards alongside it on every dim whose size
    is not 1, and unquantized leaves (embedding, norms, router) keep
    their own."""
    del mesh, mode
    sites = _sites(model)
    out = {}
    for path in _param_paths(model):
        if path.endswith(SCALE_SUFFIX) and \
                path[:-len(SCALE_SUFFIX)].replace("/", ".") in sites:
            continue
        spec = logical_to_mesh(logical_axes(path), rules)
        out[path] = spec
        scale_shape = sites.get(path.replace("/", "."))
        if scale_shape is not None:
            out[path + SCALE_SUFFIX] = PartitionSpec(*[
                spec[i] if i < len(spec) and scale_shape[i] != 1 else None
                for i in range(len(scale_shape))])
    return out


def heads_axis_size(mesh: Mesh, rules="tp") -> int:
    """Size of the mesh axis the ``heads`` logical dim shards on under
    ``rules`` (1 when whole): the number of shards a serving engine's KV
    arena splits its heads into."""
    axis = dict(_rule_list(rules)).get("heads")
    return int(mesh.shape[axis]) if axis is not None else 1


def serve_arena_shardings(mesh: Mesh, arena_shapes, rules="tp"):
    """The specs of a serving arena (the engine's ``arena_shapes()`` tree
    of ``(shape, dtype)`` leaves): every K/V payload and scale leaf of
    rank 3 or more holds the heads on axis 1 and splits them on the
    ``heads`` rule's axis; the per-slot ``index`` stays whole."""
    del mesh
    axis = dict(_rule_list(rules)).get("heads")

    def one(node):
        if isinstance(node, dict):
            return {k: one(v) for k, v in node.items()}
        shape = node[0]
        return PartitionSpec(None, axis) if len(shape) >= 3 \
            else PartitionSpec()
    return one(arena_shapes)


def placement(spec, shape, mesh: Mesh) -> PartitionSpec:
    """``spec`` as the port places it: a dim keeps its axis only when the
    mesh has that axis, of size above 1, and it divides the dim (GSPMD
    pads a dim that does not divide; the port holds it whole)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return PartitionSpec(*[
        a if a is not None and mesh.shape.get(a, 1) > 1
        and shape[i] % mesh.shape[a] == 0 else None
        for i, a in enumerate(spec)])


def block_of(array, spec, mesh: Mesh):
    """This rank's block of a whole ``array`` (tensor or numpy) under the
    placed ``spec``."""
    coords = mesh.coords()
    idx = []
    for d, n in enumerate(array.shape):
        a = spec[d] if d < len(spec) else None
        if a is None:
            idx.append(slice(None))
        else:
            per = n // mesh.shape[a]
            idx.append(slice(coords[a] * per, (coords[a] + 1) * per))
    return array[tuple(idx)]


# ---------------------------------------------------------------------------
# the placement: a TransformerLM holding this rank's shards
# ---------------------------------------------------------------------------

class _Gather(nn.Module):
    """A parametrization: the leaf's shards gathered along ``dims``
    (``(dim, axis, invariant)`` each) at every read."""

    def __init__(self, mesh: Mesh, dims):
        super().__init__()
        self.mesh, self.dims = mesh, list(dims)

    def forward(self, x):
        for dim, axis, invariant in self.dims:
            x = all_gather(x, self.mesh, axis, dim, invariant=invariant)
        return x


def _psum_f32(x, mesh, axis):
    """``psum`` summed in f32 and rounded once to ``x``'s dtype."""
    return psum(x.float(), mesh, axis).to(x.dtype)


class Placement:
    """What :func:`place_lm` installed on a ``TransformerLM``: the mesh,
    the placed spec of every leaf (``specs``, flat flax paths), which
    patterns run sharded, and the leaves whose gradients sum over the
    batch axis.  It is the model's ``shard`` (embedding and head) and its
    routed MoE blocks' (dispatch)."""

    def __init__(self, mesh: Mesh, rules, specs: dict):
        self.mesh = mesh
        self.specs = specs
        self.batch_axis = dict(_rule_list(rules)).get("batch")
        self.vocab_parallel = specs["embed"][0] == MODEL_AXIS
        q = specs.get("block_0/attn/q/kernel", (None, None))
        # the shares the heads split into (the KV arena's too)
        self.heads_split = mesh.shape[MODEL_AXIS] \
            if q[1] == MODEL_AXIS else 1
        self.whole_on_batch: list = []     # parameters, filled by place_lm

    # ---- the vocab-parallel embedding and head (TransformerLM.shard) ---

    def _vocab_rows(self, model) -> tuple[int, int]:
        v_loc = model.cfg.vocab_size // self.mesh.axis_size(MODEL_AXIS)
        return self.mesh.axis_index(MODEL_AXIS) * v_loc, v_loc

    def embed(self, model, tokens):
        emb = model.embed
        if not self.vocab_parallel:
            return emb[tokens].to(model.cfg.dtype)
        off, v_loc = self._vocab_rows(model)
        local = tokens - off
        hit = (local >= 0) & (local < v_loc)
        rows = emb[local.clamp(0, v_loc - 1)]
        rows = torch.where(hit[..., None], rows, torch.zeros_like(rows))
        # one rank's row and zeros: the f32 sum is the row exactly
        return psum(rows.float(), self.mesh, MODEL_AXIS).to(model.cfg.dtype)

    def head(self, model, x):
        logits = model.local_head(x)
        if not self.vocab_parallel:
            return logits
        return all_gather(logits, self.mesh, MODEL_AXIS, -1, invariant=True)

    def head_stats(self, model, h, targets):
        """(logsumexp, the target's logit, argmax) of every position's
        logits over the whole vocab, the full logits never gathered."""
        if not self.vocab_parallel:
            logits = model.local_head(h)
            return (torch.logsumexp(logits, -1),
                    logits.gather(-1, targets[..., None])[..., 0],
                    logits.argmax(-1))
        from dtdl_tpu_torch.parallel.megatron import _lse_and_true_logit
        off, v_loc = self._vocab_rows(model)
        logits = model.local_head(copy_to(h, self.mesh, MODEL_AXIS))
        lse, true = _lse_and_true_logit(self.mesh, logits, targets,
                                        slice(off, off + v_loc))
        # the global argmax, the lowest index among equal maxima: the
        # ranks whose local max is the global one bid their index
        with torch.no_grad():
            loc_max = logits.amax(-1)
            pred = pmin(torch.where(
                loc_max == pmax(loc_max, self.mesh, MODEL_AXIS),
                logits.argmax(-1) + off,
                torch.full_like(targets, model.cfg.vocab_size)),
                self.mesh, MODEL_AXIS)
        return lse, true, pred

    def sync_grads(self) -> None:
        """Sum over the batch axis the gradients of every leaf held whole
        on it (a leaf sharded on it came back reduce-scattered)."""
        grads = []
        for p in self.whole_on_batch:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        if self.batch_axis is not None:
            reduce_(grads, self.mesh.along(self.batch_axis))


class _ExpertParallel:
    """A routed MoE's dispatch with its experts split over ``model``:
    each rank routes its share of the groups, and a token all-to-all
    takes each expert's slots to the rank holding it and back."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def groups(self, moe, x, probs, valid, C):
        mesh, n = self.mesh, self.mesh.axis_size(MODEL_AXIS)
        G = x.shape[0]
        per = -(-G // n)
        pad = per * n - G
        if pad:     # groups with no valid token route nothing
            x = F.pad(x, (0, 0, 0, 0, 0, pad))
            probs = F.pad(probs, (0, 0, 0, 0, 0, pad))
            valid = torch.cat([valid, valid.new_zeros(pad, valid.shape[1])])
        mine = slice(mesh.axis_index(MODEL_AXIS) * per,
                     (mesh.axis_index(MODEL_AXIS) + 1) * per)
        y = moe._groups(copy_to(x, mesh, MODEL_AXIS)[mine],
                        copy_to(probs, mesh, MODEL_AXIS)[mine], valid[mine],
                        C)
        return all_gather(y, mesh, MODEL_AXIS, 0, invariant=True)[:G]

    def experts(self, moe, xe):
        # [E, slots, D] -> each owner's [E/n, n·slots, D] -> back
        got = all_to_all(xe, self.mesh, MODEL_AXIS, 0, 1)
        return all_to_all(moe._experts(got), self.mesh, MODEL_AXIS, 1, 0)


class _ExpertTensorParallel:
    """A routed MoE whose experts' ``mlp`` dim is split over ``model``:
    every rank routes all groups, and the expert products are Megatron
    column→row pairs."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def groups(self, moe, *args):
        return moe._groups(*args)

    def experts(self, moe, xe):
        y = moe._experts(copy_to(xe, self.mesh, MODEL_AXIS))
        return _psum_f32(y, self.mesh, MODEL_AXIS)


def _megatron_hooks(module, mesh: Mesh) -> None:
    """*f* (``copy_to``) on the module's input, *g* (``psum``) on its
    output: a column→row parallel pair (attention, SwiGLU)."""
    module.register_forward_pre_hook(
        lambda m, args: (copy_to(args[0], mesh, MODEL_AXIS),) + args[1:])
    module.register_forward_hook(
        lambda m, args, out: _psum_f32(out, mesh, MODEL_AXIS))


def place_lm(model, mesh: Mesh, rules="tp", device=None,
             specs: dict | None = None):
    """This rank's placement of ``model`` (the port's ``TransformerLM``,
    float or quantized, its whole weights on any device): a new
    ``TransformerLM`` on ``device`` (``None``: the card) whose parameters
    are this rank's blocks under ``rules`` (:func:`placement` of
    ``specs``, by default :func:`logical_shardings` or, quantized,
    :func:`quant_logical_shardings`), with the placement's collectives
    installed (module docstring) and its :class:`Placement` as ``.shard``.
    A placement with a leaf sharded on the batch axis checkpoints every
    block, so the gathers run again for the backward."""
    from dtdl_tpu_torch.models.transformer import MoE, TransformerLM
    dev = resolve_device(device)
    whole = _param_paths(model)
    if specs is None:
        specs = (quant_logical_shardings(mesh, model, rules)
                 if model.cfg.quantize else
                 logical_shardings(mesh, model, rules))
    placed = {path: placement(specs[path], tuple(p.shape), mesh)
              for path, p in whole.items()}
    plan = Placement(mesh, rules, placed)
    fsdp = plan.batch_axis is not None and any(
        plan.batch_axis in s for s in placed.values())
    cfg = replace(model.cfg, remat=model.cfg.remat or fsdp)
    local = TransformerLM(cfg, device="cpu", param_dtype=model.param_dtype)
    with torch.no_grad():
        for name, p in local.named_parameters():
            path = name.replace(".", "/")
            src = whole[path]
            p.data = block_of(src.detach(), placed[path], mesh).to(
                dev, copy=True).contiguous()
            p.requires_grad_(src.requires_grad)
    local.to(dev)
    local.train(model.training)
    local.shard = plan

    def hooked(path) -> bool:
        return placed[path][1] == MODEL_AXIS if path in placed else False

    # the modules whose 'model'-sharded leaves a pattern runs locally;
    # any other leaf's 'model' dims are gathered for a replicated use
    local_owners = {""} if plan.vocab_parallel else set()
    for i, block in enumerate(local.blocks):
        if hooked(f"block_{i}/attn/q/kernel"):
            _megatron_hooks(block.attn, mesh)
            local_owners |= {f"block_{i}.attn.{w}" for w in "qkv"}
            local_owners.add(f"block_{i}.attn.out")
        if hasattr(block, "mlp") and hooked(f"block_{i}/mlp/wi/kernel"):
            _megatron_hooks(block.mlp, mesh)
            local_owners |= {f"block_{i}.mlp.{w}" for w in ("wi", "wg", "wo")}
        moe = getattr(block, "moe", None)
        if isinstance(moe, MoE) and moe.dispatch == "routed":
            spec = placed[f"block_{i}/moe/wi"]
            if spec[0] == MODEL_AXIS:
                moe.shard = _ExpertParallel(mesh)
            elif spec[2] == MODEL_AXIS:
                moe.shard = _ExpertTensorParallel(mesh)
            if moe.shard is not None:
                local_owners.add(f"block_{i}.moe")

    modules = dict(local.named_modules())
    for name, p in list(local.named_parameters()):
        spec = placed[name.replace(".", "/")]
        owner, _, leaf = name.rpartition(".")
        dims = []
        for d, a in enumerate(spec):
            if a is not None and a == plan.batch_axis:
                dims.append((d, a, False))
            elif a is not None and owner not in local_owners:
                dims.append((d, a, True))
        if plan.batch_axis not in spec:
            plan.whole_on_batch.append(p)
        if dims:
            parametrize.register_parametrization(
                modules[owner], leaf, _Gather(mesh, dims), unsafe=True)
    return local


def placed_parameters(params) -> dict:
    """``{flat flax path: this rank's shard}`` of a placed model (the
    stored blocks, not their gathers)."""
    out = {}
    for name, p in params.named_parameters():
        name = name.replace(".parametrizations.", ".").replace(
            ".original", "")
        if name.startswith("parametrizations."):
            name = name[len("parametrizations."):]
        out[name.replace(".", "/")] = p
    return out


def _lm_shift_loss(params, tokens):
    """The next-token objective of the train and eval steps (one
    definition, so a numerics change cannot drift between them): shift,
    the placed forward, cross entropy over the whole vocab.  Returns this
    rank's shares ``(loss, correct)`` of the global means: its rows' sums
    over the global token count, so that their sum over the batch axis is
    the global mean."""
    plan = params.shard
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    h = params(inputs, return_hidden=True)
    lse, true, pred = plan.head_stats(params, h, targets)
    n = targets.numel() * (plan.mesh.axis_size(plan.batch_axis)
                           if plan.batch_axis else 1)
    return (lse - true).sum() / n, (pred == targets).float().sum() / n


def _batch_tokens(tokens, device):
    if isinstance(tokens, torch.Tensor):
        return tokens.to(device=device, dtype=torch.long)
    return upload(np.asarray(tokens), device, torch.long)


def init_sharded_lm(model, mesh: Mesh, tx, example_tokens=None, rules="tp",
                    rng=None, device=None, params=None):
    """This rank's shards of a ``TransformerLM`` and of its optimizer
    state: ``(params, opt_state, shardings)``.

    ``model`` is the port's ``TransformerLM`` with its whole weights (keep
    it on the host, ``device="cpu"``, for a model larger than a card;
    each rank copies only its blocks to ``device``); ``rng`` (an int)
    draws them anew from that seed first, and ``params`` (a flax tree of
    numpy arrays, say the JAX ``init_sharded_lm``'s through
    ``jax.device_get``) loads them instead.  ``params`` comes back as the
    placed model (:func:`place_lm`), ``opt_state`` as ``tx`` over its
    shards (its moments are made on the shards, 1/n of the bytes), and
    ``shardings`` as the placed specs of the parameters and of the
    per-parameter optimizer state (each slot as its parameter).
    ``example_tokens`` shapes nothing here (eager modules need no trace)
    and is accepted for the JAX signature."""
    del example_tokens
    if params is not None:
        from dtdl_tpu_torch.bridge import load_flax_params
        load_flax_params(model, params, device=model.device)
    elif rng is not None:
        model.init_weights(int(rng))
    placed = place_lm(model, mesh, rules, device)
    opt_state = tx.init([p for p in placed.parameters()])
    specs = placed.shard.specs
    return placed, opt_state, (specs, dict(specs))


def make_sharded_lm_train_step(model, mesh: Mesh, tx, shardings, rules="tp"):
    """The sharded LM step ``(params, opt_state, tokens) -> (params,
    opt_state, loss)``: ``params``/``opt_state`` from
    :func:`init_sharded_lm` (updated in place), ``tokens`` int [B/n, S+1]
    this rank's rows of the global batch
    (:func:`~dtdl_tpu_torch.runtime.mesh.batch_sharded` on the batch
    axis), ``loss`` the global mean next-token cross entropy, the same on
    every rank.  ``model``, ``tx``, ``shardings`` and ``rules`` are those
    :func:`init_sharded_lm` was given (the placement carries them)."""
    del model, tx, shardings, rules

    def step(params, opt_state, tokens):
        opt_state.zero_grad(set_to_none=True)
        loss = value_and_grad(params, tokens)
        opt_state.step()
        return params, opt_state, loss

    return step


def value_and_grad(params, tokens):
    """The global mean next-token loss of a placed model on this rank's
    rows ``tokens`` (the same on every rank), and this rank's shard of
    every parameter's gradient in its ``.grad`` (added to what is
    there)."""
    plan = params.shard
    loss, _ = _lm_shift_loss(params, _batch_tokens(tokens, params.device))
    loss.backward()
    plan.sync_grads()
    with torch.no_grad():
        return psum(loss.detach(), plan.mesh, plan.batch_axis) \
            if plan.batch_axis else loss.detach()


def make_sharded_lm_eval_step(model, mesh: Mesh, shardings, rules="tp"):
    """Forward-only validation of the placed model ``(params, tokens) ->
    {'loss', 'accuracy', 'n_tokens'}``: the global mean next-token loss
    and token accuracy, and the global target count, the same on every
    rank (``tokens`` as for the train step)."""
    del model, shardings, rules

    @torch.no_grad()
    def evaluate(params, tokens):
        plan = params.shard
        tokens = _batch_tokens(tokens, params.device)
        loss, acc = _lm_shift_loss(params, tokens)
        n = tokens.shape[0] * (tokens.shape[1] - 1) * (
            mesh.axis_size(plan.batch_axis) if plan.batch_axis else 1)
        out = torch.stack([loss, acc])
        if plan.batch_axis:
            out = psum(out, mesh, plan.batch_axis)
        return {"loss": out[0], "accuracy": out[1],
                "n_tokens": torch.tensor(float(n), device=out.device)}

    return evaluate


def gather_params(params, grads: bool = False) -> dict:
    """``{flat flax path: numpy array}`` of the whole weights (or with
    ``grads`` their gradients) of a placed model, on every rank (each
    leaf's blocks gathered over its axes): the flax tree the bridge
    loads, for checks and snapshots."""
    plan = params.shard
    out = {}
    with torch.no_grad():
        for path, p in placed_parameters(params).items():
            x = (p.grad if grads else p).detach()
            for d, a in enumerate(plan.specs[path]):
                if a is not None:
                    x = all_gather(x, plan.mesh, a, d, invariant=True)
            # audit: ok[host-sync] gather_params returns the host flax tree by contract
            out[path] = x.float().cpu().numpy()
    return out
