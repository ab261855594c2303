"""Manual-SPMD 4D-parallel transformer train step (dp × sp × pp × tp + ep),
the port of dtdl_tpu/parallel/megatron.py.

The JAX step is one ``shard_map`` over a ``('data', 'seq', 'pipe',
'model')`` mesh; here every rank is a process holding its shards, and
every collective that ``shard_map`` writes is explicit
(:mod:`dtdl_tpu_torch.parallel.collectives`):

* **dp**: the batch split over ``data``; gradients summed over it.
* **sp**: the sequence split over ``seq`` in the zigzag layout
  (:func:`shard_lm_batch` permutes the global sequence), attended by the
  ring (:func:`~dtdl_tpu_torch.parallel.sequence.ring_attention`).  With
  ``seq`` of 1 and ``fuse_rope`` the local attend is the whole sequence:
  :func:`~dtdl_tpu_torch.ops.attention.flash_attention` with the rotary
  embedding fused (kernels K1-K3 on the card).
* **pp**: layers stacked ``[n_stages, layers_per_stage, ...]`` and split
  over ``pipe``.  **1F1B** (the default, :func:`n_pipeline_ticks` ticks
  in warm-up, steady and cool-down segments, ``virtual_stages`` chunks a
  device, a ring of ``min(k_span, 2vS-1)`` saved chunk inputs, each
  chunk's forward recomputed at its backward tick) or **GPipe** (autograd
  through the differentiable ``ppermute`` of a lockstep forward).
* **tp**: Megatron column→row attention and MLP over ``model``: ``copy_to``
  (*f*: identity, gradient summed) before the column-parallel products,
  ``psum`` (*g*: sum, gradient passed) after the row-parallel ones; the
  1F1B head is vocab-parallel.
* **ep**: MoE experts split over ``model``; routed dispatch (capacity
  ``C = ceil(cf·T_loc·k/E)``, top-k, a token ``all_to_all`` to each
  expert's owner and back) or the dense one-hot oracle.

Where JAX's VMA-typed autodiff sums a gradient over an axis (a
replicated value used with a varying one), the port puts ``copy_to``
at the same place, or, for parameters, sums their gradients once after
the backward: every block weight over ``data`` and ``seq``; the
embedding over all four axes (1F1B) or ``data`` and ``seq`` (GPipe);
``ln_f`` over ``data``, ``seq`` and (1F1B) ``pipe``.  The routed MoE's
router meets the ``model``-partitioned tokens, so it takes ``copy_to``
over ``model`` inside the layer.

Parameters are a tree of this rank's shards (``place_params``), each a
leaf tensor whose ``.grad`` the step fills before the optimizer (a
:mod:`dtdl_tpu_torch.train.optim` transform over the shards; both are
elementwise, so exact under sharding) updates it in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from dtdl_tpu_torch.device import resolve_device, upload
from dtdl_tpu_torch.ops.attention import flash_attention
from dtdl_tpu_torch.ops.rope import apply_rope, rope_frequencies
from dtdl_tpu_torch.parallel.collectives import (all_to_all, copy_to, pmax,
                                                 pmin, ppermute, psum)
from dtdl_tpu_torch.parallel.sequence import (ring_attention, zigzag_order,
                                              zigzag_positions)
from dtdl_tpu_torch.runtime.bootstrap import process_count
from dtdl_tpu_torch.runtime.mesh import Mesh, build_mesh

DATA, SEQ, PIPE, MODEL = "data", "seq", "pipe", "model"
AXES = (DATA, SEQ, PIPE, MODEL)


@dataclasses.dataclass(frozen=True)
class MegatronConfig:
    vocab_size: int = 256
    d_model: int = 64
    n_heads: int = 4
    d_ff: int = 128
    n_stages: int = 2             # pipeline stages (== mesh 'pipe' size)
    layers_per_stage: int = 1
    n_experts: int = 0            # 0 = dense MLP; else experts over 'model'
    max_seq: int = 128
    n_microbatches: int = 2
    schedule: str = "1f1b"        # '1f1b' (default) or 'gpipe'
    virtual_stages: int = 1       # v chunks/device: interleaved 1F1B when >1
    moe_dispatch: str = "routed"  # 'routed' (capacity + all-to-all) | 'dense'
    capacity_factor: float = 1.25  # per-expert slots = cf * tokens*k / E
    moe_top_k: int = 1            # experts per token (1 = Switch, 2 = GShard)
    moe_aux_weight: float = 0.01  # Switch load-balance loss, in the loss
    dtype: torch.dtype = torch.bfloat16
    # the fused-rope attend: at 'seq' 1 flash_attention with the rotary
    # embedding fused (K1-K3 on the card), at 'seq' > 1 the ring rotating
    # each K block at its owner's positions.  'auto' fuses when the
    # activations are CUDA tensors (the JAX package's 'auto' fuses on a
    # TPU); True forces it (the CPU parity tests); False runs apply_rope
    # and then the ring
    fuse_rope: Any = "auto"

    def __post_init__(self):
        if self.n_experts and not (1 <= self.moe_top_k <= self.n_experts):
            raise ValueError(
                f"moe_top_k={self.moe_top_k} must be in [1, n_experts="
                f"{self.n_experts}]")

    @property
    def head_dim(self):
        return self.d_model // self.n_heads

    @property
    def n_layers(self):
        return self.n_stages * self.layers_per_stage


def factor_mesh(n_devices: int) -> tuple[int, int, int, int]:
    """Cost-aware (data, seq, pipe, model) sizes for ``n_devices``: one
    doubling per axis in model -> pipe -> seq order up to 8 devices, then
    tensor parallel up to 8, pipeline up to 4, and data parallelism takes
    the rest, odd factors included (16 -> (1,2,2,4), 128 -> (2,2,4,8))."""
    shape = {"data": 1, "seq": 1, "pipe": 1, "model": 1}
    rem = n_devices
    for ax in ("model", "pipe", "seq"):          # bootstrap doublings
        if rem % 2 == 0:
            shape[ax] *= 2
            rem //= 2
    while rem % 2 == 0 and shape["model"] < 8:   # tp within a node first
        shape["model"] *= 2
        rem //= 2
    while rem % 2 == 0 and shape["pipe"] < 4:    # then pp
        shape["pipe"] *= 2
        rem //= 2
    shape["data"] *= rem                         # dp takes the rest
    return (shape["data"], shape["seq"], shape["pipe"], shape["model"])


def build_4d_mesh() -> Mesh:
    """The process world as a ``(data, seq, pipe, model)`` mesh of
    :func:`factor_mesh`'s shape (``(1, 1, 1, 1)`` for one process)."""
    return build_mesh(factor_mesh(process_count()), AXES)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def param_specs(cfg: MegatronConfig) -> dict:
    """The mesh axis each parameter dim is split over (``None``:
    replicated), as the JAX ``PartitionSpec``s: stacked block params lead
    with ``[n_stages, layers_per_stage]`` split over 'pipe'; TP splits the
    head/ff dims over 'model'; expert weights split the expert dim."""
    specs = {
        "embed": (None, None),                   # [V, D] replicated
        "ln_f": (),                              # [D]
        "blocks": {
            "ln_attn": (PIPE,),                  # [st, L, D]
            "wq": (PIPE, None, None, MODEL),     # [st, L, D, H*hd] col-par
            "wk": (PIPE, None, None, MODEL),
            "wv": (PIPE, None, None, MODEL),
            "wo": (PIPE, None, MODEL, None),     # [st, L, H*hd, D] row-par
            "ln_mlp": (PIPE,),
        },
    }
    if cfg.n_experts:
        specs["blocks"].update({
            "router": (PIPE, None, None, None),       # [st, L, D, E]
            "wi": (PIPE, None, MODEL, None, None),    # [st, L, E, D, F]
            "wg": (PIPE, None, MODEL, None, None),
            "wo_mlp": (PIPE, None, MODEL, None, None),  # [st, L, E, F, D]
        })
    else:
        specs["blocks"].update({
            "wi": (PIPE, None, None, MODEL),     # [st, L, D, F] col-par
            "wg": (PIPE, None, None, MODEL),
            "wo_mlp": (PIPE, None, MODEL, None),  # [st, L, F, D] row-par
        })
    return specs


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def _leaves(tree, prefix=""):
    """(path, leaf) pairs in sorted-key order, as JAX's tree leaves."""
    for k in sorted(tree):
        path = f"{prefix}{k}"
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], path + "/")
        else:
            yield path, tree[k]


def _global_shapes(cfg: MegatronConfig) -> dict:
    """The global shape of every parameter."""
    st, L, D = cfg.n_stages, cfg.layers_per_stage, cfg.d_model
    H, Fd, E = cfg.n_heads * cfg.head_dim, cfg.d_ff, cfg.n_experts
    blocks = {"ln_attn": (st, L, D), "wq": (st, L, D, H),
              "wk": (st, L, D, H), "wv": (st, L, D, H), "wo": (st, L, H, D),
              "ln_mlp": (st, L, D)}
    if E:
        blocks.update(router=(st, L, D, E), wi=(st, L, E, D, Fd),
                      wg=(st, L, E, D, Fd), wo_mlp=(st, L, E, Fd, D))
    else:
        blocks.update(wi=(st, L, D, Fd), wg=(st, L, D, Fd),
                      wo_mlp=(st, L, Fd, D))
    return {"embed": (cfg.vocab_size, D), "ln_f": (D,), "blocks": blocks}


def init_params(cfg: MegatronConfig, seed: int = 0) -> dict:
    """Global-shape parameter tree (f32 CPU tensors) from ``seed``,
    drawn by an explicit ``torch.Generator`` in a fixed order, so every
    world size slices the same weights (:func:`place_params`): fan-in
    scaled normal matmul weights, unit norm scales, embedding std 0.02."""
    shapes = _global_shapes(cfg)
    gen = torch.Generator().manual_seed(seed)
    blocks = {k: torch.ones(s) if k.startswith("ln_") else
              torch.randn(s, generator=gen) / math.sqrt(s[-2])
              for k, s in sorted(shapes["blocks"].items())}
    return {"embed": torch.randn(shapes["embed"], generator=gen) * 0.02,
            "ln_f": torch.ones(shapes["ln_f"]), "blocks": blocks}


def _shard(array, spec, mesh: Mesh):
    """This rank's block of a global array under ``spec``."""
    coords = mesh.coords()
    idx = []
    for dim, axis in enumerate(spec):
        if axis is None:
            idx.append(slice(None))
            continue
        n = mesh.shape[axis]
        if array.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {array.shape[dim]} does "
                             f"not split over {n} on {axis!r}")
        per = array.shape[dim] // n
        idx.append(slice(coords[axis] * per, (coords[axis] + 1) * per))
    return array[tuple(idx)]


def place_params(mesh: Mesh, cfg: MegatronConfig, params: dict,
                 device=None) -> dict:
    """This rank's shards of a global parameter tree (numpy arrays, for
    example ``np.asarray`` of the JAX package's ``init_params``, or
    tensors): f32 leaf tensors on ``device`` (``None``: the card) that
    require grad."""
    dev = resolve_device(device)

    def place(a, spec):
        a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
            else np.asarray(a)
        # a copy: the step updates the shards in place
        t = upload(np.array(_shard(a, spec, mesh), np.float32), dev)
        return t.requires_grad_()
    return _tree_map(place, params, param_specs(cfg))


# ---------------------------------------------------------------------------
# per-stage forward (on this rank's shards)
# ---------------------------------------------------------------------------

def _rms(x, scale, eps=1e-6):
    x32 = x.float()
    return (x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
            * scale).to(x.dtype)


def _fuse(cfg, x) -> bool:
    return x.is_cuda if cfg.fuse_rope == "auto" else bool(cfg.fuse_rope)


def _attention(cfg, mesh, p, x, cos, sin):
    """TP column→row attention, the ring over 'seq' (or, at 'seq' 1 and
    fused, flash attention with rope)."""
    b, s_loc, _ = x.shape
    hd = cfg.head_dim
    h_loc = p["wq"].shape[-1] // hd              # local heads (H / tp)
    xm = copy_to(x, mesh, MODEL)                 # Megatron f

    def proj(w):
        y = torch.matmul(xm, w.to(cfg.dtype))
        return y.reshape(b, s_loc, h_loc, hd).transpose(1, 2)

    q, k, v = proj(p["wq"]), proj(p["wk"]), proj(p["wv"])
    # zigzag layout: each 'seq' shard holds one low and one high chunk;
    # rope takes the rows' global positions (the identity at seq 1)
    pos = zigzag_positions(mesh, SEQ, s_loc, x.device)
    fuse = _fuse(cfg, x)
    if fuse and mesh.axis_size(SEQ) == 1:
        o = flash_attention(q, k, v, causal=True, rope=(cos, sin),
                            rope_positions=(pos, pos))
    elif fuse:
        o = ring_attention(q, k, v, mesh=mesh, axis_name=SEQ, causal=True,
                           layout="zigzag", rope=(cos, sin))
    else:
        q = apply_rope(q, cos, sin, positions=pos)
        k = apply_rope(k, cos, sin, positions=pos)
        o = ring_attention(q, k, v, mesh=mesh, axis_name=SEQ, causal=True,
                           layout="zigzag")
    o = o.transpose(1, 2).reshape(b, s_loc, h_loc * hd)
    y = torch.matmul(o, p["wo"].to(cfg.dtype))
    return psum(y, mesh, MODEL)                  # Megatron g


def _mlp_dense(cfg, mesh, p, x):
    xm = copy_to(x, mesh, MODEL)
    h = F.silu(torch.matmul(xm, p["wg"].to(cfg.dtype))) * \
        torch.matmul(xm, p["wi"].to(cfg.dtype))
    return psum(torch.matmul(h, p["wo_mlp"].to(cfg.dtype)), mesh, MODEL)


def _aux_balance_loss(first_choice_cnt, prob_sum, n_tok_global, n_experts):
    """Switch-Transformer load-balance loss ``E·<f, p>`` from global
    statistics (already summed over every axis that partitions tokens);
    ``f`` comes from argmax counts, so the gradient moves the probs."""
    denom = torch.clamp(n_tok_global, min=1.0)
    return n_experts * torch.sum((first_choice_cnt / denom)
                                 * (prob_sum / denom))


def _top_k(probs, k):
    """``lax.top_k``: the k largest, the lower index first among equals."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _gates(topv, k):
    return topv if k == 1 else \
        topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)


def _one_hot(idx, n, dtype=torch.float32):
    """``jax.nn.one_hot``: a zero row for an index outside [0, n)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _mlp_moe_routed(cfg, mesh, p, x):
    """Capacity-factor top-k routed MoE with a token all-to-all over
    'model'.  The 'model'-replicated tokens are partitioned over 'model'
    first (each rank routes its T/tp slice); ``C = ceil(cf·T_loc·k/E)``
    slots per (source rank, expert), filled first choices first;
    overflow assignments drop.  Returns ``(y, (n_dropped, n_assign,
    aux))``."""
    e_loc = p["wi"].shape[0]                     # local experts (E / tp)
    tp = mesh.axis_size(MODEL)
    my = mesh.axis_index(MODEL)
    E, K, dt = e_loc * tp, cfg.moe_top_k, cfg.dtype
    b, s, D = x.shape
    T = b * s
    xf = x.reshape(T, D)
    Tp = -(-T // tp) * tp                        # pad to a tp multiple
    if Tp != T:
        xf = F.pad(xf, (0, 0, 0, Tp - T))
    T_loc = Tp // tp
    # the token partition: an invariant value sliced by a varying index
    xs = copy_to(xf, mesh, MODEL)[my * T_loc:(my + 1) * T_loc]
    valid = (my * T_loc + torch.arange(T_loc, device=x.device)) < T

    router = copy_to(p["router"], mesh, MODEL)
    probs = torch.softmax(torch.matmul(xs.float(), router), -1)
    topv, topi = _top_k(probs, K)                # [T_loc, K]
    gate_w = _gates(topv, K)
    eid = torch.where(valid[:, None], topi, torch.full_like(topi, E))

    # load-balance statistics over the global batch
    validf32 = valid.float()
    stats = torch.cat([_one_hot(eid[:, 0], E).sum(0),
                       (probs * validf32[:, None]).sum(0),
                       validf32.sum()[None]])
    stats = psum(stats, mesh, (DATA, SEQ, MODEL))
    aux = _aux_balance_loss(stats[:E], stats[E:2 * E], stats[2 * E], E)

    # choice-major: every first choice takes its slot before any second
    eidf = eid.t().reshape(K * T_loc)
    validf = valid.repeat(K)
    C = max(1, math.ceil(cfg.capacity_factor * T_loc * K / E))
    # each assignment's slot in its expert: the running count of that
    # expert's assignments, scanned along the innermost dim (a scan over
    # the outer dim of an [N, E] tensor took 5.8 ms a layer on the card)
    oh = (torch.arange(E, device=x.device)[:, None]
          == eidf[None]).long()                  # [E, K*T_loc]; none for E
    pos = (torch.cumsum(oh, 1) - 1).gather(
        0, eidf.clamp(0, E - 1)[None])[0]
    kept = (eidf < E) & (pos < C)
    counts = torch.stack([(validf & ~kept).float().sum(),
                          validf.float().sum()])

    # scatter the kept assignments into per-expert slots (a trash row
    # takes the rest), a2a to the experts' owners, experts, a2a back
    dest = torch.where(kept, eidf * C + pos, torch.full_like(eidf, E * C))
    xsk = xs.to(dt).repeat(K, 1)
    send = xsk.new_zeros(E * C + 1, D).index_put((dest,), xsk)
    recv = all_to_all(send[:E * C].view(E, C, D), mesh, MODEL, 0, 0)
    toks = recv.reshape(tp, e_loc, C, D).transpose(0, 1).reshape(
        e_loc, tp * C, D)
    h = F.silu(torch.bmm(toks, p["wg"].to(dt))) * \
        torch.bmm(toks, p["wi"].to(dt))
    out = torch.bmm(h, p["wo_mlp"].to(dt))       # [e_loc, tp*C, D]
    back = out.reshape(e_loc, tp, C, D).transpose(0, 1).reshape(
        tp * e_loc, C, D)
    ybuf = all_to_all(back, mesh, MODEL, 0, 0).reshape(E * C, D)
    yk = torch.cat([ybuf, ybuf.new_zeros(1, D)]).index_select(0, dest)
    w_k = gate_w.t().reshape(K * T_loc) * kept.float()
    y = (yk * w_k.to(dt)[:, None]).reshape(K, T_loc, D).sum(0)

    # back to the full 'model'-invariant token set
    parts = [y.new_zeros(T_loc, D)] * tp
    parts[my] = y
    yfull = psum(torch.stack(parts), mesh, MODEL).reshape(Tp, D)[:T]
    counts = psum(counts, mesh, MODEL)
    return yfull.reshape(b, s, D), (counts[0], counts[1], aux)


def _mlp_moe(cfg, mesh, p, x):
    """Expert-parallel switch MLP, one-hot dispatch: the oracle of the
    routed path (O(tokens × experts)); never drops.  Returns ``(y, (0,
    0, aux))``."""
    e_loc = p["wi"].shape[0]                     # [E/tp, D, F] local
    my = mesh.axis_index(MODEL)
    E, K, dt = e_loc * mesh.axis_size(MODEL), cfg.moe_top_k, cfg.dtype
    probs = torch.softmax(torch.matmul(x.float(), p["router"]), -1)
    topv, topi = _top_k(probs, K)                # [b, s, K]
    gate_w = _gates(topv, K)
    stats = torch.cat([_one_hot(topi[..., 0], E).sum((0, 1)),
                       probs.sum((0, 1)),
                       probs.new_full((1,), probs.shape[0] * probs.shape[1])])
    stats = psum(stats, mesh, (DATA, SEQ))
    aux = _aux_balance_loss(stats[:E], stats[E:2 * E], stats[2 * E], E)

    xm = copy_to(x, mesh, MODEL)
    wi, wg, wo = (p[n].to(dt) for n in ("wi", "wg", "wo_mlp"))
    y = torch.zeros_like(x)
    for k in range(K):
        onehot = _one_hot(topi[..., k] - my * e_loc, e_loc, dt)
        xe = torch.einsum("bse,bsd->ebsd", onehot, xm)
        h = F.silu(torch.einsum("ebsd,edf->ebsf", xe, wg)) * \
            torch.einsum("ebsd,edf->ebsf", xe, wi)
        yk = torch.einsum("ebsf,efd->bsd", h, wo)
        y = y + psum(yk, mesh, MODEL) * gate_w[..., k:k + 1].to(dt)
    zero = x.new_zeros((), dtype=torch.float32)
    return y, (zero, zero, aux)


def _stage_forward(cfg, mesh, stage_params, x, cos, sin):
    """This stage's (or chunk's) blocks in order.  Returns ``(x,
    (n_dropped, n_assign, aux))`` summed over its layers."""
    zero = x.new_zeros((), dtype=torch.float32)
    drop = tot = auxs = zero
    for li in range(next(iter(stage_params.values())).shape[0]):
        p = {k: a[li] for k, a in stage_params.items()}
        x = x + _attention(cfg, mesh, p, _rms(x, p["ln_attn"]), cos, sin)
        h = _rms(x, p["ln_mlp"])
        if cfg.n_experts:
            y, st = (_mlp_moe_routed if cfg.moe_dispatch == "routed"
                     else _mlp_moe)(cfg, mesh, p, h)
            drop, tot, auxs = drop + st[0], tot + st[1], auxs + st[2]
        else:
            y = _mlp_dense(cfg, mesh, p, h)
        x = x + y
    return x, (drop, tot, auxs)


def _rope(cfg, device):
    return rope_frequencies(cfg.head_dim, cfg.max_seq, device=device)


# ---------------------------------------------------------------------------
# the GPipe schedule + loss
# ---------------------------------------------------------------------------

def _pipeline(cfg, mesh, params, x_micro, cos, sin):
    """Microbatches through the pipe in lockstep, every stage every tick
    (masked, as the JAX scan), so that every rank's graph holds every
    ``ppermute`` and autograd runs them all backward.  Returns the
    stacked outputs of the last stage on every stage and the stats."""
    S, M = cfg.n_stages, cfg.n_microbatches
    stage = mesh.axis_index(PIPE)
    dev = x_micro.device
    stage_params = {k: a[0] for k, a in params["blocks"].items()}
    perm = [(i, (i + 1) % S) for i in range(S)]
    first = torch.tensor(stage == 0, device=dev)
    x_micro = copy_to(x_micro, mesh, PIPE)   # used on 'pipe'-varying data
    buf = torch.zeros_like(x_micro[0])
    outputs = [torch.zeros_like(buf) for _ in range(M)]
    zero = torch.zeros((), device=dev)
    drop = tot = auxs = zero
    for t in range(M + S - 1):
        buf = torch.where(first, x_micro[min(max(t, 0), M - 1)], buf)
        y, st = _stage_forward(cfg, mesh, stage_params, buf, cos, sin)
        if 0 <= t - stage < M:          # real data on this stage
            drop, tot, auxs = drop + st[0], tot + st[1], auxs + st[2]
        out_idx = min(max(t - (S - 1), 0), M - 1)
        collect = torch.tensor(stage == S - 1 and t >= S - 1, device=dev)
        outputs[out_idx] = torch.where(collect, y, outputs[out_idx])
        buf = ppermute(y, mesh, PIPE, perm)
    last = torch.tensor(stage == S - 1, device=dev)
    outs = torch.stack(outputs)
    outs = psum(torch.where(last, outs, torch.zeros_like(outs)), mesh, PIPE)
    return outs, (drop, tot, auxs)


def _loss_fn(cfg, mesh, params, tokens, targets, mask):
    """Global-mean causal LM loss on this rank's shards: ``(loss, (drop,
    tot, aux_mean))``; the gradients by autograd."""
    b_loc, s_loc = tokens.shape
    M = cfg.n_microbatches
    emb = params["embed"]
    x = emb[tokens].to(cfg.dtype)                # [b, s, D]
    cos, sin = _rope(cfg, x.device)
    y, (drop, tot, auxs) = _pipeline(
        cfg, mesh, params, x.reshape(M, b_loc // M, s_loc, cfg.d_model),
        cos, sin)
    y = _rms(y.reshape(b_loc, s_loc, cfg.d_model), params["ln_f"])
    logits = torch.matmul(y.float(), emb.float().t())
    lse = torch.logsumexp(logits, -1)
    true_logit = logits.gather(-1, targets[..., None])[..., 0]
    local_sum = ((lse - true_logit) * mask).sum()
    total = psum(mask.sum(), mesh, (DATA, SEQ))
    loss = psum(local_sum, mesh, (DATA, SEQ)) / torch.clamp(total, min=1.0)
    aux_mean = torch.zeros((), device=x.device)
    if cfg.n_experts:
        # each layer's aux is a global value, the same on every data/seq
        # rank; psum(PIPE) adds the stages' layers
        aux_mean = psum(auxs, mesh, PIPE) / (cfg.n_layers * M)
        loss = loss + cfg.moe_aux_weight * aux_mean
    counts = psum(torch.stack([drop, tot]).detach(), mesh, (DATA, SEQ, PIPE))
    return loss, (counts[0], counts[1], aux_mean.detach())


# ---------------------------------------------------------------------------
# the 1F1B schedule (explicit backward, remat per chunk)
# ---------------------------------------------------------------------------

def n_pipeline_ticks(cfg: MegatronConfig) -> int:
    """Combined fwd+bwd tick count of the (interleaved) 1F1B schedule:
    ``(vS-1) + (S-1) + g·vS + (v-1)S + j + 1`` with ``(g, j) =
    divmod(M-1, S)``; ``M + 2(S-1)`` at v = 1."""
    S, M, v = cfg.n_stages, cfg.n_microbatches, cfg.virtual_stages
    g, j = divmod(M - 1, S)
    return (v * S - 1) + (S - 1) + g * v * S + (v - 1) * S + j + 1


def bubble_fraction(cfg: MegatronConfig) -> float:
    """Idle time fraction of the segmented 1F1B schedule, ``1 - Mv / (T -
    (vS-1))``: the Megatron interleaved bound ``(S-1)(tf+tb)/v`` of idle
    time when S divides M (``(S-1)/(M+S-1)`` at v = 1)."""
    S, m, v = cfg.n_stages, cfg.n_microbatches, cfg.virtual_stages
    return 1.0 - m * v / (n_pipeline_ticks(cfg) - (v * S - 1))


def _head_rows(cfg, mesh) -> slice:
    """This rank's rows of the vocab-parallel head: its V/tp slice when
    'model' splits the vocab evenly, else every row (the replicated
    head)."""
    tp = mesh.axis_size(MODEL)
    if tp > 1 and cfg.vocab_size % tp == 0:
        v_loc = cfg.vocab_size // tp
        off = mesh.axis_index(MODEL) * v_loc
        return slice(off, off + v_loc)
    return slice(None)


def _lse_and_true_logit(mesh, logits, targets, rows: slice):
    """(logsumexp, the target's logit) of each position from this rank's
    ``logits`` over the vocab ``rows``: over a split vocab, combined by
    one psum each (the full logits never exist)."""
    if rows == slice(None):
        return (torch.logsumexp(logits, -1),
                logits.gather(-1, targets[..., None])[..., 0])
    off, v_loc = rows.start, rows.stop - rows.start
    mx = pmax(logits.amax(-1), mesh, MODEL)
    se = psum(torch.exp(logits - mx[..., None]).sum(-1), mesh, MODEL)
    in_range = (targets >= off) & (targets < off + v_loc)
    idx = torch.clamp(targets - off, 0, v_loc - 1)
    true_logit = psum(torch.where(
        in_range, logits.gather(-1, idx[..., None])[..., 0],
        torch.zeros((), device=logits.device)), mesh, MODEL)
    return mx + torch.log(se), true_logit


def _head_loss(cfg, mesh, emb, ln_f, y, targets, mask, inv_total):
    """Vocab-parallel LM head: the scaled loss-sum of one microbatch;
    ``emb`` holds this rank's :func:`_head_rows`."""
    tp = mesh.axis_size(MODEL)
    h = copy_to(_rms(y, ln_f).float(), mesh, MODEL)
    logits = torch.matmul(h, emb.float().t())
    lse, true_logit = _lse_and_true_logit(mesh, logits, targets,
                                          _head_rows(cfg, mesh))
    loss = ((lse - true_logit) * mask).sum() * inv_total
    if tp > 1 and cfg.vocab_size % tp:
        # the replicated head: every rank computed the same value, and
        # the mean is the value (its gradient a 1/tp share each)
        loss = psum(loss, mesh, MODEL) / tp
    return loss


def _value_and_grad_1f1b(cfg, mesh, params, tokens, targets, mask):
    """``(loss, aux)`` and the gradients in every parameter's ``.grad``
    through the explicit (interleaved) 1F1B schedule.

    Ticks as JAX's scan segments: a forward-only warm-up (vS-1 ticks),
    the two-lane steady segment (a forward chunk, the head on the last
    device's final chunk, a backward chunk) and a backward-only
    cool-down.  Forward lane at tick t on device s: ``t' = t - s``, group
    ``g = t' // vS``, chunk ``c = (t' mod vS) // S``, microbatch ``g·S +
    (t' mod S)``; the backward lane mirrors it shifted by ``(vS-1) +
    (S-1-s)``.  A lane with no microbatch computes nothing (JAX computes
    and masks it; no active lane ever reads the result) and its hop
    carries zeros.  A chunk's forward runs without a graph; its backward
    tick recomputes it from the saved input and backpropagates (dy and,
    for MoE, the aux-loss cotangent) into the block leaves' ``.grad``.
    Embedding, head and ``ln_f`` cotangents accumulate locally and are
    summed once after the schedule; the head's vocab-sharded rows and the
    input embedding's (divided by tp first) share one [V, D]
    accumulator summed over all four axes."""
    S, M, v = cfg.n_stages, cfg.n_microbatches, cfg.virtual_stages
    Lc = cfg.layers_per_stage // v            # layers per chunk
    b_loc, s_loc = tokens.shape
    mb = b_loc // M
    stage = mesh.axis_index(PIPE)
    tp = mesh.axis_size(MODEL)
    emb, lnf = params["embed"], params["ln_f"]
    dev = emb.device
    cos, sin = _rope(cfg, dev)
    inv_total = 1.0 / torch.clamp(psum(mask.sum(), mesh, (DATA, SEQ)),
                                  min=1.0)
    tok_micro = tokens.reshape(M, mb, s_loc)
    tgt_micro = targets.reshape(M, mb, s_loc)
    msk_micro = mask.reshape(M, mb, s_loc)
    p_stage = {k: a[0] for k, a in params["blocks"].items()}

    def chunk_params(c):
        return {k: a[c * Lc:(c + 1) * Lc] for k, a in p_stage.items()}

    aux_cot = (cfg.moe_aux_weight / (cfg.n_layers * M)
               if cfg.n_experts else 0.0)
    perm_up = [(i, (i + 1) % S) for i in range(S)]
    perm_down = [(i, (i - 1) % S) for i in range(S)]
    g_last, j_last = divmod(M - 1, S)
    k_span = g_last * v * S + (v - 1) * S + j_last + 1
    n_slots = min(k_span, 2 * v * S - 1)
    n_ticks = n_pipeline_ticks(cfg)
    warm_end = v * S - 1
    fwd_end = n_ticks - warm_end

    def fwd_indices(t):
        tp_ = t - stage
        g, w = divmod(tp_, v * S)
        c, m = w // S, g * S + w % S
        return tp_ >= 0 and m < M, c, m, tp_

    def bwd_indices(t):
        tb = t - (v * S - 1) - (S - 1 - stage)
        g, w = divmod(tb, v * S)
        j = w % S
        chunk = v - 1 - w // S
        return tb >= 0 and g * S + j < M, chunk, g * S + j, \
            g * (v * S) + chunk * S + j

    rows = _head_rows(cfg, mesh)
    demb = torch.zeros_like(emb, dtype=torch.float32)
    dlnf = torch.zeros_like(lnf, dtype=torch.float32)
    zeros_act = torch.zeros(mb, s_loc, cfg.d_model, dtype=cfg.dtype,
                            device=dev)
    buf_f = buf_b = zeros_act
    x_saved = [None] * n_slots
    zero = torch.zeros((), device=dev)
    loss = drop = tot = auxs = zero
    for t in range(n_ticks):
        do_fwd, do_bwd = t < fwd_end, t >= warm_end
        y = dy_head = dx = None
        if do_fwd:
            f_active, c_f, m_f, k_f = fwd_indices(t)
            if f_active:
                with torch.no_grad():
                    x_in = (emb[tok_micro[m_f]].to(cfg.dtype)
                            if stage == 0 and c_f == 0 else buf_f)
                    x_saved[k_f % n_slots] = x_in
                    y, st = _stage_forward(cfg, mesh, chunk_params(c_f),
                                           x_in, cos, sin)
                drop, tot, auxs = drop + st[0], tot + st[1], auxs + st[2]
            if do_bwd and f_active and stage == S - 1 and c_f == v - 1:
                # the head on the final chunk's output; its dy feeds this
                # same tick's backward lane
                e = emb[rows].detach().requires_grad_()
                lf = lnf.detach().requires_grad_()
                yy = y.detach().requires_grad_()
                with torch.enable_grad():
                    loss_m = _head_loss(cfg, mesh, e, lf, yy, tgt_micro[m_f],
                                        msk_micro[m_f], inv_total)
                    loss_m.backward()
                loss = loss + loss_m.detach()
                demb[rows] += e.grad
                dlnf += lf.grad
                dy_head = yy.grad
        if do_bwd:
            b_active, c_b, u_b, k_b = bwd_indices(t)
            if b_active:
                x_b = x_saved[k_b % n_slots].detach().requires_grad_()
                if stage == S - 1 and c_b == v - 1:
                    if dy_head is None:
                        raise AssertionError(
                            f"1F1B tick {t}: the final chunk's backward "
                            f"has no head cotangent")
                    dy = dy_head
                else:
                    dy = buf_b
                with torch.enable_grad():
                    y_b, st_b = _stage_forward(cfg, mesh, chunk_params(c_b),
                                               x_b, cos, sin)
                    outs, cots = [y_b], [dy]
                    if cfg.n_experts:
                        outs.append(st_b[2])
                        cots.append(torch.full((), aux_cot, device=dev))
                    torch.autograd.backward(outs, cots)
                dx = x_b.grad
                if stage == 0 and c_b == 0:
                    # the input embedding's scatter-add; index_put_'s sorted
                    # accumulation is deterministic on CUDA (index_add_'s
                    # atomics are not, and a resume must be bitwise)
                    demb.index_put_((tok_micro[u_b].reshape(-1),),
                                    dx.float().reshape(-1, cfg.d_model) / tp,
                                    accumulate=True)
        # the ring handoffs of the lanes this segment runs
        with torch.no_grad():
            if do_fwd:
                buf_f = ppermute(zeros_act if y is None else y, mesh, PIPE,
                                 perm_up)
            if do_bwd:
                buf_b = ppermute(zeros_act if dx is None else dx, mesh, PIPE,
                                 perm_down)

    with torch.no_grad():
        emb.grad = psum(demb, mesh, AXES)
        lnf.grad = psum(dlnf, mesh, (DATA, SEQ, PIPE))
        for a in params["blocks"].values():
            if a.grad is None:
                a.grad = torch.zeros_like(a)
            a.grad = psum(a.grad, mesh, (DATA, SEQ))
        loss = psum(loss, mesh, (DATA, SEQ, PIPE))
        aux_mean = torch.zeros((), device=dev)
        if cfg.n_experts:
            aux_mean = psum(auxs, mesh, PIPE) / (cfg.n_layers * M)
            loss = loss + cfg.moe_aux_weight * aux_mean
        counts = psum(torch.stack([drop, tot]), mesh, (DATA, SEQ, PIPE))
    return loss, (counts[0], counts[1], aux_mean)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def opt_state_specs(cfg: MegatronConfig, optimizer=None) -> dict:
    """The split of the optimizer state: each per-parameter slot
    (momentum, second moment) as its parameter's :func:`param_specs`;
    scalar bookkeeping (step counts) is replicated."""
    return param_specs(cfg)


def _validate(cfg: MegatronConfig, mesh: Mesh) -> None:
    if cfg.n_stages != mesh.shape[PIPE]:
        raise ValueError(
            f"cfg.n_stages={cfg.n_stages} must equal mesh 'pipe' size "
            f"{mesh.shape[PIPE]}")
    if cfg.schedule not in ("1f1b", "gpipe"):
        raise ValueError(f"unknown pipeline schedule {cfg.schedule!r}")
    if cfg.schedule == "gpipe" and cfg.virtual_stages != 1:
        raise ValueError("virtual_stages (interleaved schedule) requires "
                         "schedule='1f1b'")
    if cfg.layers_per_stage % cfg.virtual_stages:
        raise ValueError(f"virtual_stages={cfg.virtual_stages} must divide "
                         f"layers_per_stage={cfg.layers_per_stage}")


def _check_batch(cfg, mesh, tokens) -> None:
    b_loc = tokens.shape[0]
    if b_loc % cfg.n_microbatches:
        n_data = mesh.shape[DATA]
        raise ValueError(
            f"batch size {b_loc * n_data} is not splittable: the local "
            f"batch b_loc = {b_loc} must satisfy b_loc % n_microbatches == "
            f"0 (n_microbatches={cfg.n_microbatches}); use a global batch "
            f"that is a multiple of {n_data * cfg.n_microbatches}")


def init_optimizer(cfg: MegatronConfig, mesh: Mesh, optimizer, params):
    """The optimizer (a :mod:`dtdl_tpu_torch.train.optim` transform) over
    this rank's parameter shards, in :func:`_leaves` order."""
    return optimizer.init([a for _, a in _leaves(params)])


def make_megatron_train_step(cfg: MegatronConfig, mesh: Mesh, optimizer):
    """The 4D-parallel train step ``(params, opt_state, tokens, targets,
    mask) -> (params, opt_state, loss, metrics)`` on this rank's shards
    (:func:`shard_lm_batch`); ``params`` are updated in place.  ``loss``
    is the global masked mean (plus the MoE aux term), the same on every
    rank; ``metrics`` hold ``moe_aux_loss`` and, routed,
    ``moe_dropped_frac``."""
    del optimizer      # the opt_state is the optimizer over the shards
    _validate(cfg, mesh)

    def step(params, opt_state, tokens, targets, mask):
        _check_batch(cfg, mesh, tokens)
        opt_state.zero_grad(set_to_none=True)
        if cfg.schedule == "1f1b":
            loss, aux = _value_and_grad_1f1b(cfg, mesh, params, tokens,
                                             targets, mask)
        else:
            loss, aux = _loss_fn(cfg, mesh, params, tokens, targets, mask)
            loss.backward()
            with torch.no_grad():
                for _, a in _leaves(params):
                    if a.grad is None:
                        a.grad = torch.zeros_like(a)
                    a.grad = psum(a.grad, mesh, (DATA, SEQ))
            loss = loss.detach()
        opt_state.step()
        metrics = {}
        if cfg.n_experts:
            drop, tot, aux_mean = aux
            metrics["moe_aux_loss"] = aux_mean
            if cfg.moe_dispatch == "routed":
                metrics["moe_dropped_frac"] = drop / torch.clamp(tot,
                                                                 min=1.0)
        return params, opt_state, loss, metrics

    return step


def make_megatron_eval_step(cfg: MegatronConfig, mesh: Mesh):
    """The 4D-parallel eval step ``(params, tokens, targets, mask) ->
    {'loss', 'accuracy', 'n_tokens'}``: the GPipe forward whatever the
    schedule, the vocab-parallel head (logsumexp, true logit and argmax
    combined over 'model' by psum, pmax and pmin), masked sums over
    'data' and 'seq' over the summed mask.  No MoE aux in the loss."""
    if cfg.n_stages != mesh.shape[PIPE]:
        raise ValueError(
            f"cfg.n_stages={cfg.n_stages} must equal mesh 'pipe' size "
            f"{mesh.shape[PIPE]}")

    @torch.no_grad()
    def eval_step(params, tokens, targets, mask):
        _check_batch(cfg, mesh, tokens)
        b_loc, s_loc = tokens.shape
        M = cfg.n_microbatches
        emb = params["embed"]
        x = emb[tokens].to(cfg.dtype)
        cos, sin = _rope(cfg, x.device)
        y, _ = _pipeline(cfg, mesh, params,
                         x.reshape(M, b_loc // M, s_loc, cfg.d_model),
                         cos, sin)
        h = _rms(y.reshape(b_loc, s_loc, cfg.d_model),
                 params["ln_f"]).float()
        rows = _head_rows(cfg, mesh)
        logits = torch.matmul(h, emb[rows].float().t())
        lse, true_logit = _lse_and_true_logit(mesh, logits, targets, rows)
        pred = logits.argmax(-1)
        if rows != slice(None):
            # the global argmax with the first-occurrence tie-break: the
            # ranks whose local max is the global one bid their index
            loc_max = logits.amax(-1)
            pred = pmin(torch.where(
                loc_max == pmax(loc_max, mesh, MODEL), pred + rows.start,
                torch.full_like(pred, cfg.vocab_size)), mesh, MODEL)
        sums = torch.stack([((lse - true_logit) * mask).sum(),
                            ((pred == targets).float() * mask).sum(),
                            mask.sum()])
        loss_sum, correct, count = psum(sums, mesh, (DATA, SEQ))
        denom = torch.clamp(count, min=1.0)
        return {"loss": loss_sum / denom, "accuracy": correct / denom,
                "n_tokens": count}

    return eval_step


def opt_state_tree(params: dict, opt_state, install: bool = False) -> dict:
    """``{slot: tree like params}`` of the optimizer's state over this
    rank's shards (the live tensors; a slot torch has not made yet as its
    zeros, which ``install`` puts into the optimizer), plus ``count`` of
    a scheduled optimizer: the snapshot view."""
    from dtdl_tpu_torch.train.state import _fresh_slots
    group_of = {p: g for g in opt_state.param_groups for p in g["params"]}
    tree: dict = {}
    for path, p in _leaves(params):
        live = opt_state.state.get(p)
        if not live:
            live = _fresh_slots(opt_state, group_of[p], p)
            if install and live:
                opt_state.state[p] = live
        for slot, v in live.items():
            if isinstance(v, torch.Tensor):
                node = tree.setdefault(slot, {})
                *outer, leaf = path.split("/")
                for k in outer:
                    node = node.setdefault(k, {})
                node[leaf] = v
    counts = {g["count"] for g in opt_state.param_groups if "count" in g}
    if counts:
        tree["count"] = counts.pop()
    return tree


def load_opt_state(params: dict, opt_state, tree: dict) -> None:
    """Copy a snapshot's ``opt_state`` tree (:func:`opt_state_tree`'s
    layout) into the optimizer in place."""
    live = opt_state_tree(params, opt_state, install=True)
    with torch.no_grad():
        for slot, by_param in live.items():
            if slot == "count":
                for g in opt_state.param_groups:
                    g["count"] = int(tree["count"])
                continue
            for (_, dst), (_, src) in zip(_leaves(by_param),
                                          _leaves(tree[slot])):
                dst.copy_(src)


def abstract_state(cfg: MegatronConfig, mesh: Mesh, optimizer, device=None):
    """``(params, opt_state)`` trees of zeros with this rank's shard
    shapes and dtypes on ``device`` (``None``: the card): the restore
    target of a 4D snapshot (each rank reads its own shards; nothing
    global is built)."""
    dev = resolve_device(device)

    def local(shape, spec):
        return torch.zeros([n // (mesh.shape[a] if a else 1) for n, a in
                            zip(shape, spec + (None,) * len(shape))],
                           device=dev, requires_grad=True)
    params = _tree_map(local, _global_shapes(cfg), param_specs(cfg))
    opt = init_optimizer(cfg, mesh, optimizer, params)
    return params, opt_state_tree(params, opt, install=True)


def shard_lm_batch(mesh: Mesh, batch: dict, device=None) -> dict:
    """This rank's block of a global host batch (``tokens``/``targets``
    int [global_batch, global_seq], ``mask`` f32): rows by its 'data'
    coordinate, columns by its 'seq' coordinate, after the GLOBAL
    sequence is laid out in the zigzag order when 'seq' > 1 (the 4D
    step's ring layout; the loss is a masked mean over positions, so the
    permutation changes nothing observable).  Every rank holds the
    global host batch, so the 'seq' axis may span processes.  Token
    arrays become int64 tensors, the rest f32, on ``device`` (``None``:
    the card)."""
    dev = resolve_device(device)
    n_sp = mesh.shape[SEQ]
    seq_len = next(iter(batch.values())).shape[1]
    order = zigzag_order(n_sp, seq_len)
    out = {}
    for k, a in batch.items():
        a = np.asarray(a)[:, order]
        a = _shard(a, (DATA, SEQ), mesh)
        dtype = torch.float32 if np.issubdtype(a.dtype, np.floating) \
            else torch.long
        out[k] = upload(np.array(a), dev, dtype)
    return out


def to_flax_params(cfg: MegatronConfig, params: dict) -> dict:
    """The 4D engine's GLOBAL stacked tree (numpy arrays or tensors) as
    the flax ``TransformerLM`` tree (numpy), which
    :func:`dtdl_tpu_torch.bridge.load_flax_params` loads into the port's
    model (:func:`to_flax_model`).  Execution order is the (interleaved)
    virtual pipeline's: virtual stage ``u = c·S + st`` runs device st's
    chunk-c rows, so flax ``block_j`` takes row ``order[j]``; attention
    kernels reshape [D, H·hd] -> [D, H, hd]."""
    S, Lc_total, v = cfg.n_stages, cfg.layers_per_stage, cfg.virtual_stages
    H, hd, D = cfg.n_heads, cfg.head_dim, cfg.d_model
    if Lc_total % v:
        raise ValueError(f"virtual_stages={v} must divide "
                         f"layers_per_stage={Lc_total}")
    Lc = Lc_total // v
    host = _tree_map(lambda a: a.detach().cpu().numpy()
                     if isinstance(a, torch.Tensor) else np.asarray(a),
                     params)
    order = [(u % S, (u // S) * Lc + i)
             for u in range(v * S) for i in range(Lc)]
    blocks = host["blocks"]
    out = {"embed": host["embed"], "ln_f": {"scale": host["ln_f"]}}
    for j, (st, li) in enumerate(order):
        p = {k: a[st, li] for k, a in blocks.items()}
        blk = {
            "ln_attn": {"scale": p["ln_attn"]},
            "ln_mlp": {"scale": p["ln_mlp"]},
            "attn": {
                "q": {"kernel": p["wq"].reshape(D, H, hd)},
                "k": {"kernel": p["wk"].reshape(D, H, hd)},
                "v": {"kernel": p["wv"].reshape(D, H, hd)},
                "out": {"kernel": p["wo"].reshape(H, hd, D)},
            },
        }
        if cfg.n_experts:
            blk["moe"] = {"router": {"kernel": p["router"]},
                          "wi": p["wi"], "wg": p["wg"], "wo": p["wo_mlp"]}
        else:
            blk["mlp"] = {"wi": {"kernel": p["wi"]},
                          "wg": {"kernel": p["wg"]},
                          "wo": {"kernel": p["wo_mlp"]}}
        out[f"block_{j}"] = blk
    return out


def to_flax_model(cfg: MegatronConfig, device=None, **overrides):
    """The port's ``TransformerLM`` matching ``cfg`` (weights left
    uninitialized: load :func:`to_flax_params`' tree with
    ``bridge.load_flax_params``), on ``device`` (``None``: the card).
    The bridge's settings, as JAX's: ``moe_every=1`` (an MoE in every
    block), the config's own ``moe_dispatch`` (serving keeps the trained
    routing), dense attention and f32; ``overrides`` win last (say
    ``max_seq=`` for a longer decode)."""
    from dtdl_tpu_torch.models.transformer import LMConfig, TransformerLM
    kw = dict(
        vocab_size=cfg.vocab_size, d_model=cfg.d_model,
        n_layers=cfg.n_layers, n_heads=cfg.n_heads, d_ff=cfg.d_ff,
        max_seq=cfg.max_seq, n_experts=cfg.n_experts, moe_every=1,
        moe_dispatch=cfg.moe_dispatch if cfg.n_experts else "dense",
        capacity_factor=cfg.capacity_factor, moe_top_k=cfg.moe_top_k,
        attn_impl="dense", dtype=torch.float32)
    kw.update(overrides)
    return TransformerLM(LMConfig(**kw), device=device)


def serve_engine(cfg: MegatronConfig, params: dict, mesh: Mesh = None,
                 n_slots: int = 8, buckets=None, page_size: int = 0,
                 n_pages: int = None, quantize_weights: bool = False,
                 kv_dtype=None, kv_pool_bytes: int = None, rules=None,
                 device=None, **overrides):
    """Train on the 4D engine, serve through the port's engine: the
    converted model (:func:`to_flax_model` + :func:`to_flax_params` of the
    GLOBAL tree) in an ``InferenceEngine`` on this process's device.
    With ``mesh`` alone every process serves the whole model (the JAX
    replicated placement); ``mesh`` and ``rules`` (say ``'tp'``) serve
    tensor-parallel through the engine itself (``InferenceEngine(mesh=,
    rules=)``: each process holds its shards and 1/tp of the KV heads).
    ``rules`` without ``mesh`` raises.  The engine options pass through;
    ``overrides`` reach :func:`to_flax_model`."""
    from dtdl_tpu_torch.bridge import load_flax_params
    from dtdl_tpu_torch.serve.engine import InferenceEngine
    if rules is not None and mesh is None:
        # dropping the requested sharding would serve the whole model on
        # one card, far from the misconfiguration
        raise ValueError(f"rules={rules!r} requires mesh=: tensor-parallel "
                         f"serving needs the mesh the shards land on")
    tp = {} if rules is None else {"mesh": mesh, "rules": rules}
    model = to_flax_model(cfg, device=device, **overrides)
    load_flax_params(model, to_flax_params(cfg, params), device=device)
    return InferenceEngine(model, n_slots=n_slots, buckets=buckets,
                           page_size=page_size, n_pages=n_pages,
                           quantize_weights=quantize_weights,
                           kv_dtype=kv_dtype, kv_pool_bytes=kv_pool_bytes,
                           device=device, **tp)
