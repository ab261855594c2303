"""The port's mixture-of-experts module against the JAX package's ``MoE``.

One flax ``MoE`` (d_model 16, d_ff 24, 4 experts, f32) is initialised
from a seed, its params copied into the port's :class:`MoE`, and the same
numpy inputs go through both: the output, the Switch load-balance value
and the gradients of x, router, wi, wg and wo (``jax.grad`` of
``sum(y · cotangent) + 0.1 · aux``).

Tolerances: every tensor within atol 1e-5 of its largest JAX value
(different matmul summation orders in f32); routing decisions are
exact, so a misrouted or dropped token would show as an error of the
size of the output itself.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtdl_tpu.models import transformer as jtr
from dtdl_tpu_torch.models.transformer import MoE

torch.set_num_threads(1)

D, FF, E = 16, 24, 4
B, S = 2, 13
REL = 1e-5
AUX_W = 0.1


def _close(got, want, name):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= REL * scale, (name, err, scale)


def _pair(seed=0, router=None, **kw):
    """The JAX module with its params and the port's with the same."""
    jm = jtr.MoE(E, FF, jnp.float32, **kw)
    x0 = jnp.zeros((B, S, D), jnp.float32)
    params = jax.device_get(fnn.unbox(
        jm.init(jax.random.PRNGKey(seed), x0)["params"]))
    if router is not None:
        params["router"]["kernel"] = router
    tm = MoE(D, FF, E, dtype=torch.float32, param_dtype=torch.float32,
             device="cpu", **kw)
    with torch.no_grad():
        tm.router.kernel.copy_(torch.tensor(np.array(
            params["router"]["kernel"])))
        for name in MoE.EXPERT_WEIGHTS:
            getattr(tm, name).copy_(torch.tensor(np.array(params[name])))
    return jm, params, tm


def _x(seed=1, shape=(B, S, D)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _jax_run(jm, params, x, ct):
    def loss(p, xx):
        y, muts = jm.apply({"params": p}, xx, mutable=["aux_loss"])
        aux = jax.tree.leaves(muts)[0]
        return jnp.sum(y * ct) + AUX_W * aux, (y, aux)
    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    return np.asarray(y), float(aux), gp, np.asarray(gx)


def _torch_run(tm, x, ct):
    xt = torch.tensor(x, requires_grad=True)
    y, aux = tm(xt, want_aux=True)
    (torch.sum(y * torch.tensor(ct)) + AUX_W * aux).backward()
    return y.detach().numpy(), float(aux), xt.grad.numpy()


# every (capacity factor, group) pair once, each of them with top-1 and
# with top-2
ROUTED = [(1, 0.5, 0), (1, 1.25, 8), (1, 4.0, 5),
          (2, 0.5, 5), (2, 1.25, 0), (2, 4.0, 8)]


@pytest.mark.parametrize("dispatch,top_k,cf,group",
                         [("dense", 1, 1.25, 0)]
                         + [("routed", *c) for c in ROUTED])
def test_moe_output_aux_and_grads_match_jax(dispatch, top_k, cf, group):
    """Dense dispatch and routed top-1/top-2 at capacity factors that drop
    (0.5, 1.25) and that do not (4.0), over one group per row (0), groups
    of 8 (13 = 8 + a ragged 5) and of 5 (13 = 5 + 5 + a ragged 3): each
    capacity factor with each group size, top-1 and top-2 each meeting
    every capacity factor and every group size."""
    jm, params, tm = _pair(dispatch=dispatch, capacity_factor=cf,
                           top_k=top_k, group_size=group)
    x = _x()
    ct = _x(2)
    y, aux, gp, gx = _jax_run(jm, params, x, ct)
    ty, taux, tgx = _torch_run(tm, x, ct)
    _close(ty, y, "y")
    assert abs(taux - aux) <= REL * abs(aux)
    _close(tgx, gx, "dx")
    _close(tm.router.kernel.grad.numpy(), gp["router"]["kernel"], "router")
    for name in MoE.EXPERT_WEIGHTS:
        _close(getattr(tm, name).grad.numpy(), gp[name], name)


def test_capacity_drops_tokens_as_jax_does():
    """At capacity factor 0.5 some tokens are dropped (their output is 0)
    in both packages, the same tokens."""
    jm, params, tm = _pair(dispatch="routed", capacity_factor=0.5)
    x = _x()
    y = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        ty = tm(torch.tensor(x))[0].numpy()
    dropped = np.all(y == 0, axis=-1)
    assert dropped.any() and not dropped.all()
    np.testing.assert_array_equal(np.all(ty == 0, axis=-1), dropped)


@pytest.mark.parametrize("top_k", [1, 2])
def test_routed_without_drops_equals_dense(top_k):
    """With capacity_factor >= E / top_k nothing can drop, so routed top-1
    computes dense top-1's function (the oracle contract of the JAX
    tests): outputs within atol 1e-5 of the largest; top-2 without drops
    as JAX's."""
    x = _x(3)
    _, _, routed = _pair(dispatch="routed", capacity_factor=E / top_k,
                         top_k=top_k)
    with torch.no_grad():
        got = routed(torch.tensor(x))[0].numpy()
    if top_k == 1:
        _, _, dense = _pair(dispatch="dense")
        with torch.no_grad():
            want = dense(torch.tensor(x))[0].numpy()
    else:
        jm, params, _ = _pair(dispatch="routed", capacity_factor=E / top_k,
                              top_k=top_k)
        want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    _close(got, want, "y")


@pytest.mark.parametrize("top_k", [1, 2])
def test_tie_order_is_lower_index_first(top_k):
    """Equal router probs: experts 1 and 3 get the same router column and
    0 and 2 another, so every token's top two are a tie.  lax.top_k and
    argmax take the lower index first; the port must too (torch.topk
    promises no order).  Capacity 0.5 makes the order decide which tokens
    drop, so a wrong order shows in the output."""
    w = np.random.default_rng(4).normal(size=(D, 2)).astype(np.float32)
    router = np.stack([w[:, 0], w[:, 1], w[:, 0], w[:, 1]], axis=1)
    jm, params, tm = _pair(router=router, dispatch="routed",
                           capacity_factor=0.5, top_k=top_k)
    x = _x(5)
    ct = _x(6)
    y, aux, gp, gx = _jax_run(jm, params, x, ct)
    ty, taux, tgx = _torch_run(tm, x, ct)
    _close(ty, y, "y")
    _close(tgx, gx, "dx")
    _close(tm.router.kernel.grad.numpy(), gp["router"]["kernel"], "router")
    # all-equal logits: every token's first choice is expert 0
    _, _, flat = _pair(router=np.zeros((D, E), np.float32),
                       dispatch="routed", capacity_factor=E, top_k=top_k)
    with torch.no_grad():
        probs = torch.softmax(flat.router(torch.tensor(x)), -1)
    assert bool((probs.argmax(-1) == 0).all())


@pytest.mark.parametrize("kw,match", [
    (dict(top_k=0, dispatch="routed"), "must be in"),
    (dict(top_k=E + 1, dispatch="routed"), "must be in"),
    (dict(top_k=2, dispatch="dense"), "dense dispatch is top-1 only"),
    (dict(dispatch="sparse"), "unknown MoE dispatch"),
])
def test_moe_refusals_match_jax(kw, match):
    """The JAX module's ValueErrors, with the same messages (the port
    raises at construction, JAX at its first call)."""
    x0 = jnp.zeros((1, 2, D), jnp.float32)
    with pytest.raises(ValueError, match=match) as jerr:
        jtr.MoE(E, FF, jnp.float32, **kw).init(jax.random.PRNGKey(0), x0)
    with pytest.raises(ValueError, match=match) as terr:
        MoE(D, FF, E, dtype=torch.float32, param_dtype=torch.float32,
            device="cpu", **kw)
    assert str(terr.value) == str(jerr.value)


def test_aux_only_when_asked_and_on_unpadded_tokens():
    """No aux unless asked; with a ragged group the aux is taken over the
    unpadded tokens (JAX's value)."""
    jm, params, tm = _pair(dispatch="routed", group_size=8)
    x = _x(7)
    with torch.no_grad():
        assert tm(torch.tensor(x))[1] is None
        aux = float(tm(torch.tensor(x), want_aux=True)[1])
    _, muts = jm.apply({"params": params}, jnp.asarray(x),
                       mutable=["aux_loss"])
    assert abs(aux - float(jax.tree.leaves(muts)[0])) <= REL * aux
