"""The port's sequence parallelism against the JAX package's, on the CPU.

Two gloo worlds, of 4 and of 2 processes on one ``seq`` axis, are
started once for the module through the port's launcher
(``tests/_torch_world.py``; this file is the worker as ``__main__``, and
the worker imports no JAX).  Each rank takes its sequence shard of the
same numpy q, k, v (in the layout's order) and of an output cotangent,
runs :func:`ring_attention` or :func:`ulysses_attention`, and
backpropagates; the oracle is the JAX function under ``shard_map`` on a
mesh of as many of conftest's virtual CPU devices, differentiated by
``jax.vjp``.

Cases: the ring, contiguous and zigzag × causal or not × with and
without ``rope=(cos, sin)`` (rotation fused into the ring); Ulysses,
causal or not, with its default attend (the JAX Pallas kernel in
interpret mode against the port's ``flash_attention``, whose CPU path is
the plain version).  ``zigzag_order``/``zigzag_inverse`` equal JAX's.

Tolerances (f32): outputs within atol 1e-5, rtol 1e-5; gradients of q,
k and v within atol 5e-5, rtol 1e-4 (those of tests/test_sequence.py).
"""

import sys

import numpy as np
import torch

from _torch_world import World, assemble, serve

B, H, S, D = 2, 4, 32, 16
RING = [(layout, causal, rope) for layout in ("contiguous", "zigzag")
        for causal in (True, False) for rope in (False, True)]
ULYSSES = [True, False]
WORLDS = (4, 2)
SPEC = (None, None, "seq")            # [B, H, S, D], S split over 'seq'


def case_name(kind, *flags):
    return "-".join([kind] + [str(f) for f in flags])


def run_case(mesh, name, case):
    from dtdl_tpu_torch.parallel import sequence as TS
    n, my = mesh.axis_size("seq"), mesh.axis_index("seq")

    def shard(a):
        return torch.tensor(np.split(a, n, axis=2)[my])

    q, k, v = (shard(case[x]).requires_grad_() for x in "qkv")
    if case["kind"] == "ring":
        rope = ((torch.tensor(case["cos"]), torch.tensor(case["sin"]))
                if case["rope"] else None)
        o = TS.ring_attention(q, k, v, mesh=mesh, axis_name="seq",
                              causal=case["causal"], layout=case["layout"],
                              rope=rope)
    else:
        o = TS.ulysses_attention(q, k, v, mesh=mesh, axis_name="seq",
                                 causal=case["causal"])
    o.backward(shard(case["do"]))
    return {"o": o.detach().numpy(), "dq": q.grad.numpy(),
            "dk": k.grad.numpy(), "dv": v.grad.numpy()}


if __name__ == "__main__":
    sys.exit(serve(run_case, ("seq",)))

# ---- the pytest side (the JAX oracle) ---------------------------------------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

from dtdl_tpu.ops.rope import rope_frequencies  # noqa: E402
from dtdl_tpu.parallel import sequence as JS  # noqa: E402
from dtdl_tpu_torch.parallel import sequence as TS  # noqa: E402


def make_cases(n):
    rng = np.random.default_rng(n)
    cos, sin = (np.asarray(t) for t in rope_frequencies(D, S))
    cases = {}
    for layout, causal, rope in RING:
        order = JS.zigzag_order(n, S) if layout == "zigzag" else np.arange(S)
        q, k, v, do = (rng.normal(size=(B, H, S, D)).astype(np.float32)
                       for _ in range(4))
        cases[case_name("ring", layout, causal, rope)] = dict(
            kind="ring", layout=layout, causal=causal, rope=rope,
            q=q[:, :, order], k=k[:, :, order], v=v[:, :, order], do=do,
            cos=cos, sin=sin)
    for causal in ULYSSES:
        q, k, v, do = (rng.normal(size=(B, H, S, D)).astype(np.float32)
                       for _ in range(4))
        cases[case_name("ulysses", causal)] = dict(
            kind="ulysses", causal=causal, q=q, k=k, v=v, do=do)
    return cases


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = {}
    for n in WORLDS:
        cases = make_cases(n)
        out[n] = (cases, World(__file__, (n,), cases,
                               tmp_path_factory.mktemp(f"seq{n}")))
    return out


def jax_oracle(n, case, devices):
    mesh = Mesh(np.asarray(devices[:n]).reshape(n), ("seq",))
    if case["kind"] == "ring":
        rope = ((jnp.asarray(case["cos"]), jnp.asarray(case["sin"]))
                if case["rope"] else None)

        def fn(q, k, v):
            return JS.ring_attention(q, k, v, axis_name="seq",
                                     causal=case["causal"],
                                     layout=case["layout"], rope=rope)
    else:
        def fn(q, k, v):
            return JS.ulysses_attention(q, k, v, axis_name="seq",
                                        causal=case["causal"])
    sm = jax.shard_map(fn, mesh=mesh, in_specs=(P(None, None, "seq"),) * 3,
                       out_specs=P(None, None, "seq"))

    @jax.jit
    def fwd_bwd(q, k, v, do):
        o, vjp = jax.vjp(sm, q, k, v)
        return (o,) + vjp(do)

    o, dq, dk, dv = fwd_bwd(*(jnp.asarray(case[x])
                              for x in ("q", "k", "v", "do")))
    return {"o": o, "dq": dq, "dk": dk, "dv": dv}


def check(worlds, n, name, devices):
    cases, world = worlds[n]
    case = cases[name]
    want = jax_oracle(n, case, devices)
    outs = world.results()
    for key, tol in (("o", dict(atol=1e-5, rtol=1e-5)),
                     ("dq", dict(atol=5e-5, rtol=1e-4)),
                     ("dk", dict(atol=5e-5, rtol=1e-4)),
                     ("dv", dict(atol=5e-5, rtol=1e-4))):
        got = assemble(outs, lambda o: o["cases"][name][key], SPEC,
                       (B, H, S, D))
        np.testing.assert_allclose(got, np.asarray(want[key]), err_msg=key,
                                   **tol)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("layout,causal,rope", RING)
def test_ring_attention_matches_jax(worlds, devices, n, layout, causal,
                                    rope):
    check(worlds, n, case_name("ring", layout, causal, rope), devices)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("causal", ULYSSES)
def test_ulysses_attention_matches_jax(worlds, devices, n, causal):
    check(worlds, n, case_name("ulysses", causal), devices)


def test_zigzag_order_equals_jax():
    for n, s in [(1, 8), (2, 8), (4, 64), (8, 64), (2, 4096)]:
        np.testing.assert_array_equal(TS.zigzag_order(n, s),
                                      JS.zigzag_order(n, s))
        np.testing.assert_array_equal(TS.zigzag_inverse(n, s),
                                      JS.zigzag_inverse(n, s))
    for mod in (TS, JS):
        with pytest.raises(ValueError, match="divisible"):
            mod.zigzag_order(4, 12)
