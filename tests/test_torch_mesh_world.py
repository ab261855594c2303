"""The port's multi-axis mesh, its differentiable axis collectives and
hierarchical data parallelism, in a gloo world of 4 processes on the CPU.

The world is started once for the module through the port's launcher
(``tests/_torch_world.py``; this file is the worker as ``__main__``) on
the mesh ``{a 2, b 2}``.  Each case computes on every rank; the pytest
process checks the results against numpy (the collectives' definitions:
the ``lax`` operations' forward, and the transposes JAX's autodiff takes
as their backward) and, for the hierarchical DP, against the JAX
``DataParallel`` over ``hybrid_mesh(num_slices=2)`` of 4 of conftest's
virtual CPU devices with ``axis=('dcn', 'data')``, which equals the
single-device step on the global batch.

Tolerances: collectives of exact small integers exactly; the MLP's
parameters after three sgd(0.1, momentum 0.9) steps within rtol 1e-4,
atol 1e-5 (tests/test_torch_ddp.py's tolerance).
"""

import sys

import numpy as np

from _torch_world import World, serve

AXES = ("a", "b")
MESH = (2, 2)
N = 4
STEPS = 3


def value(rank, shape=(2, 4)):
    """A rank's input: small integers, so every sum is exact."""
    return (np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
            + 10 * rank)


def run_case(mesh, name, case):
    import torch

    from dtdl_tpu_torch.parallel import collectives as C
    from dtdl_tpu_torch.runtime import process_index
    me = process_index()
    if name == "mesh":
        return {"coords": mesh.coords(), "line_a": mesh.line("a"),
                "line_b": mesh.line("b"), "line_ab": mesh.line(("a", "b")),
                "index_ab": C.axis_index(mesh, ("a", "b")),
                "size_b": C.axis_size(mesh, "b")}
    if name == "collectives":
        out = {}
        x = torch.tensor(value(me), requires_grad=True)
        g = torch.tensor(value(me + 100))
        for axes in ("a", "b", ("a", "b")):
            key = "".join(axes)
            y = C.psum(x, mesh, axes)
            (dx,) = torch.autograd.grad(y, x, g)
            out[f"psum_{key}"], out[f"psum_{key}_dx"] = y.detach(), dx
            y = C.copy_to(x, mesh, axes)
            (dx,) = torch.autograd.grad(y, x, g)
            out[f"copy_{key}"], out[f"copy_{key}_dx"] = y.detach(), dx
        out["pmax_b"] = C.pmax(x, mesh, "b")
        out["pmin_ab"] = C.pmin(x, mesh, ("a", "b"))
        y = C.ppermute(x, mesh, "b", [(0, 1), (1, 0)])
        (dx,) = torch.autograd.grad(y, x, g)
        out["perm_b"], out["perm_b_dx"] = y.detach(), dx
        y = C.ppermute(x, mesh, "a", [(0, 1)])       # position 0 gets zeros
        (dx,) = torch.autograd.grad(y, x, g)
        out["shift_a"], out["shift_a_dx"] = y.detach(), dx
        y = C.all_to_all(x, mesh, "b", 1, 0)         # [2, 4] -> [4, 2]
        (dx,) = torch.autograd.grad(y, x, torch.tensor(value(me, (4, 2))))
        out["a2a_b"], out["a2a_b_dx"] = y.detach(), dx
        return {k: v.numpy() for k, v in out.items()}
    # hierarchical data parallelism: the MLP on this rank's quarter
    from dtdl_tpu_torch import bridge
    from dtdl_tpu_torch.models import MLP
    from dtdl_tpu_torch.parallel import DataParallel
    from dtdl_tpu_torch.runtime import hybrid_mesh
    from dtdl_tpu_torch.train.optim import sgd
    from dtdl_tpu_torch.train.state import init_state
    from dtdl_tpu_torch.train.step import make_train_step
    hybrid = hybrid_mesh(num_slices=2)
    strategy = DataParallel(hybrid, axis=("dcn", "data"))
    inner = DataParallel(hybrid, axis="data")
    model = MLP(n_units=32, device="cpu", seed=None)
    bridge.load_flax_params(model, case["params"], device="cpu")
    state = strategy.replicate(init_state(model, None,
                                          sgd(0.1, momentum=0.9),
                                          device="cpu"))
    step = make_train_step(strategy)
    i = strategy.replicas.axis_index(("dcn", "data"))
    per = len(case["label"]) // strategy.num_replicas
    batch = {k: v[i * per:(i + 1) * per] for k, v in case.items()
             if k != "params"}
    for _ in range(STEPS):
        state, metrics = step(state, batch)
    return {"shape": hybrid.shape, "replicas": strategy.num_replicas,
            "inner": inner.num_replicas, "inner_line": inner.replicas.ranks,
            "loss": float(metrics["loss"]),
            "params": bridge.flatten(bridge.state_dict_to_flax(model))}


if __name__ == "__main__":
    sys.exit(serve(run_case, AXES))

# ---- the pytest side --------------------------------------------------------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import pytest  # noqa: E402

from dtdl_tpu.models import MLP as JaxMLP  # noqa: E402
from dtdl_tpu.parallel import DataParallel as JaxDataParallel  # noqa: E402
from dtdl_tpu.runtime.mesh import hybrid_mesh as jax_hybrid  # noqa: E402
from dtdl_tpu.train import init_state as jax_init_state  # noqa: E402
from dtdl_tpu.train import make_train_step as jax_train_step  # noqa: E402
from dtdl_tpu_torch import bridge  # noqa: E402


def mlp_case():
    rng = np.random.default_rng(0)
    batch = {"image": rng.normal(size=(16, 784)).astype(np.float32),
             "label": rng.integers(0, 10, 16).astype(np.int32)}
    params = JaxMLP(n_units=32).init(jax.random.PRNGKey(0),
                                     jnp.zeros((1, 784)))["params"]
    return {**batch, "params": jax.tree.map(np.asarray, params)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cases = {"mesh": {}, "collectives": {}, "hybrid": mlp_case()}
    return cases, World(__file__, MESH, cases,
                        tmp_path_factory.mktemp("mesh_world"))


def by_rank(world, name):
    return [o["cases"][name] for o in world[1].results()]


def test_mesh_coords_lines_and_indices(world):
    got = by_rank(world, "mesh")
    for r, g in enumerate(got):
        a, b = divmod(r, 2)                 # row-major over (a, b)
        assert g["coords"] == {"a": a, "b": b}
        assert g["line_a"] == (b, 2 + b)
        assert g["line_b"] == (2 * a, 2 * a + 1)
        assert g["line_ab"] == (0, 1, 2, 3)
        assert g["index_ab"] == r and g["size_b"] == 2


def test_axis_collectives_and_their_transposes(world):
    got = by_rank(world, "collectives")
    lines = {"a": lambda r: (r % 2, 2 + r % 2),
             "b": lambda r: (r - r % 2, r - r % 2 + 1),
             "ab": lambda r: (0, 1, 2, 3)}
    for r, g in enumerate(got):
        for key, line in lines.items():
            total = sum(value(q) for q in line(r))
            gsum = sum(value(q + 100) for q in line(r))
            np.testing.assert_array_equal(g[f"psum_{key}"], total)
            np.testing.assert_array_equal(g[f"psum_{key}_dx"], value(r + 100))
            np.testing.assert_array_equal(g[f"copy_{key}"], value(r))
            np.testing.assert_array_equal(g[f"copy_{key}_dx"], gsum)
        np.testing.assert_array_equal(
            g["pmax_b"], np.maximum(*(value(q) for q in lines["b"](r))))
        np.testing.assert_array_equal(g["pmin_ab"], value(0))
        peer = r ^ 1                        # the other rank along 'b'
        np.testing.assert_array_equal(g["perm_b"], value(peer))
        np.testing.assert_array_equal(g["perm_b_dx"], value(peer + 100))
        a = r // 2                          # (0 -> 1) along 'a'
        np.testing.assert_array_equal(
            g["shift_a"], value(r - 2) if a == 1 else np.zeros((2, 4)))
        np.testing.assert_array_equal(
            g["shift_a_dx"], value(r + 2 + 100) if a == 0
            else np.zeros((2, 4)))
        # tiled all_to_all over 'b': split dim 1 in two, part j to
        # position j, the received parts stacked along dim 0
        j = r % 2
        pair = lines["b"](r)
        np.testing.assert_array_equal(
            g["a2a_b"], np.concatenate([value(q)[:, 2 * j:2 * j + 2]
                                        for q in pair], axis=0))
        np.testing.assert_array_equal(
            g["a2a_b_dx"], np.concatenate([value(q, (4, 2))[2 * j:2 * j + 2]
                                           for q in pair], axis=1))


def test_hierarchical_dp_matches_jax(world, devices):
    case = world[0]["hybrid"]
    got = by_rank(world, "hybrid")
    mesh = jax_hybrid(num_slices=2, devices=devices[:N])
    strategy = JaxDataParallel(mesh, axis=("dcn", "data"))
    state = strategy.replicate(jax_init_state(
        JaxMLP(n_units=32), jax.random.PRNGKey(0), jnp.zeros((1, 784)),
        optax.sgd(0.1, momentum=0.9)))
    state = state.replace(params=jax.tree.map(jnp.asarray, case["params"]))
    step = jax_train_step(strategy)
    batch = strategy.shard_batch({"image": case["image"],
                                  "label": case["label"]})
    for _ in range(STEPS):
        state, metrics = step(state, batch)
    want = bridge.flatten(jax.tree.map(np.asarray,
                                       jax.device_get(state.params)))
    for g in got:
        assert g["shape"] == {"dcn": 2, "data": 2}
        assert g["replicas"] == N and g["inner"] == 2
        np.testing.assert_allclose(g["loss"], float(metrics["loss"]),
                                   rtol=1e-4, atol=1e-5)
        for path, ref in want.items():
            np.testing.assert_allclose(g["params"][path], ref, rtol=1e-4,
                                       atol=1e-5, err_msg=path)
    assert [g["inner_line"] for g in got] == [(0, 1), (0, 1), (2, 3),
                                              (2, 3)]
