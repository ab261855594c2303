"""A tensor-parallel engine's control plane runs over its own processes.

A gloo world of 4 processes (this file is the worker as ``__main__``,
tests/_torch_world.py the harness) holds two TP engines at once: one on
the processes {0, 1} and one on {2, 3}, each on its own ``sub_mesh``
over ``model``.  Each pair runs a ``Scheduler`` over its own prompts at
the same time as the other, and the second pair's traffic carries a
request whose deadline has passed, so its first step takes the leader's
clock decision (``engine.agree``) while the first pair's prefills check
their lockstep digests.  Both run over the engine's control group
(``mesh.host_group``), never over the world.  The pytest process runs the
JAX single ``Scheduler`` through ``CopyingJaxEngine``
(tests/test_torch_chunked.py, ROADMAP C1) on the same bridged weights: the
JAX serving tests' config (vocab 64, d_model 32, 2 layers, 2 heads,
max_seq 48, f32), page 8, 2 slots.

Also: a Router on process 1 given that pair's engine and one on the
processes {1, 2} refuses the second by name (ROADMAP A12c): its control
group does not hold the Router's process 0.

Tolerance: tokens exact.
"""

from _torch_world import World, leave, serve

AXES = ("data", "model")
MESH = (4, 1)
CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, d_ff=64,
           max_seq=48)
BUCKETS = (8, 16, 32, 48)
PAGE = 8
N_NEW = 6


def run_case(mesh, name, case):
    import torch

    from dtdl_tpu_torch.bridge import load_flax_params
    from dtdl_tpu_torch.models.transformer import transformer_lm
    from dtdl_tpu_torch.runtime import process_index
    from dtdl_tpu_torch.runtime.mesh import MODEL_AXIS, sub_mesh
    from dtdl_tpu_torch.serve import (InferenceEngine, Request, Router,
                                      Scheduler)

    me = process_index()
    model = transformer_lm("tiny", device="cpu", seed=None,
                           dtype=torch.float32, attn_impl="dense", **CFG)
    load_flax_params(model, case["params"], device="cpu")
    kw = dict(n_slots=2, buckets=BUCKETS, page_size=PAGE, device="cpu",
              rules="tp")
    # dist.new_group is collective over the world: every process makes
    # every sub-mesh, in one order, and keeps its own
    pairs = [sub_mesh((0, 1), MODEL_AXIS), sub_mesh((2, 3), MODEL_AXIS)]
    across = sub_mesh((1, 2), MODEL_AXIS)
    pair = me // 2
    eng = InferenceEngine(model, mesh=pairs[pair], **kw)
    if name == "refusal":
        out = {"refused": None}
        if me == 1:
            try:
                Router([eng, InferenceEngine(model, mesh=across, **kw)],
                       device="cpu")
            except NotImplementedError as e:
                out["refused"] = str(e)
        return out
    reqs = [Request(list(p), N_NEW) for p in case["prompts"][pair]]
    if pair == 1:
        reqs.insert(1, Request([1, 2, 3], N_NEW, deadline_s=0.0))
    sched = Scheduler(eng, harvest_lag=1, device="cpu")
    sched.run(reqs)
    return {"tokens": [r.tokens for r in reqs],
            "errors": [r.error for r in reqs], "calls": eng._calls,
            "expired": sched.metrics.summary()["requests_expired"],
            "control_ranks": eng.control_ranks}


if __name__ == "__main__":
    leave(serve(run_case, AXES))

# ---- the pytest side (the JAX oracle) ---------------------------------------

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from dtdl_tpu.serve import Request as JaxRequest  # noqa: E402
from dtdl_tpu.serve import Scheduler as JaxScheduler  # noqa: E402
from test_torch_chunked import CopyingJaxEngine, jax_pair  # noqa: E402

torch.set_num_threads(1)


def _prompts(seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 64, int(rng.integers(3, 12))).tolist()
            for _ in range(4)]


PROMPTS = [_prompts(2), _prompts(3)]


@pytest.fixture(scope="module")
def models():
    return jax_pair(**CFG)


@pytest.fixture(scope="module")
def world(models, tmp_path_factory):
    """Both cases in one world of 4, within its own time limit: on a tree
    whose engines agree over the whole world the pairs' control calls
    meet each other's and the world fails instead of hanging."""
    params = jax.device_get(models[1])
    cases = {"scope": dict(params=params, prompts=PROMPTS),
             "refusal": dict(params=params)}
    return World(__file__, MESH, cases, tmp_path_factory.mktemp("scope"),
                 timeout=120)


@pytest.fixture(scope="module")
def want(models):
    jm, params, _ = models
    jeng = CopyingJaxEngine(jm, params, n_slots=2, buckets=BUCKETS,
                            page_size=PAGE, paged_kernel=False)
    out = []
    for prompts in PROMPTS:
        jreqs = [JaxRequest(list(p), N_NEW) for p in prompts]
        JaxScheduler(jeng, harvest_lag=1).run(jreqs)
        out.append([r.tokens for r in jreqs])
    return out


def _cases(world, name):
    return [o["cases"][name] for o in world.results()]


@pytest.mark.parametrize("pair", [0, 1])
def test_two_tp_engines_on_disjoint_processes_equal_jax(world, want, pair):
    """Each pair's engine serves its own prompts at the same time as the
    other pair's: JAX's greedy tokens on both of its ranks."""
    outs = _cases(world, "scope")[2 * pair:2 * pair + 2]
    for out in outs:
        tokens = [t for t, e in zip(out["tokens"], out["errors"])
                  if e is None]
        assert tokens == want[pair]
    assert outs[0]["tokens"] == outs[1]["tokens"]
    assert outs[0]["calls"] == outs[1]["calls"]


def test_deadline_is_agreed_within_its_own_pair(world):
    """The expired request of the second pair is retired on both of its
    ranks by its leader's (process 2's) clock decision; the first pair
    makes no such decision."""
    outs = _cases(world, "scope")
    for out in outs[2:]:
        assert out["errors"][1].startswith("expired:")
        assert "before admission" in out["errors"][1]
        assert out["expired"] == 1
    assert [o["expired"] for o in outs[:2]] == [0, 0]
    assert all(e is None for o in outs[:2] for e in o["errors"])


def test_each_engine_has_its_own_control_group(world):
    outs = _cases(world, "scope")
    assert [o["control_ranks"] for o in outs] == [(0, 1), (0, 1), (2, 3),
                                                  (2, 3)]


def test_router_refuses_a_replica_without_its_process(world):
    """On process 1: replica 0 is led by process 0, and replica 1's
    control group {1, 2} does not hold it: refused by name."""
    outs = _cases(world, "refusal")
    msg = outs[1]["refused"]
    assert msg is not None and "A12c" in msg
    assert "replica 1's engine runs on the processes [1, 2]" in msg
    assert "the Router's process 0" in msg
    assert [o["refused"] for o in outs[:1] + outs[2:]] == [None] * 3
