"""The port's 4D step against the JAX package's on the pipeline schedules
and the MoE edges, on the CPU, at the mesh ``{data 1, seq 2, pipe 2,
model 2}``: a gloo world of 8 processes, as tests/test_torch_megatron.py
(whose oracle and comparison this file uses) runs it.

Cases: interleaved 1F1B (``virtual_stages=2``, two layers a stage) at
M = 2, 3 (a partial last group) and 4; more microbatches (8) than the
schedule's saved-input slots (2S-1 = 3); a starved capacity factor
(0.25) that drops assignments, whose dropped fraction must equal JAX's
exactly; two adamw(1e-3) steps of the routed MoE on two batches (the
rate of the JAX package's own 4D adamw test; adam moves an element by
up to lr·m/(sqrt(v)+eps) whatever its gradient's size, so where a
gradient cancels to below eps, as one of ``blocks/wo`` does here at
~1e-9, f32 rounding alone moves the update by a share of lr: at lr 1e-2
that element differed by 4.8e-4); the unfused path
(``fuse_rope=False``: apply_rope, then the ring).

Tolerances as tests/test_torch_megatron.py: the loss within 1e-5,
parameters within ``PARAM_TOL`` (2e-4), dropped fractions exact.
"""

import sys

from _torch_world import World, run_megatron_case, serve

AXES = ("data", "seq", "pipe", "model")
MESH = (1, 2, 2, 2)
INTERLEAVED = (2, 3, 4)

if __name__ == "__main__":
    sys.exit(serve(run_megatron_case, AXES))

# ---- the pytest side (the JAX oracle) ---------------------------------------

import pytest  # noqa: E402

from dtdl_tpu.parallel import megatron as JM  # noqa: E402
from test_torch_megatron import (cfg_kw, check_case, lm_batch,  # noqa: E402
                                 make_case)


def cases():
    out = {}
    for m in INTERLEAVED:
        kw = cfg_kw(layers_per_stage=2, virtual_stages=2, n_microbatches=m)
        B = 8 if 8 % m == 0 else 2 * m          # global batch % M == 0
        out[f"interleaved-{m}"] = make_case(kw, [lm_batch(B=B, seed=11)],
                                            seed=12)
    out["slots"] = make_case(cfg_kw(n_microbatches=8), [lm_batch(seed=2)],
                             seed=3)
    out["overflow"] = make_case(
        cfg_kw(n_experts=4, capacity_factor=0.25), [lm_batch(seed=7)],
        seed=7, lr=0.05)
    out["adamw"] = make_case(
        cfg_kw(n_experts=4, capacity_factor=1.25),
        [lm_batch(seed=s) for s in (40, 41)], seed=9, opt="adamw", lr=1e-3)
    out["unfused"] = make_case(cfg_kw(fuse_rope=False), [lm_batch(seed=5)],
                               seed=6)
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cs = cases()
    return cs, World(__file__, MESH, cs, tmp_path_factory.mktemp("sched"))


@pytest.mark.parametrize("m", INTERLEAVED)
def test_interleaved_1f1b_matches_jax(world, devices, m):
    cs, w = world
    check_case(w, f"interleaved-{m}", cs[f"interleaved-{m}"],
               JM.build_4d_mesh(devices))


@pytest.mark.parametrize("name", ["slots", "unfused"])
def test_1f1b_slots_and_unfused_rope_match_jax(world, devices, name):
    cs, w = world
    check_case(w, name, cs[name], JM.build_4d_mesh(devices))


def test_capacity_overflow_drops_as_jax(world, devices):
    """Routing is exact in f32, so the dropped fraction equals JAX's."""
    cs, w = world
    check_case(w, "overflow", cs["overflow"], JM.build_4d_mesh(devices))
    frac = w.results()[0]["cases"]["overflow"]["metrics"][0][
        "moe_dropped_frac"]
    assert 0.05 < frac < 1.0, frac


def test_two_adamw_steps_match_jax(world, devices):
    cs, w = world
    check_case(w, "adamw", cs["adamw"], JM.build_4d_mesh(devices))
