"""Tensor-parallel serving in the port (``InferenceEngine(mesh=, rules=)``)
against the JAX engine: the serving face of tests/test_tensor_parallel.py.

A gloo world of 4 processes on a ``{data 2, model 2}`` mesh runs one
engine and one Scheduler per rank over its shards (this file is the
worker as ``__main__``, tests/_torch_world.py the harness) while the
pytest process runs the JAX engine through ``CopyingJaxEngine``
(tests/test_torch_chunked.py, ROADMAP C1) on the same bridged weights
(the JAX serving tests' config: vocab 64, d_model 32, 2 layers, 2 heads,
max_seq 48, f32) and the same numpy-seeded prompts:

* greedy tokens of the ``tp`` engine identical to the JAX single-placement
  engine's on a paged arena (page 8: K4's plain version on the CPU, over
  each rank's ``[n_pages, 1, 8, 16]`` pool) and on the dense arena, and
  with int8 weights (the quant rule map) identical to the JAX int8
  engine's, and with speculative decoding and chunked prefill (K4's
  verify windows) identical to the JAX plain greedy tokens; fp8 weights
  identical to the port's own single-placement fp8 engine; every rank
  returns the same tokens;
* ``serve_arena_shardings`` gives the JAX engine's arena specs, and cut
  to a rank's blocks they are the arena that rank allocates;
* the receipts: ``compile_stats()["tp"]``, the arena's heads split (1/2 of
  the KV bytes a rank), the int8 q kernel and its scale column-sharded;
* a request past its deadline expires on every rank alike (the leader's
  clock decides), and ranks that make different calls fail by name
  before any collective;
* without a world: a heads count the TP axis does not divide raises the
  JAX ``ValueError`` naming ``n_heads``, quantized or not, fp8 weights
  with a raw rules sequence raise ``Fp8UnsupportedError``, and the quant
  rule map equals the JAX one leaf for leaf.

Tolerance: tokens exactly.
"""

import sys

from _torch_world import World, serve

AXES = ("data", "model")
MESH = (2, 2)
CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, d_ff=64,
           max_seq=48)
BUCKETS = (8, 16)
N_NEW = 6


def run_case(mesh, name, case):
    """One serving case on this rank: its requests' tokens and errors,
    the engine's receipts, or (``mismatch``) the error of calls that
    differ between ranks."""
    import numpy as np
    import torch

    from dtdl_tpu_torch.bridge import load_flax_params
    from dtdl_tpu_torch.models.transformer import transformer_lm
    from dtdl_tpu_torch.parallel.tensor import (placement,
                                                serve_arena_shardings)
    from dtdl_tpu_torch.runtime import process_index
    from dtdl_tpu_torch.serve import InferenceEngine, Request, Scheduler

    model = transformer_lm("tiny", device="cpu", seed=None,
                           dtype=torch.float32, attn_impl="dense", **CFG)
    load_flax_params(model, case["params"], device="cpu")
    kw = dict(n_slots=2, buckets=BUCKETS, device="cpu",
              page_size=case["page"], quantize_weights=case["quant"])
    eng = InferenceEngine(model, mesh=mesh, rules="tp", **kw)
    if case.get("mismatch"):
        knobs = (np.zeros(2, np.float32), np.zeros(2, np.int32),
                 np.ones(2, np.float32))
        active = [process_index() == 0, True]
        try:
            eng.decode(eng.init_arena(), eng.init_last_tokens(), active,
                       *knobs)
        except AssertionError as e:
            return {"error": str(e)}
        return {"error": None}

    def run(engine):
        reqs = [Request(list(p), N_NEW, deadline_s=d,
                        speculate=case.get("speculate", 0))
                for p, d in zip(case["prompts"], case["deadlines"])]
        Scheduler(engine, harvest_lag=2, device="cpu",
                  chunk_tokens=case.get("chunk")).run(reqs)
        return reqs

    reqs = run(eng)
    arena = eng.init_arena()
    kv = next(v for v in arena["block_0"]["attn"].values() if v.dim() == 4)
    q = dict(eng.model.block_0.attn.q.named_parameters())
    # the arena's placement: serve_arena_shardings of the whole arena,
    # cut to this rank's blocks, is the arena the engine allocates
    whole = eng.arena_shapes(whole=True)
    specs = serve_arena_shardings(mesh, whole, "tp")
    placed = {}
    for k, (shape, _) in whole["block_0"]["attn"].items():
        spec = placement(specs["block_0"]["attn"][k], shape, mesh)
        placed[k] = tuple(n // mesh.shape[a] if a else n
                          for n, a in zip(shape, spec))
    return {"tokens": [r.tokens for r in reqs],
            "single": ([r.tokens for r in run(InferenceEngine(model, **kw))]
                       if case.get("single") else None),
            "arena_specs": {k: tuple(v) for k, v in
                            specs["block_0"]["attn"].items()},
            "arena_placed": placed == {
                k: tuple(v.shape) for k, v in arena["block_0"]["attn"].items()},
            "errors": [r.error for r in reqs],
            "tp": eng.compile_stats()["tp"],
            "kv_shape": tuple(kv.shape),
            "kv_bytes": sum(v.numel() * v.element_size()
                            for n, blk in arena.items() if n != "index"
                            for v in blk["attn"].values()),
            "q": {n: (str(p.dtype), tuple(p.shape)) for n, p in q.items()}}


if __name__ == "__main__":
    sys.exit(serve(run_case, AXES))

# ---- the pytest side (the JAX oracle) ---------------------------------------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from dtdl_tpu.parallel import tensor as JT  # noqa: E402
from dtdl_tpu.runtime.mesh import build_mesh as jax_mesh  # noqa: E402
from dtdl_tpu.serve import Request as JaxRequest  # noqa: E402
from dtdl_tpu.serve import Scheduler as JaxScheduler  # noqa: E402
from dtdl_tpu_torch.bridge import flatten  # noqa: E402
from dtdl_tpu_torch.models.transformer import transformer_lm  # noqa: E402
from dtdl_tpu_torch.parallel import tensor as T  # noqa: E402
from dtdl_tpu_torch.quant import Fp8UnsupportedError  # noqa: E402
from dtdl_tpu_torch.runtime.mesh import Mesh  # noqa: E402
from dtdl_tpu_torch.serve import InferenceEngine  # noqa: E402
from test_torch_chunked import CopyingJaxEngine, jax_pair  # noqa: E402

PROMPTS = [np.random.default_rng(7).integers(0, 64, n).tolist()
           for n in (3, 9, 5)]
SERVED = {"paged": dict(page=8, quant=False),
          "dense": dict(page=0, quant=False),
          "paged-int8": dict(page=8, quant=True),
          # speculative decoding (verify windows) and chunked prefill
          # (prompt chunks riding verify) over each rank's heads
          "paged-spec-chunked": dict(page=8, quant=False, speculate=2,
                                     chunk=4)}


@pytest.fixture(scope="module")
def models():
    return jax_pair(**CFG)


@pytest.fixture(scope="module")
def world(models, tmp_path_factory):
    params = jax.device_get(models[1])
    cases = {name: dict(kw, params=params, prompts=PROMPTS,
                        deadlines=[None] * len(PROMPTS))
             for name, kw in SERVED.items()}
    # a fourth request already past its deadline
    cases["deadline"] = dict(page=8, quant=False, params=params,
                             prompts=PROMPTS + [PROMPTS[0]],
                             deadlines=[None] * len(PROMPTS) + [0.0])
    cases["mismatch"] = dict(page=8, quant=False, params=params,
                             mismatch=True)
    # fp8 weights through the quant rule map, against the port's own
    # single-placement fp8 engine (fp8 is lossy against f32)
    cases["paged-fp8"] = dict(page=8, quant="w8f", params=params,
                              prompts=PROMPTS, single=True,
                              deadlines=[None] * len(PROMPTS))
    return World(__file__, MESH, cases, tmp_path_factory.mktemp("tpserve"))


def jax_tokens(models, page, quant):
    jm, params, _ = models
    eng = CopyingJaxEngine(jm, params, n_slots=2, buckets=BUCKETS,
                           page_size=page, paged_kernel=False,
                           quantize_weights=quant)
    reqs = [JaxRequest(list(p), N_NEW) for p in PROMPTS]
    JaxScheduler(eng, harvest_lag=2).run(reqs)
    assert all(r.error is None for r in reqs)
    return [r.tokens for r in reqs]


@pytest.mark.parametrize("name", SERVED)
def test_tp_engine_token_identical_to_jax(world, models, name):
    kw = SERVED[name]
    # greedy speculation and chunking are token-identical to plain decode
    want = jax_tokens(models, kw["page"], kw["quant"])
    outs = [o["cases"][name] for o in world.results()]
    for out in outs:
        assert out["errors"] == [None] * len(PROMPTS)
        assert out["tokens"] == want, name
        assert out["tp"] == {"rules": "tp", "mesh": {"data": 2, "model": 2}}
        # one of the 2 heads a rank: half of the KV bytes
        assert out["kv_shape"][1] == 1, out["kv_shape"]
    tm = models[2]
    single = InferenceEngine(tm, n_slots=2, buckets=BUCKETS, device="cpu",
                             page_size=kw["page"],
                             quantize_weights=kw["quant"])
    arena = single.init_arena()
    whole = sum(v.numel() * v.element_size() for n, blk in arena.items()
                if n != "index" for v in blk["attn"].values())
    assert all(2 * out["kv_bytes"] == whole for out in outs)
    q = outs[0]["q"]
    if kw["quant"]:
        assert q == {"kernel": ("torch.int8", (32, 1, 16)),
                     "kernel_scale": ("torch.float32", (1, 1, 16))}
    else:
        assert q == {"kernel": ("torch.float32", (32, 1, 16))}


def test_tp_fp8_engine_token_identical_to_single(world):
    for out in (o["cases"]["paged-fp8"] for o in world.results()):
        assert out["tokens"] == out["single"]
        assert out["q"]["kernel"] == ("torch.float8_e4m3fn", (32, 1, 16))
        assert out["q"]["kernel_scale"] == ("torch.bfloat16", (1, 1, 16))


def test_arena_placement_matches_jax(world, devices):
    """serve_arena_shardings of the whole arena equals the JAX engine's
    placement rule, and cut to this rank's blocks it is the arena the
    engine allocates."""
    shapes = {k: jax.ShapeDtypeStruct(s, jnp.float32) for k, s in {
        "pages_key": (7, 2, 8, 16), "pages_value": (7, 2, 8, 16),
        "index": (2,)}.items()}
    want = JT.serve_arena_shardings(jax_mesh(shape=(4, 2), axes=AXES,
                                             devices=devices), shapes)
    for out in (o["cases"]["paged"] for o in world.results()):
        assert out["arena_placed"]
        for k, spec in out["arena_specs"].items():
            assert spec == tuple(want[k].spec), k


def test_deadline_expires_alike_on_every_rank(world, models):
    outs = [o["cases"]["deadline"] for o in world.results()]
    want = jax_tokens(models, 8, False)
    for out in outs:
        assert out["tokens"][:3] == want
        assert out["errors"][:3] == [None] * 3
        assert out["errors"][3].startswith("expired: deadline")


def test_ranks_that_part_fail_by_name(world):
    for out in (o["cases"]["mismatch"] for o in world.results()):
        assert "tensor-parallel engine call 1 (decode) diverged across " \
            "hosts" in out["error"]


def test_tp_engine_validates_geometry(models):
    """The heads check runs before any placement (no world is needed to
    raise), as in the JAX engine."""
    mesh = Mesh((0, 1), AXES, None, (1, 2))
    tm3 = transformer_lm("tiny", device="cpu", dtype=torch.float32,
                         vocab_size=64, d_model=24, n_layers=1, n_heads=3,
                         d_ff=48, max_seq=32)
    for quant in (False, True):
        with pytest.raises(ValueError, match="n_heads"):
            InferenceEngine(tm3, n_slots=1, device="cpu", mesh=mesh,
                            quantize_weights=quant)
    with pytest.raises(Fp8UnsupportedError, match="named rule preset"):
        InferenceEngine(models[2], n_slots=1, device="cpu", mesh=mesh,
                        quantize_weights="w8f",
                        rules=list(T.RULE_PRESETS["tp"]))


@pytest.mark.parametrize("rules", ["tp", "ep", "tp_fsdp"])
def test_quant_rule_map_matches_jax(devices, rules):
    cfg = dict(CFG, n_experts=4, moe_every=2, moe_dispatch="routed")
    from dtdl_tpu.models.transformer import transformer_lm as jax_lm
    jm = jax_lm("tiny", attn_impl="dense", dtype=jnp.float32, **cfg)
    mesh = jax_mesh(shape=(4, 2), axes=AXES, devices=devices)
    want = flatten(JT.quant_logical_shardings(mesh, jm, rules=rules))
    got = T.quant_logical_shardings(None, transformer_lm(
        "tiny", device="cpu", seed=None, dtype=torch.float32, **cfg),
        rules=rules)
    assert set(got) == set(want)
    for path, sh in want.items():
        n = len(got[path])
        assert tuple(got[path]) == tuple(sh.spec) + (None,) * (
            n - len(sh.spec)), path
    # the column-parallel q kernel's scale rides its heads; the row-parallel
    # out kernel's [1, 1, D] scale is whole
    if rules != "tp_fsdp":
        assert got["block_0/attn/q/kernel_scale"] == (None, "model", None)
        assert got["block_0/attn/out/kernel_scale"] == (None, None, None)
