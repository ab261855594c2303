"""The port's pinned program contracts, on the CPU: each of JAX's five
programs audited (:mod:`dtdl_tpu_torch.analysis.contracts`) and held to
the port's checked-in ``baselines.json``.

The four single-process programs run in the pytest process on the CPU.
``megatron_step`` runs in a gloo world of 8 processes at the ``(1, 1, 2,
4)`` mesh, started once for the module through the port's launcher
(``tests/_torch_world.py``; this file is each rank's ``__main__``, and
the worker imports no JAX): every rank audits its own call.

The port's 1F1B schedule is not one SPMD program: a rank runs its own
stage's code, and the vocab-parallel head runs on the last stage only.
So the ranks of one pipeline stage must issue identical censuses (they
meet in every ``model`` collective), the baseline holds the first
stage's (rank 0), and the last stage's is rank 0's plus the head's
collectives, ``HEAD`` below.

The port-level collective census of ``megatron_step`` is derived from
JAX's: the test traces JAX's ``megatron_step`` at the same geometry on
its 8 CPU devices, counts how often one device executes each collective
equation, and applies the named rules of ``RULES`` (each a difference
of design, each shown to be needed) to reach each stage's calls, which
the port must equal exactly: calls and bytes, no tolerance (ROADMAP
C12).
"""

import json
import pathlib
import sys

from _torch_world import World, serve

AXES = ("data", "seq", "pipe", "model")
MESH = (1, 1, 2, 4)


def run_audit_case(mesh, name, case):
    """One rank: audit ``name`` on the CPU, the census without the
    Finding objects."""
    from dtdl_tpu_torch.analysis import contracts
    rep = contracts.audit_one(name, "cpu")
    rep.pop("_findings")
    return rep


if __name__ == "__main__":
    sys.exit(serve(run_audit_case, AXES))

# ---- the pytest side --------------------------------------------------------

import ast  # noqa: E402
import functools  # noqa: E402
import linecache  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from dtdl_tpu_torch.analysis import contracts  # noqa: E402
from dtdl_tpu_torch.analysis.program_audit import audit_program  # noqa: E402

torch.set_num_threads(1)

SINGLE = ("train_step", "serve_decode", "serve_verify", "serve_lora_decode")
SERVE = ("serve_decode", "serve_verify", "serve_lora_decode")
JAX_BASELINE = (pathlib.Path(__file__).resolve().parent.parent
                / "dtdl_tpu" / "analysis" / "baselines.json")

# what the last stage issues beyond the first, a step: the head, a
# microbatch each (2), its lse's pmax [1, 16], the psums of the exp-sum
# and of the true logit [1, 16], and copy_to's backward of dh [1, 16, 32]
HEAD = {"pmax": (2, 128), "psum": (6, 2 * (64 + 64 + 2048))}
HEAD_C10D = {"allreduce_": (8, 4480)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The 8-rank world, started before the single-process audits so it
    runs while they do."""
    return World(__file__, MESH, {"megatron_step": {}},
                 tmp_path_factory.mktemp("audit_world"), timeout=240)


@pytest.fixture(scope="module")
def reports(world):
    return contracts.audit_programs(SINGLE, device="cpu")


@pytest.fixture(scope="module")
def megatron(world):
    return [out["cases"]["megatron_step"] for out in world.results()]


@pytest.mark.parametrize("name", SINGLE)
def test_census_matches_checked_in_baseline(reports, name):
    drift = contracts.compare_to_baseline({name: reports[name]},
                                          contracts.load_baseline())
    assert not drift, "\n".join(f.render() for f in drift)
    assert reports[name]["findings"] == []


def _plus(book, extra):
    out = {k: dict(v) for k, v in book.items()}
    for prim, (calls, nbytes) in extra.items():
        ent = out.setdefault(prim, {"count": 0, "bytes": 0})
        ent["count"] += calls
        ent["bytes"] += nbytes
    return dict(sorted(out.items()))


def test_megatron_census_matches_baseline_on_every_rank(megatron):
    """The ranks of each pipeline stage issue the same collectives (count
    and bytes); rank 0's census is the baseline's, and the last stage's is
    it plus the head's."""
    fields = contracts.BASELINE_FIELDS
    per_stage = len(megatron) // MESH[2]
    for rank, rep in enumerate(megatron):
        first = megatron[rank - rank % per_stage]
        assert {f: rep[f] for f in fields} == \
            {f: first[f] for f in fields}, rank
        assert rep["findings"] == [], (rank, rep["findings"])
    drift = contracts.compare_to_baseline({"megatron_step": megatron[0]},
                                          contracts.load_baseline())
    assert not drift, "\n".join(f.render() for f in drift)
    last = megatron[-1]
    assert last["collectives"] == _plus(megatron[0]["collectives"], HEAD)
    assert last["c10d_collectives"] == _plus(megatron[0]["c10d_collectives"],
                                             HEAD_C10D)


@pytest.mark.parametrize("name", SERVE)
def test_serve_programs_have_no_collectives_no_syncs_and_keep_pools(
        reports, name):
    rep = reports[name]
    assert rep["collectives"] == {} and rep["c10d_collectives"] == {}
    assert rep["host_syncs"] == 0 and rep["d2h_copies"] == 0
    assert rep["storage_kept"] is True


def test_train_steps_keep_their_state(reports, megatron):
    assert reports["train_step"]["storage_kept"] is True
    assert all(rep["storage_kept"] is True for rep in megatron)
    # one process: DataParallel over a world of one syncs nothing
    assert reports["train_step"]["collectives"] == {}


# what turns JAX's executed collectives (one device, one step) into one
# port rank's calls; every other collective must match one for one
RULES = {
    "size-one": "JAX keeps collectives over mesh axes of size 1 (the seq "
                "ring's ppermutes, the psums over ('data', 'seq')); the "
                "port's axis collectives issue nothing there",
    "bubbles": "JAX's tick scans run every stage's layers on each tick of a "
               "lane, masked in the stage's S - 1 bubble ticks (M + S - 1 "
               "a lane); a port rank runs its stage on its M microbatches",
    "copy-to": "JAX's autodiff psums the cotangent of a sub-block's input "
               "at each model-varying product that reads it (q, k, v: 3; "
               "the MLP's gate and up: 2); the port's copy_to takes the "
               "input once, so its backward issues one psum a sub-block",
    "head": "JAX's head runs on every stage, masked off the last; the "
            "port's runs on the last stage only",
    "stacked-counts": "JAX psums the dropped and total token counts as two "
                      "scalars; the port psums them stacked, in one call",
}
COLLECTIVES = {"psum": "psum", "psum_invariant": "psum", "pmax": "pmax",
               "ppermute": "ppermute"}


@functools.lru_cache(maxsize=None)
def _code_calls(path):
    """The line spans of the collective calls written in ``path``."""
    tree = ast.parse(pathlib.Path(path).read_text())
    return [(n.lineno, n.end_lineno) for n in ast.walk(tree)
            if isinstance(n, ast.Call) and getattr(
                n.func, "attr", getattr(n.func, "id", None))
            in ("psum", "pmax", "ppermute")]


def jax_executions():
    """Every collective equation of JAX's ``megatron_step``, traced here
    at its contract geometry: its primitive, axes, result bytes, the
    times one device executes it (its enclosing scans' lengths
    multiplied; JAX's census counts it once), the function that traced
    it, whether the code calls it there (else autodiff inserted it), and
    the innermost scan body holding it."""
    import jax
    from jax._src import source_info_util

    from dtdl_tpu.analysis.contracts import _BUILDERS
    from dtdl_tpu.analysis.jaxpr_audit import _aval_bytes
    fn, args, _ = _BUILDERS["megatron_step"]()
    core = jax.extend.core
    out = []

    def walk(jaxpr, runs, body):
        for eqn in jaxpr.eqns:
            prim = eqn.primitive.name
            if prim in COLLECTIVES:
                axes = eqn.params.get("axes", eqn.params.get("axis_name"))
                frame = source_info_util.user_frame(
                    eqn.source_info.traceback)
                out.append(dict(
                    prim=COLLECTIVES[prim],
                    axes=axes if isinstance(axes, tuple) else (axes,),
                    bytes=sum(_aval_bytes(v.aval) for v in eqn.outvars),
                    runs=runs, func=frame.function_name, body=body,
                    text=linecache.getline(frame.file_name,
                                           frame.start_line),
                    placed=any(a <= frame.start_line <= b for a, b in
                               _code_calls(frame.file_name))))
            subs = [v for v in eqn.params.values()
                    for v in (v if isinstance(v, (tuple, list)) else (v,))
                    if isinstance(v, (core.ClosedJaxpr, core.Jaxpr))]
            seen = len(out)
            for sub in subs:
                walk(getattr(sub, "jaxpr", sub),
                     runs * eqn.params.get("length", 1),
                     id(eqn) if prim == "scan" else body)
            # a loop or branch would leave a collective's runs unknown
            assert prim not in ("while", "cond") or len(out) == seen, prim

    walk(jax.make_jaxpr(fn)(*args).jaxpr, 1, None)
    return out


def _kind(e):
    f = e["func"]
    if f.startswith(("_attention", "ring_attention")):
        return "block", "attention"
    if f.startswith("_mlp"):
        return "block", "mlp"
    if f.startswith("_head_loss"):
        return "head", None
    if f.endswith(".tick"):
        return "ring", None
    return "tail", None


def derive_port_calls(execs, stage, skip=()):
    """One port rank's collectives in pipeline stage ``stage``, derived
    from JAX's executions by ``RULES`` (less those named in ``skip``):
    {primitive: {"count", "bytes"}}."""
    from fractions import Fraction
    geo = contracts.MEGATRON_GEOMETRY
    m, s = geo["n_microbatches"], geo["n_stages"]
    size = dict(zip(AXES, MESH))
    uses = {}
    for e in execs:
        kind, sub = _kind(e)
        if kind == "block" and not e["placed"]:
            uses[e["body"], sub] = uses.get((e["body"], sub), 0) + 1
    book = {}
    for e in execs:
        kind, sub = _kind(e)
        calls = Fraction(e["runs"])
        if ("size-one" not in skip
                and np.prod([size[a] for a in e["axes"]]) == 1):
            continue
        if kind == "block":
            if "bubbles" not in skip:
                calls *= Fraction(m, m + s - 1)
            if "copy-to" not in skip and not e["placed"]:
                calls /= uses[e["body"], sub]
        elif kind == "head" and "head" not in skip and stage != s - 1:
            continue
        nbytes = calls * e["bytes"]
        if (kind == "tail" and "stacked-counts" not in skip
                and ('carry["drop"]' in e["text"]
                     or 'carry["tot"]' in e["text"])):
            calls /= 2                  # two scalars, one call of both
        ent = book.setdefault(e["prim"], [0, 0])
        ent[0] += calls
        ent[1] += nbytes
    return {p: {"count": c, "bytes": b} for p, (c, b) in sorted(book.items())}


@pytest.fixture(scope="module")
def jax_megatron(world):
    return jax_executions()


def test_megatron_collectives_match_jax_jaxpr_census(megatron, jax_megatron):
    """Each stage's port-level collectives equal those derived from JAX's
    executions of the same program by ``RULES``, and no rule can be left
    out.  JAX's checked-in jaxpr census (psum 31 calls / 43,664 bytes,
    ppermute 16 / 14,336, pmax 1 / 64) counts each equation once; this
    jax traces the same ppermutes and pmax and, for psum, 36 / 57,872:
    it psums a cotangent at each model-varying product (the "copy-to"
    rule), where the jax that wrote the baseline transposed each psum
    into a psum (2 a layer pass, 2 in the head)."""
    want = json.loads(JAX_BASELINE.read_text())["megatron_step"][
        "jaxpr_collectives"]
    assert want == {"psum": {"count": 31, "bytes": 43664},
                    "ppermute": {"count": 16, "bytes": 14336},
                    "pmax": {"count": 1, "bytes": 64}}
    static = {}
    for e in jax_megatron:
        ent = static.setdefault(e["prim"], {"count": 0, "bytes": 0})
        ent["count"] += 1
        ent["bytes"] += e["bytes"]
    assert static["ppermute"] == want["ppermute"]
    assert static["pmax"] == want["pmax"]
    stages = {0: megatron[0]["collectives"],
              MESH[2] - 1: megatron[-1]["collectives"]}
    for stage, got in stages.items():
        assert derive_port_calls(jax_megatron, stage) == got, stage
    for rule in RULES:
        assert any(derive_port_calls(jax_megatron, stage, skip=(rule,))
                   != got for stage, got in stages.items()), rule
    # the port's stages differ by the head alone
    assert stages[MESH[2] - 1] == _plus(stages[0], HEAD)
    # the c10d operations are the port-level calls, one for one: no
    # collective of the port is split or fused on its way to gloo
    for r in (megatron[0], megatron[-1]):
        c = r["collectives"]
        assert r["c10d_collectives"]["allreduce_"] == _plus(
            {}, {"x": (c["psum"]["count"] + c.get("pmax", {}).get("count", 0),
                       c["psum"]["bytes"] + c.get("pmax", {}).get("bytes", 0))
                 })["x"]
        assert r["c10d_collectives"]["send"] == c["ppermute"]
        assert r["c10d_collectives"]["recv_"] == c["ppermute"]


def test_baseline_checked_in():
    """Every program has a baseline, with exactly the compared fields; no
    baseline records a host sync, a copy to the host or a moved state."""
    base = contracts.load_baseline()
    assert set(base) == set(contracts.PROGRAMS)
    for name, fields in base.items():
        assert set(fields) == set(contracts.BASELINE_FIELDS), name
        assert fields["storage_kept"] is True, name
        assert fields["host_syncs"] == 0 and fields["d2h_copies"] == 0


def test_runnable_programs_name_what_a_world_skips():
    run, skipped = contracts.runnable_programs(n_processes=1)
    assert run == list(SINGLE) and skipped == ["megatron_step"]
    run, skipped = contracts.runnable_programs(n_processes=8)
    assert run == ["megatron_step"] and set(skipped) == set(SINGLE)


def test_audit_flags_a_leaking_sync_a_moved_state_and_counts_casts():
    """The census on synthetic steps: a float() of a loss is a host sync,
    a boolean index another; a parameter replaced by the call moves its
    storage; bf16 -> f32 conversions are counted."""
    w = torch.ones(4, dtype=torch.bfloat16)

    def leaky():
        loss = (w.float() * 2).sum()
        return float(loss), w[w > 0]

    rep = audit_program(leaky, name="leaky", kept=lambda: [w], warmup=0)
    assert rep.census["host_syncs"] == 2
    assert rep.census["host_sync_ops"] == {"_local_scalar_dense": 1,
                                           "index": 1}
    assert rep.census["bf16_to_f32_casts"] == 1
    assert [f.rule for f in rep.findings] == ["program-host-sync"]
    holder = {"w": torch.zeros(3)}

    def moves():
        holder["w"] = holder["w"] + 1

    rep = audit_program(moves, name="moves", kept=lambda: [holder["w"]],
                        warmup=0)
    assert [f.rule for f in rep.findings] == ["program-storage-moved"]

    def in_place():
        holder["w"].add_(1)

    rep = audit_program(in_place, name="in_place",
                        kept=lambda: [holder["w"]], warmup=0)
    assert rep.findings == [] and rep.census["storage_kept"] is True


def test_drift_is_named_by_field():
    base = contracts.load_baseline()
    rep = {**base["serve_decode"], "host_syncs": 3}
    drift = contracts.compare_to_baseline({"serve_decode": rep}, base)
    assert [f.rule for f in drift] == ["census-drift"]
    assert drift[0].detail == {"field": "host_syncs", "baseline": 0,
                               "got": 3}
    missing = contracts.compare_to_baseline({"nope": rep}, base)
    assert [f.rule for f in missing] == ["census-drift"]
    assert np.all([f.path for f in missing] == ["nope"])
