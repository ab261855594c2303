"""The pinned program contracts: audit the port's real step programs, the
counterpart of dtdl_tpu/analysis/contracts.py.

JAX's five programs under JAX's names, at JAX's tiny geometries: the
strategy train step (an MLP under ``DataParallel``), the 4D megatron step
on its ``(1, 1, 2, 4)`` mesh, and the serving decode, verify (k = 2) and
multi-LoRA decode calls of a 2-layer engine.  Each is built, called once
to warm up, and called again under the program audit
(:mod:`~dtdl_tpu_torch.analysis.program_audit`); the census is held
against the checked-in ``baselines.json``.  Any drift (a new collective,
a host sync in a step, a state copied instead of updated in place) fails
by name: rule ``census-drift`` or the audit's own finding, in
tests/test_torch_analysis_contracts.py and in ``python -m
dtdl_tpu_torch.analysis --programs``.  Regenerate the baseline with
``--programs --rebase`` after a deliberate change of a program's shape,
and say why in the change.

``megatron_step`` needs a world of 8 processes (one a mesh position);
:func:`runnable_programs` says by name what a smaller world skips, and a
rebase keeps the checked-in entries of the programs it skipped.  Each
rank of the world audits its own call and the baseline holds rank 0's;
the test holds the ranks of each pipeline stage to one census (ranks
that meet in a collective must issue the same ones in the same order)
and the last stage to rank 0's plus the head's.

The JAX baseline's ``donation_ok`` is ``storage_kept`` here; its
``callbacks`` and ``host_transfers`` are ``host_syncs`` and
``d2h_copies``.  The LoRA decode gives nonzero adapter ids: the port's
engine skips the bank's delta when every id is 0, where JAX's program
always gathers.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np

from dtdl_tpu_torch.analysis.findings import Finding

#: the contract surface: JAX's program names
PROGRAMS = ("train_step", "megatron_step", "serve_decode", "serve_verify",
            "serve_lora_decode")

#: the world each pinned geometry runs in (the megatron step is pinned
#: at its (1, 1, 2, 4) mesh, one process a position)
PROCESSES = {"train_step": 1, "megatron_step": 8, "serve_decode": 1,
             "serve_verify": 1, "serve_lora_decode": 1}

#: census fields held against the baseline (the rest of a report, the
#: uploads and the cast sites, is receipt, not contract)
BASELINE_FIELDS = ("collectives", "c10d_collectives", "host_syncs",
                   "d2h_copies", "bf16_to_f32_casts", "storage_kept")

#: the MegatronConfig of JAX's contract (dtype set at build time)
MEGATRON_GEOMETRY = dict(vocab_size=64, d_model=32, n_heads=4, d_ff=64,
                         n_stages=2, layers_per_stage=1, n_microbatches=2,
                         max_seq=32)
MEGATRON_MESH = (1, 1, 2, 4)


def runnable_programs(names=PROGRAMS, n_processes: int | None = None
                      ) -> tuple[list, list]:
    """Split ``names`` into (runnable, skipped) for a world of
    ``n_processes`` (this process's world by default)."""
    if n_processes is None:
        from dtdl_tpu_torch.runtime import process_count
        n_processes = process_count()
    run = [p for p in names if PROCESSES[p] == n_processes]
    return run, [p for p in names if p not in run]


def baseline_path() -> pathlib.Path:
    return pathlib.Path(__file__).with_name("baselines.json")


def load_baseline() -> dict:
    p = baseline_path()
    return json.loads(p.read_text()) if p.exists() else {}


# ---------------------------------------------------------------------------
# program builders: (call, kept) at the tiny fixed geometry; ``call()``
# runs one step on the state the builder holds, ``kept()`` names the
# tensors whose storages the step must keep
# ---------------------------------------------------------------------------

def _build_train_step(device):
    """The strategy train step (make_train_step under DataParallel over
    this process's world), JAX's MLP(16, 8) on 12 features, sgd(0.1)."""
    import torch

    from dtdl_tpu_torch.models.mlp import MLP
    from dtdl_tpu_torch.parallel.strategy import DataParallel
    from dtdl_tpu_torch.runtime import build_mesh
    from dtdl_tpu_torch.train.optim import sgd
    from dtdl_tpu_torch.train.state import init_state
    from dtdl_tpu_torch.train.step import make_train_step

    model = MLP(n_units=16, n_out=8, in_features=12, device=device, seed=0)
    holder = {"state": init_state(model, None, sgd(0.1), device=device)}
    strategy = DataParallel(build_mesh())
    holder["state"] = strategy.replicate(holder["state"])
    step = make_train_step(strategy)
    batch = {"image": torch.zeros((2, 12), device=device),
             "label": torch.zeros((2,), dtype=torch.int32, device=device)}

    def call():
        holder["state"], _ = step(holder["state"], batch)

    return call, lambda: _state_tensors(holder["state"])


def _state_tensors(state) -> list:
    """A train state's parameters and its optimizer's moments."""
    import torch
    out = list(state.model.parameters())
    for st in state.optimizer.state.values():
        out.extend(v for v in st.values() if isinstance(v, torch.Tensor)
                   and v.dim() > 0)
    return out


def _build_megatron_step(device):
    """The 4D megatron step on the (1, 1, pipe=2, model=4) mesh: the
    manual-SPMD face, whose collectives are placed by hand."""
    import torch

    from dtdl_tpu_torch.parallel import megatron as M
    from dtdl_tpu_torch.runtime import build_mesh
    from dtdl_tpu_torch.train.optim import sgd

    cfg = M.MegatronConfig(**MEGATRON_GEOMETRY, dtype=torch.float32)
    mesh = build_mesh(MEGATRON_MESH, M.AXES)
    tx = sgd(0.1)
    params = M.place_params(mesh, cfg, M.init_params(cfg, 0), device=device)
    holder = {"params": params, "opt": M.init_optimizer(cfg, mesh, tx,
                                                        params)}
    step = M.make_megatron_train_step(cfg, mesh, tx)
    batch = M.shard_lm_batch(mesh, {
        "tokens": np.zeros((2, 16), np.int32),
        "targets": np.zeros((2, 16), np.int32),
        "mask": np.ones((2, 16), np.float32)}, device=device)

    def call():
        holder["params"], holder["opt"], _, _ = step(
            holder["params"], holder["opt"], batch["tokens"],
            batch["targets"], batch["mask"])

    def kept():
        out = [a for _, a in M._leaves(holder["params"])]
        for st in holder["opt"].state.values():
            out.extend(v for v in st.values() if isinstance(v, torch.Tensor)
                       and v.dim() > 0)
        return out

    return call, kept


def _tiny_model(device):
    from dtdl_tpu_torch.models.transformer import transformer_lm
    import torch
    return transformer_lm("tiny", vocab_size=64, d_model=32, n_layers=2,
                          n_heads=2, d_ff=64, max_seq=32, attn_impl="dense",
                          dtype=torch.float32, device=device, seed=0)


def _engine_call(eng, method, **kw):
    """``call`` and ``kept`` of one engine method over every slot, each
    slot on its own pages."""
    holder = {"arena": eng.init_arena(), "last": eng.init_last_tokens()}
    b = eng.n_slots
    tables = (1 + np.arange(b * eng.n_ptab, dtype=np.int32)
              .reshape(b, eng.n_ptab)) % eng.n_pages
    knobs = dict(active=np.ones(b, bool), temp=np.zeros(b, np.float32),
                 top_k=np.zeros(b, np.int32), top_p=np.ones(b, np.float32),
                 page_tables=tables)

    def call():
        out = getattr(eng, method)(holder["arena"], holder["last"],
                                   **kw, **knobs)
        holder["arena"], holder["last"] = out[0], out[1]

    return call, lambda: [t for _, t in eng._pool_leaves(holder["arena"])]


def _build_serve_decode(device):
    """The decode call every serving token rides."""
    from dtdl_tpu_torch.serve.engine import InferenceEngine
    eng = InferenceEngine(_tiny_model(device), n_slots=2, buckets=(8,),
                          device=device)
    return _engine_call(eng, "decode")


def _build_serve_verify(device):
    """The k-wide verify call (speculative decoding and chunked prefill
    share it) at k = 2."""
    from dtdl_tpu_torch.serve.engine import InferenceEngine
    eng = InferenceEngine(_tiny_model(device), n_slots=2, buckets=(8,),
                          device=device)
    b, k = eng.n_slots, 2
    return _engine_call(eng, "verify",
                        draft_tokens=np.zeros((b, k), np.int32),
                        draft_len=np.ones(b, np.int32))


def _build_serve_lora_decode(device):
    """The decode call of a multi-LoRA engine: the bank's gather must add
    no collectives and no host syncs (the ids are data, uploaded)."""
    from dtdl_tpu_torch.serve.engine import InferenceEngine
    eng = InferenceEngine(_tiny_model(device), n_slots=2, buckets=(8,),
                          device=device, lora_rank=2, lora_adapters=2)
    return _engine_call(eng, "decode",
                        adapter_ids=np.ones(eng.n_slots, np.int64))


_BUILDERS = {"train_step": _build_train_step,
             "megatron_step": _build_megatron_step,
             "serve_decode": _build_serve_decode,
             "serve_verify": _build_serve_verify,
             "serve_lora_decode": _build_serve_lora_decode}


# ---------------------------------------------------------------------------
# auditing and the baseline
# ---------------------------------------------------------------------------

def audit_one(name: str, device=None) -> dict:
    """Build and audit one pinned program on ``device`` (None: the card);
    returns its JSON-able report (``findings`` rendered, census flat)."""
    from dtdl_tpu_torch.analysis.program_audit import audit_program
    from dtdl_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    call, kept = _BUILDERS[name](dev)
    audit = audit_program(call, name=name, kept=kept, warmup=1)
    return {**audit.census,
            "findings": [f.render() for f in audit.findings],
            "_findings": audit.findings}


def audit_programs(names=PROGRAMS, device=None) -> dict:
    return {n: audit_one(n, device) for n in names}


def compare_to_baseline(reports: dict, baseline: dict) -> list[Finding]:
    """Named drift findings: every BASELINE_FIELDS mismatch between a
    report and the checked-in baseline, and missing baselines."""
    out = []
    for name, rep in reports.items():
        base = baseline.get(name)
        if base is None:
            out.append(Finding(
                "census-drift", name, 0,
                "no checked-in baseline: run python -m "
                "dtdl_tpu_torch.analysis --programs --rebase and commit "
                "baselines.json"))
            continue
        for field in BASELINE_FIELDS:
            got, want = rep.get(field), base.get(field)
            if got != want:
                out.append(Finding(
                    "census-drift", name, 0,
                    f"{field} drifted from baseline: {want!r} -> {got!r} "
                    f"(deliberate? --programs --rebase)",
                    detail={"field": field, "baseline": want, "got": got}))
    return out


def save_baseline(reports: dict) -> pathlib.Path:
    """Write the comparable census of ``reports`` as the new baseline,
    keeping the checked-in entries of programs not in ``reports``."""
    slim = load_baseline()
    slim.update({name: {f: rep[f] for f in BASELINE_FIELDS}
                 for name, rep in reports.items()})
    p = baseline_path()
    p.write_text(json.dumps(dict(sorted(slim.items())), indent=2,
                            sort_keys=True) + "\n")
    return p
