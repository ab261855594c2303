"""The port's lint gate, on the CPU: dtdl_tpu_torch/ (and the card's
scripts) must lint clean, and the port's rules must agree with the JAX
package's where both have them.

AST only, no program runs: the port's isolation from JAX, its host-sync
discipline on hot paths and its catalog consistency fail here by rule
id.  The parity cases hand the same synthetic sources (at each package's
paths) to the JAX functions and to the port's: the findings must be
identical, the paths mapped.  There is no tolerance: findings are
compared exactly.
"""

import json
import pathlib
import textwrap

import pytest

from dtdl_tpu.analysis import findings as jfindings
from dtdl_tpu.analysis import lint as jlint
from dtdl_tpu.analysis.rules import ParsedModule as JParsed
from dtdl_tpu.analysis.rules import catalogs as jcatalogs
from dtdl_tpu_torch.analysis import findings as tfindings
from dtdl_tpu_torch.analysis import lint_paths, render_report, rule_docs
from dtdl_tpu_torch.analysis.__main__ import main as cli
from dtdl_tpu_torch.analysis.rules import ParsedModule as TParsed
from dtdl_tpu_torch.analysis.rules import catalogs as tcatalogs

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "dtdl_tpu_torch"
SCRIPTS = [REPO / "chip_smoke.py", REPO / "chip_obs_diag.py"]


def lint_tree(tmp_path, files: dict, **kw):
    """Write ``files`` ({repo path: source}) under ``tmp_path`` and lint
    them with ``tmp_path`` as the repository root."""
    for rel, src in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return lint_paths([str(tmp_path / r) for r in files], root=str(tmp_path),
                      **kw)


def test_port_lints_clean():
    """Zero unsuppressed findings over the port and its card scripts:
    the check ``python -m dtdl_tpu_torch.analysis`` gates on."""
    found = lint_paths([str(PORT)] + [str(p) for p in SCRIPTS],
                       root=str(REPO))
    assert not found, "\n" + render_report(found, header="lint gate:")


def test_every_suppression_carries_a_reason():
    """Each ``# audit: ok[rule] reason`` has its reason, and their number
    is pinned so that suppressions do not pile up unreviewed."""
    sups = []
    for f in sorted(PORT.rglob("*.py")) + SCRIPTS:
        if "__pycache__" in f.parts or "analysis" in f.parts:
            continue
        rel = f.relative_to(REPO).as_posix()
        sups.extend(tfindings.scan_suppressions(rel, f.read_text()))
    assert sups, "expected the documented deliberate host reads"
    for s in sups:
        assert s.reason, f"{s.path}:{s.line}: suppression without reason"
        assert s.rule.startswith("host-sync"), (s.path, s.line, s.rule)
    assert len(sups) <= 20, (
        f"{len(sups)} suppressions: review the new ones and raise this "
        f"bound deliberately")


def test_rule_catalog_is_stable_and_names_every_jax_counterpart():
    """Every id is kebab-case with a one-line doc; every JAX rule id is in
    the port's catalog, and one the port does not implement names the
    port's rule that stands in for it."""
    docs = rule_docs()
    for rid, doc in docs.items():
        assert rid == rid.lower() and " " not in rid, rid
        assert doc.strip() and "\n" not in doc
    jax_ids = set(jlint.rule_docs())
    assert jax_ids <= set(docs), sorted(jax_ids - set(docs))
    port_rules = {r for r, d in docs.items() if not d.startswith("JAX rule")}
    for rid in jax_ids:
        if docs[rid].startswith("JAX rule"):
            counterpart = docs[rid].split("in the port:", 1)[1]
            assert "none" in counterpart or any(
                r in counterpart for r in port_rules), (rid, docs[rid])
    for family in ("host-sync-item", "host-sync-cpu", "host-sync-tolist",
                   "host-sync-numpy", "host-sync-synchronize",
                   "port-imports-jax", "kernel-fallback",
                   "program-host-sync", "program-storage-moved",
                   "program-cuda-sync", "census-drift"):
        assert family in docs and family in port_rules, family


def test_cli_exit_codes(tmp_path, capsys):
    """0 on the port's tree and on --list-rules; 1 on a tree with an
    unsuppressed finding, which --json names; 0 again once the line is
    suppressed with a reason."""
    assert cli([]) == 0
    assert "audit clean" in capsys.readouterr().out
    assert cli(["--list-rules"]) == 0
    assert "port-imports-jax" in capsys.readouterr().out
    bad = tmp_path / "dtdl_tpu_torch" / "serve" / "leaky.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("def step(x):\n    return x.sum().item()\n")
    assert cli([str(tmp_path / "dtdl_tpu_torch")]) == 1
    assert "[host-sync-item]" in capsys.readouterr().out
    assert cli([str(bad), "--json"]) == 1
    got = json.loads(capsys.readouterr().out)
    assert [f["rule"] for f in got["findings"]] == ["host-sync-item"]
    bad.write_text("def step(x):\n    # audit: ok[host-sync-item] a test\n"
                   "    return x.sum().item()\n")
    assert cli([str(bad)]) == 0
    bad.write_text("def step(x):\n    # audit: ok[host-sync-item]\n"
                   "    return x.sum().item()\n")
    assert cli([str(bad)]) == 1
    assert "suppress-no-reason" in capsys.readouterr().out


# ---- parity with the JAX package's machinery --------------------------------

SUPPRESSION_SOURCES = [
    "x = 1  # audit: ok[host-sync-item] fine\ny = x.item()\n",
    "# audit: ok[host-sync] group form\nz = a.cpu().numpy()\n",
    "# audit: ok[host-sync-item]\nq = t.item()\n",
    "# audit: ok[no-such-rule] why\nw = 2\n",
    "s = '''# audit: ok[host-sync-item] in a string'''\n",
    "# audit: ok[host-sync-item] stale: nothing below\n\n\nv = 3\n",
]


def _findings_for(mod, src):
    """Synthetic findings: one host-sync-item on every line with
    ``.item()``, one host-sync-cpu on every line with ``.cpu()``."""
    out = []
    for i, line in enumerate(src.splitlines(), 1):
        if ".item()" in line and "'''" not in line:
            out.append(mod.Finding("host-sync-item", "m.py", i, "item"))
        if ".cpu()" in line:
            out.append(mod.Finding("host-sync-cpu", "m.py", i, "cpu"))
    return out


@pytest.mark.parametrize("src", SUPPRESSION_SOURCES)
def test_suppression_machinery_matches_jax(src):
    known = {"host-sync-item", "host-sync-cpu"}
    jsups = jfindings.scan_suppressions("m.py", src)
    tsups = tfindings.scan_suppressions("m.py", src)
    assert [vars(s) for s in tsups] == [vars(s) for s in jsups]
    jout = jfindings.apply_suppressions(_findings_for(jfindings, src), jsups,
                                        known_rules=known)
    tout = tfindings.apply_suppressions(_findings_for(tfindings, src), tsups,
                                        known_rules=known)
    rows = lambda fs: [(f.rule, f.path, f.line, f.message)  # noqa: E731
                       for f in fs]
    assert rows(tout) == rows(jout)
    assert tfindings.render_report(tout, header="h") == \
        jfindings.render_report(jout, header="h")


TRACE = """
SPAN_CATALOG = frozenset({"data", "drain", "orphan_span"})
EVENT_CATALOG = frozenset({"guard_bad_step", "replica_healthy",
                           "replica_dead", "orphan_event"})
"""
EMITTERS = """
def run(obs, tracer, state):
    with obs.span("data"):
        pass
    with obs.span("drain", steps=3):
        pass
    with obs.span("uncataloged_span"):
        pass
    obs.event("guard_bad_step", step=1)
    tracer.instant("not_in_catalog")
    obs.event(f"replica_{state}")
    obs.event(f"dyn_{state}_x")
    name = "x"
    obs.event(name)
"""
METRICS = """
class ServeMetrics:
    _WINDOW_COUNTERS = frozenset({"steps", "gone"})

    def __init__(self):
        self.n_steps = 0
        self.n_tokens = 0
        self.peak = 0

    def add(self, n):
        self.n_steps += 1
        self.n_tokens += n
        self.peak = max(self.peak, n)

    def summary(self):
        return {"steps": self.n_steps,
                "tokens": round(self.n_tokens, 2),
                "peak": self.peak}
"""
CATALOG_CASES = {
    "obs, whole package": {"__init__.py": "", "obs/trace.py": TRACE,
                           "serve/scheduler.py": EMITTERS},
    "obs, a subtree": {"obs/trace.py": TRACE, "serve/scheduler.py": EMITTERS},
    "obs, no catalog": {"serve/scheduler.py": EMITTERS},
    "windows": {"serve/metrics.py": METRICS},
    "obs, broken catalog": {"obs/trace.py": "SPAN_CATALOG = set()\n"},
}


@pytest.mark.parametrize("case", sorted(CATALOG_CASES))
def test_catalog_rules_match_jax(case):
    """JAX's catalog checks and the port's, on the same sources at each
    package's paths: the same findings."""
    import ast

    def run(pkg, parsed, check):
        mods = [parsed(path=f"{pkg}/{rel}", tree=ast.parse(src), source=src)
                for rel, src in CATALOG_CASES[case].items()]
        return sorted((f.rule, f.path.split("/", 1)[1], f.line, f.message)
                      for f in check(mods))

    got = run("dtdl_tpu_torch", TParsed, tcatalogs.check_repo)
    want = run("dtdl_tpu", JParsed, jcatalogs.check_repo)
    assert got == want
    if case == "obs, whole package":
        assert {r for r, *_ in got} == {
            "obs-span-uncataloged", "obs-event-uncataloged",
            "obs-catalog-stale", "obs-event-dynamic"}
    if case == "windows":
        assert {r for r, *_ in got} == {"metrics-window-counter",
                                        "metrics-window-stale"}


# ---- the port's own rules on synthetic sources ------------------------------

HOT = "dtdl_tpu_torch/serve/step.py"


@pytest.mark.parametrize("line,rule", [
    ("v = loss.item()", "host-sync-item"),
    ("v = float(torch.sum(x))", "host-sync-float"),
    ("v = int(torch.argmax(x))", "host-sync-float"),
    ("v = np.asarray(x.detach())", "host-sync-asarray"),
    ("v = np.array(torch.ones(3))", "host-sync-asarray"),
    ("v = x.tolist()", "host-sync-tolist"),
    ("v = x.numpy()", "host-sync-numpy"),
    ("v = x.numpy(force=True)", "host-sync-numpy"),
    ("v = x.cpu()", "host-sync-cpu"),
    ("torch.cuda.synchronize()", "host-sync-synchronize"),
    ("event.synchronize()", "host-sync-synchronize"),
])
def test_host_sync_rules_fire_on_torch_spellings(tmp_path, line, rule):
    src = f"import numpy as np\nimport torch\n\n\ndef f(x, loss, event):\n" \
          f"    {line}\n"
    found = lint_tree(tmp_path, {HOT: src})
    assert [(f.rule, f.line) for f in found] == [(rule, 6)]
    # the same line off the hot path, or in the drain module, is fine
    assert lint_tree(tmp_path, {"dtdl_tpu_torch/ckpt/io.py": src}) == []
    assert lint_tree(tmp_path, {"dtdl_tpu_torch/metrics/device.py": src}) \
        == []


def test_host_sync_rules_leave_host_data_alone(tmp_path):
    src = """
    import numpy as np
    import torch


    def f(active, temp, n):
        a = np.asarray(active, bool)
        b = np.array([1, 2, 3])
        c = float(n) + int(temp)
        d = torch.ones(3).to(torch.int32)
        return a, b, c, d
    """
    assert lint_tree(tmp_path, {HOT: src}) == []


@pytest.mark.parametrize("stmt", [
    "import jax",
    "import jax.numpy as jnp",
    "from flax import linen",
    "import optax",
    "from orbax.checkpoint import CheckpointManager",
    "import jaxlib",
    "from dtdl_tpu.models import transformer",
    "import dtdl_tpu",
    "mod = importlib.import_module('jax')",
    "mod = __import__('dtdl_tpu.serve')",
])
@pytest.mark.parametrize("where", ["dtdl_tpu_torch/train/x.py",
                                   "dtdl_tpu_torch/ckpt/x.py",
                                   "chip_smoke.py"])
def test_port_imports_jax_fires_on_the_jax_stack(tmp_path, stmt, where):
    src = f"import importlib\n\n\ndef f():\n    {stmt}\n"
    found = lint_tree(tmp_path, {where: src})
    assert [(f.rule, f.line) for f in found] == [("port-imports-jax", 5)]


def test_port_imports_jax_allows_the_port_and_tensorstore(tmp_path):
    src = """
    import tensorstore
    import torch
    from dtdl_tpu_torch.serve import engine
    from . import sibling
    import dtdl_tpu_torch.analysis
    """
    assert lint_tree(tmp_path, {"dtdl_tpu_torch/ckpt/x.py": src}) == []
    # the JAX package itself is not the port: the rule does not apply there
    assert lint_tree(tmp_path, {"dtdl_tpu/x.py": "import jax\n"}) == []


def test_kernel_fallback_fires_on_a_try_around_a_launch(tmp_path):
    src = """
    from dtdl_tpu_torch import kernels


    def attend(q):
        try:
            code = kernels.lib().dtdl_attend(q.data_ptr())
            kernels.check("attend", code)
        except kernels.KernelLaunchError:
            return attend_reference(q)
        return q


    def fine(q):
        try:
            code = kernels.lib().dtdl_attend(q.data_ptr())
        except kernels.KernelLaunchError:
            raise
        return q
    """
    found = lint_tree(tmp_path, {"dtdl_tpu_torch/ops/x.py": src})
    assert [(f.rule, f.line) for f in found] == [("kernel-fallback", 9)]
    # outside ops/ the rule does not look
    assert lint_tree(tmp_path, {"dtdl_tpu_torch/serve/x.py": src}) == []
