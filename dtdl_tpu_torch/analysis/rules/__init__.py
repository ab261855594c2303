"""The port's lint rules over Python ASTs, the counterpart of
dtdl_tpu/analysis/rules/.

Each rule module exposes ``RULES`` (``{rule id: one-line doc}``) and
``check(module)`` (per file) or ``check_repo(modules)`` (across files),
returning :class:`~dtdl_tpu_torch.analysis.findings.Finding` lists.  The
registry below is the one list the linter (``analysis/lint.py``) runs and
the ``--list-rules`` catalog is made from; rule ids live with their
implementations.  ``donation`` and ``trace_hygiene`` hold catalog entries
only: they police ``jax.jit`` targets, which eager PyTorch has none of,
and each names its counterpart in the port.

The shared map of the tree is here: which modules are *hot paths* (the
step and decode dispatch code, where a stray host sync is a stall every
step or token) and which is the sanctioned *drain point*.
"""

from __future__ import annotations

import ast
import dataclasses
import functools


@dataclasses.dataclass
class ParsedModule:
    """One parsed source file handed to every rule."""

    path: str          # repo-relative posix path (stable finding key)
    tree: ast.Module
    source: str

    @property
    def posix(self) -> str:
        return self.path.replace("\\", "/")

    @functools.cached_property
    def nodes(self) -> list:
        """Every node of the tree, walked once and shared by the rules."""
        return list(ast.walk(self.tree))


# ---------------------------------------------------------------------------
# the hot-path map: modules whose code runs per step or per token.  The
# host-sync rules apply only here: a host read in the checkpointer is its
# job; one in the decode loop stalls every token.
# ---------------------------------------------------------------------------

HOT_PATH_PREFIXES = (
    "dtdl_tpu_torch/train/",
    "dtdl_tpu_torch/serve/",
    "dtdl_tpu_torch/parallel/",
    "dtdl_tpu_torch/models/",
    "dtdl_tpu_torch/ops/",
    "dtdl_tpu_torch/quant/",
    "dtdl_tpu_torch/metrics/",
)

# the sanctioned drain point: the bounded metrics queue, whose job is the
# one host read a window at the loops' boundaries.  Everything else
# suppresses inline with a reason, so each exception shows where it is.
DRAIN_MODULES = (
    "dtdl_tpu_torch/metrics/device.py",
)

# the files the port's ground rules cover: its package and the card's
# scripts at the root of the repository
PORT_PREFIX = "dtdl_tpu_torch/"
PORT_SCRIPTS = ("chip_smoke.py", "chip_obs_diag.py")


def is_hot(mod: ParsedModule) -> bool:
    p = mod.posix
    if any(d in p for d in DRAIN_MODULES):
        return False
    return any(h in p for h in HOT_PATH_PREFIXES)


def is_port(mod: ParsedModule) -> bool:
    p = mod.posix
    return PORT_PREFIX in p or p.rsplit("/", 1)[-1] in PORT_SCRIPTS


# ---------------------------------------------------------------------------
# small AST helpers every rule shares
# ---------------------------------------------------------------------------

def dotted(node) -> str:
    """The dotted name of a Name/Attribute chain (``torch.cuda.synchronize``),
    or '' when the expression is not a plain chain."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def registry():
    """``{rule_id: one_line_doc}`` over every registered rule, the
    catalog-only JAX ids with their counterparts included."""
    from dtdl_tpu_torch.analysis.rules import (catalogs, compat, donation,
                                               host_sync, trace_hygiene)
    out = {}
    for mod in (host_sync, compat, donation, trace_hygiene, catalogs):
        out.update(mod.RULES)
    return out


def file_checks():
    from dtdl_tpu_torch.analysis.rules import compat, host_sync
    return (host_sync.check, compat.check)


def repo_checks():
    from dtdl_tpu_torch.analysis.rules import catalogs
    return (catalogs.check_repo,)
