"""The port's isolation discipline, in the place of
dtdl_tpu/analysis/rules/compat.py.

JAX's rule keeps ``dtdl_tpu/_compat.py`` the one owner of a
compatibility decision (``jax.shard_map`` and friends patched onto older
jax).  The port takes one PyTorch and checks a version where it needs
one (``quant/core.py``'s ``Fp8UnsupportedError``), so it has no shim
and no counterpart file; what its ground rules need held instead is
this:

* ``port-imports-jax`` - an import of ``jax``, ``jaxlib``, ``flax``,
  ``optax``, ``orbax`` or ``dtdl_tpu`` (the JAX package) under
  dtdl_tpu_torch/ or in the card's scripts (chip_smoke.py,
  chip_obs_diag.py): ``import``, ``from ... import``, or
  ``importlib.import_module`` / ``__import__`` of a literal name.  The
  port imports torch, never JAX (the orbax reader's ``tensorstore`` is
  not JAX's).
* ``kernel-fallback`` - in dtdl_tpu_torch/ops/, a ``try`` around a kernel
  launch whose handler calls the plain version (a ``*_reference`` or
  ``plain*`` function): a wrapper launches its kernel on a card tensor or
  raises, and takes the plain version only for a CPU tensor.

JAX's ids ``compat-shard-map`` and ``compat-maps`` stay in the catalog
with ``port-imports-jax`` as their counterpart: the port cannot reach a
JAX namespace at all.
"""

from __future__ import annotations

import ast

from dtdl_tpu_torch.analysis.findings import Finding
from dtdl_tpu_torch.analysis.rules import dotted, is_port

RULES = {
    "port-imports-jax": "the port imports JAX, its libraries or the JAX "
                        "package (jax, jaxlib, flax, optax, orbax, "
                        "dtdl_tpu)",
    "kernel-fallback": "a try around a kernel launch in ops/ whose "
                       "handler calls the plain version (no fallback on "
                       "the card)",
    "compat-shard-map": "JAX rule (jax.experimental.shard_map outside "
                        "dtdl_tpu/_compat.py); in the port: "
                        "port-imports-jax, which refuses every JAX import",
    "compat-maps": "JAX rule (the removed jax.experimental.maps/xmap "
                   "namespace); in the port: port-imports-jax",
}

BANNED_ROOTS = frozenset({"jax", "jaxlib", "flax", "optax", "orbax",
                          "dtdl_tpu"})
_DYNAMIC_IMPORTS = ("importlib.import_module", "__import__")
_KERNEL_HINTS = ("kernels.", "lib().")


def _banned(name: str) -> bool:
    return (name or "").split(".")[0] in BANNED_ROOTS


def _import_findings(mod) -> list[Finding]:
    out = []
    for node in mod.nodes:
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        elif (isinstance(node, ast.Call)
              and dotted(node.func) in _DYNAMIC_IMPORTS and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            names = [node.args[0].value]
        for name in names:
            if _banned(name):
                out.append(Finding(
                    "port-imports-jax", mod.path, node.lineno,
                    f"imports {name}: the port imports torch, never the "
                    f"JAX stack or the JAX package"))
    return out


def _calls(nodes) -> list[str]:
    """The dotted (or unparsed) names of every call under ``nodes``."""
    out = []
    for n in nodes:
        for sub in ast.walk(n):
            if isinstance(sub, ast.Call):
                out.append(dotted(sub.func) or ast.unparse(sub.func))
    return out


def _is_launch(name: str) -> bool:
    return any(h in name + "." for h in _KERNEL_HINTS)


def _is_plain(name: str) -> bool:
    last = name.rsplit(".", 1)[-1]
    return last.endswith("_reference") or last.startswith("plain")


def _fallback_findings(mod) -> list[Finding]:
    out = []
    for node in mod.nodes:
        if not isinstance(node, ast.Try):
            continue
        if not any(_is_launch(c) for c in _calls(node.body)):
            continue
        for handler in node.handlers:
            plain = [c for c in _calls(handler.body) if _is_plain(c)]
            if plain:
                out.append(Finding(
                    "kernel-fallback", mod.path, handler.lineno,
                    f"a failed kernel launch falls back to {plain[0]}(): "
                    f"launch or raise on the card"))
    return out


def check(mod) -> list[Finding]:
    if not is_port(mod):
        return []
    out = _import_findings(mod)
    if "dtdl_tpu_torch/ops/" in mod.posix:
        out.extend(_fallback_findings(mod))
    return out
