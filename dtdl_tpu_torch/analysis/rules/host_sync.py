"""The host-sync ban: no device reads on step and decode dispatch paths,
the port's counterpart of dtdl_tpu/analysis/rules/host_sync.py.

The port's loops never read a metric on the step they just dispatched
(:mod:`dtdl_tpu_torch.metrics.device`), and its engine keeps decode
dispatch free of host reads; these rules make that discipline checked.
In a hot-path module (``rules.HOT_PATH_PREFIXES``) each of the following
is a finding, under JAX's ids where the meaning carries over:

* ``host-sync-item``        - ``.item()``: a scalar read, the classic
  hidden wait.
* ``host-sync-float``       - ``float(...)`` / ``int(...)`` / ``bool(...)``
  applied directly to a ``torch.`` expression (an ``.item()`` in
  disguise).
* ``host-sync-asarray``     - ``np.asarray(...)`` / ``np.array(...)`` of
  a tensor expression (rooted at ``torch``, or through ``.detach()``,
  ``.cpu()``, ``.cuda()``, ``.to()``): a copy to the host in numpy's
  clothing.  (Of a card tensor without a ``.cpu()`` numpy raises rather
  than waits, so a bare name is not flagged: the engines' knobs and page
  tables reach them as host arrays.)
* ``host-sync-tolist``      - ``.tolist()`` (a tensor's is a copy to the
  host and a wait).
* ``host-sync-numpy``       - ``.numpy()``.
* ``host-sync-cpu``         - ``.cpu()``.
* ``host-sync-synchronize`` - ``torch.cuda.synchronize()``, or
  ``.synchronize()`` of a stream or an event: a pure wait.

JAX's ``host-sync-get`` (``jax.device_get``) and ``host-sync-block``
(``.block_until_ready()``) stay in the catalog with these as their
counterparts.

The AST cannot tell a tensor from a numpy array, so a host-only line
(a numpy page table's ``.tolist()``) is suppressed inline with the reason
that makes it host-only.  Sanctioned waits (the metrics queue's drain,
the KV handoff's copy out, a caller's host data at an API's entry) are
the drain module (``rules.DRAIN_MODULES``) or carry an inline ``# audit:
ok[...]`` with their reason, so every exception is visible where it
happens.
"""

from __future__ import annotations

import ast

from dtdl_tpu_torch.analysis.findings import Finding
from dtdl_tpu_torch.analysis.rules import dotted, is_hot

RULES = {
    "host-sync-item": ".item() scalar read on a hot path",
    "host-sync-float": "float()/int()/bool() of a torch expression on a "
                       "hot path (hidden .item())",
    "host-sync-asarray": "np.asarray/np.array of a tensor expression on "
                         "a hot path (a copy to the host in numpy "
                         "clothing)",
    "host-sync-tolist": ".tolist() on a hot path (a tensor's copies to "
                        "the host and waits)",
    "host-sync-numpy": ".numpy() on a hot path (a copy to the host)",
    "host-sync-cpu": ".cpu() on a hot path (a copy to the host)",
    "host-sync-synchronize": "torch.cuda.synchronize() or a stream's or "
                             "event's .synchronize() on a hot path (a "
                             "wait for the card)",
    "host-sync-get": "JAX rule (jax.device_get on a hot path); in the "
                     "port: host-sync-cpu, host-sync-numpy, "
                     "host-sync-tolist",
    "host-sync-block": "JAX rule (.block_until_ready() on a hot path); in "
                       "the port: host-sync-synchronize",
}

_ASARRAY = ("np.asarray", "numpy.asarray", "np.array", "numpy.array")
_CASTS = ("float", "int", "bool")
# method reads without arguments -> rule id
_METHODS = {"item": "host-sync-item", "tolist": "host-sync-tolist",
            "numpy": "host-sync-numpy", "cpu": "host-sync-cpu",
            "synchronize": "host-sync-synchronize"}


def _is_torch_rooted(node) -> bool:
    """Does this expression chain root at the ``torch`` name (so a host
    cast of it reads the device)?"""
    while isinstance(node, (ast.Attribute, ast.Call, ast.Subscript)):
        node = (node.func if isinstance(node, ast.Call)
                else node.value)
    return isinstance(node, ast.Name) and node.id == "torch"


_TENSOR_METHODS = ("detach", "cpu", "cuda", "to")


def _is_tensor_expr(node) -> bool:
    """A chain rooted at ``torch`` or passing through a tensor-only
    method call."""
    if _is_torch_rooted(node):
        return True
    while isinstance(node, (ast.Attribute, ast.Call, ast.Subscript)):
        if (isinstance(node, ast.Call) and isinstance(node.func,
                                                      ast.Attribute)
                and node.func.attr in _TENSOR_METHODS):
            return True
        node = node.func if isinstance(node, ast.Call) else node.value
    return False


def check(mod) -> list[Finding]:
    if not is_hot(mod):
        return []
    out = []
    for node in mod.nodes:
        if not isinstance(node, ast.Call):
            continue
        name = dotted(node.func)
        if name in _ASARRAY:
            if not (node.args and _is_tensor_expr(node.args[0])):
                continue
            out.append(Finding("host-sync-asarray", mod.path, node.lineno,
                               f"{name} on a hot path"))
        elif name == "torch.cuda.synchronize":
            out.append(Finding("host-sync-synchronize", mod.path,
                               node.lineno,
                               "torch.cuda.synchronize() on a hot path"))
        elif (isinstance(node.func, ast.Attribute)
              and node.func.attr in _METHODS and not node.args
              and (not node.keywords or node.func.attr == "numpy")):
            attr = node.func.attr
            out.append(Finding(_METHODS[attr], mod.path, node.lineno,
                               f".{attr}() on a hot path"))
        elif (isinstance(node.func, ast.Name)
              and node.func.id in _CASTS and len(node.args) == 1
              and _is_torch_rooted(node.args[0])):
            out.append(Finding(
                "host-sync-float", mod.path, node.lineno,
                f"{node.func.id}() of a torch expression on a hot path"))
    return out
