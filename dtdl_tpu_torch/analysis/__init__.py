"""The port's audit: lint rules, program census, pinned contracts and a
gate, the counterpart of dtdl_tpu/analysis/.

* **Linter** (:mod:`~dtdl_tpu_torch.analysis.lint`,
  :mod:`~dtdl_tpu_torch.analysis.rules`): AST rules over the port's
  tree, the host-sync ban on hot paths in torch's spellings, the port's
  isolation from JAX (``port-imports-jax``) and its no-fallback rule
  (``kernel-fallback``), and JAX's cross-file catalog checks.  Pure
  ``ast``: nothing is imported or run, about a second over the package
  on one CPU core.
* **Program audit** (:mod:`~dtdl_tpu_torch.analysis.program_audit`):
  runs a step once under a ``TorchDispatchMode`` census and reports its
  collectives (the port's own, and the ``c10d`` operations issued), host
  syncs, copies to and from the host, bf16->f32 casts and whether the
  state's storages were kept; on the card, also under
  ``torch.cuda.set_sync_debug_mode("error")``.
  :mod:`~dtdl_tpu_torch.analysis.contracts` pins JAX's five programs
  against ``baselines.json``.
* **Gate**: ``python -m dtdl_tpu_torch.analysis [paths] [--list-rules]
  [--rules ...] [--programs] [--rebase] [--json]``, non-zero on any
  unsuppressed finding; inline ``# audit: ok[rule-id] reason``
  suppressions.

Nothing here imports JAX or the JAX package; the linter imports no
torch (the program audit does).
"""

from dtdl_tpu_torch.analysis.findings import (Finding, Suppression,  # noqa: F401
                                              apply_suppressions,
                                              render_report,
                                              scan_suppressions)
from dtdl_tpu_torch.analysis.lint import lint_paths, rule_docs  # noqa: F401

__all__ = ["Finding", "Suppression", "apply_suppressions", "render_report",
           "scan_suppressions", "lint_paths", "rule_docs"]
