"""The port's audit gate: lint the port, and audit its pinned programs.

Usage::

    python -m dtdl_tpu_torch.analysis [paths...]          # lint (default:
                                                          # the port and
                                                          # chip_smoke.py)
    python -m dtdl_tpu_torch.analysis --list-rules        # the catalog
    python -m dtdl_tpu_torch.analysis --programs [--device cpu]
    python -m dtdl_tpu_torch.analysis --programs --rebase # new baselines
    python -m dtdl_tpu_torch.analysis --json              # findings as JSON

Exit status 0 when every finding is suppressed (``# audit: ok[rule-id]
reason`` on the offending or the preceding line) and, with
``--programs``, the census equals dtdl_tpu_torch/analysis/baselines.json;
1 otherwise.  ``--programs`` builds and runs the pinned programs this
process's world can run (``megatron_step`` needs a world of 8; it is
skipped by name here) on the card, or on the CPU with ``--device cpu``.
The counterpart of the JAX package's scripts/audit.py.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

_REPO = pathlib.Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m dtdl_tpu_torch.analysis",
                                description=__doc__.split("\n")[0])
    p.add_argument("paths", nargs="*", default=None,
                   help="files/dirs to lint (default: dtdl_tpu_torch/ and "
                        "chip_smoke.py)")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule catalog and exit")
    p.add_argument("--rules", default=None,
                   help="comma-separated rule-id (prefix) filter")
    p.add_argument("--programs", action="store_true",
                   help="also audit the pinned programs (runs them; see "
                        "dtdl_tpu_torch/analysis/contracts.py)")
    p.add_argument("--device", default=None,
                   help="with --programs: 'cpu', or the card (default)")
    p.add_argument("--rebase", action="store_true",
                   help="with --programs: write the observed census as "
                        "the new baselines.json")
    p.add_argument("--json", action="store_true",
                   help="emit findings as JSON instead of the report")
    args = p.parse_args(argv)

    from dtdl_tpu_torch.analysis import lint_paths, render_report, rule_docs

    if args.list_rules:
        for rid, doc in rule_docs().items():
            print(f"{rid:24s} {doc}")
        return 0

    paths = args.paths or [str(_REPO / "dtdl_tpu_torch"),
                           str(_REPO / "chip_smoke.py")]
    only = args.rules.split(",") if args.rules else None
    findings = lint_paths(paths, root=str(_REPO), only_rules=only)

    reports = {}
    if args.programs:
        from dtdl_tpu_torch.analysis import contracts
        runnable, skipped = contracts.runnable_programs()
        for name in skipped:
            print(f"{name}: SKIPPED (needs a world of "
                  f"{contracts.PROCESSES[name]} processes; "
                  f"tests/test_torch_analysis_contracts.py runs it)",
                  file=sys.stderr)
        reports = contracts.audit_programs(runnable, device=args.device)
        for rep in reports.values():
            findings.extend(rep.pop("_findings"))
        if args.rebase:
            path = contracts.save_baseline(reports)
            print(f"baseline written: {path}", file=sys.stderr)
        else:
            findings.extend(contracts.compare_to_baseline(
                reports, contracts.load_baseline()))

    if args.json:
        out = {"findings": [vars(f) | {"detail": f.detail}
                            for f in findings]}
        if reports:
            out["programs"] = reports
        print(json.dumps(out, indent=2, default=str))
    else:
        for name, rep in sorted(reports.items()):
            cc = ", ".join(f"{k} x{v['count']} ({v['bytes']} B)"
                           for k, v in rep["collectives"].items()) or "none"
            print(f"{name}: collectives [{cc}], host_syncs="
                  f"{rep['host_syncs']}, d2h_copies={rep['d2h_copies']}, "
                  f"h2d_uploads={rep['h2d_uploads']}, bf16_to_f32_casts="
                  f"{rep['bf16_to_f32_casts']}, storage_kept="
                  f"{rep['storage_kept']}, cuda_syncs={rep['cuda_syncs']}")
        if findings:
            print(render_report(
                findings, header=f"{len(findings)} unsuppressed finding(s):"))
        else:
            print("audit clean: no unsuppressed findings")
    return 1 if findings else 0


if __name__ == "__main__":
    raise SystemExit(main())
