"""Cross-file catalog consistency: emitters against their one source of
truth, the port's copy of dtdl_tpu/analysis/rules/catalogs.py under
JAX's rule ids.

The port keeps JAX's catalogs, and these rules prove their consistency
on every lint run, AST only:

* ``obs-*`` - every literal name passed to ``.span( / .event( /
  .instant(`` anywhere in the linted package must be in ``SPAN_CATALOG`` /
  ``EVENT_CATALOG`` (dtdl_tpu_torch/obs/trace.py), every catalog entry
  must have an emitter, and dynamic (f-string) names are refused but for
  the one sanctioned ``f"replica_{state}"`` family.
* ``metrics-window-*`` - in any class that declares a
  ``_WINDOW_COUNTERS`` frozenset next to a ``summary()`` (``ServeMetrics``,
  dtdl_tpu_torch/serve/metrics.py; ``FleetMetrics``,
  dtdl_tpu_torch/serve/fleet.py), every summary field that reads a
  ``+=``-incremented attribute is a monotonic counter and must be in the
  frozenset (or the exporter's window deltas report a cumulative value as
  a rate), and every frozenset entry must still be a summary key.

Both run only when the linted file set holds the defining module
(obs/trace.py, a ``_WINDOW_COUNTERS`` class): a subtree without the
catalog proves nothing about it.
"""

from __future__ import annotations

import ast

from dtdl_tpu_torch.analysis.findings import Finding
from dtdl_tpu_torch.analysis.rules import dotted

RULES = {
    "obs-span-uncataloged": "span name emitted but missing from "
                            "SPAN_CATALOG",
    "obs-event-uncataloged": "event name emitted but missing from "
                             "EVENT_CATALOG",
    "obs-catalog-stale": "catalog entry with no emitter anywhere",
    "obs-event-dynamic": "un-auditable dynamic span/event name "
                         "(literal names only)",
    "metrics-window-counter": "monotonic summary counter missing from "
                              "_WINDOW_COUNTERS (window deltas would "
                              "re-report the cumulative value)",
    "metrics-window-stale": "_WINDOW_COUNTERS entry that is not a "
                            "summary field",
}

#: the one sanctioned dynamic emitter: f"replica_{state}" over the
#: health machine's states, which covers every replica_* catalog entry
_DYNAMIC_OK = "replica_{state}"


def _frozenset_literal(node) -> set | None:
    """The string members of a ``frozenset({...})`` literal, else None."""
    if (isinstance(node, ast.Call) and dotted(node.func) == "frozenset"
            and node.args and isinstance(node.args[0], ast.Set)):
        elems = node.args[0].elts
        if all(isinstance(e, ast.Constant) and isinstance(e.value, str)
               for e in elems):
            return {e.value for e in elems}
    return None


def _joined_str_template(node: ast.JoinedStr) -> str:
    """f-string reassembled with ``{x}`` placeholders."""
    parts = []
    for v in node.values:
        if isinstance(v, ast.Constant):
            parts.append(str(v.value))
        elif isinstance(v, ast.FormattedValue):
            parts.append("{%s}" % (dotted(v.value) or "?"))
    return "".join(parts)


def _check_obs(modules) -> list[Finding]:
    trace_mod = next((m for m in modules
                      if m.posix.endswith("dtdl_tpu_torch/obs/trace.py")), None)
    if trace_mod is None:
        return []
    catalogs: dict[str, tuple[set, int]] = {}
    for node in trace_mod.nodes:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id in ("SPAN_CATALOG",
                                           "EVENT_CATALOG"):
            members = _frozenset_literal(node.value)
            if members is not None:
                catalogs[node.targets[0].id] = (members, node.lineno)
    if len(catalogs) != 2:
        return [Finding("obs-catalog-stale", trace_mod.path, 0,
                        "SPAN_CATALOG/EVENT_CATALOG are no longer "
                        "auditable frozenset literals")]
    span_cat, span_line = catalogs["SPAN_CATALOG"]
    event_cat, event_line = catalogs["EVENT_CATALOG"]
    # the stale direction (a catalog entry with no emitter) is provable
    # only over the WHOLE package (emitters live in serve/, train/,
    # resil/), so it runs only when the package root is in the file set;
    # a subtree lint still proves the uncataloged direction for the
    # emitters it sees
    full_package = any(m.posix.endswith("dtdl_tpu_torch/__init__.py")
                       for m in modules)

    out = []
    spans: dict[str, tuple] = {}
    events: dict[str, tuple] = {}
    for mod in modules:
        if "dtdl_tpu_torch/" not in mod.posix:
            continue            # emitters live in the package only
        for node in mod.nodes:
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("span", "event", "instant")
                    and node.args):
                continue
            arg = node.args[0]
            book = spans if node.func.attr == "span" else events
            if isinstance(arg, ast.Constant) and isinstance(arg.value,
                                                            str):
                book[arg.value] = (mod.path, node.lineno)
            elif isinstance(arg, ast.JoinedStr):
                tmpl = _joined_str_template(arg)
                if tmpl == _DYNAMIC_OK:
                    for name in event_cat:
                        if name.startswith("replica_"):
                            book[name] = (mod.path, node.lineno)
                else:
                    out.append(Finding(
                        "obs-event-dynamic", mod.path, node.lineno,
                        f"dynamic {node.func.attr} name {tmpl!r} — "
                        f"use a literal or extend the sanctioned set"))
            # non-literal Name/Attribute first args are API plumbing
            # (Tracer internals forwarding a name), not emitters

    for name, (path, line) in sorted(spans.items()):
        if name not in span_cat:
            out.append(Finding("obs-span-uncataloged", path, line,
                               f"span {name!r} missing from "
                               f"SPAN_CATALOG"))
    for name, (path, line) in sorted(events.items()):
        if name not in event_cat:
            out.append(Finding("obs-event-uncataloged", path, line,
                               f"event {name!r} missing from "
                               f"EVENT_CATALOG"))
    if full_package:
        for name in sorted(span_cat - set(spans)):
            out.append(Finding("obs-catalog-stale", trace_mod.path,
                               span_line,
                               f"SPAN_CATALOG entry {name!r} has no "
                               f"emitter"))
        for name in sorted(event_cat - set(events)):
            out.append(Finding("obs-catalog-stale", trace_mod.path,
                               event_line,
                               f"EVENT_CATALOG entry {name!r} has no "
                               f"emitter"))
    return out


def _unwrap_round(node):
    """``round(x, n)`` -> ``x`` (summary fields often round floats)."""
    if (isinstance(node, ast.Call) and dotted(node.func) == "round"
            and node.args):
        return node.args[0]
    return node


def _self_attr(node) -> str:
    node = _unwrap_round(node)
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return ""


def _check_windows(modules) -> list[Finding]:
    out = []
    for mod in modules:
        for cls in mod.nodes:
            if not isinstance(cls, ast.ClassDef):
                continue
            counters = None
            counters_line = 0
            summary = None
            for item in cls.body:
                if isinstance(item, ast.Assign) and len(item.targets) \
                        == 1 and isinstance(item.targets[0], ast.Name) \
                        and item.targets[0].id == "_WINDOW_COUNTERS":
                    counters = _frozenset_literal(item.value)
                    counters_line = item.lineno
                if isinstance(item, ast.FunctionDef) \
                        and item.name == "summary":
                    summary = item
            if counters is None or summary is None:
                continue
            # every `self.x += ...` anywhere in the class is a counter
            incremented = {
                n.target.attr for n in ast.walk(cls)
                if isinstance(n, ast.AugAssign)
                and isinstance(n.op, ast.Add)
                and _self_attr(n.target)}
            keys: dict[str, tuple[int, str]] = {}
            for node in ast.walk(summary):
                if isinstance(node, ast.Dict):
                    for k, v in zip(node.keys, node.values):
                        if isinstance(k, ast.Constant) \
                                and isinstance(k.value, str):
                            keys[k.value] = (k.lineno, _self_attr(v))
            for key, (line, attr) in sorted(keys.items()):
                if attr and attr in incremented and key not in counters:
                    out.append(Finding(
                        "metrics-window-counter", mod.path, line,
                        f"{cls.name}.summary()['{key}'] reads "
                        f"+=-counter self.{attr} but is not in "
                        f"_WINDOW_COUNTERS"))
            for name in sorted(counters - set(keys)):
                out.append(Finding(
                    "metrics-window-stale", mod.path, counters_line,
                    f"{cls.name}._WINDOW_COUNTERS entry {name!r} is "
                    f"not a summary field"))
    return out


def check_repo(modules) -> list[Finding]:
    return _check_obs(modules) + _check_windows(modules)
