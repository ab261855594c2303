"""Protobuf text-format (.prototxt) parser, the port's copy of
dtdl_tpu/utils/prototxt.py (pure Python, the same results and the same
errors).

Caffe's whole user surface is two prototxt files, a solver and a net;
this reads the subset Caffe configs use:

    key: value            scalars: ints, floats, booleans, "strings", ENUMS
    key { ... }           nested messages
    repeated keys         collected into lists (e.g. multiple ``layer { }``)

Comments (`#` to end of line) are stripped.  The result is a `Message`, a
thin dict subclass where ``msg.key`` works, repeated fields are normalized
via ``msg.getlist('key')``, and unknown keys raise KeyError with the path.
"""

from __future__ import annotations

import re


class Message(dict):
    """Parsed prototxt message: dict with attribute access + list helpers."""

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError:
            raise AttributeError(key) from None

    def getlist(self, key) -> list:
        """Value(s) of a repeated field as a list ([] if absent)."""
        if key not in self:
            return []
        v = self[key]
        return v if isinstance(v, list) else [v]

    def get_scalar(self, key, default=None):
        """Last occurrence wins (protobuf scalar-merge semantics)."""
        v = self.get(key, default)
        return v[-1] if isinstance(v, list) else v


_TOKEN = re.compile(r"""
    \s+                                   # whitespace
  | \#[^\n]*                              # comment
  | (?P<brace>[{}])
  | (?P<string>"(?:[^"\\]|\\.)*"|'(?:[^'\\]|\\.)*')
  | (?P<key>[A-Za-z_][A-Za-z0-9_]*)\s*:   # key:
  | (?P<msgkey>[A-Za-z_][A-Za-z0-9_]*)\s*(?={)   # key {  (colon optional)
  | (?P<value>[^\s{}#"'][^\s{}#]*)        # bare scalar / enum (a leading
                                          # quote means a malformed string:
                                          # fall through to the parse error)
""", re.VERBOSE)


def _coerce(tok: str):
    if tok.startswith(("\"", "'")):
        return tok[1:-1].encode().decode("unicode_escape")
    low = tok.lower()
    if low == "true":
        return True
    if low == "false":
        return False
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        pass
    return tok  # enum identifier (e.g. MAX, SGD, TRAIN)


def _store(msg: Message, key: str, value) -> None:
    if key in msg:
        cur = msg[key]
        if isinstance(cur, list):
            cur.append(value)
        else:
            msg[key] = [cur, value]
    else:
        msg[key] = value


def parse(text: str) -> Message:
    """Parse prototxt text into a Message tree."""
    root = Message()
    stack = [root]
    pending_key: str | None = None
    pos = 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if m is None:
            raise ValueError(f"prototxt parse error at offset {pos}: "
                             f"{text[pos:pos + 40]!r}")
        pos = m.end()
        if m.lastgroup is None:
            continue
        tok = m.group(m.lastgroup)
        if m.lastgroup == "brace":
            if tok == "{":
                child = Message()
                if pending_key is None:
                    raise ValueError("'{' without a field name")
                _store(stack[-1], pending_key, child)
                stack.append(child)
                pending_key = None
            else:
                if len(stack) == 1:
                    raise ValueError("unbalanced '}'")
                stack.pop()
        elif m.lastgroup in ("key", "msgkey"):
            if pending_key is not None:
                raise ValueError(f"field {pending_key!r} has no value")
            pending_key = tok
        else:  # string or bare value
            if pending_key is None:
                raise ValueError(f"value {tok!r} without a field name")
            _store(stack[-1], pending_key, _coerce(tok))
            pending_key = None
    if len(stack) != 1:
        raise ValueError("unbalanced '{': unterminated message")
    if pending_key is not None:
        raise ValueError(f"field {pending_key!r} has no value")
    return root


def parse_file(path: str) -> Message:
    with open(path) as f:
        return parse(f.read())
