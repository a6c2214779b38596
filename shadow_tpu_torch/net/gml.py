"""Minimal GML (Graph Modelling Language) parser.

Parses the subset of GML that network graphs use (the reference ships a
dedicated ``gml-parser`` crate for the same purpose): nested ``key [ ... ]``
records, string/int/float scalars, and the conventional top-level shape

    graph [ directed 0  node [ id 0 ... ]  edge [ source 0 target 0 ... ] ]

Returns plain dicts; interpretation (units, validation) happens in
:mod:`shadow_tpu_torch.net.graph`.
"""

from __future__ import annotations

import re
from typing import Any

_TOKEN_RE = re.compile(
    r"""
    \s*(?:
        (?P<comment>\#[^\n]*)
      | (?P<string>"(?:[^"\\]|\\.)*")
      | (?P<lbrack>\[)
      | (?P<rbrack>\])
      | (?P<number>[+-]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][+-]?\d+)?)
      | (?P<key>[A-Za-z_][A-Za-z0-9_]*)
    )
    """,
    re.VERBOSE,
)


class GmlError(ValueError):
    pass


def _tokenize(text: str):
    pos = 0
    n = len(text)
    while pos < n:
        m = _TOKEN_RE.match(text, pos)
        if not m:
            if text[pos:].strip() == "":
                return
            raise GmlError(f"bad GML syntax at offset {pos}: {text[pos:pos+40]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "comment":
            continue
        yield kind, m.group(kind)
    return


class _Parser:
    def __init__(self, text: str) -> None:
        self.tokens = list(_tokenize(text))
        self.i = 0

    def peek(self):
        return self.tokens[self.i] if self.i < len(self.tokens) else (None, None)

    def next(self):
        tok = self.peek()
        self.i += 1
        return tok

    def parse_record(self) -> dict[str, Any]:
        """Parse a ``[ key value ... ]`` body into a dict.  Repeated keys
        (``node``, ``edge``) accumulate into lists."""
        out: dict[str, Any] = {}
        while True:
            kind, val = self.next()
            if kind is None:
                raise GmlError("unexpected end of input: unbalanced '['")
            if kind == "rbrack":
                return out
            if kind != "key":
                raise GmlError(f"expected key, got {val!r}")
            key = val
            vkind, vval = self.next()
            if vkind == "lbrack":
                value: Any = self.parse_record()
            elif vkind == "string":
                value = vval[1:-1].replace('\\"', '"').replace("\\\\", "\\")
            elif vkind == "number":
                value = float(vval) if any(c in vval for c in ".eE") else int(vval)
            else:
                raise GmlError(f"expected value for key {key!r}, got {vval!r}")
            if key in ("node", "edge"):
                out.setdefault(key + "s", []).append(value)
            else:
                out[key] = value


def parse_gml(text: str) -> dict[str, Any]:
    """Parse GML text; returns the ``graph`` record as a dict with ``nodes``
    and ``edges`` lists."""
    p = _Parser(text)
    kind, val = p.next()
    if kind != "key" or val != "graph":
        raise GmlError("GML must start with 'graph ['")
    kind, _ = p.next()
    if kind != "lbrack":
        raise GmlError("expected '[' after 'graph'")
    g = p.parse_record()
    g.setdefault("nodes", [])
    g.setdefault("edges", [])
    return g
