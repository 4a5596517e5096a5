"""Minimal GML (Graph Modelling Language) parser.

Covers the subset Shadow's network graphs use (reference:
src/lib/gml-parser/ — a nom-based parser; ours is a small recursive-descent
tokenizer): a top-level `graph [ ... ]` block containing scalar attributes
(`directed 0`) and repeated `node [ ... ]` / `edge [ ... ]` blocks whose
values are ints, floats, or quoted strings.
"""

from __future__ import annotations

import dataclasses
import re

_TOKEN = re.compile(
    r"""
    \s*(?:
        (?P<comment>\#[^\n]*)
      | (?P<lbracket>\[)
      | (?P<rbracket>\])
      | (?P<string>"(?:[^"\\]|\\.)*")
      | (?P<number>[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?)
      | (?P<key>[A-Za-z_][A-Za-z0-9_]*)
    )
    """,
    re.VERBOSE,
)


@dataclasses.dataclass
class GmlGraph:
    directed: bool
    attrs: dict
    nodes: list  # list of dicts, each with at least "id"
    edges: list  # list of dicts, each with "source" and "target"


def _tokenize(text: str):
    pos = 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if m is None:
            if text[pos:].strip() == "":
                return
            raise ValueError(f"GML parse error at offset {pos}: {text[pos:pos+40]!r}")
        pos = m.end()
        if m.lastgroup == "comment":
            continue
        if m.lastgroup == "lbracket":
            yield ("[", None)
        elif m.lastgroup == "rbracket":
            yield ("]", None)
        elif m.lastgroup == "string":
            raw = m.group("string")[1:-1]
            yield ("value", raw.replace('\\"', '"').replace("\\\\", "\\"))
        elif m.lastgroup == "number":
            text_num = m.group("number")
            if re.fullmatch(r"[-+]?\d+", text_num):
                yield ("value", int(text_num))
            else:
                yield ("value", float(text_num))
        elif m.lastgroup == "key":
            yield ("key", m.group("key"))


def _parse_block(tokens) -> dict:
    """Parse the inside of a [ ... ] block into a dict; repeated keys become lists."""
    out: dict = {}
    for tok, val in tokens:
        if tok == "]":
            return out
        if tok != "key":
            raise ValueError(f"expected key, got {tok} {val!r}")
        key = val
        tok2, val2 = next(tokens, ("eof", None))
        if tok2 == "[":
            value = _parse_block(tokens)
        elif tok2 == "value":
            value = val2
        else:
            raise ValueError(f"expected value after key {key!r}, got {tok2}")
        if key in out:
            if not isinstance(out[key], list):
                out[key] = [out[key]]
            out[key].append(value)
        else:
            out[key] = value
    raise ValueError("unterminated block: missing ']'")


def parse_gml(text: str) -> GmlGraph:
    tokens = _tokenize(text)
    for tok, val in tokens:
        if tok == "key" and val == "graph":
            tok2, _ = next(tokens, ("eof", None))
            if tok2 != "[":
                raise ValueError("expected '[' after 'graph'")
            body = _parse_block(tokens)
            break
    else:
        raise ValueError("no 'graph [' block found")

    def as_list(v):
        if v is None:
            return []
        return v if isinstance(v, list) else [v]

    nodes = as_list(body.pop("node", None))
    edges = as_list(body.pop("edge", None))
    directed = bool(body.pop("directed", 0))
    for n in nodes:
        if not isinstance(n, dict):
            raise ValueError(f"'node' must be a [ ... ] block, got {n!r}")
        if "id" not in n:
            raise ValueError(f"node missing 'id': {n}")
    for e in edges:
        if not isinstance(e, dict):
            raise ValueError(f"'edge' must be a [ ... ] block, got {e!r}")
        if "source" not in e or "target" not in e:
            raise ValueError(f"edge missing source/target: {e}")
    return GmlGraph(directed=directed, attrs=body, nodes=nodes, edges=edges)


def write_gml(g: GmlGraph) -> str:
    def fmt_val(v):
        if isinstance(v, str):
            escaped = v.replace("\\", "\\\\").replace('"', '\\"')
            return f'"{escaped}"'
        if isinstance(v, bool):
            return str(int(v))
        return repr(v) if isinstance(v, float) else str(v)

    lines = ["graph ["]
    lines.append(f"  directed {int(g.directed)}")
    for k, v in g.attrs.items():
        lines.append(f"  {k} {fmt_val(v)}")
    for n in g.nodes:
        lines.append("  node [")
        for k, v in n.items():
            lines.append(f"    {k} {fmt_val(v)}")
        lines.append("  ]")
    for e in g.edges:
        lines.append("  edge [")
        for k, v in e.items():
            lines.append(f"    {k} {fmt_val(v)}")
        lines.append("  ]")
    lines.append("]")
    return "\n".join(lines) + "\n"
