"""Algorithm-string parser.

Grammar (behavioral parity with the reference's algorithm-string language,
``util/algorithm_parser/`` + ``AlgorithmStringParser.hpp``):

    chain   := value (':' value)*            # driver-level chain sugar
    value   := IDENT [ '(' arglist? ')' ]
             | NUMBER | STRING | 'true' | 'false'
    arglist := arg (',' arg)* [',']
    arg     := [IDENT '='] value

Parsing produces a small AST (``Node``); evaluation against Meta
declarations happens in ``registry.py``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import List, Optional, Tuple, Union


@dataclass
class Node:
    """AST node: a named invocation with positional and keyword args."""

    name: str
    args: List[Tuple[Optional[str], "Value"]] = field(default_factory=list)

    def __str__(self):
        if not self.args:
            return self.name
        parts = []
        for k, v in self.args:
            s = str(v) if isinstance(v, Node) else repr_value(v)
            parts.append(f"{k}={s}" if k else s)
        return f"{self.name}({', '.join(parts)})"


Value = Union[Node, int, str, bool]


def repr_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, str):
        return f'"{v}"'
    return str(v)


_TOKEN_RE = re.compile(
    r"""
    \s*(
        [A-Za-z_][A-Za-z0-9_]*      # identifier
      | -?[0-9]+                    # integer
      | "(?:[^"\\]|\\.)*"           # double-quoted string
      | '(?:[^'\\]|\\.)*'           # single-quoted string
      | [():,=]                     # punctuation
    )
    """,
    re.VERBOSE,
)


class ParseError(ValueError):
    pass


class _Tokens:
    def __init__(self, text: str):
        self.text = text
        self.toks: list[str] = []
        pos = 0
        while pos < len(text):
            m = _TOKEN_RE.match(text, pos)
            if not m:
                if text[pos:].strip() == "":
                    break
                raise ParseError(
                    f"unexpected character at {pos}: {text[pos:pos+10]!r}"
                )
            self.toks.append(m.group(1))
            pos = m.end()
        self.i = 0

    def peek(self) -> Optional[str]:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> str:
        t = self.peek()
        if t is None:
            raise ParseError("unexpected end of algorithm string")
        self.i += 1
        return t

    def expect(self, tok: str) -> None:
        t = self.next()
        if t != tok:
            raise ParseError(f"expected {tok!r}, got {t!r}")


_IDENT_RE = re.compile(r"[A-Za-z_][A-Za-z0-9_]*$")


def _parse_value(ts: _Tokens) -> Value:
    t = ts.next()
    if t and (t[0] in "\"'"):
        return _unquote(t)
    if re.match(r"-?[0-9]+$", t):
        return int(t)
    if not _IDENT_RE.match(t):
        raise ParseError(f"expected a value, got {t!r}")
    if t == "true":
        return True
    if t == "false":
        return False
    node = Node(t)
    if ts.peek() == "(":
        ts.next()
        while ts.peek() != ")":
            key = None
            # lookahead for IDENT '='
            if (
                ts.peek()
                and _IDENT_RE.match(ts.peek() or "")
                and ts.i + 1 < len(ts.toks)
                and ts.toks[ts.i + 1] == "="
            ):
                key = ts.next()
                ts.next()  # '='
            node.args.append((key, _parse_value(ts)))
            if ts.peek() == ",":
                ts.next()
            elif ts.peek() != ")":
                raise ParseError(f"expected ',' or ')', got {ts.peek()!r}")
        ts.expect(")")
    return node


def _unquote(tok: str) -> str:
    body = tok[1:-1]
    return re.sub(r"\\(.)", r"\1", body)


def parse(text: str) -> Node:
    """Parse a single algorithm string (no chain) into a Node."""
    ts = _Tokens(text)
    v = _parse_value(ts)
    if ts.peek() is not None:
        raise ParseError(f"trailing input: {ts.toks[ts.i:]}")
    if not isinstance(v, Node):
        raise ParseError("algorithm string must be a named invocation")
    return v


def parse_chain(text: str) -> List[Node]:
    """Parse driver-level chain sugar ``a:b:c`` into a list of Nodes.

    Mirrors the ``:``-chaining accepted by the reference driver
    (``test/tudocomp_driver_tests.cpp:211-233``).
    """
    ts = _Tokens(text)
    nodes = []
    while True:
        v = _parse_value(ts)
        if not isinstance(v, Node):
            raise ParseError("chain element must be a named invocation")
        nodes.append(v)
        if ts.peek() == ":":
            ts.next()
            continue
        break
    if ts.peek() is not None:
        raise ParseError(f"trailing input: {ts.toks[ts.i:]}")
    return nodes
