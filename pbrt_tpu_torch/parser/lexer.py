"""Tokenizer for the .pbrt scene language (reference: src/pbrtparser/lexer.rs).

Token kinds: bare identifiers (directives and true/false), quoted strings,
numbers, and square brackets. '#' starts a comment that runs to end of line.
The port's copy of ``pbrt_tpu/parser/lexer.py``.
"""
from __future__ import annotations

import re
from dataclasses import dataclass

IDENT = "IDENT"
STR = "STR"
NUM = "NUM"
LBRACK = "LBRACK"
RBRACK = "RBRACK"


@dataclass(frozen=True)
class Token:
    kind: str
    value: object
    line: int


_TOKEN_RE = re.compile(
    r"""
    (?P<ws>[ \t\r]+)
  | (?P<nl>\n)
  | (?P<comment>\#[^\n]*)
  | (?P<str>"(?:[^"\\]|\\.)*")
  | (?P<lbrack>\[)
  | (?P<rbrack>\])
  | (?P<num>[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?)
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
    """,
    re.VERBOSE,
)


class LexError(Exception):
    pass


def tokenize(text: str, filename: str = "<string>"):
    """Yield Tokens for the whole input. Raises LexError on bad characters."""
    pos = 0
    line = 1
    n = len(text)
    while pos < n:
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise LexError(f"{filename}:{line}: unexpected character {text[pos]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "nl":
            line += 1
        elif kind in ("ws", "comment"):
            pass
        elif kind == "str":
            s = m.group("str")[1:-1]
            s = s.replace('\\"', '"').replace("\\\\", "\\")
            yield Token(STR, s, line)
        elif kind == "lbrack":
            yield Token(LBRACK, "[", line)
        elif kind == "rbrack":
            yield Token(RBRACK, "]", line)
        elif kind == "num":
            txt = m.group("num")
            yield Token(NUM, float(txt), line)
        elif kind == "ident":
            yield Token(IDENT, m.group("ident"), line)


def tokenize_file(path: str):
    with open(path, "r") as f:
        return list(tokenize(f.read(), path))
