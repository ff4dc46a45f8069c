"""Cypher tokenizer (counterpart of ``nornicdb_tpu/query/tokens.py``).

The reference's default parser is string/regex-based clause extraction with
no full parse tree on the hot path (pkg/cypher/parser.go:24,
keyword_scan.go). Here a single lightweight tokenizer feeds both the
clause splitter and the Pratt expression parser — still cheap (one linear
scan), but structurally sound for nesting/quoting.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from nornicdb_tpu_torch.errors import CypherSyntaxError

# token kinds
IDENT = "IDENT"
STRING = "STRING"
NUMBER = "NUMBER"
PARAM = "PARAM"
OP = "OP"
PUNCT = "PUNCT"
EOF = "EOF"

_PUNCT = set("()[]{},:;.|")
_OP_CHARS = set("=<>+-*/%^!")
_TWO_CHAR_OPS = {"<>", "<=", ">=", "=~", "->", "<-", "..", "+="}


@dataclass
class Token:
    kind: str
    value: str
    pos: int

    def upper(self) -> str:
        return self.value.upper()


def tokenize(text: str) -> List[Token]:
    toks: List[Token] = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c.isspace():
            i += 1
            continue
        if c == "/" and i + 1 < n and text[i + 1] == "/":  # line comment
            while i < n and text[i] != "\n":
                i += 1
            continue
        if c == "/" and i + 1 < n and text[i + 1] == "*":  # block comment
            j = text.find("*/", i + 2)
            i = n if j < 0 else j + 2
            continue
        if c in "'\"":
            quote = c
            j = i + 1
            buf = []
            while j < n:
                if text[j] == "\\" and j + 1 < n:
                    esc = text[j + 1]
                    buf.append(
                        {"n": "\n", "t": "\t", "r": "\r", "\\": "\\",
                         "'": "'", '"': '"'}.get(esc, esc)
                    )
                    j += 2
                    continue
                if text[j] == quote:
                    break
                buf.append(text[j])
                j += 1
            if j >= n:
                raise CypherSyntaxError(f"unterminated string at {i}")
            toks.append(Token(STRING, "".join(buf), i))
            i = j + 1
            continue
        if c == "`":  # escaped identifier
            j = text.find("`", i + 1)
            if j < 0:
                raise CypherSyntaxError(f"unterminated backtick at {i}")
            toks.append(Token(IDENT, text[i + 1 : j], i))
            i = j + 1
            continue
        if c.isdigit() or (
            c == "." and i + 1 < n and text[i + 1].isdigit()
        ):
            j = i
            seen_dot = False
            while j < n and (
                text[j].isdigit()
                or (text[j] == "." and not seen_dot and j + 1 < n and text[j + 1].isdigit())
                or text[j] in "eE"
                or (text[j] in "+-" and j > i and text[j - 1] in "eE")
                or (text[j] == "x" and j == i + 1 and text[i] == "0")
                or (text[i : i + 2] == "0x" and text[j] in "abcdefABCDEF")
            ):
                if text[j] == ".":
                    seen_dot = True
                j += 1
            toks.append(Token(NUMBER, text[i:j], i))
            i = j
            continue
        if c == "$":
            j = i + 1
            while j < n and (text[j].isalnum() or text[j] == "_"):
                j += 1
            toks.append(Token(PARAM, text[i + 1 : j], i))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (text[j].isalnum() or text[j] == "_"):
                j += 1
            toks.append(Token(IDENT, text[i:j], i))
            i = j
            continue
        two = text[i : i + 2]
        if two in _TWO_CHAR_OPS:
            # ".." only counts as an op in range context; "." handled below
            toks.append(Token(OP, two, i))
            i += 2
            continue
        if c in _PUNCT:
            toks.append(Token(PUNCT, c, i))
            i += 1
            continue
        if c in _OP_CHARS:
            toks.append(Token(OP, c, i))
            i += 1
            continue
        raise CypherSyntaxError(f"unexpected character {c!r} at {i}")
    toks.append(Token(EOF, "", n))
    return toks


class TokenStream:
    def __init__(self, tokens: List[Token]):
        self.toks = tokens
        self.i = 0

    def peek(self, ahead: int = 0) -> Token:
        j = min(self.i + ahead, len(self.toks) - 1)
        return self.toks[j]

    def next(self) -> Token:
        t = self.peek()
        if t.kind != EOF:
            self.i += 1
        return t

    def at_end(self) -> bool:
        return self.peek().kind == EOF

    def accept(self, value: str, kind: Optional[str] = None) -> Optional[Token]:
        t = self.peek()
        if t.kind == EOF:
            return None
        if kind is not None and t.kind != kind:
            return None
        if t.kind == IDENT:
            if t.upper() != value.upper():
                return None
        elif t.value != value:
            return None
        return self.next()

    def expect(self, value: str, kind: Optional[str] = None) -> Token:
        t = self.accept(value, kind)
        if t is None:
            got = self.peek()
            raise CypherSyntaxError(
                f"expected {value!r}, got {got.value!r} at {got.pos}"
            )
        return t

    def accept_kw(self, *words: str) -> bool:
        """Accept a multi-word keyword sequence (case-insensitive)."""
        save = self.i
        for w in words:
            t = self.peek()
            if t.kind != IDENT or t.upper() != w:
                self.i = save
                return False
            self.next()
        return True

    def peek_kw(self, *words: str) -> bool:
        save = self.i
        ok = self.accept_kw(*words)
        self.i = save
        return ok
