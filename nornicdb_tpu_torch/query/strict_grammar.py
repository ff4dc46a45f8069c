"""Grammar-complete strict Cypher parser (diagnostic mode) (counterpart
of ``nornicdb_tpu/query/strict_grammar.py``).

Reference: pkg/cypher/antlr/CypherParser.g4 — the reference's strict
mode runs a second, grammar-complete OpenCypher parser (ANTLR) whose
job is rejecting malformed queries with precise diagnostics, at 73-
4,753x the fast path's cost (docs/architecture/cypher-parser-modes.md).

This is the second parser: an independent recursive-descent
implementation of the full clause grammar over the shared tokenizer.
It builds no AST — its output is acceptance plus diagnostics — and it
enforces the grammar rules the fast parser deliberately skips on the
hot path:

- clause ORDER (openCypher SinglePartQuery/MultiPartQuery): reading
  clauses cannot follow updating clauses within a query part, nothing
  follows RETURN except UNION, WHERE attaches only to MATCH/WITH and
  at most once;
- UNION / UNION ALL cannot be mixed in one statement;
- SKIP/LIMIT take non-negative integer literals or parameters;
- MERGE takes exactly one path; ON can only introduce CREATE/MATCH SET;
- CREATE relationships need a type and exactly one hop;
- label/type positions must hold identifiers (the fast parser will
  swallow a stray token as a label name);
- one statement per parse (a second `;`-separated statement is
  diagnosed, not silently concatenated).

``parse(query)`` raises StrictSyntaxError (line/col attached) on the
first violation; ``check(query)`` returns a list of Diagnostics.
tests/test_strict_grammar.py diffs a few-hundred-case accept/reject
corpus against the fast parser.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from nornicdb_tpu_torch.errors import CypherSyntaxError
from nornicdb_tpu_torch.query.tokens import (
    EOF,
    IDENT,
    NUMBER,
    OP,
    PARAM,
    PUNCT,
    STRING,
    Token,
    TokenStream,
    tokenize,
)


class StrictSyntaxError(CypherSyntaxError):
    def __init__(self, message: str, line: int = 1, column: int = 1):
        super().__init__(f"{message} (line {line}, column {column})")
        self.bare_message = message
        self.line = line
        self.column = column


_UPDATING = {"CREATE", "MERGE", "SET", "REMOVE", "DELETE", "DETACH"}
_READING = {"MATCH", "OPTIONAL", "UNWIND", "CALL"}

_RESERVED_NOT_NAMES = {
    "WHERE", "RETURN", "WITH", "MATCH", "CREATE", "MERGE", "DELETE",
    "DETACH", "REMOVE", "SET", "UNWIND", "UNION", "ORDER", "SKIP",
    "LIMIT", "CALL", "YIELD", "ON", "WHEN", "THEN", "ELSE", "END",
}


class StrictParser:
    def __init__(self, text: str):
        self.text = text
        try:
            self.ts = TokenStream(tokenize(text))
        except CypherSyntaxError as e:
            raise self._wrap_tokenize_error(e)

    # -- diagnostics ------------------------------------------------------

    def _line_col(self, pos: int):
        upto = self.text[:pos]
        return upto.count("\n") + 1, pos - (upto.rfind("\n") + 1) + 1

    def _err(self, message: str, tok: Optional[Token] = None):
        tok = tok or self.ts.peek()
        pos = getattr(tok, "pos", len(self.text))
        line, col = self._line_col(min(pos, len(self.text)))
        raise StrictSyntaxError(message, line, col)

    def _wrap_tokenize_error(self, e: CypherSyntaxError):
        import re

        m = re.search(r" at (\d+)$", str(e))
        pos = int(m.group(1)) if m else 0
        line, col = self._line_col(min(pos, len(self.text)))
        return StrictSyntaxError(str(e), line, col)

    # -- token helpers ----------------------------------------------------

    def _name(self, what: str) -> str:
        t = self.ts.peek()
        if t.kind != IDENT:
            self._err(f"expected {what}, got {t.value!r}", t)
        if t.upper() in _RESERVED_NOT_NAMES:
            self._err(f"reserved word {t.value!r} cannot be a {what}", t)
        return self.ts.next().value

    def _expect(self, value: str, kind: Optional[str] = None):
        t = self.ts.peek()
        ok = (t.value == value if kind is None
              else (t.kind == kind and t.value == value))
        if t.kind == IDENT and kind is None and t.upper() == value.upper():
            ok = True
        if not ok:
            self._err(f"expected {value!r}, got {t.value!r}", t)
        return self.ts.next()

    # -- statement --------------------------------------------------------

    def parse(self) -> None:
        self._query_part_sequence()
        union_kind = None  # 'ALL' | 'DISTINCT'
        while self.ts.peek_kw("UNION"):
            self.ts.next()
            this = "ALL" if self.ts.accept_kw("ALL") else "DISTINCT"
            if union_kind is not None and union_kind != this:
                self._err("cannot mix UNION and UNION ALL")
            union_kind = this
            self._query_part_sequence()
        if self.ts.accept(";", PUNCT):
            if not self.ts.at_end():
                self._err("only one statement per query "
                          "(text after ';')")
        if not self.ts.at_end():
            t = self.ts.peek()
            self._err(f"unexpected token {t.value!r} after query", t)

    # -- single query (clause order automaton) ----------------------------

    def _query_part_sequence(self) -> None:
        """MultiPartQuery := ((Reading* Updating*) WITH)* SinglePart.
        State machine per part: reading -> updating; WITH resets;
        RETURN terminates."""
        state = "reading"
        saw_clause = False
        returned = False
        last_where_host = False  # current clause can host a WHERE
        while not self.ts.at_end():
            t = self.ts.peek()
            if t.kind == PUNCT and t.value == ";":
                break
            if t.kind != IDENT:
                self._err(f"expected a clause, got {t.value!r}", t)
            kw = t.upper()
            if kw == "UNION":
                break
            if returned:
                self._err(f"{kw} cannot follow RETURN", t)
            if kw in ("MATCH", "OPTIONAL"):
                if state == "updating":
                    self._err(
                        f"{kw + ' MATCH' if kw == 'OPTIONAL' else kw} "
                        "cannot follow an updating clause — "
                        "introduce a WITH first", t)
                self.ts.next()
                if kw == "OPTIONAL":
                    self._expect("MATCH")
                self._patterns(allow_where_anchor=True)
                last_where_host = self._maybe_where()
            elif kw == "UNWIND":
                if state == "updating":
                    self._err("UNWIND cannot follow an updating clause "
                              "— introduce a WITH first", t)
                self.ts.next()
                self._expression()
                self._expect("AS")
                self._name("variable")
                last_where_host = False
            elif kw == "CALL":
                if state == "updating":
                    self._err("CALL cannot follow an updating clause "
                              "— introduce a WITH first", t)
                self.ts.next()
                self._call()
                last_where_host = False
            elif kw == "CREATE":
                state = "updating"
                self.ts.next()
                self._patterns(creating=True)
                last_where_host = False
            elif kw == "MERGE":
                state = "updating"
                self.ts.next()
                self._merge()
                last_where_host = False
            elif kw == "SET":
                state = "updating"
                self.ts.next()
                self._set_items()
                last_where_host = False
            elif kw == "REMOVE":
                state = "updating"
                self.ts.next()
                self._remove_items()
                last_where_host = False
            elif kw in ("DELETE", "DETACH"):
                state = "updating"
                self.ts.next()
                if kw == "DETACH":
                    self._expect("DELETE")
                self._expression()
                while self.ts.accept(",", PUNCT):
                    self._expression()
                last_where_host = False
            elif kw == "WITH":
                self.ts.next()
                self._projection(is_return=False)
                state = "reading"
                last_where_host = False  # WITH's WHERE parsed inline
            elif kw == "RETURN":
                self.ts.next()
                self._projection(is_return=True)
                returned = True
                last_where_host = False
            elif kw == "WHERE":
                self._err(
                    "WHERE must directly follow MATCH or WITH"
                    if not last_where_host
                    else "only one WHERE per MATCH/WITH", t)
            elif kw in ("ORDER", "SKIP", "LIMIT"):
                self._err(f"{kw} is only allowed after RETURN or WITH "
                          "projections", t)
            else:
                self._err(f"unknown clause {t.value!r}", t)
            saw_clause = True
        if not saw_clause:
            self._err("empty query")

    def _maybe_where(self) -> bool:
        if self.ts.accept_kw("WHERE"):
            self._expression()
            return True  # a second WHERE is now an error
        return True

    # -- clauses ----------------------------------------------------------

    def _projection(self, is_return: bool) -> None:
        self.ts.accept_kw("DISTINCT")
        t = self.ts.peek()
        if t.kind == OP and t.value == "*":
            self.ts.next()
        else:
            self._projection_item()
            while self.ts.accept(",", PUNCT):
                self._projection_item()
        if self.ts.accept_kw("ORDER"):
            self._expect("BY")
            self._expression()
            self._order_direction()
            while self.ts.accept(",", PUNCT):
                self._expression()
                self._order_direction()
        if self.ts.accept_kw("SKIP"):
            self._pagination_value("SKIP")
        if self.ts.accept_kw("LIMIT"):
            self._pagination_value("LIMIT")
        if not is_return and self.ts.accept_kw("WHERE"):
            self._expression()
            if self.ts.peek_kw("WHERE"):
                self._err("only one WHERE per MATCH/WITH")

    def _order_direction(self) -> None:
        if not (self.ts.accept_kw("DESC") or self.ts.accept_kw("DESCENDING")):
            self.ts.accept_kw("ASC") or self.ts.accept_kw("ASCENDING")

    def _projection_item(self) -> None:
        t = self.ts.peek()
        if t.kind == EOF or (t.kind == IDENT
                             and t.upper() in _RESERVED_NOT_NAMES
                             and t.upper() not in ("END",)):
            self._err("expected a projection expression", t)
        self._expression()
        if self.ts.accept_kw("AS"):
            self._name("alias")

    def _pagination_value(self, what: str) -> None:
        t = self.ts.peek()
        if t.kind == PARAM:
            self.ts.next()
            return
        neg = False
        if t.kind == OP and t.value == "-":
            neg = True
            self.ts.next()
            t = self.ts.peek()
        if t.kind != NUMBER:
            self._err(f"{what} expects a non-negative integer", t)
        if neg:
            self._err(f"{what} cannot be negative", t)
        if ("." in t.value or "e" in t.value.lower()) \
                and not t.value.startswith("0x"):
            self._err(f"{what} expects an integer, got {t.value!r}", t)
        self.ts.next()

    def _call(self) -> None:
        self._name("procedure name")
        while self.ts.accept(".", PUNCT):
            self._name("procedure name")
        if self.ts.accept("(", PUNCT):
            if not (self.ts.peek().kind == PUNCT
                    and self.ts.peek().value == ")"):
                self._expression()
                while self.ts.accept(",", PUNCT):
                    self._expression()
            self._expect(")")
        if self.ts.accept_kw("YIELD"):
            t = self.ts.peek()
            if t.kind == OP and t.value == "*":
                self.ts.next()
            else:
                self._name("yield item")
                if self.ts.accept_kw("AS"):
                    self._name("alias")
                while self.ts.accept(",", PUNCT):
                    self._name("yield item")
                    if self.ts.accept_kw("AS"):
                        self._name("alias")
            if self.ts.accept_kw("WHERE"):
                self._expression()

    def _merge(self) -> None:
        self._path()
        if self.ts.peek().kind == PUNCT and self.ts.peek().value == ",":
            self._err("MERGE takes exactly one pattern path")
        while self.ts.peek_kw("ON"):
            self.ts.next()
            t = self.ts.peek()
            if self.ts.accept_kw("CREATE") or self.ts.accept_kw("MATCH"):
                self._expect("SET")
                self._set_items()
            else:
                self._err("ON must introduce CREATE SET or MATCH SET", t)

    def _set_items(self) -> None:
        self._set_item()
        while self.ts.accept(",", PUNCT):
            self._set_item()

    def _set_item(self) -> None:
        var_tok = self.ts.peek()
        self._name("variable")
        if self.ts.accept(":", PUNCT):
            # SET n:Label[:Label...]
            self._name("label")
            while self.ts.accept(":", PUNCT):
                self._name("label")
            return
        path = False
        while self.ts.accept(".", PUNCT):
            self._name("property name")
            path = True
        t = self.ts.peek()
        if t.kind == OP and t.value in ("=", "+="):
            if t.value == "+=" and path:
                self._err("+= applies to maps on a variable, not a "
                          "property", t)
            self.ts.next()
            self._expression()
            return
        if not path:
            self._err("SET expects `var.prop = expr`, `var += map` or "
                      "`var:Label`", var_tok)
        self._err("SET expects `=` or `+=`", t)

    def _remove_items(self) -> None:
        def one():
            self._name("variable")
            if self.ts.accept(":", PUNCT):
                self._name("label")
                while self.ts.accept(":", PUNCT):
                    self._name("label")
                return
            if not self.ts.accept(".", PUNCT):
                self._err("REMOVE expects `var.prop` or `var:Label`")
            self._name("property name")
            while self.ts.accept(".", PUNCT):
                self._name("property name")

        one()
        while self.ts.accept(",", PUNCT):
            one()

    # -- patterns ---------------------------------------------------------

    def _patterns(self, creating: bool = False,
                  allow_where_anchor: bool = False) -> None:
        self._path(creating=creating)
        while self.ts.accept(",", PUNCT):
            self._path(creating=creating)

    def _path(self, creating: bool = False) -> None:
        # named path: p = (...)
        if (self.ts.peek().kind == IDENT
                and self.ts.peek(1).kind == OP
                and self.ts.peek(1).value == "="
                and self.ts.peek().upper() not in _RESERVED_NOT_NAMES):
            self._name("path variable")
            self.ts.next()  # '='
        # shortestPath( path ) / allShortestPaths( path )
        if (self.ts.peek().kind == IDENT
                and self.ts.peek().upper() in ("SHORTESTPATH",
                                               "ALLSHORTESTPATHS")
                and self.ts.peek(1).kind == PUNCT
                and self.ts.peek(1).value == "("):
            self.ts.next()
            self._expect("(")
            self._path(creating=creating)
            self._expect(")")
            return
        self._node()
        while self._at_rel_start():
            self._rel(creating=creating)
            self._node()

    def _at_rel_start(self) -> bool:
        t = self.ts.peek()
        return t.kind == OP and t.value in ("-", "<-", "<", "->")

    def _node(self) -> None:
        self._expect("(", PUNCT)
        t = self.ts.peek()
        if t.kind == IDENT and t.upper() not in _RESERVED_NOT_NAMES:
            self.ts.next()
        elif t.kind == IDENT and t.upper() in _RESERVED_NOT_NAMES:
            self._err(f"reserved word {t.value!r} cannot name a node", t)
        while self.ts.accept(":", PUNCT):
            self._name("label")
        if self.ts.peek().kind == PUNCT and self.ts.peek().value == "{":
            self._map_literal()
        elif self.ts.peek().kind == PARAM:
            self.ts.next()  # node properties from a parameter
        self._expect(")", PUNCT)

    def _rel(self, creating: bool = False) -> None:
        t = self.ts.next()  # '-', '<-', '<'
        incoming = False
        if t.value == "<-":
            incoming = True
        elif t.value == "<":
            self._expect("-", OP)
            incoming = True
        elif t.value == "->":
            self._err("relationship must open with '-' or '<-'", t)
        typed = False
        var_length = False
        if self.ts.accept("[", PUNCT):
            if (self.ts.peek().kind == IDENT
                    and self.ts.peek().upper() not in _RESERVED_NOT_NAMES):
                self.ts.next()
            if self.ts.accept(":", PUNCT):
                typed = True
                self._name("relationship type")
                while self.ts.accept("|", PUNCT):
                    self.ts.accept(":", PUNCT)  # legacy |:TYPE
                    self._name("relationship type")
            if self.ts.peek().kind == OP and self.ts.peek().value == "*":
                var_length = True
                self.ts.next()
                if self.ts.peek().kind == NUMBER:
                    self._hop_bound()
                    if self.ts.accept("..", OP):
                        if self.ts.peek().kind == NUMBER:
                            self._hop_bound()
                elif self.ts.accept("..", OP):
                    if self.ts.peek().kind == NUMBER:
                        self._hop_bound()
            if self.ts.peek().kind == PUNCT and self.ts.peek().value == "{":
                self._map_literal()
            self._expect("]", PUNCT)
        if incoming:
            self._expect("-", OP)
            if self.ts.peek().kind == OP and self.ts.peek().value == ">":
                self._err("a relationship cannot point both ways")
        else:
            nxt = self.ts.peek()
            if nxt.kind == OP and nxt.value in ("->", "-"):
                self.ts.next()
            else:
                self._err("expected '->' or '-' to close the "
                          "relationship", nxt)
        if creating:
            if not typed:
                self._err("CREATE requires a relationship type")
            if var_length:
                self._err("CREATE cannot use variable-length "
                          "relationships")

    def _hop_bound(self) -> None:
        t = self.ts.peek()
        if "." in t.value or t.value.lower().find("e") > 0:
            self._err("hop bounds must be integers", t)
        self.ts.next()

    def _map_literal(self) -> None:
        self._expect("{", PUNCT)
        if self.ts.accept("}", PUNCT):
            return
        while True:
            key = self.ts.peek()
            if key.kind not in (IDENT, STRING):
                self._err("map keys must be identifiers or strings", key)
            self.ts.next()
            self._expect(":", PUNCT)
            self._expression()
            if not self.ts.accept(",", PUNCT):
                break
        self._expect("}", PUNCT)

    # -- expressions (full precedence ladder) -----------------------------

    def _expression(self) -> None:
        self._or_expr()

    def _or_expr(self) -> None:
        self._xor_expr()
        while self.ts.accept_kw("OR"):
            self._xor_expr()

    def _xor_expr(self) -> None:
        self._and_expr()
        while self.ts.accept_kw("XOR"):
            self._and_expr()

    def _and_expr(self) -> None:
        self._not_expr()
        while self.ts.accept_kw("AND"):
            self._not_expr()

    def _not_expr(self) -> None:
        while self.ts.accept_kw("NOT"):
            pass
        self._comparison()

    def _comparison(self) -> None:
        self._string_list_null()
        while True:
            t = self.ts.peek()
            if t.kind == OP and t.value in ("=", "<>", "<", "<=", ">",
                                            ">=", "=~"):
                self.ts.next()
                self._string_list_null()
                continue
            if t.kind == IDENT and t.upper() == "IN":
                self.ts.next()
                self._string_list_null()
                continue
            if t.kind == IDENT and t.upper() in ("STARTS", "ENDS"):
                self.ts.next()
                self._expect("WITH")
                self._string_list_null()
                continue
            if t.kind == IDENT and t.upper() == "CONTAINS":
                self.ts.next()
                self._string_list_null()
                continue
            break

    def _string_list_null(self) -> None:
        self._add_sub()
        while True:
            t = self.ts.peek()
            if t.kind == IDENT and t.upper() == "IS":
                self.ts.next()
                self.ts.accept_kw("NOT")
                if not self.ts.accept_kw("NULL"):
                    self._err("IS must be followed by [NOT] NULL")
                continue
            break

    def _add_sub(self) -> None:
        self._mul_div()
        while True:
            t = self.ts.peek()
            if t.kind == OP and t.value in ("+", "-"):
                self.ts.next()
                self._mul_div()
            else:
                break

    def _mul_div(self) -> None:
        self._power()
        while True:
            t = self.ts.peek()
            if t.kind == OP and t.value in ("*", "/", "%"):
                self.ts.next()
                self._power()
            else:
                break

    def _power(self) -> None:
        self._unary()
        while self.ts.peek().kind == OP and self.ts.peek().value == "^":
            self.ts.next()
            self._unary()

    def _unary(self) -> None:
        while (self.ts.peek().kind == OP
               and self.ts.peek().value in ("+", "-")):
            self.ts.next()
        self._postfix()

    def _postfix(self) -> None:
        self._atom()
        while True:
            t = self.ts.peek()
            if t.kind == PUNCT and t.value == ".":
                self.ts.next()
                self._name("property name")
            elif t.kind == PUNCT and t.value == "[":
                self.ts.next()
                if not (self.ts.peek().kind == OP
                        and self.ts.peek().value == ".."):
                    self._expression()
                if self.ts.accept("..", OP):
                    if not (self.ts.peek().kind == PUNCT
                            and self.ts.peek().value == "]"):
                        self._expression()
                self._expect("]", PUNCT)
            elif t.kind == PUNCT and t.value == ":":
                # label predicate n:Label
                self.ts.next()
                self._name("label")
                while self.ts.accept(":", PUNCT):
                    self._name("label")
            else:
                break

    def _atom(self) -> None:
        t = self.ts.peek()
        if t.kind in (STRING, NUMBER, PARAM):
            self.ts.next()
            return
        if t.kind == PUNCT and t.value == "(":
            if self._looks_like_pattern():
                self._path()
                return
            self.ts.next()
            self._expression()
            self._expect(")", PUNCT)
            return
        if t.kind == PUNCT and t.value == "[":
            self._list_or_comprehension()
            return
        if t.kind == PUNCT and t.value == "{":
            self._map_literal()
            return
        if t.kind == IDENT:
            kw = t.upper()
            if kw in ("TRUE", "FALSE", "NULL"):
                self.ts.next()
                return
            if kw == "CASE":
                self._case()
                return
            if kw == "EXISTS" and self.ts.peek(1).kind == PUNCT \
                    and self.ts.peek(1).value == "(":
                self.ts.next()
                self._expect("(")
                if self._looks_like_pattern():
                    self._path()
                else:
                    self._expression()
                self._expect(")")
                return
            if (kw in ("ALL", "ANY", "NONE", "SINGLE")
                    and self.ts.peek(1).kind == PUNCT
                    and self.ts.peek(1).value == "("
                    and self.ts.peek(2).kind == IDENT
                    and self.ts.peek(3).kind == IDENT
                    and self.ts.peek(3).upper() == "IN"):
                self.ts.next()
                self._expect("(")
                self._name("variable")
                self._expect("IN")
                self._expression()
                if not self.ts.accept_kw("WHERE"):
                    self._err(f"{kw.lower()}() requires a WHERE predicate")
                self._expression()
                self._expect(")")
                return
            if kw == "REDUCE" and self.ts.peek(1).kind == PUNCT \
                    and self.ts.peek(1).value == "(":
                self.ts.next()
                self._expect("(")
                self._name("accumulator")
                self._expect("=", OP)
                self._expression()
                self._expect(",")
                self._name("variable")
                self._expect("IN")
                self._expression()
                self._expect("|", PUNCT)
                self._expression()
                self._expect(")")
                return
            if (kw in ("EXTRACT", "FILTER")
                    and self.ts.peek(1).kind == PUNCT
                    and self.ts.peek(1).value == "("
                    and self.ts.peek(2).kind == IDENT
                    and self.ts.peek(3).kind == IDENT
                    and self.ts.peek(3).upper() == "IN"):
                self.ts.next()
                self._expect("(")
                self._name("variable")
                self._expect("IN")
                self._expression()
                if kw == "FILTER":
                    if not self.ts.accept_kw("WHERE"):
                        self._err("filter() requires WHERE")
                    self._expression()
                else:
                    self._expect("|", PUNCT)
                    self._expression()
                self._expect(")")
                return
            if kw == "COUNT" and self.ts.peek(1).kind == PUNCT \
                    and self.ts.peek(1).value == "{":
                self.ts.next()
                self._expect("{")
                self._path()
                self._expect("}")
                return
            if kw in ("SHORTESTPATH", "ALLSHORTESTPATHS") \
                    and self.ts.peek(1).kind == PUNCT \
                    and self.ts.peek(1).value == "(":
                self.ts.next()
                self._expect("(")
                self._path()
                self._expect(")")
                return
            if self._is_func_call():
                self.ts.next()
                while self.ts.accept(".", PUNCT):
                    self._name("function name")
                self._expect("(")
                self.ts.accept_kw("DISTINCT")
                if self.ts.peek().kind == OP \
                        and self.ts.peek().value == "*":
                    self.ts.next()
                elif not (self.ts.peek().kind == PUNCT
                          and self.ts.peek().value == ")"):
                    self._expression()
                    while self.ts.accept(",", PUNCT):
                        self._expression()
                self._expect(")")
                return
            if kw in _RESERVED_NOT_NAMES:
                self._err(
                    f"expected an expression, got keyword {t.value!r}", t)
            self.ts.next()  # plain variable
            return
        self._err(f"expected an expression, got {t.value!r}", t)

    def _list_or_comprehension(self) -> None:
        self._expect("[", PUNCT)
        if self.ts.accept("]", PUNCT):
            return
        if (self.ts.peek().kind == IDENT
                and self.ts.peek(1).kind == IDENT
                and self.ts.peek(1).upper() == "IN"):
            self._name("variable")
            self.ts.next()  # IN
            self._expression()
            if self.ts.accept_kw("WHERE"):
                self._expression()
            if self.ts.accept("|", PUNCT):
                self._expression()
            self._expect("]", PUNCT)
            return
        self._expression()
        while self.ts.accept(",", PUNCT):
            self._expression()
        self._expect("]", PUNCT)

    def _case(self) -> None:
        self._expect("CASE")
        if not self.ts.peek_kw("WHEN"):
            self._expression()
        saw = False
        while self.ts.accept_kw("WHEN"):
            saw = True
            self._expression()
            self._expect("THEN")
            self._expression()
        if not saw:
            self._err("CASE requires at least one WHEN")
        if self.ts.accept_kw("ELSE"):
            self._expression()
        self._expect("END")

    # -- lookahead helpers ------------------------------------------------

    def _is_func_call(self) -> bool:
        j = 0
        if self.ts.peek(j).kind != IDENT:
            return False
        j += 1
        while self.ts.peek(j).kind == PUNCT and self.ts.peek(j).value == ".":
            if self.ts.peek(j + 1).kind != IDENT:
                return False
            j += 2
        return self.ts.peek(j).kind == PUNCT and self.ts.peek(j).value == "("

    def _looks_like_pattern(self) -> bool:
        ts = self.ts
        if not (ts.peek().kind == PUNCT and ts.peek().value == "("):
            return False
        j = 1
        if ts.peek(j).kind == IDENT:
            j += 1
        while ts.peek(j).kind == PUNCT and ts.peek(j).value == ":":
            if ts.peek(j + 1).kind != IDENT:
                return False
            j += 2
        if ts.peek(j).kind == PUNCT and ts.peek(j).value == "{":
            depth = 0
            while True:
                t = ts.peek(j)
                if t.kind == EOF:
                    return False
                if t.kind == PUNCT and t.value == "{":
                    depth += 1
                elif t.kind == PUNCT and t.value == "}":
                    depth -= 1
                    if depth == 0:
                        j += 1
                        break
                j += 1
        if not (ts.peek(j).kind == PUNCT and ts.peek(j).value == ")"):
            return False
        nxt = ts.peek(j + 1)
        if nxt.kind != OP:
            return False
        if nxt.value in ("<-", "<"):
            return True
        if nxt.value == "-":
            after = ts.peek(j + 2)
            return (after.kind == OP and after.value in ("-", "->")) or (
                after.kind == PUNCT and after.value == "[")
        return False


def parse(query: str) -> None:
    """Accept or raise StrictSyntaxError with line/col diagnostics."""
    StrictParser(query).parse()


def accepts(query: str) -> bool:
    try:
        parse(query)
        return True
    except CypherSyntaxError:
        return False
