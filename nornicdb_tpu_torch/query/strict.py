"""Strict diagnostic parser mode (counterpart of
``nornicdb_tpu/query/strict.py``).

Reference: pkg/cypher/antlr/ — the reference runs a second, full
OpenCypher ANTLR parser for strict validation with line/column
diagnostics (73-4,753x slower than the nornic fast path;
docs/architecture/cypher-parser-modes.md), selected by
NORNICDB_PARSER. This diagnostic mode runs a genuine second
parser: a grammar-complete recursive-descent implementation
(strict_grammar.py) enforcing the clause-order/shape rules the fast
parser skips on the hot path, then layers semantic validation on the
fast parser's AST — undefined variables, aggregates in WHERE, unknown
functions/procedures — all with line/col diagnostics.

Executor wiring: ``CypherExecutor(parser_mode="strict")`` (or the
NORNICDB_TPU_PARSER env var) validates every query before execution and
raises with diagnostics; parity with the fast path is covered by
tests/test_torch_strict.py against the reference (the same diagnostics
on its corpus).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Set

from nornicdb_tpu_torch.errors import CypherSyntaxError
from nornicdb_tpu_torch.query import ast as A


@dataclass
class Diagnostic:
    severity: str  # 'error' | 'warning'
    message: str
    line: int = 1
    column: int = 1

    def __str__(self):
        return f"{self.severity} at {self.line}:{self.column}: {self.message}"


def _line_col(text: str, pos: int) -> tuple:
    upto = text[:pos]
    line = upto.count("\n") + 1
    col = pos - (upto.rfind("\n") + 1) + 1
    return line, col


_AGG = {"count", "sum", "avg", "min", "max", "collect", "stdev", "stdevp",
        "percentilecont", "percentiledisc"}


def _is_agg(name: str) -> bool:
    return name in _AGG or name.startswith("apoc.agg.")


def validate(query: str) -> List[Diagnostic]:
    """Full-strictness validation; empty list = clean.

    Two passes, mirroring the reference's ANTLR mode:
    1. grammar: the independent strict parser (strict_grammar.py) —
       clause order, UNION mixing, pagination types, pattern shape —
       the class of syntax errors the fast parser tolerates;
    2. semantics: undefined variables, aggregates in WHERE, unknown
       functions, over the fast parser's AST."""
    from nornicdb_tpu_torch.query.parser import parse
    from nornicdb_tpu_torch.query.strict_grammar import StrictParser, \
        StrictSyntaxError

    diags: List[Diagnostic] = []
    try:
        StrictParser(query).parse()
    except StrictSyntaxError as e:
        diags.append(Diagnostic("error", e.bare_message, e.line, e.column))
        return diags
    except CypherSyntaxError as e:
        diags.append(Diagnostic("error", str(e)))
        return diags
    try:
        uq = parse(query)
    except CypherSyntaxError as e:
        msg = str(e)
        line, col = 1, 1
        # fast-parser errors embed the byte offset ("... at 17")
        import re

        m = re.search(r" at (\d+)$", msg)
        if m:
            line, col = _line_col(query, int(m.group(1)))
        diags.append(Diagnostic("error", msg, line, col))
        return diags
    for part in uq.parts:
        diags.extend(_validate_query(part))
    return diags


def _validate_query(q: A.Query) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    bound: Set[str] = set()

    def bind_path(path: A.PatternPath) -> None:
        for n in path.nodes:
            if n.var:
                bound.add(n.var)
        for r in path.rels:
            if r.var:
                bound.add(r.var)
        if path.path_var:
            bound.add(path.path_var)

    def check_expr(e: Optional[A.Expr], where: str,
                   local: Optional[Set[str]] = None,
                   allow_agg: bool = False) -> None:
        if e is None:
            return
        scope = bound | (local or set())
        if isinstance(e, A.Var):
            # "*" marks an open scope (CALL ... YIELD * / WITH * after a
            # procedure): yielded columns are unknowable statically
            if e.name not in scope and "*" not in scope:
                diags.append(Diagnostic(
                    "error", f"variable `{e.name}` not defined ({where})"))
            return
        if isinstance(e, A.FuncCall):
            if _is_agg(e.name) and not allow_agg:
                diags.append(Diagnostic(
                    "error",
                    f"aggregate {e.name}() is not allowed in {where}"))
            elif not _is_agg(e.name) and not _known_function(e.name):
                diags.append(Diagnostic(
                    "warning", f"unknown function {e.name}()"))
            for a in e.args:
                check_expr(a, where, local, allow_agg=False)
            return
        if isinstance(e, (A.ListComp,)):
            check_expr(e.source, where, local)
            inner = (local or set()) | {e.var}
            check_expr(e.where, where, inner)
            check_expr(e.projection, where, inner)
            return
        if isinstance(e, A.ListPredicate):
            check_expr(e.source, where, local)
            check_expr(e.where, where, (local or set()) | {e.var})
            return
        if isinstance(e, A.Reduce):
            check_expr(e.init, where, local)
            check_expr(e.source, where, local)
            check_expr(e.expr, where, (local or set()) | {e.acc, e.var})
            return
        if isinstance(e, (A.PatternPredicate, A.Exists)):
            return  # patterns bind their own scope
        import dataclasses

        if dataclasses.is_dataclass(e) and not isinstance(e, type):
            for f in dataclasses.fields(e):
                v = getattr(e, f.name)
                if isinstance(v, A.Expr):
                    check_expr(v, where, local, allow_agg=allow_agg)
                elif isinstance(v, (list, tuple)):
                    for x in v:
                        if isinstance(x, A.Expr):
                            check_expr(x, where, local, allow_agg=allow_agg)
                        elif isinstance(x, tuple):
                            for y in x:
                                if isinstance(y, A.Expr):
                                    check_expr(y, where, local,
                                               allow_agg=allow_agg)

    for clause in q.clauses:
        if isinstance(clause, A.MatchClause):
            for p in clause.paths:
                bind_path(p)
            check_expr(clause.where, "WHERE")
        elif isinstance(clause, (A.CreateClause,)):
            for p in clause.paths:
                for pr in p.rels:
                    if not pr.types:
                        diags.append(Diagnostic(
                            "error",
                            "CREATE requires a relationship type"))
                    if pr.min_hops != 1 or pr.max_hops != 1:
                        diags.append(Diagnostic(
                            "error",
                            "CREATE cannot use variable-length patterns"))
                bind_path(p)
        elif isinstance(clause, A.MergeClause):
            bind_path(clause.path)
        elif isinstance(clause, A.UnwindClause):
            check_expr(clause.expr, "UNWIND")
            bound.add(clause.var)
        elif isinstance(clause, (A.WithClause, A.ReturnClause)):
            for item in clause.items:
                check_expr(item.expr, "projection", allow_agg=True)
            for expr, _desc in clause.order_by:
                pass  # ORDER BY may reference aliases; skip
            if isinstance(clause, A.WithClause):
                new_scope = set()
                if clause.star:
                    new_scope |= bound
                elif "*" in bound:
                    new_scope.add("*")  # open scope survives projection
                for item in clause.items:
                    if item.alias:
                        new_scope.add(item.alias)
                    elif isinstance(item.expr, A.Var):
                        new_scope.add(item.expr.name)
                bound.clear()
                bound.update(new_scope)
                check_expr(clause.where, "WHERE")
        elif isinstance(clause, A.SetClause):
            for item in clause.items:
                check_expr(item.target, "SET")
                check_expr(item.value, "SET")
        elif isinstance(clause, A.DeleteClause):
            for e in clause.exprs:
                check_expr(e, "DELETE")
        elif isinstance(clause, A.CallClause):
            for a in clause.args:
                check_expr(a, "CALL arguments")
            for name, alias in clause.yield_items:
                bound.add(alias or name)
            if clause.yield_star:
                bound.add("*")
    return diags


def _known_function(name: str) -> bool:
    from nornicdb_tpu_torch.query.apoc import lookup_apoc, lookup_apoc_ctx
    from nornicdb_tpu_torch.query.functions import lookup

    if (lookup(name) is not None or lookup_apoc(name) is not None
            or lookup_apoc_ctx(name) is not None):
        return True
    if name.startswith("apoc.agg."):
        from nornicdb_tpu_torch.query.apoc_bulk import AGG_FINALIZERS

        return name in AGG_FINALIZERS
    return name in ("exists", "shortestpath", "allshortestpaths",
                    "degree", "indegree", "outdegree", "__pattern_count__")


def assert_valid(query: str) -> None:
    """Raise CypherSyntaxError listing every error diagnostic."""
    errors = [d for d in validate(query) if d.severity == "error"]
    if errors:
        raise CypherSyntaxError("; ".join(str(d) for d in errors))
