"""Cypher parser: clauses, patterns, Pratt expression parsing
(counterpart of ``nornicdb_tpu/query/parser.py``).

Covers the clause surface the reference routes in
pkg/cypher/executor_internal.go: MATCH / OPTIONAL MATCH / WHERE / RETURN /
WITH / CREATE / MERGE / SET / REMOVE / DELETE / DETACH DELETE / UNWIND /
CALL ... YIELD / ORDER BY / SKIP / LIMIT / UNION [ALL].
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from nornicdb_tpu_torch.errors import CypherSyntaxError
from nornicdb_tpu_torch.query.ast import (
    Binary,
    CallClause,
    CaseExpr,
    Clause,
    CreateClause,
    DeleteClause,
    Exists,
    Expr,
    FuncCall,
    Index,
    IsNull,
    LabelCheck,
    ListComp,
    ListPredicate,
    Reduce,
    ListExpr,
    Literal,
    MapExpr,
    MatchClause,
    MergeClause,
    Param,
    PatternNode,
    PatternPath,
    PatternPredicate,
    PatternRel,
    Prop,
    ProjectionItem,
    Query,
    RemoveClause,
    ReturnClause,
    SetClause,
    SetItem,
    Slice,
    UnionQuery,
    Unary,
    UnwindClause,
    Var,
    WithClause,
)
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

_CLAUSE_STARTERS = {
    "MATCH", "OPTIONAL", "WHERE", "RETURN", "WITH", "CREATE", "MERGE",
    "SET", "REMOVE", "DELETE", "DETACH", "UNWIND", "CALL", "ORDER",
    "SKIP", "LIMIT", "UNION", "ON", "YIELD", "FOREACH", "USE",
}

_KEYWORD_LITERALS = {"TRUE": True, "FALSE": False, "NULL": None}


def parse(query: str) -> UnionQuery:
    ts = TokenStream(tokenize(query))
    parts: List[Query] = []
    alls: List[bool] = []
    while True:
        parts.append(_parse_single(ts))
        if ts.accept_kw("UNION"):
            alls.append(bool(ts.accept_kw("ALL")))
            continue
        break
    if not ts.at_end():
        t = ts.peek()
        raise CypherSyntaxError(f"unexpected token {t.value!r} at {t.pos}")
    return UnionQuery(parts=parts, alls=alls)


def _parse_single(ts: TokenStream) -> Query:
    clauses: List[Clause] = []
    while not ts.at_end() and not ts.peek_kw("UNION"):
        t = ts.peek()
        if t.kind == PUNCT and t.value == ";":
            ts.next()
            continue
        if t.kind != IDENT:
            raise CypherSyntaxError(f"expected clause, got {t.value!r} at {t.pos}")
        kw = t.upper()
        if kw == "MATCH":
            ts.next()
            clauses.append(_parse_match(ts, optional=False))
        elif kw == "OPTIONAL":
            ts.next()
            ts.expect("MATCH")
            clauses.append(_parse_match(ts, optional=True))
        elif kw == "CREATE":
            ts.next()
            clauses.append(CreateClause(paths=_parse_patterns(ts)))
        elif kw == "MERGE":
            ts.next()
            clauses.append(_parse_merge(ts))
        elif kw == "SET":
            ts.next()
            clauses.append(SetClause(items=_parse_set_items(ts)))
        elif kw == "REMOVE":
            ts.next()
            clauses.append(RemoveClause(items=_parse_remove_items(ts)))
        elif kw == "DELETE":
            ts.next()
            clauses.append(_parse_delete(ts, detach=False))
        elif kw == "DETACH":
            ts.next()
            ts.expect("DELETE")
            clauses.append(_parse_delete(ts, detach=True))
        elif kw == "UNWIND":
            ts.next()
            expr = parse_expression(ts)
            ts.expect("AS")
            var = ts.next().value
            clauses.append(UnwindClause(expr=expr, var=var))
        elif kw == "WITH":
            ts.next()
            clauses.append(_parse_projection(ts, is_return=False))
        elif kw == "RETURN":
            ts.next()
            clauses.append(_parse_projection(ts, is_return=True))
        elif kw == "CALL":
            ts.next()
            clauses.append(_parse_call(ts))
        elif kw == "WHERE":
            # stray WHERE after WITH (Cypher allows WITH ... WHERE ...)
            ts.next()
            cond = parse_expression(ts)
            if clauses and isinstance(clauses[-1], (WithClause, MatchClause)):
                clauses[-1].where = (
                    cond
                    if clauses[-1].where is None
                    else Binary("AND", clauses[-1].where, cond)
                )
            else:
                raise CypherSyntaxError("WHERE without MATCH/WITH")
        else:
            raise CypherSyntaxError(f"unsupported clause {kw!r} at {t.pos}")
    return Query(clauses=clauses)


# -- clause helpers ------------------------------------------------------


def _parse_match(ts: TokenStream, optional: bool) -> MatchClause:
    paths = _parse_patterns(ts)
    where = None
    if ts.accept_kw("WHERE"):
        where = parse_expression(ts)
    return MatchClause(paths=paths, optional=optional, where=where)


def _parse_merge(ts: TokenStream) -> MergeClause:
    paths = _parse_patterns(ts)
    if len(paths) != 1:
        raise CypherSyntaxError("MERGE takes a single pattern")
    clause = MergeClause(path=paths[0])
    while ts.peek_kw("ON"):
        ts.accept_kw("ON")
        if ts.accept_kw("CREATE"):
            ts.expect("SET")
            clause.on_create.extend(_parse_set_items(ts))
        elif ts.accept_kw("MATCH"):
            ts.expect("SET")
            clause.on_match.extend(_parse_set_items(ts))
        else:
            raise CypherSyntaxError("expected ON CREATE / ON MATCH")
    return clause


def _parse_delete(ts: TokenStream, detach: bool) -> DeleteClause:
    exprs = [parse_expression(ts)]
    while ts.accept(",", PUNCT):
        exprs.append(parse_expression(ts))
    return DeleteClause(exprs=exprs, detach=detach)


def _parse_set_items(ts: TokenStream) -> List[SetItem]:
    items: List[SetItem] = []
    while True:
        target = parse_expression(ts, stop_at_eq=True)
        if isinstance(target, LabelCheck):
            items.append(SetItem(target=None, value=None, labels=target.labels,
                                 merge_map=False))
            items[-1].target = Var(target.var)
        elif ts.accept("+=", OP):
            items.append(SetItem(target=target, value=parse_expression(ts),
                                 merge_map=True))
        elif ts.accept("=", OP):
            value = parse_expression(ts)
            if isinstance(target, Var):
                items.append(SetItem(target=target, value=value, replace_map=True))
            else:
                items.append(SetItem(target=target, value=value))
        else:
            raise CypherSyntaxError("expected = or += in SET")
        if not ts.accept(",", PUNCT):
            break
    return items


def _parse_remove_items(ts: TokenStream) -> List[SetItem]:
    items: List[SetItem] = []
    while True:
        target = parse_expression(ts, stop_at_eq=True)
        if isinstance(target, LabelCheck):
            items.append(SetItem(target=Var(target.var), value=None,
                                 labels=target.labels))
        else:
            items.append(SetItem(target=target, value=None))
        if not ts.accept(",", PUNCT):
            break
    return items


def _parse_projection(ts: TokenStream, is_return: bool):
    distinct = bool(ts.accept_kw("DISTINCT"))
    star = False
    items: List[ProjectionItem] = []
    if ts.peek().kind == OP and ts.peek().value == "*":
        ts.next()
        star = True
        if ts.accept(",", PUNCT):
            items.extend(_parse_projection_items(ts))
    else:
        items.extend(_parse_projection_items(ts))
    order_by: List[Tuple[Expr, bool]] = []
    skip = limit = None
    where = None
    if ts.accept_kw("ORDER"):
        ts.expect("BY")
        while True:
            e = parse_expression(ts)
            desc = False
            if ts.accept_kw("DESC") or ts.accept_kw("DESCENDING"):
                desc = True
            elif ts.accept_kw("ASC") or ts.accept_kw("ASCENDING"):
                desc = False
            order_by.append((e, desc))
            if not ts.accept(",", PUNCT):
                break
    if ts.accept_kw("SKIP"):
        skip = parse_expression(ts)
    if ts.accept_kw("LIMIT"):
        limit = parse_expression(ts)
    if not is_return and ts.accept_kw("WHERE"):
        where = parse_expression(ts)
    if is_return:
        return ReturnClause(items=items, distinct=distinct, star=star,
                            order_by=order_by, skip=skip, limit=limit)
    return WithClause(items=items, distinct=distinct, star=star, where=where,
                      order_by=order_by, skip=skip, limit=limit)


def _expr_text(ts: TokenStream, start: int) -> str:
    toks = ts.toks[start : ts.i]
    return " ".join(t.value for t in toks)


def _parse_projection_items(ts: TokenStream) -> List[ProjectionItem]:
    items = []
    while True:
        start = ts.i
        e = parse_expression(ts)
        alias = None
        if ts.accept_kw("AS"):
            alias = ts.next().value
        items.append(ProjectionItem(expr=e, alias=alias, text=_expr_text(ts, start)))
        if not ts.accept(",", PUNCT):
            break
    return items


def _parse_call(ts: TokenStream) -> CallClause:
    # procedure name: dotted identifiers
    name_parts = [ts.next().value]
    while ts.accept(".", PUNCT):
        name_parts.append(ts.next().value)
    proc = ".".join(name_parts)
    args: List[Expr] = []
    if ts.accept("(", PUNCT):
        if not ts.accept(")", PUNCT):
            while True:
                args.append(parse_expression(ts))
                if not ts.accept(",", PUNCT):
                    break
            ts.expect(")")
    clause = CallClause(proc=proc.lower(), args=args)
    if ts.accept_kw("YIELD"):
        if ts.peek().kind == OP and ts.peek().value == "*":
            ts.next()
            clause.yield_star = True
        else:
            while True:
                name = ts.next().value
                alias = None
                if ts.accept_kw("AS"):
                    alias = ts.next().value
                clause.yield_items.append((name, alias))
                if not ts.accept(",", PUNCT):
                    break
        if ts.accept_kw("WHERE"):
            clause.where = parse_expression(ts)
    return clause


# -- patterns ------------------------------------------------------------


def _parse_patterns(ts: TokenStream) -> List[PatternPath]:
    paths = [_parse_path(ts)]
    while ts.accept(",", PUNCT):
        paths.append(_parse_path(ts))
    return paths


def _parse_path(ts: TokenStream) -> PatternPath:
    path_var = None
    # p = (...)
    if (
        ts.peek().kind == IDENT
        and ts.peek().upper() not in _CLAUSE_STARTERS
        and ts.peek(1).kind == OP
        and ts.peek(1).value == "="
        and (
            (ts.peek(2).kind == PUNCT and ts.peek(2).value == "(")
            or (ts.peek(2).kind == IDENT
                and ts.peek(2).upper() in ("SHORTESTPATH",
                                           "ALLSHORTESTPATHS")
                and ts.peek(3).kind == PUNCT and ts.peek(3).value == "(")
        )
    ):
        path_var = ts.next().value
        ts.next()  # =
    # MATCH-position shortestPath((a)-[*]-(b)) — endpoints may be
    # UNBOUND here (the executor scans candidates and runs BFS per
    # pair); the expression-position form still parses as a FuncCall
    if (
        ts.peek().kind == IDENT
        and ts.peek().upper() in ("SHORTESTPATH", "ALLSHORTESTPATHS")
        and ts.peek(1).kind == PUNCT and ts.peek(1).value == "("
    ):
        kind = "single" if ts.peek().upper() == "SHORTESTPATH" else "all"
        ts.next()
        ts.expect("(")
        inner = _parse_path(ts)
        ts.expect(")")
        inner.path_var = path_var
        inner.shortest = kind
        return inner
    nodes = [_parse_pattern_node(ts)]
    rels: List[PatternRel] = []
    while True:
        t = ts.peek()
        if t.kind == OP and t.value in ("-", "<-"):
            rels.append(_parse_pattern_rel(ts))
            nodes.append(_parse_pattern_node(ts))
        elif t.kind == OP and t.value == "<":
            rels.append(_parse_pattern_rel(ts))
            nodes.append(_parse_pattern_node(ts))
        else:
            break
    return PatternPath(nodes=nodes, rels=rels, path_var=path_var)


def _parse_pattern_node(ts: TokenStream) -> PatternNode:
    ts.expect("(")
    var = None
    labels: List[str] = []
    props = None
    if ts.peek().kind == IDENT:
        var = ts.next().value
    while ts.accept(":", PUNCT):
        labels.append(ts.next().value)
    if ts.peek().kind == PUNCT and ts.peek().value == "{":
        props = _parse_map(ts)
    ts.expect(")")
    return PatternNode(var=var, labels=labels, props=props)


def _parse_pattern_rel(ts: TokenStream) -> PatternRel:
    rel = PatternRel(var=None)
    t = ts.next()  # '-', '<-' or '<'
    incoming = False
    if t.value == "<-":
        incoming = True
    elif t.value == "<":
        ts.expect("-", OP)
        incoming = True
    if ts.accept("[", PUNCT):
        if ts.peek().kind == IDENT:
            rel.var = ts.next().value
        if ts.accept(":", PUNCT):
            rel.types.append(ts.next().value)
            while ts.accept("|", PUNCT):
                ts.accept(":", PUNCT)  # allow |:TYPE legacy syntax
                rel.types.append(ts.next().value)
        if ts.peek().kind == OP and ts.peek().value == "*":
            ts.next()
            rel.min_hops, rel.max_hops = 1, -1
            if ts.peek().kind == NUMBER:
                rel.min_hops = int(ts.next().value)
                rel.max_hops = rel.min_hops
                if ts.accept("..", OP):
                    if ts.peek().kind == NUMBER:
                        rel.max_hops = int(ts.next().value)
                    else:
                        rel.max_hops = -1
            elif ts.accept("..", OP):
                rel.min_hops = 1
                if ts.peek().kind == NUMBER:
                    rel.max_hops = int(ts.next().value)
                else:
                    rel.max_hops = -1
        if ts.peek().kind == PUNCT and ts.peek().value == "{":
            rel.props = _parse_map(ts)
        ts.expect("]")
    # closing direction
    if incoming:
        ts.expect("-", OP)
        rel.direction = "in"
    else:
        nxt = ts.next()
        if nxt.kind == OP and nxt.value == "->":
            rel.direction = "out"
        elif nxt.kind == OP and nxt.value == "-":
            rel.direction = "both"
        else:
            raise CypherSyntaxError(f"bad relationship direction at {nxt.pos}")
    return rel


def _parse_map(ts: TokenStream) -> MapExpr:
    ts.expect("{")
    items: List[Tuple[str, Expr]] = []
    if not ts.accept("}", PUNCT):
        while True:
            key_tok = ts.next()
            if key_tok.kind not in (IDENT, STRING):
                raise CypherSyntaxError(f"bad map key at {key_tok.pos}")
            ts.expect(":")
            items.append((key_tok.value, parse_expression(ts)))
            if not ts.accept(",", PUNCT):
                break
        ts.expect("}")
    return MapExpr(items=items)


# -- expressions (Pratt) -------------------------------------------------

_BINARY_PRECEDENCE = {
    "OR": 1,
    "XOR": 2,
    "AND": 3,
    "=": 5, "<>": 5, "<": 5, "<=": 5, ">": 5, ">=": 5, "=~": 5,
    "IN": 5, "STARTS": 5, "ENDS": 5, "CONTAINS": 5,
    "+": 6, "-": 6,
    "*": 7, "/": 7, "%": 7,
    "^": 8,
}


def parse_expression(ts: TokenStream, min_prec: int = 0, stop_at_eq: bool = False) -> Expr:
    left = _parse_unary(ts, stop_at_eq)
    while True:
        t = ts.peek()
        op = None
        if t.kind == OP and t.value in _BINARY_PRECEDENCE:
            if stop_at_eq and t.value == "=":
                break
            op = t.value
        elif t.kind == IDENT:
            kw = t.upper()
            if kw in ("AND", "OR", "XOR", "IN", "CONTAINS"):
                op = kw
            elif kw == "STARTS" and ts.peek(1).kind == IDENT and ts.peek(1).upper() == "WITH":
                op = "STARTS"
            elif kw == "ENDS" and ts.peek(1).kind == IDENT and ts.peek(1).upper() == "WITH":
                op = "ENDS"
            elif kw == "IS":
                # IS NULL / IS NOT NULL
                save = ts.i
                ts.next()
                negated = bool(ts.accept_kw("NOT"))
                if ts.accept_kw("NULL"):
                    left = IsNull(operand=left, negated=negated)
                    continue
                ts.i = save
                break
            else:
                break
        else:
            break
        prec = _BINARY_PRECEDENCE[op]
        if prec < min_prec:
            break
        ts.next()
        if op in ("STARTS", "ENDS"):
            ts.expect("WITH")
            op = op + " WITH"
        right = parse_expression(ts, prec + 1, stop_at_eq)
        left = Binary(op=op, left=left, right=right)
    return left


def _parse_unary(ts: TokenStream, stop_at_eq: bool = False) -> Expr:
    t = ts.peek()
    if t.kind == IDENT and t.upper() == "NOT":
        ts.next()
        return Unary("NOT", _parse_unary(ts, stop_at_eq))
    if t.kind == OP and t.value in ("-", "+"):
        ts.next()
        return Unary(t.value, _parse_unary(ts, stop_at_eq))
    return _parse_postfix(ts, stop_at_eq)


def _parse_postfix(ts: TokenStream, stop_at_eq: bool = False) -> Expr:
    e = _parse_atom(ts, stop_at_eq)
    while True:
        t = ts.peek()
        if t.kind == PUNCT and t.value == ".":
            ts.next()
            name = ts.next().value
            e = Prop(target=e, name=name)
        elif t.kind == PUNCT and t.value == "[":
            ts.next()
            # index or slice
            start = None
            if not (ts.peek().kind == OP and ts.peek().value == ".."):
                start = parse_expression(ts)
            if ts.accept("..", OP):
                end = None
                if not (ts.peek().kind == PUNCT and ts.peek().value == "]"):
                    end = parse_expression(ts)
                e = Slice(target=e, start=start, end=end)
            else:
                e = Index(target=e, index=start)
            ts.expect("]")
        elif (
            t.kind == PUNCT
            and t.value == ":"
            and isinstance(e, Var)
        ):
            # label predicate n:Label[:Label2]
            labels = []
            while ts.accept(":", PUNCT):
                labels.append(ts.next().value)
            e = LabelCheck(var=e.name, labels=labels)
        else:
            break
    return e


def _parse_atom(ts: TokenStream, stop_at_eq: bool = False) -> Expr:
    t = ts.peek()
    if t.kind == STRING:
        ts.next()
        return Literal(t.value)
    if t.kind == NUMBER:
        ts.next()
        v = t.value
        if v.startswith("0x"):
            return Literal(int(v, 16))
        if "." in v or "e" in v or "E" in v:
            return Literal(float(v))
        return Literal(int(v))
    if t.kind == PARAM:
        ts.next()
        return Param(t.value)
    if t.kind == PUNCT and t.value == "(":
        # parenthesized expr OR pattern predicate (a)-[:X]->(b)
        if _looks_like_pattern(ts):
            path = _parse_path(ts)
            return PatternPredicate(pattern=path)
        ts.next()
        e = parse_expression(ts)
        ts.expect(")")
        return e
    if t.kind == PUNCT and t.value == "[":
        # list literal or list comprehension
        ts.next()
        if ts.peek().kind == PUNCT and ts.peek().value == "]":
            ts.next()
            return ListExpr(items=[])
        # try comprehension: IDENT IN expr [WHERE ...] [| expr]
        if (
            ts.peek().kind == IDENT
            and ts.peek(1).kind == IDENT
            and ts.peek(1).upper() == "IN"
        ):
            var = ts.next().value
            ts.next()  # IN
            source = parse_expression(ts)
            where = None
            proj = None
            if ts.accept_kw("WHERE"):
                where = parse_expression(ts)
            if ts.accept("|", PUNCT):
                proj = parse_expression(ts)
            ts.expect("]")
            return ListComp(var=var, source=source, where=where, projection=proj)
        items = [parse_expression(ts)]
        while ts.accept(",", PUNCT):
            items.append(parse_expression(ts))
        ts.expect("]")
        return ListExpr(items=items)
    if t.kind == PUNCT and t.value == "{":
        return _parse_map(ts)
    if t.kind == IDENT:
        kw = t.upper()
        if kw in _KEYWORD_LITERALS:
            ts.next()
            return Literal(_KEYWORD_LITERALS[kw])
        if kw == "CASE":
            return _parse_case(ts)
        if kw == "EXISTS":
            save = ts.i
            ts.next()
            if ts.peek().kind == PUNCT and ts.peek().value == "(":
                ts.next()
                if _looks_like_pattern(ts):
                    path = _parse_path(ts)
                    ts.expect(")")
                    return Exists(pattern=path, prop=None)
                inner = parse_expression(ts)
                ts.expect(")")
                return Exists(pattern=None, prop=inner)
            ts.i = save
        if (
            kw in ("ALL", "ANY", "NONE", "SINGLE")
            and ts.peek(1).kind == PUNCT and ts.peek(1).value == "("
            and ts.peek(2).kind == IDENT
            and ts.peek(3).kind == IDENT and ts.peek(3).upper() == "IN"
        ):
            # all/any/none/single(x IN list WHERE pred)
            ts.next()  # keyword
            ts.expect("(")
            var = ts.next().value
            ts.next()  # IN
            source = parse_expression(ts)
            if not ts.accept_kw("WHERE"):
                raise CypherSyntaxError(f"{kw.lower()}() requires WHERE")
            where = parse_expression(ts)
            ts.expect(")")
            return ListPredicate(kind=kw.lower(), var=var, source=source,
                                 where=where)
        if kw == "REDUCE" and ts.peek(1).kind == PUNCT and ts.peek(1).value == "(":
            # reduce(acc = init, x IN list | expr)
            ts.next()
            ts.expect("(")
            acc = ts.next().value
            if not (ts.peek().kind == OP and ts.peek().value == "="):
                raise CypherSyntaxError("reduce() expects acc = init")
            ts.next()
            init = parse_expression(ts)
            ts.expect(",")
            var = ts.next().value
            if not (ts.peek().kind == IDENT and ts.peek().upper() == "IN"):
                raise CypherSyntaxError("reduce() expects `x IN list`")
            ts.next()
            source = parse_expression(ts)
            if not ts.accept("|", PUNCT):
                raise CypherSyntaxError("reduce() expects `| expr`")
            expr = parse_expression(ts)
            ts.expect(")")
            return Reduce(acc=acc, init=init, var=var, source=source, expr=expr)
        if (
            kw in ("EXTRACT", "FILTER")
            and ts.peek(1).kind == PUNCT and ts.peek(1).value == "("
            and ts.peek(2).kind == IDENT
            and ts.peek(3).kind == IDENT and ts.peek(3).upper() == "IN"
        ):
            # legacy forms (reference functions_eval_math.go:1388):
            # extract(x IN list | expr), filter(x IN list WHERE pred) —
            # sugar for list comprehensions
            ts.next()
            ts.expect("(")
            var = ts.next().value
            ts.next()  # IN
            source = parse_expression(ts)
            where = None
            proj = None
            if kw == "FILTER":
                if not ts.accept_kw("WHERE"):
                    raise CypherSyntaxError("filter() requires WHERE")
                where = parse_expression(ts)
            else:
                if not ts.accept("|", PUNCT):
                    raise CypherSyntaxError("extract() expects `| expr`")
                proj = parse_expression(ts)
            ts.expect(")")
            return ListComp(var=var, source=source, where=where,
                            projection=proj)
        if kw == "COUNT" and ts.peek(1).kind == PUNCT and ts.peek(1).value == "{":
            # COUNT { (n)--() } subquery-count — parse pattern inside
            ts.next()
            ts.expect("{")
            path = _parse_path(ts)
            ts.expect("}")
            return FuncCall(name="__pattern_count__", args=[PatternPredicate(path)])
        # function call: name(...) possibly dotted
        if _is_func_call(ts):
            name_parts = [ts.next().value]
            while ts.accept(".", PUNCT):
                name_parts.append(ts.next().value)
            ts.expect("(")
            distinct = bool(ts.accept_kw("DISTINCT"))
            star = False
            args: List[Expr] = []
            if ts.peek().kind == OP and ts.peek().value == "*":
                ts.next()
                star = True
            elif not (ts.peek().kind == PUNCT and ts.peek().value == ")"):
                args.append(parse_expression(ts))
                while ts.accept(",", PUNCT):
                    args.append(parse_expression(ts))
            ts.expect(")")
            return FuncCall(name=".".join(name_parts).lower(), args=args,
                            distinct=distinct, star=star)
        ts.next()
        return Var(t.value)
    raise CypherSyntaxError(f"unexpected token {t.value!r} at {t.pos}")


def _is_func_call(ts: TokenStream) -> bool:
    """IDENT (.IDENT)* ( — lookahead."""
    j = 0
    if ts.peek(j).kind != IDENT:
        return False
    j += 1
    while ts.peek(j).kind == PUNCT and ts.peek(j).value == ".":
        if ts.peek(j + 1).kind != IDENT:
            return False
        j += 2
    return ts.peek(j).kind == PUNCT and ts.peek(j).value == "("


def _looks_like_pattern(ts: TokenStream) -> bool:
    """At '(' — does this start a NODE pattern followed by a relationship?
    The group's contents must have node-pattern shape ([var][:Label...]
    [{props}]) — '(1+2)-(3)' is arithmetic, not a pattern — and the matching
    ')' must be followed by a rel arrow."""
    if not (ts.peek().kind == PUNCT and ts.peek().value == "("):
        return False
    j = 1
    # optional variable
    if ts.peek(j).kind == IDENT:
        j += 1
    # optional :Label chain
    while ts.peek(j).kind == PUNCT and ts.peek(j).value == ":":
        if ts.peek(j + 1).kind != IDENT:
            return False
        j += 2
    # optional props map — skip balanced braces
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
        # '(a)-(b)' is subtraction; a pattern needs '--', '-[' or '-->'
        after = ts.peek(j + 2)
        return (after.kind == OP and after.value in ("-", "->")) or (
            after.kind == PUNCT and after.value == "["
        )
    return False


def _parse_case(ts: TokenStream) -> CaseExpr:
    ts.expect("CASE")
    subject = None
    if not ts.peek_kw("WHEN"):
        subject = parse_expression(ts)
    whens: List[Tuple[Expr, Expr]] = []
    while ts.accept_kw("WHEN"):
        cond = parse_expression(ts)
        ts.expect("THEN")
        val = parse_expression(ts)
        whens.append((cond, val))
    default = None
    if ts.accept_kw("ELSE"):
        default = parse_expression(ts)
    ts.expect("END")
    return CaseExpr(subject=subject, whens=whens, default=default)
