"""Cypher AST node types (expressions, patterns, clauses); counterpart
of ``nornicdb_tpu/query/ast.py``."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


# -- expressions ---------------------------------------------------------


@dataclass
class Expr:
    pass


@dataclass
class Literal(Expr):
    value: Any


@dataclass
class Param(Expr):
    name: str


@dataclass
class Var(Expr):
    name: str


@dataclass
class Prop(Expr):
    target: Expr
    name: str


@dataclass
class ListExpr(Expr):
    items: List[Expr]


@dataclass
class MapExpr(Expr):
    items: List[Tuple[str, Expr]]


@dataclass
class Unary(Expr):
    op: str  # 'NOT', '-', '+'
    operand: Expr


@dataclass
class Binary(Expr):
    op: str  # '=','<>','<','<=','>','>=','+','-','*','/','%','^','AND','OR',
    # 'XOR','IN','STARTS WITH','ENDS WITH','CONTAINS','=~'
    left: Expr
    right: Expr


@dataclass
class IsNull(Expr):
    operand: Expr
    negated: bool


@dataclass
class FuncCall(Expr):
    name: str  # lowercase, may be dotted (apoc.coll.sum)
    args: List[Expr]
    distinct: bool = False
    star: bool = False  # count(*)


@dataclass
class CaseExpr(Expr):
    subject: Optional[Expr]  # CASE <subject> WHEN ... / CASE WHEN ...
    whens: List[Tuple[Expr, Expr]]
    default: Optional[Expr]


@dataclass
class Index(Expr):
    target: Expr
    index: Expr


@dataclass
class Slice(Expr):
    target: Expr
    start: Optional[Expr]
    end: Optional[Expr]


@dataclass
class ListComp(Expr):
    var: str
    source: Expr
    where: Optional[Expr]
    projection: Optional[Expr]


@dataclass
class ListPredicate(Expr):
    """all/any/none/single(x IN list WHERE pred)."""

    kind: str  # 'all' | 'any' | 'none' | 'single'
    var: str
    source: Expr
    where: Expr


@dataclass
class Reduce(Expr):
    """reduce(acc = init, x IN list | expr)."""

    acc: str
    init: Expr
    var: str
    source: Expr
    expr: Expr


@dataclass
class PatternPredicate(Expr):
    """A bare pattern used as a boolean predicate: WHERE (a)-[:KNOWS]->(b)."""

    pattern: "PatternPath"


@dataclass
class Exists(Expr):
    """EXISTS((a)-[:X]->()) or exists(n.prop)."""

    pattern: Optional["PatternPath"]
    prop: Optional[Expr]


@dataclass
class LabelCheck(Expr):
    """n:Label predicate."""

    var: str
    labels: List[str]


# -- patterns ------------------------------------------------------------


@dataclass
class PatternNode:
    var: Optional[str]
    labels: List[str] = field(default_factory=list)
    props: Optional[MapExpr] = None


@dataclass
class PatternRel:
    var: Optional[str]
    types: List[str] = field(default_factory=list)
    direction: str = "both"  # 'out' | 'in' | 'both'
    min_hops: int = 1
    max_hops: int = 1  # -1 == unbounded
    props: Optional[MapExpr] = None


@dataclass
class PatternPath:
    """Alternating nodes/rels: nodes[0] -rels[0]- nodes[1] ..."""

    nodes: List[PatternNode]
    rels: List[PatternRel]
    path_var: Optional[str] = None  # p = (a)-[]->(b)
    # MATCH p = shortestPath((a)-[*]-(b)): 'single' | 'all' | None
    shortest: Optional[str] = None


# -- clauses -------------------------------------------------------------


@dataclass
class Clause:
    pass


@dataclass
class MatchClause(Clause):
    paths: List[PatternPath]
    optional: bool = False
    where: Optional[Expr] = None


@dataclass
class UnwindClause(Clause):
    expr: Expr
    var: str


@dataclass
class ProjectionItem:
    expr: Expr
    alias: Optional[str]
    text: str  # original text for column naming


@dataclass
class WithClause(Clause):
    items: List[ProjectionItem]
    distinct: bool = False
    star: bool = False  # WITH *
    where: Optional[Expr] = None
    order_by: List[Tuple[Expr, bool]] = field(default_factory=list)  # (expr, desc)
    skip: Optional[Expr] = None
    limit: Optional[Expr] = None


@dataclass
class ReturnClause(Clause):
    items: List[ProjectionItem]
    distinct: bool = False
    star: bool = False
    order_by: List[Tuple[Expr, bool]] = field(default_factory=list)
    skip: Optional[Expr] = None
    limit: Optional[Expr] = None


@dataclass
class CreateClause(Clause):
    paths: List[PatternPath]


@dataclass
class MergeClause(Clause):
    path: PatternPath
    on_create: List["SetItem"] = field(default_factory=list)
    on_match: List["SetItem"] = field(default_factory=list)


@dataclass
class SetItem:
    target: Optional[Expr]  # Prop target or Var for map-set / labels
    value: Optional[Expr]
    labels: List[str] = field(default_factory=list)  # SET n:Label
    merge_map: bool = False  # SET n += {..}
    replace_map: bool = False  # SET n = {..}


@dataclass
class SetClause(Clause):
    items: List[SetItem]


@dataclass
class RemoveClause(Clause):
    items: List[SetItem]  # prop targets or labels


@dataclass
class DeleteClause(Clause):
    exprs: List[Expr]
    detach: bool = False


@dataclass
class CallClause(Clause):
    proc: str
    args: List[Expr]
    yield_items: List[Tuple[str, Optional[str]]] = field(default_factory=list)
    yield_star: bool = False
    where: Optional[Expr] = None


@dataclass
class Query:
    clauses: List[Clause]
    params_used: List[str] = field(default_factory=list)


@dataclass
class UnionQuery:
    parts: List[Query]
    alls: List[bool] = field(default_factory=list)  # UNION vs UNION ALL
