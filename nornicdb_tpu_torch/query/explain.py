"""EXPLAIN / PROFILE: plan-tree construction and db-hit accounting
(counterpart of ``nornicdb_tpu/query/explain.py``).

Reference: pkg/cypher/explain.go:95,110 (executeExplain/executeProfile) and
explain.go:149 (buildExecutionPlan) — a plan tree derived from the parsed
query with estimated-row counts from storage statistics; PROFILE executes
the query through a db-hit-counting storage proxy and reports actuals.

The plan is returned both as rows (operator table, the way `EXPLAIN`
renders in a shell) and as a nested dict on `CypherResult.plan` for
drivers that want the tree.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from nornicdb_tpu_torch.query import ast as A
from nornicdb_tpu_torch.storage.types import Engine


@dataclass
class PlanNode:
    operator: str
    details: str = ""
    estimated_rows: int = 0
    db_hits: int = 0
    actual_rows: int = 0
    children: List["PlanNode"] = field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "operator": self.operator,
            "details": self.details,
            "estimated_rows": self.estimated_rows,
            "db_hits": self.db_hits,
            "actual_rows": self.actual_rows,
            "children": [c.to_dict() for c in self.children],
        }

    def flatten(self, depth: int = 0) -> List[Tuple[int, "PlanNode"]]:
        out = [(depth, self)]
        for c in self.children:
            out.extend(c.flatten(depth + 1))
        return out


class CountingEngine:
    """Delegating storage proxy that counts db hits for PROFILE
    (reference: explain.go db-hit accounting on the operator tree)."""

    _READS = {
        "get_node", "get_edge", "get_nodes_by_label", "get_edges_by_type",
        "all_nodes", "all_edges", "get_node_edges", "neighbors", "degree",
        "batch_get_nodes", "has_node", "has_edge", "count_nodes",
        "count_edges", "count_nodes_by_label", "count_nodes_with_prefix",
        "count_edges_with_prefix",
    }
    _WRITES = {
        "create_node", "update_node", "delete_node", "create_edge",
        "update_edge", "delete_edge", "delete_by_prefix",
    }

    def __init__(self, inner: Engine):
        self._inner = inner
        self.hits = 0

    def __getattr__(self, name: str):
        attr = getattr(self._inner, name)
        if name in self._READS or name in self._WRITES:
            def counted(*args, **kwargs):
                self.hits += 1
                out = attr(*args, **kwargs)
                # iterables of rows cost ~1 hit per row fetched
                if name in ("get_nodes_by_label", "get_edges_by_type",
                            "batch_get_nodes", "neighbors", "get_node_edges"):
                    try:
                        self.hits += len(out)
                    except TypeError:
                        pass
                return out
            return counted
        return attr


def _label_estimate(storage: Engine, labels: List[str], total: int) -> int:
    if not labels:
        return total
    counter = getattr(storage, "count_nodes_by_label", None)
    if counter is not None:
        try:
            return counter(labels[0])
        except Exception:
            pass
    # never materialize the label's node list just for an estimate
    return max(1, total // 10)


def _pattern_plan(storage: Engine, path: A.PatternPath, optional: bool) -> PlanNode:
    total = storage.count_nodes()
    first = path.nodes[0]
    if first.labels:
        est = _label_estimate(storage, first.labels, total)
        leaf = PlanNode(
            operator="NodeByLabelScan",
            details=f"({first.var or ''}:{':'.join(first.labels)})",
            estimated_rows=est,
        )
    else:
        leaf = PlanNode(
            operator="AllNodesScan",
            details=f"({first.var or ''})",
            estimated_rows=total,
        )
    if first.props is not None:
        leaf = PlanNode(
            operator="Filter",
            details="property predicate",
            estimated_rows=max(1, leaf.estimated_rows // 4),
            children=[leaf],
        )
    node = leaf
    avg_degree = (
        (storage.count_edges() / max(1, total)) if total else 0.0
    )
    for src, rel, dst in zip(path.nodes, path.rels, path.nodes[1:]):
        var_len = rel.min_hops != 1 or rel.max_hops != 1
        op = "VarLengthExpand" if var_len else "Expand(All)"
        arrow = {"out": "-->", "in": "<--", "both": "--"}[rel.direction]
        t = ":" + "|".join(rel.types) if rel.types else ""
        est = max(1, int(node.estimated_rows * max(avg_degree, 1.0)))
        node = PlanNode(
            operator="OptionalExpand" if optional and not var_len else op,
            details=f"({src.var or ''}){arrow}[{rel.var or ''}{t}]"
                    f"({dst.var or ''})",
            estimated_rows=est,
            children=[node],
        )
        if dst.labels or dst.props is not None:
            node = PlanNode(
                operator="Filter",
                details=f"(:{':'.join(dst.labels)})" if dst.labels else
                        "property predicate",
                estimated_rows=max(1, node.estimated_rows // 2),
                children=[node],
            )
    return node


def build_plan(storage: Engine, uq: A.UnionQuery) -> PlanNode:
    """Build the operator tree for a parsed query
    (reference: buildExecutionPlan, explain.go:149)."""
    parts = [_build_query_plan(storage, part) for part in uq.parts]
    if len(parts) == 1:
        root = parts[0]
    else:
        root = PlanNode(
            operator="Union",
            estimated_rows=sum(p.estimated_rows for p in parts),
            children=parts,
        )
    return PlanNode(operator="ProduceResults",
                    estimated_rows=root.estimated_rows, children=[root])


def _build_query_plan(storage: Engine, q: A.Query) -> PlanNode:
    node: Optional[PlanNode] = None

    def attach(new: PlanNode) -> PlanNode:
        if node is not None:
            new.children.insert(0, node)
        return new

    for clause in q.clauses:
        if isinstance(clause, A.MatchClause):
            pats = [_pattern_plan(storage, p, clause.optional)
                    for p in clause.paths]
            sub = pats[0]
            for extra in pats[1:]:
                sub = PlanNode(
                    operator="CartesianProduct",
                    estimated_rows=max(1, sub.estimated_rows *
                                       extra.estimated_rows),
                    children=[sub, extra],
                )
            if node is not None:
                sub = PlanNode(operator="Apply",
                               estimated_rows=sub.estimated_rows,
                               children=[node, sub])
            node = sub
            if clause.where is not None:
                node = PlanNode(operator="Filter", details="WHERE",
                                estimated_rows=max(1, node.estimated_rows // 4),
                                children=[node])
        elif isinstance(clause, A.UnwindClause):
            node = attach(PlanNode(
                operator="Unwind", details=clause.var,
                estimated_rows=max(10, node.estimated_rows if node else 10)))
        elif isinstance(clause, A.CreateClause):
            n_nodes = sum(len(p.nodes) for p in clause.paths)
            n_rels = sum(len(p.rels) for p in clause.paths)
            node = attach(PlanNode(
                operator="Create",
                details=f"{n_nodes} nodes, {n_rels} rels",
                estimated_rows=node.estimated_rows if node else 1))
        elif isinstance(clause, A.MergeClause):
            node = attach(PlanNode(
                operator="Merge",
                estimated_rows=node.estimated_rows if node else 1))
        elif isinstance(clause, A.SetClause):
            node = attach(PlanNode(
                operator="SetProperties",
                estimated_rows=node.estimated_rows if node else 1))
        elif isinstance(clause, A.RemoveClause):
            node = attach(PlanNode(
                operator="RemoveProperties",
                estimated_rows=node.estimated_rows if node else 1))
        elif isinstance(clause, A.DeleteClause):
            node = attach(PlanNode(
                operator="Delete", details="DETACH" if clause.detach else "",
                estimated_rows=node.estimated_rows if node else 1))
        elif isinstance(clause, (A.WithClause, A.ReturnClause)):
            est = node.estimated_rows if node else 1
            has_agg = any(_is_aggregating(i.expr) for i in clause.items)
            op = "EagerAggregation" if has_agg else "Projection"
            details = ", ".join(i.alias or i.text for i in clause.items)
            if clause.star:
                details = "*" + (", " + details if details else "")
            node = attach(PlanNode(
                operator=op, details=details,
                estimated_rows=max(1, est // 10) if has_agg else est))
            if clause.distinct and not has_agg:
                node = PlanNode(operator="Distinct",
                                estimated_rows=node.estimated_rows,
                                children=[node])
            if clause.order_by:
                node = PlanNode(operator="Sort",
                                estimated_rows=node.estimated_rows,
                                children=[node])
            if clause.skip is not None:
                node = PlanNode(operator="Skip",
                                estimated_rows=node.estimated_rows,
                                children=[node])
            if clause.limit is not None:
                lim = clause.limit
                est_l = (lim.value if isinstance(lim, A.Literal) and
                         isinstance(lim.value, int) else node.estimated_rows)
                node = PlanNode(operator="Limit", details=str(est_l),
                                estimated_rows=min(node.estimated_rows, est_l),
                                children=[node])
            if isinstance(clause, A.WithClause) and clause.where is not None:
                node = PlanNode(operator="Filter", details="WHERE",
                                estimated_rows=max(1, node.estimated_rows // 4),
                                children=[node])
        elif isinstance(clause, A.CallClause):
            node = attach(PlanNode(
                operator="ProcedureCall", details=clause.proc,
                estimated_rows=node.estimated_rows if node else 1))
    return node or PlanNode(operator="EmptyResult")


def _is_aggregating(e: A.Expr) -> bool:
    # single source of truth with actual execution (executor._contains_agg)
    from nornicdb_tpu_torch.query.executor import _contains_agg

    return _contains_agg(e)


def plan_rows(plan: PlanNode) -> Tuple[List[str], List[List[Any]]]:
    """Render the plan tree as the tabular EXPLAIN output. (PROFILE
    returns the query's records; its plan rides on CypherResult.plan.)"""
    cols = ["Operator", "Details", "EstimatedRows"]
    rows: List[List[Any]] = []
    for depth, n in plan.flatten():
        op = ("+" * depth) + n.operator if depth else n.operator
        rows.append([op, n.details, n.estimated_rows])
    return cols, rows
