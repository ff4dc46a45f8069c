"""Cypher executor: streaming clause pipeline over binding rows
(counterpart of ``nornicdb_tpu/query/executor.py``).

Reference: pkg/cypher/executor.go:517-700 (StorageExecutor.Execute routing),
match/traversal (traversal.go, match_*.go), mutations
(executor_mutations.go), aggregation + projection semantics. Rows stream
through clause operators as dicts {var: value}; aggregation groups on the
non-aggregate projection keys exactly as Cypher defines.

APOC (``query/apoc*.py``: functions, ``apoc.agg.*`` aggregates,
procedures and triggers) and the strict parser mode (``query/strict.py``)
run as the reference's; a trigger or an ``apoc.periodic`` batch that
meets a device fault raises instead of being swallowed (ROADMAP C29).
The device graph plane (``query/device_graph.py``) serves the fast-path
shapes its gates route to it; every other read serves from the catalog's
host arrays. PROFILE keeps the plan, its db hits and row counts; there is
no metrics registry to record them in.
"""

from __future__ import annotations

import threading
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

from nornicdb_tpu_torch.errors import CypherRuntimeError, CypherSyntaxError
from nornicdb_tpu_torch.query import ast as A
from nornicdb_tpu_torch.query.functions import PathValue, lookup as lookup_fn
from nornicdb_tpu_torch.query.parser import parse
from nornicdb_tpu_torch.storage.types import Direction, Edge, Engine, Node, NotFoundError

_AGG_FUNCS = {
    "count", "sum", "avg", "min", "max", "collect", "stdev", "stdevp",
    "percentilecont", "percentiledisc",
}


def _is_agg_name(name: str) -> bool:
    """Builtin aggregates plus the apoc.agg.* family (reference
    apoc/agg: first/last/nth/slice/median/statistics/...)."""
    return name in _AGG_FUNCS or name.startswith("apoc.agg.")


@dataclass
class QueryStats:
    nodes_created: int = 0
    nodes_deleted: int = 0
    relationships_created: int = 0
    relationships_deleted: int = 0
    properties_set: int = 0
    labels_added: int = 0
    labels_removed: int = 0

    @property
    def contains_updates(self) -> bool:
        return any(
            (
                self.nodes_created, self.nodes_deleted,
                self.relationships_created, self.relationships_deleted,
                self.properties_set, self.labels_added, self.labels_removed,
            )
        )

    def to_dict(self) -> Dict[str, int]:
        return {
            "nodes_created": self.nodes_created,
            "nodes_deleted": self.nodes_deleted,
            "relationships_created": self.relationships_created,
            "relationships_deleted": self.relationships_deleted,
            "properties_set": self.properties_set,
            "labels_added": self.labels_added,
            "labels_removed": self.labels_removed,
        }


class CypherResult:
    """Query result. Internally column-major when produced by the
    vectorized fast paths (the reference's executor streams records
    rather than materializing them all up front — bolt PULL semantics,
    pkg/bolt/server.go; this is the columnar analog): ``rows`` is
    materialized lazily on first access, so servers that serialize
    straight from columns and benches that only count results never pay
    the per-row Python list cost."""

    __slots__ = ("columns", "_rows", "_col_data", "stats", "plan")

    def __init__(
        self,
        columns: Optional[List[str]] = None,
        rows: Optional[List[List[Any]]] = None,
        stats: Optional[QueryStats] = None,
        plan: Optional[Dict[str, Any]] = None,
        col_data: Optional[List[List[Any]]] = None,
    ):
        self.columns = columns if columns is not None else []
        if rows is not None:
            self._rows = rows
            self._col_data = None
        elif col_data is not None:
            self._rows = None
            self._col_data = col_data
        else:
            self._rows = []
            self._col_data = None
        self.stats = stats if stats is not None else QueryStats()
        self.plan = plan

    def _pycol(self, i: int) -> List[Any]:
        """Column i as a Python list, converting a lazily-held numpy
        column (np scalars -> natives) exactly once."""
        col = self._col_data[i]
        if not isinstance(col, list):
            col = col.tolist()
            self._col_data[i] = col
        return col

    @property
    def rows(self) -> List[List[Any]]:
        if self._rows is None:
            cols = self._col_data
            if cols and len(cols[0]):
                cols = [self._pycol(i) for i in range(len(cols))]
                self._rows = list(map(list, zip(*cols)))
            else:
                self._rows = []
        # the returned list is mutable (UNION merging extends it in
        # place): drop the column view so there is a single source of
        # truth once rows are exposed
        self._col_data = None
        return self._rows

    @rows.setter
    def rows(self, value: List[List[Any]]) -> None:
        self._rows = value
        self._col_data = None

    @property
    def n_rows(self) -> int:
        if self._rows is not None:
            return len(self._rows)
        return len(self._col_data[0]) if self._col_data else 0

    def col_values(self, i: int) -> List[Any]:
        """Column-major access without forcing row materialization.
        Returns a copy: the underlying columns may be shared with the
        query cache, so handing out the live list would let caller
        mutations poison future cache hits."""
        if self._col_data is not None:
            return list(self._pycol(i))
        return [r[i] for r in self.rows]

    def records(self) -> List[Dict[str, Any]]:
        return [dict(zip(self.columns, r)) for r in self.rows]

    def single(self) -> Optional[Dict[str, Any]]:
        recs = self.records()
        return recs[0] if recs else None

    def value(self, col: int = 0) -> Any:
        if self._rows is None and self._col_data:
            c = self._pycol(col)
            return c[0] if c else None
        return self.rows[0][col] if self.rows else None


class _Ctx:
    def __init__(
        self,
        executor: "CypherExecutor",
        params: Dict[str, Any],
        storage: Optional[Engine] = None,
    ):
        self.ex = executor
        self.storage = storage if storage is not None else executor.storage
        self.params = params
        self.stats = QueryStats()
        # create-delta tracking for granular cache maintenance: pure
        # creations extend the columnar snapshot instead of rebuilding it
        self.created_nodes: List[Node] = []
        self.created_edges: List[Edge] = []
        self.created_props = 0  # properties set BY those creations
        self.non_create_writes = False
        # incrementally-built (label, prop) -> value -> nodes map over
        # created_nodes, so per-row index probes stay O(1) amortized
        self.created_probe_index: Dict[Tuple[str, str], Dict] = {}


class CypherExecutor:
    """Executes Cypher against a storage.Engine
    (reference: cypher.NewStorageExecutor, wired at db.go:974)."""

    def __init__(self, storage: Engine, cache_size: int = 1024,
                 cache_ttl: float = 60.0, parser_mode: Optional[str] = None,
                 device=None):
        import os

        self.storage = storage
        # the device the executor's device work runs on (None: CUDA)
        self.device = device
        # 'fast' (default) or 'strict' (diagnostic validation before
        # execution — reference: NORNICDB_PARSER antlr mode,
        # cypher-parser-modes.md)
        self.parser_mode = (
            parser_mode or os.environ.get("NORNICDB_TPU_PARSER", "fast")
        ).lower()
        self._search = None
        self._lock = threading.Lock()
        self._plugin_functions: Dict[str, Any] = {}
        # Columnar snapshot powering the vectorized fast paths
        # (reference analog: the per-shape optimized executors +
        # parallel.go chunked scans; see query/columnar.py).
        from nornicdb_tpu_torch.query.columnar import ColumnarCatalog

        self.columnar = ColumnarCatalog(storage)
        self.enable_fastpaths = True
        # Device graph plane: the LDBC fast-path shapes on device
        # snapshots of the catalog (query/device_graph.py), keyed on its
        # versions and gated by NORNICDB_GRAPH_DEVICE. It resolves
        # ``device`` (None: CUDA) only when a read routes to it.
        from nornicdb_tpu_torch.query.device_graph import DeviceGraphPlane

        self.device_graph = DeviceGraphPlane(self.columnar, device)
        from nornicdb_tpu_torch import obs as _obs

        _obs.register_resource(
            "device_graph",
            getattr(storage, "database", None) or "default",
            self.device_graph)
        # Read-query result cache with write invalidation (reference:
        # read-cache probe executor.go:634, pkg/cache/query_cache.go).
        from nornicdb_tpu_torch.cache import LRUCache

        self.query_cache: LRUCache = LRUCache(
            max_size=cache_size, ttl_seconds=cache_ttl
        )
        self.enable_query_cache = True
        # parsed-AST cache keyed by query text (reference: cached
        # QueryAnalyzer.Analyze, executor.go:624) — parsing is ~15% of a
        # fast-path query; ASTs are immutable after parse
        self._parse_cache: LRUCache = LRUCache(max_size=512)
        self._tls = threading.local()
        # apoc.trigger.* registry; statements fire after updating queries
        from nornicdb_tpu_torch.query.apoc_ext import TriggerRegistry

        self.triggers = TriggerRegistry()
        self._in_trigger = False

    def on_external_mutation(self) -> None:
        """Storage-listener entry point (db.py wires this): invalidate for
        writes arriving OUTSIDE this executor's own execution (Store,
        embed queue, replication apply). The executor's own writes fire
        the same listeners mid-query; those are handled at end-of-query
        (delta-extend or full invalidate), so they are skipped here —
        otherwise the listener wipes the catalog before the delta path
        runs and MATCH…CREATE pays a full O(N) rebuild per statement."""
        if getattr(self._tls, "depth", 0) > 0:
            return
        self.invalidate_caches()

    def on_external_node_upsert(self, node) -> None:
        """Upsert-shaped external mutation: when only the embedding (or
        other non-query-visible fields) changed, swap the snapshot's node
        in place instead of invalidating wholesale — the embed queue's
        write-backs would otherwise force a full catalog rebuild per
        probe while a bulk ingest runs concurrently."""
        if getattr(self._tls, "depth", 0) > 0:
            return
        if self.columnar.note_external_upsert(node):
            # projected nodes can carry embeddings: drop only results
            self.query_cache.clear()
            return
        self.invalidate_caches()

    def invalidate_caches(self) -> None:
        """Drop the query-result cache and columnar snapshot. Called after
        any write this executor performs, and wired to storage mutation
        listeners for writes arriving from other paths (db.Store, embed
        queue) — reference: cache_policy.go write invalidation."""
        self.query_cache.clear()
        self.columnar.invalidate()

    def set_search_service(self, svc) -> None:
        """Wire the vector/fulltext procedures
        (reference: SetSearchService, db.go:1086-1093)."""
        self._search = svc

    def register_function(self, name: str, fn) -> None:
        """Plugin functions callable from Cypher
        (reference: PluginFunctionLookup, db.go:992-999)."""
        self._plugin_functions[name.lower()] = fn

    # -- entry -----------------------------------------------------------

    def execute(
        self, query: str, params: Optional[Dict[str, Any]] = None
    ) -> CypherResult:
        stripped = query.lstrip()
        head = stripped[:7].upper()
        rest = stripped[7:]
        boundary = rest[:1] == "" or rest[:1].isspace()
        if head == "EXPLAIN" and boundary:
            return self._execute_explain(rest, params)
        if head == "PROFILE" and boundary:
            return self._execute_profile(rest, params)
        if self.parser_mode == "strict":
            from nornicdb_tpu_torch.query.strict import assert_valid

            assert_valid(query)
        uq = self._parse_cached(query)
        cache_key = None
        if self.enable_query_cache and _is_read_only(uq):
            cache_key = _cache_key(query, params, uq)
            if cache_key is not None:
                hit = self.query_cache.get(cache_key)
                if hit is not None:
                    if hit._col_data is not None:
                        # column-major cached result: hits share the
                        # immutable columns; each hit materializes its
                        # own row lists only if the caller iterates them
                        return CypherResult(
                            columns=list(hit.columns),
                            col_data=hit._col_data,
                            plan=hit.plan,
                        )
                    return CypherResult(
                        columns=list(hit.columns),
                        rows=[list(r) for r in hit.rows],
                        plan=hit.plan,
                    )
        result = self._execute_parsed(uq, params)
        if cache_key is not None and not result.stats.contains_updates:
            if result._col_data is not None:
                # cache a detached wrapper over the shared columns so the
                # caller's row materialization (which drops the column
                # view) and row-list mutations can't reach future hits
                self.query_cache.put(
                    cache_key,
                    CypherResult(
                        columns=list(result.columns),
                        col_data=result._col_data,
                        plan=result.plan,
                    ),
                )
            else:
                self.query_cache.put(cache_key, result)
        return result

    def _execute_parsed(
        self,
        uq: "A.UnionQuery",
        params: Optional[Dict[str, Any]],
        storage: Optional[Engine] = None,
    ) -> CypherResult:
        ctx = _Ctx(self, params or {}, storage=storage)
        self._tls.depth = getattr(self._tls, "depth", 0) + 1
        try:
            return self._execute_parsed_inner(uq, ctx, storage)
        except BaseException:
            # a failing write query may have applied SOME mutations before
            # raising (listener invalidation is suppressed at depth>0, and
            # the end-of-query delta path never runs on this path) —
            # conservatively drop the caches
            if ctx.stats.contains_updates or ctx.created_nodes or (
                ctx.created_edges or ctx.non_create_writes
            ):
                self.invalidate_caches()
            raise
        finally:
            self._tls.depth -= 1

    def _execute_parsed_inner(
        self,
        uq: "A.UnionQuery",
        ctx: "_Ctx",
        storage: Optional[Engine] = None,
    ) -> CypherResult:
        result: Optional[CypherResult] = None
        multi_part = len(uq.parts) > 1
        for i, part in enumerate(uq.parts):
            r = self._run_query(part, ctx)
            if multi_part and ctx.stats.contains_updates:
                # later UNION parts must see this part's writes; the
                # delta path only applies after ALL parts, so multi-part
                # writes invalidate between parts (writes in UNION are
                # rare — correctness over the delta micro-optimization)
                self.invalidate_caches()
                ctx.non_create_writes = True  # disable end-of-query delta
            if result is None:
                result = r
            else:
                if r.columns != result.columns:
                    raise CypherRuntimeError("UNION parts must have same columns")
                result.rows.extend(r.rows)
                if not uq.alls[i - 1]:  # UNION (distinct)
                    seen = set()
                    deduped = []
                    for row in result.rows:
                        key = _hashable(row)
                        if key not in seen:
                            seen.add(key)
                            deduped.append(row)
                    result.rows = deduped
        result = result or CypherResult()
        result.stats = ctx.stats
        if ctx.stats.contains_updates:
            # write invalidation for every execution route (including
            # PROFILE and txn overlays) — reference: cache_policy.go.
            # Pure creations (delta lists match the stats counters and no
            # other write kind ran) extend the columnar snapshot in place
            # instead of forcing an O(N) rebuild per statement.
            pure_creates = (
                not ctx.non_create_writes
                and storage is None
                and ctx.stats.nodes_deleted == 0
                and ctx.stats.relationships_deleted == 0
                and ctx.stats.labels_removed == 0
                and len(ctx.created_nodes) == ctx.stats.nodes_created
                and len(ctx.created_edges) == ctx.stats.relationships_created
                # every counted write must be explained by the deltas —
                # a procedure mutating properties (apoc.create.setProperty)
                # bumps these counters without touching the delta lists
                and ctx.stats.properties_set == ctx.created_props
                and ctx.stats.labels_added == sum(
                    len(n.labels) for n in ctx.created_nodes)
            )
            if pure_creates:
                self.query_cache.clear()
                for n in ctx.created_nodes:
                    self.columnar.apply_node_created(n)
                for e in ctx.created_edges:
                    self.columnar.apply_edge_created(e)
            else:
                self.invalidate_caches()
            # apoc triggers ('after' phase); guarded against recursion
            if self.triggers.triggers and not self._in_trigger:
                self.triggers.fire(self)
        return result

    def _execute_for_trigger(self, statement: str,
                             params: Optional[Dict[str, Any]] = None
                             ) -> "CypherResult":
        """Nested execution for triggers / apoc.periodic / apoc.cypher.run:
        bypasses the read cache and suppresses re-entrant trigger firing.
        Uses the parse cache — a trigger statement re-fires on every
        updating query with identical text."""
        prev = self._in_trigger
        self._in_trigger = True
        try:
            return self._execute_parsed(self._parse_cached(statement),
                                        params or {})
        finally:
            self._in_trigger = prev

    def _parse_cached(self, query: str) -> "A.UnionQuery":
        uq = self._parse_cache.get(query)
        if uq is None:
            uq = parse(query)
            self._parse_cache.put(query, uq)
        return uq

    def _execute_explain(
        self, query: str, params: Optional[Dict[str, Any]]
    ) -> CypherResult:
        """EXPLAIN: build and return the plan without executing
        (reference: executeExplain, explain.go:95)."""
        from nornicdb_tpu_torch.query.explain import build_plan, plan_rows

        uq = self._parse_cached(query)
        plan = build_plan(self.storage, uq)
        cols, rows = plan_rows(plan)
        return CypherResult(columns=cols, rows=rows, plan=plan.to_dict())

    def _execute_profile(
        self, query: str, params: Optional[Dict[str, Any]]
    ) -> CypherResult:
        """PROFILE: execute through a db-hit-counting storage proxy and
        attach actuals to the plan (reference: executeProfile,
        explain.go:110). The actuals also land in the metrics registry:
        the db-hit and wall-time distributions of profiled queries."""
        import time as _time

        from nornicdb_tpu_torch.obs import REGISTRY
        from nornicdb_tpu_torch.query.explain import CountingEngine, build_plan

        uq = self._parse_cached(query)
        plan = build_plan(self.storage, uq)
        counting = CountingEngine(self.storage)
        t0 = _time.perf_counter()
        result = self._execute_parsed(uq, params, storage=counting)
        elapsed = _time.perf_counter() - t0
        root = plan.children[0] if plan.children else plan
        root.db_hits = counting.hits
        plan.actual_rows = root.actual_rows = len(result.rows)
        REGISTRY.histogram(
            "nornicdb_profile_db_hits",
            "Storage hits per PROFILEd query",
            buckets=(1, 10, 100, 1_000, 10_000, 100_000, 1_000_000),
        ).observe(counting.hits)
        REGISTRY.histogram(
            "nornicdb_profile_query_seconds",
            "Wall time per PROFILEd query").observe(elapsed)
        # Neo4j semantics: PROFILE returns the query's records; the
        # profiled plan rides on the result (summary-equivalent).
        result.plan = plan.to_dict()
        return result

    def _run_query(self, q: A.Query, ctx: _Ctx) -> CypherResult:
        from nornicdb_tpu_torch.query.fastpaths import (
            try_fast_match_rows,
            try_fast_path,
        )

        fast = try_fast_path(self, q, ctx)
        if fast is not None:
            return fast
        rows: Iterable[Dict[str, Any]] = [dict()]
        final: Optional[CypherResult] = None
        clauses = q.clauses
        for idx, clause in enumerate(clauses):
            is_last = idx == len(clauses) - 1
            if isinstance(clause, A.MatchClause):
                if idx == 0:
                    # vectorized binding resolution for the leading MATCH
                    # (compound fast path: MATCH…CREATE/SET/DELETE etc.)
                    fast_rows = try_fast_match_rows(self, clause, ctx)
                    if fast_rows is not None:
                        rows = fast_rows
                        continue
                rows = self._exec_match(clause, rows, ctx)
            elif isinstance(clause, A.UnwindClause):
                rows = self._exec_unwind(clause, rows, ctx)
            elif isinstance(clause, A.CreateClause):
                rows = self._exec_create(clause, rows, ctx)
            elif isinstance(clause, A.MergeClause):
                rows = self._exec_merge(clause, rows, ctx)
            elif isinstance(clause, A.SetClause):
                rows = self._exec_set(clause.items, rows, ctx)
            elif isinstance(clause, A.RemoveClause):
                rows = self._exec_remove(clause, rows, ctx)
            elif isinstance(clause, A.DeleteClause):
                rows = self._exec_delete(clause, rows, ctx)
            elif isinstance(clause, A.WithClause):
                rows = self._exec_projection(clause, rows, ctx)
            elif isinstance(clause, A.ReturnClause):
                final = self._exec_return(clause, rows, ctx)
                rows = []
            elif isinstance(clause, A.CallClause):
                rows = self._exec_call(clause, rows, ctx, standalone=len(clauses) == 1)
                if len(clauses) == 1:
                    # bare CALL: yield columns become the result
                    rows = list(rows)
                    cols = (
                        list(rows[0].keys()) if rows else
                        [a or n for n, a in clause.yield_items]
                    )
                    final = CypherResult(
                        columns=cols,
                        rows=[[r.get(c) for c in cols] for r in rows],
                    )
            else:
                raise CypherRuntimeError(f"unhandled clause {type(clause).__name__}")
            if is_last and final is None:
                # writes without RETURN: drain the stream to apply effects
                for _ in rows:
                    pass
        return final or CypherResult()

    # -- expression evaluation -------------------------------------------

    def _eval(self, e: A.Expr, row: Dict[str, Any], ctx: _Ctx) -> Any:
        if isinstance(e, A.Literal):
            return e.value
        if isinstance(e, A.Param):
            if e.name not in ctx.params:
                raise CypherRuntimeError(f"missing parameter ${e.name}")
            return ctx.params[e.name]
        if isinstance(e, A.Var):
            if e.name not in row:
                raise CypherRuntimeError(f"variable `{e.name}` not defined")
            return row[e.name]
        if isinstance(e, A.Prop):
            target = self._eval(e.target, row, ctx)
            if target is None:
                return None
            if isinstance(target, (Node, Edge)):
                return target.properties.get(e.name)
            if isinstance(target, dict):
                return target.get(e.name)
            # temporal/duration/point component access (d.year, dur.days,
            # p.x — reference: temporal component properties)
            comp = getattr(target, "component", None)
            if comp is not None:
                return comp(e.name)
            raise CypherRuntimeError(f"cannot access property on {type(target).__name__}")
        if isinstance(e, A.ListExpr):
            return [self._eval(x, row, ctx) for x in e.items]
        if isinstance(e, A.MapExpr):
            return {k: self._eval(v, row, ctx) for k, v in e.items}
        if isinstance(e, A.Unary):
            v = self._eval(e.operand, row, ctx)
            if e.op == "NOT":
                return None if v is None else (not _truthy(v))
            if v is None:
                return None
            return -v if e.op == "-" else +v
        if isinstance(e, A.Binary):
            return self._eval_binary(e, row, ctx)
        if isinstance(e, A.IsNull):
            v = self._eval(e.operand, row, ctx)
            return (v is not None) if e.negated else (v is None)
        if isinstance(e, A.CaseExpr):
            if e.subject is not None:
                subject = self._eval(e.subject, row, ctx)
                for cond, val in e.whens:
                    if _cypher_eq(subject, self._eval(cond, row, ctx)):
                        return self._eval(val, row, ctx)
            else:
                for cond, val in e.whens:
                    if _truthy(self._eval(cond, row, ctx)):
                        return self._eval(val, row, ctx)
            return self._eval(e.default, row, ctx) if e.default else None
        if isinstance(e, A.Index):
            target = self._eval(e.target, row, ctx)
            idx = self._eval(e.index, row, ctx)
            if target is None or idx is None:
                return None
            if isinstance(target, dict):
                return target.get(idx)
            if isinstance(target, (Node, Edge)):
                return target.properties.get(idx)
            i = int(idx)
            if -len(target) <= i < len(target):
                return target[i]
            return None
        if isinstance(e, A.Slice):
            target = self._eval(e.target, row, ctx)
            if target is None:
                return None
            s = self._eval(e.start, row, ctx) if e.start else None
            t = self._eval(e.end, row, ctx) if e.end else None
            return target[s if s is None else int(s) : t if t is None else int(t)]
        if isinstance(e, A.ListComp):
            src = self._eval(e.source, row, ctx)
            if src is None:
                return None
            out = []
            for item in src:
                inner = dict(row)
                inner[e.var] = item
                if e.where is not None and not _truthy(self._eval(e.where, inner, ctx)):
                    continue
                out.append(
                    self._eval(e.projection, inner, ctx) if e.projection else item
                )
            return out
        if isinstance(e, A.ListPredicate):
            src = self._eval(e.source, row, ctx)
            if src is None:
                return None
            if not isinstance(src, list):
                raise CypherRuntimeError(
                    f"{e.kind}() expects a list, got {type(src).__name__}"
                )
            n_true = 0
            n_null = 0
            for item in src:
                inner = dict(row)
                inner[e.var] = item
                v = self._eval(e.where, inner, ctx)
                if v is None:
                    n_null += 1
                elif _truthy(v):
                    n_true += 1
            n = len(src)
            # Cypher ternary semantics per predicate kind
            if e.kind == "all":
                if n_true == n:
                    return True
                return None if n_true + n_null == n else False
            if e.kind == "any":
                if n_true > 0:
                    return True
                return None if n_null > 0 else False
            if e.kind == "none":
                if n_true > 0:
                    return False
                return None if n_null > 0 else True
            # single
            if n_null > 0 and n_true <= 1:
                return None
            return n_true == 1
        if isinstance(e, A.Reduce):
            src = self._eval(e.source, row, ctx)
            if src is None:
                return None
            if not isinstance(src, list):
                raise CypherRuntimeError(
                    f"reduce() expects a list, got {type(src).__name__}"
                )
            acc = self._eval(e.init, row, ctx)
            for item in src:
                inner = dict(row)
                inner[e.acc] = acc
                inner[e.var] = item
                acc = self._eval(e.expr, inner, ctx)
            return acc
        if isinstance(e, A.LabelCheck):
            v = row.get(e.var)
            if not isinstance(v, Node):
                return None
            return all(l in v.labels for l in e.labels)
        if isinstance(e, A.Exists):
            if e.prop is not None:
                return self._eval(e.prop, row, ctx) is not None
            return any(True for _ in self._match_path(e.pattern, dict(row), ctx, set()))
        if isinstance(e, A.PatternPredicate):
            return any(True for _ in self._match_path(e.pattern, dict(row), ctx, set()))
        if isinstance(e, A.FuncCall):
            return self._eval_func(e, row, ctx)
        raise CypherRuntimeError(f"unhandled expression {type(e).__name__}")

    def _eval_binary(self, e: A.Binary, row, ctx) -> Any:
        op = e.op
        if op in ("AND", "OR", "XOR"):
            l = self._eval(e.left, row, ctx)
            # Cypher ternary logic
            if op == "AND":
                if l is False:
                    return False
                r = self._eval(e.right, row, ctx)
                if r is False:
                    return False
                if l is None or r is None:
                    return None
                return _truthy(l) and _truthy(r)
            if op == "OR":
                if l is True:
                    return True
                r = self._eval(e.right, row, ctx)
                if r is True:
                    return True
                if l is None or r is None:
                    return None
                return _truthy(l) or _truthy(r)
            r = self._eval(e.right, row, ctx)
            if l is None or r is None:
                return None
            return _truthy(l) != _truthy(r)
        l = self._eval(e.left, row, ctx)
        r = self._eval(e.right, row, ctx)
        if op == "=":
            if l is None or r is None:
                return None
            return _cypher_eq(l, r)
        if op == "<>":
            if l is None or r is None:
                return None
            return not _cypher_eq(l, r)
        if op in ("<", "<=", ">", ">="):
            if l is None or r is None:
                return None
            try:
                if op == "<":
                    return l < r
                if op == "<=":
                    return l <= r
                if op == ">":
                    return l > r
                return l >= r
            except TypeError:
                return None
        if op == "+":
            if l is None or r is None:
                return None
            if isinstance(l, list):
                return l + (r if isinstance(r, list) else [r])
            if isinstance(r, list):
                return [l] + r
            if isinstance(l, str) or isinstance(r, str):
                if isinstance(l, str) and isinstance(r, str):
                    return l + r
                return _to_str(l) + _to_str(r)
            try:
                return l + r
            except TypeError:
                raise CypherRuntimeError(
                    f"cannot apply + to {type(l).__name__} and "
                    f"{type(r).__name__}"
                )
        if op in ("-", "*", "/", "%", "^"):
            if l is None or r is None:
                return None
            try:
                return self._arith(op, l, r)
            except TypeError:
                raise CypherRuntimeError(
                    f"cannot apply {op} to {type(l).__name__} and "
                    f"{type(r).__name__}"
                )
        if op == "IN":
            if r is None:
                return None
            if l is None:
                return None
            return any(_cypher_eq(l, x) for x in r)
        if op == "STARTS WITH":
            if l is None or r is None:
                return None
            return isinstance(l, str) and l.startswith(r)
        if op == "ENDS WITH":
            if l is None or r is None:
                return None
            return isinstance(l, str) and l.endswith(r)
        if op == "CONTAINS":
            if l is None or r is None:
                return None
            return isinstance(l, str) and r in l
        if op == "=~":
            if l is None or r is None:
                return None
            import re as _re

            return bool(_re.fullmatch(r, l))
        raise CypherRuntimeError(f"unhandled operator {op}")

    def _arith(self, op: str, l: Any, r: Any) -> Any:
        if op == "-":
            return l - r
        if op == "*":
            return l * r
        if op == "/":
            is_num = isinstance(l, (int, float)) and isinstance(r, (int, float))
            if is_num and r == 0:
                if isinstance(l, float) or isinstance(r, float):
                    # IEEE float semantics (Neo4j returns Infinity/NaN)
                    if l == 0:
                        return float("nan")
                    return float("inf") if l > 0 else float("-inf")
                raise CypherRuntimeError("division by zero")
            if isinstance(l, int) and isinstance(r, int):
                q = l // r
                if q < 0 and l % r != 0:
                    q += 1  # Cypher truncates toward zero
                return q
            return l / r
        if op == "%":
            if r == 0:
                raise CypherRuntimeError("modulo by zero")
            m = abs(l) % abs(r)
            return m if l >= 0 else -m
        return float(l) ** float(r)

    def _eval_func(self, e: A.FuncCall, row, ctx) -> Any:
        name = e.name
        if _is_agg_name(name):
            raise CypherRuntimeError(
                f"aggregate function {name}() not allowed here"
            )
        if name == "__pattern_count__":
            pat = e.args[0]
            assert isinstance(pat, A.PatternPredicate)
            return sum(1 for _ in self._match_path(pat.pattern, dict(row), ctx, set()))
        if name == "exists":
            return self._eval(e.args[0], row, ctx) is not None
        if name in ("shortestpath", "allshortestpaths"):
            pat = e.args[0]
            if not isinstance(pat, A.PatternPredicate):
                raise CypherRuntimeError("shortestPath expects a pattern")
            return self._shortest_path(
                pat.pattern, row, ctx, all_paths=name == "allshortestpaths"
            )
        if name in ("degree", "indegree", "outdegree"):
            # storage-backed degree functions (reference
            # functions_eval_functions.go:534-560): 0 for non-nodes
            v = self._eval(e.args[0], row, ctx) if e.args else None
            if not isinstance(v, Node):
                return 0
            direction = {"degree": Direction.BOTH,
                         "indegree": Direction.INCOMING,
                         "outdegree": Direction.OUTGOING}[name]
            return ctx.storage.degree(v.id, direction)
        args = [self._eval(a, row, ctx) for a in e.args]
        fn = self._plugin_functions.get(name) or lookup_fn(name)
        if fn is None:
            from nornicdb_tpu_torch.query.apoc import lookup_apoc, lookup_apoc_ctx

            cfn = lookup_apoc_ctx(name)
            if cfn is not None:
                return cfn(ctx, *args)
            fn = lookup_apoc(name)
        if fn is None:
            raise CypherRuntimeError(f"unknown function {name}()")
        return fn(*args)

    # -- MATCH ------------------------------------------------------------

    def _exec_match(self, clause: A.MatchClause, rows, ctx) -> Iterator[Dict]:
        for row in rows:
            matched = False
            for out in self._match_paths(clause.paths, row, ctx):
                if clause.where is not None and not _truthy(
                    self._eval(clause.where, out, ctx)
                ):
                    continue
                matched = True
                yield out
            if clause.optional and not matched:
                out = dict(row)
                for p in clause.paths:
                    for n in p.nodes:
                        if n.var and n.var not in out:
                            out[n.var] = None
                    for r in p.rels:
                        if r.var and r.var not in out:
                            out[r.var] = None
                    if p.path_var and p.path_var not in out:
                        out[p.path_var] = None
                yield out  # null-extended row (Neo4j OPTIONAL MATCH semantics)

    def _match_paths(self, paths: List[A.PatternPath], row, ctx) -> Iterator[Dict]:
        """Match all comma-separated paths (cartesian, shared vars join).
        Relationship uniqueness is enforced across the whole MATCH: edges
        bound by path i are excluded from path i+1's search."""

        def rec(i: int, cur: Dict, used: frozenset) -> Iterator[Dict]:
            if i >= len(paths):
                yield cur
                return
            for out, used_out in self._match_path_used(paths[i], cur, ctx, used):
                yield from rec(i + 1, out, used_out)

        yield from rec(0, dict(row), frozenset())

    def _node_candidates(self, pn: A.PatternNode, row, ctx) -> Iterable[Node]:
        if pn.var and pn.var in row and row[pn.var] is not None:
            v = row[pn.var]
            if not isinstance(v, Node):
                raise CypherRuntimeError(f"`{pn.var}` is not a node")
            return [v]
        if pn.labels:
            if (pn.props is not None and pn.props.items
                    and getattr(self, "enable_fastpaths", True)):
                hit = self._indexed_candidates(pn, row, ctx)
                if hit is not None:
                    return hit
            # smallest label set first
            best: Optional[List[Node]] = None
            for lbl in pn.labels:
                cand = ctx.storage.get_nodes_by_label(lbl)
                if best is None or len(cand) < len(best):
                    best = cand
            return best or []
        return ctx.storage.all_nodes()

    def _indexed_candidates(self, pn: A.PatternNode, row,
                            ctx) -> Optional[List[Node]]:
        """Hash-index candidate narrowing for (:Label {k: <expr>}) in the
        ROW interpreter — the difference between O(1) and a label scan
        per row in UNWIND/loop-shaped ingest (reference resolves the same
        shape through indexed access, storage_fastpaths.go). Candidates
        are verified by _node_ok afterward, so the probe only needs to be
        a superset of the true matches; returns None to fall back to the
        label scan whenever the columnar snapshot cannot be trusted."""
        if ctx.storage is not self.storage:
            return None  # txn overlay / PROFILE proxy: snapshot mismatch
        if (ctx.non_create_writes or ctx.stats.nodes_deleted
                or ctx.stats.labels_removed):
            # updates/deletes earlier in this statement are not yet in
            # the snapshot (deltas apply at end of query)
            return None
        k, vexpr = pn.props.items[0]
        try:
            v = self._eval(vexpr, row, ctx)
        except CypherRuntimeError:
            return None
        if v is None or isinstance(v, (list, dict, Node, Edge)):
            return None
        try:
            hit = self.columnar.prop_index(pn.labels[0], k).get(v)
        except TypeError:
            return None  # unhashable probe value
        snapshot = self.columnar.nodes()
        out = [snapshot[i].copy()
               for i in (hit.tolist() if hit is not None else [])]
        # nodes created earlier in THIS statement are visible to MATCH;
        # append only the ones the snapshot does NOT already contain (a
        # lazy snapshot built after the CREATE has already read them
        # from storage — appending again would double the match). The
        # created list is consulted through an incrementally-extended
        # (label, key) -> value map so a 10k-row UNWIND MERGE stays
        # O(rows), not O(rows^2).
        label = pn.labels[0]
        cache = ctx.created_probe_index
        entry = cache.get((label, k))
        if entry is None:
            entry = {"pos": 0, "map": {}}
            cache[(label, k)] = entry
        mp = entry["map"]
        created = ctx.created_nodes
        for n in created[entry["pos"]:]:
            if label in n.labels:
                key_val = n.properties.get(k)
                if key_val is None:
                    continue  # probe values are never None (guard above)
                try:
                    mp.setdefault(key_val, []).append(n)
                except TypeError:
                    pass  # unhashable stored value can't equal probe v
        entry["pos"] = len(created)
        for n in mp.get(v, []):
            if self.columnar.node_row(n.id) is None:
                out.append(n)
        return out

    def _node_ok(self, pn: A.PatternNode, node: Node, row, ctx) -> bool:
        if any(l not in node.labels for l in pn.labels):
            return False
        if pn.props is not None:
            for k, vexpr in pn.props.items:
                if not _cypher_eq(node.properties.get(k), self._eval(vexpr, row, ctx)):
                    return False
        return True

    def _rel_ok(self, pr: A.PatternRel, edge: Edge, row, ctx) -> bool:
        if pr.types and edge.type not in pr.types:
            return False
        if pr.props is not None:
            for k, vexpr in pr.props.items:
                if not _cypher_eq(edge.properties.get(k), self._eval(vexpr, row, ctx)):
                    return False
        return True

    def _match_path(
        self, path: A.PatternPath, row: Dict, ctx, used_edges: set
    ) -> Iterator[Dict]:
        for out, _used in self._match_path_used(path, row, ctx, used_edges):
            yield out

    def _match_path_used(
        self, path: A.PatternPath, row: Dict, ctx, used_edges
    ) -> Iterator[Tuple[Dict, frozenset]]:
        """Like _match_path but also yields the edge-id set consumed by the
        match, so callers can enforce uniqueness across multiple paths."""
        if path.shortest:
            yield from self._match_shortest(path, row, ctx, used_edges)
            return
        nodes, rels = path.nodes, path.rels

        def expand(i: int, cur: Dict, cur_node: Node,
                   acc_nodes: List[Node], acc_rels: List[Edge],
                   used: set) -> Iterator[Tuple[Dict, frozenset]]:
            if i >= len(rels):
                out = dict(cur)
                if path.path_var:
                    out[path.path_var] = PathValue(list(acc_nodes), list(acc_rels))
                yield out, frozenset(used)
                return
            pr = rels[i]
            pn = nodes[i + 1]
            for hop_edges, end_node in self._expand_rel(pr, cur_node, cur, ctx, used):
                if not self._node_ok(pn, end_node, cur, ctx):
                    continue
                nxt = dict(cur)
                if pn.var:
                    if pn.var in nxt and nxt[pn.var] is not None:
                        if not isinstance(nxt[pn.var], Node) or nxt[pn.var].id != end_node.id:
                            continue
                    nxt[pn.var] = end_node
                if pr.var:
                    if pr.max_hops == 1 and pr.min_hops == 1:
                        nxt[pr.var] = hop_edges[0]
                    else:
                        nxt[pr.var] = list(hop_edges)
                new_used = used | {e.id for e in hop_edges}
                yield from expand(
                    i + 1, nxt, end_node,
                    acc_nodes + [end_node], acc_rels + list(hop_edges),
                    new_used,
                )

        first = nodes[0]
        for start in self._node_candidates(first, row, ctx):
            if not self._node_ok(first, start, row, ctx):
                continue
            cur = dict(row)
            if first.var:
                cur[first.var] = start
            yield from expand(0, cur, start, [start], [], set(used_edges))

    def _expand_rel(
        self, pr: A.PatternRel, start: Node, row, ctx, used: set
    ) -> Iterator[Tuple[List[Edge], Node]]:
        """Yield (edges_along_hop(s), end_node) for one pattern relationship,
        honoring variable-length ranges and edge uniqueness."""
        # bound rel var: single edge already fixed
        if pr.var and pr.var in row and row[pr.var] is not None and pr.max_hops == 1:
            e = row[pr.var]
            if isinstance(e, Edge):
                ends = []
                if pr.direction in ("out", "both") and e.start_node == start.id:
                    ends.append(e.end_node)
                if pr.direction in ("in", "both") and e.end_node == start.id:
                    ends.append(e.start_node)
                for other in ends:
                    try:
                        yield [e], ctx.storage.get_node(other)
                    except KeyError:
                        pass
                return

        def neighbors(node: Node) -> Iterator[Tuple[Edge, Node]]:
            direction = {
                "out": Direction.OUTGOING,
                "in": Direction.INCOMING,
                "both": Direction.BOTH,
            }[pr.direction]
            for e in ctx.storage.get_node_edges(node.id, direction):
                if not self._rel_ok(pr, e, row, ctx):
                    continue
                if pr.direction == "out" and e.start_node != node.id:
                    continue
                if pr.direction == "in" and e.end_node != node.id:
                    continue
                other_id = e.end_node if e.start_node == node.id else e.start_node
                if pr.direction == "both" and e.start_node == e.end_node:
                    other_id = node.id  # self-loop
                try:
                    yield e, ctx.storage.get_node(other_id)
                except KeyError:
                    continue

        max_hops = pr.max_hops if pr.max_hops >= 0 else 15  # sane cap
        min_hops = pr.min_hops

        if min_hops == 0:
            yield [], start

        # DFS up to max_hops with edge uniqueness
        stack: List[Tuple[Node, List[Edge], set]] = [(start, [], set(used))]
        while stack:
            node, edges_so_far, local_used = stack.pop()
            depth = len(edges_so_far)
            if depth >= max_hops:
                continue
            for e, other in neighbors(node):
                if e.id in local_used:
                    continue
                new_edges = edges_so_far + [e]
                if len(new_edges) >= min_hops:
                    yield new_edges, other
                stack.append((other, new_edges, local_used | {e.id}))

    def _match_shortest(
        self, path: A.PatternPath, row: Dict, ctx, used_edges
    ) -> Iterator[Tuple[Dict, frozenset]]:
        """MATCH-position shortestPath/allShortestPaths with possibly
        UNBOUND endpoints (the form LDBC/neo4j docs use:
        ``MATCH p = shortestPath((a:X)-[*]-(b:Y)) ...``). Endpoint
        patterns scan candidates like ordinary node patterns; BFS runs
        per (src, dst) pair. Reference: shortest_path.go served through
        its MATCH planner."""
        if len(path.nodes) != 2 or len(path.rels) != 1:
            raise CypherRuntimeError("shortestPath expects a 2-node pattern")
        src_pat, dst_pat, pr = path.nodes[0], path.nodes[1], path.rels[0]
        for a in self._node_candidates(src_pat, row, ctx):
            if not self._node_ok(src_pat, a, row, ctx):
                continue
            row_a = dict(row)
            if src_pat.var:
                row_a[src_pat.var] = a
            for b in self._node_candidates(dst_pat, row_a, ctx):
                if not self._node_ok(dst_pat, b, row_a, ctx):
                    continue
                if a.id == b.id and not (
                    src_pat.var and src_pat.var == dst_pat.var
                ):
                    # neo4j: same-node endpoints only match when both
                    # patterns name the same variable
                    continue
                res = self._bfs_shortest(
                    a, b, pr, ctx, all_paths=path.shortest == "all")
                paths = (res if isinstance(res, list)
                         else [res] if res is not None else [])
                for pv in paths:
                    out = dict(row_a)
                    if dst_pat.var:
                        out[dst_pat.var] = b
                    if pr.var:
                        out[pr.var] = list(pv.rels)
                    if path.path_var:
                        out[path.path_var] = pv
                    yield out, frozenset(used_edges)

    # -- shortest path ----------------------------------------------------

    def _shortest_path(self, path: A.PatternPath, row, ctx, all_paths=False):
        """BFS shortest path(s) (reference: shortest_path.go) —
        expression position: both endpoints must already be bound."""
        if len(path.nodes) != 2 or len(path.rels) != 1:
            raise CypherRuntimeError("shortestPath expects a 2-node pattern")
        src_pat, dst_pat, pr = path.nodes[0], path.nodes[1], path.rels[0]
        src = row.get(src_pat.var) if src_pat.var else None
        dst = row.get(dst_pat.var) if dst_pat.var else None
        if not isinstance(src, Node) or not isinstance(dst, Node):
            raise CypherRuntimeError("shortestPath endpoints must be bound nodes")
        return self._bfs_shortest(src, dst, pr, ctx, all_paths)

    def _bfs_shortest(self, src: Node, dst: Node, pr: A.PatternRel,
                      ctx, all_paths: bool = False):
        if src.id == dst.id:
            return PathValue([src], [])
        max_hops = pr.max_hops if pr.max_hops >= 0 else 25
        from collections import deque

        q = deque([(src.id, [], [src])])
        seen = {src.id: 0}
        found: List[PathValue] = []
        best_len = None
        while q:
            nid, redges, rnodes = q.popleft()
            depth = len(redges)
            if best_len is not None and depth >= best_len:
                continue
            if depth >= max_hops:
                continue
            direction = {
                "out": Direction.OUTGOING,
                "in": Direction.INCOMING,
                "both": Direction.BOTH,
            }[pr.direction]
            for e in ctx.storage.get_node_edges(nid, direction):
                if pr.types and e.type not in pr.types:
                    continue
                if pr.direction == "out" and e.start_node != nid:
                    continue
                if pr.direction == "in" and e.end_node != nid:
                    continue
                other = e.end_node if e.start_node == nid else e.start_node
                nd = depth + 1
                if other == dst.id:
                    try:
                        on = ctx.storage.get_node(other)
                    except KeyError:
                        continue
                    pv = PathValue(rnodes + [on], redges + [e])
                    if all_paths:
                        if best_len is None or nd == best_len:
                            best_len = nd
                            found.append(pv)
                    else:
                        return pv
                    continue
                # strict < so allShortestPaths keeps alternate equal-length
                # routes through an already-seen intermediate node
                if other in seen and (
                    seen[other] < nd or (not all_paths and seen[other] <= nd)
                ):
                    continue
                seen[other] = nd
                try:
                    on = ctx.storage.get_node(other)
                except KeyError:
                    continue
                q.append((other, redges + [e], rnodes + [on]))
        if all_paths:
            return found
        return None

    # -- UNWIND -----------------------------------------------------------

    def _exec_unwind(self, clause: A.UnwindClause, rows, ctx) -> Iterator[Dict]:
        for row in rows:
            v = self._eval(clause.expr, row, ctx)
            if v is None:
                continue
            if not isinstance(v, list):
                v = [v]
            for item in v:
                out = dict(row)
                out[clause.var] = item
                yield out

    # -- CREATE / MERGE ---------------------------------------------------

    def _create_node_from_pattern(self, pn: A.PatternNode, row, ctx) -> Node:
        props = {}
        if pn.props is not None:
            props = {k: self._eval(v, row, ctx) for k, v in pn.props.items}
        node = Node(id=str(uuid.uuid4()), labels=list(pn.labels), properties=props)
        emb = props.pop("embedding", None)
        if emb is not None:
            node.embedding = list(emb)
            node.properties = props
        ctx.storage.create_node(node)
        ctx.stats.nodes_created += 1
        ctx.stats.labels_added += len(pn.labels)
        ctx.stats.properties_set += len(props)
        created = ctx.storage.get_node(node.id)
        ctx.created_nodes.append(created)
        ctx.created_props += len(props)
        return created

    def _exec_create(self, clause: A.CreateClause, rows, ctx) -> Iterator[Dict]:
        for row in rows:
            out = dict(row)
            for path in clause.paths:
                prev: Optional[Node] = None
                path_nodes: List[Node] = []
                path_rels: List[Edge] = []
                for i, pn in enumerate(path.nodes):
                    if pn.var and pn.var in out and out[pn.var] is not None:
                        node = out[pn.var]
                        if not isinstance(node, Node):
                            raise CypherRuntimeError(f"`{pn.var}` is not a node")
                    else:
                        node = self._create_node_from_pattern(pn, out, ctx)
                        if pn.var:
                            out[pn.var] = node
                    path_nodes.append(node)
                    if i > 0:
                        pr = path.rels[i - 1]
                        if pr.max_hops != 1 or pr.min_hops != 1:
                            raise CypherRuntimeError("CREATE cannot use var-length rels")
                        if not pr.types:
                            raise CypherRuntimeError("CREATE requires a relationship type")
                        props = {}
                        if pr.props is not None:
                            props = {k: self._eval(v, out, ctx) for k, v in pr.props.items}
                        if pr.direction == "in":
                            start_id, end_id = node.id, prev.id
                        else:
                            start_id, end_id = prev.id, node.id
                        edge = Edge(
                            id=str(uuid.uuid4()), type=pr.types[0],
                            start_node=start_id, end_node=end_id, properties=props,
                        )
                        ctx.storage.create_edge(edge)
                        ctx.stats.relationships_created += 1
                        ctx.stats.properties_set += len(props)
                        edge = ctx.storage.get_edge(edge.id)
                        ctx.created_edges.append(edge)
                        ctx.created_props += len(props)
                        if pr.var:
                            out[pr.var] = edge
                        path_rels.append(edge)
                    prev = node
                if path.path_var:
                    out[path.path_var] = PathValue(path_nodes, path_rels)
            yield out

    def _exec_merge(self, clause: A.MergeClause, rows, ctx) -> Iterator[Dict]:
        for row in rows:
            found = False
            for out in self._match_path(clause.path, dict(row), ctx, set()):
                found = True
                if clause.on_match:
                    out = self._apply_set_items(clause.on_match, out, ctx)
                yield out
            if not found:
                created = list(
                    self._exec_create(
                        A.CreateClause(paths=[clause.path]), [dict(row)], ctx
                    )
                )
                for out in created:
                    if clause.on_create:
                        out = self._apply_set_items(clause.on_create, out, ctx)
                    yield out

    # -- SET / REMOVE / DELETE --------------------------------------------

    def _apply_set_items(self, items: List[A.SetItem], row, ctx) -> Dict:
        ctx.non_create_writes = True
        out = dict(row)
        for item in items:
            if item.labels:
                target = self._eval(item.target, out, ctx)
                if not isinstance(target, Node):
                    raise CypherRuntimeError("SET label target must be a node")
                node = ctx.storage.get_node(target.id)
                for l in item.labels:
                    if l not in node.labels:
                        node.labels.append(l)
                        ctx.stats.labels_added += 1
                ctx.storage.update_node(node)
                out = _refresh(out, ctx, node.id)
                continue
            if item.replace_map or item.merge_map:
                target = self._eval(item.target, out, ctx)
                value = self._eval(item.value, out, ctx)
                if isinstance(value, (Node, Edge)):
                    value = dict(value.properties)
                if not isinstance(value, dict):
                    raise CypherRuntimeError("SET map value must be a map")
                if isinstance(target, Node):
                    node = ctx.storage.get_node(target.id)
                    if item.replace_map:
                        node.properties = dict(value)
                    else:
                        node.properties.update(value)
                    _strip_null_props(node.properties)
                    ctx.storage.update_node(node)
                    ctx.stats.properties_set += len(value)
                    out = _refresh(out, ctx, node.id)
                elif isinstance(target, Edge):
                    edge = ctx.storage.get_edge(target.id)
                    if item.replace_map:
                        edge.properties = dict(value)
                    else:
                        edge.properties.update(value)
                    _strip_null_props(edge.properties)
                    ctx.storage.update_edge(edge)
                    ctx.stats.properties_set += len(value)
                    out = _refresh_edge(out, ctx, edge.id)
                else:
                    raise CypherRuntimeError("SET target must be node or relationship")
                continue
            # property set: target is Prop
            if not isinstance(item.target, A.Prop):
                raise CypherRuntimeError("bad SET target")
            entity = self._eval(item.target.target, out, ctx)
            value = self._eval(item.value, out, ctx)
            if isinstance(entity, Node):
                node = ctx.storage.get_node(entity.id)
                if value is None:
                    node.properties.pop(item.target.name, None)
                else:
                    node.properties[item.target.name] = value
                ctx.storage.update_node(node)
                ctx.stats.properties_set += 1
                out = _refresh(out, ctx, node.id)
            elif isinstance(entity, Edge):
                edge = ctx.storage.get_edge(entity.id)
                if value is None:
                    edge.properties.pop(item.target.name, None)
                else:
                    edge.properties[item.target.name] = value
                ctx.storage.update_edge(edge)
                ctx.stats.properties_set += 1
                out = _refresh_edge(out, ctx, edge.id)
            elif entity is None:
                continue
            else:
                raise CypherRuntimeError("SET target must be node or relationship")
        return out

    def _exec_set(self, items: List[A.SetItem], rows, ctx) -> Iterator[Dict]:
        for row in rows:
            yield self._apply_set_items(items, row, ctx)

    def _exec_remove(self, clause: A.RemoveClause, rows, ctx) -> Iterator[Dict]:
        ctx.non_create_writes = True
        for row in rows:
            out = dict(row)
            for item in clause.items:
                if item.labels:
                    target = self._eval(item.target, out, ctx)
                    if isinstance(target, Node):
                        node = ctx.storage.get_node(target.id)
                        for l in item.labels:
                            if l in node.labels:
                                node.labels.remove(l)
                                ctx.stats.labels_removed += 1
                        ctx.storage.update_node(node)
                        out = _refresh(out, ctx, node.id)
                elif isinstance(item.target, A.Prop):
                    entity = self._eval(item.target.target, out, ctx)
                    if isinstance(entity, Node):
                        node = ctx.storage.get_node(entity.id)
                        if item.target.name in node.properties:
                            del node.properties[item.target.name]
                            ctx.stats.properties_set += 1
                        ctx.storage.update_node(node)
                        out = _refresh(out, ctx, node.id)
                    elif isinstance(entity, Edge):
                        edge = ctx.storage.get_edge(entity.id)
                        if item.target.name in edge.properties:
                            del edge.properties[item.target.name]
                            ctx.stats.properties_set += 1
                        ctx.storage.update_edge(edge)
                        out = _refresh_edge(out, ctx, edge.id)
            yield out

    def _exec_delete(self, clause: A.DeleteClause, rows, ctx) -> Iterator[Dict]:
        ctx.non_create_writes = True
        for row in rows:
            for e in clause.exprs:
                v = self._eval(e, row, ctx)
                if v is None:
                    continue
                targets = v if isinstance(v, list) else [v]
                for t in targets:
                    if isinstance(t, Node):
                        if not clause.detach and ctx.storage.degree(t.id) > 0:
                            raise CypherRuntimeError(
                                f"cannot delete node {t.id} with relationships; "
                                "use DETACH DELETE"
                            )
                        n_edges = ctx.storage.degree(t.id)
                        try:
                            ctx.storage.delete_node(t.id)
                            ctx.stats.nodes_deleted += 1
                            ctx.stats.relationships_deleted += n_edges
                        except NotFoundError:
                            pass
                    elif isinstance(t, Edge):
                        try:
                            ctx.storage.delete_edge(t.id)
                            ctx.stats.relationships_deleted += 1
                        except NotFoundError:
                            pass
            yield row

    # -- WITH / RETURN ----------------------------------------------------

    def _projection_columns(self, clause, rows_sample: Dict) -> List[str]:
        cols = []
        for item in clause.items:
            if item.alias:
                cols.append(item.alias)
            elif isinstance(item.expr, A.Var):
                cols.append(item.expr.name)
            elif isinstance(item.expr, A.Prop) and isinstance(item.expr.target, A.Var):
                cols.append(f"{item.expr.target.name}.{item.expr.name}")
            else:
                cols.append(item.text)
        return cols

    def _exec_projection(self, clause, rows, ctx):
        cols, _vals, dict_rows = self._project(clause, rows, ctx)
        return dict_rows

    def _project(self, clause, rows, ctx):
        """Shared WITH/RETURN projection. Returns (cols, rows_as_value_lists,
        rows_as_dicts) so RETURN keeps duplicate-named columns positional."""
        rows = list(rows)
        has_agg = any(_contains_agg(i.expr) for i in clause.items)
        star_keys: List[str] = []
        if clause.star:
            seen = set()
            for r in rows:
                for k in r:
                    if k not in seen:
                        seen.add(k)
                        star_keys.append(k)
        cols = (star_keys if clause.star else []) + self._projection_columns(
            clause, rows[0] if rows else {}
        )
        if has_agg:
            out_rows = self._aggregate(clause, rows, ctx, star_keys)
            # ORDER BY after aggregation can only see the projected columns
            envs = [dict(zip(cols, r)) for r in out_rows]
        else:
            out_rows = []
            envs = []
            for row in rows:
                vals = [row.get(k) for k in star_keys]
                vals += [self._eval(i.expr, row, ctx) for i in clause.items]
                out_rows.append(vals)
                # ORDER BY may reference pre-projection variables (Cypher
                # allows ORDER BY p.name after RETURN p.name AS x)
                envs.append({**row, **dict(zip(cols, vals))})
        if clause.distinct:
            seen = set()
            dd, de = [], []
            for r, env in zip(out_rows, envs):
                key = _hashable(r)
                if key not in seen:
                    seen.add(key)
                    dd.append(r)
                    de.append(env)
            out_rows, envs = dd, de
        if clause.order_by:
            out_rows, envs = self._order_rows(clause, cols, out_rows, envs, ctx)
        if clause.skip is not None:
            n_skip = int(self._eval(clause.skip, {}, ctx))
            out_rows, envs = out_rows[n_skip:], envs[n_skip:]
        if clause.limit is not None:
            n_lim = int(self._eval(clause.limit, {}, ctx))
            out_rows, envs = out_rows[:n_lim], envs[:n_lim]
        new_rows = [dict(zip(cols, r)) for r in out_rows]
        if isinstance(clause, A.WithClause) and clause.where is not None:
            kept = [
                (v, r)
                for v, r in zip(out_rows, new_rows)
                if _truthy(self._eval(clause.where, r, ctx))
            ]
            out_rows = [v for v, _ in kept]
            new_rows = [r for _, r in kept]
        return cols, out_rows, new_rows

    def _order_rows(self, clause, cols, out_rows, envs, ctx):
        import functools as _ft

        # ORDER BY may reference a projected item by its expression (legal
        # for grouping keys after aggregation: RETURN o.city, count(*) AS n
        # ORDER BY n DESC, o.city) — resolve those to column positions
        # first, because the source variable is out of scope post-projection.
        col_of_expr: List[Optional[int]] = []
        for expr, _desc in clause.order_by:
            pos = None
            for i, item in enumerate(clause.items):
                if item.expr == expr:
                    pos = len(cols) - len(clause.items) + i
                    break
            col_of_expr.append(pos)
        keyed = []
        for vals, env in zip(out_rows, envs):
            keys = []
            for (expr, desc), pos in zip(clause.order_by, col_of_expr):
                if pos is not None:
                    v = vals[pos]
                else:
                    try:
                        v = self._eval(expr, env, ctx)
                    except CypherRuntimeError:
                        v = None
                keys.append((v, desc))
            keyed.append((keys, vals, env))

        def cmp(a, b):
            for (va, desc), (vb, _) in zip(a[0], b[0]):
                c = _cypher_cmp(va, vb)
                if c != 0:
                    return -c if desc else c
            return 0

        keyed.sort(key=_ft.cmp_to_key(cmp))
        return [k[1] for k in keyed], [k[2] for k in keyed]

    def _aggregate(self, clause, rows, ctx, star_keys):
        group_items = [
            (i, item) for i, item in enumerate(clause.items)
            if not _contains_agg(item.expr)
        ]
        agg_items = [
            (i, item) for i, item in enumerate(clause.items)
            if _contains_agg(item.expr)
        ]
        groups: Dict[Any, Dict] = {}
        order: List[Any] = []
        for row in rows:
            gvals = [row.get(k) for k in star_keys]
            gvals += [self._eval(item.expr, row, ctx) for _, item in group_items]
            key = _hashable(gvals)
            if key not in groups:
                groups[key] = {"gvals": gvals, "rows": []}
                order.append(key)
            groups[key]["rows"].append(row)
        if not rows and not group_items and not star_keys:
            groups[()] = {"gvals": [], "rows": []}
            order.append(())
        out = []
        n_cols = len(star_keys) + len(clause.items)
        for key in order:
            g = groups[key]
            vals: List[Any] = [None] * n_cols
            for j in range(len(star_keys)):
                vals[j] = g["gvals"][j]
            for idx, (i, item) in enumerate(group_items):
                vals[len(star_keys) + i] = g["gvals"][len(star_keys) + idx]
            for i, item in agg_items:
                vals[len(star_keys) + i] = self._eval_agg(item.expr, g["rows"], ctx)
            out.append(vals)
        return out

    def _eval_agg(self, e: A.Expr, rows: List[Dict], ctx) -> Any:
        """Evaluate an expression containing aggregate calls over a group."""
        if isinstance(e, A.FuncCall) and _is_agg_name(e.name):
            return self._run_agg(e, rows, ctx)
        if isinstance(e, A.Binary):
            l = self._eval_agg(e.left, rows, ctx)
            r = self._eval_agg(e.right, rows, ctx)
            return self._eval_binary(
                A.Binary(e.op, A.Literal(l), A.Literal(r)), {}, ctx
            )
        if isinstance(e, A.Unary):
            v = self._eval_agg(e.operand, rows, ctx)
            return self._eval(A.Unary(e.op, A.Literal(v)), {}, ctx)
        if isinstance(e, A.FuncCall):
            args = [self._eval_agg(a, rows, ctx) for a in e.args]
            return self._eval_func(
                A.FuncCall(e.name, [A.Literal(a) for a in args]), {}, ctx
            )
        if isinstance(e, A.Prop):
            inner = self._eval_agg(e.target, rows, ctx)
            return self._eval(A.Prop(A.Literal(inner), e.name), {}, ctx)
        if isinstance(e, A.Index):
            target = self._eval_agg(e.target, rows, ctx)
            idx = self._eval_agg(e.index, rows, ctx)
            return self._eval(A.Index(A.Literal(target), A.Literal(idx)), {}, ctx)
        if isinstance(e, A.Slice):
            target = self._eval_agg(e.target, rows, ctx)
            s = A.Literal(self._eval_agg(e.start, rows, ctx)) if e.start else None
            t = A.Literal(self._eval_agg(e.end, rows, ctx)) if e.end else None
            return self._eval(A.Slice(A.Literal(target), s, t), {}, ctx)
        if isinstance(e, A.MapExpr):
            return {k: self._eval_agg(v, rows, ctx) for k, v in e.items}
        if isinstance(e, A.ListExpr):
            return [self._eval_agg(x, rows, ctx) for x in e.items]
        # plain expression in agg context: evaluate on first row (grouping key
        # normally catches this case)
        return self._eval(e, rows[0], ctx) if rows else None

    def _run_agg(self, e: A.FuncCall, rows: List[Dict], ctx) -> Any:
        name = e.name
        if name.startswith("apoc.agg."):
            from nornicdb_tpu_torch.query.apoc_bulk import AGG_FINALIZERS

            fin = AGG_FINALIZERS.get(name)
            if fin is None:
                raise CypherRuntimeError(f"unknown aggregate {name}()")
            arg_rows = [
                tuple(self._eval(a, row, ctx) for a in e.args)
                for row in rows
            ]
            if e.distinct:
                seen = set()
                dd = []
                for t in arg_rows:
                    key = _hashable(list(t))
                    if key not in seen:
                        seen.add(key)
                        dd.append(t)
                arg_rows = dd
            return fin(arg_rows)
        if name == "count" and e.star:
            return len(rows)
        values = []
        for row in rows:
            v = self._eval(e.args[0], row, ctx) if e.args else None
            if v is not None:
                values.append(v)
        if e.distinct:
            seen = set()
            dd = []
            for v in values:
                key = _hashable([v])
                if key not in seen:
                    seen.add(key)
                    dd.append(v)
            values = dd
        if name == "count":
            return len(values)
        if name == "collect":
            return values
        if name == "sum":
            return sum(values) if values else 0
        if name == "avg":
            return (sum(values) / len(values)) if values else None
        if name == "min":
            return min(values, key=_cmp_key) if values else None
        if name == "max":
            return max(values, key=_cmp_key) if values else None
        if name in ("stdev", "stdevp"):
            if len(values) < 2:
                return 0.0
            mean = sum(values) / len(values)
            var = sum((x - mean) ** 2 for x in values)
            var /= (len(values) - 1) if name == "stdev" else len(values)
            return var ** 0.5
        if name in ("percentilecont", "percentiledisc"):
            if not values:
                return None
            pct = self._eval(e.args[1], rows[0], ctx)
            values = sorted(values)
            pos = pct * (len(values) - 1)
            if name == "percentiledisc":
                return values[round(pos)]
            lo, hi = int(pos), min(int(pos) + 1, len(values) - 1)
            frac = pos - int(pos)
            return values[lo] * (1 - frac) + values[hi] * frac
        raise CypherRuntimeError(f"unknown aggregate {name}()")

    def _exec_return(self, clause: A.ReturnClause, rows, ctx) -> CypherResult:
        cols, val_rows, _dicts = self._project(clause, rows, ctx)
        return CypherResult(columns=cols, rows=val_rows)

    # -- CALL procedures --------------------------------------------------

    def _exec_call(self, clause: A.CallClause, rows, ctx, standalone=False):
        from nornicdb_tpu_torch.query.procedures import run_procedure

        for row in rows:
            args = [self._eval(a, row, ctx) for a in clause.args]
            for rec in run_procedure(self, clause.proc, args, ctx):
                out = dict(row)
                if clause.yield_star or not clause.yield_items:
                    out.update(rec)
                else:
                    for name, alias in clause.yield_items:
                        if name not in rec:
                            raise CypherRuntimeError(
                                f"procedure {clause.proc} has no field {name}"
                            )
                        out[alias or name] = rec[name]
                if clause.where is not None and not _truthy(
                    self._eval(clause.where, out, ctx)
                ):
                    continue
                yield out


# -- helpers -------------------------------------------------------------

_WRITE_CLAUSES = (
    A.CreateClause, A.MergeClause, A.SetClause, A.RemoveClause, A.DeleteClause,
)

# Functions whose results must never be served from cache. Clock
# constructors (date/datetime/...) are volatile only when called with no
# argument; their .transaction/.statement/.realtime variants always are.
_VOLATILE_ALWAYS = frozenset({
    "rand", "randomuuid", "timestamp", "apoc.create.uuid",
    "apoc.create.uuidbase64", "apoc.create.uuids", "apoc.util.uuid",
    "apoc.util.randomuuid", "apoc.util.now", "apoc.util.nowinseconds",
    "apoc.util.timestamp", "apoc.util.sleep", "apoc.number.random",
    "apoc.number.randomint", "apoc.math.random", "apoc.math.randomint",
    "apoc.coll.shuffle", "apoc.coll.randomitems",
})
# whole families whose state lives outside storage (schema registry,
# lock table, log ring, trigger/job registries): results must never be
# served from the query-result cache because storage writes are not
# what invalidates them
_VOLATILE_PREFIXES = (
    "apoc.schema.", "apoc.lock.", "apoc.log.", "apoc.trigger.",
    "apoc.periodic.", "apoc.warmup.", "apoc.atomic.", "apoc.merge.",
    "apoc.refactor.", "apoc.create.", "apoc.cypher.", "apoc.import.",
    "apoc.export.", "apoc.load.", "apoc.meta.",
)
_CLOCK_FUNCS = frozenset({
    "date", "datetime", "localdatetime", "time", "localtime",
})
_CLOCK_SUFFIXES = (".transaction", ".statement", ".realtime")


def _is_read_only(uq: "A.UnionQuery") -> bool:
    """Cacheable = no write clauses and no CALL (procedures may write)."""
    for part in uq.parts:
        for clause in part.clauses:
            if isinstance(clause, _WRITE_CLAUSES + (A.CallClause,)):
                return False
    return True


def _has_volatile_call(obj: Any) -> bool:
    """Walk the parsed query's dataclass tree for volatile FuncCalls."""
    if isinstance(obj, A.FuncCall):
        name = obj.name
        if name in _VOLATILE_ALWAYS:
            return True
        if name.startswith(_VOLATILE_PREFIXES):
            return True
        if name in _CLOCK_FUNCS and not obj.args and not obj.star:
            return True
        if name.endswith(_CLOCK_SUFFIXES):
            return True
    import dataclasses

    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return any(
            _has_volatile_call(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
        )
    if isinstance(obj, (list, tuple)):
        return any(_has_volatile_call(x) for x in obj)
    return False


def _cache_key(query: str, params: Optional[Dict[str, Any]],
               uq: Optional["A.UnionQuery"] = None):
    if uq is not None and _has_volatile_call(uq):
        return None
    if not params:
        return query
    try:
        import json

        return (query, json.dumps(params, sort_keys=True, default=str))
    except (TypeError, ValueError):
        return None


def _truthy(v: Any) -> bool:
    return bool(v) if v is not None else False


def _to_str(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    return str(v)


def _cypher_eq(a: Any, b: Any) -> bool:
    if isinstance(a, (Node, Edge)) and isinstance(b, (Node, Edge)):
        return a.id == b.id
    if isinstance(a, bool) != isinstance(b, bool):
        return False
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        return a == b
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_cypher_eq(x, y) for x, y in zip(a, b))
    return a == b


_TYPE_ORDER = {str: 0, bool: 1, int: 2, float: 2, list: 3, dict: 4, type(None): 9}


def _cypher_cmp(a: Any, b: Any) -> int:
    """Total order for ORDER BY: numbers < strings? Neo4j: null sorts last
    ascending; mixed types ordered by type."""
    if a is None and b is None:
        return 0
    if a is None:
        return 1
    if b is None:
        return -1
    ta = _TYPE_ORDER.get(type(a), 5)
    tb = _TYPE_ORDER.get(type(b), 5)
    if ta != tb:
        return -1 if ta < tb else 1
    try:
        if a < b:
            return -1
        if a > b:
            return 1
        return 0
    except TypeError:
        return 0


def _cmp_key(v):
    import functools as _ft

    class K:
        def __init__(self, val):
            self.val = val

        def __lt__(self, other):
            return _cypher_cmp(self.val, other.val) < 0

    return K(v)


def _hashable(vals: Sequence[Any]) -> Any:
    out = []
    for v in vals:
        if isinstance(v, (Node, Edge)):
            out.append(("__ent__", v.id))
        elif isinstance(v, list):
            out.append(("__list__", _hashable(v)))
        elif isinstance(v, dict):
            out.append(("__map__", tuple(sorted(
                (k, _hashable([x])) for k, x in v.items()
            ))))
        elif isinstance(v, PathValue):
            out.append(("__path__", tuple(n.id for n in v.nodes),
                        tuple(r.id for r in v.rels)))
        else:
            out.append(v)
    return tuple(out)


def _strip_null_props(props: Dict[str, Any]) -> None:
    for k in [k for k, v in props.items() if v is None]:
        del props[k]


def _refresh(row: Dict, ctx, node_id: str) -> Dict:
    """Re-fetch a mutated node into every binding that references it."""
    try:
        fresh = ctx.storage.get_node(node_id)
    except KeyError:
        return row
    out = dict(row)
    for k, v in out.items():
        if isinstance(v, Node) and v.id == node_id:
            out[k] = fresh
    return out


def _refresh_edge(row: Dict, ctx, edge_id: str) -> Dict:
    try:
        fresh = ctx.storage.get_edge(edge_id)
    except KeyError:
        return row
    out = dict(row)
    for k, v in out.items():
        if isinstance(v, Edge) and v.id == edge_id:
            out[k] = fresh
    return out


def _contains_agg(e: A.Expr) -> bool:
    if isinstance(e, A.FuncCall):
        if _is_agg_name(e.name):
            return True
        return any(_contains_agg(a) for a in e.args)
    if isinstance(e, A.Binary):
        return _contains_agg(e.left) or _contains_agg(e.right)
    if isinstance(e, A.Unary):
        return _contains_agg(e.operand)
    if isinstance(e, A.Prop):
        return _contains_agg(e.target)
    if isinstance(e, A.ListExpr):
        return any(_contains_agg(x) for x in e.items)
    if isinstance(e, A.MapExpr):
        return any(_contains_agg(v) for _, v in e.items)
    if isinstance(e, A.Index):
        return _contains_agg(e.target) or _contains_agg(e.index)
    if isinstance(e, A.Slice):
        parts = [e.target] + [x for x in (e.start, e.end) if x is not None]
        return any(_contains_agg(p) for p in parts)
    if isinstance(e, A.ListComp):
        parts = [e.source] + [x for x in (e.where, e.projection) if x is not None]
        return any(_contains_agg(p) for p in parts)
    if isinstance(e, A.ListPredicate):
        return _contains_agg(e.source) or _contains_agg(e.where)
    if isinstance(e, A.Reduce):
        return any(_contains_agg(p) for p in (e.init, e.source, e.expr))
    if isinstance(e, A.CaseExpr):
        parts = [e.subject] if e.subject else []
        for c, v in e.whens:
            parts += [c, v]
        if e.default:
            parts.append(e.default)
        return any(_contains_agg(p) for p in parts if p is not None)
    return False
