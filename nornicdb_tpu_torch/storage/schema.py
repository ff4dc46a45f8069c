"""Schema constraints: unique / property-type / relationship-endpoint /
temporal-interval validation, with persistence (counterpart of
``nornicdb_tpu/storage/schema.py``).

Reference: pkg/storage constraint_validation.go, property_validation.go,
temporal_constraint.go:9 (temporalInterval), schema.go,
schema_persistence.go. Constraints are checked by a decorator engine so
any base engine (memory, native disk, namespaced) gets the same
enforcement.
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from nornicdb_tpu_torch.errors import ConstraintViolationError
from nornicdb_tpu_torch.storage.types import Edge, Engine, EngineDecorator, Node


class ConstraintViolation(ConstraintViolationError, ValueError):
    """A mutation violated a schema constraint."""


PROPERTY_TYPES = {
    "string": str,
    "int": int,
    "float": (int, float),
    "bool": bool,
    "list": (list, tuple),
    "map": dict,
}


@dataclass
class Constraint:
    """One constraint definition.

    kinds:
      ``unique``        — (label, property) values unique across nodes
      ``exists``        — (label, property) must be present & non-null
      ``type``          — (label, property) must match ``property_type``
      ``rel_endpoints`` — edges of ``rel_type`` must connect
                          ``start_label`` -> ``end_label``
      ``temporal``      — (label, property) pair names an interval:
                          ``property`` (start) <= ``property2`` (end)
    """

    name: str
    kind: str
    label: str = ""
    property: str = ""
    property2: str = ""
    property_type: str = ""
    rel_type: str = ""
    start_label: str = ""
    end_label: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Constraint":
        return Constraint(**{k: d.get(k, "") for k in (
            "name", "kind", "label", "property", "property2",
            "property_type", "rel_type", "start_label", "end_label")})


class SchemaManager:
    """Holds constraint definitions + optional JSON persistence
    (reference: schema_persistence.go)."""

    def __init__(self, path: Optional[str] = None):
        self._path = path
        self._constraints: Dict[str, Constraint] = {}
        self._lock = threading.Lock()
        if path and os.path.exists(path):
            with open(path, "r", encoding="utf-8") as f:
                for d in json.load(f):
                    c = Constraint.from_dict(d)
                    self._constraints[c.name] = c

    def _persist(self) -> None:
        if not self._path:
            return
        tmp = self._path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump([c.to_dict() for c in self._constraints.values()], f)
        os.replace(tmp, self._path)

    def add(self, c: Constraint) -> None:
        with self._lock:
            if c.name in self._constraints:
                raise ConstraintViolation(f"constraint exists: {c.name}")
            if c.kind not in ("unique", "exists", "type", "rel_endpoints", "temporal"):
                raise ConstraintViolation(f"unknown constraint kind: {c.kind}")
            self._constraints[c.name] = c
            self._persist()

    def drop(self, name: str) -> bool:
        with self._lock:
            existed = self._constraints.pop(name, None) is not None
            if existed:
                self._persist()
            return existed

    def list(self) -> List[Constraint]:
        with self._lock:
            return list(self._constraints.values())

    def for_label(self, label: str) -> List[Constraint]:
        with self._lock:
            return [c for c in self._constraints.values()
                    if c.label == label or not c.label]

    def applicable(self, labels: List[str]) -> List[Constraint]:
        """Constraints that apply to a node with these labels — global
        (label="") constraints apply to every node, even label-less ones."""
        lset = set(labels)
        with self._lock:
            return [c for c in self._constraints.values()
                    if c.kind != "rel_endpoints"
                    and (not c.label or c.label in lset)]

    def for_rel_type(self, rel_type: str) -> List[Constraint]:
        with self._lock:
            return [c for c in self._constraints.values()
                    if c.kind == "rel_endpoints" and c.rel_type == rel_type]


def _check_node(storage: Engine, sm: SchemaManager, node: Node,
                exclude_id: Optional[str] = None,
                unique_index: Optional["UniqueIndex"] = None) -> None:
    for c in sm.applicable(node.labels):
        label = c.label or "(any)"
        if c.kind == "exists":
            if node.properties.get(c.property) is None:
                raise ConstraintViolation(
                    f"{c.name}: {label}.{c.property} must exist")
        elif c.kind == "type":
            v = node.properties.get(c.property)
            want = PROPERTY_TYPES.get(c.property_type)
            if v is not None and want is not None and not isinstance(v, want):
                raise ConstraintViolation(
                    f"{c.name}: {label}.{c.property} must be {c.property_type}")
            if (v is not None and c.property_type == "int"
                    and isinstance(v, bool)):
                # bool is an int subclass; an int constraint must still
                # reject True/False
                raise ConstraintViolation(
                    f"{c.name}: {label}.{c.property} must be int")
        elif c.kind == "unique":
            v = node.properties.get(c.property)
            if v is None:
                continue
            owner = unique_index.lookup(c, v) if unique_index is not None else None
            if unique_index is None:
                # no index available: fall back to a scan
                others = (storage.get_nodes_by_label(c.label) if c.label
                          else storage.all_nodes())
                for other in others:
                    if other.id != (exclude_id or node.id) \
                            and other.properties.get(c.property) == v:
                        owner = other.id
                        break
            if owner is not None and owner != (exclude_id or node.id):
                raise ConstraintViolation(
                    f"{c.name}: duplicate {label}.{c.property}={v!r}")
        elif c.kind == "temporal":
            start = node.properties.get(c.property)
            end = node.properties.get(c.property2)
            if start is not None and end is not None:
                try:
                    if start > end:
                        raise ConstraintViolation(
                            f"{c.name}: interval {c.property} > {c.property2}")
                except TypeError:
                    raise ConstraintViolation(
                        f"{c.name}: interval endpoints not comparable")


def _check_edge(storage: Engine, sm: SchemaManager, edge: Edge) -> None:
    for c in sm.for_rel_type(edge.type):
        try:
            start = storage.get_node(edge.start_node)
            end = storage.get_node(edge.end_node)
        except KeyError:
            return  # endpoint existence is the engine's own check
        if c.start_label and c.start_label not in start.labels:
            raise ConstraintViolation(
                f"{c.name}: {edge.type} start must be :{c.start_label}")
        if c.end_label and c.end_label not in end.labels:
            raise ConstraintViolation(
                f"{c.name}: {edge.type} end must be :{c.end_label}")


class UniqueIndex:
    """Maintained (constraint, value) -> node_id map so unique checks are
    O(1) instead of a per-insert label scan (the reference backs unique
    constraints with an index). Built lazily per constraint, kept fresh by
    ConstrainedEngine's mutation hooks."""

    def __init__(self, storage: Engine):
        self._storage = storage
        # forward: key -> {value: node_id}; reverse: key -> {node_id: value}
        # — the reverse map makes per-mutation eviction O(1) instead of a
        # full value-map scan
        self._maps: Dict[Tuple[str, str], Dict[Any, str]] = {}
        self._owners: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self._lock = threading.Lock()

    def _key(self, c: Constraint) -> Tuple[str, str]:
        return (c.label, c.property)

    @staticmethod
    def _hashable(v: Any) -> Any:
        try:
            hash(v)
            return v
        except TypeError:
            return repr(v)

    def _ensure(self, c: Constraint) -> Dict[Any, str]:
        key = self._key(c)
        m = self._maps.get(key)
        if m is None:
            m = {}
            owners: Dict[str, Any] = {}
            nodes = (self._storage.get_nodes_by_label(c.label) if c.label
                     else list(self._storage.all_nodes()))
            for n in nodes:
                v = n.properties.get(c.property)
                if v is not None:
                    hv = self._hashable(v)
                    m[hv] = n.id
                    owners[n.id] = hv
            self._maps[key] = m
            self._owners[key] = owners
        return m

    def lookup(self, c: Constraint, value: Any) -> Optional[str]:
        with self._lock:
            return self._ensure(c).get(self._hashable(value))

    def on_upsert(self, constraints: List[Constraint], node: Node) -> None:
        with self._lock:
            for c in constraints:
                if c.kind != "unique":
                    continue
                if c.label and c.label not in node.labels:
                    continue
                key = self._key(c)
                m = self._maps.get(key)
                if m is None:
                    continue  # not built yet; next lookup scans fresh
                owners = self._owners[key]
                old = owners.pop(node.id, None)
                if old is not None and m.get(old) == node.id:
                    del m[old]
                v = node.properties.get(c.property)
                if v is not None:
                    hv = self._hashable(v)
                    m[hv] = node.id
                    owners[node.id] = hv

    def on_delete(self, node_id: str) -> None:
        with self._lock:
            for key, owners in self._owners.items():
                old = owners.pop(node_id, None)
                if old is not None:
                    m = self._maps[key]
                    if m.get(old) == node_id:
                        del m[old]


class ConstrainedEngine(EngineDecorator):
    """Decorator enforcing SchemaManager constraints on every mutation."""

    def __init__(self, inner: Engine, schema: Optional[SchemaManager] = None):
        super().__init__(inner)
        self.schema = schema or SchemaManager()
        self._unique = UniqueIndex(inner)

    def create_node(self, node: Node) -> None:
        _check_node(self.inner, self.schema, node, unique_index=self._unique)
        self.inner.create_node(node)
        self._unique.on_upsert(self.schema.list(), node)

    def update_node(self, node: Node) -> None:
        _check_node(self.inner, self.schema, node, exclude_id=node.id,
                    unique_index=self._unique)
        self.inner.update_node(node)
        self._unique.on_upsert(self.schema.list(), node)

    def delete_node(self, node_id: str) -> None:
        self.inner.delete_node(node_id)
        self._unique.on_delete(node_id)

    def create_edge(self, edge: Edge) -> None:
        _check_edge(self.inner, self.schema, edge)
        self.inner.create_edge(edge)

    def validate_existing(self) -> List[str]:
        """Sweep the store, returning violations (used when adding a
        constraint over existing data)."""
        problems: List[str] = []
        for node in self.inner.all_nodes():
            try:
                _check_node(self.inner, self.schema, node, exclude_id=node.id)
            except ConstraintViolation as e:
                problems.append(str(e))
        for edge in self.inner.all_edges():
            try:
                _check_edge(self.inner, self.schema, edge)
            except ConstraintViolation as e:
                problems.append(str(e))
        return problems


# ---------------------------------------------------------------------------
# Receipts (reference: pkg/storage/receipt.go:13,24 — mutation receipts
# tied to WAL sequence, hash-chained for an audit ledger)
# ---------------------------------------------------------------------------

import hashlib


@dataclass
class Receipt:
    sequence: int
    operation: str
    entity_id: str
    timestamp_ms: int
    prev_hash: str
    hash: str = ""

    def compute_hash(self) -> str:
        payload = f"{self.sequence}|{self.operation}|{self.entity_id}|{self.timestamp_ms}|{self.prev_hash}"
        return hashlib.sha256(payload.encode()).hexdigest()


class ReceiptLedger:
    """Hash-chained mutation receipts; verifiable like a mini audit chain."""

    def __init__(self) -> None:
        self._receipts: List[Receipt] = []
        self._lock = threading.Lock()

    def record(self, operation: str, entity_id: str, sequence: Optional[int] = None,
               timestamp_ms: Optional[int] = None) -> Receipt:
        from nornicdb_tpu_torch.storage.types import now_ms

        with self._lock:
            prev = self._receipts[-1].hash if self._receipts else "genesis"
            r = Receipt(
                sequence=sequence if sequence is not None else len(self._receipts) + 1,
                operation=operation,
                entity_id=entity_id,
                timestamp_ms=timestamp_ms if timestamp_ms is not None else now_ms(),
                prev_hash=prev,
            )
            r.hash = r.compute_hash()
            self._receipts.append(r)
            return r

    def verify(self) -> Tuple[bool, int]:
        """Returns (ok, first_bad_index). Tamper with any receipt and the
        chain breaks from there."""
        with self._lock:
            prev = "genesis"
            for i, r in enumerate(self._receipts):
                if r.prev_hash != prev or r.hash != r.compute_hash():
                    return False, i
                prev = r.hash
            return True, -1

    def all(self) -> List[Receipt]:
        with self._lock:
            return list(self._receipts)
