"""Data retention policies
(counterpart of ``nornicdb_tpu/retention.py``).

Reference: pkg/retention/retention.go — label/age-based retention rules
swept periodically; nodes past their window are archived or deleted.
Also carries the GDPR delete/export helpers the HTTP admin surface uses
(reference: pkg/server GDPR export/delete routes).
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from nornicdb_tpu_torch.storage.types import Engine, Node, now_ms


@dataclass
class RetentionPolicy:
    """Delete-or-archive rule for one label (empty label = all nodes)."""

    name: str
    max_age_days: float
    label: str = ""
    action: str = "archive"  # archive | delete
    property_filter: Dict[str, Any] = field(default_factory=dict)
    # compliance annotations (reference: retention.go package doc —
    # policies cite the framework that mandates them)
    category: str = ""       # pii | audit | financial | health | ""
    framework: str = ""      # e.g. "GDPR Art.5(1)(e)", "SOX", "HIPAA"

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name, "max_age_days": self.max_age_days,
            "label": self.label, "action": self.action,
            "property_filter": dict(self.property_filter),
            "category": self.category, "framework": self.framework,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RetentionPolicy":
        return cls(
            name=d["name"], max_age_days=float(d["max_age_days"]),
            label=d.get("label", ""), action=d.get("action", "archive"),
            property_filter=dict(d.get("property_filter", {})),
            category=d.get("category", ""),
            framework=d.get("framework", ""),
        )


def default_policies() -> List[RetentionPolicy]:
    """Compliance-framework defaults (reference: retention.go
    DefaultPolicies — GDPR storage limitation, HIPAA 6y, FISMA audit,
    SOX 7y financial records)."""
    return [
        RetentionPolicy(
            name="gdpr-pii", label="PII", max_age_days=3 * 365,
            action="delete", category="pii",
            framework="GDPR Art.5(1)(e)"),
        RetentionPolicy(
            name="hipaa-health", label="Health", max_age_days=6 * 365,
            action="archive", category="health",
            framework="HIPAA §164.530(j)"),
        RetentionPolicy(
            name="fisma-audit", label="Audit", max_age_days=6 * 365,
            action="archive", category="audit", framework="FISMA AU-11"),
        RetentionPolicy(
            name="sox-financial", label="Financial",
            max_age_days=7 * 365, action="archive", category="financial",
            framework="SOX"),
        RetentionPolicy(
            name="soc2-records", label="Record", max_age_days=7 * 365,
            action="archive", category="audit", framework="SOC2 CC7.4"),
    ]


@dataclass
class SweepResult:
    scanned: int = 0
    archived: int = 0
    deleted: int = 0
    held: int = 0  # deletions blocked by a legal hold


class RetentionManager:
    """Policy registry + sweeper with legal holds and archive-before-
    delete (reference: retention.go — legal hold support 'prevents
    deletion during litigation'; SetArchiveCallback)."""

    def __init__(self, storage: Engine, archive_callback=None):
        self.storage = storage
        self._policies: Dict[str, RetentionPolicy] = {}
        self._lock = threading.Lock()
        # subject property -> held values (legal holds)
        self._holds: Dict[str, set] = {}
        # called with the node dict before a delete-action removal
        self.archive_callback = archive_callback

    # -- legal holds (retention.go: legal hold support) -------------------

    def add_legal_hold(self, match_property: str, match_value: Any) -> None:
        """Nodes whose ``match_property`` equals ``match_value`` are
        exempt from retention deletion and GDPR erasure until the hold
        is released."""
        with self._lock:
            self._holds.setdefault(match_property, set()).add(match_value)

    def release_legal_hold(self, match_property: str, match_value: Any) -> bool:
        with self._lock:
            vals = self._holds.get(match_property)
            if vals and match_value in vals:
                vals.discard(match_value)
                if not vals:
                    self._holds.pop(match_property)
                return True
            return False

    def legal_holds(self) -> Dict[str, List[Any]]:
        with self._lock:
            return {k: sorted(v, key=str) for k, v in self._holds.items()}

    def is_held(self, node: Node) -> bool:
        with self._lock:
            holds = {k: set(v) for k, v in self._holds.items()}
        return any(
            node.properties.get(k) in vals for k, vals in holds.items()
        )

    # -- persistence (retention.go: policy save/load from JSON) -----------

    def save_policies(self, path: str) -> None:
        with self._lock:
            data = [p.to_dict() for p in self._policies.values()]
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"policies": data}, f, indent=1)

    def load_policies(self, path: str) -> int:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        n = 0
        for d in data.get("policies", []):
            self.add_policy(RetentionPolicy.from_dict(d))
            n += 1
        return n

    def add_policy(self, policy: RetentionPolicy) -> None:
        if policy.action not in ("archive", "delete"):
            raise ValueError(f"invalid action: {policy.action}")
        with self._lock:
            self._policies[policy.name] = policy

    def remove_policy(self, name: str) -> bool:
        with self._lock:
            return self._policies.pop(name, None) is not None

    def policies(self) -> List[RetentionPolicy]:
        with self._lock:
            return list(self._policies.values())

    def _matches(self, policy: RetentionPolicy, node: Node, now: int) -> bool:
        if policy.label and policy.label not in node.labels:
            return False
        for k, v in policy.property_filter.items():
            if node.properties.get(k) != v:
                return False
        ts = node.updated_at or node.created_at
        if not ts:
            return False
        return (now - ts) > policy.max_age_days * 86_400_000

    def sweep(self, now: Optional[int] = None) -> SweepResult:
        now = now if now is not None else now_ms()
        res = SweepResult()
        with self._lock:
            policies = list(self._policies.values())
        if not policies:
            return res
        for node in list(self.storage.all_nodes()):
            res.scanned += 1
            for p in policies:
                if not self._matches(p, node, now):
                    continue
                if p.action == "delete":
                    if self.is_held(node):
                        res.held += 1
                        break  # legal hold: no deletion while held
                    if self.archive_callback is not None:
                        # archive-before-delete (retention.go)
                        self.archive_callback(node.to_dict())
                    try:
                        self.storage.delete_node(node.id)
                        res.deleted += 1
                    except KeyError:
                        pass
                elif not node.properties.get("_archived"):
                    node.properties["_archived"] = True
                    node.properties["_archived_at"] = now
                    try:
                        self.storage.update_node(node)
                        res.archived += 1
                    except KeyError:
                        pass
                break  # first matching policy wins
        return res


# -- GDPR helpers (reference: pkg/server GDPR export/delete) ----------------


def gdpr_export(storage: Engine, match_property: str, match_value: Any) -> Dict[str, Any]:
    """Export every node (and its edges) whose property matches — the
    data-subject access request path."""
    nodes = [n for n in storage.all_nodes()
             if n.properties.get(match_property) == match_value]
    ids = {n.id for n in nodes}
    edges = [e for e in storage.all_edges()
             if e.start_node in ids or e.end_node in ids]
    return {
        "exported_at_ms": int(time.time() * 1000),
        "match": {match_property: match_value},
        "nodes": [n.to_dict() for n in nodes],
        "edges": [e.to_dict() for e in edges],
    }


def gdpr_delete(storage: Engine, match_property: str, match_value: Any,
                retention: Optional[RetentionManager] = None) -> int:
    """Hard-delete all matching nodes (edges cascade). Returns count.
    When a RetentionManager is supplied, erasure respects its legal
    holds (reference: ProcessErasure 'respects legal holds')."""
    matches = [n for n in storage.all_nodes()
               if n.properties.get(match_property) == match_value]
    deleted = 0
    for node in matches:
        if retention is not None and retention.is_held(node):
            continue
        try:
            storage.delete_node(node.id)
            deleted += 1
        except KeyError:
            pass
    return deleted
