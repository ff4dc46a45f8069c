"""Environment switches (a copy of ``env_bool``, ``env_int``,
``env_float`` and ``env_str`` from ``nornicdb_tpu/config.py``): every
name is read with the ``NORNICDB_`` prefix, and a missing or malformed
value gives the default. ``flags`` holds the runtime feature flags that
``/admin/flags`` reads and sets (the reference's ``FeatureFlags``)."""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, Optional

ENV_PREFIX = "NORNICDB_"


def env_bool(name: str, default: bool = False) -> bool:
    v = os.environ.get(ENV_PREFIX + name)
    if v is None:
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


def env_int(name: str, default: int = 0) -> int:
    v = os.environ.get(ENV_PREFIX + name)
    if v is None:
        return default
    try:
        return int(v)
    except ValueError:
        return default


def env_float(name: str, default: float = 0.0) -> float:
    v = os.environ.get(ENV_PREFIX + name)
    if v is None:
        return default
    try:
        return float(v)
    except ValueError:
        return default


def env_str(name: str, default: str = "") -> str:
    return os.environ.get(ENV_PREFIX + name, default)


_FLAG_DEFAULTS: Dict[str, Any] = {
    "parser": "nornic",  # nornic | strict
    "kalman_decay": True,
    "auto_tlp": True,  # topology link prediction feeding inference
    "inference_cooldown": True,
    "query_cache": True,
    "fast_paths": True,
    "parallel_execution": True,
    "seed_hnsw_from_bm25": True,
    "search_diag_timings": False,
}


class FeatureFlags:
    """Thread-safe runtime-mutable flags. Env ``NORNICDB_FLAG_*`` (e.g.
    NORNICDB_FLAG_PARSER=strict) is consulted live on each read so import
    order doesn't freeze values; an explicit ``set()`` wins over env."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._explicit: Dict[str, Any] = {}

    def _from_env(self, name: str, default: Any) -> Any:
        raw = os.environ.get(ENV_PREFIX + "FLAG_" + name.upper())
        if raw is None:
            return default
        if isinstance(default, bool):
            return raw.strip().lower() in ("1", "true", "yes", "on")
        return raw

    def get(self, name: str, default: Any = None) -> Any:
        with self._lock:
            if name in self._explicit:
                return self._explicit[name]
        return self._from_env(name, _FLAG_DEFAULTS.get(name, default))

    def set(self, name: str, value: Any) -> None:
        with self._lock:
            self._explicit[name] = value

    def reset(self, name: Optional[str] = None) -> None:
        """Drop explicit overrides (all, or one flag) back to env/defaults."""
        with self._lock:
            if name is None:
                self._explicit.clear()
            else:
                self._explicit.pop(name, None)

    def all(self) -> Dict[str, Any]:
        return {k: self.get(k) for k in _FLAG_DEFAULTS}


flags = FeatureFlags()
