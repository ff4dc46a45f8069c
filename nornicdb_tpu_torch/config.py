"""Environment switches (a copy of ``env_bool``, ``env_int``,
``env_float`` and ``env_str`` from ``nornicdb_tpu/config.py``): every
name is read with the ``NORNICDB_`` prefix, and a missing or malformed
value gives the default."""

from __future__ import annotations

import os

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
