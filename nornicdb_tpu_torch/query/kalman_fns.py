"""Kalman filter Cypher functions with JSON-string state (counterpart of
``nornicdb_tpu/query/kalman_fns.py``).

Reference: pkg/cypher/kalman_functions.go (952 LoC). The database stays
stateless: ``kalman.init()`` returns a JSON state string the user stores
in a node property; each ``process()`` call takes it and returns
``{value, state}`` with the updated state. Three filter families:

- ``kalman.*``          — scalar filter with velocity-projected predict
- ``kalman.velocity.*`` — 2-state (position, velocity) filter
- ``kalman.adaptive.*`` — auto-switches basic/velocity on trend strength

The JSON field names match the reference wire format (x/lx/p/k/e/q/r/vs/n
for basic; pos/vel/p/qp/qv/r/dt/n for velocity) so states written by one
implementation are readable by the other.
"""

from __future__ import annotations

import json
import math
from typing import Any, Dict, Optional


def _default_basic() -> Dict[str, Any]:
    return {"x": 0.0, "lx": 0.0, "p": 30.0, "k": 0.0, "e": 1.0,
            "q": 0.0001, "r": 88.0, "vs": 10.0, "n": 0}


def _default_velocity() -> Dict[str, Any]:
    return {"pos": 0.0, "vel": 0.0, "p": [100.0, 0.0, 0.0, 10.0],
            "qp": 0.1, "qv": 0.01, "r": 1.0, "dt": 1.0, "n": 0}


def _default_adaptive() -> Dict[str, Any]:
    return {"basic": _default_basic(), "velocity": _default_velocity(),
            "mode": "basic", "ss": 0, "tt": 0.1, "st": 0.02, "hy": 10,
            "n": 0, "lf": 0.0, "ts": 0.0}


def _load(state_json: Any) -> Optional[Dict[str, Any]]:
    if not isinstance(state_json, str):
        return None
    try:
        s = json.loads(state_json)
    except (ValueError, TypeError):
        return None
    return s if isinstance(s, dict) else None


def _f(v: Any, default: float = 0.0) -> float:
    try:
        return float(v)
    except (TypeError, ValueError):
        return default


def kalman_init(config: Any = None) -> str:
    s = _default_basic()
    if isinstance(config, dict):
        if "processNoise" in config:
            s["q"] = _f(config["processNoise"]) * 0.001
        if "measurementNoise" in config:
            s["r"] = _f(config["measurementNoise"])
        if "initialCovariance" in config:
            s["p"] = _f(config["initialCovariance"])
        if "varianceScale" in config:
            s["vs"] = _f(config["varianceScale"])
    return json.dumps(s)


def kalman_process(measurement: Any, state_json: Any,
                   target: Any = 0.0) -> Dict[str, Any]:
    s = _load(state_json)
    m = _f(measurement)
    if s is None:
        return {"value": m, "state": state_json, "error": "invalid state"}
    tgt = _f(target)
    # project ahead using implied velocity, then standard scalar update
    velocity = _f(s.get("x")) - _f(s.get("lx"))
    x = _f(s.get("x")) + velocity
    s["lx"] = x
    if tgt != 0.0 and s["lx"] != 0.0:
        s["e"] = abs(1.0 - (tgt / s["lx"]))
    else:
        s["e"] = 1.0
    p = _f(s.get("p")) + _f(s.get("q")) * s["e"]
    k = p / (p + _f(s.get("r"), 1.0))
    x = x + k * (m - x)
    s["x"] = x
    s["k"] = k
    s["p"] = (1.0 - k) * p
    s["n"] = int(s.get("n", 0)) + 1
    return {"value": x, "state": json.dumps(s)}


def kalman_predict(state_json: Any, steps: Any) -> float:
    s = _load(state_json)
    if s is None:
        return 0.0
    velocity = _f(s.get("x")) - _f(s.get("lx"))
    return _f(s.get("x")) + _f(steps) * velocity


def kalman_state(state_json: Any) -> float:
    s = _load(state_json)
    return 0.0 if s is None else _f(s.get("x"))


def kalman_rate(state_json: Any) -> float:
    s = _load(state_json)
    return 0.0 if s is None else _f(s.get("x")) - _f(s.get("lx"))


def kalman_reset(state_json: Any) -> str:
    s = _load(state_json)
    fresh = _default_basic()
    if s is not None:  # keep configured noise parameters
        for key in ("q", "r", "vs"):
            if key in s:
                fresh[key] = _f(s[key], fresh[key])
    return json.dumps(fresh)


def kalman_velocity_init(initial_pos: Any = None,
                         initial_vel: Any = None) -> str:
    s = _default_velocity()
    if initial_pos is not None:
        s["pos"] = _f(initial_pos)
    if initial_vel is not None:
        s["vel"] = _f(initial_vel)
    return json.dumps(s)


def kalman_velocity_process(measurement: Any,
                            state_json: Any) -> Dict[str, Any]:
    s = _load(state_json)
    m = _f(measurement)
    if s is None:
        return {"value": m, "velocity": 0.0, "state": state_json,
                "error": "invalid state"}
    dt = _f(s.get("dt"), 1.0)
    if dt <= 0:
        dt = 1.0
    pos, vel = _f(s.get("pos")), _f(s.get("vel"))
    pm = s.get("p") or [100.0, 0.0, 0.0, 10.0]
    p00, p01, p10, p11 = (_f(pm[i]) for i in range(4))
    qp, qv, r = _f(s.get("qp"), 0.1), _f(s.get("qv"), 0.01), _f(s.get("r"), 1.0)
    # predict: constant-velocity transition F = [[1, dt], [0, 1]]
    pred_pos = pos + vel * dt
    pred_p00 = p00 + dt * p10 + dt * p01 + dt * dt * p11 + qp
    pred_p01 = p01 + dt * p11
    pred_p10 = p10 + dt * p11
    pred_p11 = p11 + qv
    # update against the position measurement (H = [1, 0])
    innov = m - pred_pos
    sj = pred_p00 + r
    k0 = pred_p00 / sj
    k1 = pred_p10 / sj
    s["pos"] = pred_pos + k0 * innov
    s["vel"] = vel + k1 * innov
    s["p"] = [(1 - k0) * pred_p00, (1 - k0) * pred_p01,
              pred_p10 - k1 * pred_p00, pred_p11 - k1 * pred_p01]
    s["n"] = int(s.get("n", 0)) + 1
    return {"value": s["pos"], "velocity": s["vel"], "state": json.dumps(s)}


def kalman_velocity_predict(state_json: Any, steps: Any) -> float:
    s = _load(state_json)
    if s is None:
        return 0.0
    dt = _f(s.get("dt"), 1.0)
    if dt <= 0:
        dt = 1.0
    return _f(s.get("pos")) + _f(s.get("vel")) * _f(steps) * dt


def kalman_adaptive_init(config: Any = None) -> str:
    s = _default_adaptive()
    if isinstance(config, dict):
        if "trendThreshold" in config:
            s["tt"] = _f(config["trendThreshold"])
        if "stabilityThreshold" in config:
            s["st"] = _f(config["stabilityThreshold"])
        if "hysteresis" in config:
            s["hy"] = int(_f(config["hysteresis"]))
        if config.get("initialMode") == "velocity":
            s["mode"] = "velocity"
    return json.dumps(s)


def kalman_adaptive_process(measurement: Any,
                            state_json: Any) -> Dict[str, Any]:
    s = _load(state_json)
    m = _f(measurement)
    if s is None:
        return {"value": m, "mode": "error", "state": state_json,
                "error": "invalid state"}
    mode = s.get("mode", "basic")
    if mode == "velocity":
        res = kalman_velocity_process(m, json.dumps(s.get("velocity") or
                                                    _default_velocity()))
        filtered = _f(res["value"])
        s["velocity"] = json.loads(res["state"])
        s["ts"] = _f(s["velocity"].get("vel"))
    else:
        res = kalman_process(m, json.dumps(s.get("basic") or
                                           _default_basic()))
        filtered = _f(res["value"])
        s["basic"] = json.loads(res["state"])
        s["ts"] = _f(s["basic"].get("x")) - _f(s["basic"].get("lx"))
    s["n"] = int(s.get("n", 0)) + 1
    s["ss"] = int(s.get("ss", 0)) + 1
    if s["ss"] >= int(s.get("hy", 10)):
        trend = abs(_f(s.get("ts")))
        if mode == "basic" and trend > _f(s.get("tt"), 0.1):
            s["mode"] = "velocity"
            s["ss"] = 0
            s["velocity"] = s.get("velocity") or _default_velocity()
            s["velocity"]["pos"] = _f(s["basic"].get("x"))
            s["velocity"]["vel"] = _f(s.get("ts"))
        elif mode == "velocity" and trend < _f(s.get("st"), 0.02):
            s["mode"] = "basic"
            s["ss"] = 0
            s["basic"] = s.get("basic") or _default_basic()
            s["basic"]["x"] = _f(s["velocity"].get("pos"))
            s["basic"]["lx"] = (_f(s["velocity"].get("pos"))
                                - _f(s["velocity"].get("vel")))
    s["lf"] = filtered
    return {"value": filtered, "mode": s.get("mode", "basic"),
            "state": json.dumps(s)}


def register_all(register) -> None:
    register("kalman.init", kalman_init)
    register("kalman.process", kalman_process)
    register("kalman.predict", kalman_predict)
    register("kalman.state", kalman_state)
    register("kalman.rate", kalman_rate)
    register("kalman.reset", kalman_reset)
    register("kalman.velocity.init", kalman_velocity_init)
    register("kalman.velocity.process", kalman_velocity_process)
    register("kalman.velocity.predict", kalman_velocity_predict)
    register("kalman.adaptive.init", kalman_adaptive_init)
    register("kalman.adaptive.process", kalman_adaptive_process)
