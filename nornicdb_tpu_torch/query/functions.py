"""Cypher builtin scalar functions (counterpart of
``nornicdb_tpu/query/functions.py``).

Reference: pkg/cypher/functions_eval_functions.go (2,211 LoC) + registry
pkg/cypher/fn/registry.go, builtins_core.go (~200 builtins). This module
covers the high-traffic core; APOC-namespaced functions register through
their own tables (``query/apoc.py``), which the executor consults next.
"""

from __future__ import annotations

import math
import random
import time
import uuid as _uuid
from datetime import datetime, timezone
from typing import Any, Callable, Dict, List, Optional

from nornicdb_tpu_torch.errors import CypherRuntimeError
from nornicdb_tpu_torch.storage.types import Edge, Node


class PathValue:
    """A matched path: alternating nodes and relationships."""

    def __init__(self, nodes: List[Node], rels: List[Edge]):
        self.nodes = nodes
        self.rels = rels

    def __eq__(self, other):
        return (
            isinstance(other, PathValue)
            and [n.id for n in self.nodes] == [n.id for n in other.nodes]
            and [r.id for r in self.rels] == [r.id for r in other.rels]
        )

    def __len__(self):
        return len(self.rels)


FunctionImpl = Callable[..., Any]
REGISTRY: Dict[str, FunctionImpl] = {}


def register(name: str, fn: FunctionImpl) -> None:
    REGISTRY[name.lower()] = fn


def lookup(name: str) -> Optional[FunctionImpl]:
    return REGISTRY.get(name.lower())


def _num(x: Any) -> float:
    if isinstance(x, bool) or not isinstance(x, (int, float)):
        raise CypherRuntimeError(f"expected number, got {type(x).__name__}")
    return x


# -- entity functions ----------------------------------------------------


def _id(x):
    if isinstance(x, (Node, Edge)):
        return x.id
    return None


def _labels(n):
    if isinstance(n, Node):
        return list(n.labels)
    if n is None:
        return None
    raise CypherRuntimeError("labels() expects a node")


def _type(r):
    if isinstance(r, Edge):
        return r.type
    if r is None:
        return None
    raise CypherRuntimeError("type() expects a relationship")


def _properties(x):
    if isinstance(x, (Node, Edge)):
        return dict(x.properties)
    if isinstance(x, dict):
        return dict(x)
    if x is None:
        return None
    raise CypherRuntimeError("properties() expects a node/relationship/map")


def _start_node(r):
    return r.start_node if isinstance(r, Edge) else None


def _end_node(r):
    return r.end_node if isinstance(r, Edge) else None


def _keys(x):
    if isinstance(x, (Node, Edge)):
        return sorted(x.properties.keys())
    if isinstance(x, dict):
        return sorted(x.keys())
    if x is None:
        return None
    raise CypherRuntimeError("keys() expects a node/relationship/map")


# -- list / size ---------------------------------------------------------


def _size(x):
    if x is None:
        return None
    if isinstance(x, (list, str, dict)):
        return len(x)
    raise CypherRuntimeError("size() expects a list/string/map")


def _length(x):
    if x is None:
        return None
    if isinstance(x, PathValue):
        return len(x)
    if isinstance(x, (list, str)):
        return len(x)
    raise CypherRuntimeError("length() expects a path")


def _range(start, end, step=1):
    start, end, step = int(start), int(end), int(step)
    if step == 0:
        raise CypherRuntimeError("range() step must not be zero")
    out = []
    i = start
    if step > 0:
        while i <= end:
            out.append(i)
            i += step
    else:
        while i >= end:
            out.append(i)
            i += step
    return out


def _coalesce(*args):
    for a in args:
        if a is not None:
            return a
    return None


def _head(lst):
    if lst is None:
        return None
    return lst[0] if lst else None


def _last(lst):
    if lst is None:
        return None
    return lst[-1] if lst else None


def _tail(lst):
    if lst is None:
        return None
    return list(lst[1:])


def _reverse(x):
    if x is None:
        return None
    if isinstance(x, str):
        return x[::-1]
    return list(reversed(x))


def _nodes(p):
    if isinstance(p, PathValue):
        return list(p.nodes)
    return None


def _relationships(p):
    if isinstance(p, PathValue):
        return list(p.rels)
    return None


# -- string --------------------------------------------------------------


def _to_string(x):
    if x is None:
        return None
    if isinstance(x, bool):
        return "true" if x else "false"
    if isinstance(x, float) and x.is_integer():
        return f"{x:.1f}"
    return str(x)


def _substring(s, start, length=None):
    if s is None:
        return None
    start = int(start)
    if length is None:
        return s[start:]
    return s[start : start + int(length)]


def _split(s, delim):
    if s is None:
        return None
    return s.split(delim)


def _replace(s, search, repl):
    if s is None:
        return None
    return s.replace(search, repl)


def _left(s, n):
    return None if s is None else s[: int(n)]


def _right(s, n):
    return None if s is None else (s[-int(n):] if int(n) > 0 else "")


# -- numeric -------------------------------------------------------------


def _to_integer(x):
    if x is None:
        return None
    try:
        if isinstance(x, str):
            return int(float(x)) if x.strip() else None
        if isinstance(x, bool):
            return 1 if x else 0
        return int(x)
    except (ValueError, TypeError):
        return None


def _to_float(x):
    if x is None:
        return None
    try:
        if isinstance(x, bool):
            return 1.0 if x else 0.0
        return float(x)
    except (ValueError, TypeError):
        return None


def _to_boolean(x):
    if x is None or isinstance(x, bool):
        return x
    if isinstance(x, str) and x.lower() in ("true", "false"):
        return x.lower() == "true"
    return None


def _round(x, precision=0):
    if x is None:
        return None
    p = int(precision)
    # Cypher rounds half away from zero
    scaled = _num(x) * (10 ** p)
    r = math.floor(abs(scaled) + 0.5) * (1 if scaled >= 0 else -1)
    out = r / (10 ** p)
    return out if p > 0 else float(out)


def _install_core():
    register("id", _id)
    register("elementId", _id)
    register("labels", _labels)
    register("type", _type)
    register("properties", _properties)
    register("startNode", _start_node)
    register("endNode", _end_node)
    register("keys", _keys)
    register("size", _size)
    register("length", _length)
    register("range", _range)
    register("coalesce", _coalesce)
    register("head", _head)
    register("last", _last)
    register("tail", _tail)
    register("reverse", _reverse)
    register("nodes", _nodes)
    register("relationships", _relationships)

    register("toString", _to_string)
    register("toUpper", lambda s: None if s is None else s.upper())
    register("toLower", lambda s: None if s is None else s.lower())
    register("trim", lambda s: None if s is None else s.strip())
    register("ltrim", lambda s: None if s is None else s.lstrip())
    register("rtrim", lambda s: None if s is None else s.rstrip())
    register("substring", _substring)
    register("split", _split)
    register("replace", _replace)
    register("left", _left)
    register("right", _right)

    register("abs", lambda x: None if x is None else abs(_num(x)))
    register("ceil", lambda x: None if x is None else float(math.ceil(_num(x))))
    register("floor", lambda x: None if x is None else float(math.floor(_num(x))))
    register("round", _round)
    register("sqrt", lambda x: None if x is None else math.sqrt(_num(x)))
    register("sign", lambda x: None if x is None else (0 if x == 0 else (1 if x > 0 else -1)))
    register("exp", lambda x: None if x is None else math.exp(_num(x)))
    register("log", lambda x: None if x is None else math.log(_num(x)))
    register("log10", lambda x: None if x is None else math.log10(_num(x)))
    register("sin", lambda x: None if x is None else math.sin(_num(x)))
    register("cos", lambda x: None if x is None else math.cos(_num(x)))
    register("tan", lambda x: None if x is None else math.tan(_num(x)))
    register("atan", lambda x: None if x is None else math.atan(_num(x)))
    register("atan2", lambda y, x: math.atan2(_num(y), _num(x)))
    register("acos", lambda x: None if x is None else math.acos(_num(x)))
    register("asin", lambda x: None if x is None else math.asin(_num(x)))
    register("pi", lambda: math.pi)
    register("e", lambda: math.e)
    register("rand", lambda: random.random())
    register("toInteger", _to_integer)
    register("toFloat", _to_float)
    register("toBoolean", _to_boolean)

    register("timestamp", lambda: int(time.time() * 1000))
    register("randomUUID", lambda: str(_uuid.uuid4()))


def _install_temporal_spatial():
    """Temporal, duration, and spatial builtins (reference:
    pkg/cypher/duration.go + temporal functions in
    functions_eval_functions.go; spatial point/distance)."""
    from nornicdb_tpu_torch.query import temporal_types as T

    def _nullable_ctor(maker):
        # fn() -> now; fn(null) -> null (Cypher distinguishes the two)
        def fn(*args):
            if args and args[0] is None:
                return None
            return maker(args[0]) if args else maker()
        return fn

    register("date", _nullable_ctor(T.make_date))
    register("datetime", _nullable_ctor(T.make_datetime))
    register("localdatetime", _nullable_ctor(T.make_localdatetime))
    register("time", _nullable_ctor(T.make_time))
    register("localtime", _nullable_ctor(T.make_localtime))
    def _duration(*args):
        if not args:
            raise CypherRuntimeError(
                "duration() requires a string or map argument"
            )
        return None if args[0] is None else T.parse_duration(args[0])

    register("duration", _duration)

    register("date.truncate",
             lambda unit, v=None: T.truncate(unit, v if v is not None
                                             else T.make_date(), "date"))
    register("datetime.truncate",
             lambda unit, v=None: T.truncate(unit, v if v is not None
                                             else T.make_datetime(),
                                             "datetime"))
    register("localdatetime.truncate",
             lambda unit, v=None: T.truncate(unit, v if v is not None
                                             else T.make_localdatetime(),
                                             "localdatetime"))
    # transaction/statement/realtime clocks (same instant in this engine)
    for fn_name, maker in [("date", T.make_date),
                           ("datetime", T.make_datetime),
                           ("localdatetime", T.make_localdatetime),
                           ("time", T.make_time),
                           ("localtime", T.make_localtime)]:
        for clock in ("transaction", "statement", "realtime"):
            register(f"{fn_name}.{clock}", (lambda mk: lambda: mk())(maker))
    register("datetime.fromepoch",
             lambda secs, nanos=0: T.make_datetime(
                 float(secs) * 1000.0 + float(nanos) / 1e6))
    register("datetime.fromepochmillis",
             lambda ms: T.make_datetime(float(ms)))

    register("duration.between", T.duration_between)
    register("duration.inmonths", T.duration_in_months)
    register("duration.indays", T.duration_in_days)
    register("duration.inseconds", T.duration_in_seconds)

    register("point", T.make_point)
    register("distance", T.point_distance)
    register("point.distance", T.point_distance)
    register("point.withinbbox", _point_within_bbox)


def _point_within_bbox(p, lower, upper):
    from nornicdb_tpu_torch.query.temporal_types import CypherPoint

    if p is None or lower is None or upper is None:
        return None
    for v in (p, lower, upper):
        if not isinstance(v, CypherPoint):
            raise CypherRuntimeError("point.withinBBox() expects points")
    return (lower.x <= p.x <= upper.x) and (lower.y <= p.y <= upper.y)


def _install_extended():
    """Breadth beyond the core (reference builtins_core.go ~200 entries):
    *OrNull conversions, list conversions/operations, extra string and
    math functions, isEmpty/valueType, char_length."""
    # conversions with explicit null-on-failure contract
    register("tointegerornull", _to_integer)
    register("tofloatornull", _to_float)
    register("tobooleanornull", _to_boolean)
    register("tostringornull", lambda x: (
        _to_string(x) if isinstance(x, (bool, int, float, str)) else None))

    def _list_conv(conv):
        def fn(lst):
            if lst is None:
                return None
            if not isinstance(lst, list):
                raise CypherRuntimeError("expected a list")
            return [conv(x) for x in lst]
        return fn

    register("tointegerlist", _list_conv(_to_integer))
    register("tofloatlist", _list_conv(_to_float))
    register("tostringlist", _list_conv(
        lambda x: _to_string(x) if isinstance(x, (bool, int, float, str))
        else None))
    register("tobooleanlist", _list_conv(_to_boolean))

    register("isempty", lambda x: None if x is None else (
        len(x) == 0 if isinstance(x, (list, str, dict)) else
        _raise(CypherRuntimeError("isEmpty() expects list/string/map"))))
    register("char_length", lambda s: None if s is None else len(s))
    register("character_length", lambda s: None if s is None else len(s))
    register("normalize", lambda s, form="NFC": (
        None if s is None else __import__("unicodedata").normalize(form, s)))
    register("btrim", lambda s, chars=None: (
        None if s is None else s.strip(chars)))

    register("degrees", lambda x: None if x is None else math.degrees(_num(x)))
    register("radians", lambda x: None if x is None else math.radians(_num(x)))
    register("cot", lambda x: None if x is None else (
        float("inf") if math.tan(_num(x)) == 0 else 1.0 / math.tan(_num(x))))
    register("haversin", lambda x: None if x is None else
             math.sin(_num(x) / 2) ** 2)
    register("isnan", lambda x: None if x is None else (
        isinstance(x, float) and math.isnan(x)))

    def _value_type(x):
        if x is None:
            return "NULL"
        if isinstance(x, bool):
            return "BOOLEAN"
        if isinstance(x, int):
            return "INTEGER"
        if isinstance(x, float):
            return "FLOAT"
        if isinstance(x, str):
            return "STRING"
        if isinstance(x, list):
            return "LIST<ANY>"
        if isinstance(x, dict):
            return "MAP"
        if isinstance(x, Node):
            return "NODE"
        if isinstance(x, Edge):
            return "RELATIONSHIP"
        if isinstance(x, PathValue):
            return "PATH"
        from nornicdb_tpu_torch.query import temporal_types as T

        if isinstance(x, T.CypherDate):
            return "DATE"
        if isinstance(x, T.CypherDateTime):
            return "ZONED DATETIME"
        if isinstance(x, T.CypherLocalDateTime):
            return "LOCAL DATETIME"
        if isinstance(x, T.CypherTime):
            return "ZONED TIME"
        if isinstance(x, T.CypherLocalTime):
            return "LOCAL TIME"
        if isinstance(x, T.CypherDuration):
            return "DURATION"
        if isinstance(x, T.CypherPoint):
            return "POINT"
        return type(x).__name__.upper()

    register("valuetype", _value_type)


def _raise(exc):
    raise exc


def _install_reference_tail() -> None:
    """Long-tail builtins for reference parity (functions_eval_math.go,
    functions_eval_functions.go, kalman_functions.go): hyperbolic math,
    string padding, legacy aliases, component-accessor function forms,
    spatial geometry, vector similarity, Kalman filters."""
    from nornicdb_tpu_torch.query import temporal_types as T

    # hyperbolic / aliases
    register("sinh", lambda x: None if x is None else math.sinh(_num(x)))
    register("cosh", lambda x: None if x is None else math.cosh(_num(x)))
    register("tanh", lambda x: None if x is None else math.tanh(_num(x)))
    register("coth", lambda x: None if x is None else (
        float("inf") if math.tanh(_num(x)) == 0
        else 1.0 / math.tanh(_num(x))))
    def _power(x, y):
        if x is None or y is None:
            return None
        xv, yv = _num(x), _num(y)
        if (isinstance(xv, int) and isinstance(yv, int) and yv >= 0):
            return xv ** yv
        try:
            return math.pow(xv, yv)  # NaN/domain cases below
        except (ValueError, ZeroDivisionError):
            if xv == 0 and yv < 0:
                return float("inf")  # 0 ^ negative (IEEE pow)
            return float("nan")  # e.g. (-2) ^ 0.5

    register("power", _power)
    register("toint", REGISTRY["tointeger"])
    register("lower", REGISTRY["tolower"])
    register("upper", REGISTRY["toupper"])

    # string padding / search
    def _lpad(s, width, pad=" "):
        if s is None or width is None:
            return None
        s = str(s)
        pad = " " if pad is None else (str(pad) or " ")
        w = int(width)
        if len(s) >= w:
            return s
        fill = (pad * w)[: w - len(s)]
        return fill + s

    def _rpad(s, width, pad=" "):
        if s is None or width is None:
            return None
        s = str(s)
        pad = " " if pad is None else (str(pad) or " ")
        w = int(width)
        if len(s) >= w:
            return s
        return s + (pad * w)[: w - len(s)]

    register("lpad", _lpad)
    register("rpad", _rpad)

    def _index_of(coll, item):
        if coll is None:
            return None
        if isinstance(coll, str):
            return coll.find("" if item is None else str(item))
        if isinstance(coll, list):
            for i, x in enumerate(coll):
                if x == item and isinstance(x, bool) == isinstance(item, bool):
                    return i
            return -1
        raise CypherRuntimeError("indexOf() expects list or string")

    register("indexof", _index_of)
    register("nullif", lambda a, b: (
        None if a == b and isinstance(a, bool) == isinstance(b, bool)
        else a))

    def _format(template, *args):
        if template is None:
            return None
        t = str(template).replace("%v", "%s")
        try:
            return t % tuple(args)
        except (TypeError, ValueError):
            try:
                return t % tuple(str(a) for a in args)
            except (TypeError, ValueError):
                return t

    register("format", _format)

    def _slice(lst, start, end=None):
        if lst is None or start is None:
            return None
        if not isinstance(lst, list):
            raise CypherRuntimeError("slice() expects a list")
        n = len(lst)
        s = int(start)
        e = n if end is None else int(end)
        if s < 0:
            s += n
        if e < 0:
            e += n
        s = max(s, 0)
        e = min(e, n)
        return lst[s:e] if s < e else []

    register("slice", _slice)

    def _has_labels(node, labels):
        if not isinstance(node, Node):
            return False
        want = labels if isinstance(labels, list) else [labels]
        return all(lb in node.labels for lb in want)

    register("haslabels", _has_labels)

    # component-accessor function forms: date.year(d), datetime.hour(x)…
    def _component(name):
        def get(v):
            if v is None:
                return None
            comp = getattr(v, "component", None)
            if comp is None:
                v2 = T.make_datetime(v)
                return v2.component(name)
            return comp(name)
        return get

    for comp in ("year", "quarter", "month", "week", "weekyear", "day",
                 "dayofweek", "dayofyear", "ordinalday"):
        register(f"date.{comp}", _component(comp))
    for comp in ("year", "month", "day", "hour", "minute", "second"):
        register(f"datetime.{comp}", _component(comp))
    register("time.truncate",
             lambda unit, v=None: T.truncate(unit, v if v is not None
                                             else T.make_time(), "time"))
    register("localtime.truncate",
             lambda unit, v=None: T.truncate(unit, v if v is not None
                                             else T.make_localtime(),
                                             "localtime"))

    # point component accessors
    def _point_comp(name):
        def get(p):
            if p is None:
                return None
            if not isinstance(p, T.CypherPoint):
                raise CypherRuntimeError(f"point.{name}() expects a point")
            return p.component(name)
        return get

    for comp in ("x", "y", "z", "crs", "srid", "latitude", "longitude",
                 "height"):
        register(f"point.{comp}", _point_comp(comp))

    def _within_distance(p, center, dist):
        if p is None or center is None or dist is None:
            return None
        d = T.point_distance(p, center)
        if d is None:  # cross-CRS distance is null
            return None
        return d <= _num(dist)

    register("point.withindistance", _within_distance)
    register("withinbbox", REGISTRY["point.withinbbox"])

    # geometry constructors + predicates (reference returns plain maps,
    # functions_eval_math.go:1090-1230)
    def _geom_points(pts, kind):
        if not isinstance(pts, list) or len(pts) < (2 if kind ==
                                                    "linestring" else 3):
            raise CypherRuntimeError(
                f"{kind}() expects a list of at least "
                f"{2 if kind == 'linestring' else 3} points")
        out = []
        for p in pts:
            q = T.make_point(p) if not isinstance(p, T.CypherPoint) else p
            if q is None:
                raise CypherRuntimeError(f"{kind}(): bad point {p!r}")
            out.append(q)
        return out

    register("linestring", lambda pts: {
        "type": "linestring", "points": _geom_points(pts, "linestring")})
    register("polygon", lambda pts: {
        "type": "polygon", "points": _geom_points(pts, "polygon")})

    def _poly_pts(geom):
        if isinstance(geom, dict) and isinstance(geom.get("points"), list):
            return [p for p in geom["points"] if isinstance(p, T.CypherPoint)]
        return None

    def _point_in_polygon(poly, p):
        """Ray casting on the x/y plane."""
        pts = _poly_pts(poly)
        q = p if isinstance(p, T.CypherPoint) else (
            T.make_point(p) if isinstance(p, dict) else None)
        if not pts or q is None:
            return False
        inside = False
        j = len(pts) - 1
        for i in range(len(pts)):
            xi, yi = pts[i].x, pts[i].y
            xj, yj = pts[j].x, pts[j].y
            if (yi > q.y) != (yj > q.y) and (
                q.x < (xj - xi) * (q.y - yi) / (yj - yi) + xi
            ):
                inside = not inside
            j = i
        return inside

    register("point.contains", _point_in_polygon)
    register("point.intersects",
             lambda p, poly: _point_in_polygon(poly, p))

    # vector similarity (reference pkg/math/vector/similarity.go)
    def _fvec(v):
        if not isinstance(v, list) or not v:
            return None
        try:
            return [float(x) for x in v]
        except (TypeError, ValueError):
            return None

    def _cos_sim(a, b):
        va, vb = _fvec(a), _fvec(b)
        if va is None or vb is None or len(va) != len(vb):
            return None
        dot = sum(x * y for x, y in zip(va, vb))
        na = math.sqrt(sum(x * x for x in va))
        nb = math.sqrt(sum(y * y for y in vb))
        if na == 0 or nb == 0:
            return 0.0
        return dot / (na * nb)

    def _euc_sim(a, b):
        va, vb = _fvec(a), _fvec(b)
        if va is None or vb is None or len(va) != len(vb):
            return None
        return 1.0 / (1.0 + math.sqrt(
            sum((x - y) ** 2 for x, y in zip(va, vb))))

    register("vector.similarity.cosine", _cos_sim)
    register("vector.similarity.euclidean", _euc_sim)

    from nornicdb_tpu_torch.query import kalman_fns

    kalman_fns.register_all(register)


_install_core()
_install_temporal_spatial()
_install_extended()
_install_reference_tail()
