"""APOC value-level long tail: bitwise, number, math, stats, scoring,
temporal, text, util, json, diff, coll, convert, date, xml, agg
(counterpart of ``nornicdb_tpu/query/apoc_bulk.py``).

Reference: apoc/apoc.go:222 registerAllFunctions (983 names across ~40
categories). This module covers every category whose functions are pure
value transforms (no storage access); graph-touching categories live in
apoc_graph.py. Registered into the same table as nornicdb_tpu_torch.query.apoc
so the executor's single lookup path serves them.

Aggregates (apoc.agg.*) are special: the executor collects per-row
argument tuples and calls the finalizers in AGG_FINALIZERS.
"""

from __future__ import annotations

import base64
import binascii
import hashlib
import json as _json
import math
import re
import time as _time
import urllib.parse
import uuid as _uuid
import zlib
from typing import Any, Callable, Dict, List, Optional

from nornicdb_tpu_torch.errors import CypherRuntimeError
from nornicdb_tpu_torch.query.apoc import register
from nornicdb_tpu_torch.storage.types import Edge, Node

_U64 = (1 << 64) - 1
_I64_MIN = -(1 << 63)


def _i64(x: Any) -> int:
    """Coerce to a signed 64-bit integer (two's complement wrap)."""
    v = int(x) & _U64
    return v - (1 << 64) if v >= (1 << 63) else v


def _nums(lst) -> List[float]:
    if lst is None:
        return []
    return [float(x) for x in lst
            if isinstance(x, (int, float)) and not isinstance(x, bool)]


def _install_bitwise() -> None:
    register("apoc.bitwise.and", lambda a, b: _i64(_i64(a) & _i64(b)))
    register("apoc.bitwise.or", lambda a, b: _i64(_i64(a) | _i64(b)))
    register("apoc.bitwise.xor", lambda a, b: _i64(_i64(a) ^ _i64(b)))
    register("apoc.bitwise.not", lambda a: _i64(~_i64(a)))
    register("apoc.bitwise.leftShift", lambda a, n: _i64(_i64(a) << int(n)))
    register("apoc.bitwise.rightShift",
             lambda a, n: _i64(_i64(a) >> int(n)))  # arithmetic shift
    register("apoc.bitwise.rotateLeft", lambda a, n: _i64(
        ((_i64(a) & _U64) << (int(n) % 64) |
         (_i64(a) & _U64) >> (64 - int(n) % 64)) & _U64))
    register("apoc.bitwise.rotateRight", lambda a, n: _i64(
        ((_i64(a) & _U64) >> (int(n) % 64) |
         (_i64(a) & _U64) << (64 - int(n) % 64)) & _U64))
    register("apoc.bitwise.setBit", lambda a, i: _i64(_i64(a) | (1 << int(i))))
    register("apoc.bitwise.clearBit",
             lambda a, i: _i64(_i64(a) & ~(1 << int(i))))
    register("apoc.bitwise.toggleBit",
             lambda a, i: _i64(_i64(a) ^ (1 << int(i))))
    register("apoc.bitwise.testBit",
             lambda a, i: bool((_i64(a) >> int(i)) & 1))
    register("apoc.bitwise.countBits",
             lambda a: bin(_i64(a) & _U64).count("1"))
    register("apoc.bitwise.reverseBits", lambda a: _i64(
        int(format(_i64(a) & _U64, "064b")[::-1], 2)))

    def _bit_op(a, op, b=None):
        ops = {"&": lambda: _i64(a) & _i64(b), "and": lambda: _i64(a) & _i64(b),
               "|": lambda: _i64(a) | _i64(b), "or": lambda: _i64(a) | _i64(b),
               "^": lambda: _i64(a) ^ _i64(b), "xor": lambda: _i64(a) ^ _i64(b),
               "~": lambda: ~_i64(a), "not": lambda: ~_i64(a),
               "<<": lambda: _i64(a) << int(b),
               ">>": lambda: _i64(a) >> int(b)}
        fn = ops.get(str(op).lower())
        if fn is None:
            raise CypherRuntimeError(f"apoc.bitwise.op: unknown op {op!r}")
        return _i64(fn())

    register("apoc.bitwise.op", _bit_op)


_ROMAN = [(1000, "M"), (900, "CM"), (500, "D"), (400, "CD"), (100, "C"),
          (90, "XC"), (50, "L"), (40, "XL"), (10, "X"), (9, "IX"),
          (5, "V"), (4, "IV"), (1, "I")]


def _romanize(n) -> str:
    n = int(n)
    if not 0 < n < 4000:
        raise CypherRuntimeError("romanize expects 1..3999")
    out = []
    for v, sym in _ROMAN:
        while n >= v:
            out.append(sym)
            n -= v
    return "".join(out)


def _arabize(s) -> int:
    vals = {"I": 1, "V": 5, "X": 10, "L": 50, "C": 100, "D": 500, "M": 1000}
    s = str(s).upper()
    total = 0
    prev = 0
    for ch in reversed(s):
        if ch not in vals:
            raise CypherRuntimeError(f"arabize: bad numeral {ch!r}")
        v = vals[ch]
        total += v if v >= prev else -v
        prev = max(prev, v)
    return total


def _is_prime(n) -> bool:
    n = int(n)
    if n < 2:
        return False
    if n < 4:
        return True
    if n % 2 == 0:
        return False
    f = 3
    while f * f <= n:
        if n % f == 0:
            return False
        f += 2
    return True


def _next_prime(n) -> int:
    n = int(n) + 1
    while not _is_prime(n):
        n += 1
    return n


def _fibonacci(n) -> int:
    n = int(n)
    if n < 0:
        raise CypherRuntimeError("fibonacci expects n >= 0")
    a, b = 0, 1
    for _ in range(n):
        a, b = b, a + b
    return a


def _factorial(n) -> int:
    n = int(n)
    if n < 0:
        raise CypherRuntimeError("factorial expects n >= 0")
    if n > 170:
        raise CypherRuntimeError("factorial overflow (n > 170)")
    return math.factorial(n)


def _install_number() -> None:
    import random as _random

    n = "apoc.number."
    register(n + "abs", lambda x: None if x is None else abs(x))
    register(n + "ceil", lambda x: None if x is None else math.ceil(x))
    register(n + "floor", lambda x: None if x is None else math.floor(x))
    # reuse the core builtin's half-away-from-zero rounding (Cypher and
    # the reference round 2.5 -> 3, not banker's 2)
    from nornicdb_tpu_torch.query.functions import REGISTRY as _CORE

    register(n + "round", _CORE["round"])
    register(n + "sign", lambda x: None if x is None else (
        0 if x == 0 else (1 if x > 0 else -1)))
    register(n + "exp", lambda x: None if x is None else math.exp(x))
    register(n + "log", lambda x: None if x is None else math.log(x))
    register(n + "log10", lambda x: None if x is None else math.log10(x))
    register(n + "sqrt", lambda x: None if x is None else math.sqrt(x))
    register(n + "power", lambda x, y: None if x is None else x ** y)
    register(n + "gcd", lambda a, b: math.gcd(int(a), int(b)))
    register(n + "lcm", lambda a, b: (
        0 if int(a) == 0 or int(b) == 0
        else abs(int(a) * int(b)) // math.gcd(int(a), int(b))))
    register(n + "isEven", lambda x: int(x) % 2 == 0)
    register(n + "isOdd", lambda x: int(x) % 2 != 0)
    register(n + "isPrime", _is_prime)
    register(n + "nextPrime", _next_prime)
    register(n + "factorial", _factorial)
    register(n + "fibonacci", _fibonacci)
    register(n + "lerp", lambda a, b, t: float(a) + (float(b) - float(a)) * float(t))
    register(n + "clamp", lambda x, lo, hi: max(float(lo), min(float(hi), float(x))))
    register(n + "normalize", lambda x, lo, hi: (
        0.0 if float(hi) == float(lo)
        else (float(x) - float(lo)) / (float(hi) - float(lo))))
    register(n + "map", lambda x, a, b, c, d: (
        float(c) if float(b) == float(a)
        else float(c) + (float(x) - float(a)) * (float(d) - float(c))
        / (float(b) - float(a))))
    register(n + "random", lambda: _random.random())
    register(n + "randomInt", lambda a, b: _random.randrange(int(a), int(b)))
    register(n + "toBase", lambda x, base: _to_base(int(x), int(base)))
    register(n + "fromBase", lambda s, base: int(str(s), int(base)))
    register(n + "toBinary", lambda x: format(int(x), "b"))
    register(n + "fromBinary", lambda s: int(str(s), 2))
    register(n + "toHex", lambda x: format(int(x), "x"))
    register(n + "fromHex", lambda s: int(str(s).removeprefix("0x"), 16))
    register(n + "toOctal", lambda x: format(int(x), "o"))
    register(n + "fromOctal", lambda s: int(str(s), 8))
    register(n + "romanize", _romanize)
    register(n + "arabize", _arabize)

    def _parse(s, pattern=None):
        s = str(s).strip().replace(",", "")
        try:
            return int(s)
        except ValueError:
            try:
                return float(s)
            except ValueError:
                raise CypherRuntimeError(f"apoc.number.parse: {s!r}")

    register(n + "parse", _parse)

    def _exact(s):
        from decimal import Decimal, InvalidOperation
        try:
            return str(Decimal(str(s)).normalize())
        except InvalidOperation:
            raise CypherRuntimeError(f"apoc.number.exact: {s!r}")

    register(n + "exact", _exact)


def _to_base(x: int, base: int) -> str:
    if not 2 <= base <= 36:
        raise CypherRuntimeError("base must be 2..36")
    if x == 0:
        return "0"
    digits = "0123456789abcdefghijklmnopqrstuvwxyz"
    neg = x < 0
    x = abs(x)
    out = []
    while x:
        out.append(digits[x % base])
        x //= base
    return ("-" if neg else "") + "".join(reversed(out))


def _median(vals: List[float]) -> Optional[float]:
    if not vals:
        return None
    s = sorted(vals)
    m = len(s) // 2
    return float(s[m]) if len(s) % 2 else (s[m - 1] + s[m]) / 2.0


def _mode(vals: List[Any]) -> Any:
    if not vals:
        return None
    counts: Dict[Any, int] = {}
    for v in vals:
        counts[v] = counts.get(v, 0) + 1
    return max(counts.items(), key=lambda kv: kv[1])[0]


def _variance(vals: List[float], sample: bool = False) -> Optional[float]:
    if not vals or (sample and len(vals) < 2):
        return None
    mean = sum(vals) / len(vals)
    den = (len(vals) - 1) if sample else len(vals)
    return sum((x - mean) ** 2 for x in vals) / den


def _percentile(vals: List[float], p: float) -> Optional[float]:
    if not vals:
        return None
    s = sorted(vals)
    pos = float(p) * (len(s) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    frac = pos - lo
    return s[lo] * (1 - frac) + s[hi] * frac


def _install_math_stats() -> None:
    import random as _random

    m = "apoc.math."
    for name, fn in [
        ("abs", abs), ("acos", math.acos), ("asin", math.asin),
        ("atan", math.atan), ("ceil", math.ceil), ("cos", math.cos),
        ("cosh", math.cosh), ("exp", math.exp), ("floor", math.floor),
        ("log", math.log), ("log10", math.log10), ("sin", math.sin),
        ("sinh", math.sinh), ("sqrt", math.sqrt), ("tan", math.tan),
    ]:
        register(m + name, (lambda f: lambda x: None if x is None else f(x))(fn))
    register(m + "atan2", lambda y, x: math.atan2(y, x))
    register(m + "pow", lambda x, y: float(x) ** float(y))
    register(m + "clamp",
             lambda x, lo, hi: max(float(lo), min(float(hi), float(x))))
    register(m + "factorial", _factorial)
    register(m + "fibonacci", _fibonacci)
    register(m + "gcd", lambda a, b: math.gcd(int(a), int(b)))
    register(m + "lcm", lambda a, b: (
        0 if int(a) == 0 or int(b) == 0
        else abs(int(a) * int(b)) // math.gcd(int(a), int(b))))
    register(m + "isPrime", _is_prime)
    register(m + "nextPrime", _next_prime)
    register(m + "lerp",
             lambda a, b, t: float(a) + (float(b) - float(a)) * float(t))
    register(m + "logit", lambda p: math.log(float(p) / (1.0 - float(p))))
    register(m + "maxDouble", lambda: 1.7976931348623157e308)
    register(m + "minDouble", lambda: 4.9e-324)
    register(m + "mean", lambda l: (
        sum(_nums(l)) / len(_nums(l))) if _nums(l) else None)
    register(m + "median", lambda l: _median(_nums(l)))
    register(m + "mode", lambda l: _mode(list(l or [])))
    register(m + "normalize", lambda x, lo, hi: (
        0.0 if float(hi) == float(lo)
        else (float(x) - float(lo)) / (float(hi) - float(lo))))
    register(m + "percentile", lambda l, p: _percentile(_nums(l), p))
    register(m + "product", lambda l: math.prod(_nums(l)) if _nums(l) else None)
    register(m + "random", lambda: _random.random())
    register(m + "randomInt", lambda a, b: _random.randrange(int(a), int(b)))
    register(m + "range", lambda l: (
        (max(_nums(l)) - min(_nums(l))) if _nums(l) else None))
    register(m + "stdev", lambda l: (
        math.sqrt(v) if (v := _variance(_nums(l), sample=True)) is not None
        else None))
    register(m + "sum", lambda l: sum(_nums(l)) if l else 0.0)
    register(m + "variance", lambda l: _variance(_nums(l), sample=True))

    s = "apoc.stats."
    register(s + "count", lambda l: len(l or []))
    register(s + "max", lambda l: max(_nums(l)) if _nums(l) else None)
    register(s + "min", lambda l: min(_nums(l)) if _nums(l) else None)
    register(s + "mean", lambda l: (
        sum(_nums(l)) / len(_nums(l))) if _nums(l) else None)
    register(s + "median", lambda l: _median(_nums(l)))
    register(s + "mode", lambda l: _mode(list(l or [])))
    register(s + "sum", lambda l: sum(_nums(l)) if l else 0.0)
    register(s + "range", lambda l: (
        (max(_nums(l)) - min(_nums(l))) if _nums(l) else None))
    register(s + "stddev", lambda l: (
        math.sqrt(v) if (v := _variance(_nums(l), sample=True)) is not None
        else None))
    register(s + "variance", lambda l: _variance(_nums(l), sample=True))
    register(s + "percentile", lambda l, p: _percentile(_nums(l), p))
    register(s + "zscore", lambda l, x: (
        None if not _nums(l) or not _variance(_nums(l))
        else (float(x) - sum(_nums(l)) / len(_nums(l)))
        / math.sqrt(_variance(_nums(l)))))
    register(s + "normalize", lambda l: (
        [(x - min(v)) / (max(v) - min(v)) if max(v) != min(v) else 0.0
         for x in v] if (v := _nums(l)) else []))

    def _quartiles(l):
        v = _nums(l)
        if not v:
            return None
        return {"q1": _percentile(v, 0.25), "q2": _percentile(v, 0.5),
                "q3": _percentile(v, 0.75)}

    register(s + "quartiles", _quartiles)

    def _iqr(l):
        q = _quartiles(l)
        return None if q is None else q["q3"] - q["q1"]

    register(s + "iqr", _iqr)

    def _outliers(l):
        v = _nums(l)
        q = _quartiles(v)
        if q is None:
            return []
        spread = 1.5 * (q["q3"] - q["q1"])
        return [x for x in v
                if x < q["q1"] - spread or x > q["q3"] + spread]

    register(s + "outliers", _outliers)

    def _moment(v, k):
        mean = sum(v) / len(v)
        sd = math.sqrt(_variance(v))
        if sd == 0:
            return 0.0
        return sum(((x - mean) / sd) ** k for x in v) / len(v)

    register(s + "skewness", lambda l: (
        _moment(v, 3) if len(v := _nums(l)) >= 2 and _variance(v) else None))
    register(s + "kurtosis", lambda l: (
        _moment(v, 4) - 3.0
        if len(v := _nums(l)) >= 2 and _variance(v) else None))

    def _correlation(a, b):
        va, vb = _nums(a), _nums(b)
        if len(va) != len(vb) or len(va) < 2:
            return None
        ma = sum(va) / len(va)
        mb = sum(vb) / len(vb)
        cov = sum((x - ma) * (y - mb) for x, y in zip(va, vb))
        da = math.sqrt(sum((x - ma) ** 2 for x in va))
        db = math.sqrt(sum((y - mb) ** 2 for y in vb))
        if da == 0 or db == 0:
            return None
        return cov / (da * db)

    register(s + "correlation", _correlation)

    def _covariance(a, b):
        va, vb = _nums(a), _nums(b)
        if len(va) != len(vb) or len(va) < 2:
            return None
        ma = sum(va) / len(va)
        mb = sum(vb) / len(vb)
        return sum((x - ma) * (y - mb)
                   for x, y in zip(va, vb)) / (len(va) - 1)

    register(s + "covariance", _covariance)

    def _histogram(l, buckets=10):
        v = _nums(l)
        if not v:
            return []
        lo, hi = min(v), max(v)
        nb = max(int(buckets), 1)
        width = (hi - lo) / nb or 1.0
        counts = [0] * nb
        for x in v:
            i = min(int((x - lo) / width), nb - 1)
            counts[i] += 1
        return [{"min": lo + i * width, "max": lo + (i + 1) * width,
                 "count": c} for i, c in enumerate(counts)]

    register(s + "histogram", _histogram)

    def _summary(l):
        v = _nums(l)
        if not v:
            return {"count": 0}
        return {"count": len(v), "min": min(v), "max": max(v),
                "mean": sum(v) / len(v), "median": _median(v),
                "stddev": (math.sqrt(_variance(v, sample=True))
                           if len(v) > 1 else 0.0),
                "sum": sum(v)}

    register(s + "summary", _summary)

    def _degrees(l):
        """Degree distribution summary of an integer degree list."""
        v = _nums(l)
        if not v:
            return {"count": 0}
        return {"count": len(v), "min": min(v), "max": max(v),
                "mean": sum(v) / len(v), "median": _median(v)}

    register(s + "degrees", _degrees)


def _install_scoring() -> None:
    sc = "apoc.scoring."

    def _pairs(a, b):
        va, vb = _nums(a), _nums(b)
        if len(va) != len(vb) or not va:
            return None
        return va, vb

    def _cosine(a, b):
        p = _pairs(a, b)
        if p is None:
            return None
        va, vb = p
        na = math.sqrt(sum(x * x for x in va))
        nb = math.sqrt(sum(y * y for y in vb))
        if na == 0 or nb == 0:
            return 0.0
        return sum(x * y for x, y in zip(va, vb)) / (na * nb)

    register(sc + "cosine", _cosine)
    register(sc + "euclidean", lambda a, b: (
        None if _pairs(a, b) is None
        else math.sqrt(sum((x - y) ** 2 for x, y in zip(*_pairs(a, b))))))
    register(sc + "manhattan", lambda a, b: (
        None if _pairs(a, b) is None
        else sum(abs(x - y) for x, y in zip(*_pairs(a, b)))))

    def _pearson(a, b):
        p = _pairs(a, b)
        if p is None or len(p[0]) < 2:
            return None
        va, vb = p
        ma, mb = sum(va) / len(va), sum(vb) / len(vb)
        num = sum((x - ma) * (y - mb) for x, y in zip(va, vb))
        da = math.sqrt(sum((x - ma) ** 2 for x in va))
        db = math.sqrt(sum((y - mb) ** 2 for y in vb))
        return None if da == 0 or db == 0 else num / (da * db)

    register(sc + "pearson", _pearson)

    def _jaccard(a, b):
        s, t = set(_hashable_list(a)), set(_hashable_list(b))
        return len(s & t) / len(s | t) if s | t else 0.0

    def _dice(a, b):
        s, t = set(_hashable_list(a)), set(_hashable_list(b))
        return 2 * len(s & t) / (len(s) + len(t)) if s or t else 0.0

    def _overlap(a, b):
        s, t = set(_hashable_list(a)), set(_hashable_list(b))
        return len(s & t) / min(len(s), len(t)) if s and t else 0.0

    register(sc + "jaccard", _jaccard)
    register(sc + "dice", _dice)
    register(sc + "overlap", _overlap)
    register(sc + "tf", lambda count, total: (
        0.0 if not total else float(count) / float(total)))
    register(sc + "idf", lambda df, n_docs: (
        0.0 if not df else math.log(float(n_docs) / float(df))))
    register(sc + "tfidf", lambda count, total, df, n_docs: (
        (0.0 if not total else float(count) / float(total))
        * (0.0 if not df else math.log(float(n_docs) / float(df)))))

    def _bm25(tf, df, n_docs, dl, avgdl, k1=1.2, b=0.75):
        tf, df, n_docs = float(tf), float(df), float(n_docs)
        dl, avgdl = float(dl), float(avgdl)
        idf = math.log(1.0 + (n_docs - df + 0.5) / (df + 0.5))
        denom = tf + k1 * (1 - b + b * (dl / avgdl if avgdl else 1.0))
        return idf * (tf * (k1 + 1)) / denom if denom else 0.0

    register(sc + "bm25", _bm25)
    register(sc + "sigmoid", lambda x: 1.0 / (1.0 + math.exp(-float(x))))

    def _softmax(l):
        v = _nums(l)
        if not v:
            return []
        mx = max(v)
        exps = [math.exp(x - mx) for x in v]
        tot = sum(exps)
        return [e / tot for e in exps]

    register(sc + "softmax", _softmax)
    register(sc + "minmax", lambda l: (
        [(x - min(v)) / (max(v) - min(v)) if max(v) != min(v) else 0.0
         for x in v] if (v := _nums(l)) else []))
    register(sc + "normalize", lambda l: (
        [x / n for x in v] if (v := _nums(l)) and
        (n := math.sqrt(sum(x * x for x in v))) else list(v or [])))
    register(sc + "zscore", lambda l: (
        [(x - sum(v) / len(v)) / sd for x in v]
        if (v := _nums(l)) and len(v) > 1 and
        (sd := math.sqrt(_variance(v))) else [0.0] * len(_nums(l))))
    register(sc + "percentile", lambda l, p: _percentile(_nums(l), p))

    def _rank(l, desc=True):
        v = _nums(l)
        order = sorted(range(len(v)), key=lambda i: v[i], reverse=bool(desc))
        ranks = [0] * len(v)
        for r, i in enumerate(order):
            ranks[i] = r + 1
        return ranks

    register(sc + "rank", _rank)
    register(sc + "topK", lambda l, k: sorted(
        _nums(l), reverse=True)[: int(k)])
    register(sc + "pagerank", lambda incoming, damping=0.85: (
        (1.0 - float(damping)) + float(damping) * sum(_nums(incoming))))


def _install_coll_extras() -> None:
    import random as _random

    c = "apoc.coll."
    register(c + "containsDuplicates", lambda l: (
        len(_hashable_list(l)) != len(set(_hashable_list(l)))))
    register(c + "containsSorted", lambda l, v: _binary_contains(l or [], v))
    def _disjunction(a, b):
        a, b = list(a or []), list(b or [])
        ka, kb = set(_hashable_list(a)), set(_hashable_list(b))
        seen = set()
        out = []
        for x, k in zip(a + b, _hashable_list(a) + _hashable_list(b)):
            if k in seen or ((k in ka) == (k in kb)):
                continue
            seen.add(k)
            out.append(x)
        return out

    register(c + "disjunction", _disjunction)
    register(c + "duplicatesWithCount", lambda l: [
        {"item": k, "count": n}
        for k, n in _freq(l).items() if n > 1])
    register(c + "frequenciesAsMap", lambda l: {
        str(k): v for k, v in _freq(l).items()})
    register(c + "insertAll", lambda l, idx, items: (
        list(l or [])[: int(idx)] + list(items or [])
        + list(l or [])[int(idx):]))
    register(c + "isEmpty", lambda l: not l)
    register(c + "isNotEmpty", lambda l: bool(l))
    register(c + "pairsMin", lambda l: [
        [l[i], l[i + 1]] for i in range(len(l or []) - 1)])
    register(c + "randomItems", lambda l, n, allow_repeat=False: (
        [_random.choice(l) for _ in range(int(n))] if allow_repeat and l
        else _random.sample(list(l or []), min(int(n), len(l or [])))))
    register(c + "slice", lambda l, offset, length: list(
        (l or [])[int(offset): int(offset) + int(length)]))


def _freq(l) -> Dict[Any, int]:
    out: Dict[Any, int] = {}
    for x in l or []:
        k = x if not isinstance(x, (list, dict)) else repr(x)
        out[k] = out.get(k, 0) + 1
    return out


def _hashable_list(l) -> List[Any]:
    return [x if not isinstance(x, (list, dict)) else repr(x)
            for x in (l or [])]


def _binary_contains(l: List[Any], v: Any) -> bool:
    lo, hi = 0, len(l) - 1
    while lo <= hi:
        mid = (lo + hi) // 2
        if l[mid] == v:
            return True
        try:
            less = l[mid] < v
        except TypeError:
            return v in l
        if less:
            lo = mid + 1
        else:
            hi = mid - 1
    return False


def _install_text_util() -> None:
    t = "apoc.text."
    register(t + "base64Encode", lambda s: base64.b64encode(
        str(s).encode()).decode())

    def _b64decode(s):
        try:
            return base64.b64decode(str(s)).decode("utf-8", "replace")
        except (binascii.Error, ValueError):
            raise CypherRuntimeError("invalid base64")

    register(t + "base64Decode", _b64decode)
    register(t + "bytes", lambda s: list(str(s).encode()))
    register(t + "bytesToString",
             lambda b: bytes(int(x) & 0xFF for x in (b or [])).decode(
                 "utf-8", "replace"))
    register(t + "capitalizeAll", lambda s: None if s is None else
             re.sub(r"\b\w", lambda m: m.group().upper(), str(s)))
    register(t + "decapitalizeAll", lambda s: None if s is None else
             re.sub(r"\b\w", lambda m: m.group().lower(), str(s)))
    register(t + "compareCleaned", lambda a, b: (
        _clean(a) == _clean(b)))
    register(t + "fromCodePoint", lambda *cps: "".join(
        chr(int(c)) for c in cps))
    register(t + "indexesOf", lambda s, sub: [
        m.start() for m in re.finditer(re.escape(str(sub)), str(s))]
        if s is not None and sub is not None else [])
    register(t + "ltrim", lambda s: None if s is None else str(s).lstrip())
    register(t + "rtrim", lambda s: None if s is None else str(s).rstrip())
    register(t + "trim", lambda s: None if s is None else str(s).strip())
    register(t + "reverse", lambda s: None if s is None else str(s)[::-1])
    register(t + "urlencode", lambda s: urllib.parse.quote(str(s), safe=""))
    register(t + "urldecode", lambda s: urllib.parse.unquote(str(s)))
    register(t + "phonetic", lambda s: _soundex(str(s or "")))
    register(t + "phoneticDelta", lambda a, b: {
        "phonetic1": _soundex(str(a or "")), "phonetic2": _soundex(str(b or "")),
        "delta": sum(x != y for x, y in zip(_soundex(str(a or "")),
                                            _soundex(str(b or ""))))})
    register(t + "doubleMetaphone", lambda s: _metaphone(str(s or "")))

    u = "apoc.util."
    register(u + "coalesce", lambda *args: next(
        (a for a in args if a is not None), None))
    register(u + "when", lambda cond, a, b=None: a if cond else b)

    def _case(pairs, default=None):
        items = list(pairs or [])
        for i in range(0, len(items) - 1, 2):
            if items[i]:
                return items[i + 1]
        return default

    register(u + "case", _case)

    def _validate(cond, message="validation failed", params=None):
        if cond:
            raise CypherRuntimeError(str(message))
        return None

    register(u + "validate", _validate)
    register(u + "validatePredicate",
             lambda cond, message="validation failed", params=None: (
                 _validate(cond, message) or True))

    def _validate_pattern(value, pattern, message=None):
        if value is None or not re.fullmatch(str(pattern), str(value)):
            raise CypherRuntimeError(
                str(message or f"value {value!r} does not match {pattern}"))
        return value

    register(u + "validatePattern", _validate_pattern)
    register(u + "compress", lambda s: list(zlib.compress(str(s).encode())))
    register(u + "decompress", lambda b: zlib.decompress(
        bytes(int(x) & 0xFF for x in (b or []))).decode("utf-8", "replace"))

    def _compress_algo(s, algo="deflate"):
        data = str(s).encode()
        algo = str(algo).lower()
        if algo in ("deflate", "zlib"):
            return list(zlib.compress(data))
        if algo == "gzip":
            import gzip
            return list(gzip.compress(data))
        raise CypherRuntimeError(f"unknown algorithm {algo!r}")

    def _decompress_algo(b, algo="deflate"):
        data = bytes(int(x) & 0xFF for x in (b or []))
        algo = str(algo).lower()
        if algo in ("deflate", "zlib"):
            return zlib.decompress(data).decode("utf-8", "replace")
        if algo == "gzip":
            import gzip
            return gzip.decompress(data).decode("utf-8", "replace")
        raise CypherRuntimeError(f"unknown algorithm {algo!r}")

    register(u + "compressWithAlgorithm", _compress_algo)
    register(u + "decompressWithAlgorithm", _decompress_algo)
    register(u + "encodeBase64", lambda s: base64.b64encode(
        str(s).encode()).decode())
    register(u + "decodeBase64", _b64decode)
    register(u + "encodeUrl", lambda s: urllib.parse.quote(str(s), safe=""))
    register(u + "decodeUrl", lambda s: urllib.parse.unquote(str(s)))
    for algo in ("md5", "sha1", "sha256"):
        register(u + f"{algo}Hex", (lambda a: lambda *parts: getattr(
            hashlib, a)("".join(str(p) for p in parts).encode())
            .hexdigest())(algo))
        register(u + f"{algo}Base64", (lambda a: lambda *parts: base64.
                 b64encode(getattr(hashlib, a)(
                     "".join(str(p) for p in parts).encode())
                     .digest()).decode())(algo))
    register(u + "now", lambda: int(_time.time() * 1000))
    register(u + "nowInSeconds", lambda: int(_time.time()))
    register(u + "timestamp", lambda: int(_time.time() * 1000))
    register(u + "formatTimestamp", lambda ms, fmt="%Y-%m-%dT%H:%M:%SZ": (
        _time.strftime(str(fmt), _time.gmtime(float(ms) / 1000.0))))

    def _parse_ts(s, fmt="%Y-%m-%dT%H:%M:%SZ"):
        import calendar
        return int(calendar.timegm(_time.strptime(str(s), str(fmt))) * 1000)

    register(u + "parseTimestamp", _parse_ts)
    register(u + "isNode", lambda x: isinstance(x, Node))
    register(u + "isRelationship", lambda x: isinstance(x, Edge))

    def _is_path(x):
        from nornicdb_tpu_torch.query.functions import PathValue
        return isinstance(x, PathValue)

    register(u + "isPath", _is_path)

    def _typeof(x):
        from nornicdb_tpu_torch.query.functions import REGISTRY
        return REGISTRY["valuetype"](x)

    register(u + "typeof", _typeof)
    register(u + "merge", lambda a, b: {**(a or {}), **(b or {})})
    def _partition(l, size):
        n = int(size)
        if n <= 0:
            raise CypherRuntimeError("partition size must be positive")
        return [list((l or [])[i: i + n]) for i in range(0, len(l or []), n)]

    register(u + "partition", _partition)
    register(u + "range", lambda a, b, step=1: list(
        range(int(a), int(b) + (1 if int(step) > 0 else -1), int(step))))
    register(u + "repeat", lambda s, n: str(s) * int(n))
    register(u + "uuid", lambda: str(_uuid.uuid4()))
    register(u + "randomUuid", lambda: str(_uuid.uuid4()))

    def _sleep(ms):
        _time.sleep(min(float(ms), 10_000.0) / 1000.0)  # clamp: 10s max
        return None

    register(u + "sleep", _sleep)


def _clean(s) -> str:
    return re.sub(r"[^a-z0-9]", "", str(s or "").lower())


def _soundex(s: str) -> str:
    """Classic Soundex code (the reference's phonetic baseline)."""
    s = re.sub(r"[^A-Za-z]", "", s).upper()
    if not s:
        return ""
    codes = {**dict.fromkeys("BFPV", "1"), **dict.fromkeys("CGJKQSXZ", "2"),
             **dict.fromkeys("DT", "3"), "L": "4",
             **dict.fromkeys("MN", "5"), "R": "6"}
    out = s[0]
    prev = codes.get(s[0], "")
    for ch in s[1:]:
        code = codes.get(ch, "")
        if code and code != prev:
            out += code
        if ch not in "HW":
            prev = code
    return (out + "000")[:4]


def _metaphone(s: str) -> List[str]:
    """Simplified double-metaphone: primary key + soundex alternate."""
    s2 = re.sub(r"[^A-Za-z]", "", s).upper()
    if not s2:
        return ["", ""]
    subs = [("PH", "F"), ("GH", "H"), ("CK", "K"), ("SCH", "SK"),
            ("TH", "0"), ("SH", "X"), ("CH", "X"), ("DG", "J"),
            ("WR", "R"), ("KN", "N"), ("GN", "N")]
    w = s2
    for a, b in subs:
        w = w.replace(a, b)
    # drop vowels after the first letter; dedupe runs
    out = w[0]
    for ch in w[1:]:
        if ch in "AEIOU":
            continue
        if out and out[-1] == ch:
            continue
        out += ch
    return [out[:6], _soundex(s)]


def _install_json_diff() -> None:
    j = "apoc.json."

    def _parse(s):
        try:
            return _json.loads(s) if isinstance(s, str) else s
        except (ValueError, TypeError):
            raise CypherRuntimeError("invalid JSON")

    def _jsonable(v):
        if isinstance(v, (Node, Edge)):
            return dict(v.properties)
        if isinstance(v, list):
            return [_jsonable(x) for x in v]
        if isinstance(v, dict):
            return {k: _jsonable(x) for k, x in v.items()}
        return v

    register(j + "parse", _parse)
    register(j + "validate", lambda s: _try_json(s))
    register(j + "stringify", lambda v: _json.dumps(_jsonable(v)))
    register(j + "pretty", lambda v: _json.dumps(
        _jsonable(_parse(v) if isinstance(v, str) else v), indent=2,
        sort_keys=True))
    register(j + "compact", lambda v: _json.dumps(
        _jsonable(_parse(v) if isinstance(v, str) else v),
        separators=(",", ":")))
    register(j + "keys", lambda v: sorted(
        (_parse(v) if isinstance(v, str) else v or {}).keys()))
    register(j + "values", lambda v: list(
        (_parse(v) if isinstance(v, str) else v or {}).values()))
    register(j + "size", lambda v: len(
        _parse(v) if isinstance(v, str) else (v or {})))
    register(j + "type", lambda v: _json_type(
        _parse(v) if isinstance(v, str) else v))
    register(j + "map", lambda v: dict(
        _parse(v) if isinstance(v, str) else (v or {})))
    register(j + "merge", lambda a, b: {
        **(_parse(a) if isinstance(a, str) else a or {}),
        **(_parse(b) if isinstance(b, str) else b or {})})

    def _path_get(obj, path):
        cur = obj
        for part in _split_json_path(path):
            if isinstance(cur, dict):
                if part not in cur:
                    return None
                cur = cur[part]
            elif isinstance(cur, list):
                try:
                    cur = cur[int(part)]
                except (ValueError, IndexError):
                    return None
            else:
                return None
        return cur

    def _split_json_path(path) -> List[str]:
        p = str(path or "")
        p = p[2:] if p.startswith("$.") else p.lstrip("$")
        parts: List[str] = []
        for seg in p.split("."):
            if not seg:
                continue
            m = re.match(r"([^\[]*)((\[\d+\])*)$", seg)
            if m:
                if m.group(1):
                    parts.append(m.group(1))
                for idx in re.findall(r"\[(\d+)\]", m.group(2)):
                    parts.append(idx)
            else:
                parts.append(seg)
        return parts

    def _path_set(obj, path, value, delete=False):
        obj = _parse(obj) if isinstance(obj, str) else obj
        parts = _split_json_path(path)
        if not parts:
            return value
        import copy
        out = copy.deepcopy(obj)
        cur = out
        for part in parts[:-1]:
            if isinstance(cur, list):
                try:
                    idx = int(part)
                except ValueError:
                    raise CypherRuntimeError(
                        f"list index expected at {part!r}")
                if not 0 <= idx < len(cur):
                    raise CypherRuntimeError(f"index {idx} out of range")
                cur = cur[idx]
                continue
            nxt = cur.get(part) if isinstance(cur, dict) else None
            if not isinstance(nxt, (dict, list)):
                nxt = {}
                cur[part] = nxt
            cur = nxt
        last = parts[-1]
        if isinstance(cur, list):
            try:
                idx = int(last)
            except ValueError:
                raise CypherRuntimeError(f"list index expected at {last!r}")
            if delete:
                if 0 <= idx < len(cur):
                    cur.pop(idx)
            elif 0 <= idx < len(cur):
                cur[idx] = value
            elif idx == len(cur):
                cur.append(value)
            else:
                raise CypherRuntimeError(f"index {idx} out of range")
        elif delete:
            if isinstance(cur, dict):
                cur.pop(last, None)
        else:
            cur[last] = value
        return out

    register(j + "get", _path_get)
    register(j + "set", lambda obj, path, v: _path_set(obj, path, v))
    register(j + "delete", lambda obj, path: _path_set(
        obj, path, None, delete=True))
    register(j + "filter", lambda obj, path: _path_get(
        _parse(obj) if isinstance(obj, str) else obj, path))

    def _flatten_json(v, prefix="", out=None):
        out = {} if out is None else out
        if isinstance(v, dict):
            for k, x in v.items():
                _flatten_json(x, f"{prefix}{k}.", out)
        elif isinstance(v, list):
            for i, x in enumerate(v):
                _flatten_json(x, f"{prefix}{i}.", out)
        else:
            out[prefix[:-1]] = v
        return out

    register(j + "flatten", lambda v: _flatten_json(
        _parse(v) if isinstance(v, str) else (v or {})))

    def _unflatten(flat):
        out: Dict[str, Any] = {}
        for key, value in (flat or {}).items():
            cur = out
            parts = str(key).split(".")
            for part in parts[:-1]:
                cur = cur.setdefault(part, {})
            cur[parts[-1]] = value
        return out

    register(j + "unflatten", _unflatten)

    def _reduce(v):
        """Total count of leaf values."""
        obj = _parse(v) if isinstance(v, str) else v
        if isinstance(obj, dict):
            return sum(_reduce(x) for x in obj.values())
        if isinstance(obj, list):
            return sum(_reduce(x) for x in obj)
        return 1

    register(j + "reduce", _reduce)

    d = "apoc.diff."

    def _diff_maps(a, b):
        a, b = a or {}, b or {}
        left = {k: v for k, v in a.items() if k not in b}
        right = {k: v for k, v in b.items() if k not in a}
        different = {k: {"left": a[k], "right": b[k]}
                     for k in a.keys() & b.keys() if a[k] != b[k]}
        same = {k: a[k] for k in a.keys() & b.keys() if a[k] == b[k]}
        return {"leftOnly": left, "rightOnly": right,
                "inCommon": same, "different": different}

    register(d + "maps", _diff_maps)
    register(d + "nodes", lambda a, b: _diff_maps(
        a.properties if isinstance(a, Node) else a,
        b.properties if isinstance(b, Node) else b))
    register(d + "relationships", lambda a, b: _diff_maps(
        a.properties if isinstance(a, Edge) else a,
        b.properties if isinstance(b, Edge) else b))
    register(d + "lists", lambda a, b: {
        "leftOnly": [x for x in (a or []) if x not in (b or [])],
        "rightOnly": [x for x in (b or []) if x not in (a or [])],
        "inCommon": [x for x in (a or []) if x in (b or [])]})

    def _diff_strings(a, b):
        a, b = str(a or ""), str(b or "")
        prefix = 0
        for x, y in zip(a, b):
            if x != y:
                break
            prefix += 1
        return {"equal": a == b, "commonPrefix": a[:prefix],
                "left": a[prefix:], "right": b[prefix:],
                "distance": _levenshtein(a, b)}

    register(d + "strings", _diff_strings)

    def _deep(a, b, path=""):
        diffs: List[Dict[str, Any]] = []
        if isinstance(a, dict) and isinstance(b, dict):
            for k in sorted(set(a) | set(b)):
                p = f"{path}.{k}" if path else str(k)
                if k not in a:
                    diffs.append({"path": p, "kind": "added", "right": b[k]})
                elif k not in b:
                    diffs.append({"path": p, "kind": "removed", "left": a[k]})
                else:
                    diffs.extend(_deep(a[k], b[k], p))
        elif isinstance(a, list) and isinstance(b, list):
            for i in range(max(len(a), len(b))):
                p = f"{path}[{i}]"
                if i >= len(a):
                    diffs.append({"path": p, "kind": "added", "right": b[i]})
                elif i >= len(b):
                    diffs.append({"path": p, "kind": "removed", "left": a[i]})
                else:
                    diffs.extend(_deep(a[i], b[i], p))
        elif a != b:
            diffs.append({"path": path, "kind": "changed",
                          "left": a, "right": b})
        return diffs

    register(d + "deep", _deep)
    register(d + "summary", lambda a, b: {
        "differences": len(_deep(a, b)),
        "equal": not _deep(a, b)})
    register(d + "merge", lambda a, b: _deep_merge(a, b))

    def _patch(a, patches):
        import copy
        out = copy.deepcopy(a) if isinstance(a, (dict, list)) else a
        for p in patches or []:
            kind = p.get("kind")
            path = p.get("path", "")
            parts = re.split(r"\.|\[|\]", path)
            parts = [x for x in parts if x]
            cur = out
            for part in parts[:-1]:
                cur = cur[int(part)] if isinstance(cur, list) else cur[part]
            last = parts[-1] if parts else None
            if last is None:
                continue
            key = int(last) if isinstance(cur, list) else last
            if kind == "removed":
                if isinstance(cur, dict):
                    cur.pop(key, None)
                elif isinstance(cur, list) and int(last) < len(cur):
                    cur.pop(int(last))
            else:
                if isinstance(cur, list) and int(last) >= len(cur):
                    cur.append(p.get("right"))
                else:
                    cur[key] = p.get("right")
        return out

    register(d + "patch", _patch)


def _deep_merge(a, b):
    if isinstance(a, dict) and isinstance(b, dict):
        out = dict(a)
        for k, v in b.items():
            out[k] = _deep_merge(a[k], v) if k in a else v
        return out
    return b


# one edit-distance implementation for both apoc.text.* and apoc.diff.*
from nornicdb_tpu_torch.query.apoc import _levenshtein  # noqa: E402


def _try_json(s) -> bool:
    try:
        _json.loads(s)
        return True
    except (ValueError, TypeError):
        return False


def _json_type(v) -> str:
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "BOOLEAN"
    if isinstance(v, int):
        return "INTEGER"
    if isinstance(v, float):
        return "FLOAT"
    if isinstance(v, str):
        return "STRING"
    if isinstance(v, list):
        return "LIST"
    if isinstance(v, dict):
        return "MAP"
    return type(v).__name__.upper()


def _install_temporal_date() -> None:
    import datetime as _dt

    from nornicdb_tpu_torch.query import temporal_types as T

    tp = "apoc.temporal."

    def _as_dt(v) -> _dt.datetime:
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            return _dt.datetime.fromtimestamp(float(v) / 1000.0,
                                              tz=_dt.timezone.utc)
        dtv = T.make_datetime(v)
        return dtv._dt

    _UNIT_SECONDS = {"millisecond": 0.001, "second": 1, "minute": 60,
                     "hour": 3600, "day": 86400, "week": 604800}

    def _add(v, amount, unit="day"):
        d = _as_dt(v)
        u = str(unit).lower().rstrip("s")
        if u == "month":
            month = d.month - 1 + int(amount)
            year = d.year + month // 12
            month = month % 12 + 1
            day = min(d.day, _days_in_month(year, month))
            return T.CypherDateTime(d.replace(year=year, month=month,
                                              day=day))
        if u == "year":
            return T.CypherDateTime(d.replace(year=d.year + int(amount)))
        secs = _UNIT_SECONDS.get(u)
        if secs is None:
            raise CypherRuntimeError(f"unknown unit {unit!r}")
        return T.CypherDateTime(d + _dt.timedelta(seconds=secs * float(amount)))

    register(tp + "add", _add)
    register(tp + "subtract", lambda v, amount, unit="day": _add(
        v, -float(amount), unit))
    register(tp + "dayOfWeek", lambda v: _as_dt(v).isoweekday())
    register(tp + "dayOfYear", lambda v: _as_dt(v).timetuple().tm_yday)
    register(tp + "daysInMonth", lambda v: _days_in_month(
        _as_dt(v).year, _as_dt(v).month))
    register(tp + "quarter", lambda v: (_as_dt(v).month - 1) // 3 + 1)
    register(tp + "weekOfYear", lambda v: _as_dt(v).isocalendar()[1])
    register(tp + "isLeapYear", lambda v: _is_leap(
        int(v) if isinstance(v, (int, float)) and float(v) < 10_000
        else _as_dt(v).year))
    register(tp + "isWeekday", lambda v: _as_dt(v).isoweekday() <= 5)
    register(tp + "isWeekend", lambda v: _as_dt(v).isoweekday() > 5)
    register(tp + "toEpochMillis", lambda v: int(
        _as_dt(v).timestamp() * 1000))
    register(tp + "fromEpochMillis", lambda ms: T.CypherDateTime(
        _dt.datetime.fromtimestamp(float(ms) / 1000.0, tz=_dt.timezone.utc)))
    register(tp + "isBetween", lambda v, a, b: (
        _as_dt(a) <= _as_dt(v) <= _as_dt(b)))
    def _difference(a, b, unit="millisecond"):
        u = str(unit).lower().rstrip("s")
        secs = _UNIT_SECONDS.get(u)
        if secs is None:
            raise CypherRuntimeError(f"unknown unit {unit!r}")
        return (_as_dt(b) - _as_dt(a)).total_seconds() / secs

    register(tp + "difference", _difference)
    register(tp + "age", lambda v: T.duration_between(
        T.make_datetime(v), T.make_datetime()))
    register(tp + "timezone", lambda v=None: "UTC")
    register(tp + "toUTC", lambda v: T.CypherDateTime(
        _as_dt(v).astimezone(_dt.timezone.utc)))
    register(tp + "toLocal", lambda v: T.CypherLocalDateTime(
        _as_dt(v).replace(tzinfo=None)))
    register(tp + "truncate", lambda v, unit="day": T.truncate(
        str(unit), T.make_datetime(v), "datetime"))

    def _start_of(v, unit="day"):
        return T.truncate(str(unit), T.make_datetime(v), "datetime")

    def _end_of(v, unit="day"):
        start = _start_of(v, unit)
        nxt = _add(start, 1, str(unit))
        return T.CypherDateTime(nxt._dt - _dt.timedelta(milliseconds=1))

    register(tp + "startOf", _start_of)
    register(tp + "endOf", _end_of)

    def _round(v, unit="day"):
        d = _as_dt(v)
        floor = _start_of(v, unit)._dt
        ceil = _add(floor, 1, str(unit))._dt
        return T.CypherDateTime(
            floor if (d - floor) <= (ceil - d) else ceil)

    register(tp + "round", _round)

    def _fmt_duration(ms):
        ms = int(ms)
        sign = "-" if ms < 0 else ""
        ms = abs(ms)
        s, ms = divmod(ms, 1000)
        m, s = divmod(s, 60)
        h, m = divmod(m, 60)
        d, h = divmod(h, 24)
        parts = []
        if d:
            parts.append(f"{d}d")
        if h:
            parts.append(f"{h}h")
        if m:
            parts.append(f"{m}m")
        if s or not parts:
            parts.append(f"{s}s")
        return sign + " ".join(parts)

    register(tp + "formatDuration", _fmt_duration)
    register(tp + "duration", lambda m: T.parse_duration(m))
    register(tp + "parse", lambda s, fmt=None: (
        T.make_datetime(s) if fmt is None else T.CypherDateTime(
            _strptime_utc(s, fmt))))

    dd = "apoc.date."
    register(dd + "fromUnixtime", lambda secs, fmt="%Y-%m-%d %H:%M:%S": (
        _time.strftime(str(fmt).replace("yyyy", "%Y").replace("MM", "%m")
                       .replace("dd", "%d").replace("HH", "%H")
                       .replace("mm", "%M").replace("ss", "%S"),
                       _time.gmtime(float(secs)))))
    register(dd + "toUnixtime", lambda s, fmt=None: int(
        _as_dt(s).timestamp()))
    register(dd + "toYears", lambda ms: float(ms) / (365.25 * 86400 * 1000))
    register(dd + "systemTimezone", lambda: "UTC")
    register(dd + "fields", lambda v, fmt=None: {
        "years": _as_dt(v).year, "months": _as_dt(v).month,
        "days": _as_dt(v).day, "hours": _as_dt(v).hour,
        "minutes": _as_dt(v).minute, "seconds": _as_dt(v).second,
        "weekdays": _as_dt(v).isoweekday()})
    register(dd + "convertFormat", lambda s, from_fmt, to_fmt: (
        _strptime_utc(s, from_fmt).strftime(_java_fmt(to_fmt))))
    register(dd + "parseAsZonedDateTime", lambda s, fmt=None: (
        T.make_datetime(s) if fmt is None
        else T.CypherDateTime(_strptime_utc(s, fmt))))


def _java_fmt(fmt: str) -> str:
    return (str(fmt).replace("yyyy", "%Y").replace("MM", "%m")
            .replace("dd", "%d").replace("HH", "%H").replace("mm", "%M")
            .replace("ss", "%S"))


def _strptime_utc(s, fmt):
    import datetime as _dt
    return _dt.datetime.strptime(str(s), _java_fmt(fmt)).replace(
        tzinfo=_dt.timezone.utc)


def _days_in_month(year: int, month: int) -> int:
    import calendar
    return calendar.monthrange(year, month)[1]


def _is_leap(year: int) -> bool:
    return year % 4 == 0 and (year % 100 != 0 or year % 400 == 0)


def _install_convert_extras() -> None:
    cv = "apoc.convert."

    def _num_or_none(x, typ):
        try:
            return typ(x)
        except (TypeError, ValueError):
            return None

    register(cv + "toIntList", lambda l: [
        _num_or_none(x, int) for x in (l or [])])
    register(cv + "toFloatList", lambda l: [
        _num_or_none(x, float) for x in (l or [])])
    register(cv + "toStringList", lambda l: [
        None if x is None else str(x) for x in (l or [])])
    register(cv + "toBooleanList", lambda l: [
        None if x is None else bool(x) for x in (l or [])])
    register(cv + "toSet", lambda l: list(dict.fromkeys(
        _hashable_list(l))))
    register(cv + "toMap", lambda v: (
        dict(v.properties) if isinstance(v, (Node, Edge))
        else dict(v or {})))
    register(cv + "toNode", lambda v: v if isinstance(v, Node) else None)
    register(cv + "toRelationship",
             lambda v: v if isinstance(v, Edge) else None)
    register(cv + "toNodeList", lambda l: [
        x for x in (l or []) if isinstance(x, Node)])
    register(cv + "toRelationshipList", lambda l: [
        x for x in (l or []) if isinstance(x, Edge)])
    register(cv + "toSortedJsonMap", lambda v: _json.dumps(
        v or {}, sort_keys=True))
    register(cv + "getJsonProperty", lambda node, key: (
        _json.loads(node.properties.get(key))
        if isinstance(node, Node) and isinstance(
            node.properties.get(key), str) else None))
    register(cv + "getJsonPropertyMap", lambda node, key: (
        m if isinstance(m := (
            _json.loads(node.properties[key])
            if isinstance(node, Node) and isinstance(
                node.properties.get(key), str) else None), dict) else None))
    register(cv + "fromJsonNode", lambda s: (
        _json.loads(s) if isinstance(s, str) else s))

    def _to_tree(paths):
        """List of paths -> nested tree keyed by node id (reference
        apoc.convert.totree)."""
        from nornicdb_tpu_torch.query.functions import PathValue

        roots: Dict[str, Dict[str, Any]] = {}
        nodes_seen: Dict[str, Dict[str, Any]] = {}

        def entry(n: Node) -> Dict[str, Any]:
            if n.id not in nodes_seen:
                nodes_seen[n.id] = {"_id": n.id, "_type": ":".join(n.labels),
                                    **n.properties}
            return nodes_seen[n.id]

        for p in paths or []:
            if not isinstance(p, PathValue) or not p.nodes:
                continue
            root = entry(p.nodes[0])
            roots.setdefault(p.nodes[0].id, root)
            for i, rel in enumerate(p.rels):
                parent = entry(p.nodes[i])
                child = entry(p.nodes[i + 1])
                key = rel.type.lower()
                kids = parent.setdefault(key, [])
                if child not in kids:
                    kids.append(child)
        return list(roots.values())

    register(cv + "toTree", _to_tree)


def _install_xml() -> None:
    import xml.etree.ElementTree as ET
    from xml.sax.saxutils import escape as _xesc, unescape as _xunesc

    x = "apoc.xml."

    def _parse(s) -> ET.Element:
        try:
            return ET.fromstring(str(s))
        except ET.ParseError as exc:
            raise CypherRuntimeError(f"invalid XML: {exc}")

    def _el_to_map(el: ET.Element) -> Dict[str, Any]:
        out: Dict[str, Any] = {"_type": el.tag.split("}")[-1]}
        if el.attrib:
            out.update({k.split("}")[-1]: v for k, v in el.attrib.items()})
        text = (el.text or "").strip()
        if text:
            out["_text"] = text
        children = [_el_to_map(c) for c in el]
        if children:
            out["_children"] = children
        return out

    def _map_to_el(m: Dict[str, Any]) -> ET.Element:
        el = ET.Element(str(m.get("_type", "root")))
        for k, v in m.items():
            if k in ("_type", "_text", "_children"):
                continue
            el.set(k, str(v))
        if m.get("_text") is not None:
            el.text = str(m["_text"])
        for child in m.get("_children", []) or []:
            el.append(_map_to_el(child))
        return el

    register(x + "parse", lambda s: _el_to_map(_parse(s)))
    register(x + "toMap", lambda s: _el_to_map(_parse(s)))
    register(x + "toJson", lambda s: _json.dumps(_el_to_map(_parse(s))))
    register(x + "fromJson", lambda s: ET.tostring(
        _map_to_el(_json.loads(s) if isinstance(s, str) else s),
        encoding="unicode"))
    register(x + "fromMap", lambda m: ET.tostring(
        _map_to_el(m or {}), encoding="unicode"))
    register(x + "toString", lambda m: ET.tostring(
        _map_to_el(m) if isinstance(m, dict) else _parse(m),
        encoding="unicode"))
    register(x + "validate", lambda s: _xml_ok(s))
    register(x + "escape", lambda s: _xesc(str(s or "")))
    register(x + "unescape", lambda s: _xunesc(str(s or "")))
    register(x + "minify", lambda s: re.sub(r">\s+<", "><", str(s).strip()))

    def _prettify(s):
        import xml.dom.minidom
        return xml.dom.minidom.parseString(str(s)).toprettyxml(
            indent="  ").replace('<?xml version="1.0" ?>\n', "")

    register(x + "prettify", _prettify)
    register(x + "getAttribute", lambda s, attr: _parse(s).get(str(attr)))
    register(x + "getText", lambda s: "".join(_parse(s).itertext()))
    register(x + "getNamespace", lambda s: (
        m.group(1) if (m := re.match(r"\{(.+)\}", _parse(s).tag)) else None))
    register(x + "namespace", lambda s: (
        m.group(1) if (m := re.match(r"\{(.+)\}", _parse(s).tag)) else None))

    def _query(s, xpath):
        root = _parse(s)
        return [_el_to_map(el) for el in root.findall(str(xpath))]

    register(x + "query", _query)

    def _set_attribute(s, attr, value):
        el = _parse(s)
        el.set(str(attr), str(value))
        return ET.tostring(el, encoding="unicode")

    register(x + "setAttribute", _set_attribute)

    def _set_text(s, text):
        el = _parse(s)
        el.text = str(text)
        return ET.tostring(el, encoding="unicode")

    register(x + "setText", _set_text)

    def _add_child(s, child):
        el = _parse(s)
        el.append(_parse(child) if isinstance(child, str)
                  else _map_to_el(child))
        return ET.tostring(el, encoding="unicode")

    register(x + "addChild", _add_child)

    def _remove_child(s, tag):
        el = _parse(s)
        for c in list(el):
            if c.tag == str(tag):
                el.remove(c)
        return ET.tostring(el, encoding="unicode")

    register(x + "removeChild", _remove_child)
    register(x + "clone", lambda s: ET.tostring(
        _parse(s), encoding="unicode"))
    register(x + "create", lambda tag, attrs=None, text=None: ET.tostring(
        _map_to_el({"_type": tag, **(attrs or {}),
                    **({"_text": text} if text is not None else {})}),
        encoding="unicode"))

    def _transform(s, mapping):
        """Rename tags via a {old: new} map."""
        el = _parse(s)
        for node in el.iter():
            new = (mapping or {}).get(node.tag)
            if new:
                node.tag = str(new)
        root_new = (mapping or {}).get(el.tag)
        if root_new:
            el.tag = str(root_new)
        return ET.tostring(el, encoding="unicode")

    register(x + "transform", _transform)

    def _xml_ok(s) -> bool:
        try:
            ET.fromstring(str(s))
            return True
        except ET.ParseError:
            return False


def _install_hashing_extras() -> None:
    h = "apoc.hashing."

    def _cat(parts) -> bytes:
        if isinstance(parts, list):
            return "".join(str(p) for p in parts).encode()
        return str(parts).encode()

    for algo in ("md5", "sha1", "sha256", "sha384", "sha512"):
        register(h + algo, (lambda a: lambda v: getattr(hashlib, a)(
            _cat(v)).hexdigest())(algo))

    def _fnv1(v, bits64=True, fnv1a=False):
        data = _cat(v)
        if bits64:
            prime, offset, mask = 0x100000001b3, 0xcbf29ce484222325, _U64
        else:
            prime, offset, mask = 0x01000193, 0x811c9dc5, 0xFFFFFFFF
        acc = offset
        for byte in data:
            if fnv1a:
                acc = ((acc ^ byte) * prime) & mask
            else:
                acc = ((acc * prime) & mask) ^ byte
        return _i64(acc) if bits64 else acc

    register(h + "fnv1", lambda v: _fnv1(v, bits64=False))
    register(h + "fnv164", lambda v: _fnv1(v, bits64=True))
    register(h + "fnv1a", lambda v: _fnv1(v, bits64=False, fnv1a=True))
    register(h + "fnv1a64", lambda v: _fnv1(v, bits64=True, fnv1a=True))

    def _murmur3_32(v, seed=0):
        data = _cat(v)
        c1, c2 = 0xcc9e2d51, 0x1b873593
        h1 = int(seed) & 0xFFFFFFFF
        rounded = len(data) - len(data) % 4
        for i in range(0, rounded, 4):
            k1 = int.from_bytes(data[i:i + 4], "little")
            k1 = (k1 * c1) & 0xFFFFFFFF
            k1 = ((k1 << 15) | (k1 >> 17)) & 0xFFFFFFFF
            k1 = (k1 * c2) & 0xFFFFFFFF
            h1 ^= k1
            h1 = ((h1 << 13) | (h1 >> 19)) & 0xFFFFFFFF
            h1 = (h1 * 5 + 0xe6546b64) & 0xFFFFFFFF
        k1 = 0
        tail = data[rounded:]
        if len(tail) >= 3:
            k1 ^= tail[2] << 16
        if len(tail) >= 2:
            k1 ^= tail[1] << 8
        if len(tail) >= 1:
            k1 ^= tail[0]
            k1 = (k1 * c1) & 0xFFFFFFFF
            k1 = ((k1 << 15) | (k1 >> 17)) & 0xFFFFFFFF
            k1 = (k1 * c2) & 0xFFFFFFFF
            h1 ^= k1
        h1 ^= len(data)
        h1 ^= h1 >> 16
        h1 = (h1 * 0x85ebca6b) & 0xFFFFFFFF
        h1 ^= h1 >> 13
        h1 = (h1 * 0xc2b2ae35) & 0xFFFFFFFF
        h1 ^= h1 >> 16
        return h1

    register(h + "murmurhash3", _murmur3_32)

    def _jumphash(key, buckets):
        """Jump consistent hash (Lamping & Veach)."""
        k = int(hashlib.md5(_cat(key)).hexdigest()[:16], 16)
        b, j = -1, 0
        nb = int(buckets)
        while j < nb:
            b = j
            k = (k * 2862933555777941757 + 1) & _U64
            j = int((b + 1) * ((1 << 31) / ((k >> 33) + 1)))
        return b

    register(h + "jumphash", _jumphash)
    register(h + "consistenthash", lambda key, buckets: _jumphash(
        key, buckets))

    def _rendezvous(key, nodes):
        best, best_w = None, -1
        for node in nodes or []:
            w = int(hashlib.md5(
                (str(key) + "|" + str(node)).encode()).hexdigest()[:8], 16)
            if w > best_w:
                best, best_w = node, w
        return best

    register(h + "rendezvoushash", _rendezvous)

    def _fingerprint_graph(nodes, rels=None):
        parts = []
        for n in sorted(nodes or [], key=lambda n: n.id):
            parts.append(n.id + "|" + ":".join(sorted(n.labels)) + "|"
                         + _json.dumps(n.properties, sort_keys=True,
                                       default=str))
        for r in sorted(rels or [], key=lambda r: r.id):
            parts.append(r.id + "|" + r.type + "|" + r.start_node + ">"
                         + r.end_node + "|"
                         + _json.dumps(r.properties, sort_keys=True,
                                       default=str))
        return hashlib.sha256("\n".join(parts).encode()).hexdigest()

    register(h + "fingerprintGraph", _fingerprint_graph)


# -- apoc.agg.* aggregate finalizers --------------------------------------
#
# The executor collects one evaluated-args tuple per row and calls
# these with the full list (nulls preserved in the tuples; each
# finalizer applies its own null policy, matching the reference's
# aggregate behavior).

def _vals(rows: List[tuple]) -> List[Any]:
    return [r[0] for r in rows if r and r[0] is not None]


def _agg_first(rows):
    v = _vals(rows)
    return v[0] if v else None


def _agg_last(rows):
    v = _vals(rows)
    return v[-1] if v else None


def _agg_nth(rows):
    v = [r[0] for r in rows if r]
    if not v:
        return None
    n = rows[0][1] if len(rows[0]) > 1 else 0
    nn = int(n or 0)
    vv = [x for x in v if x is not None]
    return vv[nn] if -len(vv) <= nn < len(vv) else None


def _agg_slice(rows):
    vv = _vals(rows)
    start = int(rows[0][1]) if rows and len(rows[0]) > 1 else 0
    length = int(rows[0][2]) if rows and len(rows[0]) > 2 else len(vv)
    return vv[start:start + length]


def _agg_product(rows):
    out = 1
    for v in _vals(rows):
        out *= v
    return out


def _agg_statistics(rows):
    v = [float(x) for x in _vals(rows)
         if isinstance(x, (int, float)) and not isinstance(x, bool)]
    if not v:
        return {"count": 0}
    return {"count": len(v), "min": min(v), "max": max(v),
            "sum": sum(v), "mean": sum(v) / len(v),
            "stdev": (math.sqrt(_variance(v, sample=True))
                      if len(v) > 1 else 0.0)}


def _agg_items(rows, want_max: bool):
    pairs = [(r[0], r[1]) for r in rows
             if r and len(r) > 1 and r[1] is not None]
    if not pairs:
        return {"items": [], "value": None}
    best = max(p[1] for p in pairs) if want_max else min(
        p[1] for p in pairs)
    return {"value": best, "items": [p[0] for p in pairs if p[1] == best]}


def _agg_histogram(rows):
    counts: Dict[Any, int] = {}
    for v in _vals(rows):
        counts[v] = counts.get(v, 0) + 1
    return [{"value": k, "count": n} for k, n in sorted(
        counts.items(), key=lambda kv: (str(type(kv[0])), str(kv[0])))]


def _agg_graph(rows):
    nodes: Dict[str, Node] = {}
    rels: Dict[str, Edge] = {}

    def visit(v):
        if isinstance(v, Node):
            nodes[v.id] = v
        elif isinstance(v, Edge):
            rels[v.id] = v
        elif isinstance(v, list):
            for x in v:
                visit(x)
        else:
            from nornicdb_tpu_torch.query.functions import PathValue
            if isinstance(v, PathValue):
                for n in v.nodes:
                    nodes[n.id] = n
                for r in v.rels:
                    rels[r.id] = r

    for r in rows:
        for v in r:
            visit(v)
    return {"nodes": list(nodes.values()), "relationships": list(rels.values())}


AGG_FINALIZERS: Dict[str, Callable[[List[tuple]], Any]] = {
    "apoc.agg.first": _agg_first,
    "apoc.agg.last": _agg_last,
    "apoc.agg.nth": _agg_nth,
    "apoc.agg.slice": _agg_slice,
    "apoc.agg.median": lambda rows: _median(
        [float(x) for x in _vals(rows)
         if isinstance(x, (int, float)) and not isinstance(x, bool)]),
    "apoc.agg.mode": lambda rows: _mode(_vals(rows)),
    "apoc.agg.product": _agg_product,
    "apoc.agg.statistics": _agg_statistics,
    "apoc.agg.stdev": lambda rows: (
        math.sqrt(v) if (v := _variance(
            [float(x) for x in _vals(rows)
             if isinstance(x, (int, float)) and not isinstance(x, bool)],
            sample=True)) is not None else None),
    "apoc.agg.percentile": lambda rows: _percentile(
        [float(x) for x in _vals(rows)
         if isinstance(x, (int, float)) and not isinstance(x, bool)],
        float(rows[0][1]) if rows and len(rows[0]) > 1 else 0.5),
    "apoc.agg.maxitems": lambda rows: _agg_items(rows, want_max=True),
    "apoc.agg.minitems": lambda rows: _agg_items(rows, want_max=False),
    "apoc.agg.frequencies": _agg_histogram,
    "apoc.agg.histogram": _agg_histogram,
    "apoc.agg.graph": _agg_graph,
}


def install() -> None:
    _install_bitwise()
    _install_number()
    _install_math_stats()
    _install_scoring()
    _install_coll_extras()
    _install_text_util()
    _install_json_diff()
    _install_temporal_date()
    _install_convert_extras()
    _install_xml()
    _install_hashing_extras()


install()
