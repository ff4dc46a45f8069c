"""Cypher temporal, duration, and spatial value types (counterpart of
``nornicdb_tpu/query/temporal_types.py``). ``encode_value`` and
``decode_map`` are the record codec's hooks for them.

Reference: pkg/cypher/duration.go + the temporal builtins in
functions_eval_functions.go (date/datetime/localdatetime/time/localtime
construction, component access, truncate, arithmetic) and spatial
point()/distance(). Semantics follow the openCypher/Neo4j temporal
model: value types compare within kind, support component properties
(d.year, t.hour, dur.days, p.x), add/subtract durations, and stringify
to ISO-8601.
"""

from __future__ import annotations

import datetime as _dt
import math
import re
from typing import Any, Dict, Optional, Tuple

from nornicdb_tpu_torch.errors import CypherRuntimeError

_AVG_DAYS_PER_MONTH = 30.436875
_AVG_SECONDS_PER_DAY = 86400.0

_NANOS = 1_000_000_000


class CypherDuration:
    """Neo4j duration: months / days / seconds / nanoseconds held
    separately (calendar-aware, like duration.go)."""

    __slots__ = ("months", "days", "seconds", "nanos")

    def __init__(self, months: int = 0, days: int = 0, seconds: int = 0,
                 nanos: int = 0):
        # normalize nanos into seconds but keep months/days/seconds apart
        extra, nanos = divmod(nanos, _NANOS)
        self.months = int(months)
        self.days = int(days)
        self.seconds = int(seconds) + int(extra)
        self.nanos = int(nanos)

    # -- component access (dur.years, dur.minutes, ...) ------------------

    def component(self, name: str):
        n = name.lower()
        if n == "years":
            return self.months // 12
        if n == "quarters":
            return self.months // 3
        if n == "months":
            return self.months
        if n == "monthsofyear":
            return self.months % 12
        if n == "weeks":
            return self.days // 7
        if n == "days":
            return self.days
        if n == "daysofweek":
            return self.days % 7
        if n == "hours":
            return self.seconds // 3600
        if n == "minutes":
            return self.seconds // 60
        if n == "minutesofhour":
            return (self.seconds // 60) % 60
        if n == "seconds":
            return self.seconds
        if n == "secondsofminute":
            return self.seconds % 60
        if n == "milliseconds":
            return self.seconds * 1000 + self.nanos // 1_000_000
        if n == "millisecondsofsecond":
            return self.nanos // 1_000_000
        if n == "microseconds":
            return self.seconds * 1_000_000 + self.nanos // 1000
        if n == "nanoseconds":
            return self.seconds * _NANOS + self.nanos
        if n == "nanosecondsofsecond":
            return self.nanos
        return None

    # -- arithmetic ------------------------------------------------------

    def __add__(self, other):
        if isinstance(other, CypherDuration):
            return CypherDuration(self.months + other.months,
                                  self.days + other.days,
                                  self.seconds + other.seconds,
                                  self.nanos + other.nanos)
        return NotImplemented

    def __sub__(self, other):
        if isinstance(other, CypherDuration):
            return CypherDuration(self.months - other.months,
                                  self.days - other.days,
                                  self.seconds - other.seconds,
                                  self.nanos - other.nanos)
        return NotImplemented

    def __neg__(self):
        return CypherDuration(-self.months, -self.days, -self.seconds,
                              -self.nanos)

    def __mul__(self, k):
        if isinstance(k, bool) or not isinstance(k, (int, float)):
            return NotImplemented
        total_n = (self.seconds * _NANOS + self.nanos) * k
        return CypherDuration(
            months=round(self.months * k), days=round(self.days * k),
            seconds=int(total_n // _NANOS), nanos=int(total_n % _NANOS),
        )

    __rmul__ = __mul__

    def __truediv__(self, k):
        if isinstance(k, bool) or not isinstance(k, (int, float)) or k == 0:
            return NotImplemented
        return self.__mul__(1.0 / k)

    def _approx_seconds(self) -> float:
        return ((self.months * _AVG_DAYS_PER_MONTH + self.days)
                * _AVG_SECONDS_PER_DAY
                + self.seconds + self.nanos / _NANOS)

    def __eq__(self, other):
        return (isinstance(other, CypherDuration)
                and (self.months, self.days, self.seconds, self.nanos)
                == (other.months, other.days, other.seconds, other.nanos))

    def __lt__(self, other):
        if not isinstance(other, CypherDuration):
            return NotImplemented
        return self._approx_seconds() < other._approx_seconds()

    def __hash__(self):
        return hash(("dur", self.months, self.days, self.seconds, self.nanos))

    def __str__(self):
        if not any((self.months, self.days, self.seconds, self.nanos)):
            return "PT0S"
        out = "P"
        if self.months:
            y, m = divmod(self.months, 12)
            if y:
                out += f"{y}Y"
            if m:
                out += f"{m}M"
        if self.days:
            out += f"{self.days}D"
        if self.seconds or self.nanos:
            out += "T"
            secs = self.seconds
            h, secs = divmod(secs, 3600)
            m, s = divmod(secs, 60)
            if h:
                out += f"{h}H"
            if m:
                out += f"{m}M"
            if s or self.nanos:
                if self.nanos:
                    frac = f"{self.nanos / _NANOS:.9f}".rstrip("0")[1:]
                    out += f"{s}{frac}S"
                else:
                    out += f"{s}S"
        return out

    __repr__ = __str__


_DUR_RE = re.compile(
    r"^P(?:(?P<y>-?\d+(?:\.\d+)?)Y)?(?:(?P<mo>-?\d+(?:\.\d+)?)M)?"
    r"(?:(?P<w>-?\d+(?:\.\d+)?)W)?(?:(?P<d>-?\d+(?:\.\d+)?)D)?"
    r"(?:T(?:(?P<h>-?\d+(?:\.\d+)?)H)?(?:(?P<mi>-?\d+(?:\.\d+)?)M)?"
    r"(?:(?P<s>-?\d+(?:\.\d+)?)S)?)?$"
)


def parse_duration(value: Any) -> CypherDuration:
    if isinstance(value, CypherDuration):
        return value
    if isinstance(value, dict):
        months = (int(value.get("years", 0)) * 12
                  + int(value.get("quarters", 0)) * 3
                  + int(value.get("months", 0)))
        days = int(value.get("weeks", 0)) * 7 + int(value.get("days", 0))
        seconds = (int(value.get("hours", 0)) * 3600
                   + int(value.get("minutes", 0)) * 60
                   + int(value.get("seconds", 0)))
        nanos = (int(value.get("milliseconds", 0)) * 1_000_000
                 + int(value.get("microseconds", 0)) * 1000
                 + int(value.get("nanoseconds", 0)))
        return CypherDuration(months, days, seconds, nanos)
    if isinstance(value, str):
        if value.startswith("-"):
            # leading sign negates the whole duration (Neo4j accepts -P1D)
            return -parse_duration(value[1:])
        if value.startswith("+"):
            return parse_duration(value[1:])
        m = _DUR_RE.match(value)
        if not m or value == "P":
            raise CypherRuntimeError(f"invalid duration {value!r}")
        g = {k: float(v) if v else 0.0 for k, v in m.groupdict().items()}
        months = g["y"] * 12 + g["mo"]
        days = g["w"] * 7 + g["d"]
        seconds = g["h"] * 3600 + g["mi"] * 60 + g["s"]
        # fractional months/days cascade downward (Neo4j semantics)
        mi, mf = divmod(months, 1)
        days += mf * _AVG_DAYS_PER_MONTH
        di, df = divmod(days, 1)
        seconds += df * _AVG_SECONDS_PER_DAY
        si, sf = divmod(seconds, 1)
        return CypherDuration(int(mi), int(di), int(si), round(sf * _NANOS))
    raise CypherRuntimeError(
        f"duration() expects a string or map, got {type(value).__name__}"
    )


class _TemporalBase:
    """Shared component access + comparison plumbing."""

    _dt: Any  # datetime.date / datetime.time / datetime.datetime

    def component(self, name: str):
        n = name.lower()
        d = self._dt
        has_date = hasattr(d, "year") and not isinstance(d, _dt.time)
        has_time = isinstance(d, (_dt.time, _dt.datetime))
        if has_date:
            if n == "year":
                return d.year
            if n == "quarter":
                return (d.month - 1) // 3 + 1
            if n == "month":
                return d.month
            if n == "week":
                return d.isocalendar()[1]
            if n == "weekyear":
                return d.isocalendar()[0]
            if n == "day":
                return d.day
            if n in ("ordinalday", "dayofyear"):
                return d.timetuple().tm_yday
            if n == "dayofweek":
                return d.isoweekday()
            if n == "dayofquarter":
                q_start = _dt.date(d.year, 3 * ((d.month - 1) // 3) + 1, 1)
                return (_dt.date(d.year, d.month, d.day) - q_start).days + 1
        if has_time:
            if n == "hour":
                return d.hour
            if n == "minute":
                return d.minute
            if n == "second":
                return d.second
            if n == "millisecond":
                return d.microsecond // 1000
            if n == "microsecond":
                return d.microsecond
            if n == "nanosecond":
                return d.microsecond * 1000
        if isinstance(d, _dt.datetime):
            if n == "epochmillis":
                return int(self._epoch_seconds() * 1000)
            if n == "epochseconds":
                return int(self._epoch_seconds())
            if n in ("timezone", "offset"):
                off = d.utcoffset()
                if off is None:
                    return None
                total = int(off.total_seconds())
                sign = "+" if total >= 0 else "-"
                total = abs(total)
                return f"{sign}{total // 3600:02d}:{(total % 3600) // 60:02d}"
        return None

    def _epoch_seconds(self) -> float:
        d = self._dt
        if d.tzinfo is None:
            d = d.replace(tzinfo=_dt.timezone.utc)
        return d.timestamp()

    def _key(self) -> Tuple:
        raise NotImplementedError

    def __eq__(self, other):
        return type(other) is type(self) and self._key() == other._key()

    def __lt__(self, other):
        if type(other) is not type(self):
            return NotImplemented
        return self._key() < other._key()

    def __le__(self, other):
        if type(other) is not type(self):
            return NotImplemented
        return self._key() <= other._key()

    def __gt__(self, other):
        eq = self.__le__(other)
        return NotImplemented if eq is NotImplemented else not eq

    def __ge__(self, other):
        eq = self.__lt__(other)
        return NotImplemented if eq is NotImplemented else not eq

    def __hash__(self):
        return hash((type(self).__name__, self._key()))

    def __repr__(self):
        return str(self)


class CypherDate(_TemporalBase):
    __slots__ = ("_dt",)

    def __init__(self, d: _dt.date):
        self._dt = d

    def _key(self):
        return (self._dt.year, self._dt.month, self._dt.day)

    def __str__(self):
        return self._dt.isoformat()

    def __add__(self, other):
        if isinstance(other, CypherDuration):
            return CypherDate(_shift_date(self._dt, other))
        return NotImplemented

    __radd__ = __add__

    def __sub__(self, other):
        if isinstance(other, CypherDuration):
            return CypherDate(_shift_date(self._dt, -other))
        return NotImplemented


class CypherLocalTime(_TemporalBase):
    __slots__ = ("_dt",)

    def __init__(self, t: _dt.time):
        self._dt = t.replace(tzinfo=None)

    def _key(self):
        t = self._dt
        return (t.hour, t.minute, t.second, t.microsecond)

    def __str__(self):
        return self._dt.isoformat()

    def __add__(self, other):
        if isinstance(other, CypherDuration):
            return CypherLocalTime(_shift_time(self._dt, other))
        return NotImplemented

    __radd__ = __add__

    def __sub__(self, other):
        if isinstance(other, CypherDuration):
            return CypherLocalTime(_shift_time(self._dt, -other))
        return NotImplemented


class CypherTime(_TemporalBase):
    __slots__ = ("_dt",)

    def __init__(self, t: _dt.time):
        if t.tzinfo is None:
            t = t.replace(tzinfo=_dt.timezone.utc)
        self._dt = t

    def _key(self):
        t = self._dt
        off = t.utcoffset() or _dt.timedelta(0)
        base = (t.hour * 3600 + t.minute * 60 + t.second
                - int(off.total_seconds()))
        return (base, t.microsecond)

    def __str__(self):
        return self._dt.isoformat()

    def __add__(self, other):
        if isinstance(other, CypherDuration):
            tz = self._dt.tzinfo
            return CypherTime(_shift_time(self._dt.replace(tzinfo=None),
                                          other).replace(tzinfo=tz))
        return NotImplemented

    __radd__ = __add__

    def __sub__(self, other):
        if isinstance(other, CypherDuration):
            return self.__add__(-other)
        return NotImplemented


class CypherLocalDateTime(_TemporalBase):
    __slots__ = ("_dt",)

    def __init__(self, d: _dt.datetime):
        self._dt = d.replace(tzinfo=None)

    def _key(self):
        d = self._dt
        return (d.year, d.month, d.day, d.hour, d.minute, d.second,
                d.microsecond)

    def __str__(self):
        return self._dt.isoformat()

    def __add__(self, other):
        if isinstance(other, CypherDuration):
            return CypherLocalDateTime(_shift_datetime(self._dt, other))
        return NotImplemented

    __radd__ = __add__

    def __sub__(self, other):
        if isinstance(other, CypherDuration):
            return CypherLocalDateTime(_shift_datetime(self._dt, -other))
        return NotImplemented


class CypherDateTime(_TemporalBase):
    __slots__ = ("_dt",)

    def __init__(self, d: _dt.datetime):
        if d.tzinfo is None:
            d = d.replace(tzinfo=_dt.timezone.utc)
        self._dt = d

    def _key(self):
        return (self._epoch_seconds(), self._dt.microsecond % 1000)

    def __str__(self):
        return self._dt.isoformat()

    def __add__(self, other):
        if isinstance(other, CypherDuration):
            tz = self._dt.tzinfo
            naive = _shift_datetime(self._dt.replace(tzinfo=None), other)
            return CypherDateTime(naive.replace(tzinfo=tz))
        return NotImplemented

    __radd__ = __add__

    def __sub__(self, other):
        if isinstance(other, CypherDuration):
            return self.__add__(-other)
        return NotImplemented


def _shift_date(d: _dt.date, dur: CypherDuration) -> _dt.date:
    if dur.months:
        total = d.year * 12 + (d.month - 1) + dur.months
        y, m = divmod(total, 12)
        day = min(d.day, _days_in_month(y, m + 1))
        d = _dt.date(y, m + 1, day)
    if dur.days or dur.seconds or dur.nanos:
        d = d + _dt.timedelta(days=dur.days,
                              seconds=dur.seconds + dur.nanos / _NANOS)
        if isinstance(d, _dt.datetime):
            d = d.date()
    return d


def _shift_time(t: _dt.time, dur: CypherDuration) -> _dt.time:
    total_us = (t.hour * 3600 + t.minute * 60 + t.second) * 1_000_000 + t.microsecond
    total_us += dur.seconds * 1_000_000 + dur.nanos // 1000
    total_us %= 24 * 3600 * 1_000_000
    s, us = divmod(total_us, 1_000_000)
    h, s2 = divmod(s, 3600)
    m, s3 = divmod(s2, 60)
    return _dt.time(int(h), int(m), int(s3), int(us))


def _shift_datetime(d: _dt.datetime, dur: CypherDuration) -> _dt.datetime:
    if dur.months:
        total = d.year * 12 + (d.month - 1) + dur.months
        y, m = divmod(total, 12)
        day = min(d.day, _days_in_month(y, m + 1))
        d = d.replace(year=y, month=m + 1, day=day)
    return d + _dt.timedelta(days=dur.days,
                             seconds=dur.seconds,
                             microseconds=dur.nanos // 1000)


def _days_in_month(y: int, m: int) -> int:
    if m == 12:
        return 31
    return (_dt.date(y, m + 1, 1) - _dt.timedelta(days=1)).day


# -- constructors ---------------------------------------------------------


_TZ_RE = re.compile(r"(Z|[+-]\d{2}:?\d{2})$")


def _parse_tz(name_or_offset: Any) -> _dt.tzinfo:
    if isinstance(name_or_offset, str):
        s = name_or_offset
        if s in ("Z", "z", "UTC", "utc"):
            return _dt.timezone.utc
        m = re.match(r"^([+-])(\d{2}):?(\d{2})?$", s)
        if m:
            sign = 1 if m.group(1) == "+" else -1
            mins = int(m.group(2)) * 60 + int(m.group(3) or 0)
            return _dt.timezone(sign * _dt.timedelta(minutes=mins))
        try:
            import zoneinfo

            return zoneinfo.ZoneInfo(s)
        except Exception:
            raise CypherRuntimeError(f"unknown timezone {s!r}")
    raise CypherRuntimeError("timezone must be a string")


def make_date(value: Any = None) -> Optional[CypherDate]:
    if value is None:
        return CypherDate(_dt.datetime.now(_dt.timezone.utc).date())
    if isinstance(value, CypherDate):
        return value
    if isinstance(value, (CypherDateTime, CypherLocalDateTime)):
        return CypherDate(value._dt.date())
    if isinstance(value, str):
        try:
            return CypherDate(_dt.date.fromisoformat(_normalize_date_str(value)))
        except ValueError:
            raise CypherRuntimeError(f"invalid date {value!r}")
    if isinstance(value, dict):
        try:
            return CypherDate(_dt.date(int(value.get("year", 0)),
                                       int(value.get("month", 1)),
                                       int(value.get("day", 1))))
        except ValueError as e:
            raise CypherRuntimeError(f"invalid date components: {e}")
    raise CypherRuntimeError("date() expects a string or map")


def _normalize_date_str(s: str) -> str:
    # Neo4j accepts 20260101 and 2026-01-01
    if re.fullmatch(r"\d{8}", s):
        return f"{s[:4]}-{s[4:6]}-{s[6:]}"
    return s


def _normalize_iso(s: str) -> str:
    """Rewrite ISO-8601 variants pre-3.11 ``fromisoformat`` rejects.

    Python 3.10's C parser wants exactly 3 or 6 fractional digits, a
    ``+HH:MM`` offset with the colon, and no ``Z`` suffix. Neo4j (and
    wire payloads) emit ``Z``, nanosecond fractions, and colon-less
    offsets — normalize those to the strict form before retrying.
    """
    s = s.strip()
    if s and s[-1] in "zZ":
        s = s[:-1] + "+00:00"
    tz = ""
    m = re.search(r"([+-]\d{2}):?(\d{2})$", s)
    if m:
        tz = f"{m.group(1)}:{m.group(2)}"
        s = s[: m.start()]
    fm = re.search(r"\.(\d+)$", s)
    if fm:
        s = s[: fm.start()] + "." + (fm.group(1) + "000000")[:6]
    return s + tz


def _iso_time(s: str) -> _dt.time:
    try:
        return _dt.time.fromisoformat(s)
    except ValueError:
        return _dt.time.fromisoformat(_normalize_iso(s))


def _iso_datetime(s: str) -> _dt.datetime:
    try:
        return _dt.datetime.fromisoformat(s)
    except ValueError:
        return _dt.datetime.fromisoformat(_normalize_iso(s))


def make_localtime(value: Any = None) -> Optional[CypherLocalTime]:
    if value is None:
        return CypherLocalTime(_dt.datetime.now().time())
    if isinstance(value, CypherLocalTime):
        return value
    if isinstance(value, CypherTime):
        return CypherLocalTime(value._dt.replace(tzinfo=None))
    if isinstance(value, (CypherDateTime, CypherLocalDateTime)):
        return CypherLocalTime(value._dt.time())
    if isinstance(value, str):
        try:
            return CypherLocalTime(_iso_time(value))
        except ValueError:
            raise CypherRuntimeError(f"invalid localtime {value!r}")
    if isinstance(value, dict):
        return CypherLocalTime(_time_from_map(value))
    raise CypherRuntimeError("localtime() expects a string or map")


def _time_from_map(m: Dict[str, Any]) -> _dt.time:
    us = (int(m.get("millisecond", 0)) * 1000
          + int(m.get("microsecond", 0))
          + int(m.get("nanosecond", 0)) // 1000)
    try:
        return _dt.time(int(m.get("hour", 0)), int(m.get("minute", 0)),
                        int(m.get("second", 0)), us)
    except ValueError as e:
        raise CypherRuntimeError(f"invalid time components: {e}")


def make_time(value: Any = None) -> Optional[CypherTime]:
    if value is None:
        return CypherTime(_dt.datetime.now(_dt.timezone.utc).timetz())
    if isinstance(value, CypherTime):
        return value
    if isinstance(value, CypherLocalTime):
        return CypherTime(value._dt.replace(tzinfo=_dt.timezone.utc))
    if isinstance(value, CypherDateTime):
        return CypherTime(value._dt.timetz())
    if isinstance(value, CypherLocalDateTime):
        return CypherTime(value._dt.time().replace(tzinfo=_dt.timezone.utc))
    if isinstance(value, str):
        try:
            return CypherTime(_iso_time(value.replace("Z", "+00:00")))
        except ValueError:
            raise CypherRuntimeError(f"invalid time {value!r}")
    if isinstance(value, dict):
        t = _time_from_map(value)
        tz = value.get("timezone")
        return CypherTime(t.replace(
            tzinfo=_parse_tz(tz) if tz else _dt.timezone.utc))
    raise CypherRuntimeError("time() expects a string or map")


def make_localdatetime(value: Any = None) -> Optional[CypherLocalDateTime]:
    if value is None:
        return CypherLocalDateTime(_dt.datetime.now())
    if isinstance(value, CypherLocalDateTime):
        return value
    if isinstance(value, CypherDateTime):
        return CypherLocalDateTime(value._dt.replace(tzinfo=None))
    if isinstance(value, CypherDate):
        return CypherLocalDateTime(
            _dt.datetime.combine(value._dt, _dt.time()))
    if isinstance(value, str):
        try:
            return CypherLocalDateTime(_iso_datetime(value))
        except ValueError:
            raise CypherRuntimeError(f"invalid localdatetime {value!r}")
    if isinstance(value, dict):
        return CypherLocalDateTime(_datetime_from_map(value))
    raise CypherRuntimeError("localdatetime() expects a string or map")


def _datetime_from_map(m: Dict[str, Any]) -> _dt.datetime:
    us = (int(m.get("millisecond", 0)) * 1000
          + int(m.get("microsecond", 0))
          + int(m.get("nanosecond", 0)) // 1000)
    try:
        return _dt.datetime(int(m.get("year", 0)), int(m.get("month", 1)),
                            int(m.get("day", 1)), int(m.get("hour", 0)),
                            int(m.get("minute", 0)), int(m.get("second", 0)),
                            us)
    except ValueError as e:
        raise CypherRuntimeError(f"invalid datetime components: {e}")


def make_datetime(value: Any = None) -> Optional[CypherDateTime]:
    if value is None:
        return CypherDateTime(_dt.datetime.now(_dt.timezone.utc))
    if isinstance(value, CypherDateTime):
        return value
    if isinstance(value, CypherLocalDateTime):
        return CypherDateTime(value._dt.replace(tzinfo=_dt.timezone.utc))
    if isinstance(value, CypherDate):
        return CypherDateTime(_dt.datetime.combine(
            value._dt, _dt.time(), tzinfo=_dt.timezone.utc))
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        # epoch millis convenience (Neo4j: datetime({epochMillis: v}))
        return CypherDateTime(_dt.datetime.fromtimestamp(
            value / 1000.0, tz=_dt.timezone.utc))
    if isinstance(value, str):
        try:
            return CypherDateTime(
                _iso_datetime(value.replace("Z", "+00:00")))
        except ValueError:
            raise CypherRuntimeError(f"invalid datetime {value!r}")
    if isinstance(value, dict):
        if "epochmillis" in {k.lower() for k in value}:
            millis = next(v for k, v in value.items()
                          if k.lower() == "epochmillis")
            return CypherDateTime(_dt.datetime.fromtimestamp(
                millis / 1000.0, tz=_dt.timezone.utc))
        if "epochseconds" in {k.lower() for k in value}:
            secs = next(v for k, v in value.items()
                        if k.lower() == "epochseconds")
            return CypherDateTime(_dt.datetime.fromtimestamp(
                secs, tz=_dt.timezone.utc))
        d = _datetime_from_map(value)
        tz = value.get("timezone")
        return CypherDateTime(d.replace(
            tzinfo=_parse_tz(tz) if tz else _dt.timezone.utc))
    raise CypherRuntimeError("datetime() expects a string, map, or millis")


# -- truncate -------------------------------------------------------------

_TRUNC_ORDER = ["year", "quarter", "month", "week", "day", "hour", "minute",
                "second", "millisecond", "microsecond"]


def truncate(unit: str, value: Any, kind: str):
    """date.truncate / datetime.truncate / localdatetime.truncate."""
    unit = unit.lower()
    if unit not in _TRUNC_ORDER:
        raise CypherRuntimeError(f"unknown truncation unit {unit!r}")
    if isinstance(value, CypherDate):
        src = _dt.datetime.combine(value._dt, _dt.time())
        tz = None
    elif isinstance(value, (CypherDateTime, CypherLocalDateTime)):
        src = value._dt
        tz = getattr(src, "tzinfo", None)
    elif isinstance(value, (CypherTime, CypherLocalTime)):
        t = value._dt
        src = _dt.datetime(1970, 1, 1, t.hour, t.minute, t.second,
                           t.microsecond)
        tz = getattr(t, "tzinfo", None)
    else:
        raise CypherRuntimeError("truncate expects a temporal value")
    d = src
    if unit == "year":
        d = d.replace(month=1, day=1, hour=0, minute=0, second=0, microsecond=0)
    elif unit == "quarter":
        q_month = 3 * ((d.month - 1) // 3) + 1
        d = d.replace(month=q_month, day=1, hour=0, minute=0, second=0,
                      microsecond=0)
    elif unit == "month":
        d = d.replace(day=1, hour=0, minute=0, second=0, microsecond=0)
    elif unit == "week":
        d = (d - _dt.timedelta(days=d.isoweekday() - 1)).replace(
            hour=0, minute=0, second=0, microsecond=0)
    elif unit == "day":
        d = d.replace(hour=0, minute=0, second=0, microsecond=0)
    elif unit == "hour":
        d = d.replace(minute=0, second=0, microsecond=0)
    elif unit == "minute":
        d = d.replace(second=0, microsecond=0)
    elif unit == "second":
        d = d.replace(microsecond=0)
    elif unit == "millisecond":
        d = d.replace(microsecond=(d.microsecond // 1000) * 1000)
    if kind == "date":
        return CypherDate(d.date())
    if kind == "datetime":
        return CypherDateTime(d if d.tzinfo else d.replace(
            tzinfo=_dt.timezone.utc))
    if kind == "time":
        return CypherTime(_dt.time(d.hour, d.minute, d.second,
                                   d.microsecond,
                                   tzinfo=tz or _dt.timezone.utc))
    if kind == "localtime":
        return CypherLocalTime(_dt.time(d.hour, d.minute, d.second,
                                        d.microsecond))
    return CypherLocalDateTime(d.replace(tzinfo=None))


# -- duration.between family ---------------------------------------------


def _as_datetime(v: Any) -> _dt.datetime:
    if isinstance(v, CypherDate):
        return _dt.datetime.combine(v._dt, _dt.time())
    if isinstance(v, (CypherDateTime, CypherLocalDateTime)):
        return v._dt.replace(tzinfo=None)
    if isinstance(v, (CypherTime, CypherLocalTime)):
        t = v._dt
        return _dt.datetime(1970, 1, 1, t.hour, t.minute, t.second,
                            t.microsecond)
    raise CypherRuntimeError("expected a temporal value")


def duration_between(a: Any, b: Any) -> CypherDuration:
    """Calendar-aware difference (duration.between)."""
    da, db = _as_datetime(a), _as_datetime(b)
    sign = 1
    if db < da:
        da, db = db, da
        sign = -1
    months = (db.year - da.year) * 12 + (db.month - da.month)
    anchor = _shift_datetime(da, CypherDuration(months=months))
    if anchor > db:
        months -= 1
        anchor = _shift_datetime(da, CypherDuration(months=months))
    delta = db - anchor
    days = delta.days
    seconds = delta.seconds
    nanos = delta.microseconds * 1000
    d = CypherDuration(months, days, seconds, nanos)
    return -d if sign < 0 else d


def duration_in_months(a: Any, b: Any) -> CypherDuration:
    d = duration_between(a, b)
    return CypherDuration(months=d.months)


def duration_in_days(a: Any, b: Any) -> CypherDuration:
    da, db = _as_datetime(a), _as_datetime(b)
    delta = db - da
    total_s = delta.days * 86400 + delta.seconds
    return CypherDuration(days=int(total_s / 86400))  # truncate toward zero


def duration_in_seconds(a: Any, b: Any) -> CypherDuration:
    da, db = _as_datetime(a), _as_datetime(b)
    delta = db - da
    # exact integer microseconds; timedelta's days carries the sign while
    # seconds/microseconds are positive floor remainders — summing keeps
    # the exact (possibly negative) instant
    total_us = ((delta.days * 86400 + delta.seconds) * 1_000_000
                + delta.microseconds)
    return CypherDuration(seconds=total_us // 1_000_000,
                          nanos=(total_us % 1_000_000) * 1000)


# -- spatial --------------------------------------------------------------


class CypherPoint:
    """2D/3D point, cartesian or WGS-84 (reference: spatial functions)."""

    __slots__ = ("x", "y", "z", "crs")

    def __init__(self, x: float, y: float, z: Optional[float] = None,
                 crs: str = "cartesian"):
        self.x = float(x)
        self.y = float(y)
        self.z = None if z is None else float(z)
        self.crs = crs

    @property
    def longitude(self):
        return self.x if self.crs.startswith("wgs-84") else None

    @property
    def latitude(self):
        return self.y if self.crs.startswith("wgs-84") else None

    def component(self, name: str):
        n = name.lower()
        if n == "x":
            return self.x
        if n == "y":
            return self.y
        if n == "z":
            return self.z
        if n == "crs":
            return self.crs
        if n == "srid":
            return {"cartesian": 7203, "cartesian-3d": 9157,
                    "wgs-84": 4326, "wgs-84-3d": 4979}.get(self.crs)
        if n == "longitude":
            return self.longitude
        if n == "latitude":
            return self.latitude
        if n == "height":
            return self.z if self.crs == "wgs-84-3d" else None
        return None

    def __eq__(self, other):
        return (isinstance(other, CypherPoint)
                and (self.x, self.y, self.z, self.crs)
                == (other.x, other.y, other.z, other.crs))

    def __hash__(self):
        return hash(("point", self.x, self.y, self.z, self.crs))

    def __str__(self):
        if self.z is not None:
            return f"point({{x: {self.x}, y: {self.y}, z: {self.z}, crs: '{self.crs}'}})"
        return f"point({{x: {self.x}, y: {self.y}, crs: '{self.crs}'}})"

    __repr__ = __str__


def make_point(m: Any) -> Optional[CypherPoint]:
    if m is None:
        return None
    if isinstance(m, CypherPoint):
        return m
    if not isinstance(m, dict):
        raise CypherRuntimeError("point() expects a map")
    low = {k.lower(): v for k, v in m.items()}
    if "latitude" in low and "longitude" in low:
        z = low.get("height")
        crs = "wgs-84-3d" if z is not None else "wgs-84"
        return CypherPoint(low["longitude"], low["latitude"], z, crs)
    if "x" in low and "y" in low:
        z = low.get("z")
        crs = low.get("crs") or ("cartesian-3d" if z is not None else "cartesian")
        return CypherPoint(low["x"], low["y"], z, crs)
    raise CypherRuntimeError("point() requires x/y or latitude/longitude")


_EARTH_RADIUS_M = 6_378_140.0


def point_distance(a: Any, b: Any) -> Optional[float]:
    if a is None or b is None:
        return None
    if not isinstance(a, CypherPoint) or not isinstance(b, CypherPoint):
        raise CypherRuntimeError("distance() expects two points")
    if a.crs != b.crs:
        return None  # Neo4j: distance across CRS is null
    if a.crs.startswith("wgs-84"):
        # haversine on the sphere (+ altitude delta for 3d)
        la1, lo1 = math.radians(a.latitude), math.radians(a.longitude)
        la2, lo2 = math.radians(b.latitude), math.radians(b.longitude)
        h = (math.sin((la2 - la1) / 2) ** 2
             + math.cos(la1) * math.cos(la2) * math.sin((lo2 - lo1) / 2) ** 2)
        ground = 2 * _EARTH_RADIUS_M * math.asin(math.sqrt(h))
        if a.crs == "wgs-84-3d":
            dz = (a.z or 0.0) - (b.z or 0.0)
            return math.sqrt(ground * ground + dz * dz)
        return ground
    dz = ((a.z or 0.0) - (b.z or 0.0)) if (a.z is not None or b.z is not None) else 0.0
    return math.sqrt((a.x - b.x) ** 2 + (a.y - b.y) ** 2 + dz * dz)


TEMPORAL_TYPES = (CypherDate, CypherTime, CypherLocalTime, CypherDateTime,
                  CypherLocalDateTime)


# -- storage / wire codec -------------------------------------------------
#
# Temporal, duration, and point values stored as node/edge properties must
# survive msgpack (WAL, native KV) and JSON (cluster transport) encoding.
# They serialize as tagged maps and decode back to value objects, so a
# restart or a replica apply reconstructs the same typed value
# (reference: Neo4j persists temporals natively in its record format).

_TAG = "__nornic_value__"

_KIND_MAKERS = {
    "date": lambda s: make_date(s),
    "datetime": lambda s: make_datetime(s),
    "localdatetime": lambda s: make_localdatetime(s),
    "time": lambda s: make_time(s),
    "localtime": lambda s: make_localtime(s),
}


def encode_value(v: Any):
    """msgpack `default=` / json `default=` hook for typed values."""
    if isinstance(v, CypherDate):
        return {_TAG: "date", "v": str(v)}
    if isinstance(v, CypherDateTime):
        return {_TAG: "datetime", "v": str(v)}
    if isinstance(v, CypherLocalDateTime):
        return {_TAG: "localdatetime", "v": str(v)}
    if isinstance(v, CypherTime):
        return {_TAG: "time", "v": str(v)}
    if isinstance(v, CypherLocalTime):
        return {_TAG: "localtime", "v": str(v)}
    if isinstance(v, CypherDuration):
        return {_TAG: "duration", "m": v.months, "d": v.days,
                "s": v.seconds, "n": v.nanos}
    if isinstance(v, CypherPoint):
        return {_TAG: "point", "x": v.x, "y": v.y, "z": v.z, "crs": v.crs}
    raise TypeError(f"can not serialize {type(v).__name__}")


def decode_map(m: Dict[str, Any]):
    """msgpack `object_hook`: revive a tagged map, else return it as-is.

    `__nornic_value__` is a reserved property-map key. Decoding is
    strict-schema: a map carrying the tag but not matching the codec's
    exact shape is returned unchanged (never crashes replay), so an
    unlucky user map can only collide by reproducing the full schema.
    """
    kind = m.get(_TAG) if isinstance(m, dict) else None
    if kind is None:
        return m
    try:
        if kind == "duration" and set(m) == {_TAG, "m", "d", "s", "n"}:
            return CypherDuration(m["m"], m["d"], m["s"], m["n"])
        if kind == "point" and set(m) == {_TAG, "x", "y", "z", "crs"}:
            return CypherPoint(m["x"], m["y"], m.get("z"),
                               m.get("crs", "cartesian"))
        maker = _KIND_MAKERS.get(kind)
        if maker is not None and set(m) == {_TAG, "v"} and isinstance(
            m["v"], str
        ):
            return maker(m["v"])
    except (KeyError, TypeError, ValueError, CypherRuntimeError):
        return m
    return m


def decode_tree(obj: Any):
    """Recursively revive tagged maps in a parsed-JSON tree (cluster
    transport path, where no object_hook ran)."""
    if isinstance(obj, dict):
        decoded = {k: decode_tree(v) for k, v in obj.items()}
        return decode_map(decoded)
    if isinstance(obj, list):
        return [decode_tree(x) for x in obj]
    return obj
