"""PackStream v2 codec — the Bolt wire serialization (counterpart of
``nornicdb_tpu/api/packstream.py``; the same bytes for every value).

Implements the full marker space:
null/bool/ints (tiny, 8/16/32/64), float64, bytes, strings, lists, maps,
and structures (Node 'N', Relationship 'R', UnboundRelationship 'r',
Path 'P') as served to official Neo4j drivers.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

from nornicdb_tpu_torch.storage.types import Edge, Node

# structure tags (Bolt 4.x)
SIG_NODE = 0x4E          # 'N'
SIG_RELATIONSHIP = 0x52  # 'R'
SIG_UNBOUND_REL = 0x72   # 'r'
SIG_PATH = 0x50          # 'P'


class PackStreamError(ValueError):
    pass


class Structure:
    """Generic PackStream structure (tag + fields)."""

    __slots__ = ("tag", "fields")

    def __init__(self, tag: int, fields: List[Any]):
        self.tag = tag
        self.fields = fields

    def __eq__(self, other):
        return (isinstance(other, Structure) and other.tag == self.tag
                and other.fields == self.fields)

    def __repr__(self):
        return f"Structure(0x{self.tag:02X}, {self.fields!r})"


def node_id_to_int(node_id: str) -> int:
    """Stable numeric surrogate for string IDs (Bolt node ids are ints).
    53-bit so it survives float64 round-trips in loose clients."""
    import hashlib

    h = hashlib.sha1(node_id.encode()).digest()
    return int.from_bytes(h[:7], "big") & ((1 << 53) - 1)


def node_structure(n: Node) -> Structure:
    props = dict(n.properties)
    props.setdefault("_id", n.id)  # expose the real string id
    return Structure(SIG_NODE, [node_id_to_int(n.id), list(n.labels), props])


def relationship_structure(e: Edge) -> Structure:
    props = dict(e.properties)
    props.setdefault("_id", e.id)
    return Structure(SIG_RELATIONSHIP, [
        node_id_to_int(e.id), node_id_to_int(e.start_node),
        node_id_to_int(e.end_node), e.type, props,
    ])


def to_packable(value: Any) -> Any:
    """Convert framework values (Node/Edge/paths) into packable form."""
    if isinstance(value, Node):
        return node_structure(value)
    if isinstance(value, Edge):
        return relationship_structure(value)
    if isinstance(value, dict):
        return {k: to_packable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [to_packable(v) for v in value]
    return value


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


class Packer:
    def __init__(self) -> None:
        self._buf = bytearray()

    def data(self) -> bytes:
        return bytes(self._buf)

    def pack(self, value: Any) -> "Packer":
        b = self._buf
        if value is None:
            b.append(0xC0)
        elif value is True:
            b.append(0xC3)
        elif value is False:
            b.append(0xC2)
        elif isinstance(value, int):
            self._pack_int(value)
        elif isinstance(value, float):
            b.append(0xC1)
            b += struct.pack(">d", value)
        elif isinstance(value, str):
            self._pack_str(value)
        elif isinstance(value, (bytes, bytearray)):
            self._pack_bytes(bytes(value))
        elif isinstance(value, (list, tuple)):
            self._pack_list_header(len(value))
            for v in value:
                self.pack(v)
        elif isinstance(value, dict):
            self._pack_map_header(len(value))
            for k, v in value.items():
                self._pack_str(str(k))
                self.pack(v)
        elif isinstance(value, Structure):
            n = len(value.fields)
            if n > 15:
                raise PackStreamError("structure too large")
            b.append(0xB0 + n)
            b.append(value.tag)
            for f in value.fields:
                self.pack(f)
        elif isinstance(value, Node):
            self.pack(node_structure(value))
        elif isinstance(value, Edge):
            self.pack(relationship_structure(value))
        elif (ts := _temporal_structure(value)) is not None:
            self.pack(ts)
        else:
            # numpy scalars, and torch tensors as the values they hold
            import numpy as np
            import torch

            if isinstance(value, np.integer):
                self._pack_int(int(value))
                return self
            if isinstance(value, np.floating):
                b.append(0xC1)
                b += struct.pack(">d", float(value))
                return self
            if isinstance(value, torch.Tensor):
                return self.pack(value.tolist())
            raise PackStreamError(f"cannot pack {type(value).__name__}")
        return self

    def _pack_int(self, v: int) -> None:
        b = self._buf
        if -16 <= v < 128:
            b += struct.pack(">b", v)
        elif -128 <= v < 128:
            b.append(0xC8)
            b += struct.pack(">b", v)
        elif -32768 <= v < 32768:
            b.append(0xC9)
            b += struct.pack(">h", v)
        elif -2147483648 <= v < 2147483648:
            b.append(0xCA)
            b += struct.pack(">i", v)
        elif -(1 << 63) <= v < (1 << 63):
            b.append(0xCB)
            b += struct.pack(">q", v)
        else:
            raise PackStreamError("integer out of 64-bit range")

    def _pack_str(self, s: str) -> None:
        data = s.encode("utf-8")
        n = len(data)
        b = self._buf
        if n < 16:
            b.append(0x80 + n)
        elif n < 256:
            b += bytes((0xD0, n))
        elif n < 65536:
            b.append(0xD1)
            b += struct.pack(">H", n)
        else:
            b.append(0xD2)
            b += struct.pack(">I", n)
        b += data

    def _pack_bytes(self, data: bytes) -> None:
        n = len(data)
        b = self._buf
        if n < 256:
            b += bytes((0xCC, n))
        elif n < 65536:
            b.append(0xCD)
            b += struct.pack(">H", n)
        else:
            b.append(0xCE)
            b += struct.pack(">I", n)
        b += data

    def _pack_list_header(self, n: int) -> None:
        b = self._buf
        if n < 16:
            b.append(0x90 + n)
        elif n < 256:
            b += bytes((0xD4, n))
        elif n < 65536:
            b.append(0xD5)
            b += struct.pack(">H", n)
        else:
            b.append(0xD6)
            b += struct.pack(">I", n)

    def _pack_map_header(self, n: int) -> None:
        b = self._buf
        if n < 16:
            b.append(0xA0 + n)
        elif n < 256:
            b += bytes((0xD8, n))
        elif n < 65536:
            b.append(0xD9)
            b += struct.pack(">H", n)
        else:
            b.append(0xDA)
            b += struct.pack(">I", n)


import datetime as _dt

from nornicdb_tpu_torch.query import temporal_types as T


def _temporal_structure(value: Any) -> Any:
    """Bolt structures for temporal/spatial values (Bolt 4.x tags:
    Date 'D', Time 'T', LocalTime 't', DateTime 'F', LocalDateTime 'd',
    Duration 'E', Point2D 'X', Point3D 'Y') so official drivers decode
    them natively."""
    if isinstance(value, T.CypherDate):
        days = (value._dt - _dt.date(1970, 1, 1)).days
        return Structure(0x44, [days])
    if isinstance(value, T.CypherLocalTime):
        t = value._dt
        nanos = ((t.hour * 3600 + t.minute * 60 + t.second) * 1_000_000
                 + t.microsecond) * 1000
        return Structure(0x74, [nanos])
    if isinstance(value, T.CypherTime):
        t = value._dt
        nanos = ((t.hour * 3600 + t.minute * 60 + t.second) * 1_000_000
                 + t.microsecond) * 1000
        off = int((t.utcoffset() or _dt.timedelta(0)).total_seconds())
        return Structure(0x54, [nanos, off])
    if isinstance(value, T.CypherLocalDateTime):
        d = value._dt
        epoch = _dt.datetime(1970, 1, 1)
        delta = d - epoch
        secs = delta.days * 86400 + delta.seconds
        return Structure(0x64, [secs, delta.microseconds * 1000])
    if isinstance(value, T.CypherDateTime):
        d = value._dt
        off = int((d.utcoffset() or _dt.timedelta(0)).total_seconds())
        naive = d.replace(tzinfo=None)
        delta = naive - _dt.datetime(1970, 1, 1)
        # legacy 'F' (pre-utc-patch Bolt 4.x): seconds field is the LOCAL
        # wall-clock time interpreted against the unix epoch, offset
        # carried separately
        wall_secs = delta.days * 86400 + delta.seconds
        return Structure(0x46, [wall_secs, delta.microseconds * 1000, off])
    if isinstance(value, T.CypherDuration):
        return Structure(0x45, [value.months, value.days, value.seconds,
                                value.nanos])
    if isinstance(value, T.CypherPoint):
        srid = value.component("srid") or 7203
        if value.z is not None:
            return Structure(0x59, [srid, value.x, value.y, value.z])
        return Structure(0x58, [srid, value.x, value.y])
    return None


def pack(*values: Any) -> bytes:
    p = Packer()
    for v in values:
        p.pack(v)
    return p.data()


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


class Unpacker:
    def __init__(self, data: bytes):
        self._data = data
        self._pos = 0

    def _take(self, n: int) -> bytes:
        if self._pos + n > len(self._data):
            raise PackStreamError("truncated packstream data")
        out = self._data[self._pos:self._pos + n]
        self._pos += n
        return out

    def at_end(self) -> bool:
        return self._pos >= len(self._data)

    def unpack(self) -> Any:
        marker = self._take(1)[0]
        # tiny int
        if marker < 0x80:
            return marker
        if marker >= 0xF0:
            return marker - 0x100
        # tiny string / list / map / struct
        if 0x80 <= marker <= 0x8F:
            return self._take(marker - 0x80).decode("utf-8")
        if 0x90 <= marker <= 0x9F:
            return [self.unpack() for _ in range(marker - 0x90)]
        if 0xA0 <= marker <= 0xAF:
            return self._unpack_map(marker - 0xA0)
        if 0xB0 <= marker <= 0xBF:
            n = marker - 0xB0
            tag = self._take(1)[0]
            return Structure(tag, [self.unpack() for _ in range(n)])
        handlers = {
            0xC0: lambda: None,
            0xC1: lambda: struct.unpack(">d", self._take(8))[0],
            0xC2: lambda: False,
            0xC3: lambda: True,
            0xC8: lambda: struct.unpack(">b", self._take(1))[0],
            0xC9: lambda: struct.unpack(">h", self._take(2))[0],
            0xCA: lambda: struct.unpack(">i", self._take(4))[0],
            0xCB: lambda: struct.unpack(">q", self._take(8))[0],
            0xCC: lambda: self._take(self._take(1)[0]),
            0xCD: lambda: self._take(struct.unpack(">H", self._take(2))[0]),
            0xCE: lambda: self._take(struct.unpack(">I", self._take(4))[0]),
            0xD0: lambda: self._take(self._take(1)[0]).decode("utf-8"),
            0xD1: lambda: self._take(struct.unpack(">H", self._take(2))[0]).decode("utf-8"),
            0xD2: lambda: self._take(struct.unpack(">I", self._take(4))[0]).decode("utf-8"),
            0xD4: lambda: [self.unpack() for _ in range(self._take(1)[0])],
            0xD5: lambda: [self.unpack() for _ in range(struct.unpack(">H", self._take(2))[0])],
            0xD6: lambda: [self.unpack() for _ in range(struct.unpack(">I", self._take(4))[0])],
            0xD8: lambda: self._unpack_map(self._take(1)[0]),
            0xD9: lambda: self._unpack_map(struct.unpack(">H", self._take(2))[0]),
            0xDA: lambda: self._unpack_map(struct.unpack(">I", self._take(4))[0]),
        }
        h = handlers.get(marker)
        if h is None:
            raise PackStreamError(f"unknown marker 0x{marker:02X}")
        return h()

    def _unpack_map(self, n: int) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for _ in range(n):
            k = self.unpack()
            out[k] = self.unpack()
        return out


def unpack(data: bytes) -> Any:
    return Unpacker(data).unpack()


def unpack_all(data: bytes) -> List[Any]:
    u = Unpacker(data)
    out = []
    while not u.at_end():
        out.append(u.unpack())
    return out
