"""The record codec: the subset of msgpack that the reference's records
use, byte for byte as ``msgpack.packb(obj, use_bin_type=True)`` writes it
and as ``msgpack.unpackb(b, raw=False, strict_map_key=False)`` reads it,
so the port and the reference open each other's data dirs.

The subset is nil, bool, int (every width, both signs), float64 (float32
is read too), str, bin, array and map. A list of floats, such as a
node's embedding, is packed and unpacked with one ``struct`` call over
the whole run instead of one Python step per value.

Typed property values (temporal, duration and point values of
``query/temporal_types.py``) pack as the reference's tagged maps
(``encode_value``, its msgpack ``default=`` hook), and a map of exactly
such a shape is revived on unpack (``decode_map``, its ``object_hook``);
any other map comes back unchanged. Anything else that is not a plain
type raises ``TypeError``, as the reference's ``encode_value`` does.
"""

from __future__ import annotations

import struct
from typing import Any, Callable, Dict

__all__ = ["pack", "unpack"]


def _typed_default(v: Any) -> Dict[str, Any]:
    # the query package loads on a record's first typed value, not when
    # storage is imported, as in the reference's WAL hooks
    from nornicdb_tpu_torch.query.temporal_types import encode_value

    return encode_value(v)


def _typed_hook(m: dict) -> Any:
    from nornicdb_tpu_torch.query.temporal_types import decode_map

    return decode_map(m)

_B = struct.Struct(">B")
_BB = struct.Struct(">BB")
_BH = struct.Struct(">BH")
_BI = struct.Struct(">BI")
_Bb = struct.Struct(">Bb")
_Bh = struct.Struct(">Bh")
_Bi = struct.Struct(">Bi")
_Bq = struct.Struct(">Bq")
_BQ = struct.Struct(">BQ")
_Bd = struct.Struct(">Bd")
_H = struct.Struct(">H")
_I = struct.Struct(">I")
_F64 = 0xCB

# one Struct per float-run length: ">" + "xd" * n packs n doubles, each
# behind a pad byte that is then overwritten with the float64 marker
_RUNS: Dict[int, struct.Struct] = {}


def _run(n: int) -> struct.Struct:
    s = _RUNS.get(n)
    if s is None:
        s = struct.Struct(">" + "xd" * n)
        if len(_RUNS) < 4096:
            _RUNS[n] = s
    return s


# -- pack -------------------------------------------------------------------


def _pack_int(x: int, out: bytearray) -> None:
    if -32 <= x < 128:
        out += _B.pack(x & 0xFF)
    elif x > 0:
        if x < 0x100:
            out += _BB.pack(0xCC, x)
        elif x < 0x10000:
            out += _BH.pack(0xCD, x)
        elif x < 0x100000000:
            out += _BI.pack(0xCE, x)
        elif x < 0x10000000000000000:
            out += _BQ.pack(0xCF, x)
        else:
            raise OverflowError("Integer value out of range")
    elif x >= -0x80:
        out += _Bb.pack(0xD0, x)
    elif x >= -0x8000:
        out += _Bh.pack(0xD1, x)
    elif x >= -0x80000000:
        out += _Bi.pack(0xD2, x)
    elif x >= -0x8000000000000000:
        out += _Bq.pack(0xD3, x)
    else:
        raise OverflowError("Integer value out of range")


def _pack_len(n: int, fix: int, fix_max: int, m16: int, m32: int, out: bytearray,
              m8: int = 0) -> None:
    if n < fix_max:
        out += _B.pack(fix | n)
    elif m8 and n < 0x100:
        out += _BB.pack(m8, n)
    elif n < 0x10000:
        out += _BH.pack(m16, n)
    elif n < 0x100000000:
        out += _BI.pack(m32, n)
    else:
        raise ValueError("object too large to pack")


def _pack_str(s: str, out: bytearray) -> None:
    b = s.encode("utf-8")
    _pack_len(len(b), 0xA0, 32, 0xDA, 0xDB, out, m8=0xD9)
    out += b


def _pack_bin(b, out: bytearray) -> None:
    b = bytes(b)
    n = len(b)
    if n < 0x100:
        out += _BB.pack(0xC4, n)
    elif n < 0x10000:
        out += _BH.pack(0xC5, n)
    elif n < 0x100000000:
        out += _BI.pack(0xC6, n)
    else:
        raise ValueError("object too large to pack")
    out += b


def _pack_array(seq, out: bytearray) -> None:
    n = len(seq)
    _pack_len(n, 0x90, 16, 0xDC, 0xDD, out)
    if n > 1 and all(type(x) is float for x in seq):
        run = bytearray(_run(n).pack(*seq))
        run[0::9] = b"\xcb" * n
        out += run
        return
    for x in seq:
        _pack_into(x, out)


def _pack_map(d: dict, out: bytearray) -> None:
    _pack_len(len(d), 0x80, 16, 0xDE, 0xDF, out)
    for k, v in d.items():
        _pack_into(k, out)
        _pack_into(v, out)


def _pack_into(obj: Any, out: bytearray) -> None:
    t = type(obj)
    if t is str:
        _pack_str(obj, out)
    elif t is dict:
        _pack_map(obj, out)
    elif t is list or t is tuple:
        _pack_array(obj, out)
    elif t is float:
        out += _Bd.pack(_F64, obj)
    elif obj is None:
        out += b"\xc0"
    elif obj is True:
        out += b"\xc3"
    elif obj is False:
        out += b"\xc2"
    elif t is int:
        _pack_int(obj, out)
    # subclasses pack as their base type, as msgpack does by default
    elif isinstance(obj, bool):
        out += b"\xc3" if obj else b"\xc2"
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out += _Bd.pack(_F64, float(obj))
    elif isinstance(obj, str):
        _pack_str(str(obj), out)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        _pack_bin(obj, out)
    elif isinstance(obj, dict):
        _pack_map(obj, out)
    elif isinstance(obj, (list, tuple)):
        _pack_array(obj, out)
    else:
        # a typed value becomes its tagged map; anything else raises
        _pack_map(_typed_default(obj), out)


def pack(obj: Any) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)``, byte for byte."""
    out = bytearray()
    _pack_into(obj, out)
    return bytes(out)


# -- unpack -----------------------------------------------------------------


class _Reader:
    __slots__ = ("b", "pos")

    def __init__(self, b: bytes):
        self.b = b
        self.pos = 0

    def take(self, n: int) -> int:
        p = self.pos
        end = p + n
        if end > len(self.b):
            raise ValueError("truncated msgpack data")
        self.pos = end
        return p

    def value(self) -> Any:
        b = self.b
        p = self.take(1)
        c = b[p]
        if c <= 0x7F:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0xA0 <= c <= 0xBF:
            return self.str(c & 0x1F)
        if 0x90 <= c <= 0x9F:
            return self.array(c & 0x0F)
        if 0x80 <= c <= 0x8F:
            return self.map(c & 0x0F)
        op = _OPS.get(c)
        if op is None:
            raise ValueError(f"unsupported msgpack type 0x{c:02x}")
        return op(self)

    def fixed(self, s: struct.Struct) -> Any:
        return s.unpack_from(self.b, self.take(s.size))[0]

    def str(self, n: int) -> str:
        p = self.take(n)
        return self.b[p:p + n].decode("utf-8")

    def bin(self, n: int) -> bytes:
        p = self.take(n)
        return bytes(self.b[p:p + n])

    def array(self, n: int) -> list:
        b = self.b
        p = self.pos
        if n > 1 and p < len(b) and b[p] == _F64:
            end = p + 9 * n
            if end <= len(b) and b[p:end:9] == b"\xcb" * n:
                self.pos = end
                return list(_run(n).unpack_from(b, p))
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        d = {}
        for _ in range(n):
            k = self.value()
            d[k] = self.value()
        return _typed_hook(d)


_u8 = struct.Struct(">B")
_u16 = struct.Struct(">H")
_u32 = struct.Struct(">I")
_u64 = struct.Struct(">Q")
_i8 = struct.Struct(">b")
_i16 = struct.Struct(">h")
_i32 = struct.Struct(">i")
_i64 = struct.Struct(">q")
_f32 = struct.Struct(">f")
_f64 = struct.Struct(">d")

_OPS: Dict[int, Callable[[_Reader], Any]] = {
    0xC0: lambda r: None,
    0xC2: lambda r: False,
    0xC3: lambda r: True,
    0xC4: lambda r: r.bin(r.fixed(_u8)),
    0xC5: lambda r: r.bin(r.fixed(_u16)),
    0xC6: lambda r: r.bin(r.fixed(_u32)),
    0xCA: lambda r: r.fixed(_f32),
    0xCB: lambda r: r.fixed(_f64),
    0xCC: lambda r: r.fixed(_u8),
    0xCD: lambda r: r.fixed(_u16),
    0xCE: lambda r: r.fixed(_u32),
    0xCF: lambda r: r.fixed(_u64),
    0xD0: lambda r: r.fixed(_i8),
    0xD1: lambda r: r.fixed(_i16),
    0xD2: lambda r: r.fixed(_i32),
    0xD3: lambda r: r.fixed(_i64),
    0xD9: lambda r: r.str(r.fixed(_u8)),
    0xDA: lambda r: r.str(r.fixed(_u16)),
    0xDB: lambda r: r.str(r.fixed(_u32)),
    0xDC: lambda r: r.array(r.fixed(_u16)),
    0xDD: lambda r: r.array(r.fixed(_u32)),
    0xDE: lambda r: r.map(r.fixed(_u16)),
    0xDF: lambda r: r.map(r.fixed(_u32)),
}


def unpack(data: bytes) -> Any:
    """``msgpack.unpackb(data, raw=False, strict_map_key=False)`` on the
    subset above; ``ValueError`` on data outside it, truncated data or
    bytes left over."""
    r = _Reader(bytes(data) if not isinstance(data, bytes) else data)
    out = r.value()
    if r.pos != len(r.b):
        raise ValueError("extra data after the msgpack value")
    return out
