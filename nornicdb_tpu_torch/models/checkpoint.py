"""Encoder checkpoint I/O (counterpart of ``load_checkpoint``,
``default_checkpoint_path`` and ``load_default_embedder`` in
``nornicdb_tpu/models/pretrain.py``).

The committed ``encoder_mini.npz`` holds ``params``, a flax msgpack blob
(uint8), and ``meta = [vocab, hidden, layers, heads, mlp, max_len]``.
Inside the blob every array is msgpack ext type 1 carrying
``(shape, dtype name, raw bytes)``, in float16. Neither ``msgpack`` nor
``flax`` is a dependency of the port, so this module carries the small
msgpack reader that blob needs, and the writer (``packb``) that makes
the same bytes as ``flax.serialization.to_bytes`` for a tree of dicts of
arrays (``models/pretrain.save_checkpoint``).
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np

_EXT_NDARRAY = 1  # flax.serialization's ext code for numpy arrays


class _Reader:
    """Decoder for the msgpack subset flax writes: maps, arrays, strings,
    bin, ints, floats, nil/bool and ext (type 1 = ndarray)."""

    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self._take(size))[0]

    def read(self) -> Any:
        t = self._unpack(">B")
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self._map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self._array(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return str(self._take(t & 0x1F), "utf-8")
        fixed = {
            0xC0: lambda: None,
            0xC2: lambda: False,
            0xC3: lambda: True,
            0xC4: lambda: bytes(self._take(self._unpack(">B"))),
            0xC5: lambda: bytes(self._take(self._unpack(">H"))),
            0xC6: lambda: bytes(self._take(self._unpack(">I"))),
            0xC7: lambda: self._ext(self._unpack(">B")),
            0xC8: lambda: self._ext(self._unpack(">H")),
            0xC9: lambda: self._ext(self._unpack(">I")),
            0xCA: lambda: self._unpack(">f"),
            0xCB: lambda: self._unpack(">d"),
            0xCC: lambda: self._unpack(">B"),
            0xCD: lambda: self._unpack(">H"),
            0xCE: lambda: self._unpack(">I"),
            0xCF: lambda: self._unpack(">Q"),
            0xD0: lambda: self._unpack(">b"),
            0xD1: lambda: self._unpack(">h"),
            0xD2: lambda: self._unpack(">i"),
            0xD3: lambda: self._unpack(">q"),
            0xD4: lambda: self._ext(1),
            0xD5: lambda: self._ext(2),
            0xD6: lambda: self._ext(4),
            0xD7: lambda: self._ext(8),
            0xD8: lambda: self._ext(16),
            0xD9: lambda: str(self._take(self._unpack(">B")), "utf-8"),
            0xDA: lambda: str(self._take(self._unpack(">H")), "utf-8"),
            0xDB: lambda: str(self._take(self._unpack(">I")), "utf-8"),
            0xDC: lambda: self._array(self._unpack(">H")),
            0xDD: lambda: self._array(self._unpack(">I")),
            0xDE: lambda: self._map(self._unpack(">H")),
            0xDF: lambda: self._map(self._unpack(">I")),
        }
        fn = fixed.get(t)
        if fn is None:
            raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")
        return fn()

    def _map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _ext(self, n: int) -> np.ndarray:
        code = self._unpack(">b")
        data = bytes(self._take(n))
        if code != _EXT_NDARRAY:
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype_name, raw = unpackb(data)
        if isinstance(dtype_name, bytes):
            dtype_name = dtype_name.decode()
        return np.frombuffer(raw, dtype=np.dtype(dtype_name)).reshape(shape)


def unpackb(data: bytes) -> Any:
    """Decode one msgpack object (the whole buffer)."""
    reader = _Reader(data)
    out = reader.read()
    if reader.pos != len(data):
        raise ValueError("trailing bytes after msgpack object")
    return out


def _pack_len(out: bytearray, n: int, fix: int, fix_max: int, codes) -> None:
    """A length header: ``fix | n`` below ``fix_max``, else the smallest
    of ``codes`` (8/16/32-bit, ``None`` where msgpack has no such form)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError("msgpack object too large")


def _pack(out: bytearray, obj: Any, strict: bool) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        if 0 <= obj < 0x80 or -0x20 <= obj < 0:
            out += struct.pack(">b" if obj < 0 else ">B", obj)
        else:
            for lo, hi, code, fmt in ((0, 0xFF, 0xCC, ">B"), (-0x80, -1, 0xD0, ">b"),
                                      (0, 0xFFFF, 0xCD, ">H"), (-0x8000, -1, 0xD1, ">h"),
                                      (0, 0xFFFFFFFF, 0xCE, ">I"),
                                      (-0x80000000, -1, 0xD2, ">i"),
                                      (0, (1 << 64) - 1, 0xCF, ">Q"),
                                      (-(1 << 63), -1, 0xD3, ">q")):
                if lo <= obj <= hi:
                    out.append(code)
                    out += struct.pack(fmt, obj)
                    return
            raise ValueError("integer out of msgpack's range")
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(out, len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _pack_len(out, len(raw), None, 0, (0xC4, 0xC5, 0xC6))
        out += raw
    elif isinstance(obj, list) or (isinstance(obj, tuple) and not strict):
        _pack_len(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for x in obj:
            _pack(out, x, strict)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, k, strict)
            _pack(out, v, strict)
    elif isinstance(obj, np.ndarray):
        if obj.dtype.hasobject:
            raise ValueError("object arrays cannot be packed")
        data = packb((obj.shape, obj.dtype.name, obj.tobytes("C")), strict=False)
        fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}.get(len(data))
        if fixed is not None:
            out.append(fixed)
        else:
            _pack_len(out, len(data), None, 0, (0xC7, 0xC8, 0xC9))
        out += struct.pack(">b", _EXT_NDARRAY)
        out += data
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


def packb(obj: Any, strict: bool = True) -> bytes:
    """Encode ``obj`` (dicts, lists, strings, bytes, numbers, None, bools,
    numpy arrays as ext type 1) as flax's ``msgpack_serialize`` does:
    the smallest encoding of each value, floats as doubles, tuples only
    inside an array's ext payload (``strict``)."""
    out = bytearray()
    _pack(out, obj, strict)
    return bytes(out)


def read_checkpoint(path: str) -> Tuple[list, Dict[str, Any]]:
    """(meta, flax parameter tree of float16 numpy arrays)."""
    data = np.load(path if path.endswith(".npz") else path + ".npz")
    meta = [int(x) for x in data["meta"]]
    return meta, unpackb(data["params"].tobytes())


def _to_f32(tree):
    if isinstance(tree, dict):
        return {k: _to_f32(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)


def load_checkpoint(path: str):
    """Returns (cfg, state_dict) with float32 params. The config is the
    checkpoint's shape with the config's default dtype (bf16 activations,
    float32 LayerNorm), as ``pretrain.load_checkpoint`` builds it; a
    caller that needs float32 activations replaces ``cfg.dtype``."""
    from nornicdb_tpu_torch.models.encoder import EncoderConfig
    from nornicdb_tpu_torch.models.weights import params_from_jax

    meta, tree = read_checkpoint(path)
    cfg = EncoderConfig(
        vocab_size=meta[0], hidden_size=meta[1], num_layers=meta[2],
        num_heads=meta[3], mlp_dim=meta[4], max_len=meta[5],
    )
    return cfg, params_from_jax(_to_f32(tree))


def default_checkpoint_path() -> Optional[str]:
    """The committed mini checkpoint, read as data from its place in the
    JAX package's tree; None if absent."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.path.join(root, "nornicdb_tpu", "models", "checkpoints",
                        "encoder_mini.npz")
    return path if os.path.exists(path) else None


def load_default_embedder(device=None, dtype=None):
    """The DB's default semantic embedder: the committed mini encoder
    behind ``TorchEncoderEmbedder``, in bf16 unless ``dtype`` says
    otherwise; None when no checkpoint exists."""
    path = default_checkpoint_path()
    if path is None:
        return None
    from nornicdb_tpu_torch.embed.embedder import TorchEncoderEmbedder
    from nornicdb_tpu_torch.models.encoder import Encoder

    cfg, state = load_checkpoint(path)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    model = Encoder(cfg)
    model.load_state_dict(state)
    return TorchEncoderEmbedder(model=model, cfg=cfg, device=device)
