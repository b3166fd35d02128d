"""The checkpoint manifest's codec: the subset of MessagePack it uses.

A checkpoint's ``manifest.msgpack`` (paths, dtypes, shapes, step and the
server's ``extra`` blob) is MessagePack, as the reference writes it with
``msgpack.packb``. The port keeps its own encoder and decoder, so it
needs no ``msgpack`` package. The subset: nil, bool, integers of every
width and sign (packed in the smallest form, as ``msgpack.packb``
packs them), float64 (float32 is decoded too), str, bin, and arrays and
maps of every length class. Extension types raise. ``packb`` output
reads back through ``msgpack.unpackb`` and vice versa (the tests hold
both ways): str is UTF-8 (``use_bin_type=True``), bytes is bin, a
tuple packs as an array and every array decodes as a list.
"""
from __future__ import annotations

import struct
from typing import Any, Tuple


def packb(obj: Any) -> bytes:
    """MessagePack bytes of ``obj`` (None, bool, int, float, str, bytes,
    list/tuple, dict, nested)."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _header(out: bytearray, n: int, fix: int, fix_max: int, codes) -> None:
    """A length header: the fix form below ``fix_max``, else the 8-, 16-
    or 32-bit form (``codes``; None where the type has no such form)."""
    if n < fix_max and fix is not None:
        out.append(fix | n)
    elif n <= 0xFF and codes[0] is not None:
        out += struct.pack(">BB", codes[0], n)
    elif n <= 0xFFFF:
        out += struct.pack(">BH", codes[1], n)
    elif n <= 0xFFFFFFFF:
        out += struct.pack(">BI", codes[2], n)
    else:
        raise ValueError(f"length {n} exceeds MessagePack's 32-bit limit")


def _pack_int(v: int, out: bytearray) -> None:
    if -0x20 <= v < 0x80:
        out += struct.pack(">b" if v < 0 else ">B", v)
    elif 0x80 <= v <= 0xFF:
        out += struct.pack(">BB", 0xCC, v)
    elif -0x80 <= v < 0:
        out += struct.pack(">Bb", 0xD0, v)
    elif 0xFF < v <= 0xFFFF:
        out += struct.pack(">BH", 0xCD, v)
    elif -0x8000 <= v < -0x80:
        out += struct.pack(">Bh", 0xD1, v)
    elif 0xFFFF < v <= 0xFFFFFFFF:
        out += struct.pack(">BI", 0xCE, v)
    elif -0x80000000 <= v < -0x8000:
        out += struct.pack(">Bi", 0xD2, v)
    elif 0xFFFFFFFF < v <= 0xFFFFFFFFFFFFFFFF:
        out += struct.pack(">BQ", 0xCF, v)
    elif -0x8000000000000000 <= v < -0x80000000:
        out += struct.pack(">Bq", 0xD3, v)
    else:
        raise OverflowError(f"integer {v} does not fit in 64 bits")


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif isinstance(obj, bool):
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out += struct.pack(">Bd", 0xCB, obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _header(out, len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _header(out, len(raw), None, 0, (0xC4, 0xC5, 0xC6))
        out += raw
    elif isinstance(obj, (list, tuple)):
        _header(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _header(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__!r} "
                        "into a checkpoint manifest")


def unpackb(data: bytes) -> Any:
    """The object encoded in ``data`` (one MessagePack value, nothing
    after it)."""
    obj, pos = _unpack(bytes(data), 0)
    if pos != len(data):
        raise ValueError(f"{len(data) - pos} bytes of extra data after "
                         "the manifest")
    return obj


# fixed-width codes: (struct format, byte count)
_SCALARS = {0xCA: (">f", 4), 0xCB: (">d", 8),
            0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
            0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8)}
# length-prefixed codes: code -> (kind, length format, length bytes)
_SIZED = {0xD9: ("str", ">B", 1), 0xDA: ("str", ">H", 2),
          0xDB: ("str", ">I", 4), 0xC4: ("bin", ">B", 1),
          0xC5: ("bin", ">H", 2), 0xC6: ("bin", ">I", 4),
          0xDC: ("array", ">H", 2), 0xDD: ("array", ">I", 4),
          0xDE: ("map", ">H", 2), 0xDF: ("map", ">I", 4)}


def _take(data: bytes, pos: int, n: int) -> int:
    if pos + n > len(data):
        raise ValueError("truncated manifest")
    return pos + n


def _unpack(data: bytes, pos: int) -> Tuple[Any, int]:
    end = _take(data, pos, 1)
    b = data[pos]
    pos = end
    if b <= 0x7F:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if 0x80 <= b <= 0x8F:
        return _sized("map", b & 0x0F, data, pos)
    if 0x90 <= b <= 0x9F:
        return _sized("array", b & 0x0F, data, pos)
    if 0xA0 <= b <= 0xBF:
        return _sized("str", b & 0x1F, data, pos)
    if b == 0xC0:
        return None, pos
    if b in (0xC2, 0xC3):
        return b == 0xC3, pos
    if b in _SCALARS:
        fmt, n = _SCALARS[b]
        end = _take(data, pos, n)
        return struct.unpack_from(fmt, data, pos)[0], end
    if b in _SIZED:
        kind, fmt, n = _SIZED[b]
        end = _take(data, pos, n)
        return _sized(kind, struct.unpack_from(fmt, data, pos)[0], data, end)
    raise ValueError(f"unsupported MessagePack type byte 0x{b:02x}")


def _sized(kind: str, n: int, data: bytes, pos: int) -> Tuple[Any, int]:
    if kind in ("str", "bin"):
        end = _take(data, pos, n)
        raw = data[pos:end]
        return (raw.decode("utf-8") if kind == "str" else raw), end
    if kind == "array":
        out = []
        for _ in range(n):
            v, pos = _unpack(data, pos)
            out.append(v)
        return out, pos
    res = {}
    for _ in range(n):
        k, pos = _unpack(data, pos)
        v, pos = _unpack(data, pos)
        res[k] = v
    return res, pos
