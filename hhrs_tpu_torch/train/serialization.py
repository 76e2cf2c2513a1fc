"""A msgpack decoder for flax's ``params.msgpack`` files, standard library only.

flax (``flax.serialization.to_bytes``) writes a state dict as msgpack:
nested maps with string keys (lists become maps keyed ``"0"``, ``"1"``, …),
and every array leaf as extension type 1, whose payload is itself msgpack:
the tuple ``(shape, dtype name, C-order bytes)``. :func:`msgpack_restore`
decodes that into nested ``dict``s of numpy arrays, as
``flax.serialization.msgpack_restore`` does. Leaves over 2 GiB, which flax
stores in a chunked form, are refused.
"""

from __future__ import annotations

import struct

import numpy as np

_EXT_NDARRAY = 1
_CHUNKED_KEY = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _decode(r: _Reader, raw_str: bool = False):
    b = r.unpack(">B")
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return [_decode(r, raw_str) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return _str(r, b & 0x1F, raw_str)
    if b == 0xC0:
        return None
    if b == 0xC2:
        return False
    if b == 0xC3:
        return True
    if b in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
        n = r.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])
        return bytes(r.take(n))
    if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
        n = r.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
        return _ext(r.unpack(">b"), bytes(r.take(n)))
    if b == 0xCA:
        return r.unpack(">f")
    if b == 0xCB:
        return r.unpack(">d")
    ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    if b in ints:
        return r.unpack(ints[b])
    if b in (0xD4, 0xD5, 0xD6, 0xD7, 0xD8):  # fixext 1/2/4/8/16
        code = r.unpack(">b")
        return _ext(code, bytes(r.take(1 << (b - 0xD4))))
    if b in (0xD9, 0xDA, 0xDB):  # str 8/16/32
        return _str(r, r.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b]), raw_str)
    if b in (0xDC, 0xDD):  # array 16/32
        return [_decode(r, raw_str) for _ in range(r.unpack(">H" if b == 0xDC else ">I"))]
    if b in (0xDE, 0xDF):  # map 16/32
        return _map(r, r.unpack(">H" if b == 0xDE else ">I"))
    raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")


def _str(r: _Reader, n: int, raw: bool):
    data = bytes(r.take(n))
    return data if raw else data.decode("utf-8")


def _map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        key = _decode(r)
        out[key] = _decode(r)
    if _CHUNKED_KEY in out:
        raise ValueError(
            "chunked array leaf (over 2 GiB) in params.msgpack is not supported"
        )
    return out


def _ext(code: int, payload: bytes):
    if code != _EXT_NDARRAY:
        raise ValueError(f"unsupported msgpack extension type {code}")
    r = _Reader(payload)
    shape, dtype_name, buf = _decode(r, raw_str=True)
    if r.pos != len(payload):
        raise ValueError("trailing bytes in an ndarray extension payload")
    dtype = np.dtype(dtype_name.decode("ascii"))
    return np.frombuffer(buf, dtype=dtype).reshape(shape)


def msgpack_restore(data: bytes):
    """Decode one msgpack document (flax's state-dict encoding)."""
    r = _Reader(data)
    out = _decode(r)
    if r.pos != len(data):
        raise ValueError("trailing bytes after the msgpack document")
    return out
