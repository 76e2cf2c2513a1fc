"""A msgpack codec for flax's ``params.msgpack`` files, standard library only.

flax (``flax.serialization.to_bytes``) writes a state dict as msgpack:
nested maps with string keys (lists become maps keyed ``"0"``, ``"1"``, …),
and every array leaf as extension type 1, whose payload is itself msgpack:
the tuple ``(shape, dtype name, C-order bytes)``. :func:`msgpack_restore`
decodes that into nested ``dict``s of numpy arrays, as
``flax.serialization.msgpack_restore`` does; :func:`msgpack_serialize`
writes a tree of dicts, lists and numpy arrays as the JAX package's
export writes it, in the same (smallest) msgpack forms. Leaves over 2 GiB, which flax
stores in a chunked form, are refused both ways.
"""

from __future__ import annotations

import struct

import numpy as np

_EXT_NDARRAY = 1
_CHUNKED_KEY = "__msgpack_chunked_array__"
_MAX_LEAF_BYTES = 2**31 - 1


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


def _pack_uint_len(out: bytearray, n: int, small: int, fix_base: int | None, codes: tuple) -> None:
    """A length header: the fix form below ``small`` when there is one, else
    the 8/16/32-bit form (``codes`` lists the type bytes, shortest first;
    ``None`` where msgpack has no 8-bit form)."""
    if fix_base is not None and n < small:
        out.append(fix_base | n)
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack length {n} too large")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v <= 0x7F or -32 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
        return
    forms = ((0xCC, ">B", 0, 0xFF), (0xCD, ">H", 0, 0xFFFF), (0xCE, ">I", 0, 0xFFFFFFFF),
             (0xCF, ">Q", 0, 2**64 - 1)) if v > 0 else (
            (0xD0, ">b", -2**7, 0), (0xD1, ">h", -2**15, 0), (0xD2, ">i", -2**31, 0),
            (0xD3, ">q", -2**63, 0))
    for code, fmt, lo, hi in forms:
        if lo <= v <= hi:
            out.append(code)
            out += struct.pack(fmt, v)
            return
    raise ValueError(f"integer {v} out of msgpack range")


def _pack(out: bytearray, obj) -> None:
    if isinstance(obj, bool):
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_uint_len(out, len(data), 32, 0xA0, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, bytes):
        _pack_uint_len(out, len(obj), 0, None, (0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, dict):
        _pack_uint_len(out, len(obj), 16, 0x80, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(obj, (list, tuple)):
        _pack_uint_len(out, len(obj), 16, 0x90, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, np.ndarray):
        _pack_ndarray(out, obj)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def _pack_ndarray(out: bytearray, arr: np.ndarray) -> None:
    """Extension type 1 around msgpack ``(shape, dtype name, raw bytes)``."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    if arr.nbytes > _MAX_LEAF_BYTES:
        raise ValueError("array leaves over 2 GiB (flax's chunked form) are not supported")
    payload = bytearray()
    _pack(payload, (list(arr.shape), arr.dtype.name, arr.tobytes("C")))
    n = len(payload)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        out.append(fixext[n])
    else:
        _pack_uint_len(out, n, 0, None, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", _EXT_NDARRAY)
    out += payload


def to_state_dict(tree):
    """flax's state-dict form: lists become maps keyed ``"0"``, ``"1"``, …
    in index order; dict keys are sorted, as ``jax.device_get`` leaves them
    in the JAX package's export, so both packages write the same bytes."""
    if isinstance(tree, dict):
        return {str(k): to_state_dict(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return {str(i): to_state_dict(v) for i, v in enumerate(tree)}
    return tree


def msgpack_serialize(tree) -> bytes:
    """Encode a tree of dicts, lists and numpy arrays as the JAX package's
    ``export_artifacts`` does (``flax.serialization.to_bytes`` of the
    ``jax.device_get``-ed tree)."""
    out = bytearray()
    _pack(out, to_state_dict(tree))
    return bytes(out)
