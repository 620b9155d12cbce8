"""Reader and writer of the flax msgpack `.ckpt` files (yondx/train/ckpt.py).

A checkpoint is one msgpack map {params, opt_state, epoch, best_psnr}
written by `flax.serialization.msgpack_serialize`. Arrays are msgpack ext
type 1: a nested msgpack array (shape, dtype name, C-order bytes); numpy
scalars are ext type 3 in the same encoding. This module decodes and
encodes that format in pure Python + numpy (no msgpack or flax package
needed). The reader skips `opt_state` without materializing it (two
thirds of a file) unless asked for it; the writer emits what flax emits
for the same tree, byte for byte: map keys sorted at every level (flax
rebuilds the tree with jax.tree_util first), the smallest msgpack form
of every int, str, bin, array and map header, floats as float64.
"""
from __future__ import annotations

import os
import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    """Minimal msgpack decoder over one bytes buffer."""

    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        out = self.buf[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("truncated msgpack data")
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self._take(size))[0]

    def _header(self) -> Tuple[str, int]:
        """-> (kind, payload); kind in int/float/nil/bool/str/bin/array/
        map/ext. For str/bin/array/map the payload is the length; for ext
        it is the length and the type byte is read by the caller."""
        b = self._take(1)[0]
        if b <= 0x7f:
            return "int", b
        if b >= 0xe0:
            return "int", b - 0x100
        if 0x80 <= b <= 0x8f:
            return "map", b & 0x0f
        if 0x90 <= b <= 0x9f:
            return "array", b & 0x0f
        if 0xa0 <= b <= 0xbf:
            return "str", b & 0x1f
        fixed = {
            0xc0: ("nil", None), 0xc2: ("bool", False), 0xc3: ("bool", True),
        }
        if b in fixed:
            return fixed[b]
        sized = {
            0xc4: ("bin", ">B"), 0xc5: ("bin", ">H"), 0xc6: ("bin", ">I"),
            0xc7: ("ext", ">B"), 0xc8: ("ext", ">H"), 0xc9: ("ext", ">I"),
            0xd9: ("str", ">B"), 0xda: ("str", ">H"), 0xdb: ("str", ">I"),
            0xdc: ("array", ">H"), 0xdd: ("array", ">I"),
            0xde: ("map", ">H"), 0xdf: ("map", ">I"),
        }
        if b in sized:
            kind, fmt = sized[b]
            return kind, self._unpack(fmt)
        if 0xd4 <= b <= 0xd8:                       # fixext 1/2/4/8/16
            return "ext", 1 << (b - 0xd4)
        numbers = {
            0xca: ">f", 0xcb: ">d",
            0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
            0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q",
        }
        if b in numbers:
            v = self._unpack(numbers[b])
            return ("float" if b in (0xca, 0xcb) else "int"), v
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def read(self) -> Any:
        kind, n = self._header()
        if kind in ("int", "float", "nil", "bool"):
            return n
        if kind == "str":
            return bytes(self._take(n)).decode("utf-8")
        if kind == "bin":
            return bytes(self._take(n))
        if kind == "array":
            return [self.read() for _ in range(n)]
        if kind == "map":
            out = {}
            for _ in range(n):
                key = self.read()
                out[key] = self.read()
            return out
        code = struct.unpack(">b", self._take(1))[0]
        data = self._take(n)
        if code == _EXT_NDARRAY:
            return _ndarray_from_bytes(data)
        if code == _EXT_NPSCALAR:
            return _ndarray_from_bytes(data)[()]
        raise ValueError(f"unsupported msgpack ext type {code}")

    def skip(self) -> None:
        kind, n = self._header()
        if kind in ("str", "bin"):
            self.pos += n
        elif kind == "ext":
            self.pos += 1 + n
        elif kind == "array":
            for _ in range(n):
                self.skip()
        elif kind == "map":
            for _ in range(2 * n):
                self.skip()


def _ndarray_from_bytes(data: memoryview) -> np.ndarray:
    """flax's ndarray encoding: msgpack (shape, dtype name, bytes)."""
    shape, dtype_name, raw = _Reader(bytes(data)).read()
    return np.frombuffer(raw, dtype=np.dtype(dtype_name)).reshape(shape)


def read_msgpack(buf: bytes, skip_keys=()) -> Any:
    """Decode one msgpack object; top-level map keys in `skip_keys` are
    passed over without decoding (their values are absent from the
    result)."""
    r = _Reader(buf)
    kind, n = r._header()
    if kind != "map":
        r.pos = 0
        return r.read()
    out = {}
    for _ in range(n):
        key = r.read()
        if key in skip_keys:
            r.skip()
        else:
            out[key] = r.read()
    return out


def load_checkpoint(path: str, opt_state: bool = False) -> Dict[str, Any]:
    """Read a yondx `.ckpt` into {params, epoch, best_psnr} of numpy
    leaves (the flax variable tree, e.g. {'params': {...}}), and its
    `opt_state` tree when asked (else it is skipped)."""
    with open(path, "rb") as f:
        buf = f.read()
    return read_msgpack(buf, skip_keys=() if opt_state else ("opt_state",))


# ------------------------------------------------------------------ writer

def _pack_header(out: list, kind: str, n: int) -> None:
    """Append the msgpack header of a str/bin/array/map of length n."""
    fix = {"str": (0xa0, 32), "array": (0x90, 16), "map": (0x80, 16)}
    if kind in fix and n < fix[kind][1]:
        out.append(bytes([fix[kind][0] | n]))
        return
    codes = {"str": (0xd9, 0xda, 0xdb), "bin": (0xc4, 0xc5, 0xc6),
             "array": (None, 0xdc, 0xdd), "map": (None, 0xde, 0xdf)}[kind]
    if n < 256 and codes[0] is not None:
        out.append(struct.pack(">BB", codes[0], n))
    elif n < 65536:
        out.append(struct.pack(">BH", codes[1], n))
    else:
        out.append(struct.pack(">BI", codes[2], n))


def _pack_int(out: list, v: int) -> None:
    if 0 <= v < 128:
        out.append(struct.pack(">B", v))
    elif -32 <= v < 0:
        out.append(struct.pack(">b", v))
    elif v >= 0:
        for fmt, code in ((">B", 0xcc), (">H", 0xcd), (">I", 0xce),
                          (">Q", 0xcf)):
            if v < 1 << (8 * struct.calcsize(fmt)):
                out.append(bytes([code]) + struct.pack(fmt, v))
                return
        raise OverflowError(v)
    else:
        for fmt, code in ((">b", 0xd0), (">h", 0xd1), (">i", 0xd2),
                          (">q", 0xd3)):
            bits = 8 * struct.calcsize(fmt) - 1
            if v >= -(1 << bits):
                out.append(bytes([code]) + struct.pack(fmt, v))
                return
        raise OverflowError(v)


def _pack_ext(out: list, code: int, data: bytes) -> None:
    n = len(data)
    fixext = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixext:
        out.append(struct.pack(">Bb", fixext[n], code))
    elif n < 256:
        out.append(struct.pack(">BBb", 0xc7, n, code))
    elif n < 65536:
        out.append(struct.pack(">BHb", 0xc8, n, code))
    else:
        out.append(struct.pack(">BIb", 0xc9, n, code))
    out.append(data)


def _ndarray_to_bytes(arr: np.ndarray) -> bytes:
    arr = np.asarray(arr)
    out: list = []
    _pack_header(out, "array", 3)
    _pack_header(out, "array", arr.ndim)
    for d in arr.shape:
        _pack_int(out, int(d))
    _pack(out, arr.dtype.name)
    raw = arr.tobytes("C")
    _pack_header(out, "bin", len(raw))
    out.append(raw)
    return b"".join(out)


def _pack(out: list, obj: Any) -> None:
    if isinstance(obj, np.ndarray):
        _pack_ext(out, _EXT_NDARRAY, _ndarray_to_bytes(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _ndarray_to_bytes(np.asarray(obj)))
    elif type(obj) is int:
        _pack_int(out, obj)
    elif type(obj) is float:
        out.append(struct.pack(">Bd", 0xcb, obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_header(out, "str", len(raw))
        out.append(raw)
    elif isinstance(obj, dict):
        _pack_header(out, "map", len(obj))
        for k in sorted(obj):
            _pack(out, k)
            _pack(out, obj[k])
    else:
        raise TypeError(f"cannot encode {type(obj).__name__} in a .ckpt")


def write_msgpack(obj: Any) -> bytes:
    """Encode a tree of dicts (str keys) with numpy arrays and scalars,
    ints, floats and strings as flax.serialization.msgpack_serialize
    does; any other type raises TypeError."""
    out: list = []
    _pack(out, obj)
    return b"".join(out)


def find_checkpoint(fast_ckpt: str, model_name: str) -> Optional[str]:
    """Inference search order best -> last -> bare (yondx/train/ckpt.py)."""
    for suffix in ("_best_model", "_last_model", ""):
        p = os.path.join(fast_ckpt, f"{model_name}{suffix}.ckpt")
        if os.path.exists(p):
            return p
    return None
