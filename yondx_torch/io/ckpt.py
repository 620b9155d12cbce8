"""Checkpoint reader for the flax msgpack `.ckpt` files (yondx/train/ckpt.py).

A checkpoint is one msgpack map {params, opt_state, epoch, best_psnr}
written by `flax.serialization.msgpack_serialize`. Arrays are msgpack ext
type 1: a nested msgpack array (shape, dtype name, C-order bytes); numpy
scalars are ext type 3 in the same encoding. This module decodes that
format in pure Python + numpy (no msgpack or flax package needed) and
skips `opt_state` without materializing it (two thirds of the file).
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


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Read a yondx `.ckpt` into {params, epoch, best_psnr} of numpy
    leaves (the flax variable tree, e.g. {'params': {...}}); the
    optimizer state is skipped."""
    with open(path, "rb") as f:
        buf = f.read()
    return read_msgpack(buf, skip_keys=("opt_state",))


def find_checkpoint(fast_ckpt: str, model_name: str) -> Optional[str]:
    """Inference search order best -> last -> bare (yondx/train/ckpt.py)."""
    for suffix in ("_best_model", "_last_model", ""):
        p = os.path.join(fast_ckpt, f"{model_name}{suffix}.ckpt")
        if os.path.exists(p):
            return p
    return None
