"""The reference's own reader of the committed flax msgpack `.ckpt` files.

A checkpoint is one msgpack map {params, opt_state, epoch, best_psnr}.
Arrays are msgpack ext type 1 (a nested msgpack array: shape, dtype
name, C-order bytes); numpy scalars are ext type 3. Only `params` is
decoded; the rest of the map is skipped. `state_dict` lays the flax tree
out as PyTorch's modules want it (HWIO conv kernels to OIHW, dense
kernels transposed, transposed-conv kernels flipped).
"""
from __future__ import annotations

import struct

import numpy as np
import torch

_FIXED = {0xc0: ("nil", None), 0xc2: ("bool", False), 0xc3: ("bool", True)}
_SIZED = {
    0xc4: ("bin", ">B"), 0xc5: ("bin", ">H"), 0xc6: ("bin", ">I"),
    0xc7: ("ext", ">B"), 0xc8: ("ext", ">H"), 0xc9: ("ext", ">I"),
    0xd9: ("str", ">B"), 0xda: ("str", ">H"), 0xdb: ("str", ">I"),
    0xdc: ("array", ">H"), 0xdd: ("array", ">I"),
    0xde: ("map", ">H"), 0xdf: ("map", ">I"),
}
_NUMBERS = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
            0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}


class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n):
        out = self.buf[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("truncated msgpack data")
        self.pos += n
        return out

    def unpack(self, fmt):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def header(self):
        b = self.take(1)[0]
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
        if b in _FIXED:
            return _FIXED[b]
        if b in _SIZED:
            kind, fmt = _SIZED[b]
            return kind, self.unpack(fmt)
        if 0xd4 <= b <= 0xd8:
            return "ext", 1 << (b - 0xd4)
        if b in _NUMBERS:
            return ("float" if b in (0xca, 0xcb) else "int",
                    self.unpack(_NUMBERS[b]))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def read(self):
        kind, n = self.header()
        if kind in ("int", "float", "nil", "bool"):
            return n
        if kind == "str":
            return bytes(self.take(n)).decode("utf-8")
        if kind == "bin":
            return bytes(self.take(n))
        if kind == "array":
            return [self.read() for _ in range(n)]
        if kind == "map":
            return {self.read(): self.read() for _ in range(n)}
        code = struct.unpack(">b", self.take(1))[0]
        data = self.take(n)
        if code not in (1, 3):
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype, raw = _Reader(bytes(data)).read()
        arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)
        return arr if code == 1 else arr[()]

    def skip(self):
        kind, n = self.header()
        if kind in ("str", "bin"):
            self.pos += n
        elif kind == "ext":
            self.pos += 1 + n
        elif kind in ("array", "map"):
            for _ in range(n * (2 if kind == "map" else 1)):
                self.skip()


def read_params(path):
    """The `params` tree of a `.ckpt` (numpy leaves)."""
    with open(path, "rb") as f:
        r = _Reader(f.read())
    kind, n = r.header()
    if kind != "map":
        raise ValueError(f"{path}: not a checkpoint map")
    for _ in range(n):
        if r.read() == "params":
            params = r.read()
            return params.get("params", params)
        r.skip()
    raise KeyError(f"{path}: no params")


def state_dict(params):
    """flax params -> {dotted name: float32 tensor} in PyTorch layouts."""
    out = {}

    def walk(tree, path):
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val, path + (key,))
                continue
            arr = np.asarray(val)
            if key == "kernel" and arr.ndim == 4:
                arr = np.transpose(arr[::-1, ::-1], (2, 3, 0, 1)) \
                    if path[-1] == "deconv" else np.transpose(arr,
                                                              (3, 2, 0, 1))
            elif key == "kernel":
                arr = arr.T
            name = "weight" if key == "kernel" else key
            out[".".join(path + (name,))] = torch.from_numpy(
                np.array(arr, dtype=np.float32, order="C"))

    walk(params, ())
    return out
