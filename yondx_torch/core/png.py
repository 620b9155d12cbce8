"""A PNG codec of the port's own (stdlib zlib and struct, numpy arrays), in
place of the JAX package's cv2.imwrite / cv2.imread of PNG files.

write_png(path, img): uint8 or uint16 arrays, [H, W] gray, [H, W, 2]
gray + alpha, [H, W, 3] RGB or [H, W, 4] RGBA, in that channel order (cv2
takes BGR; the port's callers flip where JAX's pass BGR). Every row is
Sub-filtered (Paeth cost a third more time on a 256x8192 sRGB strip for
2% less data) and the stream deflated at `level` (1 by default, as
cv2.imwrite).

read_png(path): the image as stored, [H, W] or [H, W, C] in the file's
channel order (gray, gray + alpha, RGB, RGBA), uint8 or uint16; gray of
1, 2 or 4 bits widens to uint8 scaled as libpng does (v * 255 / (2^d -
1)); a palette image expands to RGB, or RGBA when it has a tRNS chunk.
All five scanline filters are decoded. An interlaced file raises.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
# colour type -> channels
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


class PNGError(ValueError):
    pass


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _sub_filter(raw: np.ndarray, bpp: int) -> np.ndarray:
    """[H, n] bytes -> [H, 1 + n] rows filtered by Sub (type 1): each byte
    less the one bpp before it, modulo 256."""
    out = np.empty((raw.shape[0], raw.shape[1] + 1), np.uint8)
    out[:, 0] = 1
    out[:, 1:bpp + 1] = raw[:, :bpp]
    np.subtract(raw[:, bpp:], raw[:, :-bpp], out=out[:, bpp + 1:])
    return out


def encode_png(img, level: int = 1) -> bytes:
    """The PNG file's bytes of `img` (see write_png)."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise PNGError(f"PNG takes uint8 or uint16, got {img.dtype}")
    if img.ndim == 2:
        img = img[:, :, None]
    if img.ndim != 3 or img.shape[2] not in (1, 2, 3, 4):
        raise PNGError(f"PNG takes [H, W] or [H, W, 1-4], got {img.shape}")
    H, W, C = img.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[C]
    depth = 8 * img.dtype.itemsize
    raw = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img)
    rows = raw.view(np.uint8).reshape(H, W * C * depth // 8)
    data = _sub_filter(rows, C * depth // 8).tobytes()
    ihdr = struct.pack(">IIBBBBB", W, H, depth, ctype, 0, 0, 0)
    return (_SIG + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(data, level))
            + _chunk(b"IEND", b""))


def write_png(path: str, img, level: int = 1) -> None:
    """Write `img` ([H, W], [H, W, 2], [H, W, 3] RGB or [H, W, 4] RGBA;
    uint8 or uint16) to `path` as a PNG."""
    data = encode_png(img, level)
    with open(path, "wb") as f:
        f.write(data)


def _unfilter(data: bytes, H: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the scanline filters: [H, stride] bytes."""
    need = H * (stride + 1)
    if len(data) < need:
        raise PNGError(f"PNG image data is short: {len(data)} of {need}")
    buf = np.frombuffer(data, np.uint8, need).reshape(H, stride + 1)
    out = np.zeros((H, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(H):
        ftype, line = int(buf[y, 0]), buf[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:      # Sub: a running sum along each byte lane
            lanes = np.zeros(-(-stride // bpp) * bpp, np.uint8)
            lanes[:stride] = line
            cur = np.cumsum(lanes.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)[:stride]
        elif ftype == 2:      # Up
            cur = line + prev
        elif ftype in (3, 4):  # Average, Paeth: byte by byte
            cur = _unfilter_seq(line.tolist(), prev.tolist(), bpp, ftype)
        else:
            raise PNGError(f"PNG filter type {ftype} on row {y}")
        out[y] = cur
        prev = out[y]
    return out


def _unfilter_seq(line, prev, bpp, ftype) -> np.ndarray:
    cur = bytearray(len(line))
    for i, f in enumerate(line):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        if ftype == 3:
            cur[i] = (f + ((a + b) >> 1)) & 0xFF
            continue
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (f + pred) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """The image of a PNG file's bytes (see read_png)."""
    if data[:8] != _SIG:
        raise PNGError("not a PNG file")
    pos, ihdr, plte, trns, idat = 8, None, None, None, []
    while pos + 8 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
        if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise PNGError(f"PNG chunk {tag!r}: CRC mismatch")
        pos += 12 + n
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            trns = body
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if ihdr is None:
        raise PNGError("PNG without IHDR")
    W, H, depth, ctype, comp, filt, interlace = ihdr
    if interlace:
        raise PNGError("interlaced PNG files are not supported")
    if ctype not in _CHANNELS or comp or filt:
        raise PNGError(f"PNG colour type {ctype} / method {comp}, {filt}")
    C = _CHANNELS[ctype]
    bits = C * depth
    stride = (W * bits + 7) // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), H, stride,
                     max(1, bits // 8))
    if depth == 16:
        img = rows.view(">u2").astype(np.uint16).reshape(H, W, C)
    elif depth == 8:
        img = rows.reshape(H, W, C)
    else:                      # 1, 2 or 4 bits: gray or palette indices
        per = 8 // depth
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        v = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
        img = v.reshape(H, stride * per)[:, :W, None].astype(np.uint8)
        if ctype == 0:
            img = (img.astype(np.uint16) * 255
                   // ((1 << depth) - 1)).astype(np.uint8)
    if ctype == 3:
        if plte is None:
            raise PNGError("palette PNG without PLTE")
        idx = img[..., 0]
        if trns is not None:
            alpha = np.full(len(plte), 255, np.uint8)
            alpha[:len(trns)] = np.frombuffer(trns, np.uint8)[:len(plte)]
            return np.concatenate([plte[idx], alpha[idx][..., None]], -1)
        return plte[idx]
    return img[..., 0] if C == 1 else img


def read_png(path: str) -> np.ndarray:
    """Read a PNG file: [H, W] or [H, W, C] in the file's channel order
    (gray, gray + alpha, RGB, RGBA), uint8 or uint16."""
    with open(path, "rb") as f:
        return decode_png(f.read())
