"""Tensorstore's OCDBT key-value store, read and written by the port.

Orbax writes its checkpoints (yondx/train/orbax_ckpt.py) as an OCDBT store:
a manifest (`manifest.ocdbt`) whose newest version names the root of a
B-tree, whose leaves map keys to values stored inline or as (data file,
offset, length) references. Orbax's root manifest merges the trees its
processes write under `ocdbt.process_<i>/`; its nodes name those
processes' data files, which this reader follows.

On disk (every integer a LEB128 varint unless noted):
- a manifest or node starts with its magic (u32 big-endian: 0x0cdb3a2a,
  0x0cdb20de), its total length (u64 LE), a format version (0) and a
  compression format (0 none, 1 zstd: the rest up to the footer is one
  zstd frame); it ends with the CRC-32C of everything before it (u32 LE);
- the manifest's body: its config (16-byte uuid, manifest kind, max
  inline value bytes, max decoded node bytes, version tree arity log2 as
  one byte, compression method 0 or 1 with a zstd level as i32 LE), then
  the inline version tree leaf: a data file table and, per version, its
  generation, root height (one byte), root location (file id, offset,
  length; all ones for an empty tree), statistics (keys, tree bytes,
  indirect value bytes) and commit time (u64 LE), column by column; then
  references to older version tree nodes, which a reader of the newest
  version does not need;
- a data file table: the count, then prefix-compressed paths (prefix
  lengths from the second path on, suffix lengths, base path lengths,
  the suffix bytes); a file's path is relative to the store's root;
- a node: its height (one byte), a data file table, the entry count,
  prefix-compressed keys; a leaf then has each value's length and kind
  (0 inline, 1 indirect), the indirect values' file ids and offsets and
  the inline values' bytes; an interior node has each child's common key
  prefix length, location and statistics. A child's keys are stored
  without the prefix its parent's entry gives them.

The reader takes node compression 0 and 1 (zstd through
`native.zstd_decompress`, the port's own decoder) and raises naming any
other field it does not know. The writer writes one uncompressed manifest
and one data file holding every value longer than MAX_INLINE bytes and then
one leaf node: a store any OCDBT reader (tensorstore's) opens.
"""
from __future__ import annotations

import os
import secrets
import struct
import time
from typing import Dict, Iterator, List, Optional, Tuple

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
NO_LOCATION = (1 << 64) - 1
MAX_INLINE = 100            # value bytes the writer keeps in the leaf node


class OcdbtError(ValueError):
    """A store this reader does not take, or a corrupt one."""


def _native():
    from .. import native
    return native


class _Reader:
    def __init__(self, buf: bytes, what: str):
        self.buf, self.pos, self.what = buf, 0, what

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise OcdbtError(f"{self.what}: truncated")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        out = shift = 0
        while True:
            b = self.u8()
            out |= (b & 0x7F) << shift
            if b < 0x80:
                return out
            shift += 7
            if shift > 63:
                raise OcdbtError(f"{self.what}: varint longer than 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _unwrap(data: bytes, magic: int, what: str) -> bytes:
    """Checks a manifest's or node's header and footer; returns its body."""
    if len(data) < 18:
        raise OcdbtError(f"{what}: {len(data)} bytes, too short")
    got_magic, length = struct.unpack(">I", data[:4])[0], \
        struct.unpack("<Q", data[4:12])[0]
    if got_magic != magic:
        raise OcdbtError(f"{what}: magic {got_magic:#010x}, "
                         f"expected {magic:#010x}")
    if length != len(data):
        raise OcdbtError(f"{what}: header length {length}, "
                         f"{len(data)} bytes read")
    crc = struct.unpack("<I", data[-4:])[0]
    if _native().crc32c(data[:-4]) != crc:
        raise OcdbtError(f"{what}: CRC-32C mismatch")
    r = _Reader(data[:-4], what)
    r.pos = 12
    version = r.varint()
    if version != 0:
        raise OcdbtError(f"{what}: format version {version} (only 0 "
                         "is read)")
    compression = r.varint()
    body = data[r.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        return _native().zstd_decompress(body)
    raise OcdbtError(f"{what}: compression_format {compression} (0 none "
                     "and 1 zstd are read)")


def _wrap(magic: int, body: bytes) -> bytes:
    head = _varint(0) + _varint(0)          # version 0, uncompressed
    length = 4 + 8 + len(head) + len(body) + 4
    data = struct.pack(">I", magic) + struct.pack("<Q", length) + head + body
    return data + struct.pack("<I", _native().crc32c(data))


def _file_table(r: _Reader) -> List[str]:
    n = r.varint()
    if n == 0:
        return []
    prefix = [0] + r.varints(n - 1)
    suffix = r.varints(n)
    base = r.varints(n)
    paths, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise OcdbtError(f"{r.what}: data file path prefix too long")
        prev = prev[:prefix[i]] + r.take(suffix[i])
        if base[i] > len(prev):
            raise OcdbtError(f"{r.what}: data file base path too long")
        paths.append(prev.decode())     # base path + relative path
    return paths


def _keys(r: _Reader, n: int) -> Tuple[List[int], List[int]]:
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    return prefix, suffix


def _join_keys(r: _Reader, prefix: List[int], suffix: List[int]) \
        -> List[bytes]:
    keys, prev = [], b""
    for p, s in zip(prefix, suffix):
        if p > len(prev):
            raise OcdbtError(f"{r.what}: key prefix longer than the key "
                             "before it")
        prev = prev[:p] + r.take(s)
        keys.append(prev)
    return keys


class Config:
    def __init__(self, r: _Reader):
        self.uuid = r.take(16)
        self.manifest_kind = r.varint()
        if self.manifest_kind != 0:
            raise OcdbtError(f"manifest_kind {self.manifest_kind}: only a "
                             "single-file manifest (0) is read")
        self.max_inline_value_bytes = r.varint()
        self.max_decoded_node_bytes = r.varint()
        self.version_tree_arity_log2 = r.u8()
        self.compression_method = r.varint()
        self.zstd_level = None
        if self.compression_method == 1:
            self.zstd_level = struct.unpack("<i", r.take(4))[0]
        elif self.compression_method != 0:
            raise OcdbtError(f"config compression_method "
                             f"{self.compression_method} (0 none and 1 "
                             "zstd are read)")


class Store:
    """An OCDBT store's newest version, read from the directory `root`.

    `keys()` lists the keys in order, `read(key)` returns a value,
    `items()` yields every (key, value)."""

    def __init__(self, root: str):
        self.root = root
        path = os.path.join(root, "manifest.ocdbt")
        with open(path, "rb") as f:
            r = _Reader(_unwrap(f.read(), MANIFEST_MAGIC, path), path)
        self.config = Config(r)
        files = _file_table(r)
        n = r.varint()
        if n == 0:
            raise OcdbtError(f"{path}: no version in the manifest")
        gens = r.varints(n)
        heights = [r.u8() for _ in range(n)]
        fids, offs, lens = r.varints(n), r.varints(n), r.varints(n)
        r.varints(3 * n)                     # statistics
        r.take(8 * n)                        # commit times
        i = max(range(n), key=gens.__getitem__)
        self.generation = gens[i]
        self._entries: Dict[bytes, Tuple] = {}
        if offs[i] != NO_LOCATION:
            if fids[i] >= len(files):
                raise OcdbtError(f"{path}: root names data file "
                                 f"{fids[i]} of {len(files)}")
            self._walk(files[fids[i]], offs[i], lens[i], heights[i], b"")

    def _read_file(self, rel: str, offset: int, length: int) -> bytes:
        with open(os.path.join(self.root, rel), "rb") as f:
            f.seek(offset)
            data = f.read(length)
        if len(data) != length:
            raise OcdbtError(f"{rel}: {length} bytes at {offset} past its "
                             "end")
        return data

    def _walk(self, rel: str, offset: int, length: int, height: int,
              prefix: bytes) -> None:
        what = f"{rel}@{offset}"
        body = _unwrap(self._read_file(rel, offset, length), NODE_MAGIC,
                       what)
        r = _Reader(body, what)
        h = r.u8()
        if h != height:
            raise OcdbtError(f"{what}: node height {h}, its parent says "
                             f"{height}")
        files = _file_table(r)
        n = r.varint()
        kp, ks = _keys(r, n)
        if height == 0:
            keys = _join_keys(r, kp, ks)
            vlen = r.varints(n)
            kind = r.varints(n)
            indirect = [j for j in range(n) if kind[j] == 1]
            if any(k not in (0, 1) for k in kind):
                raise OcdbtError(f"{what}: value kind not 0 (inline) or 1 "
                                 "(indirect)")
            vfid = r.varints(len(indirect))
            voff = r.varints(len(indirect))
            loc = dict(zip(indirect, zip(vfid, voff)))
            for j in range(n):
                key = prefix + keys[j]
                if j in loc:
                    fid, off = loc[j]
                    if fid >= len(files):
                        raise OcdbtError(f"{what}: value names data file "
                                         f"{fid} of {len(files)}")
                    self._entries[key] = ("file", files[fid], off, vlen[j])
                else:
                    self._entries[key] = ("inline", r.take(vlen[j]))
            if r.pos != len(body):
                raise OcdbtError(f"{what}: {len(body) - r.pos} bytes after "
                                 "the leaf's values")
            return
        common = r.varints(n)
        keys = _join_keys(r, kp, ks)
        cfid, coff, clen = r.varints(n), r.varints(n), r.varints(n)
        r.varints(3 * n)                     # statistics
        for j in range(n):
            if cfid[j] >= len(files):
                raise OcdbtError(f"{what}: child names data file "
                                 f"{cfid[j]} of {len(files)}")
            if common[j] > len(keys[j]):
                raise OcdbtError(f"{what}: subtree prefix longer than its "
                                 "key")
            self._walk(files[cfid[j]], coff[j], clen[j], height - 1,
                       prefix + keys[j][:common[j]])

    def keys(self) -> List[bytes]:
        return sorted(self._entries)

    def __contains__(self, key: bytes) -> bool:
        return key in self._entries

    def read(self, key: bytes) -> bytes:
        e = self._entries.get(key)
        if e is None:
            raise KeyError(key)
        if e[0] == "inline":
            return e[1]
        return self._read_file(e[1], e[2], e[3])

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        for k in self.keys():
            yield k, self.read(k)


def write(root: str, items: Dict[bytes, bytes]) -> None:
    """Write `items` as a new OCDBT store in the directory `root` (which
    must hold no manifest yet): one data file under `d/` holding the
    values longer than MAX_INLINE bytes and then the leaf node, and an
    uncompressed manifest naming that node as generation 1's root."""
    if os.path.exists(os.path.join(root, "manifest.ocdbt")):
        raise FileExistsError(os.path.join(root, "manifest.ocdbt"))
    keys = sorted(items)
    rel = f"d/{secrets.token_hex(16)}"
    table = _varint(1) + _varint(len(rel)) + _varint(0) + rel.encode()
    chunks, off, indirect = [], 0, []
    for k in keys:
        v = items[k]
        if len(v) > MAX_INLINE:
            indirect.append((k, off))
            chunks.append(v)
            off += len(v)
    n = len(keys)
    body = [b"\x00", table, _varint(n)]
    prev = b""
    prefix = []
    for k in keys:
        p = 0
        while p < min(len(prev), len(k)) and prev[p] == k[p]:
            p += 1
        prefix.append(p)
        prev = k
    body += [_varint(p) for p in prefix[1:]]
    body += [_varint(len(k) - p) for k, p in zip(keys, prefix)]
    body += [k[p:] for k, p in zip(keys, prefix)]
    body += [_varint(len(items[k])) for k in keys]
    ind = dict(indirect)
    body += [_varint(1 if k in ind else 0) for k in keys]
    body += [_varint(0) for _ in indirect]
    body += [_varint(o) for _, o in indirect]
    body += [items[k] for k in keys if k not in ind]
    node = _wrap(NODE_MAGIC, b"".join(body))
    os.makedirs(os.path.join(root, "d"), exist_ok=True)
    with open(os.path.join(root, rel), "wb") as f:
        for c in chunks:
            f.write(c)
        f.write(node)
    config = (secrets.token_bytes(16) + _varint(0) + _varint(MAX_INLINE)
              + _varint(max(100_000_000, len(node))) + bytes([4])
              + _varint(0))
    version = (_varint(1) + _varint(1) + b"\x00" + _varint(0) + _varint(off)
               + _varint(len(node)) + _varint(n) + _varint(len(node))
               + _varint(off) + struct.pack("<Q", time.time_ns()))
    manifest = _wrap(MANIFEST_MAGIC, config + table + version + _varint(0))
    tmp = os.path.join(root, "manifest.ocdbt.tmp")
    with open(tmp, "wb") as f:
        f.write(manifest)
    os.replace(tmp, os.path.join(root, "manifest.ocdbt"))


def read_all(root: str, store: Optional[Store] = None) -> Dict[bytes, bytes]:
    """Every key of the store at `root` with its value."""
    return dict((store or Store(root)).items())
