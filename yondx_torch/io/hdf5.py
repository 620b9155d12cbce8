"""A reader of the HDF5 subset that MATLAB v7.3 files and the HDF5
library's earliest file format (its default) use, for DND's `.mat` files
and `core/io`'s v7.3 branch, with no HDF5 package.

What it reads:
- a user block of 0 or 512, 1024, 2048, ... bytes (the signature is
  searched for at those offsets; MATLAB writes its text header there);
- superblock versions 0 and 1 (addresses relative to the base address);
- version 1 object headers, with continuation messages;
- groups as symbol tables: a v1 B-tree of type 0 over SNOD nodes, names in
  a local heap;
- datasets: the dataspace, datatype, data layout (version 3) and filter
  pipeline messages. Datatypes: fixed-point and IEEE float of either byte
  order, and object references. Layouts: compact, contiguous, and chunked
  through a v1 B-tree of type 1. Filters: deflate (id 1, through zlib)
  and shuffle (id 2);
- attributes and other messages are skipped; object references are
  dereferenced with `File.deref` (or `file[ref]`).

Anything else raises Hdf5Error naming it: superblock versions 2 and 3,
version 2 object headers, link-message and fractal-heap groups, soft or
external links, other datatypes, layouts or filters.

    with File(path) as f:
        x = f["info"]["boundingboxes"][()]    # numpy array (refs: Reference)
        box = f[x[0, 0]][()]                  # the referenced dataset
"""
from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Optional

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEFINED = (1 << 64) - 1


class Hdf5Error(ValueError):
    """A file outside the subset this reader takes, or a corrupt one."""


class Reference:
    """An HDF5 object reference: the referenced object header's address."""

    def __init__(self, addr: int):
        self.addr = addr

    def __eq__(self, other):
        return isinstance(other, Reference) and other.addr == self.addr

    def __hash__(self):
        return hash(self.addr)

    def __repr__(self):
        return f"<HDF5 object reference {self.addr:#x}>"


class _Msg:
    __slots__ = ("type", "data")

    def __init__(self, mtype: int, data: bytes):
        self.type, self.data = mtype, data


_SKIPPED = {0x0000, 0x0004, 0x0005, 0x000C, 0x000D, 0x000E, 0x0012,
            0x0013, 0x0015, 0x0016, 0x0014}
_NAMES = {0x0002: "link info message (a v2 group: link messages or a "
                  "fractal heap)",
          0x0006: "link message (a v2 group)",
          0x000A: "group info message (a v2 group)",
          0x0007: "external data files message",
          0x000F: "shared message table",
          0x0017: "B-tree 'K' values message",
          0x0018: "driver info message"}


class File:
    """An HDF5 file opened for reading: `f[name]` (or a path "a/b") gives
    a Group or Dataset, `f[ref]` the object a Reference names."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        try:
            self._open_superblock()
            self.root = Group(self, self._root_addr, "/")
        except Exception:
            self._f.close()
            raise

    # ---------------------------------------------------------- low level
    def _read(self, addr: int, n: int) -> bytes:
        self._f.seek(self.base + addr)
        data = self._f.read(n)
        if len(data) != n:
            raise Hdf5Error(f"{self.path}: {n} bytes at {addr:#x} run past "
                            "the end of the file")
        return data

    def _open_superblock(self):
        f, pos = self._f, 0
        size = f.seek(0, 2)
        while True:
            f.seek(pos)
            if f.read(8) == SIGNATURE:
                break
            pos = 512 if pos == 0 else pos * 2
            if pos + 8 > size:
                raise Hdf5Error(f"{self.path}: no HDF5 signature at 0 or at "
                                "512 * 2^n")
        f.seek(pos)
        head = f.read(24)
        version = head[8]
        if version not in (0, 1):
            raise Hdf5Error(f"{self.path}: superblock version {version} "
                            "(only 0 and 1 are read)")
        offsets, lengths = head[13], head[14]
        if offsets != 8 or lengths != 8:
            raise Hdf5Error(f"{self.path}: size of offsets {offsets} and "
                            f"lengths {lengths} (only 8 and 8 are read)")
        f.read(4 if version == 1 else 0)    # indexed storage K, reserved
        f.read(32)           # base, free-space, end-of-file, driver info
        self.base = pos      # as the HDF5 library takes it
        entry = f.read(40)
        cache = struct.unpack("<I", entry[16:20])[0]
        if cache == 2:
            raise Hdf5Error(f"{self.path}: the root is a soft link")
        self._root_addr = struct.unpack("<Q", entry[8:16])[0]

    def _messages(self, addr: int) -> List[_Msg]:
        head = self._read(addr, 16)
        if head[:4] == b"OHDR":
            raise Hdf5Error(f"{self.path}: version 2 object header at "
                            f"{addr:#x} (only version 1 is read)")
        if head[0] != 1:
            raise Hdf5Error(f"{self.path}: object header version {head[0]} "
                            f"at {addr:#x} (only 1 is read)")
        nmsg, _, size = struct.unpack("<HII", head[2:12])
        blocks = [(addr + 16, size)]
        out: List[_Msg] = []
        while blocks and len(out) < nmsg:
            start, length = blocks.pop(0)
            buf = self._read(start, length)
            p = 0
            while p + 8 <= length and len(out) < nmsg:
                mtype, msize, flags = struct.unpack("<HHB", buf[p:p + 5])
                data = buf[p + 8:p + 8 + msize]
                p += 8 + msize
                if flags & 0x02:
                    raise Hdf5Error(f"{self.path}: shared message (type "
                                    f"{mtype:#06x}) at {addr:#x}")
                if mtype == 0x0010:
                    caddr, clen = struct.unpack("<QQ", data[:16])
                    blocks.append((caddr, clen))
                out.append(_Msg(mtype, data))
        return out

    def _object(self, addr: int, name: str):
        msgs = self._messages(addr)
        types = {m.type for m in msgs}
        for t in types:
            if t in _NAMES:
                raise Hdf5Error(f"{self.path}: {name}: {_NAMES[t]} "
                                "(not read)")
        if 0x0011 in types:
            return Group(self, addr, name, msgs)
        if 0x0008 in types:
            return Dataset(self, addr, name, msgs)
        raise Hdf5Error(f"{self.path}: {name}: object header at {addr:#x} "
                        "is neither a symbol-table group nor a dataset")

    # ---------------------------------------------------------- public
    def __getitem__(self, key):
        if isinstance(key, Reference):
            return self.deref(key)
        return self.root[key]

    def __contains__(self, key: str) -> bool:
        return key in self.root

    def keys(self) -> List[str]:
        return self.root.keys()

    def deref(self, ref: Reference):
        if not isinstance(ref, Reference):
            raise TypeError(f"not an object reference: {ref!r}")
        if ref.addr == UNDEFINED or ref.addr == 0:
            raise Hdf5Error(f"{self.path}: null object reference")
        return self._object(ref.addr, f"<ref {ref.addr:#x}>")

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Group:
    """A symbol-table group: `g[name]`, `name in g`, `g.keys()` (sorted,
    as the B-tree holds them)."""

    def __init__(self, f: File, addr: int, name: str,
                 msgs: Optional[List[_Msg]] = None):
        self.file, self.addr, self.name = f, addr, name
        msgs = f._messages(addr) if msgs is None else msgs
        st = [m for m in msgs if m.type == 0x0011]
        if not st:
            raise Hdf5Error(f"{f.path}: {name}: no symbol table message "
                            "(v2 groups are not read)")
        btree, heap = struct.unpack("<QQ", st[0].data[:16])
        self._links = self._read_links(btree, heap)

    def _read_links(self, btree: int, heap: int) -> Dict[str, int]:
        f = self.file
        hh = f._read(heap, 32)
        if hh[:4] != b"HEAP":
            raise Hdf5Error(f"{f.path}: {self.name}: bad local heap")
        seg_size, _, seg_addr = struct.unpack("<QQQ", hh[8:32])
        seg = f._read(seg_addr, seg_size)

        def name_at(off: int) -> str:
            end = seg.index(b"\x00", off)
            return seg[off:end].decode()

        links: Dict[str, int] = {}
        todo = [btree]
        while todo:
            node = todo.pop()
            head = f._read(node, 24)
            if head[:4] != b"TREE" or head[4] != 0:
                raise Hdf5Error(f"{f.path}: {self.name}: group B-tree node "
                                f"at {node:#x} is not a type-0 TREE")
            level, used = head[5], struct.unpack("<H", head[6:8])[0]
            body = f._read(node + 24, 8 * (2 * used + 1))
            kids = [struct.unpack("<Q", body[8 + 16 * i:16 + 16 * i])[0]
                    for i in range(used)]
            if level > 0:
                todo += kids
                continue
            for snod in kids:
                sh = f._read(snod, 8)
                if sh[:4] != b"SNOD":
                    raise Hdf5Error(f"{f.path}: {self.name}: bad symbol "
                                    "table node")
                n = struct.unpack("<H", sh[6:8])[0]
                ents = f._read(snod + 8, 40 * n)
                for i in range(n):
                    e = ents[40 * i:40 * i + 40]
                    noff, oh, cache = struct.unpack("<QQI", e[:20])
                    if cache == 2:
                        raise Hdf5Error(f"{f.path}: {self.name}/"
                                        f"{name_at(noff)}: soft link (not "
                                        "read)")
                    links[name_at(noff)] = oh
        return links

    def keys(self) -> List[str]:
        return sorted(self._links)

    def __contains__(self, key: str) -> bool:
        head, _, rest = key.strip("/").partition("/")
        if head not in self._links:
            return False
        return not rest or rest in self[head]

    def __getitem__(self, key: str):
        key = key.strip("/")
        head, _, rest = key.partition("/")
        if head not in self._links:
            raise KeyError(f"{self.name}: no member {head!r}")
        path = f"{self.name.rstrip('/')}/{head}"
        obj = self.file._object(self._links[head], path)
        return obj[rest] if rest else obj


def _dtype(data: bytes, where: str):
    """-> (numpy dtype, is_reference) of a datatype message."""
    cls = data[0] & 15
    bits = data[1] | (data[2] << 8) | (data[3] << 16)
    size = struct.unpack("<I", data[4:8])[0]
    if cls == 0:                                    # fixed-point
        order = ">" if bits & 1 else "<"
        kind = "i" if bits & 8 else "u"
        if size not in (1, 2, 4, 8):
            raise Hdf5Error(f"{where}: {size}-byte integers (not read)")
        return np.dtype(f"{order}{kind}{size}"), False
    if cls == 1:                                    # IEEE float
        if bits & 0x40:
            raise Hdf5Error(f"{where}: VAX float byte order (not read)")
        if size not in (2, 4, 8):
            raise Hdf5Error(f"{where}: {size}-byte floats (not read)")
        return np.dtype(f"{'>' if bits & 1 else '<'}f{size}"), False
    if cls == 7:                                    # reference
        if bits & 15 != 0:
            raise Hdf5Error(f"{where}: region references (not read)")
        return np.dtype("<u8"), True
    names = {2: "time", 3: "string", 4: "bitfield", 5: "opaque",
             6: "compound", 8: "enumerated", 9: "variable-length",
             10: "array"}
    raise Hdf5Error(f"{where}: {names.get(cls, f'class {cls}')} datatype "
                    "(not read)")


class Dataset:
    """A dataset: `.shape`, `.dtype`, `ds[()]` (or `np.asarray(ds)`) reads
    it whole; object references come back as an object array of
    Reference."""

    def __init__(self, f: File, addr: int, name: str, msgs: List[_Msg]):
        self.file, self.addr, self.name = f, addr, name
        where = f"{f.path}: {name}"
        by = {}
        for m in msgs:
            by.setdefault(m.type, m)
            if m.type not in _SKIPPED and m.type not in (
                    0x0001, 0x0003, 0x0008, 0x000B, 0x0010):
                raise Hdf5Error(f"{where}: header message type "
                                f"{m.type:#06x} (not read)")
        if 0x0001 not in by or 0x0003 not in by:
            raise Hdf5Error(f"{where}: dataset without a dataspace or a "
                            "datatype")
        self.shape = self._dataspace(by[0x0001].data, where)
        self._dt, self.is_reference = _dtype(by[0x0003].data, where)
        self.dtype = np.dtype(object) if self.is_reference else self._dt
        self._layout = by[0x0008].data
        self._filters = self._pipeline(by[0x000B].data, where) \
            if 0x000B in by else []
        self._where = where

    @staticmethod
    def _dataspace(d: bytes, where: str):
        version, rank = d[0], d[1]
        if version == 1:
            p = 8
        elif version == 2:
            if d[3] == 2:
                raise Hdf5Error(f"{where}: null dataspace (not read)")
            p = 4
        else:
            raise Hdf5Error(f"{where}: dataspace version {version} "
                            "(not read)")
        return tuple(struct.unpack(f"<{rank}Q", d[p:p + 8 * rank]))

    @staticmethod
    def _pipeline(d: bytes, where: str):
        version, n = d[0], d[1]
        p = 8 if version == 1 else 2
        out = []
        for _ in range(n):
            fid, = struct.unpack("<H", d[p:p + 2])
            p += 2
            namelen = 0
            if version == 1 or fid >= 256:
                namelen, = struct.unpack("<H", d[p:p + 2])
                p += 2
            flags, nval = struct.unpack("<HH", d[p:p + 4])
            p += 4
            if version == 1:
                namelen = (namelen + 7) // 8 * 8
            p += namelen
            vals = struct.unpack(f"<{nval}I", d[p:p + 4 * nval])
            p += 4 * nval
            if version == 1 and nval % 2:
                p += 4
            if fid not in (1, 2):
                raise Hdf5Error(f"{where}: filter {fid} (only deflate 1 "
                                "and shuffle 2 are read)")
            out.append((fid, flags, vals))
        return out

    def _unfilter(self, raw: bytes, mask: int) -> bytes:
        for i in range(len(self._filters) - 1, -1, -1):
            if mask & (1 << i):
                continue
            fid = self._filters[i][0]
            if fid == 1:
                raw = zlib.decompress(raw)
            else:
                size = self._dt.itemsize
                a = np.frombuffer(raw, np.uint8)
                n = a.size // size
                head = a[:n * size].reshape(size, n).T.reshape(-1)
                raw = head.tobytes() + a[n * size:].tobytes()
        return raw

    def _raw(self) -> np.ndarray:
        f, d = self.file, self._layout
        version, cls = d[0], d[1]
        if version != 3:
            raise Hdf5Error(f"{self._where}: data layout version {version} "
                            "(only 3 is read)")
        count = int(np.prod(self.shape, dtype=np.int64))
        nbytes = count * self._dt.itemsize
        if cls == 0:                                    # compact
            size, = struct.unpack("<H", d[2:4])
            return np.frombuffer(d[4:4 + size], self._dt)[:count] \
                .reshape(self.shape)
        if cls == 1:                                    # contiguous
            addr, size = struct.unpack("<QQ", d[2:18])
            if addr == UNDEFINED:
                return np.zeros(self.shape, self._dt)
            return np.frombuffer(f._read(addr, nbytes), self._dt) \
                .reshape(self.shape)
        if cls != 2:
            raise Hdf5Error(f"{self._where}: layout class {cls} (not read)")
        rank = d[2]
        btree, = struct.unpack("<Q", d[3:11])
        cdims = struct.unpack(f"<{rank}I", d[11:11 + 4 * rank])[:-1]
        out = np.zeros(self.shape, self._dt)
        if btree == UNDEFINED:
            return out
        csize = int(np.prod(cdims, dtype=np.int64)) * self._dt.itemsize
        todo = [btree]
        while todo:
            node = todo.pop()
            head = f._read(node, 24)
            if head[:4] != b"TREE" or head[4] != 1:
                raise Hdf5Error(f"{self._where}: chunk B-tree node at "
                                f"{node:#x} is not a type-1 TREE")
            level, used = head[5], struct.unpack("<H", head[6:8])[0]
            ksize = 8 + 8 * rank
            body = f._read(node + 24, (ksize + 8) * used + ksize)
            for i in range(used):
                k = body[(ksize + 8) * i:(ksize + 8) * i + ksize]
                child, = struct.unpack(
                    "<Q", body[(ksize + 8) * i + ksize:(ksize + 8) * (i + 1)])
                if level > 0:
                    todo.append(child)
                    continue
                size, mask = struct.unpack("<II", k[:8])
                offs = struct.unpack(f"<{rank}Q", k[8:8 + 8 * rank])[:-1]
                raw = self._unfilter(f._read(child, size), mask)
                if len(raw) != csize:
                    raise Hdf5Error(f"{self._where}: chunk of {len(raw)} "
                                    f"bytes, expected {csize}")
                block = np.frombuffer(raw, self._dt).reshape(cdims)
                sl = tuple(slice(o, min(o + c, s))
                           for o, c, s in zip(offs, cdims, self.shape))
                out[sl] = block[tuple(slice(0, s.stop - s.start)
                                      for s in sl)]
        return out

    def __getitem__(self, key):
        if key != () and key != Ellipsis:
            return self[()][key]
        a = self._raw()
        if self.is_reference:
            refs = np.empty(a.shape, object)
            for i, v in np.ndenumerate(a.astype(np.uint64)):
                refs[i] = Reference(int(v))
            return refs
        return a.copy()              # in the stored byte order

    def __array__(self, dtype=None, copy=None):
        a = self[()]
        return a if dtype is None else a.astype(dtype)
