"""A read-only HDF5 reader, in pure Python over ``struct`` and numpy.

The JAX package reads Keras h5 files with ``h5py`` (``modelimport/keras/
importer.py::_read_h5``); the port depends on no HDF5 library. This module
reads the subset of the format that ``h5py`` writes with its default
(earliest) format settings, which is what Keras's h5 files use:

- superblock version 0 (sizes of offsets and lengths 2, 4 or 8 bytes);
- version-1 object headers, with continuation blocks;
- old-style groups: a symbol-table message over a version-1 B-tree
  (``TREE``), symbol-table nodes (``SNOD``) and a local heap (``HEAP``),
  walked in link-name order, the order of ``h5py``'s ``keys()`` and
  ``visititems``;
- the dataspace, datatype (fixed-point, IEEE float, fixed-length and
  variable-length strings), attribute, layout (version 3: compact and
  contiguous) and fill-value messages;
- the global heap (``GCOL``), which holds variable-length strings.

A contiguous dataset whose address is undefined (storage never
allocated) reads as its fill value, as HDF5 specifies. A file that is no
HDF5 file raises ``OSError``, as ``h5py`` does. Anything else raises
:class:`~.ir.ImportException` naming the message or feature met: a
filter pipeline, a chunked or virtual layout, new-style groups (link
messages, a fractal heap), dense attribute storage, a version-2 object
header (``OHDR``), a later superblock, shared messages, soft links.

Every contiguous dataset records where its layout's address field lies in
the file (:attr:`Dataset.address_field`), and the file where its
superblock's end-of-file address lies (:attr:`File.eof_field`), so that
a writer can append a dataset's bytes and point the file at them.
"""
from __future__ import annotations

import struct
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .ir import ImportException

_SIGNATURE = b"\x89HDF\r\n\x1a\n"

#: the messages a refusal names
_MESSAGE_NAMES = {
    0x0001: "dataspace", 0x0002: "link info", 0x0003: "datatype",
    0x0005: "fill value", 0x0006: "link", 0x0008: "data layout",
    0x000C: "attribute", 0x0011: "symbol table",
}

_CLASS_NAMES = {2: "time", 4: "bitfield", 5: "opaque", 6: "compound",
                7: "reference", 8: "enum", 10: "array"}


class _Type:
    """A decoded datatype: ``kind`` is ``"num"`` (numpy ``dtype``),
    ``"fstr"`` (fixed-length bytes of ``size``) or ``"vstr"``
    (variable-length string; ``utf8`` says its character set)."""

    __slots__ = ("kind", "dtype", "size", "utf8")

    def __init__(self, kind, dtype, size, utf8=False):
        self.kind, self.dtype, self.size, self.utf8 = kind, dtype, size, utf8


class _Reader:
    """The file's bytes and the superblock's sizes."""

    def __init__(self, buf):
        self.buf = buf
        base = 0
        while buf[base:base + 8] != _SIGNATURE:
            base = 512 if base == 0 else base * 2
            if base + 8 > len(buf):
                # h5py's error for a file that is no HDF5 at all
                raise OSError("not an HDF5 file (file signature not "
                              "found)")
        version = buf[base + 8]
        if version != 0:
            raise ImportException(
                f"HDF5 superblock version {version} is unsupported (only "
                "version 0, the earliest format h5py writes by default)")
        self.so, self.sl = buf[base + 13], buf[base + 14]
        if self.so not in (2, 4, 8) or self.sl not in (2, 4, 8):
            raise ImportException(
                f"HDF5 sizes of offsets / lengths {self.so} / {self.sl} "
                "are unsupported")
        self._fo = {2: "<H", 4: "<I", 8: "<Q"}[self.so]
        self._fl = {2: "<H", 4: "<I", 8: "<Q"}[self.sl]
        self.undefined = (1 << (8 * self.so)) - 1
        p = base + 24
        self.base = base + self.offset(p)
        self.eof_field = p + 2 * self.so
        self.root_entry = p + 4 * self.so
        self._gheaps: Dict[int, Dict[int, bytes]] = {}

    def u8(self, p):
        return self.buf[p]

    def u16(self, p):
        return struct.unpack_from("<H", self.buf, p)[0]

    def u32(self, p):
        return struct.unpack_from("<I", self.buf, p)[0]

    def offset(self, p):
        return struct.unpack_from(self._fo, self.buf, p)[0]

    def length(self, p):
        return struct.unpack_from(self._fl, self.buf, p)[0]

    def address(self, p) -> Optional[int]:
        """An address field as an absolute file position, None when
        undefined."""
        a = self.offset(p)
        return None if a == self.undefined else self.base + a

    def cstring(self, p) -> bytes:
        end = self.buf.index(b"\0", p)
        return bytes(self.buf[p:end])

    # -- global heap -----------------------------------------------------
    def gheap_object(self, addr: int, index: int) -> bytes:
        coll = self._gheaps.get(addr)
        if coll is None:
            if self.buf[addr:addr + 4] != b"GCOL":
                raise ImportException(
                    f"no global heap collection (GCOL) at {addr}")
            size = self.length(addr + 8)
            end, p, coll = addr + size, addr + 8 + self.sl, {}
            while p + 8 + self.sl <= end:
                idx = self.u16(p)
                if idx == 0:                 # the free space: the end
                    break
                n = self.length(p + 8)
                data = p + 8 + self.sl
                coll[idx] = bytes(self.buf[data:data + n])
                p = data + ((n + 7) & ~7)
            self._gheaps[addr] = coll
        try:
            return coll[index]
        except KeyError:
            raise ImportException(
                f"global heap object {index} missing at {addr}") from None


def _pad8(n: int) -> int:
    return (n + 7) & ~7


def _datatype(r: _Reader, p: int) -> _Type:
    cv = r.u8(p)
    cls, version = cv & 0x0F, cv >> 4
    bits = r.u8(p + 1) | (r.u8(p + 2) << 8) | (r.u8(p + 3) << 16)
    size = r.u32(p + 4)
    if cls == 0:                                   # fixed-point
        order = ">" if bits & 1 else "<"
        kind = "i" if bits & 0x08 else "u"
        if size not in (1, 2, 4, 8) or r.u16(p + 8) != 0 \
                or r.u16(p + 10) != 8 * size:
            raise ImportException(
                f"HDF5 fixed-point datatype of {size} bytes with bit "
                f"offset {r.u16(p + 8)} / precision {r.u16(p + 10)} is "
                "unsupported")
        return _Type("num", np.dtype(f"{order}{kind}{size}"), size)
    if cls == 1:                                   # IEEE float
        if bits & 0x40:
            raise ImportException("HDF5 VAX-order float is unsupported")
        if size not in (2, 4, 8):
            raise ImportException(
                f"HDF5 float datatype of {size} bytes is unsupported")
        order = ">" if bits & 1 else "<"
        return _Type("num", np.dtype(f"{order}f{size}"), size)
    if cls == 3:                                   # fixed-length string
        return _Type("fstr", np.dtype(f"S{size}"), size,
                     utf8=((bits >> 4) & 0x0F) == 1)
    if cls == 9:                                   # variable-length
        if bits & 0x0F != 1:
            raise ImportException(
                "HDF5 variable-length sequence datatype is unsupported "
                "(only variable-length strings)")
        return _Type("vstr", np.dtype(object), size,
                     utf8=((bits >> 8) & 0x0F) == 1)
    raise ImportException(
        f"HDF5 {_CLASS_NAMES.get(cls, f'class-{cls}')} datatype (class "
        f"{cls}, version {version}) is unsupported")


def _dataspace(r: _Reader, p: int) -> Optional[Tuple[int, ...]]:
    """The shape; () for a scalar, None for a null dataspace."""
    version, ndims, flags = r.u8(p), r.u8(p + 1), r.u8(p + 2)
    if version == 1:
        q = p + 8
    elif version == 2:
        if r.u8(p + 3) == 2:
            return None
        q = p + 4
    else:
        raise ImportException(
            f"HDF5 dataspace message version {version} is unsupported")
    return tuple(r.length(q + i * r.sl) for i in range(ndims))


def _values(r: _Reader, t: _Type, shape, raw) -> np.ndarray:
    """``raw`` bytes of ``shape`` elements of ``t`` as a native array."""
    n = int(np.prod(shape, dtype=np.int64))
    if t.kind == "num":
        a = np.frombuffer(raw, t.dtype, count=n).astype(
            t.dtype.newbyteorder("="))
    elif t.kind == "fstr":
        a = np.frombuffer(raw, t.dtype, count=n).copy()
    else:
        step = 4 + r.so + 4
        out = []
        for i in range(n):
            q = i * step
            nbytes = struct.unpack_from("<I", raw, q)[0]
            addr = struct.unpack_from(r._fo, raw, q + 4)[0]
            index = struct.unpack_from("<I", raw, q + 4 + r.so)[0]
            data = b"" if nbytes == 0 and addr == 0 else \
                r.gheap_object(r.base + addr, index)[:nbytes]
            out.append(data.decode("utf-8" if t.utf8 else "ascii"))
        a = np.empty(n, object)
        a[:] = out
    return a.reshape(shape)


def _scalar_or_array(a: np.ndarray):
    """h5py's reading of an attribute: a scalar comes back as one value
    (``str`` for a variable-length string), an array as an array."""
    if a.shape == ():
        return a[()]
    return a


class _Object:
    """An object header: its messages by type, in file order."""

    def __init__(self, r: _Reader, addr: int, name: str):
        self.r, self.addr, self.name = r, addr, name
        if r.buf[addr:addr + 4] == b"OHDR":
            raise ImportException(
                f"{name!r}: version-2 object header (OHDR) is unsupported "
                "(only version-1 headers, h5py's earliest format)")
        version = r.u8(addr)
        if version != 1:
            raise ImportException(
                f"{name!r}: object header version {version} is "
                "unsupported")
        self.messages: List[Tuple[int, int, int, int]] = []
        blocks = [(addr + 16, r.u32(addr + 8))]
        while blocks:
            start, size = blocks.pop(0)
            p, end = start, start + size
            while p + 8 <= end:
                mtype, msize, flags = r.u16(p), r.u16(p + 2), r.u8(p + 4)
                if mtype == 0x0010:
                    blocks.append((r.address(p + 8), r.length(p + 8 + r.so)))
                elif mtype != 0:
                    self.messages.append((mtype, flags, p + 8, msize))
                p += 8 + msize
        for mtype, flags, p, _ in self.messages:
            what = _MESSAGE_NAMES.get(mtype, f"type-{mtype:#06x}")
            if mtype in (0x0001, 0x0003, 0x0005, 0x0008, 0x000C,
                         0x0011) and flags & 0x02:
                raise ImportException(
                    f"{name!r}: shared {what} message is unsupported")
            if mtype == 0x000B:
                raise ImportException(
                    f"{name!r}: filter pipeline message (compression or "
                    "other filters) is unsupported")
            if mtype in (0x0002, 0x0006):
                raise ImportException(
                    f"{name!r}: {what} message (a new-style group, links "
                    "in the header or a fractal heap) is unsupported")
            if mtype == 0x0007:
                raise ImportException(
                    f"{name!r}: external data files message is "
                    "unsupported")
            if mtype == 0x0015:
                flags_ = r.u8(p + 1)
                q = p + 2 + (2 if flags_ & 0x01 else 0)
                if r.address(q) is not None:
                    raise ImportException(
                        f"{name!r}: dense attribute storage (attribute "
                        "info message with a fractal heap) is unsupported")

    def first(self, mtype: int) -> Optional[int]:
        for t, _, p, _ in self.messages:
            if t == mtype:
                return p
        return None

    def attrs(self) -> Dict[str, object]:
        r, out = self.r, {}
        for t, _, p, _ in self.messages:
            if t != 0x000C:
                continue
            version = r.u8(p)
            if version not in (1, 2, 3):
                raise ImportException(
                    f"{self.name!r}: attribute message version {version} "
                    "is unsupported")
            if version > 1 and r.u8(p + 1) & 0x03:
                raise ImportException(
                    f"{self.name!r}: attribute with a shared datatype or "
                    "dataspace is unsupported")
            nsize, tsize, ssize = r.u16(p + 2), r.u16(p + 4), r.u16(p + 6)
            pad = _pad8 if version == 1 else (lambda n: n)
            q = p + (9 if version == 3 else 8)
            name = r.cstring(q).decode(
                "utf-8" if version == 3 and r.u8(p + 8) == 1 else "ascii")
            q += pad(nsize)
            dtype = _datatype(r, q)
            q += pad(tsize)
            shape = _dataspace(r, q)
            q += pad(ssize)
            if shape is None:
                raise ImportException(
                    f"{self.name!r}: attribute {name!r} has a null "
                    "dataspace (an empty attribute), unsupported")
            n = int(np.prod(shape, dtype=np.int64))
            width = 4 + r.so + 4 if dtype.kind == "vstr" else dtype.size
            raw = bytes(r.buf[q:q + n * width])
            out[name] = _scalar_or_array(_values(r, dtype, shape, raw))
        return dict(sorted(out.items()))


class Dataset:
    """A dataset: ``shape``, ``dtype``, ``attrs`` and :meth:`read`
    (``np.array(ds)`` reads it too). A contiguous dataset's
    ``address_field`` is the file position of its layout's address and
    ``data_address`` the absolute position of its bytes (None when never
    allocated)."""

    def __init__(self, obj: _Object):
        r, self._obj, self._r = obj.r, obj, obj.r
        self.name = obj.name
        p = obj.first(0x0003)
        if p is None:
            raise ImportException(f"{self.name!r}: dataset with no "
                                  "datatype message")
        self._type = _datatype(r, p)
        self.dtype = (self._type.dtype.newbyteorder("=")
                      if self._type.kind == "num" else self._type.dtype)
        p = obj.first(0x0001)
        self.shape = _dataspace(r, p) if p is not None else None
        if self.shape is None:
            raise ImportException(f"{self.name!r}: dataset with a null "
                                  "dataspace is unsupported")
        self._fill = self._fill_value(obj)
        self.layout, self.address_field = None, None
        self.data_address, self._compact = None, None
        self._layout(obj.first(0x0008))

    @property
    def attrs(self) -> Dict[str, object]:
        return self._obj.attrs()

    @property
    def size(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    def _fill_value(self, obj) -> Optional[bytes]:
        """The fill value message's bytes, None when it defines none."""
        r = self._r
        p = obj.first(0x0005)
        if p is None:
            return None
        version = r.u8(p)
        if version in (1, 2):
            if version == 1 or r.u8(p + 3):
                n = r.u32(p + 4)
                return bytes(r.buf[p + 8:p + 8 + n]) or None
            return None
        if version == 3:
            if r.u8(p + 1) & 0x20:
                n = r.u32(p + 2)
                return bytes(r.buf[p + 6:p + 6 + n]) or None
            return None
        raise ImportException(f"{self.name!r}: fill value message "
                              f"version {version} is unsupported")

    def _layout(self, p):
        r = self._r
        if p is None:
            raise ImportException(f"{self.name!r}: dataset with no data "
                                  "layout message")
        version, cls = r.u8(p), r.u8(p + 1)
        if version != 3:
            raise ImportException(
                f"{self.name!r}: data layout message version {version} "
                "is unsupported (only version 3)")
        if cls == 0:
            self.layout, self._compact = "compact", (p + 4, r.u16(p + 2))
        elif cls == 1:
            self.layout, self.address_field = "contiguous", p + 2
            self.data_address = r.address(p + 2)
        else:
            kind = {2: "chunked", 3: "virtual"}.get(cls, f"class-{cls}")
            raise ImportException(
                f"{self.name!r}: {kind} data layout is unsupported (only "
                "contiguous and compact datasets)")

    def read(self) -> np.ndarray:
        r, t, n = self._r, self._type, self.size
        width = 4 + r.so + 4 if t.kind == "vstr" else t.size
        if self._compact is not None:
            start, size = self._compact
            raw = bytes(r.buf[start:start + size])
        elif self.data_address is None:
            if t.kind == "vstr":
                raise ImportException(
                    f"{self.name!r}: unallocated variable-length string "
                    "dataset is unsupported")
            fill = self._fill or bytes(width)
            raw = fill[:width].ljust(width, b"\0") * n
        else:
            raw = r.buf[self.data_address:self.data_address + n * width]
            if len(raw) < n * width:
                raise ImportException(
                    f"{self.name!r}: the file ends inside the dataset's "
                    "data (a truncated file)")
        return _values(r, t, self.shape, raw)

    def __array__(self, dtype=None, copy=None):
        a = self.read()
        return a if dtype is None else a.astype(dtype)


class Group:
    """An old-style (symbol-table) group: ``keys()``, ``group[path]``,
    ``path in group``, ``attrs`` and ``visititems``, as ``h5py`` gives
    them (link-name order)."""

    def __init__(self, obj: _Object):
        self._obj, self._r, self.name = obj, obj.r, obj.name
        p = obj.first(0x0011)
        if p is None:
            raise ImportException(
                f"{self.name!r}: group without a symbol table message "
                "(a new-style group) is unsupported")
        self._btree = self._r.address(p)
        self._heap = self._r.address(p + self._r.so)
        self._links: Optional[Dict[str, int]] = None

    @property
    def attrs(self) -> Dict[str, object]:
        return self._obj.attrs()

    def _child_path(self, key: str) -> str:
        return key if self.name == "/" else f"{self.name}/{key}"

    def links(self) -> Dict[str, int]:
        """Link name -> object header address, in link-name order."""
        if self._links is None:
            r = self._r
            heap = self._heap
            if r.buf[heap:heap + 4] != b"HEAP":
                raise ImportException(
                    f"{self.name!r}: no local heap (HEAP) at {heap}")
            data = r.address(heap + 8 + 2 * r.sl)
            found: List[Tuple[bytes, int]] = []
            self._walk(self._btree, data, found)
            self._links = {k.decode("utf-8"): a for k, a in sorted(found)}
        return self._links

    def _walk(self, node: Optional[int], heap_data: int, found):
        r = self._r
        if node is None:
            return
        if r.buf[node:node + 4] != b"TREE":
            raise ImportException(
                f"{self.name!r}: no v1 B-tree node (TREE) at {node}")
        if r.u8(node + 4) != 0:
            raise ImportException(
                f"{self.name!r}: a chunk B-tree where a group's was "
                "expected")
        level, used = r.u8(node + 5), r.u16(node + 6)
        p = node + 8 + 2 * r.so + r.sl        # past the siblings and key 0
        for _ in range(used):
            child = r.address(p)
            if level > 0:
                self._walk(child, heap_data, found)
            else:
                self._snod(child, heap_data, found)
            p += r.so + r.sl
        return

    def _snod(self, node, heap_data, found):
        r = self._r
        if r.buf[node:node + 4] != b"SNOD":
            raise ImportException(
                f"{self.name!r}: no symbol table node (SNOD) at {node}")
        n = r.u16(node + 6)
        entry = 2 * r.so + 24
        for i in range(n):
            p = node + 8 + i * entry
            name = r.cstring(heap_data + r.offset(p))
            if r.u32(p + 2 * r.so) == 2:
                raise ImportException(
                    f"{self.name!r}: soft link {name.decode()!r} is "
                    "unsupported (hard links only)")
            found.append((name, r.address(p + r.so)))

    def keys(self) -> List[str]:
        return list(self.links())

    def _child(self, key: str):
        addr = self.links().get(key)
        if addr is None:
            raise KeyError(f"{key!r} not in h5 group {self.name!r}")
        return _open(self._r, addr, self._child_path(key))

    def __getitem__(self, path: str):
        node = self
        for part in [s for s in path.split("/") if s]:
            if not isinstance(node, Group):
                raise KeyError(f"{path!r}: {node.name!r} is a dataset")
            node = node._child(part)
        return node

    def __contains__(self, path: str) -> bool:
        try:
            self[path]
        except KeyError:
            return False
        return True

    def visititems(self, fn: Callable[[str, object], object]):
        """``fn(name, obj)`` for every object below this group, depth
        first, each group's links in name order, each object once (as
        ``h5py``'s ``visititems``); a value other than None stops the
        walk and is returned."""
        seen = {self._obj.addr}

        def visit(group: Group, prefix: str):
            for key, addr in group.links().items():
                if addr in seen:
                    continue
                seen.add(addr)
                name = f"{prefix}{key}"
                obj = _open(self._r, addr, group._child_path(key))
                ret = fn(name, obj)
                if ret is not None:
                    return ret
                if isinstance(obj, Group):
                    ret = visit(obj, name + "/")
                    if ret is not None:
                        return ret
            return None

        return visit(self, "")


def _open(r: _Reader, addr: int, name: str):
    obj = _Object(r, addr, name)
    if obj.first(0x0008) is not None:
        return Dataset(obj)
    if obj.first(0x0011) is not None:
        return Group(obj)
    raise ImportException(
        f"{name!r}: an object that is neither an old-style group nor a "
        "dataset (a committed datatype?) is unsupported")


class File(Group):
    """An HDF5 file from a path or its bytes: the root :class:`Group`.
    ``eof_field`` is the file position of the superblock's end-of-file
    address, ``base`` the base address that every address field is
    relative to."""

    def __init__(self, path_or_bytes):
        if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
            buf = bytes(path_or_bytes)
        else:
            with open(path_or_bytes, "rb") as f:
                buf = f.read()
        r = _Reader(buf)
        self.eof_field, self.base = r.eof_field, r.base
        root = r.address(r.root_entry + r.so)
        super().__init__(_Object(r, root, "/"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def datasets(self) -> List[Dataset]:
        """Every dataset of the file, in ``visititems`` order."""
        out: List[Dataset] = []
        self.visititems(lambda _, o: out.append(o)
                        if isinstance(o, Dataset) else None)
        return out
