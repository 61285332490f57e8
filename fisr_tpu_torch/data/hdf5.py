"""A minimal HDF5 reader and writer (numpy and the stdlib's zlib), for the
MATLAB v7.3 .mat files of the FISR corpora (data/matio).

A v7.3 .mat file is an HDF5 file behind a 512-byte userblock. The corpora
come from three writers: MATLAB's `save -v7.3` (the LR and HR training
sets), hdf5storage with matlab_compatible (the warp .mat files of
FISR_for_video_warp_img_with_flo.py:131-137: chunked, gzip 7 + shuffle +
fletcher32) and h5py at its defaults (the JAX package's writer). All three
write the file format's earliest structures, and that is all this reader
takes:

* the superblock, version 0 or 1, found at 0, 512, 1024, 2048, ...; every
  address in the file is relative to where it was found;
* object headers version 1, continuation messages included;
* groups stored as a symbol table (the version-1 B-tree of group nodes,
  symbol-table nodes and the local heap);
* simple and scalar dataspaces;
* fixed-point and IEEE float datatypes in either byte order, and
  fixed-length strings (attributes such as MATLAB_class);
* data layout message version 3: compact, contiguous, and chunked with a
  version-1 B-tree index (edge chunks are stored full size and cropped);
  chunks never written read as the fill value;
* the filters deflate (1), shuffle (2) and fletcher32 (3), whose checksum is
  verified.

Anything else raises NotImplementedError naming the feature (superblock
version 2/3 and object header version 2 of libver='latest', link messages,
other chunk indexes, other filters, committed and variable-length types),
so the reader never returns bytes it did not understand.

Contiguous data is read with np.fromfile straight into the array that is
returned; a chunk is read, unfiltered and copied into its place in an
output array allocated once, so no more than one chunk is held besides it.

`write` stores float32 arrays as contiguous datasets with fixed-length
string attributes in a root symbol-table group behind an optional userblock,
the structures h5py writes at its defaults, and streams each array to disk
with ndarray.tofile.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

__all__ = ["File", "Group", "Dataset", "write"]

_SIGNATURE = b"\x89HDF\r\n\x1a\n"

# message types (HDF5 file format specification, section IV.A.2)
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE, _FILL_OLD, _FILL = 0x00, 0x01, 0x02, 0x03, 0x04, 0x05
_LINK, _EXTERNAL, _LAYOUT, _GROUP_INFO, _FILTERS, _ATTRIBUTE = 0x06, 0x07, 0x08, 0x0A, 0x0B, 0x0C
_COMMENT, _MTIME_OLD, _CONTINUATION, _SYMBOL_TABLE, _MTIME = 0x0D, 0x0E, 0x10, 0x11, 0x12
_ATTRIBUTE_INFO, _REFCOUNT = 0x15, 0x16
# messages that carry nothing a reader of datasets and groups needs
_IGNORED = {_NIL, _COMMENT, _MTIME_OLD, _MTIME, _REFCOUNT, _GROUP_INFO}
_MESSAGE_NAMES = {_LINK_INFO: "link info message (0x0002, new-style group)",
                  _LINK: "link message (0x0006, new-style group)",
                  _EXTERNAL: "external data files message (0x0007)",
                  _ATTRIBUTE_INFO: "attribute info message (0x0015, dense attribute storage)"}
_CLASS_NAMES = {2: "time", 4: "bitfield", 5: "opaque", 6: "compound", 7: "reference",
                8: "enumerated", 9: "variable-length", 10: "array"}
_DEFLATE, _SHUFFLE, _FLETCHER32 = 1, 2, 3
_FILTER_NAMES = {4: "szip", 5: "nbit", 6: "scaleoffset", 307: "bzip2", 32000: "lzf",
                 32001: "blosc", 32004: "lz4", 32015: "zstd"}
# IEEE layouts by size: exponent location, exponent size, mantissa location,
# mantissa size, exponent bias
_IEEE = {2: (10, 5, 0, 10, 15), 4: (23, 8, 0, 23, 127), 8: (52, 11, 0, 52, 1023)}


def _pad8(n: int) -> int:
    return (n + 7) & ~7


def _uint(buf, pos: int, size: int) -> int:
    return int.from_bytes(buf[pos:pos + size], "little")


def _refuse(what: str):
    return NotImplementedError(f"HDF5: {what} is not supported by fisr_tpu_torch.data.hdf5")


def _fletcher32(data) -> int:
    """HDF5's Fletcher-32 (H5_checksum_fletcher32) of `data`: 16-bit
    big-endian words, an odd last byte as the high byte of one more word,
    both sums folded end-around-carry, which leaves s % 65535 in [1, 65535]
    for a positive s and 0 only for all-zero data."""
    a = np.frombuffer(data, np.uint8)
    if a.size % 2:
        a = np.concatenate([a, np.zeros(1, np.uint8)])
    words = a.view(">u2")
    n = words.size
    s1 = s2 = 0
    step = 1 << 20  # keeps every partial sum inside int64
    for b in range(0, n, step):
        w = words[b:b + step].astype(np.int64)
        s1 += int(w.sum())
        # sum2 adds every prefix sum: word i counts n - i times
        s2 += int(np.dot(w, np.arange(n - b, n - b - w.size, -1, dtype=np.int64) % 65535))
    if s1 == 0:
        return 0
    return ((s2 - 1) % 65535 + 1) << 16 | ((s1 - 1) % 65535 + 1)


def _unshuffle(buf, itemsize: int):
    """Undo the shuffle filter: byte planes back to interleaved elements."""
    a = np.frombuffer(buf, np.uint8)
    n = a.size // itemsize
    if itemsize <= 1 or n <= 1:
        return buf
    out = np.empty_like(a)
    out[:n * itemsize].reshape(n, itemsize)[:] = a[:n * itemsize].reshape(itemsize, n).T
    out[n * itemsize:] = a[n * itemsize:]
    return out


def _datatype(data) -> np.dtype:
    cls, bits, size = data[0] & 0x0F, _uint(data, 1, 3), _uint(data, 4, 4)
    order = ">" if bits & 1 else "<"
    if cls == 0:
        offset, precision = struct.unpack_from("<HH", data, 8)
        if size not in (1, 2, 4, 8) or offset or precision != 8 * size:
            raise _refuse(f"fixed-point datatype of {precision} bits at bit {offset} in {size} bytes")
        return np.dtype(f"{order}{'i' if bits & 8 else 'u'}{size}")
    if cls == 1:
        offset, precision, *layout = struct.unpack_from("<HHBBBBI", data, 8)
        if bits & 0x40 or size not in _IEEE or offset or precision != 8 * size \
                or tuple(layout) != _IEEE[size]:
            raise _refuse(f"floating-point datatype of {size} bytes other than IEEE "
                          f"(bit fields {bits:#x}, layout {layout})")
        return np.dtype(f"{order}f{size}")
    if cls == 3:
        return np.dtype(f"S{size}")
    raise _refuse(f"datatype class {cls} ({_CLASS_NAMES.get(cls, 'unknown')})")


class Dataset:
    """A dataset of an HDF5 file: `shape`, `dtype`, `attrs` and `read()`."""

    def __init__(self, file: "File", name: str, messages):
        self._file, self.name = file, name
        self._attrs_raw, self._filters, layout, fill_old = [], [], None, None
        self._fill, shape, dtype = None, None, None
        for mtype, data in messages:
            if mtype == _DATASPACE:
                shape = file._dataspace(data)
            elif mtype == _DATATYPE:
                dtype = _datatype(data)
            elif mtype == _LAYOUT:
                layout = data
            elif mtype == _FILTERS:
                self._filters = self._filter_pipeline(data)
            elif mtype == _FILL:
                self._fill = self._fill_value(data)
            elif mtype == _FILL_OLD:
                fill_old = data[4:4 + _uint(data, 0, 4)]
            elif mtype == _ATTRIBUTE:
                self._attrs_raw.append(data)
        if shape is None or dtype is None or layout is None:
            raise ValueError(f"HDF5 dataset {name!r}: no dataspace, datatype or layout message")
        self.shape, self.dtype = shape, dtype
        if self._fill is None and fill_old:
            self._fill = fill_old
        self._layout(layout)

    # -- messages ---------------------------------------------------------
    @staticmethod
    def _fill_value(data) -> Optional[bytes]:
        version = data[0]
        if version in (1, 2):
            defined = version == 1 or data[3] == 1
            pos = 4
        elif version == 3:
            defined, pos = bool(data[1] & 0x20), 2
        else:
            raise _refuse(f"fill value message (0x0005) version {version}")
        if not defined:
            return None
        size = _uint(data, pos, 4)
        return bytes(data[pos + 4:pos + 4 + size]) or None

    @staticmethod
    def _filter_pipeline(data) -> List[int]:
        version, count = data[0], data[1]
        if version not in (1, 2):
            raise _refuse(f"filter pipeline message (0x000B) version {version}")
        pos, ids = (8 if version == 1 else 2), []
        for _ in range(count):
            fid = _uint(data, pos, 2)
            if version == 1 or fid >= 256:
                name_len, pos = _uint(data, pos + 2, 2), pos + 4
            else:
                name_len, pos = 0, pos + 2
            n_values = _uint(data, pos + 2, 2)
            pos += 4 + (_pad8(name_len) if version == 1 else name_len)
            pos += 4 * n_values + (4 if version == 1 and n_values % 2 else 0)
            if fid not in (_DEFLATE, _SHUFFLE, _FLETCHER32):
                raise _refuse(f"filter {fid} ({_FILTER_NAMES.get(fid, 'unknown')})")
            ids.append(fid)
        return ids

    def _layout(self, data) -> None:
        f, version, cls = self._file, data[0], data[1]
        if version != 3:
            raise _refuse(f"data layout message (0x0008) version {version}"
                          + (" (chunk indexes of libver 'v110' and later)" if version == 4 else ""))
        self._kind = {0: "compact", 1: "contiguous", 2: "chunked"}.get(cls)
        if cls == 0:
            self._raw = bytes(data[4:4 + _uint(data, 2, 2)])
        elif cls == 1:
            self._addr = _uint(data, 2, f._o)
            self._size = _uint(data, 2 + f._o, f._l)
        elif cls == 2:
            ndims = data[2]
            self._addr = _uint(data, 3, f._o)
            dims = struct.unpack_from(f"<{ndims}I", data, 3 + f._o)
            self._chunk, element = tuple(dims[:-1]), dims[-1]
            if len(self._chunk) != len(self.shape) or element != self.dtype.itemsize:
                raise ValueError(f"HDF5 dataset {self.name!r}: chunk dims {dims} for shape "
                                 f"{self.shape} of {self.dtype}")
        else:
            raise _refuse(f"data layout class {cls} (virtual)")

    @property
    def attrs(self) -> Dict[str, object]:
        """The attributes, as h5py returns them: a numpy scalar for a scalar
        dataspace, else an array."""
        return dict(self._attribute(data) for data in self._attrs_raw)

    def _attribute(self, data):
        version = data[0]
        if version not in (1, 2, 3):
            raise _refuse(f"attribute message (0x000C) version {version}")
        if version > 1 and data[1] & 3:
            raise _refuse("attribute with a shared (committed) datatype or dataspace")
        name_size, type_size, space_size = struct.unpack_from("<HHH", data, 2)
        pad = _pad8 if version == 1 else (lambda n: n)
        pos = 9 if version == 3 else 8
        name = bytes(data[pos:pos + name_size]).rstrip(b"\0").decode("utf-8")
        pos += pad(name_size)
        dtype = _datatype(data[pos:pos + type_size])
        pos += pad(type_size)
        shape = self._file._dataspace(data[pos:pos + space_size])
        pos += pad(space_size)
        value = np.frombuffer(data, dtype, int(np.prod(shape)), pos).reshape(shape)
        return name, (value[()] if shape == () else value.copy())

    # -- data -------------------------------------------------------------
    def _filled(self) -> np.ndarray:
        if self._fill is None:
            return np.zeros(self.shape, self.dtype)
        return np.full(self.shape, np.frombuffer(self._fill, self.dtype, 1)[0], self.dtype)

    def read(self) -> np.ndarray:
        """The whole dataset as an array of `dtype` (the file's byte order)."""
        f, n = self._file, int(np.prod(self.shape))
        nbytes = n * self.dtype.itemsize
        if self._kind == "compact":
            if len(self._raw) < nbytes:
                raise ValueError(f"HDF5 dataset {self.name!r}: compact data of "
                                 f"{len(self._raw)} bytes, want {nbytes}")
            return np.frombuffer(self._raw, self.dtype, n).reshape(self.shape).copy()
        if self._kind == "contiguous":
            if f._undefined(self._addr) or n == 0:
                return self._filled()
            if self._size < nbytes:
                raise ValueError(f"HDF5 dataset {self.name!r}: {self._size} bytes stored, "
                                 f"want {nbytes}")
            f._fh.seek(f._base + self._addr)
            out = np.fromfile(f._fh, self.dtype, n)
            if out.size != n:
                raise ValueError(f"HDF5 dataset {self.name!r}: the file ends inside its data")
            return out.reshape(self.shape)
        return self._read_chunked()

    def _read_chunked(self) -> np.ndarray:
        f, shape, chunk = self._file, self.shape, self._chunk
        if int(np.prod(shape)) == 0:
            return np.empty(shape, self.dtype)
        chunks = [] if f._undefined(self._addr) else [
            c for c in self._chunk_records() if all(o < s for o, s in zip(c[2], shape))]
        n_grid = int(np.prod([-(-s // c) for s, c in zip(shape, chunk)]))
        out = self._filled() if len(chunks) < n_grid else np.empty(shape, self.dtype)
        count = int(np.prod(chunk))
        for size, mask, offsets, addr in chunks:
            if any(o % c for o, c in zip(offsets, chunk)):
                raise ValueError(f"HDF5 dataset {self.name!r}: chunk offset {offsets} "
                                 f"off the chunk grid {chunk}")
            block = np.frombuffer(self._unfilter(f._read(addr, size), mask, addr),
                                  self.dtype, count).reshape(chunk)
            region = tuple(slice(o, min(o + c, s)) for o, c, s in zip(offsets, chunk, shape))
            out[region] = block[tuple(slice(0, r.stop - r.start) for r in region)]
        return out

    def _chunk_records(self) -> Iterator[Tuple[int, int, Tuple[int, ...], int]]:
        """(stored bytes, filter mask, element offsets, address) of every chunk."""
        rank = len(self.shape)
        for key, addr in self._file._btree(self._addr, 1, 8 + 8 * (rank + 1)):
            size, mask = struct.unpack_from("<II", key)
            yield size, mask, struct.unpack_from(f"<{rank}Q", key, 8), addr

    def _unfilter(self, buf, mask: int, addr: int):
        for i in reversed(range(len(self._filters))):
            if mask >> i & 1:  # the writer skipped filter i on this chunk
                continue
            fid = self._filters[i]
            if fid == _FLETCHER32:
                stored, body = _uint(buf, len(buf) - 4, 4), buf[:-4]
                want = _fletcher32(body)
                swapped = int.from_bytes(want.to_bytes(4, "little"), "big")
                if stored not in (want, swapped):  # HDF5 accepts either byte order
                    raise ValueError(f"HDF5 dataset {self.name!r}: fletcher32 checksum "
                                     f"mismatch in the chunk at {addr}")
                buf = body
            elif fid == _DEFLATE:
                buf = zlib.decompress(buf)
            else:
                buf = _unshuffle(buf, self.dtype.itemsize)
        want = int(np.prod(self._chunk)) * self.dtype.itemsize
        if len(buf) != want:
            raise ValueError(f"HDF5 dataset {self.name!r}: the chunk at {addr} holds "
                             f"{len(buf)} bytes after its filters, want {want}")
        return buf


class Group:
    """A group stored as a symbol table: `keys()` and `[name]` (a path of
    names joined by '/' reaches into subgroups)."""

    def __init__(self, file: "File", name: str, messages):
        self._file, self.name = file, name
        table = [data for mtype, data in messages if mtype == _SYMBOL_TABLE]
        if not table:
            raise ValueError(f"HDF5 group {name!r}: no symbol table message")
        o = file._o
        self._members = file._symbol_table(_uint(table[0], 0, o), _uint(table[0], o, o))

    def keys(self) -> List[str]:
        return list(self._members)

    def __getitem__(self, path: str):
        head, _, rest = path.strip("/").partition("/")
        if head not in self._members:
            raise KeyError(f"HDF5 group {self.name!r} has no member {head!r}")
        addr = self._members[head]
        if self._file._undefined(addr):
            raise _refuse(f"soft link {head!r}")
        obj = self._file._object(f"{self.name.rstrip('/')}/{head}", addr)
        return obj[rest] if rest else obj


class File(Group):
    """An HDF5 file opened for reading (a context manager)."""

    def __init__(self, path: str | os.PathLike):
        self._fh = open(path, "rb")
        try:
            self._base = self._find_superblock(path)
            root = self._superblock()
            super().__init__(self, "/", self._messages(root))
        except BaseException:
            self._fh.close()
            raise

    def close(self) -> None:
        self._fh.close()

    def __enter__(self) -> "File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- low level --------------------------------------------------------
    def _find_superblock(self, path) -> int:
        size, pos = os.fstat(self._fh.fileno()).st_size, 0
        while pos + 8 <= size:
            self._fh.seek(pos)
            if self._fh.read(8) == _SIGNATURE:
                return pos
            pos = 512 if pos == 0 else 2 * pos
        raise ValueError(f"{os.fspath(path)}: not an HDF5 file (no superblock signature "
                         "at 0, 512, 1024, ...)")

    def _read(self, addr: int, n: int) -> bytes:
        self._fh.seek(self._base + addr)
        data = self._fh.read(n)
        if len(data) != n:
            raise ValueError(f"HDF5: the file ends inside the {n} bytes at address {addr}")
        return data

    def _undefined(self, addr: int) -> bool:
        return addr == (1 << 8 * self._o) - 1

    def _superblock(self) -> int:
        """Parses the superblock; returns the root group's object header address."""
        head = self._read(0, 24)
        version = head[8]
        if version not in (0, 1):
            raise _refuse(f"superblock version {version} (libver 'v108' or 'latest')")
        self._o, self._l = head[13], head[14]
        pos = 24 + (4 if version == 1 else 0)  # v1: indexed storage K + reserved
        # the base address and three more (free space, end of file, file
        # info block), then the root group's symbol table entry: link name
        # offset, object header address
        body = self._read(pos, 6 * self._o)
        return _uint(body, 5 * self._o, self._o)

    def _messages(self, addr: int) -> List[Tuple[int, bytes]]:
        """The (type, data) messages of the version-1 object header at `addr`,
        its continuation blocks included, in order."""
        head = self._read(addr, 16)
        if head[:4] == b"OHDR":
            raise _refuse("object header version 2 ('OHDR', libver 'v108' or later)")
        if head[0] != 1:
            raise _refuse(f"object header version {head[0]}")
        blocks, out = [(addr + 16, _uint(head, 8, 4))], []
        while blocks:
            start, size = blocks.pop(0)
            buf, pos = self._read(start, size), 0
            while pos + 8 <= size:
                mtype, msize, flags = struct.unpack_from("<HHB", buf, pos)
                data = buf[pos + 8:pos + 8 + msize]
                pos += 8 + msize
                if mtype == _CONTINUATION:
                    blocks.append((_uint(data, 0, self._o), _uint(data, self._o, self._l)))
                elif flags & 0x02:
                    raise _refuse("committed datatype (shared message)" if mtype == _DATATYPE
                                  else f"shared message of type {mtype:#06x}")
                elif mtype in _MESSAGE_NAMES:
                    raise _refuse(_MESSAGE_NAMES[mtype])
                elif mtype not in _IGNORED:
                    out.append((mtype, data))
        return out

    def _object(self, name: str, addr: int):
        messages = self._messages(addr)
        types = {mtype for mtype, _ in messages}
        if _SYMBOL_TABLE in types:
            return Group(self, name, messages)
        if _LAYOUT in types:
            return Dataset(self, name, messages)
        if types <= {_DATATYPE, _ATTRIBUTE}:
            raise _refuse(f"committed datatype object {name!r}")
        known = {_DATASPACE, _DATATYPE, _FILL_OLD, _FILL, _FILTERS, _ATTRIBUTE}
        raise _refuse(f"object {name!r} with message types "
                      f"{sorted(f'{t:#06x}' for t in types - known)}")

    def _dataspace(self, data) -> Tuple[int, ...]:
        version, rank = data[0], data[1]
        if version == 1:
            pos = 8
        elif version == 2:
            if data[3] == 2:
                raise _refuse("null dataspace")
            pos = 4
        else:
            raise _refuse(f"dataspace message (0x0001) version {version}")
        return tuple(_uint(data, pos + i * self._l, self._l) for i in range(rank))

    def _btree(self, addr: int, node_type: int, key_size: int) -> Iterator[Tuple[bytes, int]]:
        """(key before the child, child address) of every leaf entry of the
        version-1 B-tree at `addr`."""
        o = self._o
        head = self._read(addr, 8 + 2 * o)
        if head[:4] != b"TREE" or head[4] != node_type:
            raise ValueError(f"HDF5: no B-tree node of type {node_type} at {addr}")
        level, used = head[5], _uint(head, 6, 2)
        body = self._read(addr + 8 + 2 * o, used * (key_size + o) + key_size)
        for i in range(used):
            pos = i * (key_size + o)
            child = _uint(body, pos + key_size, o)
            if level == 0:
                yield body[pos:pos + key_size], child
            else:
                yield from self._btree(child, node_type, key_size)

    def _symbol_table(self, btree: int, heap: int) -> Dict[str, int]:
        """name -> object header address of a symbol-table group."""
        o, l = self._o, self._l
        prefix = self._read(heap, 8 + 2 * l + o)
        if prefix[:4] != b"HEAP":
            raise ValueError(f"HDF5: no local heap at {heap}")
        names = self._read(_uint(prefix, 8 + 2 * l, o), _uint(prefix, 8, l))
        members, entry = {}, 2 * o + 24
        for _, snod in self._btree(btree, 0, l):
            head = self._read(snod, 8)
            if head[:4] != b"SNOD":
                raise ValueError(f"HDF5: no symbol table node at {snod}")
            n = _uint(head, 6, 2)
            body = self._read(snod + 8, n * entry)
            for i in range(n):
                off = _uint(body, i * entry, o)
                name = names[off:names.index(b"\0", off)].decode("utf-8")
                members[name] = _uint(body, i * entry + o, o)
        return members


# -- writer ----------------------------------------------------------------
_UNDEF = 0xFFFFFFFFFFFFFFFF
_LEAF_K, _INTERNAL_K = 4, 16  # HDF5's defaults: 8 entries a node, 32 children a B-tree node
_SNOD_SIZE = 8 + 2 * _LEAF_K * 40
_BTREE_SIZE = 24 + (2 * _INTERNAL_K + 1) * 8 + 2 * _INTERNAL_K * 8
# IEEE little-endian float32 (class 1, version 1, mantissa normalization
# "implied", sign at bit 31), as h5py writes it
_F32_TYPE = bytes.fromhex("11201f00" "04000000" "0000" "2000" "17" "08" "00" "17" "7f000000")
_STREAM_BYTES = 1 << 26  # bound of the slabs a non-contiguous array is written in


def _message(mtype: int, data: bytes, flags: int = 0) -> bytes:
    data = data.ljust(_pad8(len(data)), b"\0")
    return struct.pack("<HHB3x", mtype, len(data), flags) + data


def _object_header(messages: List[bytes]) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def _string_attribute(name: str, value: bytes) -> bytes:
    n = name.encode() + b"\0"
    # fixed-length string, null-padded, ASCII; scalar dataspace version 1
    dtype = struct.pack("<BBBBI", 0x13, 0x01, 0, 0, len(value))
    space = struct.pack("<BBBB4x", 1, 0, 0, 0)
    return (struct.pack("<BxHHH", 1, len(n), len(dtype), len(space))
            + n.ljust(_pad8(len(n)), b"\0") + dtype + space + value)


def _dataset_header(arr: np.ndarray, attrs: Dict[str, bytes], addr: int) -> bytes:
    dims = b"".join(struct.pack("<Q", d) for d in arr.shape)
    size = arr.nbytes
    messages = [
        # dataspace version 1, maximum dims present (equal to the dims)
        _message(_DATASPACE, struct.pack("<BBB5x", 1, arr.ndim, 1) + dims + dims),
        _message(_DATATYPE, _F32_TYPE, flags=1),
        # fill value version 2: allocation late, written if set, defined, size 0
        _message(_FILL, struct.pack("<BBBBI", 2, 2, 2, 1, 0), flags=1),
        _message(_LAYOUT, struct.pack("<BBQQ", 3, 1, addr if size else _UNDEF, size)),
    ] + [_message(_ATTRIBUTE, _string_attribute(k, v)) for k, v in attrs.items()]
    return _object_header(messages)


def _stream(fh, arr: np.ndarray) -> None:
    """arr's elements in C order into `fh` with ndarray.tofile: at once when
    the array is C-contiguous, else in C-contiguous slabs of at most
    _STREAM_BYTES along its leading axes (no second copy of the array)."""
    if arr.flags.c_contiguous:
        arr.tofile(fh)
        return
    lead = 0
    while lead < arr.ndim and arr[(0,) * lead].nbytes > _STREAM_BYTES:
        lead += 1
    for index in np.ndindex(*arr.shape[:lead]):
        np.ascontiguousarray(arr[index]).tofile(fh)


def write(path: str | os.PathLike, datasets: Dict[str, np.ndarray],
          attrs: Optional[Dict[str, bytes]] = None, userblock: bytes = b"") -> None:
    """Write float32 `datasets` (name -> array, stored in C order) as
    contiguous datasets of the root group, each with the fixed-length string
    attributes `attrs`, behind `userblock` padded to 512 bytes (none when
    empty). Superblock version 0, version-1 object headers, a symbol-table
    root group: what h5py writes at its defaults, which h5py and MATLAB
    open."""
    attrs = attrs or {}
    names = sorted(datasets, key=lambda k: k.encode())
    if not names or len(names) > 2 * _LEAF_K * 2 * _INTERNAL_K:
        raise ValueError(f"1 to {4 * _LEAF_K * _INTERNAL_K} datasets, got {len(names)}")
    arrays = [np.asarray(datasets[k]) for k in names]
    for k, a in zip(names, arrays):
        if a.dtype != np.dtype("<f4"):
            raise TypeError(f"dataset {k!r}: the writer stores little-endian float32, "
                            f"got {a.dtype}")
    if len(userblock) > 512:
        raise ValueError(f"a userblock of {len(userblock)} bytes; at most 512")
    base = 512 if userblock else 0

    # the local heap's data: "" at offset 0 (the root's name and the first
    # B-tree key), then each name, null-terminated, 8-byte aligned
    heap_data, offsets = b"\0" * 8, {}
    for k in names:
        offsets[k] = len(heap_data)
        n = k.encode() + b"\0"
        heap_data += n.ljust(_pad8(len(n)), b"\0")
    snods = [names[i:i + 2 * _LEAF_K] for i in range(0, len(names), 2 * _LEAF_K)]

    # relative addresses: superblock, root header, heap, B-tree, symbol
    # table nodes, dataset headers, then the data
    root_addr = 96
    root_hdr_size = 16 + 8 + 16
    heap_addr = root_addr + root_hdr_size
    btree_addr = heap_addr + 32 + len(heap_data)
    snod_addr = btree_addr + _BTREE_SIZE
    hdr_addr = snod_addr + len(snods) * _SNOD_SIZE
    headers = [_dataset_header(a, attrs, 0) for a in arrays]  # sizes only
    data_addr, hdr_addrs, pos = [], [], hdr_addr + sum(len(h) for h in headers)
    for h in headers:
        hdr_addrs.append(hdr_addr)
        hdr_addr += len(h)
    for a in arrays:
        data_addr.append(pos)
        pos += a.nbytes
    end = base + pos

    sym = struct.pack("<QQ", btree_addr, heap_addr)
    superblock = (_SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
                  + struct.pack("<HHI", _LEAF_K, _INTERNAL_K, 0)
                  + struct.pack("<QQQQ", base, _UNDEF, end, _UNDEF)
                  + struct.pack("<QQII", 0, root_addr, 1, 0) + sym)
    root = _object_header([_message(_SYMBOL_TABLE, sym)])
    heap = b"HEAP" + bytes(4) + struct.pack("<QQQ", len(heap_data), 1, heap_addr + 32) + heap_data
    keys = [0] + [offsets[group[-1]] for group in snods]
    children = [snod_addr + i * _SNOD_SIZE for i in range(len(snods))]
    btree = b"TREE" + struct.pack("<BBHQQ", 0, 0, len(snods), _UNDEF, _UNDEF)
    for key, child in zip(keys, children):
        btree += struct.pack("<QQ", key, child)
    btree = (btree + struct.pack("<Q", keys[-1])).ljust(_BTREE_SIZE, b"\0")
    nodes = b""
    for group in snods:
        entries = b"".join(struct.pack("<QQII16x", offsets[k], hdr_addrs[names.index(k)], 0, 0)
                           for k in group)
        nodes += (b"SNOD" + struct.pack("<BxH", 1, len(group)) + entries).ljust(_SNOD_SIZE, b"\0")
    headers = [_dataset_header(a, attrs, d) for a, d in zip(arrays, data_addr)]
    meta = superblock + root + heap + btree + nodes + b"".join(headers)
    assert len(meta) == data_addr[0], (len(meta), data_addr[0])

    with open(path, "wb") as fh:
        fh.write(userblock.ljust(base, b"\0"))
        fh.write(meta)
        for a in arrays:
            _stream(fh, a)
