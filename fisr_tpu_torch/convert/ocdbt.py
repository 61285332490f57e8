"""A read-only OCDBT key-value store: tensorstore's "Optionally-Cooperative
Distributed B+Tree", the store orbax writes a checkpoint step into, read
with numpy, the stdlib and the host runtime (crc32c and zstd, csrc/).

The format is tensorstore's ("OCDBT on-disk format" in its documentation):

  every file     magic (u32 big-endian: 0x0cdb3a2a a manifest, 0x0cdb20de a
                 B-tree node), length (u64, the file's size), varint format
                 version 0, varint compression (0 none, 1 zstd), the body
                 compressed so, crc32c (u32) of every byte before it
  manifest       config (uuid, manifest kind, max inline value bytes, max
                 decoded node bytes, version tree arity log2, compression
                 and its zstd level), then for the single-file kind a data
                 file table, the newest versions (each a generation, its
                 root's height, location and statistics, a commit time) and
                 the references to version-tree nodes that hold older ones
  B-tree node    height, data file table, then the entries column by column:
                 prefix-compressed keys; an interior node adds each child's
                 common key prefix and location; a leaf each value, inline
                 or a (data file, offset, length) reference
  data file      ids index the table of the file that names them: a base
                 path and a relative path, prefix-compressed, under the root

Only the newest generation is read; it is always among the manifest's inline
versions. Anything else of the format raises NotImplementedError naming the
field and its value; a file whose crc32c, length or body does not check out
raises ValueError naming the file.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional

__all__ = ["OcdbtStore"]

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_NONE, _ZSTD = 0, 1
_SINGLE_FILE = 0
_INLINE, _INDIRECT = 0, 1
_MISSING = (1 << 64) - 1  # offset and length of an empty tree's root
# a manifest holds at most 2^arity versions and a few version-tree
# references: kilobytes
_MANIFEST_LIMIT = 16 << 20


class _Body:
    """The decoded body of one file, read forward; every read checked."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def error(self, text: str) -> ValueError:
        return ValueError(f"{self.what}: {text} (at byte {self.pos} of {len(self.data)})")

    def raw(self, n: int) -> bytes:
        if n > len(self.data) - self.pos:
            raise self.error(f"needs {n} bytes, the body ends")
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def u8(self) -> int:
        return self.raw(1)[0]

    def varint(self) -> int:
        v = shift = 0
        while True:
            b = self.u8()
            v |= (b & 0x7F) << shift
            if b < 0x80:
                break
            shift += 7
            if shift >= 70:
                raise self.error("varint longer than 10 bytes")
        if v >= 1 << 64:
            raise self.error(f"varint {v} exceeds 64 bits")
        return v

    def column(self, n: int) -> list:
        return [self.varint() for _ in range(n)]

    def end(self) -> None:
        if self.pos != len(self.data):
            raise self.error(f"{len(self.data) - self.pos} bytes after the last field")


def _open_envelope(data: bytes, magic: int, what: str, limit: int) -> _Body:
    """The body of one OCDBT file, its envelope checked; a compressed body
    decodes to at most `limit` bytes."""
    from fisr_tpu_torch import native

    if len(data) < 4 + 8 + 2 + 4:
        raise ValueError(f"{what}: truncated, {len(data)} bytes")
    got = int.from_bytes(data[:4], "big")
    if got != magic:
        raise ValueError(f"{what}: magic 0x{got:08x}, not 0x{magic:08x}")
    length = int.from_bytes(data[4:12], "little")
    if length != len(data):
        raise ValueError(f"{what}: its header says {length} bytes, it has {len(data)} "
                         "(truncated)")
    crc = int.from_bytes(data[-4:], "little")
    if native.crc32c(data[:-4]) != crc:
        raise ValueError(f"{what}: crc32c mismatch (the file is corrupt)")
    head = _Body(data[12:-4], what)
    version = head.varint()
    if version != 0:
        raise NotImplementedError(f"{what}: OCDBT format version {version}")
    compression = head.varint()
    body = data[12 + head.pos:-4]
    if compression == _ZSTD:
        try:
            body = native.zstd_decompress_bounded(body, limit).tobytes()
        except ValueError as e:
            raise ValueError(f"{what}: {e}") from None
    elif compression != _NONE:
        raise NotImplementedError(f"{what}: OCDBT compression {compression}")
    return _Body(body, what)


def _data_files(r: _Body, root: str) -> list:
    """A data file table -> the files' paths under `root`."""
    n = r.varint()
    prefix = [0] + r.column(n - 1) if n else []
    suffix = r.column(n)
    base = r.column(n)
    paths, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise r.error(f"data file {i} shares {prefix[i]} bytes of a {len(prev)}-byte path")
        full = prev[:prefix[i]] + r.raw(suffix[i])
        if base[i] > len(full):
            raise r.error(f"data file {i}: base path of {base[i]} bytes in a {len(full)}-byte "
                          "path")
        rel = full.decode()
        if rel.startswith("/") or ".." in rel.split("/"):
            raise r.error(f"data file path {rel!r} leaves the store")
        paths.append(os.path.join(root, rel))
        prev = full
    return paths


def _key_lengths(r: _Body, n: int) -> tuple:
    """The lengths of n prefix-compressed keys: (each key's prefix shared
    with the one before, its own suffix); the bytes follow, after an
    interior node's subtree prefix lengths."""
    return [0] + r.column(n - 1) if n else [], r.column(n)


def _key_bytes(r: _Body, prefix: list, suffix: list) -> list:
    keys, prev = [], b""
    for i, (p, s) in enumerate(zip(prefix, suffix)):
        if p > len(prev):
            raise r.error(f"key {i} shares {p} bytes of a {len(prev)}-byte key")
        prev = prev[:p] + r.raw(s)
        keys.append(prev)
    return keys


def _location(files: list, r: _Body, file_id: int, offset: int, length: int) -> tuple:
    if file_id >= len(files):
        raise r.error(f"data file id {file_id} of a table of {len(files)}")
    return files[file_id], offset, length


class OcdbtStore:
    """The newest generation of the OCDBT store at `root` (a directory holding
    manifest.ocdbt): `keys()`, `read(key)` and `items(prefix)`, keys as str.
    Nodes are read when first needed; indirect values are read with
    os.pread, each the slice it needs."""

    def __init__(self, root: str):
        self.root = os.path.abspath(os.fspath(root))
        path = os.path.join(self.root, "manifest.ocdbt")
        with open(path, "rb") as f:
            r = _open_envelope(f.read(), MANIFEST_MAGIC, path, _MANIFEST_LIMIT)
        self.config = {"uuid": r.raw(16).hex()}
        kind = r.varint()
        if kind != _SINGLE_FILE:
            raise NotImplementedError(f"{path}: manifest kind {kind} (numbered manifests)")
        self.config.update(max_inline_value_bytes=r.varint(), max_decoded_node_bytes=r.varint(),
                           version_tree_arity_log2=r.u8())
        compression = r.varint()
        if compression == _ZSTD:
            self.config["zstd_level"] = int.from_bytes(r.raw(4), "little", signed=True)
        elif compression != _NONE:
            raise NotImplementedError(f"{path}: config compression {compression}")
        files = _data_files(r, self.root)
        n = r.varint()
        if n > 1 << self.config["version_tree_arity_log2"]:
            raise r.error(f"{n} inline versions exceed the version tree's arity")
        gens, heights = r.column(n), [r.u8() for _ in range(n)]
        ids, offsets, lengths = r.column(n), r.column(n), r.column(n)
        for _ in range(3):  # num_keys, num_tree_bytes, num_indirect_value_bytes
            r.column(n)
        r.raw(8 * n)  # commit times
        m = r.varint()  # references to version-tree nodes: the older generations
        node_gens = r.column(m)
        for _ in range(4):  # data file, offset, length, number of generations
            r.column(m)
        r.raw(8 * m + m)  # commit times, heights
        r.end()
        if not n:
            raise NotImplementedError(f"{path}: no inline version ({m} version-tree nodes)")
        newest = max(range(n), key=gens.__getitem__)
        if node_gens and max(node_gens) > gens[newest]:
            raise r.error(f"a version-tree node holds generation {max(node_gens)}, newer than "
                          f"the inline {gens[newest]}")
        self.generation = gens[newest]
        self.root_height = heights[newest]
        if offsets[newest] == lengths[newest] == _MISSING:
            self._root: Optional[tuple] = None  # an empty tree
        else:
            self._root = _location(files, r, ids[newest], offsets[newest], lengths[newest])
        self._index: Optional[dict] = None

    # ---- nodes ----------------------------------------------------------------

    def _node(self, loc: tuple, height: int, prefix: bytes, out: dict) -> None:
        """The entries under the node at `loc` (full keys = prefix + its
        keys) into out {key: value or (path, offset, length)}."""
        path, offset, length = loc
        what = f"{path} [{offset}:{offset + length}]"
        r = _open_envelope(_pread(path, offset, length, what), NODE_MAGIC, what,
                           self.config["max_decoded_node_bytes"])
        got = r.u8()
        if got != height:
            raise r.error(f"node of height {got} where the tree has height {height}")
        files = _data_files(r, self.root)
        n = r.varint()
        if height:
            pre, suf = _key_lengths(r, n)
            common = r.column(n)
            keys = _key_bytes(r, pre, suf)
            ids, offs, lens = r.column(n), r.column(n), r.column(n)
            for _ in range(3):  # num_keys, num_tree_bytes, num_indirect_value_bytes
                r.column(n)
            r.end()
            for key, c, i, o, k in zip(keys, common, ids, offs, lens):
                if c > len(key):
                    raise r.error(f"subtree prefix of {c} bytes on a {len(key)}-byte key")
                self._node(_location(files, r, i, o, k), height - 1, prefix + key[:c], out)
            return
        pre, suf = _key_lengths(r, n)
        keys = _key_bytes(r, pre, suf)
        lens = r.column(n)
        kinds = [r.u8() for _ in range(n)]
        bad = [k for k in kinds if k not in (_INLINE, _INDIRECT)]
        if bad:
            raise NotImplementedError(f"{what}: leaf value kind {bad[0]}")
        indirect = [i for i, k in enumerate(kinds) if k == _INDIRECT]
        ids, offs = r.column(len(indirect)), r.column(len(indirect))
        values: list = [None] * n
        for i, file_id, off in zip(indirect, ids, offs):
            values[i] = _location(files, r, file_id, off, lens[i])
        for i, kind in enumerate(kinds):
            if kind == _INLINE:
                values[i] = r.raw(lens[i])
        r.end()
        for key, value in zip(keys, values):
            out[(prefix + key).decode(errors="surrogateescape")] = value

    def _entries(self) -> dict:
        if self._index is None:
            index: dict = {}
            if self._root is not None:
                self._node(self._root, self.root_height, b"", index)
            self._index = dict(sorted(index.items()))
        return self._index

    # ---- the store --------------------------------------------------------------

    def keys(self) -> list:
        """Every key, sorted."""
        return list(self._entries())

    def read(self, key: str) -> Optional[bytes]:
        """The value of `key`, or None where the store has no such key."""
        value = self._entries().get(key)
        return None if value is None else _value(value)

    def items(self, prefix: str = "") -> Iterator[tuple]:
        """(key, value) for every key that starts with `prefix`, sorted."""
        for key, value in self._entries().items():
            if key.startswith(prefix):
                yield key, _value(value)


def _value(value) -> bytes:
    if isinstance(value, bytes):
        return value
    path, offset, length = value
    return _pread(path, offset, length, f"{path} [{offset}:{offset + length}]")


def _pread(path: str, offset: int, length: int, what: str) -> bytes:
    """`length` bytes of the file at `offset`, and no others."""
    fd = os.open(path, os.O_RDONLY)
    try:
        size = os.fstat(fd).st_size
        if offset + length > size:
            raise ValueError(f"{what}: the file ends at byte {size} (truncated)")
        return os.pread(fd, length, offset)
    finally:
        os.close(fd)
