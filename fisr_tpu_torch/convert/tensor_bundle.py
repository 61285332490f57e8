"""TensorFlow TensorBundle (checkpoint V2) reader and writer in numpy
(copy of fisr_tpu/convert/tensor_bundle.py).

The reference ships weights as TF1 checkpoints (`FISRnet-122000`,
`pwcnet.ckpt-595000`; restore path FISRnet.py:1101-1115 and
FISR_tfoptflow/model_base.py:115-191). A V2 checkpoint is two files:

  <prefix>.index               LevelDB-format table: key -> protobuf
                               * key ""        -> BundleHeaderProto
                               * key <varname> -> BundleEntryProto
                                 (dtype, shape, shard, offset, size, crc32c)
  <prefix>.data-00000-of-00001 raw little-endian tensor bytes

The containers are implemented here: the LevelDB table format
(prefix-compressed blocks, restart arrays, block trailers, 48-byte footer),
the three protobuf messages (hand-rolled varint parsing), masked crc32c and a
snappy decoder for compressed blocks, so no TensorFlow is needed. The writer
emits the same format (single shard, uncompressed blocks), which TF1's
`tf.train.Saver` restores.

bfloat16 tensors (TF code 14) need `ml_dtypes`, imported where such a tensor
is met; every other dtype is plain numpy.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from fisr_tpu_torch.native import crc32c as native_crc32c

__all__ = ["read_bundle", "write_bundle", "list_variables"]

_TABLE_MAGIC = 0xDB4775248B80FB57
_FOOTER_LEN = 48
_BLOCK_TRAILER_LEN = 5  # 1 byte compression type + 4 byte crc32c

# TF DataType enum -> numpy dtype (the subset tensors actually use)
_DTYPES = {
    1: np.dtype("<f4"), 2: np.dtype("<f8"), 3: np.dtype("<i4"),
    4: np.dtype("<u1"), 5: np.dtype("<i2"), 6: np.dtype("<i1"),
    9: np.dtype("<i8"), 10: np.dtype("bool"), 17: np.dtype("<u2"),
    22: np.dtype("<u4"), 23: np.dtype("<u8"), 19: np.dtype("<f2"),
}
_DTYPE_CODES = {v: k for k, v in _DTYPES.items()}
_BF16 = 14


def _np_dtype(code: int, name: str) -> np.dtype:
    """The numpy dtype of TF dtype `code` for tensor `name`."""
    if code == _BF16:
        try:
            import ml_dtypes
        except ImportError:
            raise ValueError(f"{name}: dtype bfloat16 (TF code 14) needs the ml_dtypes "
                             "package, which this machine lacks") from None
        return np.dtype(ml_dtypes.bfloat16)
    if code not in _DTYPES:
        raise ValueError(f"{name}: unsupported dtype {code}")
    return _DTYPES[code]


def _dtype_code(dtype: np.dtype, name: str) -> int:
    if dtype.name == "bfloat16":  # ml_dtypes' bfloat16
        return _BF16
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: unsupported dtype {dtype}")
    return _DTYPE_CODES[dtype]


# ---------------------------------------------------------------------------
# varint + minimal protobuf
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _write_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _proto_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) from a serialized message."""
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:  # fixed64
            val = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:  # fixed32
            val = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_shape(buf: bytes) -> Tuple[int, ...]:
    """TensorShapeProto: field 2 = repeated Dim{1: size}."""
    dims: List[int] = []
    for field, _w, val in _proto_fields(buf):
        if field == 2:
            # proto3 implicit default: an omitted Dim.size means 0 (TF
            # serializes a zero-size dim as an EMPTY Dim message)
            size = 0
            for f2, _w2, v2 in _proto_fields(val):
                if f2 == 1:
                    size = v2
            dims.append(size)
        elif field == 3 and val:
            raise ValueError("unknown-rank shape in bundle entry")
    return tuple(dims)


def _parse_entry(buf: bytes) -> dict:
    """BundleEntryProto: 1 dtype, 2 shape, 3 shard_id, 4 offset, 5 size,
    6 crc32c (fixed32), 7 slices."""
    e = {"dtype": 0, "shape": (), "shard_id": 0, "offset": 0, "size": 0,
         "crc32c": 0}
    for field, _w, val in _proto_fields(buf):
        if field == 1:
            e["dtype"] = val
        elif field == 2:
            e["shape"] = _parse_shape(val)
        elif field == 3:
            e["shard_id"] = val
        elif field == 4:
            e["offset"] = val
        elif field == 5:
            e["size"] = val
        elif field == 6:
            e["crc32c"] = val
        elif field == 7:
            raise ValueError("sliced (partitioned) tensors not supported")
    return e


def _parse_header(buf: bytes) -> dict:
    h = {"num_shards": 1, "endianness": 0}
    for field, _w, val in _proto_fields(buf):
        if field == 1:
            h["num_shards"] = val
        elif field == 2:
            h["endianness"] = val
    return h


def _emit_field(field: int, wire: int, payload: bytes) -> bytes:
    return _write_varint(field << 3 | wire) + payload


def _serialize_entry(dtype_code: int, shape: Tuple[int, ...], shard: int,
                     offset: int, size: int, crc: int) -> bytes:
    shape_buf = b"".join(
        _emit_field(2, 2, _write_varint(len(dim_buf)) + dim_buf)
        for dim_buf in (_emit_field(1, 0, _write_varint(int(d))) for d in shape)
    )
    out = _emit_field(1, 0, _write_varint(dtype_code))
    out += _emit_field(2, 2, _write_varint(len(shape_buf)) + shape_buf)
    if shard:
        out += _emit_field(3, 0, _write_varint(shard))
    if offset:
        out += _emit_field(4, 0, _write_varint(offset))
    out += _emit_field(5, 0, _write_varint(size))
    out += _emit_field(6, 5, struct.pack("<I", crc))
    return out


def _serialize_header(num_shards: int) -> bytes:
    # num_shards, little endianness (0), version {producer: 1}
    version = _emit_field(1, 0, _write_varint(1))
    return (_emit_field(1, 0, _write_varint(num_shards))
            + _emit_field(2, 0, _write_varint(0))
            + _emit_field(3, 2, _write_varint(len(version)) + version))


# ---------------------------------------------------------------------------
# crc32c (Castagnoli): the host runtime's slice-by-8 (native.crc32c); below,
# its plain version, a byte-table loop run over many lanes at once
# ---------------------------------------------------------------------------

def _make_crc32c_table() -> list:
    poly = 0x82F63B78
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table.append(crc)
    return table


_CRC_TABLE = _make_crc32c_table()
_CRC_TABLE_NP = np.array(_CRC_TABLE, np.uint32)
_MAX_LANES_LOG2 = 16  # lanes advanced together (a power of two, for the pairwise join)
_MIN_LANE_BYTES, _MIN_LANES = 64, 64  # below 64 lanes of 64 bytes: the byte loop


def _crc_register(state: int, data) -> int:
    """The CRC register after feeding `data` one table step a byte (no
    pre- or post-inversion): the reference the lanes are checked against."""
    table = _CRC_TABLE
    for b in data:
        state = (state >> 8) ^ table[(state ^ b) & 0xFF]
    return state


def _gf2_apply(m: np.ndarray, x: np.ndarray) -> np.ndarray:
    """A 32x32 GF(2) matrix (its 32 columns, uint32) times uint32 vectors."""
    out = np.zeros_like(x)
    for i in range(32):
        out ^= ((x >> np.uint32(i)) & np.uint32(1)) * m[i]
    return out


def _zeros_operator(n: int) -> np.ndarray:
    """The register's (linear) map over `n` zero bytes, as 32 columns."""
    basis = np.uint32(1) << np.arange(32, dtype=np.uint32)
    step = (basis >> np.uint32(8)) ^ _CRC_TABLE_NP[basis & np.uint32(0xFF)]
    out = basis
    while n:
        if n & 1:
            out = _gf2_apply(step, out)
        step = _gf2_apply(step, step)
        n >>= 1
    return out


def _crc32c(data: bytes, crc: int = 0) -> int:
    """crc32c of `data`, continuing `crc`. Long inputs run as K equal lanes
    advanced together (one vectorized table step a byte of lane), then joined
    by the register's linearity: reg(s, A + B) = Z_|B| reg(s, A) ^ reg(0, B),
    Z_n being the map over n zero bytes."""
    n = len(data)
    state = crc ^ 0xFFFFFFFF
    if n < _MIN_LANE_BYTES * _MIN_LANES:
        return _crc_register(state, data) ^ 0xFFFFFFFF
    lanes = 1 << min(_MAX_LANES_LOG2, (n // _MIN_LANE_BYTES).bit_length() - 1)
    width = n // lanes
    cols = np.ascontiguousarray(
        np.frombuffer(data, np.uint8, count=lanes * width).reshape(lanes, width).T)
    regs = np.zeros(lanes, np.uint32)
    table = _CRC_TABLE_NP
    for col in cols:
        regs = (regs >> np.uint32(8)) ^ table[(regs ^ col) & np.uint32(0xFF)]
    join = _zeros_operator(width)
    while len(regs) > 1:  # pairs of equal lengths, then their pairs, ...
        regs = _gf2_apply(join, regs[0::2]) ^ regs[1::2]
        join = _gf2_apply(join, join)
    state = int(_gf2_apply(join, np.array([state], np.uint32))[0] ^ regs[0])
    return _crc_register(state, data[lanes * width:]) ^ 0xFFFFFFFF


def _masked_crc32c(data: bytes) -> int:
    crc = native_crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# snappy (decode only; writer never compresses)
# ---------------------------------------------------------------------------

def _snappy_decode(src: bytes) -> bytes:
    length, pos = _read_varint(src, 0)
    out = bytearray()
    while pos < len(src):
        tag = src[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            ln = tag >> 2
            if ln >= 60:
                extra = ln - 59
                ln = int.from_bytes(src[pos:pos + extra], "little")
                pos += extra
            ln += 1
            out += src[pos:pos + ln]
            pos += ln
        else:
            if kind == 1:
                ln = ((tag >> 2) & 7) + 4
                off = ((tag >> 5) << 8) | src[pos]
                pos += 1
            elif kind == 2:
                ln = (tag >> 2) + 1
                off = int.from_bytes(src[pos:pos + 2], "little")
                pos += 2
            else:
                ln = (tag >> 2) + 1
                off = int.from_bytes(src[pos:pos + 4], "little")
                pos += 4
            for _ in range(ln):  # may overlap itself
                out.append(out[-off])
    if len(out) != length:
        raise ValueError("snappy: bad uncompressed length")
    return bytes(out)


# ---------------------------------------------------------------------------
# LevelDB table reading
# ---------------------------------------------------------------------------

def _read_block(data: bytes, offset: int, size: int, verify: bool) -> bytes:
    raw = data[offset:offset + size]
    ctype = data[offset + size]
    if verify:
        stored = struct.unpack_from("<I", data, offset + size + 1)[0]
        if _masked_crc32c(data[offset:offset + size + 1]) != stored:
            raise ValueError(f"block crc mismatch at offset {offset}")
    if ctype == 0:
        return raw
    if ctype == 1:
        return _snappy_decode(raw)
    raise ValueError(f"unsupported block compression {ctype}")


def _iter_block_entries(block: bytes) -> Iterator[Tuple[bytes, bytes]]:
    (num_restarts,) = struct.unpack_from("<I", block, len(block) - 4)
    data_end = len(block) - 4 - 4 * num_restarts
    pos = 0
    key = b""
    while pos < data_end:
        shared, pos = _read_varint(block, pos)
        unshared, pos = _read_varint(block, pos)
        value_len, pos = _read_varint(block, pos)
        key = key[:shared] + block[pos:pos + unshared]
        pos += unshared
        value = block[pos:pos + value_len]
        pos += value_len
        yield key, value


def _read_table(path: str, verify: bool = False) -> Dict[bytes, bytes]:
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < _FOOTER_LEN:
        raise ValueError(f"{path}: too small to be a table file")
    footer = data[-_FOOTER_LEN:]
    if struct.unpack("<Q", footer[40:])[0] != _TABLE_MAGIC:
        raise ValueError(f"{path}: bad table magic (not a V2 checkpoint index)")
    _mi_off, p = _read_varint(footer, 0)
    _mi_size, p = _read_varint(footer, p)
    idx_off, p = _read_varint(footer, p)
    idx_size, p = _read_varint(footer, p)
    index = _read_block(data, idx_off, idx_size, verify)
    out: Dict[bytes, bytes] = {}
    for _key, handle in _iter_block_entries(index):
        boff, hp = _read_varint(handle, 0)
        bsize, _hp = _read_varint(handle, hp)
        for k, v in _iter_block_entries(_read_block(data, boff, bsize, verify)):
            out[k] = v
    return out


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def _shard_path(prefix: str, shard: int, num_shards: int) -> str:
    return f"{prefix}.data-{shard:05d}-of-{num_shards:05d}"


def list_variables(prefix: str) -> Dict[str, Tuple[Tuple[int, ...], np.dtype]]:
    """{name: (shape, dtype)} for every tensor in the checkpoint."""
    table = _read_table(prefix + ".index")
    out = {}
    for key, val in table.items():
        if key == b"":
            continue
        e = _parse_entry(val)
        out[key.decode()] = (e["shape"], _np_dtype(e["dtype"], key.decode()))
    return out


def read_bundle(prefix: str, verify: bool = False) -> Dict[str, np.ndarray]:
    """Read a TF checkpoint-V2 bundle into {var_name: np.ndarray}.

    `prefix` is the checkpoint prefix (e.g. .../FISRnet-122000), exactly what
    TF1's `saver.restore` takes (FISRnet.py:1110-1115).
    verify=True additionally checks per-tensor and per-block crc32c.
    """
    table = _read_table(prefix + ".index", verify)
    if b"" not in table:
        raise ValueError(f"{prefix}: missing bundle header entry")
    header = _parse_header(table[b""])
    if header["endianness"] != 0:
        raise ValueError("big-endian bundles not supported")
    num_shards = header["num_shards"]
    shards: Dict[int, bytes] = {}
    out: Dict[str, np.ndarray] = {}
    for key in sorted(k for k in table if k != b""):
        e = _parse_entry(table[key])
        name = key.decode()
        dtype = _np_dtype(e["dtype"], name)
        if e["shard_id"] not in shards:
            with open(_shard_path(prefix, e["shard_id"], num_shards), "rb") as f:
                shards[e["shard_id"]] = f.read()
        raw = shards[e["shard_id"]][e["offset"]:e["offset"] + e["size"]]
        if len(raw) != e["size"]:
            raise ValueError(f"{name}: truncated data shard")
        if verify and e["crc32c"] and _masked_crc32c(raw) != e["crc32c"]:
            raise ValueError(f"{name}: tensor crc mismatch")
        arr = np.frombuffer(raw, dtype).reshape(e["shape"])
        out[name] = arr.copy()  # own the memory
    return out


class _BlockBuilder:
    """LevelDB block builder (prefix compression + restart array)."""

    def __init__(self, restart_interval: int = 16):
        self.restart_interval = restart_interval
        self.buf = bytearray()
        self.restarts = [0]
        self.counter = 0
        self.last_key = b""

    def add(self, key: bytes, value: bytes) -> None:
        shared = 0
        if self.counter < self.restart_interval:
            for a, b in zip(self.last_key, key):
                if a != b:
                    break
                shared += 1
        else:
            self.restarts.append(len(self.buf))
            self.counter = 0
        self.buf += _write_varint(shared)
        self.buf += _write_varint(len(key) - shared)
        self.buf += _write_varint(len(value))
        self.buf += key[shared:]
        self.buf += value
        self.last_key = key
        self.counter += 1

    def finish(self) -> bytes:
        out = bytes(self.buf)
        for r in self.restarts:
            out += struct.pack("<I", r)
        return out + struct.pack("<I", len(self.restarts))

    @property
    def size(self) -> int:
        return len(self.buf) + 4 * (len(self.restarts) + 1)


class _TableWriter:
    def __init__(self, path: str, block_size: int = 4096):
        self.f = open(path, "wb")
        self.block_size = block_size
        self.offset = 0
        self.block = _BlockBuilder()
        self.index: List[Tuple[bytes, Tuple[int, int]]] = []
        self.last_key: Optional[bytes] = None

    def _flush_block(self) -> None:
        if not self.block.buf:
            return
        contents = self.block.finish()
        handle = (self.offset, len(contents))
        self._write_raw(contents)
        self.index.append((self.last_key, handle))
        self.block = _BlockBuilder()

    def _write_raw(self, contents: bytes) -> Tuple[int, int]:
        trailer = b"\x00" + struct.pack("<I", _masked_crc32c(contents + b"\x00"))
        self.f.write(contents + trailer)
        handle = (self.offset, len(contents))
        self.offset += len(contents) + _BLOCK_TRAILER_LEN
        return handle

    def add(self, key: bytes, value: bytes) -> None:
        if self.last_key is not None and key <= self.last_key:
            raise ValueError("keys must be added in strictly increasing order")
        self.block.add(key, value)
        self.last_key = key
        if self.block.size >= self.block_size:
            self._flush_block()

    def finish(self) -> None:
        self._flush_block()
        meta_handle = self._write_raw(_BlockBuilder().finish())  # empty
        index_block = _BlockBuilder(restart_interval=1)
        for key, (boff, bsize) in self.index:
            index_block.add(key, _write_varint(boff) + _write_varint(bsize))
        idx_handle = self._write_raw(index_block.finish())
        footer = (_write_varint(meta_handle[0]) + _write_varint(meta_handle[1])
                  + _write_varint(idx_handle[0]) + _write_varint(idx_handle[1]))
        footer += b"\x00" * (40 - len(footer))
        footer += struct.pack("<Q", _TABLE_MAGIC)
        self.f.write(footer)
        self.f.close()


def write_bundle(prefix: str, tensors: Dict[str, np.ndarray],
                 crc: bool = True) -> None:
    """Write {name: array} as a TF checkpoint-V2 bundle (1 shard).

    Output is restorable by TF1's `tf.train.Saver` / readable by
    `tf.train.load_checkpoint` — the reverse migration path, and the fixture
    generator that pins `read_bundle`. crc=False skips the per-tensor
    checksums, for consumers that do not validate; TF's restore needs them.
    """
    os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
    names = sorted(tensors)
    data_path = _shard_path(prefix, 0, 1)
    entries: Dict[str, bytes] = {}
    offset = 0
    with open(data_path, "wb") as f:
        for name in names:
            arr = np.asarray(tensors[name])  # (np.ascontiguousarray makes a 0-d array 1-d)
            code = _dtype_code(arr.dtype, name)
            raw = arr.tobytes()  # C order
            f.write(raw)
            entries[name] = _serialize_entry(
                code, arr.shape, 0, offset, len(raw),
                _masked_crc32c(raw) if crc else 0)
            offset += len(raw)

    writer = _TableWriter(prefix + ".index")
    writer.add(b"", _serialize_header(num_shards=1))
    for name in names:
        writer.add(name.encode(), entries[name])
    writer.finish()
