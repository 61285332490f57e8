"""Ops-free TensorBoard event writer (scalars + images), no TF dependency
(copy of fisr_tpu/utils/tb_writer.py; numpy, struct and the package's own PNG
encoder, so it also runs where PIL is not installed).

Rebuild of the reference's proto-based `TBLogger` (logger.py:32-129) — that
one built Summary protos with TF but no graph ops; here even the protobuf
encoding is done by hand (Event/Summary wire format + TFRecord framing with
masked CRC32C), so real TensorBoard can read the files from a TF-free
environment.

Wire format notes:
  * event file = TFRecord stream: [len u64][crc(len) u32][payload][crc u32],
    crcs are masked CRC32C (the TensorFlow masking rotation);
  * Event proto: 1=wall_time(double) 2=step(int64) 5=summary(Summary);
  * Summary.Value: 1=tag(string) 2=simple_value(float) 4=image(Image);
  * Summary.Image: 1=height 2=width 3=colorspace 4=encoded_image_string.
"""

from __future__ import annotations

import os
import struct
import time

import numpy as np

from fisr_tpu_torch.native import crc32c as native_crc32c

__all__ = ["TBLogger", "crc32c"]

_CRC_TABLE = None


def _crc_table():
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78  # Castagnoli, reflected
        table = []
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            table.append(c)
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    """CRC-32C by the byte table: the plain version of native.crc32c, which
    the writer uses."""
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = native_crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# -- minimal protobuf encoding ------------------------------------------------

def _varint(n: int) -> bytes:
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _tag(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _f_double(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", v)


def _f_float(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def _f_int(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v)


def _f_bytes(field: int, v: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(v)) + v


def _scalar_value(tag: str, value: float) -> bytes:
    return _f_bytes(1, tag.encode()) + _f_float(2, float(value))


def _image_value(tag: str, png_bytes: bytes, h: int, w: int, colorspace: int = 3) -> bytes:
    image = (_f_int(1, h) + _f_int(2, w) + _f_int(3, colorspace)
             + _f_bytes(4, png_bytes))
    return _f_bytes(1, tag.encode()) + _f_bytes(4, image)


def _event(step: int, summary_values: list[bytes]) -> bytes:
    summary = b"".join(_f_bytes(1, v) for v in summary_values)
    return (_f_double(1, time.time()) + _f_int(2, int(step))
            + _f_bytes(5, summary))


class TBLogger:
    """Append-only TensorBoard event file writer."""

    def __init__(self, logdir: str, filename_suffix: str = ""):
        os.makedirs(logdir, exist_ok=True)
        name = f"events.out.tfevents.{int(time.time())}.fisr_tpu_torch{filename_suffix}"
        self._path = os.path.join(logdir, name)
        self._f = open(self._path, "ab")
        # TB requires a first event with file_version (field 3, string)
        first = _f_double(1, time.time()) + _f_bytes(3, b"brain.Event:2")
        self._write_record(first)

    def _write_record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))
        self._f.flush()

    def log_scalar(self, tag: str, value: float, step: int) -> None:
        self._write_record(_event(step, [_scalar_value(tag, value)]))

    def log_scalars(self, scalars: dict, step: int) -> None:
        self._write_record(
            _event(step, [_scalar_value(k, v) for k, v in scalars.items()]))

    def log_image(self, tag: str, img_u8: np.ndarray, step: int) -> None:
        """img_u8: [H, W, 3] uint8 (encoded as PNG into the event)."""
        from fisr_tpu_torch.data.png_io import encode_png

        h, w = img_u8.shape[:2]
        self._write_record(
            _event(step, [_image_value(tag, encode_png(img_u8), h, w)]))

    def close(self) -> None:
        self._f.close()

    @property
    def path(self) -> str:
        return self._path
