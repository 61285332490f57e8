"""Port: the host runtime's zstd decoder (csrc/zstd.cc, native.zstd_decompress)
against the `zstandard` package, on the CPU.

Every frame here is written by `zstandard` (libzstd) and decoded by both; the
outputs must be bit-equal: levels -5, 1, 3, 19 and 22, long-distance
matching on and off, the content checksum and the content size each on and
off, inputs of 0 bytes, 1 byte, 128 KiB - 1, + 0, + 1 and 3 MiB that are
random, f32 weight-like or highly repetitive (zero runs for RLE blocks, one
separator byte between copies for RLE literals, short periods for repeat
offsets), several frames back to back, a skippable frame, and every chunk of
the repo's trained PWC-Net (checkpoint_dir/pwcnet, read through tensorstore).
Malformed frames (truncated every 97 bytes, seeded single bit flips, a wrong
size, a bad checksum, a Dictionary_ID, a legacy magic, a reserved block
type) raise ValueError in this process, which must survive them.
"""

import os

import numpy as np
import pytest
import zstandard

from fisr_tpu_torch import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAINED_STEP = os.path.join(ROOT, "checkpoint_dir", "pwcnet", "step_14000")
BLOCK = 128 << 10
SIZES = (0, 1, BLOCK - 1, BLOCK, BLOCK + 1, 3 << 20)
LEVELS = (-5, 1, 3, 19, 22)


def _repetitive(n: int, rng) -> bytes:
    base = rng.integers(0, 255, 4096, dtype=np.uint8).tobytes()
    parts, total = [], 0
    while total < n:
        kind = int(rng.integers(0, 4))
        if kind == 0:  # a zero run: RLE blocks
            part = bytes(int(rng.integers(1000, 200000)))
        elif kind == 1:  # a short period: repeat offsets
            part = b"abcdefgh"[:int(rng.integers(1, 8))] * int(rng.integers(10, 5000))
        elif kind == 2:  # one byte between copies: RLE literals
            o = int(rng.integers(0, 4000))
            part = b"\xff" + base[o:o + int(rng.integers(16, 96))]
        else:
            part = base[:int(rng.integers(1, 4096))]
        parts.append(part)
        total += len(part)
    return b"".join(parts)[:n]


def _data(kind: str, n: int) -> bytes:
    rng = np.random.default_rng(n)
    if kind == "random":
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if kind == "weights":
        w = (rng.standard_normal(n // 4 + 1) * 0.05).astype(np.float32)
        return w.tobytes()[:n]
    return _repetitive(n, rng)


def _compress(data: bytes, level: int, checksum=True, content_size=True, ldm=False) -> bytes:
    params = zstandard.ZstdCompressionParameters.from_level(
        level, write_checksum=int(checksum), write_content_size=int(content_size),
        enable_ldm=int(ldm))
    return zstandard.ZstdCompressor(compression_params=params).compress(data)


def _zstandard(frame: bytes) -> bytes:
    return zstandard.ZstdDecompressor().decompressobj().decompress(frame)


# ---- bit-equal to zstandard -------------------------------------------------

@pytest.mark.parametrize("level", LEVELS)
def test_decodes_every_size_kind_and_header_flag_like_zstandard(level):
    case = 0
    for kind in ("random", "weights", "repetitive"):
        for n in SIZES:
            data = _data(kind, n)
            # each (checksum, content size) pair and long-distance matching
            # in turn over the sizes and kinds
            checksum, content_size, ldm = case & 1, (case >> 1) & 1, (case >> 2) & 1
            case += 1
            frame = _compress(data, level, checksum, content_size, ldm)
            got = native.zstd_decompress(frame, len(data))
            want = _zstandard(frame)
            assert want == data
            assert got.dtype == np.uint8 and got.tobytes() == want, (kind, n, checksum,
                                                                     content_size, ldm)


@pytest.mark.parametrize("checksum,content_size", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_header_flags_with_long_distance_matching(checksum, content_size):
    data = _data("repetitive", 3 << 20) + _data("weights", BLOCK + 1)
    for level in (1, 19):
        frame = _compress(data, level, checksum, content_size, ldm=True)
        assert native.zstd_decompress(frame, len(data)).tobytes() == data


def test_frames_back_to_back_and_a_skippable_frame():
    datas = [_data(k, n) for k, n in (("weights", 5000), ("random", 1), ("repetitive", BLOCK + 1),
                                      ("weights", 0), ("random", BLOCK))]
    frames = [_compress(d, lvl, lvl > 0, lvl != 3) for d, lvl in zip(datas, (1, 3, 19, -5, 22))]
    skippable = (0x184D2A53).to_bytes(4, "little") + (7).to_bytes(4, "little") + b"skipped"
    stream = frames[0] + skippable + b"".join(frames[1:])
    want = b"".join(datas)
    assert native.zstd_decompress(stream, len(want)).tobytes() == want
    # on threads, as the orbax reader decodes a step's chunks
    outs = native.zstd_decompress_batch(frames, [len(d) for d in datas], threads=3)
    assert [o.tobytes() for o in outs] == datas
    bounded = native.zstd_decompress_bounded(stream, len(want) + 100)
    assert bounded.tobytes() == want


def test_every_chunk_of_the_trained_pwcnet_decodes_like_zstandard():
    import json

    import tensorstore as ts

    kv = ts.KvStore.open({"driver": "ocdbt", "base": "file://" + TRAINED_STEP}).result()
    keys = [k.decode() for k in kv.list().result()]
    chunks = [k for k in keys if not k.endswith("/.zarray")]
    assert len(chunks) == 182
    frames, sizes = [], []
    for key in chunks:
        meta = json.loads(kv.read(key.rsplit("/", 1)[0] + "/.zarray").result().value)
        assert meta["compressor"] == {"id": "zstd", "level": 1} and meta["dtype"] == "<f4"
        frames.append(kv.read(key).result().value)
        sizes.append(int(np.prod(meta["chunks"])) * 4)
    got = native.zstd_decompress_batch(frames, sizes)
    for key, frame, size, out in zip(chunks, frames, sizes, got):
        assert out.tobytes() == _zstandard(frame), key


# ---- malformed frames ---------------------------------------------------------

def _malformed_set():
    return [(d, _compress(d, lvl)) for d, lvl in ((_data("weights", 200_000), 3),
                                                  (_data("repetitive", 300_000), 19),
                                                  (_data("random", 20_000), -5))]


def test_truncated_frames_raise():
    for data, frame in _malformed_set():
        for cut in range(0, len(frame), 97):
            with pytest.raises(ValueError, match="zstd"):
                native.zstd_decompress(frame[:cut], len(data))


def test_single_bit_flips_raise_or_decode_the_original():
    """With the content checksum on, a flipped bit either raises or lands
    where the decoder may ignore it (the frame header's unused bit, the
    window descriptor) and the original comes out."""
    rng = np.random.default_rng(1234)
    raised = total = 0
    for data, frame in _malformed_set():
        for pos in rng.integers(0, 8 * len(frame), 400):
            bad = bytearray(frame)
            bad[pos >> 3] ^= 1 << int(pos & 7)
            total += 1
            try:
                out = native.zstd_decompress(bytes(bad), len(data))
            except ValueError:
                raised += 1
                continue
            assert out.tobytes() == data, int(pos)
    assert raised >= 0.95 * total, (raised, total)


def test_wrong_size_bad_checksum_dictionary_and_legacy_frames_raise():
    data = _data("weights", 50_000)
    frame = _compress(data, 3, checksum=True, content_size=False)
    for n in (len(data) - 1, len(data) + 1, 0):
        with pytest.raises(ValueError, match="decode to"):
            native.zstd_decompress(frame, n)
    bad = frame[:-1] + bytes([frame[-1] ^ 0x40])
    with pytest.raises(ValueError, match="content checksum mismatch"):
        native.zstd_decompress(bad, len(data))
    single = _compress(data, 3, checksum=False, content_size=True)
    fhd = single[4]
    assert fhd & 0x20 and not fhd & 3  # single segment, no Dictionary_ID
    with_dict = single[:4] + bytes([fhd | 1, 7]) + single[5:]
    with pytest.raises(ValueError, match="Dictionary_ID 7"):
        native.zstd_decompress(with_dict, len(data))
    with pytest.raises(ValueError, match=r"legacy zstd frame \(magic 0xFD2FB527, format v0.7\)"):
        native.zstd_decompress(b"\x27\xb5\x2f\xfd" + bytes(20), 10)
    with pytest.raises(ValueError, match="not a zstd frame"):
        native.zstd_decompress(b"PNG!" + bytes(20), 10)
    with pytest.raises(ValueError, match="no zstd frame in 0 bytes"):
        native.zstd_decompress(b"", 0)
    # a reserved block type (3) in the first block header
    at = 4 + 1 + 1  # magic, header byte, 1-byte content size (single segment)
    header = bytearray(_compress(b"x" * 100, 1, checksum=False, content_size=True))
    header[at] |= 0b110
    with pytest.raises(ValueError, match="block type 3 is reserved"):
        native.zstd_decompress(bytes(header), 100)
    with pytest.raises(ValueError, match="negative size"):
        native.zstd_decompress(frame, -1)


def _one_sequence_frame(literals: bytes, ll_code: int) -> bytes:
    """A frame by hand (a 1 KiB window, no content size): one compressed
    block, raw literals, one sequence with RLE tables (literal-length code
    `ll_code`, offset code 1 with extra bit 0, i.e. repeat offset 2, match
    length 3)."""
    block = bytes([len(literals) << 3]) + literals + bytes([1, 0x54, ll_code, 1, 0, 0x02])
    header = 1 | (2 << 1) | (len(block) << 3)  # last, compressed
    return (0xFD2FB528).to_bytes(4, "little") + bytes([0, 0]) + header.to_bytes(3, "little") + \
        block


def test_a_match_never_reaches_before_its_frame():
    # literal length 8: repeat offset 2 is the second repeat offset, 4
    good = _one_sequence_frame(b"abcdefgh", 8)
    assert _zstandard(good) == b"abcdefghefg"
    assert native.zstd_decompress(good, 11).tobytes() == b"abcdefghefg"
    # literal length 0: it is the third, 8, with nothing decoded yet in the
    # frame, also after another frame's 100 bytes
    bad = _one_sequence_frame(b"", 0)
    with pytest.raises(zstandard.ZstdError):
        _zstandard(bad)
    before = _compress(_data("random", 100), 3)
    for stream, n in ((bad, 3), (before + bad, 103)):
        with pytest.raises(ValueError, match="match offset 8 reaches before the 0 bytes"):
            native.zstd_decompress(stream, n)
    # a single-segment frame's window is its content: a 15-byte block cannot
    # make 11 bytes
    single = good[:4] + bytes([0x20, 11]) + good[6:]
    with pytest.raises(zstandard.ZstdError):
        _zstandard(single)
    with pytest.raises(ValueError, match="block of 15 bytes exceeds Block_Maximum_Size 11"):
        native.zstd_decompress(single, 11)


def test_treeless_literals_first_and_bits_left_over_raise():
    magic_wd = (0xFD2FB528).to_bytes(4, "little") + bytes([0, 0])

    def frame(block):
        return magic_wd + (1 | (2 << 1) | (len(block) << 3)).to_bytes(3, "little") + block

    # treeless literals (type 3, one stream: 4 literals from 1 byte) in the
    # frame's first block: no earlier Huffman table to take
    header = 3 | (4 << 4) | (1 << 14)
    treeless = frame(header.to_bytes(3, "little") + bytes([0x01, 0]))
    with pytest.raises(zstandard.ZstdError):
        _zstandard(treeless)
    with pytest.raises(ValueError, match="treeless literals without an earlier Huffman table"):
        native.zstd_decompress(treeless, 4)
    # the one-sequence frame with one bit more in its sequences bitstream
    good = _one_sequence_frame(b"abcdefgh", 8)
    assert good[-1] == 0x02
    extra = good[:-1] + bytes([0x04])
    with pytest.raises(zstandard.ZstdError):
        _zstandard(extra)
    with pytest.raises(ValueError, match="sequences bitstream: 1 bits left after 1 sequences"):
        native.zstd_decompress(extra, 11)
