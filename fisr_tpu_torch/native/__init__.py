"""The port's host runtime (port of fisr_tpu/native): PNG decode and encode,
u8 colour conversion, row gather, patch extraction, crc32c and a flow
training sample's crop and augmentation in threaded C++ (csrc/native.cc),
and a zstd decoder (csrc/zstd.cc), built with g++ at first use and bound
with ctypes."""

from fisr_tpu_torch.native.bindings import (available, crc32c, decode_png, decode_png_batch,
                                            decode_png_bytes, encode_png, encode_png_bytes,
                                            extract_patches, flow_sample, gather_rows,
                                            plain_versions, rgb2yuv_matlab_u8, yuv2rgb_matlab_u8,
                                            yuv2rgb_ops_u8, zlib_version, zstd_decompress,
                                            zstd_decompress_batch, zstd_decompress_bounded)

__all__ = ["available", "crc32c", "decode_png", "decode_png_batch", "decode_png_bytes",
           "encode_png", "encode_png_bytes", "extract_patches", "flow_sample", "gather_rows",
           "plain_versions", "rgb2yuv_matlab_u8", "yuv2rgb_matlab_u8", "yuv2rgb_ops_u8",
           "zlib_version", "zstd_decompress", "zstd_decompress_batch", "zstd_decompress_bounded"]
