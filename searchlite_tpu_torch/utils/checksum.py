"""CRC32 checksums (IEEE, same polynomial as the reference's crc32fast;
see searchlite-core `util/checksum.rs:3-7`)."""

from __future__ import annotations

import zlib


def crc32(data: bytes, value: int = 0) -> int:
    """crc32 of ``data``, optionally continuing from a prior ``value``
    — crc32(b + p) == crc32(p, crc32(b)), so framed formats can skip
    concatenating header bytes with large payloads."""
    return zlib.crc32(data, value) & 0xFFFFFFFF
