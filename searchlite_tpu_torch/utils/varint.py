"""LEB128 unsigned varint codec.

Behavioral parity with the reference codec (searchlite-core
`util/varint.rs:5-49`): little-endian base-128 with the continuation
bit in the high bit of each byte. Used by the WAL and postings files.
"""

from __future__ import annotations


def encode_u64(value: int) -> bytes:
    if value < 0:
        raise ValueError("varint cannot encode negative values")
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def decode_u64(buf: bytes, offset: int = 0) -> tuple[int, int]:
    """Decode a varint from ``buf`` at ``offset``.

    Returns ``(value, new_offset)``. Raises ``ValueError`` on truncation
    or overlong encodings (>10 bytes).
    """
    result = 0
    shift = 0
    pos = offset
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        byte = buf[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise ValueError("varint too long")
