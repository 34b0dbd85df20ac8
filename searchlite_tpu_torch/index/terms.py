"""Terms dictionary: sorted term strings, id = rank.

Replaces the reference's term→file-offset map (`index/terms.rs`,
`util/fst.rs`) with a sorted-array dictionary whose term id indexes the
block-native postings arrays directly. Binary format:

    u64 LE count
    repeated: varint len + utf-8 term bytes   (sorted ascending)
    u32 LE crc32 of everything before it

Prefix iteration is a bisect over the sorted list. Term keys are
``{field}:{token}`` (parity: `index/segment.rs:675-684`).
"""

from __future__ import annotations

import bisect

from searchlite_tpu_torch.errors import StorageError
from searchlite_tpu_torch.utils import varint
from searchlite_tpu_torch.utils.checksum import crc32


def write_terms(terms: list[str]) -> bytes:
    """Serialize a *sorted* list of terms."""
    out = bytearray()
    out += len(terms).to_bytes(8, "little")
    for term in terms:
        data = term.encode()
        out += varint.encode_u64(len(data))
        out += data
    out += crc32(bytes(out)).to_bytes(4, "little")
    return bytes(out)


def read_terms(data: bytes) -> list[str]:
    if len(data) < 12:
        raise StorageError("terms file too short")
    body, stored = data[:-4], int.from_bytes(data[-4:], "little")
    if crc32(body) != stored:
        raise StorageError("terms file checksum mismatch")
    count = int.from_bytes(body[:8], "little")
    terms: list[str] = []
    pos = 8
    for _ in range(count):
        length, pos = varint.decode_u64(body, pos)
        terms.append(body[pos:pos + length].decode())
        pos += length
    return terms


class TermsDict:
    """Sorted term dictionary with exact and prefix lookups."""

    def __init__(self, terms: list[str]):
        self._terms = terms

    def __len__(self) -> int:
        return len(self._terms)

    def get(self, term: str) -> int | None:
        i = bisect.bisect_left(self._terms, term)
        if i < len(self._terms) and self._terms[i] == term:
            return i
        return None

    def term(self, term_id: int) -> str:
        return self._terms[term_id]

    def iter_prefix(self, prefix: str):
        """Yield (term, term_id) for all terms starting with prefix, in order."""
        i = bisect.bisect_left(self._terms, prefix)
        while i < len(self._terms) and self._terms[i].startswith(prefix):
            yield self._terms[i], i
            i += 1

    def iter_range(self, lo: str, hi_exclusive: str | None = None):
        """Yield (term, term_id) for lo <= term < hi_exclusive."""
        i = bisect.bisect_left(self._terms, lo)
        while i < len(self._terms):
            t = self._terms[i]
            if hi_exclusive is not None and t >= hi_exclusive:
                break
            yield t, i
            i += 1

    @property
    def terms(self) -> list[str]:
        return self._terms
