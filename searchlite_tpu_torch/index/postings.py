"""Block-native postings: the TPU-facing inverted index layout.

This is the central TPU-first redesign. The reference stores per-term
varint-compressed posting streams consumed by a doc-at-a-time heap loop
(`index/postings.rs`, `query/wand.rs`). A TPU wants fixed-width batched
work, so postings live as dense arrays shared by ALL terms of a segment:

    block_docs  : int32  [n_blocks, 128]   doc ordinals, padded with -1
    block_tfs   : float32[n_blocks, 128]   term frequencies, padded with 0
    term_block_start/count : int32 [n_terms]  each term's block range
    term_df     : int32  [n_terms]         document frequency
    term_max_tf : float32[n_terms]         max tf (WAND upper bounds)
    block_max_tf: float32[n_blocks]        per-block max tf (BMW bounds)
    block_last_doc: int32[n_blocks]        per-block max doc id

Block width 128 matches both the reference's block-max granularity
(`index/postings.rs:11`) and the TPU lane width, so a block is exactly
one VPU row of work. Positions (for phrase queries) are kept in a
ragged CSR sidecar indexed by posting ordinal (term-major), consumed
host-side on top-k survivors.

On disk the arrays are stored as an uncompressed ``.npz`` so segment
open is a straight mmap-friendly load followed by one device_put.
"""

from __future__ import annotations

import io
from dataclasses import dataclass

import numpy as np

from searchlite_tpu_torch.errors import StorageError

BLOCK = 128  # postings per block == TPU lane width


class InvertedIndexBuilder:
    """Accumulates (term, doc, position) during segment build.

    Same-doc adds merge into one posting with tf += 1 and appended
    positions (parity: `index/postings.rs:31-51`). Docs must arrive in
    non-decreasing ordinal order (the segment writer guarantees this).
    """

    def __init__(self, enable_positions: bool = True):
        self.enable_positions = enable_positions
        # term -> (docs list, tfs list, positions list-of-lists)
        self._terms: dict[str, tuple[list[int], list[int], list[list[int]]]] = {}

    def add_term(self, term: str, doc: int, position: int,
                 with_positions: bool = True) -> None:
        entry = self._terms.get(term)
        if entry is None:
            entry = ([], [], [])
            self._terms[term] = entry
        docs, tfs, poss = entry
        if docs and docs[-1] == doc:
            tfs[-1] += 1
            if self.enable_positions and with_positions:
                poss[-1].append(position)
        else:
            docs.append(doc)
            tfs.append(1)
            poss.append([position] if (self.enable_positions and with_positions)
                        else [])

    def __len__(self) -> int:
        return len(self._terms)

    def build(self) -> "PostingsData":
        terms = sorted(self._terms)
        n_terms = len(terms)
        term_df = np.zeros(n_terms, dtype=np.int32)
        term_block_start = np.zeros(n_terms, dtype=np.int32)
        term_block_count = np.zeros(n_terms, dtype=np.int32)
        term_max_tf = np.zeros(n_terms, dtype=np.float32)

        # First pass: block counts.
        total_blocks = 0
        for t_idx, term in enumerate(terms):
            df = len(self._terms[term][0])
            term_df[t_idx] = df
            term_block_start[t_idx] = total_blocks
            blocks = -(-df // BLOCK) if df else 0
            term_block_count[t_idx] = blocks
            total_blocks += blocks

        block_docs = np.full((total_blocks, BLOCK), -1, dtype=np.int32)
        block_tfs = np.zeros((total_blocks, BLOCK), dtype=np.float32)
        block_term = np.zeros(total_blocks, dtype=np.int32)

        pos_offsets = [0]
        pos_chunks: list[list[int]] = []

        for t_idx, term in enumerate(terms):
            docs, tfs, poss = self._terms[term]
            df = len(docs)
            if df == 0:
                continue
            darr = np.asarray(docs, dtype=np.int32)
            tarr = np.asarray(tfs, dtype=np.float32)
            term_max_tf[t_idx] = tarr.max()
            start = term_block_start[t_idx]
            nb = term_block_count[t_idx]
            flat_docs = block_docs[start:start + nb].reshape(-1)
            flat_tfs = block_tfs[start:start + nb].reshape(-1)
            flat_docs[:df] = darr
            flat_tfs[:df] = tarr
            block_term[start:start + nb] = t_idx
            if self.enable_positions:
                for plist in poss:
                    pos_chunks.append(plist)
                    pos_offsets.append(pos_offsets[-1] + len(plist))

        if self.enable_positions:
            pos_values = np.asarray(
                [p for chunk in pos_chunks for p in chunk], dtype=np.int32)
            pos_off_arr = np.asarray(pos_offsets, dtype=np.int64)
        else:
            pos_values = np.zeros(0, dtype=np.int32)
            pos_off_arr = np.zeros(1, dtype=np.int64)

        block_max_tf = block_tfs.max(axis=1)
        block_last_doc = block_docs.max(axis=1) if total_blocks else \
            np.zeros(0, dtype=np.int32)

        return PostingsData(
            terms=terms,
            block_docs=block_docs,
            block_tfs=block_tfs,
            block_term=block_term,
            term_block_start=term_block_start,
            term_block_count=term_block_count,
            term_df=term_df,
            term_max_tf=term_max_tf,
            block_max_tf=block_max_tf.astype(np.float32),
            block_last_doc=block_last_doc.astype(np.int32),
            pos_values=pos_values,
            pos_offsets=pos_off_arr,
            has_positions=self.enable_positions,
        )


@dataclass
class PostingsData:
    """In-memory (host, numpy) postings for one segment."""

    terms: list[str]
    block_docs: np.ndarray      # [B, 128] int32, pad -1
    block_tfs: np.ndarray       # [B, 128] f32
    block_term: np.ndarray      # [B] int32 (owning term of each block)
    term_block_start: np.ndarray
    term_block_count: np.ndarray
    term_df: np.ndarray
    term_max_tf: np.ndarray
    block_max_tf: np.ndarray
    block_last_doc: np.ndarray
    pos_values: np.ndarray      # [P] int32
    pos_offsets: np.ndarray     # [NNZ+1] int64, posting-ordinal CSR
    has_positions: bool

    # posting ordinal base per term = cumsum of df
    _df_cumsum: np.ndarray | None = None

    def df_base(self, term_id: int) -> int:
        if self._df_cumsum is None:
            self._df_cumsum = np.concatenate(
                [[0], np.cumsum(self.term_df, dtype=np.int64)])
        return int(self._df_cumsum[term_id])

    @property
    def n_terms(self) -> int:
        return len(self.terms)

    @property
    def n_blocks(self) -> int:
        return self.block_docs.shape[0]

    def term_postings(self, term_id: int) -> tuple[np.ndarray, np.ndarray]:
        """(doc_ids, tfs) for one term, unpadded, sorted by doc."""
        start = int(self.term_block_start[term_id])
        nb = int(self.term_block_count[term_id])
        df = int(self.term_df[term_id])
        docs = self.block_docs[start:start + nb].reshape(-1)[:df]
        tfs = self.block_tfs[start:start + nb].reshape(-1)[:df]
        return docs, tfs

    def positions(self, term_id: int, posting_idx: int) -> np.ndarray:
        """Positions of the posting_idx-th posting of a term."""
        if not self.has_positions:
            return np.zeros(0, dtype=np.int32)
        base = self.df_base(term_id) + posting_idx
        lo = int(self.pos_offsets[base])
        hi = int(self.pos_offsets[base + 1])
        return self.pos_values[lo:hi]

    def positions_for_doc(self, term_id: int, doc: int) -> np.ndarray | None:
        docs, _ = self.term_postings(term_id)
        idx = np.searchsorted(docs, doc)
        if idx >= len(docs) or docs[idx] != doc:
            return None
        return self.positions(term_id, int(idx))

    # -- serialization ------------------------------------------------------

    def to_bytes(self) -> bytes:
        buf = io.BytesIO()
        np.savez(
            buf,
            block_docs=self.block_docs,
            block_tfs=self.block_tfs,
            block_term=self.block_term,
            term_block_start=self.term_block_start,
            term_block_count=self.term_block_count,
            term_df=self.term_df,
            term_max_tf=self.term_max_tf,
            block_max_tf=self.block_max_tf,
            block_last_doc=self.block_last_doc,
            pos_values=self.pos_values,
            pos_offsets=self.pos_offsets,
            has_positions=np.array([1 if self.has_positions else 0]),
        )
        return buf.getvalue()

    @classmethod
    def from_bytes(cls, data: bytes, terms: list[str]) -> "PostingsData":
        try:
            npz = np.load(io.BytesIO(data), allow_pickle=False)
        except Exception as e:  # noqa: BLE001
            raise StorageError(f"corrupt postings file: {e}") from e
        return cls(
            terms=terms,
            block_docs=npz["block_docs"],
            block_tfs=npz["block_tfs"],
            block_term=npz["block_term"],
            term_block_start=npz["term_block_start"],
            term_block_count=npz["term_block_count"],
            term_df=npz["term_df"],
            term_max_tf=npz["term_max_tf"],
            block_max_tf=npz["block_max_tf"],
            block_last_doc=npz["block_last_doc"],
            pos_values=npz["pos_values"],
            pos_offsets=npz["pos_offsets"],
            has_positions=bool(npz["has_positions"][0]),
        )

    @classmethod
    def empty(cls) -> "PostingsData":
        return cls(
            terms=[],
            block_docs=np.zeros((0, BLOCK), dtype=np.int32),
            block_tfs=np.zeros((0, BLOCK), dtype=np.float32),
            block_term=np.zeros(0, dtype=np.int32),
            term_block_start=np.zeros(0, dtype=np.int32),
            term_block_count=np.zeros(0, dtype=np.int32),
            term_df=np.zeros(0, dtype=np.int32),
            term_max_tf=np.zeros(0, dtype=np.float32),
            block_max_tf=np.zeros(0, dtype=np.float32),
            block_last_doc=np.zeros(0, dtype=np.int32),
            pos_values=np.zeros(0, dtype=np.int32),
            pos_offsets=np.zeros(1, dtype=np.int64),
            has_positions=True,
        )
