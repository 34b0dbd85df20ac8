"""Doc-tile pruned execution in PyTorch: block-max (WAND/BMW) pruning at
the granularity of fixed doc-space tiles.

The port of ``searchlite_tpu/ops/tiles.py``. The bound semantics of a
doc-at-a-time WAND/BMW traversal are kept, at a granularity where the
bound check is one small matmul:

1. **Index time** (host, cached per segment): the doc axis is cut into
   tiles of ``T`` docs. For every (term, tile) with postings the table
   keeps the posting run (start, len) and the tile-max impact. Postings
   are (term, doc)-sorted, so each (term, tile) run is contiguous. Tile
   maxes are packed into the 128-wide block layout postings use, so the
   bound pass reuses the block-gather M build.
2. **Wave 1, bounds**: ``UB[q, tile] = sum_s W[q, s] * tilemax[s, tile]``.
   ``UB`` bounds every doc's score in the tile: impacts >= 0, idf >= 1,
   and the score tree is a sum / dis-max of non-negative leaf scores.
3. **Wave 2, seed**: the per-query top-C tiles by UB are scored exactly.
   All slots' postings inside a chosen tile are gathered (every doc of a
   scored tile gets its complete score; matcher masks, must_not and
   filters evaluate exactly there), densified into a compacted
   ``M [S, n_sel*T]`` and scored with ``W @ M``. The k-th exact score of a
   query is its threshold theta.
4. **Wave 3, survivors** (often empty): every remaining tile with
   ``UB >= theta`` for some query is scored. After it every unscored tile
   has UB < theta for every query, so the merged per-query top-k is exact,
   scores and (score desc, doc asc) tie order included: a doc tying the
   threshold lives in a tile with UB >= theta and was scored.

The host half (:class:`TileIndex`, the run tables, :func:`pack_runs`) is
numpy and builds the JAX module's arrays, array for array; the JAX
``TileIndex``'s host gathers into tile space (``gather_cols``,
``deleted_cols``) and the numpy ``unpack_runs_np`` have no counterpart
here, since the reader gathers and unpacks on the device
(:func:`gather_cols`, ``deleted_tiles``, :func:`unpack_runs`). The device
half is torch ops on the segment's device; the union run scorer ends in
the fused score + mask + top-k (:mod:`.fused_topk`, the hand-written
Hopper kernel on CUDA tensors). Every top-k whose ties can reach a result
or a tile choice is keyed by (value desc, index asc)
(:func:`~searchlite_tpu_torch.ops.score.topk_by_doc`), as ``lax.top_k``
orders them; compacted columns ascend with the doc ordinal.

Pads dropped against the JAX module (they serve XLA's compile cache
only): the pow-2 pad of a launch's tile count (``pad_tiles``), and the
pow-4 / pow-2 bucket of the posting positions ``build_m_from_runs``
materialises, with its dump zone (the host knows the exact count, the
run tables' ``postings``). The run tables still report the bucketed
``p_pad`` and pad ``r_pad``, so the wave budgets and the int32 guard
split waves where the JAX reader splits them.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from searchlite_tpu_torch.ops.fused_topk import fused_topk
from searchlite_tpu_torch.ops.impact import (
    build_block_tables,
    build_m_from_blocks,
    densify_w,
    next_pow2,
    pow2_bucket,
    pow4_bucket,
)
from searchlite_tpu_torch.ops.precision import UB_SAFETY
from searchlite_tpu_torch.ops.score import _matmul_f32, topk_by_doc

# TileIndex's tensors (from_host_arrays keys): the tile-max block layout
# and the deleted mask in tile layout
TILE_KEYS = ("tile_docs", "tile_maxes", "deleted_tiles")


def default_tile_width(n1: int, max_tiles: int = 4096,
                       minimum: int = 512) -> int:
    """Tile width: fine enough to prune, coarse enough that the UB
    matrix stays small (n_tiles <= max_tiles). Multiple of 128."""
    t = minimum
    while -(-n1 // t) > max_tiles:
        t += 128
    return t


class TileIndex:
    """Per-segment doc-tile tables (numpy, tensors on first use), built
    lazily from a DeviceSegment's flat impact-ordered postings."""

    def __init__(self, dseg, tile_width: int | None = None):
        self.dseg = dseg
        host = dseg.host
        n1 = dseg.n1
        T = tile_width or default_tile_width(n1)
        self.T = T
        self.n_tiles = -(-n1 // T)

        docs = host.docs_flat_np
        imps = host.impacts_flat_np
        postings = dseg.reader.postings
        term_df = postings.term_df.astype(np.int64)
        n_terms = len(term_df)
        # docs_flat_np is padded to length 1 for empty segments; guard
        total = int(term_df.sum())
        docs = docs[:total]
        imps = imps[:total]

        term_of = np.repeat(np.arange(n_terms, dtype=np.int64), term_df)
        tile_of = (docs // T).astype(np.int64)
        key = term_of * self.n_tiles + tile_of
        if total:
            is_start = np.empty(total, dtype=bool)
            is_start[0] = True
            np.not_equal(key[1:], key[:-1], out=is_start[1:])
            entry_start = np.flatnonzero(is_start).astype(np.int64)
            entry_len = np.diff(np.append(entry_start, total))
            self.entry_term = term_of[entry_start]
            self.entry_tile = tile_of[entry_start].astype(np.int32)
            self.entry_max = np.maximum.reduceat(imps, entry_start)
        else:
            entry_start = np.zeros(0, dtype=np.int64)
            entry_len = np.zeros(0, dtype=np.int64)
            self.entry_term = np.zeros(0, dtype=np.int64)
            self.entry_tile = np.zeros(0, dtype=np.int32)
            self.entry_max = np.zeros(0, dtype=np.float32)
        self.entry_start = entry_start
        self.entry_len = entry_len
        # per-term entry CSR (entry_term ascending)
        self.entry_base = np.searchsorted(
            self.entry_term, np.arange(n_terms + 1))

        # pack (tile, max) entries into the 128-wide block layout so the
        # UB pass reuses build_m_from_blocks; pad tile = n_tiles routes
        # to the scatter dump zone (n_t1 = n_tiles + 1 columns)
        n_entries = len(entry_start)
        counts = np.diff(self.entry_base)
        eb_cnt = -(-counts // 128)
        self.eb_start = np.concatenate(
            [[0], np.cumsum(eb_cnt)]).astype(np.int64)
        self.eb_cnt = eb_cnt.astype(np.int64)
        total_eb = int(self.eb_start[-1])
        tl_docs = np.full((total_eb + 1, 128), self.n_tiles,
                          dtype=np.int32)
        tl_maxes = np.zeros((total_eb + 1, 128), dtype=np.float32)
        if n_entries:
            run_of = np.repeat(np.arange(n_terms, dtype=np.int64), counts)
            offset = np.arange(n_entries, dtype=np.int64) \
                - self.entry_base[:-1][run_of]
            dest = self.eb_start[:-1][run_of] * 128 + offset
            tl_docs.reshape(-1)[dest] = self.entry_tile
            tl_maxes.reshape(-1)[dest] = self.entry_max
        self.sentinel_row = total_eb
        self.tile_docs_np = tl_docs
        self.tile_maxes_np = tl_maxes
        # the tables' tensors, uploaded at first use; every clone_for of
        # this index holds the same dict
        self._tables: dict = {}
        self._deleted_tiles = None

    def clone_for(self, dseg) -> "TileIndex":
        """This index bound to a tombstone-delta clone of its segment
        (JAX ``TileIndex.clone_for``): the tile tables are built from the
        raw impacts, so they stay sound and are shared, on the host and
        on the device; only the tile layout of ``deleted`` is the clone's
        own (``deleted_tiles_np`` reads the clone's mask, the tensor is
        uploaded at first use)."""
        import copy

        tl = copy.copy(self)
        tl.dseg = dseg
        tl._deleted_tiles = None
        return tl

    # -- wave-1 helpers ------------------------------------------------------

    def ub_block_tables(self, slot_tids):
        """Block-gather tables over the tile-max layout for the given
        slot terms ([nb], [nb], nb_pad): the shape contract of
        build_block_tables over postings."""
        starts = self.eb_start[slot_tids] if len(slot_tids) else \
            np.zeros(0, dtype=np.int64)
        cnts = self.eb_cnt[slot_tids] if len(slot_tids) else \
            np.zeros(0, dtype=np.int64)
        return build_block_tables(starts, cnts,
                                  sentinel_row=self.sentinel_row)

    # -- wave-2/3 helpers ----------------------------------------------------

    def run_tables(self, slot_tids, tiles: np.ndarray):
        """Posting runs restricted to the selected (sorted) tiles.

        Returns dict with ``packed``/``packed_fmt`` (pack_runs: the
        start/off/len/slot arrays as ONE [3 or 4, r_pad] int32 upload,
        pow-4 bucketed) + p_pad + n_cols + postings. Destination column
        of doc d in a run for tile t at rank r: d - t*T + r*T, i.e.
        run_off = (r - t)*T. Runs are emitted slot-major with tiles
        ascending, and docs ascend within a run, so the scatter's flat
        indices are sorted + unique."""
        n_sel = len(tiles)
        e_hit, pos_hit, slot_hit = self._entry_hits(slot_tids, tiles)
        if len(e_hit):
            run_start = self.entry_start[e_hit]
            run_len = self.entry_len[e_hit]
            run_slot = slot_hit
            run_off = (pos_hit.astype(np.int64)
                       - self.entry_tile[e_hit]) * self.T
        else:
            run_start = np.zeros(0, dtype=np.int64)
            run_len = np.zeros(0, dtype=np.int64)
            run_slot = np.zeros(0, dtype=np.int64)
            run_off = np.zeros(0, dtype=np.int64)
        total = int(run_len.sum())
        r_pad = pow4_bucket(max(len(run_start), 1), minimum=64)
        p_pad = pow4_bucket(max(total, 1), minimum=1024)
        packed, fmt = pack_runs(run_start, run_off, run_len, run_slot,
                                r_pad)
        return {
            "packed": packed,
            "packed_fmt": fmt,
            "p_pad": p_pad,
            "n_cols": n_sel * self.T,
            "postings": total,
        }

    def _entry_hits(self, slot_tids, tiles: np.ndarray):
        """Shared CSR expansion for run_tables/tile_postings: expand
        every slot's (term, tile) entry range, match against the sorted
        tile selection with one searchsorted. Returns (entry_idx,
        tile_rank, slot) arrays for the matching entries."""
        n_sel = len(tiles)
        tids = np.asarray(slot_tids, dtype=np.int64)
        if n_sel == 0 or len(tids) == 0:
            z = np.zeros(0, dtype=np.int64)
            return z, z, z
        lo = self.entry_base[tids]
        counts = self.entry_base[tids + 1] - lo
        total = int(counts.sum())
        bases = np.concatenate([[0], np.cumsum(counts)[:-1]])
        e_idx = (np.repeat(lo - bases, counts)
                 + np.arange(total, dtype=np.int64))
        slot_of = np.repeat(np.arange(len(tids), dtype=np.int64), counts)
        etiles = self.entry_tile[e_idx]
        pos = np.searchsorted(tiles, etiles)
        pos_c = np.minimum(pos, n_sel - 1)
        hit = tiles[pos_c] == etiles
        return e_idx[hit], pos_c[hit], slot_of[hit]

    def run_tables_per_query(self, q_tids: np.ndarray,
                             q_tiles: np.ndarray, tpq_pad: int):
        """Per-QUERY posting runs: query q's OWN terms restricted to
        q's OWN selected tiles, the batched pruning formulation that
        keeps each query's candidate set private.

        q_tids [Q, tpq_pad] int64: term ids per query (-1 pads).
        q_tiles [Q, C] int64: each query's selected tiles, ASCENDING
        per row (sentinel = n_tiles pads, matched against nothing).

        Returns runs for build_m_from_runs over the compacted output
        space M_b [Q*tpq_pad, C*T]: destination col of doc d for
        query q, term slot ti, tile rank r is r*T + (d - tile*T), and
        run_slot = q*tpq_pad + ti; flat indices are sorted + unique by
        construction ((q, ti, tile) emission order, docs ascending in
        a run).

        The four run arrays ship as ONE upload ``packed``: ``[3, r_pad]``
        int32 with rows (start, off, slot<<16 | len) when len fits 16
        bits and slot fits 15, else the explicit ``[4, r_pad]``
        (start, off, len, slot). ``packed_fmt`` says which; the pq
        scorer unpacks on the device."""
        Q, C = q_tiles.shape
        tids_flat = q_tids.reshape(-1)
        valid_t = tids_flat >= 0
        safe_tids = np.where(valid_t, tids_flat, 0)
        lo = self.entry_base[safe_tids]
        counts = np.where(valid_t,
                          self.entry_base[safe_tids + 1] - lo, 0)
        total = int(counts.sum())
        if total == 0 or C == 0:
            return {"packed": np.zeros((3, 64), dtype=np.int32),
                    "packed_fmt": 3,
                    "p_pad": 1024, "n_cols": C * self.T, "postings": 0}
        bases = np.concatenate([[0], np.cumsum(counts)[:-1]])
        e_idx = (np.repeat(lo - bases, counts)
                 + np.arange(total, dtype=np.int64))
        row_of = np.repeat(np.arange(Q * tpq_pad, dtype=np.int64),
                           counts)
        etiles = self.entry_tile[e_idx].astype(np.int64)
        # match each entry's tile against ITS query's sorted tile row:
        # one searchsorted over a globally sorted key
        # (q * (n_tiles+2) + tile)
        q_of = row_of // tpq_pad
        keys = q_of * (self.n_tiles + 2) + etiles
        flat_tiles = (np.arange(Q, dtype=np.int64)[:, None]
                      * (self.n_tiles + 2) + q_tiles).reshape(-1)
        pos = np.searchsorted(flat_tiles, keys)
        pos_c = np.minimum(pos, Q * C - 1)
        hit = flat_tiles[pos_c] == keys
        e_hit = e_idx[hit]
        rank_hit = (pos_c[hit] % C).astype(np.int64)
        row_hit = row_of[hit]
        run_start = self.entry_start[e_hit]
        run_len = self.entry_len[e_hit]
        run_off = (rank_hit - etiles[hit]) * self.T
        total_p = int(run_len.sum())
        r_pad = next_pow2(max(len(run_start), 64))
        p_pad = pow2_bucket(max(total_p, 1), minimum=1024)
        packed, fmt = pack_runs(run_start, run_off, run_len, row_hit,
                                r_pad)
        return {
            "packed": packed,
            "packed_fmt": fmt,
            "p_pad": p_pad,
            "n_cols": C * self.T,
            "postings": total_p,
        }

    def tile_postings(self, slot_tids, tiles: np.ndarray) -> np.ndarray:
        """Posting count per selected tile, summed over the given slots
        ([n_sel] int64). Bounds wave launches by the device-side posting
        intermediates, not just the M matrix."""
        out = np.zeros(len(tiles), dtype=np.int64)
        e_hit, pos_hit, _slot = self._entry_hits(slot_tids, tiles)
        if len(e_hit):
            np.add.at(out, pos_hit, self.entry_len[e_hit])
        return out

    @property
    def deleted_tiles_np(self) -> np.ndarray:
        """The deleted mask in tile layout [n_tiles+1, T] bool (sentinel
        row all-deleted)."""
        dp = np.ones((self.n_tiles + 1, self.T), dtype=bool)
        flat = dp[: self.n_tiles].reshape(-1)
        flat[: self.dseg.n1] = self.dseg.host.deleted_np
        return dp

    def host_arrays(self) -> dict[str, np.ndarray]:
        """The numpy arrays behind this index's tensors (TILE_KEYS)."""
        return {"tile_docs": self.tile_docs_np,
                "tile_maxes": self.tile_maxes_np,
                "deleted_tiles": self.deleted_tiles_np}

    def _upload(self, keys: tuple) -> dict:
        from searchlite_tpu_torch.device.index import from_host_arrays

        return from_host_arrays(
            {key: getattr(self, key + "_np") for key in keys},
            self.dseg.device, keys=keys)

    def _table(self, key: str) -> torch.Tensor:
        if key not in self._tables:
            self._tables.update(self._upload(TILE_KEYS[:2]))
        return self._tables[key]

    def drop_tensors(self) -> None:
        """Let go of the device copies; the next use uploads them again.
        The shared tables are rebound, not cleared: another clone of this
        index keeps the ones it holds."""
        self._tables = {}
        self._deleted_tiles = None

    @property
    def tile_docs(self) -> torch.Tensor:
        return self._table("tile_docs")

    @property
    def tile_maxes(self) -> torch.Tensor:
        return self._table("tile_maxes")

    @property
    def deleted_tiles(self) -> torch.Tensor:
        """Device-resident deleted mask in tile layout: wave launches
        row-gather it by tile instead of uploading an [n_cols] bool per
        launch."""
        if self._deleted_tiles is None:
            self._deleted_tiles = self._upload(
                TILE_KEYS[2:])["deleted_tiles"]
        return self._deleted_tiles

    def map_ids(self, tiles: np.ndarray, ids: np.ndarray) -> np.ndarray:
        """Map compacted top-k ids back to doc ordinals."""
        t = tiles[np.minimum(ids // self.T, len(tiles) - 1)]
        return t.astype(np.int64) * self.T + ids % self.T


def pack_runs(run_start, run_off, run_len, run_slot, r_pad: int):
    """Pack the four run arrays into one [3, r_pad] int32 upload
    (start, off, slot<<16 | len) when len fits 16 bits and slot 15,
    else the explicit [4, r_pad]. Returns (packed, fmt).
    SEARCHLITE_RUNS_FMT=4 forces the explicit format (tests exercise
    it end to end; it only engages naturally at >= 2^15-row waves)."""
    n_runs = len(run_start)
    if os.environ.get("SEARCHLITE_RUNS_FMT") == "4":
        pass  # fall through to the explicit format
    elif (n_runs == 0 or (run_len.max(initial=0) < (1 << 16)
                          and run_slot.max(initial=0) < (1 << 15))):
        packed = np.zeros((3, r_pad), dtype=np.int32)
        packed[0, :n_runs] = run_start
        packed[1, :n_runs] = run_off
        packed[2, :n_runs] = (np.asarray(run_slot) << 16) | run_len
        return packed, 3
    packed = np.zeros((4, r_pad), dtype=np.int32)
    packed[0, :n_runs] = run_start
    packed[1, :n_runs] = run_off
    packed[2, :n_runs] = run_len
    packed[3, :n_runs] = run_slot
    return packed, 4


def get_tile_index(dseg, tile_width: int | None = None) -> TileIndex:
    """Process-cached per (segment, width). SEARCHLITE_TILE_WIDTH
    overrides the default width (tests use tiny widths to force the
    pruning machinery onto many tiles)."""
    if tile_width is None:
        tile_width = int(os.environ.get("SEARCHLITE_TILE_WIDTH", 0)) or None
    cached = dseg._tile_index
    if cached is not None and cached.T == (tile_width or cached.T):
        return cached
    tl = TileIndex(dseg, tile_width)
    dseg._tile_index = tl
    return tl


# -- device ops (torch) ------------------------------------------------------


def unpack_runs(runs: torch.Tensor, fmt: int):
    """Device-side inverse of pack_runs: (start, len, slot, off), widened
    to int64 once (they index the flat postings and M). The slot field
    sits above bit 16; the shift is logical (the sign bit's copies are
    masked off)."""
    runs = runs.long()
    if fmt == 3:
        return (runs[0], runs[2] & 0xFFFF, (runs[2] >> 16) & 0xFFFF,
                runs[1])
    return runs[0], runs[2], runs[3], runs[1]


def build_m_from_runs(docs_flat, impacts_flat, run_start, run_len,
                      run_slot, run_off, n_cols: int, s_pad: int,
                      n_post: int):
    """Densify posting RUNS (contiguous CSR slices with per-run
    destination column offsets, int64 as :func:`unpack_runs` gives them)
    into a compacted M [s_pad, n_cols] f32. ``n_post`` is the runs' total
    length, which the host knows exactly (the run tables' ``postings``):
    the JAX op materialises a padded bucket of positions and routes the
    excess to a dump zone; here no position is excess. Position p belongs
    to the run whose cumulative end first passes it (a binary search over
    the ends, where the JAX op scatters marks and scans). Flat indices are
    unique by construction (TileIndex.run_tables), so the scatter is
    deterministic."""
    dev = docs_flat.device
    m_flat = torch.zeros(s_pad * n_cols, dtype=torch.float32, device=dev)
    if n_post == 0:
        return m_flat.reshape(s_pad, n_cols)
    ends = torch.cumsum(run_len, dim=0)
    positions = torch.arange(n_post, dtype=torch.int64, device=dev)
    rid = torch.searchsorted(ends, positions, right=True)
    p_idx = (run_start - (ends - run_len))[rid] + positions
    dest = docs_flat[p_idx] + run_off[rid]
    m_flat[run_slot[rid] * n_cols + dest] = \
        impacts_flat[p_idx].to(torch.float32)
    return m_flat.reshape(s_pad, n_cols)


def ub_scorer(tile_docs, tile_maxes, blk_idx, slot_row, w_idx, w_val, *,
              n_t1: int, s_pad: int, n_queries: int):
    """Wave 1: the full UB matrix [Q, n_t1] = W @ TileMax times
    UB_SAFETY (no top-k: the seed choice and the survivor check need
    every tile's bound)."""
    m = build_m_from_blocks(tile_docs, tile_maxes, blk_idx, slot_row,
                            n_t1, s_pad)
    w = densify_w(w_idx, w_val, n_queries, s_pad)
    return _matmul_f32(w, m) * UB_SAFETY


def seed_select(ub, processed, theta, *, c: int):
    """Per-query tile selection on the device: the top-C tiles by UB
    (ties to the lowest tile) among those not yet processed, positive and
    at least theta. Returns (tile ids [Q, C] int32, n_tiles where none
    qualifies; the qualifying count [Q] left AFTER this selection; the
    updated processed mask)."""
    n_tiles = ub.shape[1]
    eligible = ~processed & (ub > 0.0) & (ub >= theta[:, None])
    masked = torch.where(eligible, ub, float("-inf"))
    vals, ids = topk_by_doc(masked, min(c, n_tiles))
    found = vals > float("-inf")
    ids = torch.where(found, ids, n_tiles).to(torch.int32)
    remaining = torch.clamp(eligible.sum(dim=1) - found.sum(dim=1), min=0)
    # one spare column takes the sentinel ids
    marks = torch.zeros((ub.shape[0], n_tiles + 1), dtype=torch.bool,
                        device=ub.device)
    marks.scatter_(1, ids.long(), True)
    return ids, remaining, processed | marks[:, :n_tiles]


def pq_run_scorer(docs_flat, impacts_flat, deleted_tiles, tiles_b, w_b,
                  runs, *, k: int, n_cols: int, n_post: int, tpq_pad: int,
                  t: int, fmt: int = 3):
    """Per-query wave scorer: M_b [Q*tpq, C*T] from per-query runs, a
    batched matvec against each query's term weights (f32, TF32 off),
    top-k over the query's OWN compacted columns, ids mapped back to doc
    ordinals on the device. Returns (scores [Q, min(k, n_cols)], doc ids
    int32)."""
    run_start, run_len, run_slot, run_off = unpack_runs(runs, fmt)
    q = tiles_b.shape[0]
    m = build_m_from_runs(docs_flat, impacts_flat, run_start, run_len,
                          run_slot, run_off, n_cols, q * tpq_pad, n_post)
    # einsum("qt,qtc->qc") as one batched product
    scores = _matmul_f32(w_b[:, None, :],
                         m.reshape(q, tpq_pad, n_cols))[:, 0, :]
    # deleted mask in each query's tile space (row gathers from the
    # resident padded copy; the sentinel tile row is all-deleted)
    del_cols = deleted_tiles[tiles_b.long()].reshape(q, n_cols)
    ok = (scores > 0.0) & ~del_cols
    masked = torch.where(ok, scores, float("-inf"))
    top, idx = topk_by_doc(masked, min(k, n_cols))
    tile_of = torch.gather(tiles_b, 1, (idx // t).long())
    doc_ids = (tile_of * t + idx % t).to(torch.int32)
    doc_ids = torch.where(top > float("-inf"), doc_ids, 0)
    return top, doc_ids


def topk_merge(s_a, d_a, s_b, d_b, lims):
    """Running top-k merge of two (scores, ids) sets on the device in
    (score desc, doc asc) order (two stable sorts: doc, then score
    descending), plus the per-query threshold at each query's own limit.
    Returns (scores [Q, k], ids [Q, k], theta [Q]); k = s_a's width."""
    s = torch.cat([s_a, s_b], dim=1)
    d = torch.cat([d_a, d_b], dim=1)
    k = s_a.shape[1]
    order_doc = torch.argsort(d, dim=1, stable=True)
    s1 = torch.gather(s, 1, order_doc)
    d1 = torch.gather(d, 1, order_doc)
    order_sc = torch.argsort(-s1, dim=1, stable=True)
    s2 = torch.gather(s1, 1, order_sc)[:, :k]
    d2 = torch.gather(d1, 1, order_sc)[:, :k]
    valid = (s2 > float("-inf")).sum(dim=1)
    full = valid >= lims
    li = torch.clamp(torch.clamp(lims, max=s2.shape[1]) - 1, min=0)
    theta = torch.gather(s2, 1, li.long()[:, None])[:, 0]
    theta = torch.where(full, theta, float("-inf"))
    return s2, d2, theta


def tile_cols(tiles, t: int, n1: int):
    """The doc ordinals of the selected tiles' columns on the device:
    (clamped ordinals [n_sel*T] int64, past-n1 mask [n_sel*T] bool), once
    a wave for every :func:`gather_cols` of it."""
    cols = (tiles.long()[:, None] * t + torch.arange(
        t, dtype=torch.int64, device=tiles.device)[None, :]).reshape(-1)
    return torch.clamp(cols, max=n1 - 1), cols >= n1


def gather_cols(arr, cols, oob, fill):
    """A doc-axis tensor [..., n1] in tile space [..., n_sel*T] on the
    device: the columns :func:`tile_cols` names, ``fill`` past n1 (a sentinel tile is all
    fill)."""
    return torch.where(oob, fill, arr[..., cols])


def run_batch_scorer(docs_flat, impacts_flat, deleted_tiles, tiles, runs,
                     w_idx, w_val, filter_rows=None, fidx=None, *, k: int,
                     n_cols: int, n_post: int, s_pad: int, n_queries: int,
                     fmt: int = 3):
    """Wave-2/3 batched scorer over the union of the batch's selected
    tiles: M [s_pad, n_sel*T] from the runs, W from the COO weights, then
    the fused score + mask + top-k (score > 0, not deleted, the query's
    filter row). ``filter_rows`` [F+1, n_cols] bool is already in tile
    space (:func:`gather_cols`). Returns (scores [Q, k], compacted column ids [Q, k] int32)."""
    run_start, run_len, run_slot, run_off = unpack_runs(runs, fmt)
    m = build_m_from_runs(docs_flat, impacts_flat, run_start, run_len,
                          run_slot, run_off, n_cols, s_pad, n_post)
    deleted_cols = deleted_tiles[tiles.long()].reshape(-1)
    w = densify_w(w_idx, w_val, n_queries, s_pad)
    return fused_topk(w, m, deleted_cols, k=k, filter_rows=filter_rows,
                      fidx=fidx)
