"""DeviceSegment: one segment's sparse-scoring arrays as torch tensors.

Two layers. :class:`HostSegment` is the numpy build of a segment (the
port's copy of ``searchlite_tpu/device/index.py::DeviceSegment`` as
``DeviceSegment(reader, ord, jnp=numpy)`` builds it, without any JAX
member): the padded doc axis ``n1`` and block layout, the BM25 impacts
(one native pass, or numpy), the flat CSR postings, the f64/f32 idf
tables, the packed term table, the sentinels, the deletion mask and the
heavy-term lookup. The query prep and the partitions read it.
:class:`DeviceSegment` uploads what the batched routes read to an
explicit ``torch.device``:

- ``block_docs [n_block_rows+1, 128] int32``: doc ordinals, pads and the
  trailing gather-pad row hold the dead slot ``n1-1``;
- ``block_impacts_live [n_block_rows+1, 128] f32``: impacts with
  tombstoned docs zeroed (the strip scorer's deletion contract);
- ``sparse_tid_tbl [3, n_terms_pad] int32``: per term id the block
  start, block count and f32 idf bit-cast;
- ``sparse_sentinels [2] int32``: (sentinel block row, ``n1-1``);
- ``deleted [n1] bool``.

and, built on first use and cached, what the dense and term-split scorers
read: :meth:`DeviceSegment.dense_rows` (resident f32 impact rows of the
highest-df terms) and :meth:`DeviceSegment.heavy_lookup` (the head-term
doc-to-block lookup). The single-query reader also reads the host build's
``posting_base``, ``block_max_impact`` (per-block max impact, the
pruning telemetry) and ``live_term_df`` (the term split's counts).

Impacts stay f32. :func:`cached_segment` shares segments across readers.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

from searchlite_tpu_torch.index.segment import SegmentReader
from searchlite_tpu_torch.ops.impact import pow2_bucket, pow15_bucket
from searchlite_tpu_torch.ops.sparse import build_heavy_lookup_host


class HostSegment:
    """A segment's numpy build for the batched routes. Arrays equal the
    JAX package's ``DeviceSegment(reader, ord, jnp=numpy)``'s of the same
    names, array for array."""

    def __init__(self, reader: SegmentReader, segment_ord: int,
                 k1: float = 0.9, b: float = 0.4):
        self.reader = reader
        self.ord = segment_ord
        self.n_docs = reader.doc_count
        self.n1 = self.n_docs + 1  # +1 sentinel slot
        # small segments pad the doc axis (and below, the block-row axis)
        # to a power of two, as the JAX build does: pad slots carry no
        # postings, ``deleted`` masks them, and the dead slot stays n1-1
        pad_max = int(os.environ.get("SEARCHLITE_PAD_DOCS_MAX", "262144"))
        if 0 < self.n1 <= pad_max:
            self.n1 = pow2_bucket(self.n1, minimum=256)
        self.k1 = float(k1)
        self.b = float(b)

        postings = reader.postings
        bd = postings.block_docs
        if bd.shape[0] == 0:
            bd = np.full((1, 128), -1, dtype=np.int32)
        self.n_block_rows = bd.shape[0]

        # per-field doc lengths plus one zero row (avgdl 0 -> norm 1) for
        # length-less fields (keywords)
        len_fields = sorted(
            name[len("_len:"):] for name in reader.fast.columns
            if name.startswith("_len:"))
        self.len_field_ids = {f: i for i, f in enumerate(len_fields)}
        n_fields = len(len_fields) + 1
        doc_len = np.zeros((n_fields, self.n1), dtype=np.float32)
        avgdl = np.zeros(n_fields, dtype=np.float32)
        for field, fid in self.len_field_ids.items():
            col = reader.fast.column(f"_len:{field}")
            if col is not None and len(col.values):
                doc_len[fid, col.row_ids] = col.values.astype(np.float32)
            avgdl[fid] = np.float32(reader.avg_field_length(field))

        deleted = np.zeros(self.n1, dtype=bool)
        deleted[self.n_docs:] = True  # sentinel + doc-axis pad slots
        for d in reader.deleted:
            if 0 <= d < self.n_docs:
                deleted[d] = True
        self.deleted_np = deleted
        self.live_docs = int(self.n_docs - len(reader.deleted))

        # impact-ordered flat postings: tf saturation and length norm are
        # query-independent, so every posting's impact is computed here
        term_df = postings.term_df.astype(np.int64)
        self.posting_base = np.concatenate(
            [[0], np.cumsum(term_df)]).astype(np.int64)
        if len(postings.terms):
            term_fields = np.asarray(
                [self.len_field_ids.get(t.split(":", 1)[0], n_fields - 1)
                 for t in postings.terms], dtype=np.int32)
        else:
            term_fields = np.zeros(0, dtype=np.int32)
        docs_flat = impacts = None
        if postings.block_docs.size:
            out = self._impacts_native(postings, term_fields, term_df,
                                       doc_len, avgdl)
            if out is None:
                out = self._impacts_numpy(postings, term_fields, term_df,
                                          doc_len, avgdl)
            (self.block_docs_np, self.block_impacts_np,
             self.block_max_impact, docs_flat, impacts) = out
        else:
            self.block_max_impact = np.zeros(0, dtype=np.float32)
            self.block_docs_np = np.concatenate([
                np.where(bd < 0, self.n1 - 1, bd).astype(np.int32),
                np.full((1, 128), self.n1 - 1, dtype=np.int32)])
            self.block_impacts_np = np.zeros((bd.shape[0] + 1, 128),
                                             dtype=np.float32)
        if self.n1 != self.n_docs + 1:
            rows = self.block_docs_np.shape[0]
            p_rows = pow2_bucket(rows, minimum=16)
            if p_rows > rows:
                self.block_docs_np = np.concatenate([
                    self.block_docs_np,
                    np.full((p_rows - rows, 128), self.n1 - 1,
                            dtype=np.int32)])
                self.block_impacts_np = np.concatenate([
                    self.block_impacts_np,
                    np.zeros((p_rows - rows, 128), dtype=np.float32)])
        if docs_flat is None or len(docs_flat) == 0:
            docs_flat = np.zeros(1, dtype=np.int32)
            impacts = np.zeros(1, dtype=np.float32)
        self.docs_flat_np = docs_flat.astype(np.int32, copy=False)
        self.impacts_flat_np = impacts
        self._idf_table = None
        self._idf32 = None
        self._sparse_tid_tbl = None
        self._heavy_lookup_host = None
        self._live_df_cache: dict[int, int] = {}

    def _impacts_native(self, postings, term_fields, term_df, doc_len,
                        avgdl):
        """One C pass (``native/slt_ingest.cpp::slt_impacts``): the padded
        block-doc/impact arrays, per-block max impacts and the pad-stripped
        flat CSR, bit-identical to :meth:`_impacts_numpy`. None when the
        native library is unavailable."""
        from searchlite_tpu_torch.native import get_lib

        lib = get_lib()
        if lib is None or not hasattr(lib, "slt_impacts"):
            return None
        bd = np.ascontiguousarray(postings.block_docs, dtype=np.int32)
        bt = np.ascontiguousarray(postings.block_tfs, dtype=np.float32)
        n_rows = bd.shape[0]
        row_field = np.ascontiguousarray(np.repeat(
            term_fields, postings.term_block_count.astype(np.int64)),
            dtype=np.int32)
        n_post = int(term_df.sum())
        bd_out = np.empty((n_rows + 1, 128), dtype=np.int32)
        bi_out = np.empty((n_rows + 1, 128), dtype=np.float32)
        block_max = np.empty(n_rows, dtype=np.float32)
        docs_flat = np.empty(max(n_post, 1), dtype=np.int32)
        impacts = np.empty(max(n_post, 1), dtype=np.float32)
        n_flat = lib.slt_impacts(
            bd, n_rows, row_field, bt,
            np.ascontiguousarray(doc_len), doc_len.shape[1],
            np.ascontiguousarray(avgdl), self.k1, self.b,
            np.int32(self.n1 - 1), bd_out, bi_out, block_max,
            docs_flat, impacts)
        if n_flat != n_post:  # pads and term_df disagree: use numpy
            return None
        return (bd_out, bi_out, block_max, docs_flat[:n_post],
                impacts[:n_post])

    def _impacts_numpy(self, postings, term_fields, term_df, doc_len,
                       avgdl):
        """Pure-numpy impacts; the behavioural spec for ``slt_impacts``."""
        bd = postings.block_docs
        flat_mask = bd.reshape(-1) >= 0
        docs_flat = bd.reshape(-1)[flat_mask]
        tfs_flat = postings.block_tfs.reshape(-1)[flat_mask]
        pf = np.repeat(term_fields, term_df)
        dl = doc_len[pf, docs_flat] if len(docs_flat) else \
            np.zeros(0, dtype=np.float32)
        avg = avgdl[pf] if len(docs_flat) else \
            np.zeros(0, dtype=np.float32)
        norm = np.where(avg > 0, dl / np.where(avg > 0, avg, 1.0), 1.0)
        denom = np.maximum(
            tfs_flat + self.k1 * (1.0 - self.b + self.b * norm), 1e-6)
        impacts = (tfs_flat * (self.k1 + 1.0) / denom).astype(np.float32)
        blocked = np.zeros(bd.size, dtype=np.float32)
        blocked[flat_mask] = impacts
        block_max = blocked.reshape(-1, bd.shape[1]).max(axis=1)
        bi_out = np.concatenate(
            [blocked.reshape(-1, 128), np.zeros((1, 128), dtype=np.float32)])
        bd_out = np.concatenate(
            [np.where(bd < 0, self.n1 - 1, bd).astype(np.int32),
             np.full((1, 128), self.n1 - 1, dtype=np.int32)])
        return bd_out, bi_out, block_max, docs_flat, impacts

    @property
    def idf_table(self) -> np.ndarray:
        """f64 [n_terms] BM25 idf per term id over the live doc count;
        the batch builders (Python and native) read term idf from here,
        so their weights are bit-identical."""
        if self._idf_table is None:
            df = self.reader.postings.term_df.astype(np.float64)
            live = float(max(self.live_docs, 0))
            ratio = (live - df + 0.5) / (df + 0.5)
            with np.errstate(divide="ignore", invalid="ignore"):
                self._idf_table = np.where(
                    ratio <= 0.0, 1.0,
                    np.maximum(np.log(np.maximum(ratio, 1e-300)), 0.0)
                    + 1.0)
        return self._idf_table

    @property
    def idf32(self) -> np.ndarray:
        """``idf_table`` rounded to f32: the values the packed scorer's
        weight decode reads from ``sparse_tid_tbl``."""
        if self._idf32 is None:
            self._idf32 = self.idf_table.astype(np.float32)
        return self._idf32

    @property
    def sparse_tid_tbl(self) -> np.ndarray:
        """[3, n_terms_pad] int32: per term id the posting block start,
        block count and f32 idf bit-cast; the term axis pads to a pow-1.5
        bucket."""
        if self._sparse_tid_tbl is None:
            p = self.reader.postings
            n = len(p.term_df)
            tbl = np.zeros((3, pow15_bucket(max(n, 1), minimum=1024)),
                           dtype=np.int32)
            tbl[0, :n] = p.term_block_start.astype(np.int32)
            tbl[1, :n] = p.term_block_count.astype(np.int32)
            tbl[2, :n] = self.idf32.view(np.int32)
            self._sparse_tid_tbl = tbl
        return self._sparse_tid_tbl

    @property
    def sparse_sentinels(self) -> np.ndarray:
        """[2] int32: (sentinel block row, dead doc slot ``n1-1``)."""
        return np.array([self.n_block_rows, self.n1 - 1], dtype=np.int32)

    def heavy_lookup_host(self, term_cap: int) -> dict[str, np.ndarray]:
        """The heavy-term doc-to-block lookup
        (``ops/sparse.py::build_heavy_lookup_host``), cached per term cap.
        Its ``maximp`` (f32 [n_terms], every term) also feeds the
        term-split partition's routing predictor."""
        cached = self._heavy_lookup_host
        if cached is not None and cached[0] == term_cap:
            return cached[1]
        host = build_heavy_lookup_host(
            self.reader.postings, self.block_docs_np, self.block_impacts_np,
            self.n1, term_cap)
        self._heavy_lookup_host = (term_cap, host)
        return host


    def live_term_df(self, tid: int) -> int:
        """Exact live (non-tombstoned) document frequency of one term: the
        single-query term split's count arithmetic (|light | heavy| =
        n_strip + live_df - overlap) needs it. Free without deletions;
        otherwise one pass over the term's postings, cached per term."""
        p = self.reader.postings
        if self.live_docs == self.n_docs:
            return int(p.term_df[tid])
        got = self._live_df_cache.get(tid)
        if got is None:
            base = int(p.df_base(tid))
            docs = self.docs_flat_np[base: base + int(p.term_df[tid])]
            got = int(np.count_nonzero(~self.deleted_np[docs]))
            self._live_df_cache[tid] = got
        return got


TENSOR_KEYS = ("block_docs", "block_impacts_live", "sparse_tid_tbl",
               "sparse_sentinels", "deleted")
# DeviceSegment.heavy_lookup's tensors (ops/sparse.py::build_heavy_lookup_
# host): the lookup table, per-term base and log2 group width, max impact
HEAVY_KEYS = ("tbl", "base", "log2g", "maximp")
# DeviceSegment.flat_postings' tensors: the (term, doc)-sorted CSR postings
# the doc-tile run scorers read (int32 docs, f32 RAW impacts: the tile
# path masks tombstones by ``deleted_tiles``); 8 bytes a posting
FLAT_KEYS = ("docs_flat", "impacts_flat")


def host_arrays(host: HostSegment) -> dict[str, np.ndarray]:
    """The numpy arrays behind the port's tensors, from the host build.
    ``block_impacts_live`` folds tombstones in as the JAX segment does on
    device (impacts times the live mask)."""
    live = (~host.deleted_np)[host.block_docs_np]
    return {
        "block_docs": np.asarray(host.block_docs_np, dtype=np.int32),
        "block_impacts_live": (host.block_impacts_np.astype(np.float32)
                               * live.astype(np.float32)),
        "sparse_tid_tbl": np.asarray(host.sparse_tid_tbl,
                                     dtype=np.int32),
        "sparse_sentinels": np.asarray(host.sparse_sentinels,
                                       dtype=np.int32),
        "deleted": np.asarray(host.deleted_np, dtype=bool),
    }


def from_host_arrays(arrays: dict[str, np.ndarray], device,
                     keys=TENSOR_KEYS) -> dict[str, torch.Tensor]:
    """Carry a segment's state across: the numpy arrays of ``keys`` (from
    the host build, or any other source of the same layout) as tensors on
    ``device``, bit for bit. The default
    keys are the strip route's; :data:`HEAVY_KEYS` carries a
    ``heavy_lookup(term_cap)``, ``("m_dense",)`` a
    ``dense_rows(budget)["m_dense"]``, :data:`FLAT_KEYS` the flat
    postings and ``ops/tiles.py::TILE_KEYS`` a ``TileIndex``'s tables."""
    device = torch.device(device)
    out = {}
    for key in keys:
        arr = np.ascontiguousarray(arrays[key])
        out[key] = torch.from_numpy(arr.copy()).to(device)
    return out


class DeviceSegment:
    """A segment's tensors on one torch device, plus the host members the
    query prep and partitions read (through ``host``, the
    :class:`HostSegment`)."""

    def __init__(self, reader: SegmentReader, segment_ord: int, device,
                 k1: float = 0.9, b: float = 0.4):
        self.host = HostSegment(reader, segment_ord, k1=k1, b=b)
        self.device = torch.device(device)
        self.reader = reader
        self.ord = segment_ord
        self.n_docs = self.host.n_docs
        self.n1 = self.host.n1
        self.n_block_rows = self.host.n_block_rows
        self.live_docs = self.host.live_docs
        self.posting_base = self.host.posting_base
        self.block_max_impact = self.host.block_max_impact
        self.live_term_df = self.host.live_term_df
        self.heavy_lookup_host = self.host.heavy_lookup_host
        tensors = from_host_arrays(host_arrays(self.host), self.device)
        self.block_docs = tensors["block_docs"]
        self.block_impacts_live = tensors["block_impacts_live"]
        self.sparse_tid_tbl = tensors["sparse_tid_tbl"]
        self.sparse_sentinels = tensors["sparse_sentinels"]
        self.deleted = tensors["deleted"]
        self._dense_rows: dict = {}
        self._heavy_lookup: dict = {}
        self._flat_postings = None
        self._tile_index = None  # ops/tiles.py::get_tile_index
        self.filter_rows_cache = None  # (filter key, [F+1, n1] bool)
        self._doc_shards = None  # doc_shards(n_shards), the last n_shards
        # ops/device_aggs.py: per-spec bucket structures and their tensors
        self.agg_struct_cache: dict = {}

    def flat_postings(self) -> dict[str, torch.Tensor]:
        """The flat CSR postings on this segment's device (keys
        :data:`FLAT_KEYS`), uploaded at the first pruned or chunked use
        and cached: 8 bytes a posting."""
        if self._flat_postings is None:
            self._flat_postings = from_host_arrays(
                {"docs_flat": self.host.docs_flat_np,
                 "impacts_flat": self.host.impacts_flat_np},
                self.device, keys=FLAT_KEYS)
        return self._flat_postings

    def evict_device_caches(self) -> None:
        """Drop the device residents that can be rebuilt from the host
        build (the dense rows, the heavy-term lookup, the filter rows, the
        flat postings, the tile tables' tensors, the doc-shard tables with
        their deleted stack, the aggregation structures, the vector
        matrices). Called when a launch runs out of device memory; the
        next query that needs one uploads it again."""
        self._dense_rows = {}
        self._heavy_lookup = {}
        self._flat_postings = None
        self.filter_rows_cache = None
        self._doc_shards = None
        self.agg_struct_cache = {}
        for vdata in getattr(self.reader, "vectors", {}).values():
            vdata.__dict__.pop("_torch_vectors", None)
        if self._tile_index is not None:
            self._tile_index.drop_tensors()

    def doc_shards(self, n_shards: int) -> dict:
        """The doc-sharded layout of the segment's postings (JAX
        ``DeviceSegment.doc_shards``): the flat postings re-sorted by
        (doc shard, term, doc), each (term, shard) run re-blocked 128 wide
        with LOCAL doc ordinals, the local sentinel doc ``shard_width``
        (a shard's doc axis is ``shard_width + 1`` wide). Every shard's
        slice is still term-major and doc-ascending, so one shard scores
        through the same block gather as a whole segment. ``block_docs``
        int32 and ``block_impacts`` f32 (RAW impacts: tombstones are
        masked by the shard's deleted row) go to the segment's device;
        ``block_base`` / ``blocks`` / ``counts`` (per key
        ``shard * n_terms + term``), ``docs_sh_np`` / ``imps_sh_np`` /
        ``posting_base`` stay on the host. Cached for the last
        ``n_shards``."""
        cached = self._doc_shards
        if cached is not None and cached["n_shards"] == n_shards:
            return cached
        host = self.host
        docs_flat = host.docs_flat_np
        n_terms = len(self.reader.postings.terms)
        term_df = self.reader.postings.term_df.astype(np.int64)
        term_of_posting = np.repeat(
            np.arange(n_terms, dtype=np.int32), term_df)
        shard_width = -(-self.n1 // n_shards)
        shard_of = (docs_flat // shard_width).astype(np.int32)
        order = np.lexsort((docs_flat, term_of_posting, shard_of))
        docs_sh = (docs_flat[order] - shard_of[order].astype(np.int64)
                   * shard_width).astype(np.int32)
        imps_sh = host.impacts_flat_np[order]
        # per-(term, shard) posting counts: the key is sorted by
        # (shard, term), so offsets come from a bincount over key ids
        key = shard_of[order].astype(np.int64) * n_terms + \
            term_of_posting[order]
        counts = np.bincount(key, minlength=n_shards * n_terms)
        base = np.concatenate([[0], np.cumsum(counts)])
        blocks = -(-counts // 128)
        block_base = np.concatenate([[0], np.cumsum(blocks)])
        total_blocks = int(block_base[-1])
        bdocs = np.full((total_blocks + 1, 128), shard_width,
                        dtype=np.int32)
        bimps = np.zeros((total_blocks + 1, 128), dtype=np.float32)
        if len(docs_sh):
            run_of = np.repeat(np.arange(len(counts), dtype=np.int64),
                               counts)
            offset = np.arange(len(docs_sh), dtype=np.int64) \
                - base[:-1][run_of]
            dest = block_base[:-1][run_of] * 128 + offset
            bdocs.reshape(-1)[dest] = docs_sh
            bimps.reshape(-1)[dest] = imps_sh
        tensors = from_host_arrays(
            {"block_docs": bdocs, "block_impacts": bimps}, self.device,
            keys=("block_docs", "block_impacts"))
        cached = {
            "n_shards": n_shards,
            "shard_width": int(shard_width),
            "block_docs": tensors["block_docs"],
            "block_impacts": tensors["block_impacts"],
            "block_base": block_base,
            "blocks": blocks,
            "sentinel_row": total_blocks,
            "counts": counts,
            "n_terms": n_terms,
            "docs_sh_np": docs_sh,
            "imps_sh_np": imps_sh,
            "posting_base": base,
        }
        self._doc_shards = cached
        return cached

    def dense_rows(self, budget_bytes: int):
        """Resident dense impact rows for the highest-df terms (df >=
        n1/512, highest first) within ``budget_bytes``, the host half of
        the JAX ``DeviceSegment.dense_rows`` in numpy: one vectorized
        scatter of the selected terms' postings (tombstoned docs keep
        their impacts; the scorers mask them). f32 always: the port keeps
        exact f32. Returns None when no term qualifies, else
        ``{"row_of_tid": {tid: row}, "m_dense": [R+1, n1] f32}`` (last
        row zeros, the pad row). Cached per budget."""
        if budget_bytes in self._dense_rows:
            return self._dense_rows[budget_bytes]
        host = self.host
        term_df = host.reader.postings.term_df.astype(np.int64)
        max_rows = budget_bytes // (self.n1 * 4)
        order = np.argsort(-term_df, kind="stable")
        sel = order[:max_rows]
        rows = sel[term_df[sel] * 512 >= self.n1]
        out = None
        if len(rows):
            n_rows = len(rows)
            m = np.zeros((n_rows + 1) * self.n1, dtype=np.float32)
            dfs = term_df[rows]
            total = int(dfs.sum())
            if total:
                row_of = np.repeat(np.arange(n_rows, dtype=np.int64), dfs)
                p_idx = (np.repeat(host.posting_base[rows] - np.concatenate(
                    [[0], np.cumsum(dfs)[:-1]]), dfs)
                    + np.arange(total, dtype=np.int64))
                docs = host.docs_flat_np[p_idx].astype(np.int64)
                m[row_of * self.n1 + docs] = host.impacts_flat_np[p_idx]
            out = {
                "row_of_tid": {int(t): i for i, t in enumerate(rows)},
                "m_dense": from_host_arrays(
                    {"m_dense": m.reshape(n_rows + 1, self.n1)},
                    self.device, keys=("m_dense",))["m_dense"],
            }
        self._dense_rows[budget_bytes] = out
        return out

    def heavy_lookup(self, term_cap: int) -> dict[str, torch.Tensor]:
        """The term-split scorer's head-term lookup (keys
        :data:`HEAVY_KEYS`: ``tbl``/``base``/``log2g`` int32, ``maximp``
        f32 [n_terms]) on this segment's device, over the host build
        ``heavy_lookup_host(term_cap)``. Cached per term cap."""
        hit = self._heavy_lookup.get(term_cap)
        if hit is None:
            hit = from_host_arrays(self.host.heavy_lookup_host(term_cap),
                                   self.device, keys=HEAVY_KEYS)
            self._heavy_lookup[term_cap] = hit
        return hit


# Segments are immutable (a tombstone change is a new key), so their
# uploads are shared by every reader a commit reopens. Bounded FIFO.
_SEGMENTS: dict[tuple, tuple] = {}
_MAX_CACHED_SEGMENTS = 64
_LOCK = threading.Lock()


def cached_segment(storage, meta, ordinal: int, k1: float, b: float,
                   device) -> tuple[SegmentReader, DeviceSegment]:
    """(SegmentReader, DeviceSegment) for an immutable segment, keyed by
    (segment id, k1, b, tombstones, device, ordinal)."""
    device = torch.device(device)
    key = (meta.id, float(k1), float(b), tuple(meta.deleted_docs),
           str(device), ordinal)
    with _LOCK:
        hit = _SEGMENTS.get(key)
    if hit is not None:
        return hit
    seg = SegmentReader(meta, storage)
    dseg = DeviceSegment(seg, ordinal, device, k1=k1, b=b)
    with _LOCK:
        _SEGMENTS[key] = (seg, dseg)
        while len(_SEGMENTS) > _MAX_CACHED_SEGMENTS:
            _SEGMENTS.pop(next(iter(_SEGMENTS)))
    return seg, dseg
