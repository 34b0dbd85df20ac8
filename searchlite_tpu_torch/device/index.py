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
- ``block_impacts [n_block_rows+1, 128]`` (f32, or bf16: see below): the
  RAW impacts, which no tombstone touches, so every tombstone state of a
  segment shares them;
- ``block_impacts_live``: impacts with tombstoned docs zeroed (the strip
  scorer's deletion contract), derived on the device from the raw table
  and ``deleted`` at first use; the raw table itself while nothing is
  deleted;
- ``sparse_tid_tbl [3, n_terms_pad] int32``: per term id the block
  start, block count and f32 idf bit-cast;
- ``sparse_sentinels [2] int32``: (sentinel block row, ``n1-1``);
- ``deleted [n1] bool``.

and, built on first use and cached, what the dense and term-split scorers
read: :meth:`DeviceSegment.dense_rows` (resident impact rows of the
highest-df terms) and :meth:`DeviceSegment.heavy_lookup` (the head-term
doc-to-block lookup). The single-query reader also reads the host build's
``posting_base``, ``block_max_impact`` (per-block max impact, the
pruning telemetry) and ``live_term_df`` (the term split's counts).

The impact tables on the device (``block_impacts``, the flat postings,
the doc-shard and mesh tables) store ``DeviceSegment.impact_dtype``, the
precision policy's :func:`~searchlite_tpu_torch.ops.precision.
impacts_store_dtype` for the segment's device when it was opened, and
the dense rows :func:`~searchlite_tpu_torch.ops.precision.
dense_store_dtype`: f32 unless a bf16 mode asks (``ops/precision.py``),
rounded on the host before upload. The host build stays f32.
:func:`cached_segment` shares segments across readers,
and a commit that only moves a segment's tombstones reopens it as a
:meth:`DeviceSegment.clone_with_tombstones`: the tensors above that do not
depend on deletions are the base's, by identity.
"""

from __future__ import annotations

import copy
import os
import threading

import numpy as np
import torch

from searchlite_tpu_torch.index.segment import SegmentReader
from searchlite_tpu_torch.ops.impact import pow2_bucket, pow15_bucket
from searchlite_tpu_torch.ops.precision import (
    dense_store_dtype,
    impacts_store_dtype,
)
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

        self._bind_tombstones(reader)

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
        self._heavy_lookup_host = None

    def _bind_tombstones(self, reader: SegmentReader) -> None:
        """Everything that depends on the reader's tombstones: the mask,
        the live count, and (rebuilt at first use) the idf tables, the
        packed term table and the per-term live df."""
        deleted = np.zeros(self.n1, dtype=bool)
        deleted[self.n_docs:] = True  # sentinel + doc-axis pad slots
        dead = np.fromiter(reader.deleted, dtype=np.int64,
                           count=len(reader.deleted))
        deleted[dead[(dead >= 0) & (dead < self.n_docs)]] = True
        self.deleted_np = deleted
        self.live_docs = int(self.n_docs - len(reader.deleted))
        self._idf_table = None
        self._idf32 = None
        self._sparse_tid_tbl = None
        self._live_df_cache: dict[int, int] = {}

    def clone_with_tombstones(self, reader: SegmentReader,
                              segment_ord: int) -> "HostSegment":
        """The same segment at another tombstone state (``reader`` is a
        ``SegmentReader.clone_with_tombstones``): the block layout, the
        impacts, the flat postings and the heavy-term lookup are shared
        with this build by identity; the deletion-derived members are the
        clone's own."""
        clone = copy.copy(self)
        clone.reader = reader
        clone.ord = segment_ord
        clone._bind_tombstones(reader)
        return clone

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


TENSOR_KEYS = ("block_docs", "block_impacts", "sparse_tid_tbl",
               "sparse_sentinels", "deleted")
# DeviceSegment.heavy_lookup's tensors (ops/sparse.py::build_heavy_lookup_
# host): the lookup table, per-term base and log2 group width, max impact
HEAVY_KEYS = ("tbl", "base", "log2g", "maximp")
# DeviceSegment.flat_postings' tensors: the (term, doc)-sorted CSR postings
# the doc-tile run scorers read (int32 docs, RAW impacts: the tile
# path masks tombstones by ``deleted_tiles``); 8 bytes a posting, 6 with
# bf16 impacts
FLAT_KEYS = ("docs_flat", "impacts_flat")
# DeviceSegment.mesh_sparse_tables' per-shard tensors
MESH_KEYS = ("block_docs", "block_impacts", "tid_tbl", "sent", "dead")


def host_arrays(host: HostSegment) -> dict[str, np.ndarray]:
    """The numpy arrays behind the port's tensors, from the host build.
    ``block_impacts`` is the raw table: ``block_impacts_live`` is derived
    from it and ``deleted`` on the device
    (:func:`live_block_impacts`)."""
    return {
        "block_docs": np.asarray(host.block_docs_np, dtype=np.int32),
        "block_impacts": np.asarray(host.block_impacts_np,
                                    dtype=np.float32),
        "sparse_tid_tbl": np.asarray(host.sparse_tid_tbl,
                                     dtype=np.int32),
        "sparse_sentinels": np.asarray(host.sparse_sentinels,
                                       dtype=np.int32),
        "deleted": np.asarray(host.deleted_np, dtype=bool),
    }


def _host_tensor(arr) -> torch.Tensor:
    """A CPU tensor holding a copy of ``arr``'s bits (a bfloat16 numpy
    array, as JAX hands out, is carried through its uint16 view)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


def from_host_arrays(arrays: dict[str, np.ndarray], device,
                     keys=TENSOR_KEYS, dtypes=None) -> dict[str, torch.Tensor]:
    """Carry a segment's state across: the numpy arrays of ``keys`` (from
    the host build, or any other source of the same layout, bf16 included)
    as tensors on ``device``, bit for bit; ``dtypes`` ({key: torch dtype})
    converts those keys on the host first (round to nearest even), so the
    copy carries the stored form. The default
    keys are the strip route's; :data:`HEAVY_KEYS` carries a
    ``heavy_lookup(term_cap)``, ``("m_dense",)`` a
    ``dense_rows(budget)["m_dense"]``, :data:`FLAT_KEYS` the flat
    postings and ``ops/tiles.py::TILE_KEYS`` a ``TileIndex``'s tables."""
    device = torch.device(device)
    dtypes = dtypes or {}
    out = {}
    for key in keys:
        t = _host_tensor(arrays[key])
        if key in dtypes and t.dtype != dtypes[key]:
            t = t.to(dtypes[key])
        out[key] = t.to(device)
    return out


def live_block_impacts(block_docs: torch.Tensor,
                       block_impacts: torch.Tensor,
                       deleted: torch.Tensor) -> torch.Tensor:
    """``block_impacts`` with the lanes of deleted docs zeroed: one
    elementwise pass over ``[n_block_rows+1, 128]`` on the tensors'
    device, in the raw table's dtype (JAX
    ``DeviceSegment.block_impacts_live``)."""
    return torch.where(deleted[block_docs.long()],
                       block_impacts.new_zeros(()), block_impacts)


class DeviceSegment:
    """A segment's tensors on one torch device, plus the host members the
    query prep and partitions read (through ``host``, the
    :class:`HostSegment`). ``tiered`` marks a host-tier placement: a small
    segment of a reader on the card that lives on the CPU
    (``api/reader.py::_host_tier_device``).

    Who owns what, across the tombstone states of one segment
    (:meth:`clone_with_tombstones`): the tensors that no deletion touches
    -- ``block_docs``, the raw ``block_impacts``, ``sparse_sentinels``, the
    flat postings, the dense rows, the heavy-term lookup, the doc-shard
    tables, the tile tables, the filter rows, the aggregation structures
    and the vector buffers -- belong to the whole family and are held by
    reference: a member that lets go (:meth:`evict_device_caches`, or
    leaving the segment cache) drops only its own references, and the
    memory is freed when the last member has. ``deleted``,
    ``block_impacts_live``, ``sparse_tid_tbl``, the shards' deleted stack,
    the mesh tables, the tile layout of ``deleted`` and the
    significant-terms background belong to one member alone."""

    def __init__(self, reader: SegmentReader, segment_ord: int, device,
                 k1: float = 0.9, b: float = 0.4, tiered: bool = False):
        self.host = HostSegment(reader, segment_ord, k1=k1, b=b)
        self.device = torch.device(device)
        self.tiered = bool(tiered)
        self.n_docs = self.host.n_docs
        self.n1 = self.host.n1
        self.n_block_rows = self.host.n_block_rows
        self.posting_base = self.host.posting_base
        self.block_max_impact = self.host.block_max_impact
        # the impact tables' storage, fixed when the segment is opened
        # (cached_segment keys on it): every table built later from this
        # segment, clones included, stores the same dtype
        self.impact_dtype = impacts_store_dtype(self.device)
        tensors = from_host_arrays(
            host_arrays(self.host), self.device,
            dtypes={"block_impacts": self.impact_dtype})
        self.block_docs = tensors["block_docs"]
        self.block_impacts = tensors["block_impacts"]
        self.sparse_sentinels = tensors["sparse_sentinels"]
        self._dense_rows: dict = {}
        self._heavy_lookup: dict = {}
        # residents built at first use that every tombstone state shares:
        # "flat_postings", "doc_shards" (the last n_shards)
        self._shared: dict = {}
        self._tile_index = None  # ops/tiles.py::get_tile_index
        # (filter key, [F+1, n1] bool): the filters' own masks, with no
        # tombstone folded in, so clones share them
        self.filter_rows_cache = None
        # ops/device_aggs.py: per-spec bucket structures and their tensors
        self.agg_struct_cache: dict = {}
        self._bind_host(tensors["deleted"], tensors["sparse_tid_tbl"])

    def _bind_host(self, deleted: torch.Tensor, sparse_tid_tbl=None):
        """Point the deletion-derived members at ``self.host``'s state."""
        host = self.host
        self.reader = host.reader
        self.ord = host.ord
        self.live_docs = host.live_docs
        self.live_term_df = host.live_term_df
        self.heavy_lookup_host = host.heavy_lookup_host
        self.deleted = deleted
        self._sparse_tid_tbl = sparse_tid_tbl
        self._block_impacts_live = None
        self._deleted_stack = None  # (n_shards, [n_shards, width+1] bool)
        self._sig_bg_cache = None   # ops/device_aggs.py::_sig_bg_structure
        self._mesh_sparse = None    # mesh_sparse_tables: tombstones folded

    def clone_with_tombstones(self, reader: SegmentReader,
                              segment_ord: int) -> "DeviceSegment":
        """This segment at another tombstone state or ordinal (JAX
        ``DeviceSegment.clone_with_tombstones``): nothing is read from
        storage, no impact is recomputed and no table is uploaded but
        ``deleted`` ([n1] bool). The family's tensors (see the class
        docstring) are this segment's, by identity; ``block_impacts_live``,
        the idf tables, ``sparse_tid_tbl`` (it embeds the f32 idf of the
        live count), the live df, the shards' deleted stack, the mesh
        tables, the tile layout of ``deleted`` and the significant-terms
        background are rebuilt for the clone at first use. The live table is always
        derived from the RAW impacts and the clone's own ``deleted``:
        this segment may itself hold a later tombstone state than the one
        asked for."""
        clone = copy.copy(self)
        clone.host = self.host.clone_with_tombstones(reader, segment_ord)
        clone._bind_host(from_host_arrays(
            {"deleted": clone.host.deleted_np}, self.device,
            keys=("deleted",))["deleted"])
        if self._tile_index is not None:
            clone._tile_index = self._tile_index.clone_for(clone)
        return clone

    @property
    def block_impacts_live(self) -> torch.Tensor:
        """``block_impacts`` with tombstoned docs zeroed
        (:func:`live_block_impacts`): the raw table itself while nothing
        is deleted, else a second table of the same size, computed at
        first use."""
        if self.live_docs == self.n_docs:
            return self.block_impacts
        if self._block_impacts_live is None:
            self._block_impacts_live = live_block_impacts(
                self.block_docs, self.block_impacts, self.deleted)
        return self._block_impacts_live

    @property
    def sparse_tid_tbl(self) -> torch.Tensor:
        if self._sparse_tid_tbl is None:
            self._sparse_tid_tbl = from_host_arrays(
                {"sparse_tid_tbl": self.host.sparse_tid_tbl}, self.device,
                keys=("sparse_tid_tbl",))["sparse_tid_tbl"]
        return self._sparse_tid_tbl

    def flat_postings(self) -> dict[str, torch.Tensor]:
        """The flat CSR postings on this segment's device (keys
        :data:`FLAT_KEYS`; impacts in :attr:`impact_dtype`), uploaded at
        the first pruned or chunked use and cached: 8 bytes a posting, 6
        with bf16 impacts."""
        flat = self._shared.get("flat_postings")
        if flat is None:
            flat = self._shared["flat_postings"] = from_host_arrays(
                {"docs_flat": self.host.docs_flat_np,
                 "impacts_flat": self.host.impacts_flat_np},
                self.device, keys=FLAT_KEYS,
                dtypes={"impacts_flat": self.impact_dtype})
        return flat

    def evict_device_caches(self) -> None:
        """Let go of the device residents that can be rebuilt from the
        host build (the dense rows, the heavy-term lookup, the filter rows,
        the flat postings, the tile tables' tensors, the doc-shard tables
        with their deleted stack, the mesh tables, the live impact table,
        the aggregation structures, the vector matrices). Called when a launch runs out of
        device memory; the next query that needs one builds it again. Only
        this object's references go (the members are rebound, never
        cleared in place): another tombstone state of the segment keeps
        serving from what it holds, see the class docstring."""
        self._dense_rows = {}
        self._heavy_lookup = {}
        self._shared = {}
        self.filter_rows_cache = None
        self._deleted_stack = None
        self._block_impacts_live = None
        self._mesh_sparse = None
        self.agg_struct_cache = {}
        for vdata in getattr(self.reader, "vectors", {}).values():
            vdata.__dict__.pop("_torch_vectors", None)
            vdata.__dict__.pop("_torch_sharded", None)
        if self._tile_index is not None:
            self._tile_index.drop_tensors()

    def deleted_stack(self, n_shards: int, build) -> torch.Tensor:
        """``deleted`` cut into the doc shards' columns
        ([n_shards, width + 1] bool), built by ``build()`` at first use
        and kept for the last ``n_shards``: this member's own, beside the
        shared :meth:`doc_shards` tables."""
        if self._deleted_stack is None \
                or self._deleted_stack[0] != n_shards:
            self._deleted_stack = (n_shards, build())
        return self._deleted_stack[1]

    def doc_shards(self, n_shards: int) -> dict:
        """The doc-sharded layout of the segment's postings (JAX
        ``DeviceSegment.doc_shards``): the flat postings re-sorted by
        (doc shard, term, doc), each (term, shard) run re-blocked 128 wide
        with LOCAL doc ordinals, the local sentinel doc ``shard_width``
        (a shard's doc axis is ``shard_width + 1`` wide). Every shard's
        slice is still term-major and doc-ascending, so one shard scores
        through the same block gather as a whole segment. ``block_docs``
        int32 and ``block_impacts`` in :attr:`impact_dtype` (RAW impacts:
        tombstones are masked by the shard's deleted row) go to the
        segment's device;
        ``block_base`` / ``blocks`` / ``counts`` (per key
        ``shard * n_terms + term``), ``docs_sh_np`` / ``imps_sh_np`` /
        ``posting_base`` stay on the host. Cached for the last
        ``n_shards``."""
        cached = self._shared.get("doc_shards")
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
            keys=("block_docs", "block_impacts"),
            dtypes={"block_impacts": self.impact_dtype})
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
        self._shared["doc_shards"] = cached
        return cached

    def mesh_sparse_tables(self, n_shards: int, devices) -> dict:
        """The doc-sharded block layout and per-shard term tables of the
        mesh's batched routes (JAX ``DeviceSegment.mesh_sparse_tables``),
        shard ``d``'s tensors on ``devices[d]``. Built from
        :meth:`doc_shards`' reordered postings: each shard's 128-wide
        blocks padded to a uniform pow-1.5 ``bp`` rows (``block_docs`` /
        ``block_impacts`` [bp, 128], impacts in :attr:`impact_dtype`, JAX
        ``impacts_store_dtype``; pad lanes and rows hold the shard's
        dead doc ``width`` and zero impacts; tombstoned docs' impacts are
        zeroed too, the strip core's deletion contract), a term table
        ``tid_tbl`` [3, n_terms_pad] (local block start, block count, f32
        idf bit-cast), ``sent`` [2] (sentinel block row ``bp - 1``,
        ``width``) and ``dead`` [width + 1] bool (only the dead column: the
        fused kernel's deletion mask), as per-shard lists under those keys.
        On the host: ``blocks`` [D * n_terms] and ``local_start_np`` [D,
        n_terms] (the light/heavy partition and the dense remainder's
        gather tables), ``width``, ``bp``, ``n_terms``. Each shard's
        tensors are its own, even where two shards share a device.

        The tables fold this member's tombstones, so they are its own: a
        clone builds its own, and :meth:`evict_device_caches` drops them.
        Cached for the last (n_shards, devices)."""
        devices = tuple(torch.device(d) for d in devices)
        key = (n_shards, tuple(str(d) for d in devices))
        cached = self._mesh_sparse
        if cached is not None and cached["key"] == key:
            return cached
        sh = self.doc_shards(n_shards)
        n_terms = sh["n_terms"]
        width = sh["shard_width"]
        counts = sh["counts"]                      # [D*n_terms]
        base = sh["posting_base"]                  # [D*n_terms + 1]
        blocks = -(-counts // 128)
        block_base = np.concatenate([[0], np.cumsum(blocks)])
        sb_lo = block_base[np.arange(n_shards) * n_terms]
        sb_hi = block_base[(np.arange(n_shards) + 1) * n_terms]
        bp = pow15_bucket(int((sb_hi - sb_lo).max()) + 1, minimum=16)
        bdocs = np.full((n_shards * bp, 128), width, dtype=np.int32)
        bimps = np.zeros((n_shards * bp, 128), dtype=np.float32)
        total = int(counts.sum())
        if total:
            run_of = np.repeat(np.arange(len(counts), dtype=np.int64),
                               counts)
            shard_of = run_of // n_terms
            offset = np.arange(total, dtype=np.int64) - base[:-1][run_of]
            dest = (shard_of * bp
                    + (block_base[:-1][run_of] - sb_lo[shard_of])) \
                * 128 + offset
            docs_sh = sh["docs_sh_np"][:total]
            imps_sh = sh["imps_sh_np"][:total]
            if self.live_docs != self.n_docs:
                glob = shard_of * width + docs_sh.astype(np.int64)
                imps_sh = np.where(self.host.deleted_np[glob],
                                   np.float32(0), imps_sh)
            bdocs.reshape(-1)[dest] = docs_sh
            bimps.reshape(-1)[dest] = imps_sh
        n_pad = pow15_bucket(max(n_terms, 1), minimum=1024)
        tid_tbl = np.zeros((n_shards, 3, n_pad), dtype=np.int32)
        local_start = (block_base[:-1].reshape(n_shards, n_terms)
                       - sb_lo[:, None])
        tid_tbl[:, 0, :n_terms] = local_start.astype(np.int32)
        tid_tbl[:, 1, :n_terms] = blocks.reshape(
            n_shards, n_terms).astype(np.int32)
        tid_tbl[:, 2, :n_terms] = self.host.idf32.view(np.int32)[None, :]
        dead = np.zeros(width + 1, dtype=bool)
        dead[width] = True
        per_shard = [from_host_arrays({
            "block_docs": bdocs[d * bp:(d + 1) * bp],
            "block_impacts": bimps[d * bp:(d + 1) * bp],
            "tid_tbl": tid_tbl[d],
            "sent": np.array([bp - 1, width], dtype=np.int32),
            "dead": dead}, dev, keys=MESH_KEYS,
            dtypes={"block_impacts": self.impact_dtype})
            for d, dev in enumerate(devices)]
        cached = {
            "key": key,
            "n_shards": n_shards,
            "width": int(width),
            "bp": int(bp),
            "n_terms": n_terms,
            "blocks": blocks,
            "local_start_np": local_start.astype(np.int64),
            **{name: [t[name] for t in per_shard] for name in MESH_KEYS},
        }
        self._mesh_sparse = cached
        return cached

    def dense_rows(self, budget_bytes: int):
        """Resident dense impact rows for the highest-df terms (df >=
        n1/512, highest first) within ``budget_bytes``, the host half of
        the JAX ``DeviceSegment.dense_rows`` in numpy: one vectorized
        scatter of the selected terms' postings (tombstoned docs keep
        their impacts; the scorers mask them). Stored in
        ``dense_store_dtype()`` (f32; bf16 under
        ``SEARCHLITE_PRECISION=bf16``, where one budget holds twice the
        rows), converted on the host before upload. Returns None when no
        term qualifies, else ``{"row_of_tid": {tid: row}, "m_dense":
        [R+1, n1]}`` (last row zeros, the pad row). Cached per (budget,
        dtype)."""
        dtype = dense_store_dtype()
        key = (budget_bytes, dtype)
        if key in self._dense_rows:
            return self._dense_rows[key]
        host = self.host
        term_df = host.reader.postings.term_df.astype(np.int64)
        max_rows = budget_bytes // (self.n1 * dtype.itemsize)
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
                    self.device, keys=("m_dense",),
                    dtypes={"m_dense": dtype})["m_dense"],
            }
        self._dense_rows[key] = out
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


# Segments are immutable, so their uploads are shared by every reader a
# commit reopens. Two bounded caches: the exact one, keyed by the
# segment's tombstone state too, and the base one, which holds the newest
# state seen of each (segment id, k1, b, tier placement, device, impact
# dtype) for
# :func:`cached_segment` to clone from. Both drop the entry opened longest
# ago: a live index mints a segment id a commit, and first-in-first-out
# would drop the oldest id, which is the big base segment every reader
# still opens.
_SEGMENTS: dict[tuple, tuple] = {}
_BASES: dict[tuple, tuple] = {}
_MAX_CACHED_SEGMENTS = 64
_LOCK = threading.Lock()


def cached_segment(storage, meta, ordinal: int, k1: float, b: float,
                   device, tiered: bool = False
                   ) -> tuple[SegmentReader, DeviceSegment]:
    """(SegmentReader, DeviceSegment) for an immutable segment, shared
    process-wide (JAX ``api/reader.py::_cached_segment``). Keyed by
    (segment id, k1, b, tier placement, device, impact dtype) and the
    tombstones, so a reader opened under another precision mode builds
    its own tables and clones share only within one dtype: a
    commit that only ADDS segments reuses every entry; one that moves a
    segment's tombstones, or a merge that shifts its ordinal, clones the
    base entry (``clone_with_tombstones``: no file is read, no impact
    recomputed, one [n1] bool uploaded). Only a segment id never seen on
    this placement is read, built and uploaded."""
    device = torch.device(device)
    base_key = (meta.id, float(k1), float(b), bool(tiered), str(device),
                impacts_store_dtype(device))
    key = base_key + (tuple(meta.deleted_docs),)
    with _LOCK:
        hit = _SEGMENTS.get(key)
        base = _BASES.get(base_key)
    if hit is not None and hit[1].ord == ordinal:
        entry = hit
    elif base is not None:
        seg = base[0].clone_with_tombstones(meta)
        entry = (seg, base[1].clone_with_tombstones(seg, ordinal))
    else:
        seg = SegmentReader(meta, storage)
        entry = (seg, DeviceSegment(seg, ordinal, device, k1=k1, b=b,
                                    tiered=tiered))
    with _LOCK:
        # (re)insert at the end of both caches. A clone or a new build is
        # the newest state and becomes the base; an exact hit (which may
        # be an older snapshot's state) leaves the base as it is
        _SEGMENTS.pop(key, None)
        _SEGMENTS[key] = entry
        kept = _BASES.pop(base_key, entry)
        _BASES[base_key] = kept if entry is hit else entry
        for cache in (_SEGMENTS, _BASES):
            while len(cache) > _MAX_CACHED_SEGMENTS:
                cache.pop(next(iter(cache)))
    return entry


def clear_segment_caches() -> None:
    """Forget every cached segment (tests, and timing a cold reopen)."""
    with _LOCK:
        _SEGMENTS.clear()
        _BASES.clear()
