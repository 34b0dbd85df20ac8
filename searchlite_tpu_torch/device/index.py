"""DeviceSegment: one segment's sparse-scoring arrays as torch tensors.

Composes over the shared host build,
``searchlite_tpu.device.index.DeviceSegment(reader, ord, jnp=numpy)``,
which computes the padded block layout, the BM25 impacts, the f32 idf
table and the deletion mask with numpy and the native library and no
JAX. This module uploads what the batched strip route reads to an
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
doc-to-block lookup of the shared host build).

Impacts stay f32. :func:`cached_segment` shares segments across readers.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from searchlite_tpu.device.index import DeviceSegment as HostSegment
from searchlite_tpu.index.segment import SegmentReader

TENSOR_KEYS = ("block_docs", "block_impacts_live", "sparse_tid_tbl",
               "sparse_sentinels", "deleted")
# DeviceSegment.heavy_lookup's tensors (ops/sparse.py::build_heavy_lookup_
# host): the lookup table, per-term base and log2 group width, max impact
HEAVY_KEYS = ("tbl", "base", "log2g", "maximp")


def host_arrays(host: HostSegment) -> dict[str, np.ndarray]:
    """The numpy arrays behind the port's tensors, from the shared host
    build. ``block_impacts_live`` folds tombstones in as the JAX segment
    does on device (impacts times the live mask)."""
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
    this package's host build, or read off a JAX ``DeviceSegment`` with
    ``np.asarray``) as tensors on ``device``, bit for bit. The default
    keys are the strip route's; :data:`HEAVY_KEYS` carries a
    ``heavy_lookup(term_cap)`` and ``("m_dense",)`` a
    ``dense_rows(budget)["m_dense"]``."""
    device = torch.device(device)
    out = {}
    for key in keys:
        arr = np.ascontiguousarray(arrays[key])
        out[key] = torch.from_numpy(arr.copy()).to(device)
    return out


class DeviceSegment:
    """A segment's strip-route tensors on one torch device, plus the
    host members the shared query prep and partitions read (through
    ``host``, the shared numpy build)."""

    def __init__(self, reader: SegmentReader, segment_ord: int, device,
                 k1: float = 0.9, b: float = 0.4):
        self.host = HostSegment(reader, segment_ord, jnp=np, k1=k1, b=b)
        self.device = torch.device(device)
        self.reader = reader
        self.ord = segment_ord
        self.n_docs = self.host.n_docs
        self.n1 = self.host.n1
        self.n_block_rows = self.host.n_block_rows
        self.live_docs = self.host.live_docs
        tensors = from_host_arrays(host_arrays(self.host), self.device)
        self.block_docs = tensors["block_docs"]
        self.block_impacts_live = tensors["block_impacts_live"]
        self.sparse_tid_tbl = tensors["sparse_tid_tbl"]
        self.sparse_sentinels = tensors["sparse_sentinels"]
        self.deleted = tensors["deleted"]
        self._dense_rows: dict = {}
        self._heavy_lookup: dict = {}
        self.filter_rows_cache = None  # (filter key, [F+1, n1] bool)

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
        f32 [n_terms]) on this segment's device, over the shared host
        build ``heavy_lookup_host(term_cap)``. Cached per term cap."""
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
