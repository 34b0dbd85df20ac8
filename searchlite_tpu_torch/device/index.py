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


def from_host_arrays(arrays: dict[str, np.ndarray], device
                     ) -> dict[str, torch.Tensor]:
    """Carry a segment's state across: the numpy arrays of the keys in
    :data:`TENSOR_KEYS` (from this package's host build, or read off a
    JAX ``DeviceSegment`` with ``np.asarray``) as tensors on ``device``,
    bit for bit."""
    device = torch.device(device)
    out = {}
    for key in TENSOR_KEYS:
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
