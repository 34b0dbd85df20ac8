"""Full query execution doc-sharded over a mesh (``parallel/mesh.py``).

The counterpart of ``searchlite_tpu/parallel/query.py``. Every route
shards the doc axis: shard ``d`` owns docs ``[d * width, (d+1) * width)``
and holds exactly the postings that land there, in LOCAL doc coordinates
(``DeviceSegment.doc_shards`` / ``mesh_sparse_tables``), so each shard's
work needs nothing of the others; only the small results merge, on the
mesh's first device (``mesh.merge_topk``: shard-major, ties by score
descending then doc ascending).

- :func:`make_sharded_query_executor`: the single-query executor per
  shard -- ``ops/impact.py::build_m`` over the shard's postings, then the
  same ``CompiledQuery._core`` the one-device executor runs, on the
  shard's slice of every doc-axis input; the match count summed over the
  shards and the doc-axis outputs reassembled.
- :func:`make_sharded_batch_scorer`: the batched candidate strips per
  shard -- the strip kernel (``ops/strip_topk.py``) once a shard, over the
  shard's own blocks.
- :func:`make_sharded_dense_batch_scorer`: the heavy remainder of a mesh
  batch -- M over the shard's blocks and the fused score + mask + top-k
  kernel (``ops/fused_topk.py``) once a shard, at N = ``width + 1``.
- :func:`make_sharded_vector_topk`: exact vector similarity per shard of
  vector rows.
- :func:`make_sharded_terms_counts`, :func:`make_sharded_stats_partial`,
  :func:`make_sharded_range_counts`: aggregation partials per shard,
  summed (counts exact integers, sums f64) across shards.

Each factory returns a plain function; an argument sharded over the doc
(or row) axis may be one tensor or numpy array (cut into the mesh's equal
slices and moved to each shard's device) or a list already per shard.
There is nothing to compile, so nothing is cached here: the per-shard
tables are cached where they are built.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from searchlite_tpu_torch.ops.device_aggs import bucket_counts2d, \
    range_counts
from searchlite_tpu_torch.ops.fused_topk import fused_topk
from searchlite_tpu_torch.ops.impact import (
    build_m,
    build_m_from_blocks,
    densify_w,
)
from searchlite_tpu_torch.ops.score import topk_by_doc
from searchlite_tpu_torch.ops.sparse import sparse_candidate_scorer_packed
from searchlite_tpu_torch.ops.vector import vector_scores
from searchlite_tpu_torch.parallel.mesh import (
    merge_topk,
    pad_topk,
    part,
    put,
)


def pad_doc_axis(arr: np.ndarray, n1p: int, fill) -> np.ndarray:
    """Pad the trailing (doc) axis of a host array to n1p."""
    n = arr.shape[-1]
    if n == n1p:
        return arr
    out = np.full(arr.shape[:-1] + (n1p,), fill, dtype=arr.dtype)
    out[..., :n] = arr
    return out


def _doc_part(x, d: int, n: int, device):
    """Shard ``d``'s slice of a doc-axis input (the trailing axis)."""
    return part(x, d, n, device, dim=x.ndim - 1 if not isinstance(
        x, (list, tuple)) else 0)


def make_sharded_query_executor(mesh, compiled, width: int):
    """The sharded single-query executor (cursorless: the host general
    path applies cursors). ``width`` is the per-shard doc slice (n1p =
    width * n_shards). Returns

        run(docs_local, impacts_local, deleted, slot_start, slot_len,
            w_leaf, leaf_ind, group_ind, phrase_masks, filter_masks,
            col_vals, col_has, root_mask, *, k, p_pad, has_scored_terms,
            need_scores)
        -> (top_scores [k'], top_idx [k'], match_count, final_mask [n1p],
            adjusted [n1p], text_mask [n1p])

    on the mesh's first device, k' = min(k, n1p). ``docs_local`` /
    ``impacts_local`` are the doc-sharded postings ([D*per], or per-shard
    lists, LOCAL doc coordinates) and ``slot_start`` / ``slot_len`` per-
    shard [D, S] tables into them; the doc-axis inputs are [..., n1p]."""
    devs = mesh.shard_devices
    n_shards = len(devs)

    def run(docs_local, impacts_local, deleted, slot_start, slot_len,
            w_leaf, leaf_ind, group_ind, phrase_masks, filter_masks,
            col_vals, col_has, root_mask, *, k: int, p_pad: int,
            has_scored_terms: bool, need_scores: bool):
        kk = min(k, width)
        loc_s, loc_i, counts, fms, adjs, tms = [], [], [], [], [], []
        for d, dev in enumerate(devs):
            m = build_m(part(docs_local, d, n_shards, dev),
                        part(impacts_local, d, n_shards, dev),
                        part(slot_start, d, n_shards, dev).reshape(-1),
                        part(slot_len, d, n_shards, dev).reshape(-1),
                        width, p_pad)
            dead = _doc_part(deleted, d, n_shards, dev)
            final_mask, adjusted, matcher_mask = compiled._core(
                m, dead, put(w_leaf, dev), put(leaf_ind, dev),
                put(group_ind, dev),
                *(_doc_part(x, d, n_shards, dev)
                  for x in (phrase_masks, filter_masks, col_vals,
                            col_has, root_mask)),
                has_scored_terms, need_scores)
            adjusted = adjusted.to(torch.float32)
            masked = torch.where(final_mask, adjusted, -math.inf)
            s, i = topk_by_doc(masked, kk)
            loc_s.append(s)
            loc_i.append(i + d * width)
            counts.append(final_mask.sum())
            fms.append(final_mask)
            adjs.append(adjusted)
            tms.append(matcher_mask & ~dead)
        fs, fi = merge_topk(loc_s, loc_i, k, mesh.device)
        dev0 = mesh.device
        count = sum(put(c, dev0) for c in counts)
        return (fs, fi, count,
                torch.cat([put(x, dev0) for x in fms]),
                torch.cat([put(x, dev0) for x in adjs]),
                torch.cat([put(x, dev0) for x in tms]))

    return run


def _replicas(x, devs) -> list:
    """One copy of a replicated input per shard device (a device seen
    twice gets the same copy: the kernels only read it)."""
    by_dev = {}
    return [by_dev.setdefault(dev, put(x, dev)) for dev in devs]


def make_sharded_batch_scorer(mesh):
    """The doc-sharded batched candidate scorer (JAX
    ``make_sharded_batch_scorer``): per shard, every query row's strip top-k
    over the shard's own blocks -- ``ops/sparse.py::
    sparse_candidate_scorer_packed``, i.e. the strip kernel once a shard --
    then the merge. Returns

        run(block_docs, block_impacts, tid_tbl, packed, ovr, sent, *, k,
            t_pad, nblk, log2_run, n_ovr, width) -> (scores [B, k],
            ids [B, k])

    with the segment's per-shard tables as lists
    (``DeviceSegment.mesh_sparse_tables``: each shard's ``sent`` is its
    (sentinel block row, ``width``)), the packed rows and the weight
    overrides replicated. A shard's ids become global as ``td + d *
    width``; rows pad to ``k`` with -inf where the strips hold fewer."""
    devs = mesh.shard_devices

    def run(block_docs, block_impacts, tid_tbl, packed, ovr, sent, *,
            k: int, t_pad: int, nblk: int, log2_run: int, n_ovr: int,
            width: int):
        kk = min(k, nblk * 128)
        packed_d = _replicas(packed, devs)
        ovr_d = _replicas(ovr, devs)
        loc_s, loc_i = [], []
        for d, dev in enumerate(devs):
            ts, td = sparse_candidate_scorer_packed(
                block_docs[d], block_impacts[d], tid_tbl[d],
                packed_d[d], ovr_d[d], sent[d], k=kk, t_pad=t_pad,
                nblk=nblk, log2_run=log2_run, n_ovr=n_ovr)
            loc_s.append(ts)
            loc_i.append(td + d * width)
        return pad_topk(*merge_topk(loc_s, loc_i, k, mesh.device), k)

    return run


def make_sharded_dense_batch_scorer(mesh):
    """The doc-sharded dense batched scorer, the heavy remainder of a mesh
    batch (JAX ``make_sharded_dense_batch_scorer``): per shard, M [S_pad,
    width + 1] from the shard's blocks (``build_m_from_blocks``, the dead
    doc ``width`` to the dump zone), W from the batch's COO weights, and the
    fused score + mask + top-k kernel at N = ``width + 1`` (tombstoned
    docs' impacts are zero in the shard tables, so ``score > 0`` is the
    match mask: ``deleted`` holds only the dead column); then the merge.
    Each shard's M is f32 (``m_store_dtype``), its impacts widened from
    the shard tables' storage (bf16 under the bf16 modes), and the sums
    are f32 with TF32 off in every mode.
    Returns

        run(block_docs, block_impacts, blk_idx, slot_row, w_idx, w_val,
            dead, *, k, s_pad, n_queries, width) -> (scores [Q, k],
            ids [Q, k])

    with ``block_docs`` / ``block_impacts`` / ``dead`` ([width + 1] bool)
    per-shard lists and ``blk_idx`` / ``slot_row`` [D, nb] per-shard
    gather tables."""
    devs = mesh.shard_devices
    n_shards = len(devs)

    def run(block_docs, block_impacts, blk_idx, slot_row, w_idx, w_val,
            dead, *, k: int, s_pad: int, n_queries: int, width: int):
        kk = min(k, width + 1)
        w_idx_d = _replicas(w_idx, devs)
        w_val_d = _replicas(w_val, devs)
        loc_s, loc_i = [], []
        for d, dev in enumerate(devs):
            m = build_m_from_blocks(
                block_docs[d], block_impacts[d],
                part(blk_idx, d, n_shards, dev).reshape(-1),
                part(slot_row, d, n_shards, dev).reshape(-1), width + 1,
                s_pad)
            w = densify_w(w_idx_d[d], w_val_d[d], n_queries, s_pad)
            ls, li = fused_topk(w, m, dead[d], k=kk)
            loc_s.append(ls)
            loc_i.append(li + d * width)
        return pad_topk(*merge_topk(loc_s, loc_i, k, mesh.device), k)

    return run


def make_sharded_vector_topk(mesh):
    """Vector similarity over the mesh (JAX ``make_sharded_vector_topk``):
    vector rows (docs) shard over the mesh, each shard runs the exact
    similarity (``ops/vector.py::vector_scores``) and a local top-k, and
    the lists merge. Cosine and L2 at every quantization of
    ``ops/vector.py``. Returns

        run(vectors, v_scale, v_sq, present, mask, queries, q_scale, *, k,
            metric, quantization) -> (scores [Q, k'], ids [Q, k'])

    with the row-sharded inputs per-shard lists or [n_pad, ...] arrays,
    ``queries`` / ``q_scale`` replicated."""
    devs = mesh.shard_devices
    n_shards = len(devs)

    def run(vectors, v_scale, v_sq, present, mask, queries, q_scale, *,
            k: int, metric: str, quantization: str):
        q_d = _replicas(queries, devs)
        qs_d = _replicas(q_scale, devs)
        loc_s, loc_i = [], []
        base = 0
        for d, dev in enumerate(devs):
            vec = part(vectors, d, n_shards, dev)
            masked = vector_scores(
                vec, part(v_scale, d, n_shards, dev),
                part(v_sq, d, n_shards, dev),
                part(present, d, n_shards, dev),
                part(mask, d, n_shards, dev), q_d[d].to(vec.dtype),
                qs_d[d], metric=metric, quantization=quantization)
            n_local = vec.shape[0]
            s, i = topk_by_doc(masked, min(k, n_local))
            loc_s.append(s)
            loc_i.append(i.to(torch.int64) + base)
            base += n_local
        return merge_topk(loc_s, loc_i, k, mesh.device)

    return run


def make_sharded_terms_counts(mesh):
    """Bucket counts per shard (``ops/device_aggs.py::bucket_counts2d``
    over the shard's slice of the codes and the match mask), summed across
    shards: exact integers. Serves terms (dictionary ids, -1 = none) and
    histogram (host-computed bucket codes) alike. Returns
    ``run(dict_ids [n1p], mask [n1p], *, n_buckets) -> int64
    [n_buckets]``."""
    devs = mesh.shard_devices
    n_shards = len(devs)

    def run(dict_ids, mask, *, n_buckets: int):
        out = None
        for d, dev in enumerate(devs):
            codes = _doc_part(dict_ids, d, n_shards, dev)
            counts = bucket_counts2d(
                codes.reshape(-1, 1).long(),
                _doc_part(mask, d, n_shards, dev), n_buckets=n_buckets)
            counts = put(counts, mesh.device).to(torch.int64)
            out = counts if out is None else out + counts
        return out

    return run


def make_sharded_stats_partial(mesh):
    """Stats partials per shard -- (count, sum, sum_sq, min, max) over the
    docs that hold a value and match -- merged across shards: the count
    an exact int64, the sums f64 (as the port's on-card aggregation
    partials), min / max exact. Returns ``run(vals [n1p] f32, has [n1p],
    mask [n1p]) -> (count, total, total_sq, vmin, vmax)`` 0-d tensors on
    the mesh's first device; an empty selection gives 0, 0, 0, +inf,
    -inf."""
    devs = mesh.shard_devices
    n_shards = len(devs)

    def run(vals, has, mask):
        parts = []
        for d, dev in enumerate(devs):
            v = _doc_part(vals, d, n_shards, dev)
            ok = _doc_part(has, d, n_shards, dev) \
                & _doc_part(mask, d, n_shards, dev)
            vd = torch.where(ok, v.double(), 0.0)
            parts.append([x.to(mesh.device) for x in (
                ok.sum(), vd.sum(), (vd * vd).sum(),
                torch.where(ok, v, math.inf).amin(),
                torch.where(ok, v, -math.inf).amax())])
        count = sum(p[0] for p in parts)
        total = sum(p[1] for p in parts)
        total_sq = sum(p[2] for p in parts)
        vmin = torch.stack([p[3] for p in parts]).amin()
        vmax = torch.stack([p[4] for p in parts]).amax()
        return count, total, total_sq, vmin, vmax

    return run


def make_sharded_range_counts(mesh):
    """Range-aggregation partials per shard: ``rows`` [R, n1p] bool are
    host-f64 membership rows (ranges may overlap), sharded on the doc
    axis; per-shard counts (``ops/device_aggs.py::range_counts``) summed
    across shards, exact. Returns ``run(rows, mask) -> int64 [R]``."""
    devs = mesh.shard_devices
    n_shards = len(devs)

    def run(rows, mask):
        out = None
        for d, dev in enumerate(devs):
            counts = range_counts(_doc_part(rows, d, n_shards, dev),
                                  _doc_part(mask, d, n_shards, dev))
            counts = put(counts, mesh.device).to(torch.int64)
            out = counts if out is None else out + counts
        return out

    return run
