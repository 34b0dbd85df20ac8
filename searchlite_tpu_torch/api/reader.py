"""IndexReader: batched BM25 search over torch tensors.

The batched half of ``searchlite_tpu/api/reader.py`` (``search_batch`` /
``search_batch_many`` with ``execution="bm25"``), on one explicit torch
device. Every segment takes the candidate-strip route that the JAX
reader takes for corpora whose dense score matrix exceeds its memory
budget (``_try_sparse_candidates`` with the oversized-corpus block cap):

1. native query prep (shared, ``build_impact_batch_native``);
2. rows whose posting blocks fit the cap ride packed candidate strips in
   pow-4 tiers (``partition_sparse_batch_tiered``), or one explicit table
   when the packed format does not apply;
3. rows over the cap are scored on full strips holding every term;
4. the tier and row groups are scattered back into batch order on the
   device, every result comes back in ONE device-to-host copy, and the
   segments are merged on the host.

The route is exact for every row, so results match the JAX reader
whichever route it took (scores to f32 reassociation, divergence D10).
Filters, ``wand``/``bmw``, ``mesh``, ``k > 1024`` and single-query
``search()`` are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from searchlite_tpu.errors import QueryError, StorageError
from searchlite_tpu.ops.impact import (
    build_impact_batch,
    build_impact_batch_native,
    subset_impact_batch,
)
from searchlite_tpu.ops.sparse import (
    STRIP_CHUNK_ELEMS,
    partition_sparse_batch,
    partition_sparse_batch_tiered,
)
from searchlite_tpu_torch.device.index import cached_segment
from searchlite_tpu_torch.ops.sparse import (
    group_gather,
    row_combine,
    sparse_candidate_scorer,
    sparse_candidate_scorer_packed,
)

# the strip route's own top-k cap (JAX: reader.py::_try_sparse_candidates)
MAX_STRIP_K = 1024


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to searchlite_tpu_torch yet "
        f"(ROADMAP.md queue 1: {item})")


class IndexReader:
    """Batched reader over ``index`` with every segment's tensors on
    ``device`` (required: there is no default device)."""

    def __init__(self, index, device):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "IndexReader(device='cuda') needs a CUDA device, and "
                "torch.cuda.is_available() is False")
        self.index = index
        self.manifest = index.manifest  # snapshot
        self.schema = self.manifest.schema
        self.options = index.options
        self.analysis = self.schema.build_analyzers()
        self.segments = []
        self.device_segments = []
        # a concurrent merge can delete a snapshot's segment files
        # before they open; re-snapshotting converges (as the JAX reader)
        for attempt in range(8):
            try:
                for i, meta in enumerate(self.manifest.segments):
                    seg, dseg = cached_segment(
                        index.storage, meta, i, self.options.bm25_k1,
                        self.options.bm25_b, self.device)
                    self.segments.append(seg)
                    self.device_segments.append(dseg)
                break
            except StorageError:
                if attempt == 7:
                    raise
                self.segments.clear()
                self.device_segments.clear()
                self.manifest = index.reload_manifest()
                self.schema = self.manifest.schema
                self.analysis = self.schema.build_analyzers()
        self._token_cache: dict = {}

    def search(self, *args, **kwargs):
        raise _not_ported("single-query search()", "single-query search()")

    def search_batch(self, queries: list[str], limit: int = 10,
                     fields: Optional[list[str]] = None,
                     execution: str = "bm25",
                     filters: Optional[list] = None,
                     limits: Optional[list[int]] = None,
                     mesh=None) -> list[list[tuple[str, float]]]:
        """Exact top-``limit`` ``(doc_id, score)`` pairs per query, in
        (score desc, doc asc) order -- one batch of
        :meth:`search_batch_many`."""
        return self.search_batch_many(
            [queries], limit=limit, fields=fields, execution=execution,
            filters=None if filters is None else [filters],
            limits=None if limits is None else [limits], mesh=mesh)[0]

    def search_batch_many(self, batches: list[list[str]], limit: int = 10,
                          fields: Optional[list[str]] = None,
                          execution: str = "bm25",
                          filters: Optional[list] = None,
                          limits: Optional[list] = None,
                          output: str = "pairs", mesh=None) -> list:
        """A stream of batches: every batch's device work is enqueued
        before any result is copied back, in one copy. ``output="pairs"``
        returns per batch a list of ``(doc_id, score)`` lists;
        ``output="arrays"`` returns per batch ``(scores [Q,k] f32,
        doc_ords [Q,k] i32, seg_ords [Q,k] i32)`` with -inf past each
        row's matches and limit (the JAX reader's contract)."""
        if limit <= 0:
            raise QueryError("limit must be > 0")
        if execution in ("wand", "bmw"):
            raise _not_ported(f"execution={execution!r}",
                              "pruned execution (wand and bmw)")
        if execution != "bm25":
            raise QueryError(f"unknown execution strategy `{execution}`")
        if output not in ("pairs", "arrays"):
            raise QueryError(f"unknown output form `{output}`")
        if mesh is not None:
            raise _not_ported("mesh execution", "multi-GPU")
        if filters is not None and any(
                bf is not None and any(f is not None for f in bf)
                for bf in filters):
            raise _not_ported("filtered batches",
                              "dense scorers and filters")
        if fields is None:
            fields = [f.name for f in self.schema.text_fields]
        limits = self._check_batch_limits(batches, limit, limits)
        if max((int(bl.max()) for bl in limits if len(bl)),
               default=0) > MAX_STRIP_K:
            raise _not_ported(f"k > {MAX_STRIP_K}",
                              "dense scorers and filters")
        coalesced = self._coalesce(batches, limit, fields, limits, output)
        if coalesced is not None:
            return coalesced

        # phase 1: prep + enqueue every batch and segment
        analyzed_all = None
        launches = []  # per batch: [(seg_ord, scores, ids)]
        for bi, (queries, blimits) in enumerate(zip(batches, limits)):
            k_batch = int(blimits.max()) if len(blimits) else limit
            launched = []
            for dseg in self.device_segments:
                seg = dseg.reader
                if seg.doc_count == 0:
                    continue
                qb = build_impact_batch_native(
                    seg, dseg.host, queries, fields, self.analysis,
                    self.schema, lazy_tables=True)
                if qb is None:
                    if analyzed_all is None:
                        analyzed_all = self._analyze_batches(batches,
                                                             fields)
                    qb = build_impact_batch(seg, dseg.host,
                                            analyzed_all[bi],
                                            lazy_tables=True)
                scores, ids = self._try_sparse_candidates(
                    dseg, qb, min(k_batch, dseg.n1))
                launched.append((dseg.ord, scores, ids))
            launches.append(launched)

        # phase 2: ONE device-to-host copy for every batch and segment
        flat = [t for launched in launches for _o, s, i in launched
                for t in (s, i)]
        host = _fetch(flat)

        # phase 3: host merge per batch
        out = []
        cursor = 0
        for queries, launched, blimits in zip(batches, launches, limits):
            per_segment = []
            for seg_ord, _s, _i in launched:
                per_segment.append((seg_ord, host[cursor],
                                    host[cursor + 1]))
                cursor += 2
            out.append(self._merge_batch_output(
                queries, per_segment, blimits, output, limit))
        return out

    # -- batching helpers ---------------------------------------------------

    def _check_batch_limits(self, batches, limit: int, limits):
        """Per-query limits: one int64 array per batch."""
        if limits is None:
            return [np.full(len(qs), limit, dtype=np.int64)
                    for qs in batches]
        if len(limits) != len(batches):
            raise QueryError("limits must align with batches")
        out = []
        for qs, bl in zip(batches, limits):
            if bl is None:
                out.append(np.full(len(qs), limit, dtype=np.int64))
                continue
            if len(bl) != len(qs):
                raise QueryError("limits must align with queries")
            arr = np.asarray(bl, dtype=np.int64)
            if len(arr) and arr.min() <= 0:
                raise QueryError("every limit must be > 0")
            out.append(arr)
        return out

    def _coalesce(self, batches, limit, fields, limits, output):
        """Micro-batch coalescing (JAX ``reader.py:2254-2308``): re-chunk
        a stream of narrow batches into launches of up to
        ``SEARCHLITE_BATCH_COALESCE`` queries and split the results back
        per batch (rows are independent). Returns None when the stream
        is not coalesced."""
        coalesce = int(os.environ.get("SEARCHLITE_BATCH_COALESCE", "4096"))
        if not (coalesce > 0 and len(batches) > 1
                and max(len(b) for b in batches) <= coalesce // 2):
            return None
        groups: list[tuple[int, int]] = []
        start, total = 0, 0
        for i, b in enumerate(batches):
            if total and total + len(b) > coalesce:
                groups.append((start, i))
                start, total = i, 0
            total += len(b)
        groups.append((start, len(batches)))
        if len(groups) == len(batches):
            return None
        merged = [[q for b in batches[s:e] for q in b] for s, e in groups]
        merged_limits = [np.concatenate(limits[s:e]) for s, e in groups]
        outs = self.search_batch_many(
            merged, limit=limit, fields=fields, limits=merged_limits,
            output=output)
        split: list = []
        for (s, e), gout in zip(groups, outs):
            row = 0
            for bi, b in enumerate(batches[s:e], start=s):
                if output == "arrays":
                    sc, di, sg = gout
                    # this batch's own max limit, as un-coalesced
                    kb = int(limits[bi].max()) if len(limits[bi]) else limit
                    kb = min(kb, sc.shape[1])
                    split.append((sc[row:row + len(b), :kb],
                                  di[row:row + len(b), :kb],
                                  sg[row:row + len(b), :kb]))
                else:
                    split.append(gout[row:row + len(b)])
                row += len(b)
        return split

    def _analyze_batches(self, batches, fields):
        """Python query analysis for batches the native prep rejects:
        per-query (field, token) pairs, memoized per (field, raw term)."""
        from searchlite_tpu.query.parser import parse_query

        cache = self._token_cache

        def term_pairs(field: str, raw_term: str):
            hit = cache.get((field, raw_term))
            if hit is None:
                if self.schema.field_kind(field) == "keyword":
                    hit = [(field, raw_term.lower())]
                else:
                    analyzer = self.analysis.search_analyzer(field)
                    hit = ([] if analyzer is None else
                           [(field, tok.text)
                            for tok in analyzer.analyze(raw_term)])
                cache[(field, raw_term)] = hit
            return hit

        out = []
        for queries in batches:
            analyzed = []
            for raw in queries:
                pairs: list[tuple[str, str]] = []
                for term in parse_query(raw).terms:
                    for field in ([term.field] if term.field is not None
                                  else fields):
                        pairs.extend(term_pairs(field, term.term))
                analyzed.append(pairs)
            out.append(analyzed)
        return out

    # -- the strip route ----------------------------------------------------

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(arr), device=self.device)

    def _try_sparse_candidates(self, dseg, qb, k: int):
        """Score one segment's batch on candidate strips: rows within the
        block cap on tiered strips, the rest on full strips, scattered
        back into batch order. Returns (scores [Q,k] f32, ids [Q,k]
        int32) device tensors."""
        nq = int(qb["n_queries"])
        if nq == 0:
            return (torch.empty((0, k), device=self.device),
                    torch.empty((0, k), dtype=torch.int32,
                                device=self.device))
        mb_env = os.environ.get("SEARCHLITE_SPARSE_MAX_BLOCKS")
        # the oversized-corpus cap: 2x the implied head-term cap
        max_blocks = (int(mb_env) if mb_env is not None
                      else max(512, 2 * (dseg.n1 // 640)))
        launched = self._sparse_light_launch(dseg, qb, k, max_blocks)
        if launched is None:  # every row is over the cap
            ts, td = self._full_strip_launch(dseg, qb, k)
            return ts[:nq], td[:nq]
        ts, td, part = launched
        light_idx = part["light_idx"]
        heavy_idx = part["heavy_idx"]
        if len(heavy_idx) == 0 and len(light_idx) == nq \
                and ts.shape[0] == nq:
            return ts, td
        light_map = np.full(ts.shape[0], nq, dtype=np.int32)
        light_map[:len(light_idx)] = light_idx
        if len(heavy_idx):
            hs, hi = self._full_strip_launch(
                dseg, subset_impact_batch(qb, heavy_idx), k)
            heavy_map = np.full(hs.shape[0], nq, dtype=np.int32)
            heavy_map[:len(heavy_idx)] = heavy_idx
        else:
            hs = torch.full((1, k), float("-inf"), device=self.device)
            hi = torch.zeros((1, k), dtype=torch.int32, device=self.device)
            heavy_map = np.full(1, nq, dtype=np.int32)
        return row_combine(ts, td, hs, hi,
                           self._upload(np.concatenate(
                               [light_map, heavy_map])), n_rows=nq)

    def _full_strip_launch(self, dseg, qb, k: int):
        """Exact scoring of rows over the cap: every term of every row
        rides the strip (the cap is the widest row's block count).
        Returns (scores, ids) in row order, padded rows last."""
        mb = max(int(qb["q_nblk"].max()), 1)
        ts, td, part = self._sparse_light_launch(dseg, qb, k, mb)
        if len(part["heavy_idx"]):
            raise AssertionError("full strips must hold every row")
        return ts, td

    def _sparse_light_launch(self, dseg, qb, k: int, max_blocks: int):
        """Partition the rows within ``max_blocks`` and score them:
        packed uploads in pow-4 block-count tiers, gathered back into
        light-row order, or one explicit table when the packed format
        does not apply. Returns (scores, ids, partition), rows aligned to
        ``partition["light_idx"]``, or None when no row is light."""
        part = partition_sparse_batch_tiered(qb, max_blocks,
                                             dseg.host.idf32, k)
        if part is not None:
            groups = part["groups"]
            outs = [sparse_candidate_scorer_packed(
                dseg.block_docs, dseg.block_impacts_live,
                dseg.sparse_tid_tbl, self._upload(g["packed"]),
                self._upload(g["ovr"]), dseg.sparse_sentinels, k=k,
                t_pad=g["t_pad"], nblk=g["nblk"], log2_run=g["log2_run"],
                n_ovr=g["n_ovr"]) for g in groups]
            n_light = len(part["light_idx"])
            if (len(groups) == 1
                    and np.array_equal(groups[0]["pos_in_light"],
                                       np.arange(n_light))):
                # one tier holding every light row in order
                return outs[0][0], outs[0][1], part
            bl = part["bl"]
            posmaps = np.full(sum(g["packed"].shape[0] for g in groups),
                              bl, dtype=np.int32)
            off = 0
            for g in groups:
                posmaps[off:off + len(g["pos_in_light"])] = \
                    g["pos_in_light"]
                off += g["packed"].shape[0]
            ts, td = group_gather([o[0] for o in outs],
                                  [o[1] for o in outs],
                                  self._upload(posmaps), bl=bl)
            return ts, td, part
        part = partition_sparse_batch(qb, max_blocks)
        if part is None:
            return None
        # explicit table: row chunks bound each launch's strip lanes
        tbl = part["tbl"]
        nblk = part["nblk"]
        step = max(16, STRIP_CHUNK_ELEMS // (nblk * 128))
        outs = [sparse_candidate_scorer(
            dseg.block_docs, dseg.block_impacts_live,
            self._upload(tbl[:, r0:r0 + step]), dseg.sparse_sentinels,
            k=k, t_pad=part["t_pad"], nblk=nblk,
            log2_run=part["log2_run"])
            for r0 in range(0, tbl.shape[1], step)]
        return (torch.cat([o[0] for o in outs]),
                torch.cat([o[1] for o in outs]), part)

    # -- host merge -----------------------------------------------------------

    def _merge_batch_output(self, queries, per_segment, blimits,
                            output: str, limit: int):
        """One batch's per-segment (seg_ord, scores, ids) as the requested
        result surface, the empty index included."""
        if output == "arrays":
            if not per_segment:
                k = int(blimits.max()) if len(blimits) else limit
                q = len(queries)
                return (np.full((q, k), -np.inf, dtype=np.float32),
                        np.zeros((q, k), dtype=np.int32),
                        np.zeros((q, k), dtype=np.int32))
            return self._merge_batch_arrays(per_segment, blimits)
        if not per_segment:
            return [[] for _ in queries]
        return self._merge_batch_results(per_segment, blimits)

    def _merge_batch_arrays(self, per_segment, limits):
        """Per-segment top-k merged into (scores, doc_ords, seg_ords),
        (score desc, (seg, doc) asc), -inf past each row's matches and
        limit; one lexsort."""
        if len(per_segment) == 1:
            seg_ord, scores, ids = per_segment[0]
            scores = scores.astype(np.float32, copy=True)
            ids = ids.astype(np.int32, copy=False)
            seg_arr = np.full(ids.shape, seg_ord, dtype=np.int32)
        else:
            scores = np.concatenate(
                [s for _o, s, _i in per_segment], axis=1).astype(np.float32)
            ids = np.concatenate(
                [i for _o, _s, i in per_segment], axis=1).astype(np.int32)
            seg_arr = np.concatenate(
                [np.full(i.shape, o, dtype=np.int32)
                 for o, _s, i in per_segment], axis=1)
            order = np.lexsort((ids, seg_arr, -scores), axis=-1)
            k = min(scores.shape[1],
                    int(limits.max()) if len(limits) else scores.shape[1])
            order = order[:, :k]
            scores = np.take_along_axis(scores, order, axis=1)
            ids = np.take_along_axis(ids, order, axis=1)
            seg_arr = np.take_along_axis(seg_arr, order, axis=1)
        col = np.arange(scores.shape[1])
        scores[col[None, :] >= np.asarray(limits)[:, None]] = -np.inf
        return scores, ids, seg_arr

    def _merge_batch_results(self, per_segment, limits):
        scores, ids, seg_arr = self._merge_batch_arrays(per_segment, limits)
        docstrs = np.empty(ids.shape, dtype=object)
        for seg_ord, _s, _i in per_segment:
            seg = self.segments[seg_ord]
            dids = getattr(seg, "_doc_ids_obj_arr", None)
            if dids is None or len(dids) != len(seg.doc_ids):
                dids = np.asarray(seg.doc_ids, dtype=object)
                seg._doc_ids_obj_arr = dids
            mask = seg_arr == seg_ord
            # -inf cells may hold the dead slot: clip, they are never read
            docstrs[mask] = dids[np.minimum(ids[mask], len(dids) - 1)]
        take = (scores != -np.inf).sum(axis=1).astype(np.int64)
        from searchlite_tpu.native import get_results_mod

        mod = get_results_mod()
        if mod is not None:
            return mod.build(np.ascontiguousarray(docstrs),
                             np.ascontiguousarray(scores, dtype=np.float32),
                             np.ascontiguousarray(take, dtype=np.int64))
        return [list(zip(drow[:n].tolist(), srow[:n]))
                for n, drow, srow in zip(take.tolist(), docstrs,
                                         scores.tolist())]


def _fetch(tensors: list[torch.Tensor]) -> list[np.ndarray]:
    """One device-to-host copy of many 32-bit tensors (their bits are
    concatenated as int32), split back into numpy arrays of their own
    dtypes and shapes."""
    if not tensors:
        return []
    flat = torch.cat([t.contiguous().view(torch.int32).reshape(-1)
                      for t in tensors]).cpu().numpy()
    out = []
    off = 0
    for t in tensors:
        n = t.numel()
        np_dtype = np.float32 if t.dtype == torch.float32 else np.int32
        out.append(flat[off:off + n].view(np_dtype).reshape(t.shape))
        off += n
    return out
