"""IndexReader: batched BM25 search over torch tensors.

The batched half of ``searchlite_tpu/api/reader.py`` (``search_batch`` /
``search_batch_many`` with ``execution="bm25"``), on one torch device
(the card unless the caller asks for the CPU), routed as the JAX reader routes: per segment, the dense-M
estimate ``(s_pad + Q) * n1 * 4`` against ``SEARCHLITE_M_BUDGET_BYTES``.

Under the budget (``_launch_batch_segment``), with per-query filters and
any k up to the doc axis:

1. native query prep (``build_impact_batch_native``);
2. unfiltered batches with k <= 1024 first try candidate strips: rows
   whose posting blocks fit 32 blocks ride packed strips in pow-4 tiers;
   rows with head terms ride the term-split scorer (light terms on the
   strip, heavy terms by point lookup, a soundness certificate per row);
3. the rest -- filtered batches, k > 1024, the strips' remainder -- take
   the dense split scorer (resident dense rows of the head terms plus a
   scattered M of the batch's other terms) or, when no slot is dense, the
   plain block scorer; both end in the fused score + mask + top-k kernel;
4. every result (and the certificates) comes back in ONE device-to-host
   copy; rows whose certificate failed are re-scored dense in a second
   round (``_apply_split_fallbacks``); the segments merge on the host.

Over the budget (the oversized-corpus route) unfiltered batches with
k <= 1024 ride the strips with the wider cap ``max(512, 2*n1/640)``,
term-split rows included, and rows the strips cannot certify take full
strips holding every term. Filtered or k > 1024 batches over the budget
need ``_search_batch_sharded``, which is not ported yet.

Every route is exact, so results match the JAX reader whichever route it
took (scores to f32 reassociation, divergence D10). ``wand``/``bmw``,
``mesh`` and single-query ``search()`` are not ported yet and raise
``NotImplementedError``.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from searchlite_tpu_torch.api.types import Filter
from searchlite_tpu_torch.errors import QueryError, StorageError
from searchlite_tpu_torch.native import get_results_mod
from searchlite_tpu_torch.ops.impact import (
    build_impact_batch,
    build_impact_batch_native,
    ensure_dense_tables,
    next_pow2,
    split_impact_batch,
    subset_impact_batch,
)
from searchlite_tpu_torch.ops.sparse import (
    STRIP_CHUNK_ELEMS,
    partition_sparse_batch,
    partition_sparse_batch_split,
    partition_sparse_batch_tiered,
)
from searchlite_tpu_torch.query.filters import (
    compute_filters_mask,
    validate_filter,
)
from searchlite_tpu_torch.query.parser import parse_query
from searchlite_tpu_torch.device.index import cached_segment
from searchlite_tpu_torch.ops.impact import impact_scorer, split_impact_scorer
from searchlite_tpu_torch.ops.sparse import (
    group_gather,
    group_gather_sound,
    row_combine,
    sparse_candidate_scorer,
    sparse_candidate_scorer_packed,
    sparse_candidate_scorer_split,
)

# the strip route's own top-k cap (JAX: reader.py::_try_sparse_candidates)
MAX_STRIP_K = 1024
# int32 indexing bound of the dense M scatter (JAX: reader.py)
FLAT_INDEX_LIMIT = 2**31


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to searchlite_tpu_torch yet "
        f"(ROADMAP.md queue 1: {item})")


class IndexReader:
    """Batched reader over ``index`` with every segment's tensors on
    ``device``: the card by default, the CPU only when the caller asks
    (``device="cpu"``). Raises where CUDA is absent; it never falls back
    to the CPU.

    ``route_rows`` counts the rows each route scored (``strip``: light
    rows on plain strips, ``split``: term-split rows with a head term,
    ``dense``: rows through the dense scorers, fallback waves included,
    ``fallback``: unsound term-split rows re-scored dense)."""

    def __init__(self, index, device="cuda"):
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
        self._split_fallback_rows = 0
        self.route_rows = {"strip": 0, "split": 0, "dense": 0,
                           "fallback": 0}

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
        if fields is None:
            fields = [f.name for f in self.schema.text_fields]
        limits = self._check_batch_limits(batches, limit, limits)
        filter_tables = self._batch_filter_tables(batches, filters)
        coalesced = self._coalesce(batches, limit, fields, limits, output,
                                   filter_tables)
        if coalesced is not None:
            return coalesced
        # memory budget of the dense M + score matrices on one device;
        # past it a segment takes the oversized-corpus strip route
        m_budget = int(os.environ.get("SEARCHLITE_M_BUDGET_BYTES",
                                      2 * 1024**3))

        # phase 1: prep + enqueue every batch and segment
        analyzed_all = None
        launches = []  # per batch: [(seg_ord, scores, ids)]
        pending_recs = []  # term-split soundness checks (+ bi/li)
        for bi, (queries, (fidx, distinct), blimits) in enumerate(
                zip(batches, filter_tables, limits)):
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
                k = min(k_batch, dseg.n1)
                pend: list = []
                est_bytes = (qb["s_pad"] + len(queries)) * dseg.n1 * 4
                if int(qb["n_queries"]) == 0:
                    scores = torch.empty((0, k), device=self.device)
                    ids = torch.empty((0, k), dtype=torch.int32,
                                      device=self.device)
                elif (est_bytes <= m_budget
                        and qb["flat_extent"] < FLAT_INDEX_LIMIT):
                    scores, ids = self._launch_batch_segment(
                        dseg, qb, k, fidx, distinct, pending=pend)
                else:
                    scores, ids = self._oversized_launch(
                        dseg, qb, k, fidx, m_budget, pend)
                for rec in pend:
                    rec["bi"] = bi
                    rec["li"] = len(launched)
                    pending_recs.append(rec)
                launched.append((dseg.ord, scores, ids))
            launches.append(launched)

        # phase 2: ONE device-to-host copy for every batch and segment,
        # the term-split soundness flags riding along
        flat = [t for launched in launches for _o, s, i in launched
                for t in (s, i)]
        n_main = len(flat)
        flat += [rec["sound"].to(torch.int32) for rec in pending_recs]
        host = _fetch(flat)
        if pending_recs:
            self._apply_split_fallbacks(launches, host, n_main,
                                        pending_recs)
            del host[n_main:]

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

    def _batch_filter_tables(self, batches, filters):
        """Validate and deduplicate per-query filters (JAX
        ``_batch_filter_tables``): per batch (fidx [Q] int32, distinct
        [Filter, ...]), or (None, None) for a batch without filters;
        fidx 0 means no filter (row 0 of the mask table is all-true)."""
        if filters is None:
            return [(None, None)] * len(batches)
        if len(filters) != len(batches):
            raise QueryError("filters must align with batches")
        out = []
        for queries, batch_filters in zip(batches, filters):
            if batch_filters is None:
                out.append((None, None))
                continue
            if len(batch_filters) != len(queries):
                raise QueryError("filters must align with queries")
            distinct: list = []
            by_key: dict[str, int] = {}
            fidx = np.zeros(len(queries), dtype=np.int32)
            for i, f in enumerate(batch_filters):
                if f is None:
                    continue
                fobj = Filter.from_json(f)
                validate_filter(self.schema, fobj)
                key = json.dumps(fobj.to_json(), sort_keys=True)
                fid = by_key.get(key)
                if fid is None:
                    distinct.append(fobj)
                    fid = len(distinct)  # 1-based; 0 = match-all
                    by_key[key] = fid
                fidx[i] = fid
            out.append((fidx, distinct) if distinct else (None, None))
        return out

    def _segment_filter_rows(self, dseg, distinct) -> torch.Tensor:
        """[F+1, n1] bool mask table of one segment on its device: row 0
        all-true over the segment's docs, rows 1..F the distinct filters
        (JAX ``_segment_filter_rows_np`` + ``_segment_filter_rows``).
        Cached per (segment, filters)."""
        key = tuple(json.dumps(f.to_json(), sort_keys=True)
                    for f in distinct)
        cached = dseg.filter_rows_cache
        if cached is not None and cached[0] == key:
            return cached[1]
        seg = dseg.reader
        rows = np.zeros((len(distinct) + 1, dseg.n1), dtype=bool)
        rows[0, :seg.doc_count] = True
        for i, fobj in enumerate(distinct):
            rows[i + 1, :seg.doc_count] = compute_filters_mask(seg.fast,
                                                              [fobj])
        rows_dev = torch.from_numpy(rows).to(dseg.device)
        dseg.filter_rows_cache = (key, rows_dev)
        return rows_dev

    def _coalesce(self, batches, limit, fields, limits, output,
                  filter_tables):
        """Micro-batch coalescing (JAX ``reader.py:2254-2308``): re-chunk
        a stream of narrow filterless batches into launches of up to
        ``SEARCHLITE_BATCH_COALESCE`` queries and split the results back
        per batch (rows are independent). Returns None when the stream
        is not coalesced."""
        coalesce = int(os.environ.get("SEARCHLITE_BATCH_COALESCE", "4096"))
        if not (coalesce > 0 and len(batches) > 1
                and all(f[0] is None for f in filter_tables)
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

    # -- routes ----------------------------------------------------------

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(arr), device=self.device)

    def _oversized_launch(self, dseg, qb, k: int, fidx, m_budget: int,
                          pending: list):
        """A segment over the dense-M budget: candidate strips with the
        oversized-corpus cap, term-split rows included (JAX
        ``search_batch_many``, ``reader.py:2407-2424``). When no row fits
        the cap, or no term of the batch is in the segment, every row
        rides full strips. Filtered and k > 1024 batches need the
        doc-sharded dense scan."""
        out = None
        if fidx is None:
            out = self._try_sparse_candidates(dseg, qb, k,
                                              shard_budget=m_budget,
                                              pending=pending)
            if out is None:
                out = self._full_strip_launch(dseg, qb, k)
                if out is not None:
                    nq = int(qb["n_queries"])
                    out = (out[0][:nq], out[1][:nq])
        if out is None:
            raise _not_ported(
                "filtered or k > 1024 batches over the dense-M budget "
                "(SEARCHLITE_M_BUDGET_BYTES)", "_search_batch_sharded")
        return out

    def _launch_batch_segment(self, dseg, qb, k: int, fidx=None,
                              distinct=None, allow_sparse: bool = True,
                              pending=None, n_rows: Optional[int] = None):
        """One segment's batch under the budget (JAX
        ``_launch_batch_segment_inner``): unfiltered batches try the
        candidate strips first; the rest take the dense split scorer when
        the segment has dense rows and the batch a dense slot, else the
        plain block scorer. ``(fidx, distinct)`` are the batch's filters
        (see :meth:`_batch_filter_tables`). ``n_rows`` is the count of real
        rows for ``route_rows`` (default: every row of ``qb``). Returns
        (scores [Q,k], ids [Q,k]) device tensors."""
        use_filters = fidx is not None
        if allow_sparse and not use_filters:
            out = self._try_sparse_candidates(dseg, qb, k, pending=pending)
            if out is not None:
                return out
        if qb["flat_extent"] >= FLAT_INDEX_LIMIT:
            raise QueryError(
                "impact matrix exceeds int32 indexing; route through "
                "the doc-sharded batch path")
        ensure_dense_tables(qb)
        self.route_rows["dense"] += (int(qb["n_queries"]) if n_rows is None
                                     else n_rows)
        filter_rows = fidx_dev = None
        if use_filters:
            filter_rows = self._segment_filter_rows(dseg, distinct)
            fidx_dev = self._upload(fidx)
        dense_budget = int(os.environ.get("SEARCHLITE_DENSE_M_BYTES",
                                          2 * 1024**3))
        if dense_budget > 0:
            dense = dseg.dense_rows(dense_budget)
            if dense is not None:
                split = split_impact_batch(
                    qb, dense["row_of_tid"],
                    n_rows=len(dense["row_of_tid"]), n1=dseg.n1)
                if split is not None:
                    return split_impact_scorer(
                        dseg.block_docs, dseg.block_impacts_live,
                        dense["m_dense"], dseg.deleted,
                        self._upload(split["packed"]), filter_rows,
                        fidx_dev, k=k, s_pad=split["s_pad"],
                        n_queries=qb["n_queries"], nb_pad=split["nb_pad"],
                        wd_pad=split["wd_pad"], ws_pad=split["ws_pad"])
        return impact_scorer(
            dseg.block_docs, dseg.block_impacts_live, dseg.deleted,
            self._upload(qb["blk_idx"]), self._upload(qb["slot_row"]),
            self._upload(qb["w_idx"]), self._upload(qb["w_val"]),
            filter_rows, fidx_dev, k=k, s_pad=qb["s_pad"],
            n_queries=qb["n_queries"])

    def _try_sparse_candidates(self, dseg, qb, k: int,
                               shard_budget: int = 0, pending=None):
        """Route a batch through the candidate strips (JAX
        ``_try_sparse_candidates``): rows within the block cap (32 under
        the budget, ``max(512, 2*n1/640)`` with ``shard_budget`` set) are
        scored on their own candidates; the remainder is re-packed and
        scored dense under the budget, on full strips over it; both row
        groups are scattered back into batch order. With ``pending`` (a
        list) head-term rows may take the term split, and a record of
        their soundness flags is appended: the caller must fetch it and
        re-score unsound rows (:meth:`_apply_split_fallbacks`). Returns
        None when the strips do not apply (the caller goes dense)."""
        mb_env = os.environ.get("SEARCHLITE_SPARSE_MAX_BLOCKS")
        if mb_env is not None:
            max_blocks = int(mb_env)
        elif shard_budget:
            max_blocks = max(512, 2 * (dseg.n1 // 640))
        else:
            max_blocks = 32
        if max_blocks <= 0 or k > MAX_STRIP_K:
            return None
        nq = int(qb["n_queries"])
        if nq == 0 or qb["n_slots"] == 0:
            return None
        launched = self._sparse_light_launch(
            dseg, qb, k, max_blocks, allow_split=pending is not None)
        if launched is None:
            return None
        ts, td, part = launched
        light_idx = part["light_idx"]
        heavy_idx = part["heavy_idx"]
        if part.get("sound") is not None:
            pending.append({
                "dseg": dseg, "qb": qb, "light_idx": light_idx,
                "sound": part["sound"], "k": k,
                "shard_budget": shard_budget})
        if len(heavy_idx) == 0 and len(light_idx) == nq \
                and ts.shape[0] == nq:
            return ts, td
        light_map = np.full(ts.shape[0], nq, dtype=np.int32)
        light_map[:len(light_idx)] = light_idx
        if len(heavy_idx):
            hqb = subset_impact_batch(qb, heavy_idx)
            if shard_budget:
                out_h = self._full_strip_launch(dseg, hqb, k)
                if out_h is None:
                    raise _not_ported(
                        "rows the full strips cannot hold over the "
                        "dense-M budget", "_search_batch_sharded")
            else:
                out_h = self._launch_batch_segment(
                    dseg, hqb, k, allow_sparse=False,
                    n_rows=len(heavy_idx))
            hs, hi = out_h
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
        """Exact, certificate-free scoring on full strips: every term of
        every row rides the strip (the cap is the widest row's block
        count). Returns (scores, ids) in row order, padded rows last, or
        None when the strips cannot hold the batch."""
        nq = int(qb["n_queries"])
        if nq == 0 or k > MAX_STRIP_K:
            return None
        mb = max(int(qb["q_nblk"].max()), 1)
        launched = self._sparse_light_launch(dseg, qb, k, mb)
        if launched is None:
            return None
        ts, td, part = launched
        if len(part["heavy_idx"]) or len(part["light_idx"]) != nq:
            return None
        return ts, td

    def _sparse_light_launch(self, dseg, qb, k: int, max_blocks: int,
                             allow_split: bool = False):
        """Partition the rows within ``max_blocks`` and score them (JAX
        ``_sparse_light_launch``): packed uploads in pow-4 block-count
        tiers, gathered back into light-row order, or one explicit table
        when the packed format does not apply. With ``allow_split`` the
        term-split partition also admits head-term rows; their groups run
        the term-split scorer and ``partition["sound"]`` holds per-light-
        row soundness flags the caller must honour. Returns (scores, ids,
        partition), rows aligned to ``partition["light_idx"]``, or None
        when no row is light."""
        host = dseg.host
        part = None
        term_cap = 0
        use_packed = os.environ.get("SEARCHLITE_SPARSE_PACKED", "1") != "0"
        if (allow_split and use_packed
                and os.environ.get("SEARCHLITE_TERM_SPLIT", "1") != "0"):
            term_cap = int(os.environ.get(
                "SEARCHLITE_HEAVY_TERM_BLOCKS",
                str(max_blocks if max_blocks <= 512
                    else max(512, max_blocks // 16))))
            h_max = int(os.environ.get("SEARCHLITE_HEAVY_SLOTS", "4"))
            ub_ratio = float(os.environ.get("SEARCHLITE_SPLIT_UB_RATIO",
                                            "0.5"))
            part = partition_sparse_batch_split(
                qb, max_blocks, host.idf32, k, term_cap, h_max,
                maximp=host.heavy_lookup_host(term_cap)["maximp"],
                ub_ratio=ub_ratio)
        if part is None and use_packed:
            part = partition_sparse_batch_tiered(qb, max_blocks,
                                                 host.idf32, k)
        if part is not None:
            groups = part["groups"]
            kp = next_pow2(max(4 * k, 64))
            outs = []
            flags = []
            for g in groups:
                n_real = len(g["pos_in_light"])
                if g.get("hvy") is not None:
                    # kp must clear the candidate band (JAX: a floor of
                    # SEARCHLITE_SPLIT_KP, at most 8192)
                    kp_g = next_pow2(min(
                        max(kp, g["nblk"] * 128 // 64,
                            int(os.environ.get("SEARCHLITE_SPLIT_KP",
                                               "4096"))), 8192))
                    hl = dseg.heavy_lookup(term_cap)
                    # only rows with a head term run the lookups
                    heavy_rows = np.flatnonzero(
                        (g["hvy"][1] != 0).any(axis=1))
                    ts_g, td_g, snd = sparse_candidate_scorer_split(
                        dseg.block_docs, dseg.block_impacts_live,
                        dseg.sparse_tid_tbl, hl["tbl"], hl["base"],
                        hl["log2g"], hl["maximp"], self._upload(g["packed"]),
                        self._upload(g["ovr"]), self._upload(g["hvy"]),
                        dseg.sparse_sentinels, k=k, kp=kp_g,
                        t_pad=g["t_pad"], nblk=g["nblk"],
                        log2_run=g["log2_run"], h_pad=g["h_pad"],
                        n_ovr=g["n_ovr"],
                        heavy_rows=self._upload(heavy_rows))
                    outs.append((ts_g, td_g))
                    flags.append(snd)
                    n_split = len(heavy_rows)
                    self.route_rows["split"] += n_split
                    self.route_rows["strip"] += n_real - n_split
                else:
                    outs.append(sparse_candidate_scorer_packed(
                        dseg.block_docs, dseg.block_impacts_live,
                        dseg.sparse_tid_tbl, self._upload(g["packed"]),
                        self._upload(g["ovr"]), dseg.sparse_sentinels,
                        k=k, t_pad=g["t_pad"], nblk=g["nblk"],
                        log2_run=g["log2_run"], n_ovr=g["n_ovr"]))
                    flags.append(None)
                    self.route_rows["strip"] += n_real
            any_split = any(f is not None for f in flags)
            n_light = len(part["light_idx"])
            if (len(groups) == 1
                    and np.array_equal(groups[0]["pos_in_light"],
                                       np.arange(n_light))):
                # one tier holding every light row in order
                if any_split:
                    part["sound"] = flags[0]
                return outs[0][0], outs[0][1], part
            bl = part["bl"]
            posmaps = np.full(sum(g["packed"].shape[0] for g in groups),
                              bl, dtype=np.int32)
            off = 0
            for g in groups:
                posmaps[off:off + len(g["pos_in_light"])] = \
                    g["pos_in_light"]
                off += g["packed"].shape[0]
            if any_split:
                flags = [f if f is not None else torch.ones(
                    (o[0].shape[0],), dtype=torch.bool, device=self.device)
                    for f, o in zip(flags, outs)]
                ts, td, part["sound"] = group_gather_sound(
                    [o[0] for o in outs], [o[1] for o in outs], flags,
                    self._upload(posmaps), bl=bl)
                return ts, td, part
            ts, td = group_gather([o[0] for o in outs],
                                  [o[1] for o in outs],
                                  self._upload(posmaps), bl=bl)
            return ts, td, part
        part = partition_sparse_batch(qb, max_blocks)
        if part is None or k > part["nblk"] * 128:
            return None
        self.route_rows["strip"] += len(part["light_idx"])
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

    def _apply_split_fallbacks(self, launches, host, n_main: int,
                               pending_recs) -> None:
        """The term split's fallback wave (JAX ``_apply_split_fallbacks``):
        rows whose soundness certificate failed are re-scored (dense under
        the budget, on full strips over it) and patched into the fetched
        per-(batch, segment) arrays in place. One more dispatch and fetch
        round, only when some row failed."""
        entry_off = np.cumsum([0] + [len(launched) for launched in launches])
        patches = []
        for rec, flags in zip(pending_recs, host[n_main:]):
            li = rec["light_idx"]
            bad = li[flags[:len(li)] == 0]
            if len(bad) == 0:
                continue
            dseg = rec["dseg"]
            self._split_fallback_rows += len(bad)
            self.route_rows["fallback"] += len(bad)
            hqb = subset_impact_batch(rec["qb"], np.asarray(bad))
            if rec["shard_budget"]:
                out = self._full_strip_launch(dseg, hqb, rec["k"])
                if out is None:
                    raise _not_ported(
                        "fallback rows the full strips cannot hold over "
                        "the dense-M budget", "_search_batch_sharded")
            else:
                out = self._launch_batch_segment(
                    dseg, hqb, rec["k"], allow_sparse=False,
                    n_rows=len(bad))
            patches.append((rec, bad, out[0], out[1]))
        if not patches:
            return
        vals = iter(_fetch([x for _r, _b, ps, pi in patches
                            for x in (ps, pi)]))
        for rec, bad, _s, _i in patches:
            ps = next(vals)
            pi = next(vals)
            pos = 2 * (int(entry_off[rec["bi"]]) + rec["li"])
            sc = np.array(host[pos], copy=True)
            ids = np.array(host[pos + 1], copy=True)
            sc[bad] = ps[:len(bad)]
            ids[bad] = pi[:len(bad)]
            host[pos] = sc
            host[pos + 1] = ids

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
