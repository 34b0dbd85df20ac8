"""Batched sparse candidate scoring in PyTorch: top-k over each query's
own posting blocks.

The port of ``searchlite_tpu/ops/sparse.py``. Per query row, the
posting blocks of its terms form a ``[B, nblk*128]`` candidate strip of
(doc, impact x weight); the strip core
(:func:`searchlite_tpu_torch.ops.strip_topk.strip_topk_blocks`) sums
duplicate docs and takes the top-k. On CUDA tensors the strip is never
materialised: the hand-written Hopper kernel reads the posting blocks in
place and searches the terms' pre-sorted doc runs. On CPU tensors the
plain version gathers the strip (:func:`strip_gather`) and sorts it. The
host half -- the per-batch partitions (``partition_sparse_batch_tiered``,
``partition_sparse_batch_split``, ``partition_sparse_batch``) and the
heavy-term lookup build (``build_heavy_lookup_host``) -- is this
package's own numpy copy of the JAX module's and builds the same arrays.

Sentinels follow the reference: ``sent`` is the segment's ``[2]`` int32
tensor (sentinel block row, dead doc slot ``n1-1``), read on device so
no call waits for the host.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from searchlite_tpu_torch.ops.impact import (
    csr_row_lengths,
    csr_take_rows,
    next_pow2,
    pow15_bucket,
)
from searchlite_tpu_torch.ops.strip_topk import (  # noqa: F401
    strip_gather,
    strip_lanes_blocks,
    strip_topk_blocks,
)

# Packed per-(query, slot) upload format (``_pack_entries`` /
# ``sparse_candidate_scorer_packed``): one int32 carries the term id in the
# low 26 bits and the within-query occurrence count in bits 26..30 (sign
# bit clear). Segments with >= 2^26 terms or queries repeating one term
# more than 31 times take the explicit-table path.
TID_BITS = 26
TID_LIMIT = 1 << TID_BITS
OCC_MAX = 31

# -- host partitions (numpy) -------------------------------------------------


def build_heavy_lookup_host(postings, block_docs_np, block_impacts_np,
                            n1: int, term_cap: int):
    """Host build of the per-segment heavy-term doc→block lookup used
    by the term-split candidate scorer (TPU-native batched WAND — see
    make_sparse_candidate_scorer_split).

    For every term with more than ``term_cap`` posting blocks, the doc
    axis is cut into pow-2 groups of width G (per term, G chosen so
    any group's docs lie within TWO consecutive blocks — G = 128
    always satisfies this because a 128-posting block spans ≥ 127
    docs, and wider G is used when the term's average block span
    allows). ``tbl[base + (doc >> log2g)]`` then names the first of
    the ≤ 2 blocks that can contain ``doc``: one int32 gather plus two
    128-wide block-row gathers replace the reference's posting-cursor
    skip_to (`query/wand.rs:883-891`) — no per-wave run tables, no
    per-batch upload.

    Returns dict of host arrays: ``tbl`` int32 [total_entries+1]
    (absolute block-row ids), ``base`` int32 [n_terms] (−1 = term has
    no row), ``log2g`` int32 [n_terms], ``maximp`` f32 [n_terms]
    (per-term max impact incl. tombstoned docs — a sound upper bound
    for the non-candidate pruning check)."""
    nb = postings.term_block_count.astype(np.int64)
    start = postings.term_block_start.astype(np.int64)
    n_terms = len(nb)
    base = np.full(n_terms, -1, dtype=np.int32)
    log2g = np.zeros(n_terms, dtype=np.int32)
    # per-term max impact: blocks are term-contiguous & ascending
    maximp = np.zeros(n_terms, dtype=np.float32)
    has = nb > 0
    if has.any():
        bmax = block_impacts_np[: int((start + nb).max()), :].max(
            axis=1).astype(np.float32)
        red = np.maximum.reduceat(bmax, start[has])
        maximp[has] = red
    heavy = np.flatnonzero(nb > term_cap)
    parts = []
    total = 0
    for t in heavy:
        s, c = int(start[t]), int(nb[t])
        lasts = block_docs_np[s:s + c, -1].astype(np.int64)
        g = 128
        span = max(128 * n1 // max(int(postings.term_df[t]), 1), 128)
        while g * 2 <= span:
            g *= 2
        while g > 128:
            lo = np.minimum(
                np.searchsorted(lasts, np.arange(0, n1, g)), c - 1)
            if np.all(np.diff(lo) <= 1):
                break
            g //= 2
        lo = np.minimum(
            np.searchsorted(lasts, np.arange(0, n1, g)), c - 1)
        parts.append((lo + s).astype(np.int32))
        base[t] = total
        log2g[t] = int(g).bit_length() - 1
        total += len(lo)
    tbl = (np.concatenate(parts + [np.zeros(1, dtype=np.int32)])
           if parts else np.zeros(1, dtype=np.int32))
    return {"tbl": tbl, "base": base, "log2g": log2g,
            "maximp": maximp}


def tier_bounds(max_blocks: int) -> list:
    """Ladder of light-row tiers up to ``max_blocks``: pow-4 to 512
    (e.g. 512 → [8, 32, 128, 512]), pow-2 beyond (8192 →
    [8, 32, 128, 512, 1024, ..., 8192]). The candidate scorer pads
    every row's strip to the GROUP's max block count, so mixing a
    480-block query into a batch of 4-block queries makes every row
    sort a 61k-candidate strip; tiering keeps each row's padding
    bounded (4x low tiers, 2x above 512 — where the strip sort is the
    dominant cost and pad columns are pure waste) at the cost of one
    launch per occupied tier."""
    bounds = []
    b = 8
    while b < max_blocks:
        bounds.append(b)
        b *= 4 if b < 512 else 2
    bounds.append(max_blocks)
    return bounds


# per-launch candidate-strip element cap (docs+impacts i32/f32 pairs):
# a group whose rows x padded strip width exceed it is emitted as
# multiple row chunks so one wide tier can't blow the device memory
# budget (16 rows x 2M-candidate strips = 256M elements = 2 GB already).
STRIP_CHUNK_ELEMS = int(os.environ.get(
    "SEARCHLITE_STRIP_CHUNK_ELEMS", str(128 * 1024 * 1024)))


def _chunk_rows(n_rows: int, nblk: int) -> int:
    """Rows per launch for a tier whose padded strips hold
    ``nblk`` * 128 candidates, bounded by STRIP_CHUNK_ELEMS."""
    per = max(16, STRIP_CHUNK_ELEMS // max(nblk * 128, 1))
    return min(n_rows, per)


def _split_light(qb, max_blocks: int):
    """Shared light/heavy split of a build_impact_batch() output by
    per-query gathered-block count: queries at or under ``max_blocks``
    go to the candidate scorer, the rest (head-term queries, whose
    candidate strips would stretch every row of the batch) stay on the
    dense path. Returns None when no query qualifies, else the light
    rows' CSR entry gather + bucketed static shapes."""
    nblk_q = qb["q_nblk"]
    light = nblk_q <= max_blocks
    if not light.any():
        return None
    light_idx = np.flatnonzero(light)
    heavy_idx = np.flatnonzero(~light)
    counts = csr_row_lengths(qb)
    idx, sc, pos = csr_take_rows(qb["qs_start"], counts, light_idx)
    t_max = int(sc.max()) if len(sc) else 1
    t_pad = next_pow2(max(t_max, 2))
    return {
        "idx": idx,
        "pos": pos,
        "rows_rep": np.repeat(
            np.arange(len(light_idx), dtype=np.int64), sc),
        "light_idx": light_idx,
        "heavy_idx": heavy_idx,
        "t_pad": t_pad,
        "nblk": pow15_bucket(int(nblk_q[light_idx].max()), minimum=16),
        "bl": pow15_bucket(len(light_idx), minimum=64),
        "log2_run": max((t_pad - 1).bit_length(), 1),
    }


def partition_sparse_batch(qb, max_blocks: int):
    """Explicit-table emission of the light/heavy split: the light
    rows' [3, Bl, t_pad] (bstart, bcnt, weight) upload for
    make_sparse_candidate_scorer(). Returns None when no query
    qualifies."""
    sp = _split_light(qb, max_blocks)
    if sp is None:
        return None
    idx, pos, rows_rep = sp["idx"], sp["pos"], sp["rows_rep"]
    t_pad, bl = sp["t_pad"], sp["bl"]
    bstart = np.zeros((bl, t_pad), dtype=np.int32)
    bcnt = np.zeros((bl, t_pad), dtype=np.int32)
    w = np.zeros((bl, t_pad), dtype=np.float32)
    slots = qb["qs_slot"][idx]
    bstart[rows_rep, pos] = qb["slot_bstart"][slots]
    bcnt[rows_rep, pos] = qb["slot_bcnt"][slots]
    w[rows_rep, pos] = qb["qs_w"][idx]
    sp["tbl"] = np.stack([bstart, bcnt, w.view(np.int32)])
    return sp


def _packed_applies(qb) -> bool:
    """Batch-global guards for the packed upload format: per-entry
    occurrence counts present, term ids under 2^26, occurrence counts
    at most 31."""
    qs_cnt = qb.get("qs_cnt")
    if qs_cnt is None:
        return False
    slot_tids = qb["slot_tids"]
    if len(slot_tids) and int(slot_tids.max()) >= TID_LIMIT:
        return False
    if len(qs_cnt) and int(qs_cnt.max()) > OCC_MAX:
        return False
    return True


def _take_kept(qb, row_idx, entry_keep):
    """Row-major CSR expansion of the given rows' entries restricted
    to ``entry_keep`` (bool over the global qs_* entry axis). Returns
    (idx, rows_rep, pos, sc): kept global entry indices, their row
    ordinal within ``row_idx``, within-row rank, and per-row kept
    counts."""
    counts = csr_row_lengths(qb)
    idx, sc, _pos = csr_take_rows(qb["qs_start"], counts, row_idx)
    rows_rep = np.repeat(np.arange(len(row_idx), dtype=np.int64), sc)
    keep = entry_keep[idx]
    idx = idx[keep]
    rows_rep = rows_rep[keep]
    sc2 = np.bincount(rows_rep, minlength=len(row_idx)).astype(np.int64)
    starts2 = np.concatenate([[0], np.cumsum(sc2)[:-1]])
    pos = np.arange(len(idx), dtype=np.int64) - starts2[rows_rep]
    return idx, rows_rep, pos, sc2


def _emit_packed_rows(qb, row_idx, idf32, bl_min: int = 64):
    """Packed [bl, t_pad] int32 of (tid | occ << 26) for the given
    query rows, plus the (usually empty) weight-override COO: entries
    where the device's f32(occ)*f32(idf) double-rounds away from the
    host's f32(occ * f64(idf)) ship their exact weight. ``idf32`` is
    the segment's f64 idf table pre-rounded to f32 — the values the
    device recomputes weights from (DeviceSegment.idf32 must match
    sparse_tid_tbl's row 2)."""
    counts = csr_row_lengths(qb)
    idx, sc, pos = csr_take_rows(qb["qs_start"], counts, row_idx)
    t_max = int(sc.max()) if len(sc) else 1
    rows_rep = np.repeat(np.arange(len(row_idx), dtype=np.int64), sc)
    return _pack_entries(qb, idx, rows_rep, pos, len(row_idx), t_max,
                         idf32, bl_min)


def _pack_entries(qb, idx, rows_rep, pos, n_rows, t_max, idf32,
                  bl_min):
    """Shared packed-table emission from a row-major entry selection
    (see _emit_packed_rows for the format)."""
    t_pad = next_pow2(max(t_max, 2))
    bl = pow15_bucket(n_rows, minimum=bl_min)
    occ = qb["qs_cnt"][idx]
    slots = qb["qs_slot"][idx]
    tids_e = qb["slot_tids"][slots].astype(np.int64)
    packed = np.zeros((bl, t_pad), dtype=np.int32)
    packed[rows_rep, pos] = (
        tids_e | (occ.astype(np.int64) << TID_BITS)).astype(np.int32)
    qs_w = qb["qs_w"][idx]
    w_dev = occ.astype(np.float32) * idf32[tids_e]
    bad = w_dev.view(np.int32) != qs_w.view(np.int32)
    n_ovr = int(bad.sum())
    if n_ovr:
        ov_pad = next_pow2(max(n_ovr, 8))
        ovr = np.full((2, ov_pad), bl * t_pad, dtype=np.int32)
        ovr[0, :n_ovr] = (rows_rep[bad] * t_pad + pos[bad]).astype(
            np.int32)
        ovr[1, :n_ovr] = qs_w[bad].view(np.int32)
    else:
        ovr = np.zeros((2, 1), dtype=np.int32)
    return {
        "packed": packed,
        "ovr": ovr,
        "n_ovr": next_pow2(max(n_ovr, 8)) if n_ovr else 0,
        "t_pad": t_pad,
        "log2_run": max((t_pad - 1).bit_length(), 1),
    }


def partition_sparse_batch_split(qb, max_blocks: int,
                                 idf32: np.ndarray, k: int,
                                 term_cap: int, h_max: int,
                                 maximp: np.ndarray | None = None,
                                 ub_ratio: float = 0.5):
    """TERM-level split partition (TPU-native batched WAND): an entry
    is heavy when ITS term exceeds ``term_cap`` blocks; a row is
    eligible when its LIGHT entries total ≤ ``max_blocks`` blocks, it
    has ≤ ``h_max`` heavy entries, and ≥ 1 light entry. Eligible rows
    ride the candidate strips on their light terms (pow-4 tiers, as
    partition_sparse_batch_tiered) with per-group heavy tables
    [2, Bg, h_pad] (term id, exact f32 weight bit-cast) consumed by
    make_sparse_candidate_scorer_split; the rest fall back dense.

    Against the row-level tiered partition this turns head-term
    queries — previously ALL dense — into strip rows with a 2-block
    point lookup per heavy term, at the price of a per-row soundness
    certificate (rows whose certificate fails must be re-scored dense;
    the scorer returns the flags). Groups without heavy entries carry
    ``hvy=None`` and should run the plain packed scorer."""
    if not _packed_applies(qb):
        return None
    nq = qb["n_queries"]
    counts = csr_row_lengths(qb)
    row_of = np.repeat(np.arange(nq, dtype=np.int64), counts)
    ent_bcnt = qb["slot_bcnt"][qb["qs_slot"]].astype(np.int64)
    heavy_e = ent_bcnt > term_cap
    n_heavy = np.bincount(row_of[heavy_e], minlength=nq)
    light_blocks = np.bincount(
        row_of[~heavy_e], weights=ent_bcnt[~heavy_e],
        minlength=nq).astype(np.int64)
    n_light = np.bincount(row_of[~heavy_e], minlength=nq)
    eligible = ((light_blocks <= max_blocks) & (n_heavy <= h_max)
                & ((n_light > 0) | (n_heavy == 0)))
    if maximp is not None and ub_ratio > 0:
        # host routing predictor: a split row's certificate needs its
        # k-th candidate score to strictly beat HUB = Σ_heavy w·maximp.
        # θ is unknowable before scoring, but rows where HUB rivals
        # even the best light term's ceiling (max_light w·maximp)
        # almost always fail it — send those straight to the dense
        # path instead of scoring them twice. Pure routing: mispredicts
        # are caught by the certificate (→ fallback wave) or merely
        # dense-score a row that would have been sound.
        ent_ub = qb["qs_w"] * maximp[
            qb["slot_tids"][qb["qs_slot"]]].astype(np.float32)
        hub = np.bincount(row_of[heavy_e], weights=ent_ub[heavy_e],
                          minlength=nq)
        lmax = np.zeros(nq, dtype=np.float64)
        np.maximum.at(lmax, row_of[~heavy_e], ent_ub[~heavy_e])
        eligible &= (n_heavy == 0) | (hub < ub_ratio * lmax)
    if not eligible.any():
        return None
    light_idx = np.flatnonzero(eligible)
    heavy_idx = np.flatnonzero(~eligible)
    nblk_min = -(-k // 128)  # strips must hold at least k candidates
    groups = []
    prev = -1  # first tier includes 0-block strips (all-df-0 rows)
    for bound in tier_bounds(max_blocks):
        lb = light_blocks[light_idx]
        sel = (lb > prev) & (lb <= bound)
        prev = bound
        if not sel.any():
            continue
        pos_sel = np.flatnonzero(sel)
        nblk_tier = pow15_bucket(
            max(int(lb[pos_sel].max()), nblk_min), minimum=16)
        step = _chunk_rows(len(pos_sel), nblk_tier)
        if step < len(pos_sel):
            # width-ascending order within the tier: row chunks then
            # get chunk-local nblk buckets (early chunks pad less)
            pos_sel = pos_sel[np.argsort(lb[pos_sel], kind="stable")]
        for c0 in range(0, len(pos_sel), step):
            pos_c = pos_sel[c0:c0 + step]
            rows = light_idx[pos_c]
            lidx, lrows, lpos, lsc = _take_kept(qb, rows, ~heavy_e)
            g = _pack_entries(qb, lidx, lrows, lpos, len(rows),
                              int(lsc.max()) if len(lsc) else 1,
                              idf32, bl_min=16)
            g["pos_in_light"] = pos_c
            g["nblk"] = pow15_bucket(
                max(int(lb[pos_c].max()), nblk_min), minimum=16)
            nh = n_heavy[rows]
            if nh.any():
                bl = g["packed"].shape[0]
                h_pad = next_pow2(max(int(nh.max()), 1))
                hidx, hrows, hpos, _hsc = _take_kept(qb, rows, heavy_e)
                hvy = np.zeros((2, bl, h_pad), dtype=np.int32)
                htids = qb["slot_tids"][qb["qs_slot"][hidx]]
                hvy[0, hrows, hpos] = htids.astype(np.int32)
                hvy[1, hrows, hpos] = qb["qs_w"][hidx].view(np.int32)
                g["hvy"] = hvy
                g["h_pad"] = h_pad
            else:
                g["hvy"] = None
            groups.append(g)
    return {
        "groups": groups,
        "light_idx": light_idx,
        "heavy_idx": heavy_idx,
        "bl": pow15_bucket(len(light_idx), minimum=64),
        "term_split": True,
    }


def partition_sparse_batch_tiered(qb, max_blocks: int,
                                  idf32: np.ndarray, k: int):
    """Tiered packed emission: light rows are grouped into pow-4
    block-count tiers (tier_bounds), one packed table per occupied
    tier, so a single wide query can't inflate every other row's
    candidate strip. Each group's strip is still wide enough for
    top-k (nblk >= ceil(k/128)). Returns None when the packed format
    doesn't apply or no query is light."""
    if not _packed_applies(qb):
        return None
    nblk_q = qb["q_nblk"]
    light = nblk_q <= max_blocks
    if not light.any():
        return None
    light_idx = np.flatnonzero(light)
    heavy_idx = np.flatnonzero(~light)
    nblk_min = -(-k // 128)  # strips must hold at least k candidates
    groups = []
    # first tier includes 0-block rows (every query term absent from
    # this segment): they MUST land in a group — an ungrouped light
    # row would shift every later row in a single-group fast path
    prev = -1
    for bound in tier_bounds(max_blocks):
        sel = (nblk_q[light_idx] > prev) & (nblk_q[light_idx] <= bound)
        prev = bound
        if not sel.any():
            continue
        pos_sel = np.flatnonzero(sel)
        nblk_tier = pow15_bucket(
            max(int(nblk_q[light_idx[pos_sel]].max()), nblk_min),
            minimum=16)
        step = _chunk_rows(len(pos_sel), nblk_tier)
        if step < len(pos_sel):
            pos_sel = pos_sel[np.argsort(
                nblk_q[light_idx[pos_sel]], kind="stable")]
        for c0 in range(0, len(pos_sel), step):
            pos_c = pos_sel[c0:c0 + step]
            rows = light_idx[pos_c]
            g = _emit_packed_rows(qb, rows, idf32, bl_min=16)
            g["pos_in_light"] = pos_c
            g["nblk"] = pow15_bucket(
                max(int(nblk_q[rows].max()), nblk_min), minimum=16)
            groups.append(g)
    return {
        "groups": groups,
        "light_idx": light_idx,
        "heavy_idx": heavy_idx,
        "bl": pow15_bucket(len(light_idx), minimum=64),
    }


# -- device scorers (torch) ---------------------------------------------


def candidate_core(block_docs, block_impacts, bstart, bcnt, w, sent, *,
                   k: int, t_pad: int, nblk: int, log2_run: int,
                   with_counts: bool = False):
    """Strip core over the posting blocks (``ops/sparse.py::
    _candidate_core``; ``t_pad`` is ``bstart.shape[1]``). On CUDA the
    strip is never materialised. Returns (scores [B,k] f32, ids [B,k]
    int32[, counts [B] int32])."""
    del t_pad
    return strip_topk_blocks(block_docs, block_impacts, bstart, bcnt, w,
                             sent, k=k, nblk=nblk, log2_run=log2_run,
                             with_counts=with_counts)


def sparse_candidate_scorer(block_docs, block_impacts, tbl, sent, *,
                            k: int, t_pad: int, nblk: int, log2_run: int,
                            with_counts: bool = False):
    """Explicit-table scorer (``make_sparse_candidate_scorer``): ``tbl``
    [3, B, t_pad] int32 holds block starts, block counts and the f32 slot
    weights bit-cast to int32."""
    w = tbl[2].contiguous().view(torch.float32)
    return candidate_core(block_docs, block_impacts, tbl[0], tbl[1], w,
                          sent, k=k, t_pad=t_pad, nblk=nblk,
                          log2_run=log2_run, with_counts=with_counts)


def decode_packed(tid_tbl, packed, ovr, *, n_ovr: int = 0):
    """(bstart, bcnt, w) [B, t_pad] from the packed upload: ``packed``
    holds ``tid | occ << 26``; block ranges and f32 idf come from the
    segment's ``tid_tbl`` [3, n_terms_pad]; weights are f32(occ) *
    f32(idf), with the host's exact weights scattered over the entries in
    ``ovr`` [2, ov_pad] (flat row*t_pad+col indices, pads at B*t_pad
    dropped) -- bit-identical to the explicit table."""
    tid = (packed & (TID_LIMIT - 1)).long()
    occ = packed >> TID_BITS  # sign bit is clear: logical == arithmetic
    bstart = tid_tbl[0][tid]
    bcnt = torch.where(occ > 0, tid_tbl[1][tid], 0)
    idf = tid_tbl[2].contiguous().view(torch.float32)[tid]
    w = occ.to(torch.float32) * idf
    if n_ovr:
        B, t_pad = packed.shape
        n = B * t_pad
        wf = torch.cat([w.reshape(n), w.new_zeros(1)])  # last slot: dump
        idx = ovr[0].long().clamp(max=n)
        wf[idx] = ovr[1].contiguous().view(torch.float32)
        w = wf[:n].reshape(B, t_pad)
    return bstart, bcnt, w


def sparse_candidate_scorer_packed(block_docs, block_impacts, tid_tbl,
                                   packed, ovr, sent, *, k: int, t_pad: int,
                                   nblk: int, log2_run: int, n_ovr: int = 0,
                                   with_counts: bool = False):
    """Packed-upload scorer (``make_sparse_candidate_scorer_packed``)."""
    bstart, bcnt, w = decode_packed(tid_tbl, packed, ovr, n_ovr=n_ovr)
    return candidate_core(block_docs, block_impacts, bstart, bcnt, w,
                          sent, k=k, t_pad=t_pad, nblk=nblk,
                          log2_run=log2_run, with_counts=with_counts)


def _heavy_meta(hvy_tid, hvy_w, hb_base, hb_log2g, tid_tbl):
    """Per heavy slot: (wh, tbase, lg, blk0, last, ok_h) for the point
    lookups of :func:`_heavy_contrib`, shaped like ``hvy_tid``."""
    tbase = hb_base[hvy_tid]
    lg = hb_log2g[hvy_tid]
    blk0 = tid_tbl[0][hvy_tid]
    nb_t = tid_tbl[1][hvy_tid]
    last = blk0 + torch.clamp(nb_t - 1, min=0)
    ok_h = (hvy_w > 0.0) & (tbase >= 0) & (nb_t > 0)
    return hvy_w, tbase, lg, blk0, last, ok_h


def _heavy_contrib(block_docs, block_impacts, hb_tbl, docs, tbase, lg, blk0,
                   last, ok_h, sentinel_row):
    """One heavy term's impact at each of ``docs`` [R, C] (0 where the
    term does not hold the doc): the lookup table names the block that
    may hold the doc, and the doc is searched in that block and the next
    (two [R, C, 128] gathers, bf16 impacts widened to f32 before the
    sum). The term's fields are [R] per row."""
    n_tbl = hb_tbl.shape[0]
    g = docs >> lg[:, None]  # docs are >= 0: logical == arithmetic
    ent_idx = torch.clamp(
        torch.where(ok_h, tbase, 0)[:, None] + g, max=n_tbl - 1)
    ent = hb_tbl[ent_idx.long()]
    b1 = torch.minimum(torch.maximum(ent, blk0[:, None]), last[:, None])
    b2 = torch.minimum(b1 + 1, last[:, None])
    b2_ok = ok_h[:, None] & (b2 != b1)
    b1 = torch.where(ok_h[:, None], b1, sentinel_row).long()
    b2 = torch.where(b2_ok, b2, sentinel_row).long()
    return (torch.where(block_docs[b1] == docs[..., None],
                        block_impacts[b1].to(torch.float32), 0.0).sum(dim=-1)
            + torch.where(block_docs[b2] == docs[..., None],
                          block_impacts[b2].to(torch.float32),
                          0.0).sum(dim=-1))


def candidate_core_split(block_docs, block_impacts, bstart, bcnt, w, sent,
                         hvy, hb_tbl, hb_base, hb_log2g, tid_tbl, maximp, *,
                         k: int, kp: int, t_pad: int, nblk: int,
                         log2_run: int, h_pad: int, heavy_rows=None):
    """Term-split candidate scoring (``ops/sparse.py::_candidate_core_
    split``): the row's light terms ride the candidate strip and the strip
    core keeps the top-``kp`` tail candidates with the row's match count;
    each heavy (head) term then adds its impact at every candidate by
    point lookup in the segment's heavy lookup table (at most two block
    rows per doc). ``hvy`` [2, B, h_pad] int32 holds the heavy term ids
    and their f32 weights bit-cast (0 = unused slot).

    Returns (scores [B,k], ids [B,k], sound [B] bool). A row is sound --
    its result equals the dense scorer's -- when it has no heavy term, or
    its k-th score beats HUB = sum of w_h * maximp_h and no candidate cut
    at kp can climb back over it. Unsound rows must be re-scored dense.
    The certificate arithmetic follows the JAX order step for step, so
    the flags agree exactly.

    ``heavy_rows`` (int64 row indices, optional) names the rows with a
    heavy weight; only they run the lookups. The others would add
    ``0 * c = +0`` per slot, so the result is the same bit for bit."""
    sentinel_row = sent[0]
    B = bstart.shape[0]
    kp = min(kp, nblk * 128)
    tv, td, n_cand = candidate_core(
        block_docs, block_impacts, bstart, bcnt, w, sent, k=kp, t_pad=t_pad,
        nblk=nblk, log2_run=log2_run, with_counts=True)
    real = tv > float("-inf")
    hvy_tid = hvy[0].long()
    hvy_w = hvy[1].contiguous().view(torch.float32)
    hub = torch.zeros((B,), dtype=torch.float32, device=tv.device)
    slot_meta = []
    for h in range(h_pad):
        tid = hvy_tid[:, h]
        meta = _heavy_meta(tid, hvy_w[:, h], hb_base, hb_log2g, tid_tbl)
        slot_meta.append(meta)
        wh, ok_h = meta[0], meta[5]
        hub = hub + torch.where(ok_h, wh * maximp[tid], 0.0)

    heavy_sum = torch.zeros_like(tv)
    td_h = td
    if heavy_rows is not None:
        td_h = td[heavy_rows]
        slot_meta = [tuple(x[heavy_rows] for x in meta)
                     for meta in slot_meta]
    # the lookups gather [Bh, chunk, 128] block rows: chunk the candidate
    # axis so temporaries stay bounded at deep kp windows
    chunk = max(128, min(512, (1 << 26) // max(td_h.shape[0] * 128, 1)))
    for c0 in range(0, kp, chunk):
        td_c = td_h[:, c0:c0 + chunk]
        hs = torch.zeros(td_c.shape, dtype=torch.float32, device=tv.device)
        for wh, tbase, lg, blk0, last, ok_h in slot_meta:
            c = _heavy_contrib(block_docs, block_impacts, hb_tbl, td_c,
                               tbase, lg, blk0, last, ok_h, sentinel_row)
            hs = hs + wh[:, None] * c
        if heavy_rows is None:
            heavy_sum[:, c0:c0 + chunk] = hs
        else:
            heavy_sum[heavy_rows, c0:c0 + chunk] = hs
    final = torch.where(real, tv + heavy_sum, float("-inf"))
    # (score desc, doc asc) over the kp window: a stable doc-ascending
    # sort, then a stable score-descending one
    _, od = torch.sort(td, dim=1, stable=True)
    f1 = torch.gather(final, 1, od)
    d1s = torch.gather(td, 1, od)
    _, osc = torch.sort(-f1, dim=1, stable=True)
    fs = torch.gather(f1, 1, osc)[:, :k]
    ds = torch.gather(d1s, 1, osc)[:, :k]
    nreal = (fs > float("-inf")).sum(dim=1)
    theta = torch.where(nreal >= k, fs[:, k - 1], float("-inf"))
    tail_k = tv[:, kp - 1]
    excluded = n_cand > kp
    sound = (hub <= 0.0) | ((theta > hub)
                            & (~excluded | (tail_k + hub < theta)))
    return fs, ds, sound


def sparse_candidate_scorer_split(block_docs, block_impacts, tid_tbl,
                                  hb_tbl, hb_base, hb_log2g, maximp, packed,
                                  ovr, hvy, sent, *, k: int, kp: int,
                                  t_pad: int, nblk: int, log2_run: int,
                                  h_pad: int, n_ovr: int = 0,
                                  heavy_rows=None):
    """Term-split variant of the packed scorer
    (``make_sparse_candidate_scorer_split``): the packed light table and
    override COO as the packed scorer, plus the [2, B, h_pad] heavy
    table (and optionally the rows that use it, see
    :func:`candidate_core_split`). Returns (scores [B,k], ids [B,k],
    sound [B] bool)."""
    bstart, bcnt, w = decode_packed(tid_tbl, packed, ovr, n_ovr=n_ovr)
    return candidate_core_split(
        block_docs, block_impacts, bstart, bcnt, w, sent, hvy, hb_tbl,
        hb_base, hb_log2g, tid_tbl, maximp, k=k, kp=kp, t_pad=t_pad,
        nblk=nblk, log2_run=log2_run, h_pad=h_pad, heavy_rows=heavy_rows)


def group_gather_sound(group_s, group_i, group_f, posmaps, *, bl: int):
    """:func:`group_gather` that also scatters each group's per-row
    soundness flags (``make_group_gather_sound``); plain groups pass
    all-True flags, and rows no group maps stay True."""
    s, i = group_gather(group_s, group_i, posmaps, bl=bl)
    f = torch.ones((bl + 1,), dtype=torch.bool, device=s.device)
    off = 0
    for gf in group_f:
        m = posmaps[off:off + gf.shape[0]].long().clamp(max=bl)
        f[m] = gf
        off += gf.shape[0]
    return s, i, f[:bl]


def group_gather(group_s, group_i, posmaps, *, bl: int):
    """Scatter the tier groups' (scores, ids) into light-row order
    (``make_group_gather``): ``posmaps`` concatenates each group's row
    positions; pads carry ``bl`` and are dropped."""
    k = group_s[0].shape[1]
    dev = group_s[0].device
    s = torch.full((bl + 1, k), float("-inf"), dtype=group_s[0].dtype,
                   device=dev)
    i = torch.zeros((bl + 1, k), dtype=group_i[0].dtype, device=dev)
    off = 0
    for gs, gi in zip(group_s, group_i):
        m = posmaps[off:off + gs.shape[0]].long().clamp(max=bl)
        s[m] = gs
        i[m] = gi
        off += gs.shape[0]
    return s[:bl], i[:bl]


def row_combine(light_s, light_i, heavy_s, heavy_i, maps, *, n_rows: int):
    """Scatter two row groups' (scores, ids) back into batch order
    (``make_row_combiner``). ``maps`` [Bl + Bh] holds both row maps; pad
    rows carry ``n_rows`` and are dropped."""
    light_map = maps[:light_s.shape[0]].long().clamp(max=n_rows)
    heavy_map = maps[light_s.shape[0]:].long().clamp(max=n_rows)
    k = light_s.shape[1]
    s = torch.full((n_rows + 1, k), float("-inf"), dtype=light_s.dtype,
                   device=light_s.device)
    i = torch.zeros((n_rows + 1, k), dtype=light_i.dtype,
                    device=light_s.device)
    s[light_map] = light_s
    i[light_map] = light_i
    s[heavy_map] = heavy_s.to(light_s.dtype)
    i[heavy_map] = heavy_i.to(light_i.dtype)
    return s[:n_rows], i[:n_rows]


def sparse_single_split_scorer(block_docs, block_impacts, hb_tbl, hb_base,
                               hb_log2g, tid_tbl, maximp, tbl, hvy, sent, *,
                               k: int, t_pad: int, nblk: int, log2_run: int):
    """Single-query term split (``make_sparse_single_split_scorer``): the
    query's light terms ride one candidate strip, ``tbl`` [3, 1, t_pad]
    (block starts, block counts, f32 weights bit-cast); up to ``h_pad``
    heavy terms, ``hvy`` [2, h_pad] (term ids, f32 weights bit-cast; 0 =
    unused), add their impacts by point lookup at EVERY strip doc. So
    soundness needs only theta > HUB = sum of w_h * maximp_h: a doc off
    the strip matches heavy terms alone.

    The strip kernel returns every kept strip doc with its light score
    and the count (:func:`strip_lanes_blocks`: its tile pass, no row
    merge); the strip is never gathered on the card. The heavy lookups and
    the final (score desc, doc asc) top-k are torch ops.
    Returns (scores [1,k], ids [1,k], n_strip [1] int32, overlap [h_pad]
    int32, sound [1] bool): ``overlap[h]`` counts the strip docs heavy
    term h also holds (the caller's count arithmetic)."""
    del t_pad
    sentinel_row = sent[0]
    bstart, bcnt = tbl[0], tbl[1]
    w = tbl[2].contiguous().view(torch.float32)
    tv, td, n_strip = strip_lanes_blocks(
        block_docs, block_impacts, bstart, bcnt, w, sent, nblk=nblk,
        log2_run=log2_run)
    width = tv.shape[1]
    real = tv[0] > float("-inf")                                  # [L]
    docs = torch.where(real, td[0], sent[1])   # -inf lanes: the dead slot
    hvy_tid = hvy[0].long()
    wh, tbase, lg, blk0, last, ok_h = _heavy_meta(
        hvy_tid, hvy[1].contiguous().view(torch.float32), hb_base,
        hb_log2g, tid_tbl)
    h_pad = hvy_tid.shape[0]
    # every heavy term at once, [h_pad, chunk, 128] gathers: chunks bound
    # the temporaries at wide strips (at most 2^17 lookups a chunk)
    chunk = max(32768, (1 << 17) // h_pad)
    parts = []
    for c0 in range(0, width, chunk):
        dc = docs[None, c0:c0 + chunk].expand(h_pad, -1)
        parts.append(wh[:, None] * _heavy_contrib(
            block_docs, block_impacts, hb_tbl, dc, tbase, lg, blk0, last,
            ok_h, sentinel_row))
    hv = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    overlap = (real[None, :] & (hv > 0.0)).sum(dim=1, dtype=torch.int32)
    score = torch.where(real, tv[0] + hv.sum(dim=0), float("-inf"))
    # (score desc, doc asc): a stable doc-ascending sort, then a stable
    # score-descending one
    d_sorted, od = torch.sort(docs, stable=True)
    s_sorted = score[od]
    _, osc = torch.sort(-s_sorted, stable=True)
    ts = s_sorted[osc[:k]][None, :]
    ids = d_sorted[osc[:k]][None, :]
    hub = torch.where(ok_h, wh * maximp[hvy_tid], 0.0).sum()
    nreal = (ts > float("-inf")).sum(dim=1)
    theta = torch.where(nreal >= k, ts[:, k - 1], float("-inf"))
    sound = (hub <= 0.0) | (theta > hub)
    return ts, ids, n_strip, overlap, sound
