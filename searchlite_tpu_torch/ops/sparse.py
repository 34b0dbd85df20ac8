"""Batched sparse candidate scoring in PyTorch: top-k over each query's
own posting blocks.

The device half of ``searchlite_tpu/ops/sparse.py``. Per query row, the
posting blocks of its terms form a ``[B, nblk*128]`` candidate strip of
(doc, impact x weight); the strip core
(:func:`searchlite_tpu_torch.ops.strip_topk.strip_topk_blocks`) sums
duplicate docs and takes the top-k. On CUDA tensors the strip is never
materialised: the hand-written Hopper kernel reads the posting blocks in
place and searches the terms' pre-sorted doc runs. On CPU tensors the
plain version gathers the strip (:func:`strip_gather`) and sorts it. The
host partitions that build the per-batch tables
(``partition_sparse_batch_tiered``, ``partition_sparse_batch``,
``subset_impact_batch``) are numpy and are imported from the JAX package,
not copied.

Sentinels follow the reference: ``sent`` is the segment's ``[2]`` int32
tensor (sentinel block row, dead doc slot ``n1-1``), read on device so
no call waits for the host.
"""

from __future__ import annotations

import torch

from searchlite_tpu.ops.sparse import TID_BITS, TID_LIMIT
from searchlite_tpu_torch.ops.strip_topk import (  # noqa: F401
    strip_gather,
    strip_topk_blocks,
)


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
    n_tbl = hb_tbl.shape[0]
    slot_meta = []
    for h in range(h_pad):
        tid = hvy_tid[:, h]
        wh = hvy_w[:, h]
        tbase = hb_base[tid]
        lg = hb_log2g[tid]
        blk0 = tid_tbl[0][tid]
        nb_t = tid_tbl[1][tid]
        last = blk0 + torch.clamp(nb_t - 1, min=0)
        ok_h = (wh > 0.0) & (tbase >= 0) & (nb_t > 0)
        slot_meta.append((wh, tbase, lg, blk0, last, ok_h))
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
            g = td_c >> lg[:, None]  # docs are >= 0: logical == arithmetic
            ent_idx = torch.clamp(
                torch.where(ok_h, tbase, 0)[:, None] + g, max=n_tbl - 1)
            ent = hb_tbl[ent_idx.long()]
            b1 = torch.minimum(torch.maximum(ent, blk0[:, None]),
                               last[:, None])
            b2 = torch.minimum(b1 + 1, last[:, None])
            b2_ok = ok_h[:, None] & (b2 != b1)
            b1 = torch.where(ok_h[:, None], b1, sentinel_row).long()
            b2 = torch.where(b2_ok, b2, sentinel_row).long()
            c = (torch.where(block_docs[b1] == td_c[..., None],
                             block_impacts[b1], 0.0).sum(dim=-1)
                 + torch.where(block_docs[b2] == td_c[..., None],
                               block_impacts[b2], 0.0).sum(dim=-1))
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
