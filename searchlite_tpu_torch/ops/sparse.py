"""Batched sparse candidate scoring in PyTorch: top-k over each query's
own gathered posting blocks.

The device half of ``searchlite_tpu/ops/sparse.py``. Per query row, the
posting blocks of its terms are gathered into a ``[B, nblk*128]``
candidate strip of (doc, impact x weight); the strip core
(:mod:`searchlite_tpu_torch.ops.strip_topk`, a hand-written Hopper kernel
on CUDA tensors) sorts it by doc, sums duplicate-doc runs and takes the
top-k. The host partitions that build the per-batch tables
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
from searchlite_tpu_torch.ops.strip_topk import strip_topk


def strip_gather(block_docs, block_impacts, bstart, bcnt, w, sentinel_row,
                 *, t_pad: int, nblk: int):
    """Gather each row's posting blocks into an UNSORTED candidate strip
    (``ops/sparse.py::_strip_gather``). ``bstart``/``bcnt`` [B, t_pad]
    int32 are per-slot block starts and counts (0 for unused slots), ``w``
    [B, t_pad] f32 the slot weights. Returns (d int32, v f32), both
    [B, nblk*128]."""
    B = bstart.shape[0]
    dev = bstart.device
    cum = torch.cumsum(bcnt, dim=1, dtype=torch.int32)         # [B, T]
    total = cum[:, -1]
    pos = torch.arange(nblk, dtype=torch.int32, device=dev)
    # owning term slot per gathered block: #{t : cum[t] <= pos}
    t_of = (pos[None, None, :] >= cum[:, :, None]).sum(
        dim=1, dtype=torch.int32)                              # [B, nblk]
    valid = pos[None, :] < total[:, None]
    t_safe = t_of.clamp(max=t_pad - 1).long()
    begin = cum - bcnt
    blk = (torch.gather(bstart, 1, t_safe)
           + (pos[None, :] - torch.gather(begin, 1, t_safe)))
    blk_idx = torch.where(valid, blk, sentinel_row).long()
    w_blk = torch.gather(w, 1, t_safe)
    d = block_docs[blk_idx].reshape(B, nblk * 128)
    v = (block_impacts[blk_idx] * w_blk[:, :, None]).reshape(B, nblk * 128)
    return d, v


def candidate_core(block_docs, block_impacts, bstart, bcnt, w, sent, *,
                   k: int, t_pad: int, nblk: int, log2_run: int,
                   with_counts: bool = False):
    """Gather + strip core (``ops/sparse.py::_candidate_core``). Returns
    (scores [B,k] f32, ids [B,k] int32[, counts [B] int32])."""
    d, v = strip_gather(block_docs, block_impacts, bstart, bcnt, w,
                        sent[0], t_pad=t_pad, nblk=nblk)
    return strip_topk(d, v, sent[1:2], k=k, log2_run=log2_run,
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
