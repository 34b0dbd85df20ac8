"""Dense impact scorers in PyTorch: BM25 as ``W @ M`` over the doc axis.

The device half of ``searchlite_tpu/ops/impact.py`` that the batched
reader runs under its dense-M memory budget. A batch's distinct terms
become rows of ``M [S, n1]`` (one row gather of their 128-wide posting
blocks and one unique-index scatter), its per-query weights a dense
``W [Q, S]``, and the fused score + mask + top-k
(:mod:`searchlite_tpu_torch.ops.fused_topk`, a hand-written Hopper kernel
on CUDA tensors) finishes each row. The split scorer adds a second
operand pair: the segment-resident dense rows of the highest-df terms
(``DeviceSegment.dense_rows``), so head terms skip the scatter.

The host tables (``ensure_dense_tables``, ``split_impact_batch``,
``build_block_tables``, ``subset_impact_batch``) are numpy and are
imported from the JAX package, not copied. Impacts stay f32 throughout.
"""

from __future__ import annotations

import torch

from searchlite_tpu_torch.ops.fused_topk import fused_topk


def build_m_from_blocks(block_docs, block_impacts, blk_idx, slot_row,
                        n1: int, s_count: int):
    """M [s_count, n1] f32 from the 128-wide block layout
    (``ops/impact.py::build_m_from_blocks``): ``blk_idx`` [nb] names the
    gathered block rows, ``slot_row`` [nb] their owning slots. Pad docs
    (``n1-1``) scatter to unique places in a dump zone past
    ``s_count*n1``, so every index is unique and the scatter is
    deterministic."""
    nb = blk_idx.shape[0]
    dev = block_docs.device
    idx = blk_idx.long()
    docs2d = block_docs[idx]                                   # [nb, 128]
    imps2d = block_impacts[idx].to(torch.float32)
    pos = torch.arange(nb * 128, dtype=torch.int64,
                       device=dev).reshape(nb, 128)
    flat_idx = torch.where(docs2d == n1 - 1, s_count * n1 + pos,
                           slot_row.long()[:, None] * n1 + docs2d.long())
    m_flat = torch.zeros(s_count * n1 + nb * 128, dtype=torch.float32,
                         device=dev)
    m_flat[flat_idx.reshape(-1)] = imps2d.reshape(-1)
    return m_flat[:s_count * n1].reshape(s_count, n1)


def densify_w(w_idx, w_val, n_queries: int, s_count: int):
    """W [n_queries, s_count] f32 from the sorted unique COO (``w_idx`` =
    q*S + s; pads point past ``n_queries*s_count``) -- ``_densify_w``."""
    w_flat = torch.zeros(n_queries * s_count + w_idx.shape[0],
                         dtype=torch.float32, device=w_val.device)
    w_flat[w_idx.long()] = w_val
    return w_flat[:n_queries * s_count].reshape(n_queries, s_count)


def impact_scorer(block_docs, block_impacts, deleted, blk_idx, slot_row,
                  w_idx, w_val, filter_rows=None, fidx=None, *, k: int,
                  s_pad: int, n_queries: int):
    """The plain block scorer (``make_impact_scorer`` + ``_score_m``):
    M from the batch's blocks, W from its COO weights, then the fused
    tail. ``filter_rows`` [F+1, n1] bool and ``fidx`` [Q] int32 apply
    per-query filters (row 0 matches all). Returns (scores [Q,k] f32,
    ids [Q,k] int32)."""
    m = build_m_from_blocks(block_docs, block_impacts, blk_idx, slot_row,
                            deleted.shape[0], s_pad)
    w = densify_w(w_idx, w_val, n_queries, s_pad)
    return fused_topk(w, m, deleted, k=k, filter_rows=filter_rows,
                      fidx=fidx)


def split_impact_scorer(block_docs, block_impacts, m_dense, deleted, packed,
                        filter_rows=None, fidx=None, *, k: int, s_pad: int,
                        n_queries: int, nb_pad: int, wd_pad: int,
                        ws_pad: int):
    """The dense/sparse split scorer (``make_split_impact_scorer``):
    ``Wd @ m_dense + Ws @ M_sparse``, masks, top-k. ``packed`` is the ONE
    int32 per-batch upload of ``split_impact_batch``: block rows, their
    slots, then the dense and sparse weight COOs with f32 values
    bit-cast. The resident ``m_dense [R+1, n1]`` is read in place, never
    copied or concatenated with the batch's M."""
    o = 0

    def take(n):
        nonlocal o
        out = packed[o:o + n]
        o += n
        return out

    blk_idx = take(nb_pad)
    slot_row = take(nb_pad)
    wd_idx = take(wd_pad)
    wd_val = take(wd_pad).view(torch.float32)
    ws_idx = take(ws_pad)
    ws_val = take(ws_pad).view(torch.float32)
    n1 = deleted.shape[0]
    m_sparse = build_m_from_blocks(block_docs, block_impacts, blk_idx,
                                   slot_row, n1, s_pad)
    wd = densify_w(wd_idx, wd_val, n_queries, m_dense.shape[0])
    ws = densify_w(ws_idx, ws_val, n_queries, s_pad)
    return fused_topk(wd, m_dense, deleted, k=k, w2=ws, m2=m_sparse,
                      filter_rows=filter_rows, fidx=fidx)
