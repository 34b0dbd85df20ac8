"""Chip smoke test of the PyTorch/CUDA port (searchlite_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

1. Finds the card (prints ``nvidia-smi`` name and power limit); exits
   non-zero when ``torch.cuda.is_available()`` is false.
2. Builds every CUDA kernel of the batched BM25 path from ``csrc/``, one
   nvcc per source, all started together.
3. Holds each kernel against its plain PyTorch version on the card at the
   shapes the path gives it, and prints both times beside the kernel's
   bound (the bytes it must move at 3.35 TB/s against its operations at
   67 TFLOP/s) and, for the fused kernel, one ``torch.matmul`` of the
   score part: the strip kernel (read in place from posting blocks)
   bit-identical on finite entries, ids and match counts equal, over
   seeded block tables of a synthetic segment at n1 = 131,072 (Zipf
   posting lists, 5% of docs deleted) at the widths the strips produce,
   rows of 8 and 16 term slots, the term-split widths at k = kp, and
   4 x 524,288 lanes over a segment at n1 = 2^20; its all-lanes pass
   (every kept doc of a row, no top-k) at the single-query split widths,
   the same (doc, score) set bit for bit; the fused score + mask +
   top-k kernel within rtol 1e-6 / atol 1e-4 per score, the same finite
   count and the same top-k set except near-ties, at the dense scorers'
   shapes (filtered, k = 2,000) and one of the Pallas kernel's own.
4. Drives the port's main paths on ``bench.py``'s 100k-doc Zipf corpus,
   ingested through the port's own ``Index`` and writer (one commit, plus
   a numeric fast field ``bucket = i % 16``), through ``index.reader()``
   (the port's ``IndexReader``, on the card), each with the launch counts
   set to 0 just before it and read just after:
   a. the oversized-budget stream: ``search_batch_many`` over three
      1024-query batches (coalesced into one launch set) with
      ``output="arrays"``, and one ``search_batch`` in pairs form: the
      strip kernel only, no dense or term-split row;
   b. the under-budget route: a 256-query ``search_batch`` (strips, term
      split, dense remainder), the same 256 queries with per-query
      filters (all dense), and a 32-query batch with ``limit=2000``
      (dense); prints the rows each route scored.
   c. single-query ``search()``: bench.py's 9 single queries as default
      requests (warmed, then timed once each; the dense compiled
      executor), a structured set (bool with must / must_not and a
      ``bucket`` filter, a phrase, a function_score over ``bucket``, a
      field sort drained through ``search_scroll``), and the sparse
      single routes with ``SEARCHLITE_SINGLE_SPARSE_MIN_DOCS=0``: 64 of
      bench.py's queries plus 16 holding one or two of the head terms
      ``tok0``-``tok3`` (past the 512-block term cap: the term split,
      whose strip pass returns every kept doc, ``strip_lanes_blocks``);
      prints the p50s, the segments and strip launches per route.
   d. pruned execution (``ops/tiles.py``), at the default tile width
      (T = 512, 256 tiles): the 9 single queries and the structured
      set's filter / must_not requests with ``execution`` wand and bmw
      and ``SEARCHLITE_PRUNE_MIN_POSTINGS=0`` (every segment defers to
      the doc-tile pruned jobs: ``pruning_simulated`` false, postings
      advanced <= the dense route's), once more at the default threshold;
      the same singles with ``SEARCHLITE_M_BUDGET_BYTES`` cut to a
      quarter of their dense M (the chunked executor, a cursor page
      too); the b1024 x3 stream with ``execution="wand"`` (the per-query
      path: light rows on the strip kernel), 64 head-term queries (tile
      waves), one filtered b256 batch (the union path, ending in the
      fused kernel) and one ``SEARCHLITE_BATCH_PRUNE=union`` batch, the
      fused kernel then held against its plain version on each union
      wave's own operands (one W, M [s_pad, n_sel * T], filter rows in
      tile space; a partial 1,024-doc chunk where n_sel is odd, else the
      first wave again less one tile);
      prints wand and bm25 QPS, pruned, dense and chunked p50s, tiles
      scored and waves per query.
   Every result is checked against ``bench.py``'s f64 oracle under
   ``SEARCHLITE_PRECISION=f32_strict`` (masked by the port's filter where
   there is one; result counts too; the structured set against oracles
   with host-computed masks), and every path must launch its kernels,
   never run a plain version and never gather a strip on the card.

Prints one JSON line of per-kernel results before the last line, and as
the last line ``{"ok": true, "device": {...}}``. Any failure exits
non-zero without that line. Never imports JAX or ``searchlite_tpu`` (both
are blocked in ``sys.modules``).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

# the port must run without JAX and without the JAX package: fail loudly
sys.modules["jax"] = None
sys.modules["searchlite_tpu"] = None

# widths [rows, lanes] the headline stream gives the strip kernel: one
# coalesced 3,072-query launch set at 100k docs (tiers of 16/32/128/512
# blocks), then full strips and non-power-of-2 widths; 4 x 524,288 is the
# width full strips of a 1M-doc corpus reach
STREAM_SHAPES = [(1536, 2048), (1536, 4096), (256, 16384), (48, 65536)]
EXTRA_SHAPES = [(64, 3072), (16, 49152), (4, 131072)]
WIDE_SHAPE = (4, 524288)
# the term-split scorer's strips: (rows, lanes, k = kp). Under the budget
# a strip holds <= 32 blocks and kp clamps to its width; kp reaches 8,192
SPLIT_SHAPES = [(16, 4096, 4096), (16, 2048, 2048), (4, 16384, 8192)]
# rows of 8 and 16 term slots (log2_run 3 and 4)
T_PAD_SHAPES = [(64, 8192, 8), (32, 4096, 16)]
# the single-query term split reads every kept doc of one row's strip (a
# light strip of up to 512 blocks, bucketed): [rows, lanes]
LANES_SHAPES = [(1, 24576), (1, 65536)]
K = 10
N1 = 131072  # the 100k-doc corpus' padded doc axis
N1_1M = 1 << 20  # a 1M-doc corpus' padded doc axis
# the fused kernel at the dense scorers' shapes on that corpus:
# (name, Q, dense rows R+1, sparse slots S, N, k, filter rows)
FUSED_SHAPES = [
    ("b256 split scorer", 256, 2990, 768, N1, K, 0),
    ("b256 filtered", 256, 2990, 768, N1, K, 4),
    ("b32 k=2000", 32, 2990, 768, N1, 2000, 0),
    ("pallas family", 128, 64, 0, 1024, K, 0),
]
RTOL, ATOL = 1e-6, 1e-4  # bench.py's f32_strict gate
# an H100 SXM's published peaks: HBM bytes/s, f32 FLOP/s outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# per-query filters of the filtered batch, over bucket = i % 16
FILTERS = [None,
           {"I64Range": {"field": "bucket", "min": 0, "max": 7}},
           {"I64Range": {"field": "bucket", "min": 3, "max": 3}},
           {"I64Range": {"field": "bucket", "min": 20, "max": 30}}]


def log(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return res.stdout.strip().splitlines()[0] if res.stdout.strip() \
            else f"nvidia-smi failed: {res.stderr.strip()}"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def make_segment(rng, n1: int, n_terms: int, max_len: int):
    """A seeded segment's block layout: ``n_terms`` posting lists of Zipf
    lengths (rank r draws max_len / r docs, duplicates dropped) plus four
    1-5 doc lists, each doc-ascending, cut into 128-lane block rows with
    the sentinel ``n1-1`` padding each list's last row; a trailing
    all-sentinel row. 5% of docs are deleted (impact 0). Returns
    (block_docs, block_impacts, term_start, term_blocks)."""
    sent = n1 - 1
    lens = [max(1, max_len // r) for r in range(1, n_terms + 1)]
    lens += [int(x) for x in rng.integers(1, 6, size=4)]
    deleted = rng.random(n1) < 0.05
    docs_all, imps_all, starts, blocks = [], [], [], []
    row = 0
    for n in lens:
        docs = np.unique(rng.integers(0, n1 - 1, size=n)).astype(np.int32)
        nb = -(-len(docs) // 128)
        bd = np.full(nb * 128, sent, dtype=np.int32)
        bi = np.zeros(nb * 128, dtype=np.float32)
        bd[:len(docs)] = docs
        bi[:len(docs)] = np.where(
            deleted[docs], 0.0,
            rng.random(len(docs), dtype=np.float32) * 2 + 0.1)
        docs_all.append(bd)
        imps_all.append(bi)
        starts.append(row)
        blocks.append(nb)
        row += nb
    docs_all.append(np.full(128, sent, dtype=np.int32))
    imps_all.append(np.zeros(128, dtype=np.float32))
    return (np.concatenate(docs_all).reshape(-1, 128),
            np.concatenate(imps_all).reshape(-1, 128),
            np.asarray(starts), np.asarray(blocks))


def make_rows(rng, seg, B: int, t_pad: int, nblk: int, n_big: int = 1):
    """Per-row slot tables (bstart, bcnt, w) over distinct terms whose
    blocks fit the ``nblk``-block strip, shaped like queries: ``n_big``
    large terms (an eighth to half the width, else the largest that fit)
    then random ones (mostly rare: Zipf), in random slot order. With 8
    rows or more, row 0 has no term (all sentinel) and row 1 one 1-5 doc
    term (fewer matches than k)."""
    _, _, term_start, term_blocks = seg
    n_terms = len(term_start)
    bstart = np.zeros((B, t_pad), dtype=np.int32)
    bcnt = np.zeros((B, t_pad), dtype=np.int32)
    w = np.zeros((B, t_pad), dtype=np.float32)
    big = np.flatnonzero((term_blocks > nblk // 8)
                         & (term_blocks <= nblk // 2))
    if not len(big):
        fit = np.flatnonzero(term_blocks <= nblk // max(n_big, 1))
        big = fit[np.argsort(-term_blocks[fit])][:8]
    special = B >= 8  # rows 0 and 1 as above; small shapes skip them
    for b in range(1 if special else 0, B):
        if special and b == 1:
            chosen = [n_terms - 1]
        else:
            used = int(rng.integers(max(1, t_pad // 2), t_pad + 1))
            chosen = []
            room = nblk
            for tid in rng.permutation(big):
                if len(chosen) >= min(n_big, used):
                    break
                if term_blocks[tid] <= room:
                    chosen.append(int(tid))
                    room -= int(term_blocks[tid])
            for tid in rng.integers(0, n_terms, size=64):
                if len(chosen) >= used:
                    break
                if int(tid) not in chosen and term_blocks[tid] <= room:
                    chosen.append(int(tid))
                    room -= int(term_blocks[tid])
            chosen = [chosen[i] for i in rng.permutation(len(chosen))]
        for j, tid in enumerate(chosen):
            bstart[b, j] = term_start[tid]
            bcnt[b, j] = term_blocks[tid]
            w[b, j] = rng.uniform(0.5, 5.0)
    return bstart, bcnt, w


def max_slots_per_doc(seg, bstart, bcnt, n1: int) -> int:
    """The most slots of one row that hold the same live doc."""
    docs = seg[0]
    best = 0
    for b in range(bstart.shape[0]):
        parts = [docs[bstart[b, j]:bstart[b, j] + bcnt[b, j]].ravel()
                 for j in range(bstart.shape[1]) if bcnt[b, j]]
        if parts:
            d = np.concatenate(parts)
            d = d[d != n1 - 1]
            if len(d):
                best = max(best, int(np.bincount(d).max()))
    return best


def time_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def time_pair(kernel, plain, iters: int):
    """(kernel ms, plain ms): each the mean of two timings, in turns
    plain, kernel, kernel, plain."""
    p1 = time_ms(plain, iters)
    k1 = time_ms(kernel, iters)
    k2 = time_ms(kernel, iters)
    p2 = time_ms(plain, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound_ms(ops: int, nbytes: int) -> tuple[float, str]:
    """The least time the card could take: the bytes over the HBM rate
    against the operations over the f32 rate, the larger of the two."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def strip_work(bstart, bcnt, k: int):
    """(operations, bytes) of one strip launch on these tables: every
    block row some row reads (doc and impact, 1 KiB) once, the tables, the
    output keys; a multiply and an add per live lane."""
    rows = set()
    for b in range(bstart.shape[0]):
        for j in range(bstart.shape[1]):
            rows.update(range(int(bstart[b, j]),
                              int(bstart[b, j]) + int(bcnt[b, j])))
    lanes = int(bcnt.sum()) * 128
    nbytes = len(rows) * 128 * 8 + bstart.size * 12 + bstart.shape[0] * k * 8
    return 2 * lanes, nbytes


def fused_work(w1, m1, deleted, k: int, w2=None, m2=None, filter_rows=None,
               fidx=None):
    """(operations, bytes) of one fused call on these inputs: an FMA per
    nonzero weight and doc of every query some doc can match (a query
    whose filter matches no live doc needs none); every M row such a query
    weights read once, the weights, the deletion mask, the filter rows the
    queries name, the output written once."""
    import torch

    n = m1.shape[1]
    live = torch.ones(w1.shape[0], dtype=torch.bool, device=w1.device)
    if filter_rows is not None:
        live = (filter_rows[fidx.long()] & ~deleted[None, :]).any(dim=1)
    ops = 0
    nbytes = n + w1.shape[0] * k * 8
    for w in (w1, w2):
        if w is None:
            continue
        nz = (w != 0) & live[:, None]
        ops += 2 * int(nz.sum()) * n
        nbytes += w.numel() * 4 + int(nz.any(dim=0).sum()) * n * 4
    if filter_rows is not None:
        nbytes += fidx.numel() * 4 + int(torch.unique(fidx).numel()) * n
    return ops, nbytes


def check_strip_kernel(seg, n1: int, shapes, k: int = K, t_pad: int = 4,
                       seed: int = 5, n_big: int = 1):
    """The strip kernel vs its plain version on the card, per (rows,
    lanes[, k]) shape over seeded block tables of ``seg``. Returns a list
    of per-shape dicts; raises on any disagreement."""
    import torch

    from searchlite_tpu_torch.ops.strip_topk import (
        strip_topk_blocks,
        strip_topk_blocks_plain,
    )

    rng = np.random.default_rng(seed)
    log2_run = max((t_pad - 1).bit_length(), 1)
    block_docs = torch.from_numpy(seg[0]).cuda()
    block_imps = torch.from_numpy(seg[1]).cuda()
    sent = torch.tensor([seg[0].shape[0] - 1, n1 - 1], dtype=torch.int32,
                        device="cuda")
    rows = []
    for B, L, *kk in shapes:
        kk = kk[0] if kk else k
        nblk = L // 128
        bstart_np, bcnt_np, w_np = make_rows(rng, seg, B, t_pad, nblk, n_big)
        multi = max_slots_per_doc(seg, bstart_np, bcnt_np, n1)
        args = (block_docs, block_imps, torch.from_numpy(bstart_np).cuda(),
                torch.from_numpy(bcnt_np).cuda(),
                torch.from_numpy(w_np).cuda(), sent)
        kw = dict(k=kk, nblk=nblk, log2_run=log2_run)
        ts, td, cnt = strip_topk_blocks(*args, with_counts=True, **kw)
        ps, pd, pc = strip_topk_blocks_plain(*args, **kw)
        torch.cuda.synchronize()
        ts, td, cnt = ts.cpu().numpy(), td.cpu().numpy(), cnt.cpu().numpy()
        ps, pd, pc = ps.cpu().numpy(), pd.cpu().numpy(), pc.cpu().numpy()
        name = f"[{B}, {L}] t_pad={t_pad} k={kk}"
        fin = np.isfinite(ps)
        if not np.array_equal(np.isfinite(ts), fin):
            raise AssertionError(f"{name}: finite entries differ")
        if not np.array_equal(ts[fin].view(np.int32),
                              ps[fin].view(np.int32)):
            raise AssertionError(f"{name}: scores not bit-identical")
        if not np.array_equal(td[fin], pd[fin]):
            raise AssertionError(f"{name}: ids differ")
        if not np.array_equal(cnt, pc):
            raise AssertionError(f"{name}: match counts differ")
        if B >= 8 and not (cnt[0] == 0 and np.isinf(ts[0]).all()):
            raise AssertionError(f"{name}: all-sentinel row matched")
        if B >= 8 and not (cnt[1] < kk and np.isinf(ts[1, cnt[1]:]).all()):
            raise AssertionError(f"{name}: the short row is not short")
        iters = 20 if B * L <= 8 << 20 else 5
        t_kern, t_plain = time_pair(
            lambda: strip_topk_blocks(*args, **kw),
            lambda: strip_topk_blocks_plain(*args, **kw), iters)
        bms, by = bound_ms(*strip_work(bstart_np, bcnt_np, kk))
        row = {"rows": B, "lanes": L, "k": kk, "t_pad": t_pad,
               "multi": multi, "bound_ms": bms, "bound_by": by,
               "max_abs_err": float(np.abs(ts[fin] - ps[fin]).max())
               if fin.any() else 0.0,
               "finite": int(fin.sum()), "ms": t_kern, "plain_ms": t_plain}
        log(f"strip_topk {name}: bit-identical ({row['finite']} finite "
            f"entries, counts equal, a doc in up to {multi} slots); kernel "
            f"{t_kern:.4f} ms, plain {t_plain:.4f} ms, bound {bms:.4f} ms "
            f"({by})")
        rows.append(row)
        del args
    return rows


def check_lanes_kernel(seg, n1: int, shapes, seed: int = 12):
    """The strip kernel's all-lanes pass (``strip_lanes_blocks``) vs its
    plain version on the card: the same kept (doc, score) set bit for
    bit and the same counts, per [rows, lanes] shape over seeded block
    tables of ``seg``. Returns per-shape dicts; raises on disagreement."""
    import torch

    from searchlite_tpu_torch.ops.strip_topk import (
        strip_lanes_blocks,
        strip_lanes_blocks_plain,
    )

    rng = np.random.default_rng(seed)
    block_docs = torch.from_numpy(seg[0]).cuda()
    block_imps = torch.from_numpy(seg[1]).cuda()
    sent = torch.tensor([seg[0].shape[0] - 1, n1 - 1], dtype=torch.int32,
                        device="cuda")
    rows = []
    for B, L in shapes:
        nblk = L // 128
        bstart_np, bcnt_np, w_np = make_rows(rng, seg, B, 4, nblk, 2)
        args = (block_docs, block_imps, torch.from_numpy(bstart_np).cuda(),
                torch.from_numpy(bcnt_np).cuda(),
                torch.from_numpy(w_np).cuda(), sent)
        kw = dict(nblk=nblk, log2_run=2)
        ks, kd, kc = strip_lanes_blocks(*args, **kw)
        ps, pd, pc = strip_lanes_blocks_plain(*args, **kw)
        torch.cuda.synchronize()
        ks, kd, kc = ks.cpu().numpy(), kd.cpu().numpy(), kc.cpu().numpy()
        ps, pd, pc = ps.cpu().numpy(), pd.cpu().numpy(), pc.cpu().numpy()
        name = f"[{B}, {L}]"
        if not np.array_equal(kc, pc):
            raise AssertionError(f"strip_lanes {name}: counts differ")
        for b in range(B):
            got = {int(d): int(x) for d, x in zip(
                kd[b][np.isfinite(ks[b])], ks[b][np.isfinite(ks[b])]
                .view(np.int32))}
            want = {int(d): int(x) for d, x in zip(
                pd[b][np.isfinite(ps[b])], ps[b][np.isfinite(ps[b])]
                .view(np.int32))}
            if got != want or len(got) != int(kc[b]):
                raise AssertionError(f"strip_lanes {name}: the kept "
                                     "(doc, score) sets differ")
        t_kern, t_plain = time_pair(lambda: strip_lanes_blocks(*args, **kw),
                                    lambda: strip_lanes_blocks_plain(*args,
                                                                     **kw),
                                    20)
        # the output: one 8-byte key a lane of the kernel's tiles
        bms, by = bound_ms(*strip_work(bstart_np, bcnt_np, ks.shape[1]))
        row = {"rows": B, "lanes": L, "kept": int(kc.sum()), "ms": t_kern,
               "plain_ms": t_plain, "bound_ms": bms, "bound_by": by,
               "max_abs_err": 0.0}
        log(f"strip_lanes {name}: {row['kept']} kept (doc, score) pairs "
            f"bit-identical, counts equal; kernel {t_kern:.4f} ms, plain "
            f"{t_plain:.4f} ms, bound {bms:.4f} ms ({by})")
        rows.append(row)
    return rows


def fused_inputs(g, Q, R, S, N, n_filters):
    """Seeded operands on the card shaped like a batch's: each query has
    4 dense-row terms and 2 scattered ones (idf-like weights 1-5), M
    rows hold ~2% nonzero impacts, 5% of docs are deleted; filter row 0
    matches all and the last matches nothing."""
    import torch

    def weights(K, per_row):
        w = torch.zeros((Q, K), device="cuda")
        if K:
            cols = torch.randint(0, K, (Q, per_row), generator=g,
                                 device="cuda")
            w.scatter_(1, cols, torch.rand((Q, per_row), generator=g,
                                           device="cuda") * 4 + 1)
        return w

    def impacts(K):
        m = torch.rand((K, N), generator=g, device="cuda")
        keep = torch.rand((K, N), generator=g, device="cuda") < 0.02
        return torch.where(keep, m, 0.0)

    kw = {}
    w1, m1 = weights(R, 4), impacts(R)
    if S:
        kw["w2"], kw["m2"] = weights(S, 2), impacts(S)
    deleted = torch.rand((N,), generator=g, device="cuda") < 0.05
    if n_filters:
        rows = torch.rand((n_filters, N), generator=g, device="cuda") < 0.5
        rows[0] = True
        rows[-1] = False
        kw["filter_rows"] = rows
        kw["fidx"] = torch.randint(0, n_filters, (Q,), generator=g,
                                   device="cuda", dtype=torch.int32)
    return w1, m1, deleted, kw


def same_topk(ref_s, ref_i, got_s, got_i) -> float:
    """Raises unless the finite entries, scores (RTOL/ATOL) and ids
    (except near-ties) agree; returns the max abs score error."""
    fin = np.isfinite(ref_s)
    if not np.array_equal(np.isfinite(got_s), fin):
        raise AssertionError("finite entries differ")
    if not np.allclose(got_s[fin], ref_s[fin], rtol=RTOL, atol=ATOL):
        raise AssertionError("scores differ past tolerance")
    tol = ATOL + RTOL * np.abs(np.where(fin, ref_s, 0.0))
    gap = np.full(ref_s.shape, np.inf)
    with np.errstate(invalid="ignore"):
        diff = np.abs(np.diff(ref_s, axis=1))
    gap[:, 1:] = np.minimum(gap[:, 1:], diff)
    gap[:, :-1] = np.minimum(gap[:, :-1], diff)
    clear = fin & (gap > tol)
    if not np.array_equal(got_i[clear], ref_i[clear]):
        raise AssertionError("top-k ids differ beyond near-ties")
    return float(np.abs(got_s[fin] - ref_s[fin]).max()) if fin.any() \
        else 0.0


def check_fused_call(name, w1, m1, deleted, k: int, kw, n_false=None):
    """One fused call against the plain version on the same tensors, then
    timed beside it. ``n_false`` names a filter row that matches nothing.
    Returns the per-shape dict; raises on any disagreement."""
    import torch

    from searchlite_tpu_torch.ops.fused_topk import (
        fused_topk,
        fused_topk_plain,
    )

    Q, R, N = w1.shape[0], w1.shape[1], m1.shape[1]
    w2, m2 = kw.get("w2"), kw.get("m2")
    S = 0 if w2 is None else w2.shape[1]
    nf = 0 if kw.get("filter_rows") is None else kw["filter_rows"].shape[0]
    ts, td = fused_topk(w1, m1, deleted, k=k, **kw)
    ps, pd = fused_topk_plain(w1, m1, deleted, k=k, **kw)
    torch.cuda.synchronize()
    ts, td, ps, pd = (x.cpu().numpy() for x in (ts, td, ps, pd))
    try:
        err = same_topk(ps, pd, ts, td)
    except AssertionError as e:
        raise AssertionError(f"fused_topk {name}: {e}") from None
    if n_false is not None and not np.isneginf(
            ts[kw["fidx"].cpu().numpy() == n_false]).all():
        raise AssertionError(f"fused_topk {name}: the all-false "
                             "filter row matched")
    iters = 3 if Q * N > 1 << 24 else 20
    t_kern, t_plain = time_pair(
        lambda: fused_topk(w1, m1, deleted, k=k, **kw),
        lambda: fused_topk_plain(w1, m1, deleted, k=k, **kw), iters)
    # the library yardstick: one torch.matmul (TF32 off) of the score
    # part over the concatenated operands; the port never calls it
    wcat = torch.cat([w1, w2], 1) if S else w1
    mcat = torch.cat([m1, m2], 0) if S else m1
    t_lib = time_ms(lambda: torch.matmul(wcat, mcat), iters)
    del wcat, mcat
    bms, by = bound_ms(*fused_work(w1, m1, deleted, k, **kw))
    row = {"name": name, "shape": [Q, R, S, N], "k": k,
           "max_abs_err": err, "finite": int(np.isfinite(ts).sum()),
           "ms": t_kern, "plain_ms": t_plain, "library_ms": t_lib,
           "bound_ms": bms, "bound_by": by}
    log(f"fused_topk {name}: Wd [{Q}, {R}] Md [{R}, {N}]"
        + (f" + Ws [{Q}, {S}] Ms [{S}, {N}]" if S else "")
        + (f", {nf} filter rows" if nf else "")
        + f", k={k}: agrees ({row['finite']} finite, max abs err "
        f"{err:.3g}); kernel {t_kern:.4f} ms, plain {t_plain:.4f} ms, "
        f"matmul {t_lib:.4f} ms, bound {bms:.4f} ms ({by})")
    return row


def check_fused_kernel(seed: int = 17):
    """The fused kernel vs its plain version at FUSED_SHAPES. Returns a
    list of per-shape dicts; raises on any disagreement."""
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    rows = []
    for name, Q, R, S, N, k, nf in FUSED_SHAPES:
        w1, m1, deleted, kw = fused_inputs(g, Q, R, S, N, nf)
        rows.append(check_fused_call(name, w1, m1, deleted, k, kw,
                                     n_false=nf - 1 if nf else None))
        del w1, m1, deleted, kw
    return rows


class FusedCalls:
    """Records the operands a scorer hands ``fused_topk`` (the union
    waves' scorer of ``ops/tiles.py``, or with ``module`` the block scorer
    of ``ops/impact.py`` that the doc-sharded scan calls once a shard:
    each looks the wrapper up in its own module), so that the kernel is
    held against its plain version on the tensors the main path gave it.
    The recorder passes every call on unchanged."""

    def __init__(self, module=None):
        if module is None:
            from searchlite_tpu_torch.ops import tiles as module

        self.module = module
        self.real = module.fused_topk
        self.calls = []

    def __enter__(self):
        def record(w1, m1, deleted, **kw):
            self.calls.append((w1, m1, deleted, kw))
            return self.real(w1, m1, deleted, **kw)

        self.module.fused_topk = record
        return self

    def __exit__(self, *exc):
        self.module.fused_topk = self.real


def check_wave_calls(name: str, calls, tile_width: int):
    """Every recorded wave call of one batch against the plain version;
    if none of them ended in a partial doc chunk (N an odd count of
    ``tile_width`` = half-chunk tiles), the first once more with its last
    tile cut off, so that shape is always held. Returns per-shape dicts."""
    from searchlite_tpu_torch.ops.fused_topk import CHUNK

    if not calls:
        raise AssertionError(f"{name}: no wave call was recorded")
    rows = []
    partial = False
    for i, (w1, m1, deleted, kw) in enumerate(calls):
        kw = dict(kw)
        k = kw.pop("k")
        partial = partial or m1.shape[1] % CHUNK != 0
        rows.append(check_fused_call(f"{name} wave {i + 1}", w1, m1,
                                     deleted, k, kw))
    if not partial:
        w1, m1, deleted, kw = calls[0]
        kw = dict(kw)
        n = m1.shape[1] - tile_width
        if n % CHUNK == 0 or n <= 0:
            raise AssertionError(f"{name}: cannot cut N={m1.shape[1]} to "
                                 "a partial chunk")
        k = min(kw.pop("k"), n)
        if kw.get("filter_rows") is not None:
            kw["filter_rows"] = kw["filter_rows"][:, :n].contiguous()
        rows.append(check_fused_call(
            f"{name} wave 1 less one tile", w1, m1[:, :n].contiguous(),
            deleted[:n].contiguous(), k, kw))
    return rows


def materialize(reader, arrays, n: int):
    scores, ids, segs = arrays
    out = []
    for qi in range(n):
        m = int(np.isfinite(scores[qi]).sum())
        out.append([(reader.segments[int(segs[qi, j])].doc_id(
            int(ids[qi, j])), float(scores[qi, j])) for j in range(m)])
    return out


class Counts:
    """Every kernel wrapper's launch counts, reset and read together."""

    def __init__(self):
        from searchlite_tpu_torch.ops import fused_topk, strip_topk

        self.counts = {"strip_topk": strip_topk.COUNTS,
                       "strip_lanes": strip_topk.LANES_COUNTS,
                       "fused_topk": fused_topk.COUNTS}
        self.gathers = strip_topk.GATHER_CALLS

    def reset(self):
        for c in self.counts.values():
            c.reset()
        self.gathers.reset()

    def read(self):
        """(launches per kernel, plain-version calls); raises if the strip
        was gathered on the card (the kernel reads blocks in place)."""
        if self.gathers.get("cuda"):
            raise AssertionError(
                f"strip_gather ran {self.gathers.get('cuda')} time(s) on "
                "CUDA tensors")
        return ({n: c.launches for n, c in self.counts.items()},
                sum(c.plain for c in self.counts.values()))


# phase e's fields: a keyword of N_CATS distinct values, a multi-valued
# numeric (1-3 values a doc), a date keyword, a 128-wide cosine vector on
# every doc and a bf16 and an int8 vector field on the first
# N_QUANT_DOCS docs
N_CATS = 300
VEC_DIM = 128
N_QUANT_DOCS = 20_000


def doc_cat(i: int) -> int:
    return (i * 7919) % N_CATS


def doc_vals(i: int) -> list[int]:
    return [(i * 37 + j * 101) % 1000 for j in range(1 + i % 3)]


def doc_month_day(i: int) -> tuple[int, int]:
    return 1 + i % 12, 1 + i % 28


def build_index():
    """bench.py's corpus in one commit (body text unchanged), plus the fast
    fields of the filtered batches and of phase e: ``bucket = i % 16``,
    the keyword ``cat``, the multi-valued numeric ``vals``, the date
    keyword ``day``, the cosine vector ``vec`` and, on the first
    ``N_QUANT_DOCS`` docs, ``vec_bf16`` and ``vec_int8``. Returns (index,
    the raw vectors by field)."""
    import bench
    from searchlite_tpu_torch.api.types import IndexOptions, StorageType
    from searchlite_tpu_torch.index import Index
    from searchlite_tpu_torch.index.manifest import Schema

    t0 = time.perf_counter()
    index = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY),
        Schema.from_json({
            "text_fields": [{"name": "body", "analyzer": "default",
                             "stored": False, "indexed": True}],
            "keyword_fields": [
                {"name": "cat", "stored": False, "indexed": False,
                 "fast": True},
                {"name": "day", "stored": False, "indexed": False,
                 "fast": True}],
            "numeric_fields": [
                {"name": "bucket", "type": "i64", "stored": False,
                 "fast": True},
                {"name": "vals", "type": "i64", "stored": False,
                 "fast": True}],
            "vector_fields": [
                {"name": "vec", "dim": VEC_DIM, "metric": "Cosine"},
                {"name": "vec_bf16", "dim": VEC_DIM, "metric": "Cosine",
                 "quantization": "bf16"},
                {"name": "vec_int8", "dim": VEC_DIM, "metric": "L2",
                 "quantization": "int8"}]}))
    docs = bench.build_docs()
    rng = np.random.default_rng(23)
    n_quant = min(N_QUANT_DOCS, len(docs))
    vectors = {
        "vec": rng.normal(size=(len(docs), VEC_DIM)).astype(np.float32),
        "vec_bf16": rng.normal(size=(n_quant, VEC_DIM)).astype(np.float32),
        "vec_int8": rng.normal(size=(n_quant, VEC_DIM)).astype(np.float32)}
    for i, doc in enumerate(docs):
        doc["bucket"] = i % 16
        doc["cat"] = f"c{doc_cat(i):03d}"
        doc["vals"] = doc_vals(i)
        doc["day"] = "2024-%02d-%02dT00:00:00Z" % doc_month_day(i)
        doc["vec"] = vectors["vec"][i].tolist()
        if i < n_quant:
            doc["vec_bf16"] = vectors["vec_bf16"][i].tolist()
            doc["vec_int8"] = vectors["vec_int8"][i].tolist()
    writer = index.writer()
    writer.add_documents(docs)
    writer.commit()
    log(f"index: {bench.N_DOCS} docs built in "
        f"{time.perf_counter() - t0:.1f} s")
    return index, vectors


def run_stream(reader, counts):
    """Path a: the oversized-budget 3x1024 stream. Returns (launches,
    qps)."""
    import torch

    import bench

    batches = bench.build_queries()
    stream = batches[1:]
    n_queries = sum(len(b) for b in stream)
    reader.search_batch_many(stream, limit=K, output="arrays")  # warm
    for key in reader.route_rows:
        reader.route_rows[key] = 0

    counts.reset()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    arr_out = reader.search_batch_many(stream, limit=K, output="arrays")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t2
    launches, plain = counts.read()
    qps = n_queries / dt
    log(f"stream: {n_queries} queries in {dt * 1000:.1f} ms = {qps:.1f} "
        f"QPS; launches {launches}, plain calls {plain}; rows per route "
        f"{reader.route_rows}")
    if launches["strip_topk"] <= 0:
        raise AssertionError("the stream launched no strip kernel")
    if plain != 0:
        raise AssertionError("the stream ran a plain version")
    if reader.route_rows["dense"] or reader.route_rows["split"]:
        raise AssertionError("the b1024 stream took dense or term-split "
                             "rows")
    if len(arr_out) != len(stream):
        raise AssertionError("one result per batch expected")
    for sc, ids, sg in arr_out:
        if sc.shape != (1024, K) or ids.shape != (1024, K) \
                or sg.shape != (1024, K):
            raise AssertionError(f"bad result shape {sc.shape}")
        if np.isnan(sc).any():
            raise AssertionError("NaN scores")

    first = stream[0]
    if not bench.verify_vs_oracle(reader, first,
                                  materialize(reader, arr_out[0],
                                              len(first))):
        raise AssertionError("arrays output disagrees with the oracle")
    log(f"arrays output: verify_vs_oracle true (f32_strict) on all "
        f"{len(first)} queries of the first batch")
    counts.reset()
    pairs = reader.search_batch(first, limit=K)
    launches_p, plain_p = counts.read()
    if launches_p["strip_topk"] <= 0 or plain_p != 0:
        raise AssertionError("search_batch did not run the strip kernel")
    if not bench.verify_vs_oracle(reader, first, pairs):
        raise AssertionError("pairs output disagrees with the oracle")
    log(f"pairs output: verify_vs_oracle true (f32_strict) on all "
        f"{len(first)} queries")
    launches["strip_topk"] += launches_p["strip_topk"]
    return launches, qps


def verify_masked(reader, queries, filters, results, limit):
    """bench.verify_vs_oracle with each query's filter applied to the
    oracle, plus the result count: min(limit, matching docs)."""
    import bench
    from searchlite_tpu_torch.api.types import Filter
    from searchlite_tpu_torch.query.filters import compute_filters_mask

    seg = reader.segments[0]
    masks = {}
    for raw, filt, got in zip(queries, filters, results):
        scores = bench._oracle_scores(reader, raw)
        if filt is not None:
            key = json.dumps(filt, sort_keys=True)
            if key not in masks:
                masks[key] = compute_filters_mask(
                    seg.fast, [Filter.from_json(filt)])
            scores = np.where(masks[key], scores, 0.0).astype(np.float32)
        if len(got) != min(limit, int((scores > 0).sum())):
            raise AssertionError(f"{raw!r}: {len(got)} results")
        if filt is None and not bench.verify_vs_oracle(reader, [raw],
                                                       [got]):
            raise AssertionError(f"{raw!r} disagrees with the oracle")
        tol = [ATOL + RTOL * abs(float(scores[int(d)])) for d, _ in got]
        if any(abs(s - float(scores[int(d)])) > t
               for (d, s), t in zip(got, tol)):
            raise AssertionError(f"{raw!r} ({filt}): a score disagrees "
                                 "with the masked oracle")
        if got:
            floor = min(float(scores[int(d)]) for d, _ in got)
            mask = np.ones(len(scores), dtype=bool)
            mask[np.asarray([int(d) for d, _ in got])] = False
            best_out = float(scores[mask].max()) if mask.any() else 0.0
            if best_out > floor + ATOL + RTOL * abs(best_out):
                raise AssertionError(f"{raw!r} ({filt}): a better doc "
                                     "was left out")


def run_under_budget(reader, counts):
    """Path b: the under-budget route. Returns (launches summed over its
    three batches, per-batch records)."""
    import torch

    import bench

    queries = bench.build_queries()[1][:256]
    filters = [FILTERS[i % len(FILTERS)] for i in range(len(queries))]
    phases = [
        ("b256", queries, None, K),
        ("b256 filtered", queries, filters, K),
        ("b32 k=2000", queries[:32], None, 2000),
    ]
    total = {"strip_topk": 0, "strip_lanes": 0, "fused_topk": 0}
    records = []
    for name, qs, fs, limit in phases:
        reader.search_batch(qs, limit=limit, filters=fs)  # warm
        for key in reader.route_rows:
            reader.route_rows[key] = 0
        fallbacks = reader._split_fallback_rows
        counts.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pairs = reader.search_batch(qs, limit=limit, filters=fs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches, plain = counts.read()
        routes = dict(reader.route_rows)
        log(f"{name}: {len(qs)} queries in {dt * 1000:.1f} ms; launches "
            f"{launches}, plain calls {plain}; rows per route: light "
            f"strip {routes['strip']}, term-split {routes['split']}, "
            f"dense {routes['dense']} (fallback re-scores included), "
            f"fallback {routes['fallback']}")
        if plain != 0:
            raise AssertionError(f"{name} ran a plain version")
        if launches["fused_topk"] <= 0 and (fs is not None or limit > 1024):
            raise AssertionError(f"{name} launched no fused kernel")
        if fs is None and limit <= 1024 and launches["strip_topk"] <= 0:
            raise AssertionError(f"{name} launched no strip kernel")
        if reader._split_fallback_rows - fallbacks != routes["fallback"]:
            raise AssertionError(f"{name}: fallback counts disagree")
        verify_masked(reader, qs, fs or [None] * len(qs), pairs, limit)
        log(f"{name}: oracle-verified (f32_strict"
            + (", filter-masked" if fs else "") + f") on all {len(qs)} "
            "queries")
        for key in total:
            total[key] += launches[key]
        records.append({"name": name, "ms": dt * 1000, "routes": routes,
                        "launches": launches})
    if total["strip_topk"] <= 0 or total["fused_topk"] <= 0:
        raise AssertionError("the under-budget route missed a kernel")
    return total, records


def p50(values) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), 50))


def hit_pairs(res):
    return [(h.doc_id, h.score) for h in res.hits]


def timed_search(reader, req):
    """(result, ms) of one search() call, the card drained around it."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = reader.search(dict(req))
    torch.cuda.synchronize()
    return res, (time.perf_counter() - t0) * 1000


def check_topk_vs(scores, cand, got, count, what: str, limit: int,
                  exact_count: bool = True):
    """The hits ``got`` [(doc_id, score)] and match count against oracle
    ``scores`` [n] over ``cand`` [n], the docs the request matches
    (computed on the host): every score within the f32_strict tolerance,
    no better match left out, the count and the hit count exact. A pruned
    route counts the matches of the tiles it scored: with ``exact_count``
    false the count lies between the hits and the oracle's."""
    n_match = int(cand.sum())
    if (count != n_match) if exact_count else \
            not len(got) <= count <= n_match:
        raise AssertionError(f"{what}: count {count}, oracle {n_match}")
    if len(got) != min(limit, n_match):
        raise AssertionError(f"{what}: {len(got)} hits")
    ids = [int(d) for d, _ in got]
    for d, s in got:
        ref = float(scores[int(d)])
        if not cand[int(d)] or abs(s - ref) > ATOL + RTOL * abs(ref):
            raise AssertionError(f"{what}: doc {d} scores {s}, oracle {ref}")
    if ids:
        floor = min(float(scores[i]) for i in ids)
        rest = cand.copy()
        rest[ids] = False
        best_out = float(scores[rest].max()) if rest.any() else 0.0
        if best_out > floor + ATOL + RTOL * abs(best_out):
            raise AssertionError(f"{what}: a better doc was left out")


def term_docs(reader, token: str) -> np.ndarray:
    seg = reader.segments[0]
    docs, _tfs = seg.postings.term_postings(seg.terms.get(f"body:{token}"))
    return docs


def phrase_docs(reader, first: str, second: str) -> np.ndarray:
    """Docs holding ``second`` right after ``first``, from the postings'
    positions."""
    seg = reader.segments[0]
    postings = seg.postings
    ta = seg.terms.get(f"body:{first}")
    tb = seg.terms.get(f"body:{second}")
    after = {d: set(postings.positions(tb, i).tolist())
             for i, d in enumerate(postings.term_postings(tb)[0].tolist())}
    return np.asarray(sorted(
        d for i, d in enumerate(postings.term_postings(ta)[0].tolist())
        if d in after and any(p + 1 in after[d]
                              for p in postings.positions(ta, i).tolist())),
        dtype=np.int64)


def run_singles(reader, counts):
    """Path c, part 1: bench.py's 9 single queries as default requests
    (execution wand, limit 10): the dense executor, or the doc-tile pruned
    jobs where a segment passes ``SEARCHLITE_PRUNE_MIN_POSTINGS``. Returns
    (launches, p50 ms)."""
    import bench

    queries = bench.build_queries()[0][:9]
    reqs = [{"query": q, "limit": K} for q in queries]
    for req in reqs:
        reader.search(dict(req))  # warm
    before = dict(reader.single_routes)
    counts.reset()
    results, times = [], []
    for req in reqs:
        res, ms = timed_search(reader, req)
        results.append(hit_pairs(res))
        times.append(ms)
    launches, plain = counts.read()
    routes = {k: reader.single_routes[k] - before[k] for k in before}
    if plain != 0:
        raise AssertionError("the single queries ran a plain version")
    if routes["dense"] + routes["pruned"] != len(reqs):
        raise AssertionError(f"the default singles took routes {routes}")
    if not bench.verify_vs_oracle(reader, queries, results):
        raise AssertionError("a default single disagrees with the oracle")
    ms50 = p50(times)
    log(f"singles: {len(reqs)} default requests oracle-verified "
        f"(f32_strict), {routes['pruned']} of them deferred to the pruned "
        f"jobs at the default threshold; routes {routes}; launches "
        f"{launches}; p50 {ms50:.3f} ms (min {min(times):.3f}, max "
        f"{max(times):.3f}) on {card_line()} (information, not a benchmark)")
    return launches, ms50


def run_structured(reader, counts):
    """Path c, part 2: the structured request set, each against an oracle
    with host-computed masks. Returns launches."""
    import bench
    from searchlite_tpu_torch.api.types import Filter
    from searchlite_tpu_torch.query.filters import compute_filters_mask

    seg = reader.segments[0]
    n = seg.doc_count
    bucket = np.arange(n) % 16
    counts.reset()
    # a bool with must / must_not and the bucket filter
    filt = {"I64Range": {"field": "bucket", "min": 2, "max": 9}}
    res = reader.search({"query": {
        "type": "bool",
        "must": [{"type": "term", "field": "body", "value": "tok57"}],
        "must_not": [{"type": "term", "field": "body", "value": "tok12"}],
        "filter": [filt]}, "limit": K})
    scores = bench._oracle_scores(reader, "tok57")
    cand = compute_filters_mask(seg.fast, [Filter.from_json(filt)]) \
        & (scores > 0)
    cand[term_docs(reader, "tok12")] = False
    check_topk_vs(scores, cand, hit_pairs(res), res.total_hits_estimate,
                  "bool", K)
    # a phrase: a filter-only match (score 0), so its first docs ascending
    res = reader.search({"query": {"type": "phrase", "field": "body",
                                   "terms": ["tok40", "tok41"]},
                         "limit": K})
    phrase = phrase_docs(reader, "tok40", "tok41")
    if res.total_hits_estimate != len(phrase) or \
            [h.doc_id for h in res.hits] != [str(d) for d in phrase[:K]] \
            or any(h.score != 0.0 for h in res.hits):
        raise AssertionError("phrase: hits differ from the positions")
    # a function_score over bucket: BM25 x log1p(bucket / 2); bucket 0
    # docs still match, at score 0
    res = reader.search({"query": {
        "type": "function_score",
        "query": {"type": "term", "field": "body", "value": "tok33"},
        "functions": [{"type": "field_value_factor", "field": "bucket",
                       "factor": 0.5, "modifier": "log1p"}],
        "boost_mode": "multiply"}, "limit": K})
    base = bench._oracle_scores(reader, "tok33")
    fvf = np.log1p(np.float32(0.5) * bucket.astype(np.float32))
    check_topk_vs((base * fvf).astype(np.float32), base > 0,
                  hit_pairs(res), res.total_hits_estimate,
                  "function_score", K)
    # a field sort drained through search_scroll: every match, in
    # (bucket, doc) order
    pages = reader.search_scroll(
        {"query": "tok333 tok444", "limit": 50,
         "sort": [{"field": "bucket", "order": "asc"}]}, block_docs=2000)
    got = [h.doc_id for p in pages for h in p.hits]
    docs = np.flatnonzero(bench._oracle_scores(reader, "tok333 tok444") > 0)
    want = [str(d) for d in docs[np.lexsort((docs, bucket[docs]))]]
    if got != want or pages[0].total_hits_estimate != len(want):
        raise AssertionError(f"scroll: {len(got)} hits, want {len(want)} "
                             "in (bucket, doc) order")
    launches, plain = counts.read()
    if plain != 0:
        raise AssertionError("the structured set ran a plain version")
    log(f"structured: bool + filter, phrase ({len(phrase)} docs), "
        f"function_score, field sort drained through search_scroll "
        f"({len(pages)} pages, {len(got)} hits) agree with the oracle and "
        f"the host masks; launches {launches}")
    return launches


def split_queries(seed: int = 13, n: int = 16):
    """Queries holding one or two of the head terms tok0-tok3 beside
    mid-frequency terms."""
    import random

    rng = random.Random(seed)
    out = []
    for i in range(n):
        heads = rng.sample(["tok0", "tok1", "tok2", "tok3"], 1 + i % 2)
        mids = [f"tok{rng.randint(60, 3000)}" for _ in range(3 - i % 2)]
        out.append(" ".join(heads + mids))
    return out


def run_sparse_singles(reader, counts):
    """Path c, part 3: the sparse single routes at this corpus size
    (``SEARCHLITE_SINGLE_SPARSE_MIN_DOCS=0``). Returns (launches, per
    route {"n", "launches", "p50_ms"})."""
    import bench

    queries = bench.build_queries()[0][9:73] + split_queries()
    os.environ["SEARCHLITE_SINGLE_SPARSE_MIN_DOCS"] = "0"
    try:
        for q in queries:
            reader.search({"query": q, "limit": K})  # warm
        counts.reset()
        per_route: dict = {}
        results = []
        for q in queries:
            before = dict(reader.single_routes)
            launches0, _ = counts.read()
            res, ms = timed_search(reader, {"query": q, "limit": K})
            launches1, _ = counts.read()
            delta = {k: reader.single_routes[k] - before[k]
                     for k in before}
            route = ("split_fallthrough" if delta["split_fallthrough"]
                     else "sparse_split" if delta["sparse_split"]
                     else "sparse_plain" if delta["sparse_plain"]
                     else "dense")
            rec = per_route.setdefault(route, {"n": 0, "strip_topk": 0,
                                               "strip_lanes": 0, "ms": []})
            rec["n"] += 1
            for kname in ("strip_topk", "strip_lanes"):
                rec[kname] += launches1[kname] - launches0[kname]
            rec["ms"].append(ms)
            results.append(hit_pairs(res))
            heavy = sum(t in ("tok0", "tok1", "tok2", "tok3")
                        for t in q.split())
            oracle = int((bench._oracle_scores(reader, q) > 0).sum())
            count = res.total_hits_estimate
            exact = route != "sparse_split" or heavy <= 1
            if (count != oracle) if exact else (count > oracle):
                raise AssertionError(f"{q!r} ({route}): count {count}, "
                                     f"oracle {oracle}")
        launches, plain = counts.read()
    finally:
        del os.environ["SEARCHLITE_SINGLE_SPARSE_MIN_DOCS"]
    if not bench.verify_vs_oracle(reader, queries, results):
        raise AssertionError("a sparse single disagrees with the oracle")
    if plain != 0:
        raise AssertionError("the sparse singles ran a plain version")
    if launches["strip_topk"] <= 0 or launches["strip_lanes"] <= 0:
        raise AssertionError("the sparse singles missed a strip kernel pass")
    if "sparse_plain" not in per_route or "sparse_split" not in per_route:
        raise AssertionError(f"routes taken: {sorted(per_route)}")
    for route, rec in sorted(per_route.items()):
        rec["p50_ms"] = p50(rec.pop("ms"))
        log(f"sparse singles, route {route}: {rec['n']} queries, strip "
            f"launches {rec['strip_topk']} top-k + {rec['strip_lanes']} "
            f"all-lanes, p50 {rec['p50_ms']:.3f} ms on {card_line()} "
            "(information, not a benchmark)")
    log(f"sparse singles: {len(queries)} queries oracle-verified "
        f"(f32_strict, counts exact or a lower bound with two head terms); "
        f"launches {launches}, plain calls {plain}, no strip gathered")
    return launches, per_route


def timed_singles(reader, reqs):
    """(results, per-request ms) of ``reqs``, each warmed once first."""
    for req in reqs:
        reader.search(dict(req))
    results, times = [], []
    for req in reqs:
        res, ms = timed_search(reader, req)
        results.append(res)
        times.append(ms)
    return results, times


def same_hits(got, want, what: str):
    """Two results of one request by two routes: the same docs in the same
    order (near-ties may swap), scores within the f32_strict tolerance."""
    g, w = hit_pairs(got), hit_pairs(want)
    if len(g) != len(w) or got.total_hits_estimate != \
            want.total_hits_estimate:
        raise AssertionError(f"{what}: {len(g)} hits of "
                             f"{got.total_hits_estimate}, want {len(w)} of "
                             f"{want.total_hits_estimate}")
    w_score = dict(w)
    for (gd, gs), (wd, ws) in zip(g, w):
        tol = ATOL + RTOL * abs(ws)
        if abs(gs - ws) > tol or (gd != wd and (
                gd not in w_score or abs(w_score[gd] - ws) > tol)):
            raise AssertionError(f"{what}: hit ({gd}, {gs}), want "
                                 f"({wd}, {ws})")


def run_pruned_singles(reader, counts):
    """Path d, part 1: the doc-tile pruned jobs. Returns launches."""
    import bench
    from searchlite_tpu_torch.api.types import Filter
    from searchlite_tpu_torch.query.filters import compute_filters_mask

    queries = bench.build_queries()[0][:9]
    seg = reader.segments[0]
    dense_reqs = [{"query": q, "limit": K, "execution": "bm25",
                   "profile": True} for q in queries]
    dense, dense_ms = timed_singles(reader, dense_reqs)
    counts.reset()
    os.environ["SEARCHLITE_PRUNE_MIN_POSTINGS"] = "0"
    try:
        p50s = {}
        for strategy in ("wand", "bmw"):
            reqs = [{"query": q, "limit": K, "execution": strategy,
                     "profile": True} for q in queries]
            before = dict(reader.single_routes)
            stats = dict(reader.tile_stats)
            results, times = timed_singles(reader, reqs)
            routes = {k: reader.single_routes[k] - before[k]
                      for k in before}
            # warm and timed passes: two searches a request
            per_q = {k: (reader.tile_stats[k] - stats[k])
                     / (2 * len(reqs)) for k in stats}
            if routes["pruned"] != 2 * len(reqs) or routes["dense"]:
                raise AssertionError(f"{strategy} singles took {routes}")
            if not bench.verify_vs_oracle(
                    reader, queries, [hit_pairs(r) for r in results]):
                raise AssertionError(f"a {strategy} single disagrees with "
                                     "the oracle")
            adv = []
            for q, res, ref in zip(queries, results, dense):
                ex = res.profile["execution"]
                touched = ref.profile["execution"]["postings_advanced"]
                if ex["pruning_simulated"] is not False:
                    raise AssertionError(f"{q!r}: pruning_simulated "
                                         f"{ex['pruning_simulated']}")
                if not ex["postings_advanced"] <= touched:
                    raise AssertionError(
                        f"{q!r}: {ex['postings_advanced']} postings "
                        f"advanced, the dense route touches {touched}")
                if not len(res.hits) <= res.total_hits_estimate \
                        <= ref.total_hits_estimate:
                    raise AssertionError(f"{q!r}: count "
                                         f"{res.total_hits_estimate}")
                adv.append(ex["postings_advanced"] / max(touched, 1))
            p50s[strategy] = p50(times)
            log(f"pruned singles ({strategy}): {len(reqs)} requests "
                f"oracle-verified (f32_strict), pruning_simulated false; "
                f"per query {per_q['tiles_scored']:.1f} tiles scored of "
                f"{-(-reader.device_segments[0].n1 // 512)}, "
                f"{per_q['wave_launches']:.2f} wave launches, "
                f"{per_q['ub_launches']:.0f} UB launch; postings advanced "
                f"{100 * float(np.mean(adv)):.1f}% of the dense route's; "
                f"p50 {p50s[strategy]:.3f} ms (min {min(times):.3f}, max "
                f"{max(times):.3f}) beside dense (bm25) p50 "
                f"{p50(dense_ms):.3f} ms on {card_line()} (information, "
                "not a benchmark)")
        # filter / must_not requests: exact inside the scored tiles
        filt = {"I64Range": {"field": "bucket", "min": 2, "max": 9}}
        fmask = compute_filters_mask(seg.fast, [Filter.from_json(filt)])
        s57 = bench._oracle_scores(reader, "tok57")
        cand_bool = fmask & (s57 > 0)
        cand_bool[term_docs(reader, "tok12")] = False
        s_root = bench._oracle_scores(reader, "tok57 tok300")
        structured = [
            ("bool", {"query": {
                "type": "bool",
                "must": [{"type": "term", "field": "body",
                          "value": "tok57"}],
                "must_not": [{"type": "term", "field": "body",
                              "value": "tok12"}],
                "filter": [filt]}, "limit": K}, s57, cand_bool),
            ("root filter", {"query": "tok57 tok300", "limit": K,
                             "filter": filt}, s_root,
             fmask & (s_root > 0)),
        ]
        before = reader.single_routes["pruned"]
        for name, req, scores, cand in structured:
            for strategy in ("wand", "bmw"):
                res = reader.search(dict(req, execution=strategy))
                check_topk_vs(scores, cand, hit_pairs(res),
                              res.total_hits_estimate,
                              f"{name} ({strategy})", K, exact_count=False)
        if reader.single_routes["pruned"] - before != 2 * len(structured):
            raise AssertionError("a structured pruned request did not "
                                 "defer")
        log(f"pruned structured: bool (must, must_not, filter) and a root "
            f"filter, wand and bmw, agree with the oracle and host masks")
    finally:
        del os.environ["SEARCHLITE_PRUNE_MIN_POSTINGS"]
    # once more at the default threshold
    before = dict(reader.single_routes)
    results = [reader.search({"query": q, "limit": K}) for q in queries]
    if not bench.verify_vs_oracle(reader, queries,
                                  [hit_pairs(r) for r in results]):
        raise AssertionError("a default single disagrees with the oracle")
    log(f"default threshold (SEARCHLITE_PRUNE_MIN_POSTINGS=100000): "
        f"{reader.single_routes['pruned'] - before['pruned']} of "
        f"{len(queries)} default singles defer to the pruned jobs, "
        f"{reader.single_routes['dense'] - before['dense']} run dense")
    launches, plain = counts.read()
    if plain != 0:
        raise AssertionError("the pruned singles ran a plain version")
    return launches


def run_chunked_singles(reader, counts):
    """Path d, part 2: the chunked executor, forced by a budget of a
    quarter of the singles' dense M (s_pad 8 x n1 x 4 bytes): four chunks
    of 64 tiles. Returns launches."""
    import bench

    queries = bench.build_queries()[0][:9]
    reqs = [{"query": q, "limit": K, "execution": "bm25"} for q in queries]
    dense, dense_ms = timed_singles(reader, reqs)
    page2 = reader.search(dict(reqs[0], cursor=dense[0].next_cursor))
    n1 = reader.device_segments[0].n1
    counts.reset()
    os.environ["SEARCHLITE_M_BUDGET_BYTES"] = str(8 * n1 * 4 // 4)
    try:
        before = dict(reader.single_routes)
        waves = reader.tile_stats["wave_launches"]
        chunked, times = timed_singles(reader, reqs)
        n_chunks = (reader.tile_stats["wave_launches"] - waves) \
            / (2 * len(reqs))
        for q, got, want in zip(queries, chunked, dense):
            same_hits(got, want, f"chunked {q!r}")
        same_hits(reader.search(dict(reqs[0],
                                     cursor=chunked[0].next_cursor)),
                  page2, "chunked cursor page")
        routes = {k: reader.single_routes[k] - before[k] for k in before}
        if routes["chunked"] != 2 * len(reqs) + 1 or routes["dense"] \
                or n_chunks < 2:
            raise AssertionError(f"chunked singles took {routes}, "
                                 f"{n_chunks} chunks a query")
    finally:
        del os.environ["SEARCHLITE_M_BUDGET_BYTES"]
    launches, plain = counts.read()
    if plain != 0:
        raise AssertionError("the chunked singles ran a plain version")
    log(f"chunked singles: {len(reqs)} requests (bm25) and a cursor page "
        f"equal to the dense run's, {n_chunks:.0f} chunks a query; p50 "
        f"{p50(times):.3f} ms (min {min(times):.3f}, max {max(times):.3f}) "
        f"beside dense p50 {p50(dense_ms):.3f} ms on {card_line()} "
        "(information, not a benchmark)")
    return launches


def run_batched_wand(reader, counts):
    """Path d, part 3: batched wand. Returns (launches summed over its
    batches, the fused kernel's per-shape rows at the union waves' own
    operands)."""
    import torch

    import bench
    from searchlite_tpu_torch.ops.tiles import get_tile_index

    batches = bench.build_queries()
    stream = batches[1:]
    n_queries = sum(len(b) for b in stream)
    total = {"strip_topk": 0, "strip_lanes": 0, "fused_topk": 0}
    wave_rows = []
    tile_width = get_tile_index(reader.device_segments[0]).T

    def timed_stream(execution):
        reader.search_batch_many(stream, limit=K, output="arrays",
                                 execution=execution)  # warm
        counts.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = reader.search_batch_many(stream, limit=K, output="arrays",
                                       execution=execution)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches, plain = counts.read()
        if plain != 0:
            raise AssertionError(f"the {execution} stream ran a plain "
                                 "version")
        return out, n_queries / dt, launches

    def add(launches):
        for key in total:
            total[key] += launches[key]

    # the stream, bm25 then wand then wand then bm25 (means side by side)
    rows = dict(reader.route_rows)
    _o, bm_1, _l = timed_stream("bm25")
    arr_out, wand_1, launches = timed_stream("wand")
    _o, wand_2, _l = timed_stream("wand")
    _o, bm_2, _l = timed_stream("bm25")
    add(launches)
    if launches["strip_topk"] <= 0:
        raise AssertionError("the wand stream (pq path) launched no strip "
                             "kernel for its light rows")
    first = stream[0]
    if not bench.verify_vs_oracle(
            reader, first, materialize(reader, arr_out[0], len(first))):
        raise AssertionError("the wand stream disagrees with the oracle")
    log(f"wand stream (per-query path): {n_queries} queries, "
        f"verify_vs_oracle true (f32_strict) on all {len(first)} queries "
        f"of the first batch; launches {launches}; QPS wand "
        f"{(wand_1 + wand_2) / 2:.1f} ({wand_1:.1f}, {wand_2:.1f}) beside "
        f"bm25 {(bm_1 + bm_2) / 2:.1f} ({bm_1:.1f}, {bm_2:.1f}) on "
        f"{card_line()} (information, not a benchmark); rows per route "
        f"over the six calls: "
        f"{ {k: reader.route_rows[k] - rows[k] for k in rows} }")

    def batch(name, queries, filters, env, want_tiles, want_fused):
        for key, val in env.items():
            os.environ[key] = val
        try:
            reader.search_batch(queries, limit=K, filters=filters,
                                execution="wand")  # warm
            stats = dict(reader.tile_stats)
            counts.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with FusedCalls() as recorded:
                pairs = reader.search_batch(queries, limit=K,
                                            filters=filters,
                                            execution="wand")
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches, plain = counts.read()
        finally:
            for key in env:
                del os.environ[key]
        delta = {k: reader.tile_stats[k] - stats[k] for k in stats}
        if plain != 0:
            raise AssertionError(f"{name} ran a plain version")
        if want_tiles and not (delta["ub_launches"] > 0
                               and delta["wave_launches"] > 0):
            raise AssertionError(f"{name} ran no tile wave: {delta}")
        if want_fused and launches["fused_topk"] <= 0:
            raise AssertionError(f"{name} launched no fused kernel")
        if want_fused:
            # the kernel against its plain version on the waves' own
            # operands (after the counts were read: these launches do not
            # count for the path)
            wave_rows.extend(check_wave_calls(name, recorded.calls,
                                              tile_width))
        del recorded
        verify_masked(reader, queries, filters or [None] * len(queries),
                      pairs, K)
        add(launches)
        log(f"{name}: {len(queries)} queries oracle-verified (f32_strict"
            + (", filter-masked" if filters else "") + f") in "
            f"{dt * 1000:.1f} ms; launches {launches}; tile stats {delta} "
            f"on {card_line()} (information, not a benchmark)")

    # head-term rows are over the strips' cap: the per-query tile waves
    batch("wand head-term b64 (per-query tile waves)",
          split_queries(seed=19, n=64), None, {}, True, False)
    b256 = batches[1][:256]
    filters = [FILTERS[i % len(FILTERS)] for i in range(len(b256))]
    batch("wand b256 filtered (union path)", b256, filters, {}, True, True)
    batch("wand b256, SEARCHLITE_BATCH_PRUNE=union", b256, None,
          {"SEARCHLITE_BATCH_PRUNE": "union"}, True, True)
    return total, wave_rows


def fetch_pairs(reader, scores, ids, n: int):
    """Device (scores, ids) of one segment as per-query (doc_id, score)
    lists, as ``search_batch`` gives them."""
    seg = reader.segments[0]
    sc = scores[:n].cpu().numpy()
    di = ids[:n].cpu().numpy()
    return [[(seg.doc_id(int(d)), float(s)) for s, d in zip(srow, drow)
             if s > -np.inf] for srow, drow in zip(sc, di)]


def run_sharded(reader, counts):
    """Path e1: the doc-sharded dense scan. The filtered b1024 batch at
    the default budget (two shards) and a 32-query ``limit=2000`` batch
    with the budget cut to a quarter of its dense-M estimate (four
    shards), each against the f64 oracle masked by its filters, with one
    fused launch a live shard and the kernel held against its plain
    version on every shard's own operands; then the two exact routes of a
    batch with no row under the strip cap, full strips (the port's) and
    the scan (the JAX reader's), side by side. Returns (launches, the
    fused kernel's per-shape rows)."""
    import torch

    import bench
    from searchlite_tpu_torch.ops import impact

    dseg = reader.device_segments[0]
    seg = reader.segments[0]
    b1024 = bench.build_queries()[1]
    filters = [FILTERS[i % len(FILTERS)] for i in range(len(b1024))]
    total = {"strip_topk": 0, "strip_lanes": 0, "fused_topk": 0}
    rows = []

    def dense_estimate(queries):
        qb = reader._qb_lazy_native(seg, dseg, [queries], 0, ["body"],
                                    [None])
        return (qb["s_pad"] + len(queries)) * dseg.n1 * 4

    def batch(name, queries, fs, limit, budget, want_shards):
        saved = os.environ.get("SEARCHLITE_M_BUDGET_BYTES")
        if budget is not None:
            os.environ["SEARCHLITE_M_BUDGET_BYTES"] = str(budget)
        try:
            reader.search_batch(queries, limit=limit, filters=fs)  # warm
            before = dict(reader.route_rows)
            counts.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with FusedCalls(impact) as recorded:
                pairs = reader.search_batch(queries, limit=limit,
                                            filters=fs)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches, plain = counts.read()
        finally:
            if saved is None:
                os.environ.pop("SEARCHLITE_M_BUDGET_BYTES", None)
            else:
                os.environ["SEARCHLITE_M_BUDGET_BYTES"] = saved
        routes = {k: reader.route_rows[k] - before[k] for k in before}
        shards = dseg._doc_shards
        width = shards["shard_width"]
        live = -(-dseg.n1 // width)
        if shards["n_shards"] != want_shards:
            raise AssertionError(f"{name}: {shards['n_shards']} shards, "
                                 f"expected {want_shards}")
        if launches["fused_topk"] != live or plain != 0 \
                or len(recorded.calls) != live:
            raise AssertionError(
                f"{name}: {launches['fused_topk']} fused launches over "
                f"{live} live shards, {plain} plain calls")
        if routes["sharded"] != len(queries) or routes["dense"]:
            raise AssertionError(f"{name} took routes {routes}")
        if any(call[1].shape[1] != width + 1 for call in recorded.calls):
            raise AssertionError(f"{name}: a shard is not {width + 1} wide")
        verify_masked(reader, queries, fs or [None] * len(queries), pairs,
                      limit)
        # the kernel against plain on each shard's own operands (after
        # the counts were read: these launches do not count for the path)
        for i, (w1, m1, deleted, kw) in enumerate(recorded.calls):
            kw = dict(kw)
            k = kw.pop("k")
            kw = {key: val for key, val in kw.items() if val is not None}
            rows.append(check_fused_call(f"{name} shard {i + 1}", w1, m1,
                                         deleted, k, kw))
        del recorded
        for key in total:
            total[key] += launches[key]
        log(f"{name}: {len(queries)} queries oracle-verified (f32_strict"
            + (", filter-masked" if fs else "") + f") in {dt * 1000:.1f} "
            f"ms; {shards['n_shards']} shards of N = {width + 1}, "
            f"launches {launches}, plain calls {plain}; rows per route "
            f"{routes} on {card_line()} (information, not a benchmark)")

    est = dense_estimate(b1024)
    budget = int(os.environ.get("SEARCHLITE_M_BUDGET_BYTES", 2 * 1024**3))
    if not est > budget >= est // 2:
        raise AssertionError(f"the b1024 dense-M estimate is {est} bytes: "
                             f"not two shards at the budget of {budget}")
    batch("sharded b1024 filtered", b1024, filters, K, None, 2)
    b32 = b1024[:32]
    batch("sharded b32 k=2000", b32, None, 2000, dense_estimate(b32) // 4, 4)

    # a batch with no row under the strip cap, over the budget: the port
    # rides full strips where the JAX reader takes the scan; both exact
    qb = reader._qb_lazy_native(seg, dseg, [b1024], 0, ["body"], [None])
    impact.ensure_dense_tables(qb)

    def full_strips():
        return reader._full_strip_launch(dseg, qb, K)

    def scan():
        return reader._search_batch_sharded(dseg, qb, K, est, budget)

    counts.reset()
    for name, fn in (("full strips", full_strips), ("the scan", scan)):
        scores, ids = fn()
        if not bench.verify_vs_oracle(
                reader, b1024, fetch_pairs(reader, scores, ids, len(b1024))):
            raise AssertionError(f"{name} disagree with the oracle")
    t_strips, t_scan = time_pair(full_strips, scan, 3)
    launches, plain = counts.read()
    if plain != 0 or launches["strip_topk"] <= 0 \
            or launches["fused_topk"] <= 0:
        raise AssertionError("the route comparison missed a kernel")
    log(f"b1024 unfiltered with no row under the strip cap, both "
        f"oracle-verified: full strips {t_strips:.3f} ms, the doc-sharded "
        f"scan {t_scan:.3f} ms a batch (CUDA events around each call, "
        f"its host prep included) on "
        f"{card_line()} (information, not a benchmark)")
    return total, rows


def agg_requests():
    """Phase e2's requests: (name, aggs, reduces on the device)."""
    sub = {"s": {"type": "stats", "field": "bucket"}}
    device = {
        "terms + stats": {"t": {"type": "terms", "field": "cat",
                                "size": N_CATS, "aggs": sub}},
        "histogram": {"h": {"type": "histogram", "field": "vals",
                            "interval": 100}},
        "date_histogram": {"d": {"type": "date_histogram", "field": "day",
                                 "calendar_interval": "month"}},
        "range": {"r": {"type": "range", "field": "bucket", "ranges": [
            {"to": 4}, {"from": 4, "to": 12}, {"from": 12}]}},
        "filter": {"f": {"type": "filter", "filter": {
            "I64Range": {"field": "bucket", "min": 0, "max": 7}}}},
        "value_count": {"vc": {"type": "value_count", "field": "vals"}},
        "extended_stats": {"es": {"type": "extended_stats",
                                  "field": "bucket"}},
        "significant_terms": {"sig": {"type": "significant_terms",
                                      "field": "cat", "size": N_CATS}},
    }
    host = {
        "percentiles": {"p": {"type": "percentiles", "field": "bucket",
                              "percents": [50, 90]}},
        "cardinality": {"card": {"type": "cardinality", "field": "cat"}},
        "top_hits": {"top": {"type": "top_hits", "size": 3}},
    }
    return ([(name, aggs, True) for name, aggs in device.items()]
            + [(name, aggs, False) for name, aggs in host.items()])


def close_tree(a, b, rtol: float, where: str) -> None:
    """Equal JSON trees: keys, counts and strings equal, floats within
    ``rtol``."""
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            raise AssertionError(f"{where}: keys {sorted(a)} != {sorted(b)}")
        for key in a:
            close_tree(a[key], b[key], rtol, f"{where}.{key}")
    elif isinstance(a, list) and isinstance(b, list):
        if len(a) != len(b):
            raise AssertionError(f"{where}: {len(a)} != {len(b)} entries")
        for i, (x, y) in enumerate(zip(a, b)):
            close_tree(x, y, rtol, f"{where}[{i}]")
    elif isinstance(a, float) and isinstance(b, float):
        if abs(a - b) > rtol * abs(b) + 1e-9:
            raise AssertionError(f"{where}: {a} != {b}")
    elif a != b:
        raise AssertionError(f"{where}: {a!r} != {b!r}")


def check_aggs_vs_numpy(name, out, matched: np.ndarray) -> None:
    """One request's aggregations against numpy over the ingested values
    of the matched docs (``matched``: doc ordinals)."""
    bucket = matched % 16
    cats = np.asarray([doc_cat(int(i)) for i in matched])
    n = len(matched)

    def stats_ok(got, values, what):
        if got["count"] != len(values) or got["min"] != values.min() \
                or got["max"] != values.max() \
                or abs(got["sum"] - values.sum()) > 1e-6 * values.sum():
            raise AssertionError(f"{name}: {what} stats differ from numpy")

    if name == "terms + stats":
        want = np.bincount(cats, minlength=N_CATS)
        got = {b["key"]: b for b in out["t"]["buckets"]}
        if {key: b["doc_count"] for key, b in got.items()} != {
                f"c{c:03d}": int(v) for c, v in enumerate(want) if v}:
            raise AssertionError(f"{name}: bucket counts differ from numpy")
        for c in np.flatnonzero(want)[:40]:
            stats_ok(got[f"c{c:03d}"]["aggregations"]["s"],
                     bucket[cats == c].astype(np.float64), f"c{c:03d}")
    elif name == "histogram":
        want: dict = {}
        for i in matched:
            for key in {v // 100 * 100.0 for v in doc_vals(int(i))}:
                want[key] = want.get(key, 0) + 1
        got = {b["key"]: b["doc_count"] for b in out["h"]["buckets"]
               if b["doc_count"]}
        if got != want:
            raise AssertionError(f"{name}: bucket counts differ from numpy")
    elif name == "date_histogram":
        months = np.bincount(matched % 12, minlength=12)
        got = {b["key"]: b["doc_count"] for b in out["d"]["buckets"]}
        want = {"2024-%02d-01T00:00:00Z" % (m + 1): int(v)
                for m, v in enumerate(months) if v}
        if got != want:
            raise AssertionError(f"{name}: bucket counts differ from numpy")
    elif name == "range":
        want = [int((bucket < 4).sum()),
                int(((bucket >= 4) & (bucket < 12)).sum()),
                int((bucket >= 12).sum())]
        if [b["doc_count"] for b in out["r"]["buckets"]] != want:
            raise AssertionError(f"{name}: counts differ from numpy")
    elif name == "filter":
        if out["f"]["doc_count"] != int((bucket <= 7).sum()):
            raise AssertionError(f"{name}: count differs from numpy")
    elif name == "value_count":
        if out["vc"]["value"] != int((1 + matched % 3).sum()):
            raise AssertionError(f"{name}: count differs from numpy")
    elif name == "extended_stats":
        vals = bucket.astype(np.float64)
        stats_ok(out["es"], vals, "bucket")
        if abs(out["es"]["variance"] - vals.var()) > 1e-6 * vals.var():
            raise AssertionError(f"{name}: variance differs from numpy")
    elif name == "significant_terms":
        import bench

        fg = np.bincount(cats, minlength=N_CATS)
        bg = np.bincount([doc_cat(i) for i in range(bench.N_DOCS)],
                         minlength=N_CATS)
        if out["sig"]["doc_count"] != n \
                or out["sig"]["bg_count"] != bench.N_DOCS:
            raise AssertionError(f"{name}: totals differ from numpy")
        for b in out["sig"]["buckets"]:
            c = int(b["key"][1:])
            if b["doc_count"] != fg[c] or b["bg_count"] != bg[c]:
                raise AssertionError(f"{name}: {b['key']} differs")
    elif name == "percentiles":
        for pct in (50, 90):
            want = float(np.percentile(bucket, pct))
            if abs(out["p"]["values"][str(pct)] - want) > 1.0:
                raise AssertionError(f"{name}: p{pct} far from numpy")
    elif name == "cardinality":
        want = len(set(cats.tolist()))
        if abs(out["card"]["value"] - want) > 0.03 * want:
            raise AssertionError(f"{name}: {out['card']['value']} vs {want}")
    elif name == "top_hits":
        if out["top"]["total"] != n:
            raise AssertionError(f"{name}: total differs from numpy")
    else:
        raise AssertionError(f"no oracle for {name}")


def run_aggs(reader, counts):
    """Path e2: aggregations. Each request runs with
    ``SEARCHLITE_DEVICE_AGGS`` at its default (the device kinds reduce on
    the card) and at 0 (host collectors over the fetched mask): the two
    must agree (keys and counts equal, sums within rtol 1e-6) and equal
    numpy over the ingested values and the host match mask. Returns
    launches."""
    import bench
    from searchlite_tpu_torch.api import reader as reader_mod

    query = "tok5 tok9 tok40"
    matched = np.flatnonzero(bench._oracle_scores(reader, query) > 0)
    fetched = [0]
    real_fetch = reader_mod._fetch

    def counting_fetch(tensors):
        fetched[0] += sum(t.numel() * t.element_size() for t in tensors)
        return real_fetch(tensors)

    counts.reset()
    times = {"device": [], "host": []}
    nbytes = {"device": [], "host": []}
    reader_mod._fetch = counting_fetch
    # under f32_strict stats stay with the host's f64 collectors: this
    # path runs at the default precision, where they reduce on the card
    precision = os.environ.pop("SEARCHLITE_PRECISION", None)
    try:
        for name, aggs, on_device in agg_requests():
            req = {"query": query, "limit": K, "aggs": aggs}
            outs = {}
            for mode in ("device", "host"):
                if mode == "host":
                    os.environ["SEARCHLITE_DEVICE_AGGS"] = "0"
                try:
                    reader.search(dict(req))  # warm
                    before = dict(reader.agg_routes)
                    fetched[0] = 0
                    res, ms = timed_search(reader, req)
                finally:
                    os.environ.pop("SEARCHLITE_DEVICE_AGGS", None)
                delta = {k: reader.agg_routes[k] - before[k]
                         for k in before}
                want = ({"device": 1, "host": 0}
                        if on_device and mode == "device"
                        else {"device": 0, "host": 1})
                if delta != want:
                    raise AssertionError(f"{name} ({mode}): the route "
                                         f"counter moved by {delta}")
                if res.total_hits_estimate != len(matched):
                    raise AssertionError(f"{name} ({mode}): count "
                                         f"{res.total_hits_estimate}")
                check_aggs_vs_numpy(name, res.aggregations, matched)
                outs[mode] = res.aggregations
                if on_device:
                    times[mode].append(ms)
                    nbytes[mode].append(fetched[0])
            close_tree(outs["device"], outs["host"], 1e-6, name)
    finally:
        reader_mod._fetch = real_fetch
        if precision is not None:
            os.environ["SEARCHLITE_PRECISION"] = precision
    launches, plain = counts.read()
    if plain != 0:
        raise AssertionError("the aggregation requests ran a plain version")
    n_dev = len(times["device"])
    log(f"aggregations: {n_dev} device kinds + "
        f"{len(agg_requests()) - n_dev} host-only requests over "
        f"{len(matched)} matched docs agree between the card's reductions "
        f"and the host collectors and with numpy; device kinds p50 "
        f"{p50(times['device']):.3f} ms on the card "
        f"({p50(nbytes['device']):.0f} bytes fetched a request) beside "
        f"{p50(times['host']):.3f} ms on the host collectors "
        f"({p50(nbytes['host']):.0f} bytes, the mask included) on "
        f"{card_line()} (information, not a benchmark)")
    return launches


def check_vector_hits(name, hits, sims: np.ndarray, ok: np.ndarray,
                      limit: int, rtol: float = 1e-5) -> None:
    """Vector-only hits against the brute-force similarity ``sims`` [n]
    over the admissible docs ``ok`` [n]: scores within ``rtol``, the count
    right, no better doc left out (so the sets agree away from
    near-ties)."""
    if len(hits) != min(limit, int(ok.sum())):
        raise AssertionError(f"{name}: {len(hits)} hits")
    ids = [int(h.doc_id) for h in hits]
    for h, d in zip(hits, ids):
        if not ok[d] or abs(h.score - sims[d]) > rtol * abs(sims[d]) + 1e-6:
            raise AssertionError(f"{name}: doc {d} scores {h.score}, brute "
                                 f"force {sims[d]}")
    if ids:
        rest = ok.copy()
        rest[ids] = False
        floor = min(float(sims[d]) for d in ids)
        if rest.any() and float(sims[rest].max()) > floor + 1e-6 \
                + rtol * abs(floor):
            raise AssertionError(f"{name}: a closer doc was left out")
    if [h.score for h in hits] != sorted((h.score for h in hits),
                                         reverse=True):
        raise AssertionError(f"{name}: hits are not score-descending")


def run_vectors(reader, counts, vectors):
    """Path e3: vector and hybrid search. A vector-only request over the
    128-wide cosine field of every doc, a hybrid request (alpha 0.5) with
    a filter, and a vector-only request on the bf16 and the int8 field,
    each against numpy f64 brute force (for bf16 / int8 on the same
    quantized values). Returns launches."""
    import torch

    import bench
    from searchlite_tpu_torch.api.types import Filter
    from searchlite_tpu_torch.ops.vector import quantize_int8
    from searchlite_tpu_torch.query.filters import compute_filters_mask

    seg = reader.segments[0]
    n = seg.doc_count
    rng = np.random.default_rng(29)
    counts.reset()
    limit = 10
    times = {}

    def timed(name, req):
        reader.search(dict(req))  # warm: the field's buffers upload once
        res, ms = timed_search(reader, req)
        times[name] = ms
        return res

    # vector-only, f32 cosine over every doc
    stored = seg.vectors["vec"].vectors.astype(np.float64)
    q = vectors["vec"][4321] + 0.05 * rng.normal(size=VEC_DIM).astype(
        np.float32)
    qn = q.astype(np.float64) / np.linalg.norm(q.astype(np.float64))
    sims = stored @ qn
    res = timed("vector-only", {"query": {
        "type": "vector", "field": "vec", "vector": q.tolist(),
        "alpha": 0.0}, "limit": limit})
    check_vector_hits("vector-only", res.hits, sims, np.ones(n, dtype=bool),
                      limit)
    if res.hits[0].doc_id != "4321":
        raise AssertionError("vector-only: the perturbed doc is not first")

    # hybrid, alpha 0.5, with a root filter: the text top (candidate + 1)
    # joined with the vector top (candidate) among the docs the text
    # matcher and the filter admit
    raw = "tok57 tok300"
    filt = {"I64Range": {"field": "bucket", "min": 2, "max": 9}}
    fmask = compute_filters_mask(seg.fast, [Filter.from_json(filt)])
    bm25 = np.where(fmask, bench._oracle_scores(reader, raw), 0.0)
    cand = bm25 > 0
    res = timed("hybrid", {"query": raw, "limit": limit, "filter": filt,
                           "vector_query": {"field": "vec",
                                            "vector": q.tolist(),
                                            "alpha": 0.5}})
    n_cand = 2 * max(limit, 10)
    text_top = np.lexsort((np.arange(n), -bm25))[:n_cand + 1]
    text_top = text_top[bm25[text_top] > 0]
    vec_sims = np.where(cand, sims, -np.inf)
    vec_top = np.lexsort((np.arange(n), -vec_sims))[:n_cand]
    vec_top = vec_top[np.isfinite(vec_sims[vec_top])]
    in_text = np.zeros(n, dtype=bool)
    in_text[text_top] = True
    in_vec = np.zeros(n, dtype=bool)
    in_vec[vec_top] = True
    blended = 0.5 * np.where(in_text, bm25, 0.0) \
        + 0.5 * np.where(in_vec, sims, -1.0)
    check_vector_hits("hybrid", res.hits, blended, in_text | in_vec, limit,
                      rtol=1e-5)
    if res.total_hits_estimate != int(cand.sum()):
        raise AssertionError("hybrid: the match count differs from the "
                             "oracle's")

    # the quantized fields, on the same quantized values
    n_quant = len(vectors["vec_bf16"])
    present = np.zeros(n, dtype=bool)
    present[:n_quant] = True

    def bf16(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(
            torch.bfloat16).to(torch.float64).numpy()

    stored = seg.vectors["vec_bf16"].vectors[:n_quant]
    qb = vectors["vec_bf16"][77] + 0.05 * rng.normal(size=VEC_DIM).astype(
        np.float32)
    qbn = (qb.astype(np.float64)
           / np.sqrt((qb.astype(np.float64) ** 2).sum())).astype(np.float32)
    sims_b = np.full(n, -np.inf)
    sims_b[:n_quant] = bf16(stored) @ bf16(qbn)
    res = timed("bf16", {"query": {"type": "vector", "field": "vec_bf16",
                                   "vector": qb.tolist(), "alpha": 0.0},
                         "limit": limit})
    check_vector_hits("bf16", res.hits, sims_b, present, limit)

    stored = seg.vectors["vec_int8"].vectors[:n_quant]
    qi = vectors["vec_int8"][99] + 0.05 * rng.normal(size=VEC_DIM).astype(
        np.float32)
    codes, scale = quantize_int8(stored)
    qcodes, qscale = quantize_int8(qi[None, :])
    dots = (codes.astype(np.int64) @ qcodes[0].astype(np.int64)).astype(
        np.float64) * (scale.astype(np.float64) * float(qscale[0]))
    v_sq = (stored.astype(np.float64) ** 2).sum(axis=1)
    q_sq = ((qcodes[0].astype(np.float64) * float(qscale[0])) ** 2).sum()
    sims_i = np.full(n, -np.inf)
    sims_i[:n_quant] = -np.sqrt(np.maximum(v_sq + q_sq - 2.0 * dots, 0.0))
    res = timed("int8", {"query": {"type": "vector", "field": "vec_int8",
                                   "vector": qi.tolist(), "alpha": 0.0},
                         "limit": limit})
    check_vector_hits("int8", res.hits, sims_i, present, limit, rtol=1e-4)

    launches, plain = counts.read()
    if plain != 0:
        raise AssertionError("the vector requests ran a plain version")
    log(f"vectors: vector-only over {n} docs x dim {VEC_DIM} "
        f"({times['vector-only']:.3f} ms), hybrid alpha 0.5 with a filter "
        f"({times['hybrid']:.3f} ms), bf16 cosine ({times['bf16']:.3f} ms) "
        f"and int8 l2 ({times['int8']:.3f} ms) over {n_quant} docs agree "
        f"with numpy f64 brute force on {card_line()} (information, not a "
        "benchmark)")
    return launches


def main() -> int:
    import torch

    log(card_line())
    if not torch.cuda.is_available():
        log("FAILED: torch.cuda.is_available() is False")
        return 2
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {name}, "
        f"{torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from searchlite_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    _kernels.build_all(["strip_topk", "fused_topk"])
    for kname in ("strip_topk", "fused_topk"):
        _kernels.load(kname)
    log(f"built strip_topk + fused_topk in {time.perf_counter() - t0:.1f} "
        f"s (nvcc {_kernels.BUILD_SECONDS.get('strip_topk', 0.0):.1f} s, "
        f"{_kernels.BUILD_SECONDS.get('fused_topk', 0.0):.1f} s, in "
        "parallel)")

    t2 = time.perf_counter()
    rng = np.random.default_rng(3)
    seg = make_segment(rng, N1, 3000, 2 * N1)
    seg_1m = make_segment(rng, N1_1M, 200, 2 * N1_1M)
    log(f"block tables: {seg[0].shape[0]} block rows at n1={N1}, "
        f"{seg_1m[0].shape[0]} at n1={N1_1M}, in "
        f"{time.perf_counter() - t2:.1f} s")
    stream_rows = check_strip_kernel(seg, N1, STREAM_SHAPES)
    strip_rows = stream_rows + check_strip_kernel(
        seg, N1, EXTRA_SHAPES, seed=6, n_big=4)
    strip_rows += check_strip_kernel(seg_1m, N1_1M, [WIDE_SHAPE], seed=7,
                                     t_pad=8, n_big=8)
    strip_rows += check_strip_kernel(seg, N1, [(8, 4096)], k=1024, seed=8)
    strip_rows += check_strip_kernel(seg, N1, SPLIT_SHAPES, seed=9)
    for (B, L, tp), sd in zip(T_PAD_SHAPES, (10, 11)):
        strip_rows += check_strip_kernel(seg, N1, [(B, L)], t_pad=tp,
                                         seed=sd, n_big=tp // 2)
    if max(r["multi"] for r in strip_rows) < 4:
        raise AssertionError("no strip row held a doc in 4 slots")
    lanes_rows = check_lanes_kernel(seg, N1, LANES_SHAPES)
    fused_rows = check_fused_kernel()

    index, vectors = build_index()
    t1 = time.perf_counter()
    reader = index.reader()  # the port's reader, on the card
    log(f"reader open + upload {time.perf_counter() - t1:.1f} s, "
        f"{len(reader.segments)} segment(s), "
        f"n1={reader.device_segments[0].n1}")
    os.environ["SEARCHLITE_PRECISION"] = "f32_strict"  # the oracle's gate
    counts = Counts()
    stream_launches, qps = run_stream(reader, counts)
    log(f"stream QPS {qps:.1f} on {card_line()} (information, not a "
        "benchmark)")
    budget_launches, records = run_under_budget(reader, counts)
    for rec in records:
        log(f"under-budget {rec['name']}: {rec['ms']:.2f} ms on "
            f"{card_line()} (information, not a benchmark)")
    single_launches, _p50 = run_singles(reader, counts)
    struct_launches = run_structured(reader, counts)
    sparse_launches, _routes = run_sparse_singles(reader, counts)
    pruned_launches = run_pruned_singles(reader, counts)
    chunked_launches = run_chunked_singles(reader, counts)
    wand_launches, wave_rows = run_batched_wand(reader, counts)
    fused_rows += wave_rows
    sharded_launches, shard_rows = run_sharded(reader, counts)
    fused_rows += shard_rows
    agg_launches = run_aggs(reader, counts)
    vector_launches = run_vectors(reader, counts, vectors)
    search_launches = {k: single_launches[k] + struct_launches[k]
                       + sparse_launches[k] + pruned_launches[k]
                       + chunked_launches[k] + wand_launches[k]
                       + sharded_launches[k] + agg_launches[k]
                       + vector_launches[k]
                       for k in single_launches}
    for blocked in ("jax", "searchlite_tpu"):
        if sys.modules.get(blocked) is not None:
            raise AssertionError(f"{blocked} was imported")
    main_fused = next(r for r in fused_rows if r["name"] == "b256 filtered")
    kernels = [{
        "name": "strip_topk",
        "route": "cuda",
        "source": "searchlite_tpu_torch/csrc/strip_topk.cu",
        "replaces": "searchlite_tpu/ops/pallas_strip.py:157",
        "launches": stream_launches["strip_topk"]
        + budget_launches["strip_topk"] + search_launches["strip_topk"],
        "max_abs_err": max(r["max_abs_err"] for r in stream_rows),
        # one coalesced 3,072-query launch set: the four stream tiers
        "ms": sum(r["ms"] for r in stream_rows),
        "plain_ms": sum(r["plain_ms"] for r in stream_rows),
        "bound_ms": sum(r["bound_ms"] for r in stream_rows),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                   for r in stream_rows) else "operations",
        "library_ms": None,  # no single PyTorch call computes it
    }, {
        "name": "strip_lanes",
        "route": "cuda",
        "source": "searchlite_tpu_torch/csrc/strip_topk.cu",
        "replaces": "searchlite_tpu/ops/pallas_strip.py:157",
        "launches": search_launches["strip_lanes"],
        "max_abs_err": 0.0,
        # the widest single-query split strip: 1 x 65,536 lanes
        "ms": lanes_rows[-1]["ms"],
        "plain_ms": lanes_rows[-1]["plain_ms"],
        "bound_ms": lanes_rows[-1]["bound_ms"],
        "bound_by": lanes_rows[-1]["bound_by"],
        "library_ms": None,  # no single PyTorch call computes it
    }, {
        "name": "fused_topk",
        "route": "cuda",
        "source": "searchlite_tpu_torch/csrc/fused_topk.cu",
        "replaces": "searchlite_tpu/ops/pallas_topk.py:32",
        "launches": stream_launches["fused_topk"]
        + budget_launches["fused_topk"] + search_launches["fused_topk"],
        "max_abs_err": max(r["max_abs_err"] for r in fused_rows),
        # the filtered b256 batch: every row dense
        "ms": main_fused["ms"],
        "plain_ms": main_fused["plain_ms"],
        "bound_ms": main_fused["bound_ms"],
        "bound_by": main_fused["bound_by"],
        "library_ms": main_fused["library_ms"],
    }]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
