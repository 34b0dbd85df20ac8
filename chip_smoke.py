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
   4 x 524,288 lanes over a segment at n1 = 2^20; the fused score + mask +
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
   Every result is checked against ``bench.py``'s f64 oracle under
   ``SEARCHLITE_PRECISION=f32_strict`` (masked by the port's filter where
   there is one; result counts too), and every path must launch its
   kernels, never run a plain version and never gather a strip on the
   card.

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


def check_fused_kernel(seed: int = 17):
    """The fused kernel vs its plain version at FUSED_SHAPES. Returns a
    list of per-shape dicts; raises on any disagreement."""
    import torch

    from searchlite_tpu_torch.ops.fused_topk import (
        fused_topk,
        fused_topk_plain,
    )

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    rows = []
    for name, Q, R, S, N, k, nf in FUSED_SHAPES:
        w1, m1, deleted, kw = fused_inputs(g, Q, R, S, N, nf)
        ts, td = fused_topk(w1, m1, deleted, k=k, **kw)
        ps, pd = fused_topk_plain(w1, m1, deleted, k=k, **kw)
        torch.cuda.synchronize()
        ts, td, ps, pd = (x.cpu().numpy() for x in (ts, td, ps, pd))
        try:
            err = same_topk(ps, pd, ts, td)
        except AssertionError as e:
            raise AssertionError(f"fused_topk {name}: {e}") from None
        if nf and not np.isneginf(ts[kw["fidx"].cpu().numpy()
                                     == nf - 1]).all():
            raise AssertionError(f"fused_topk {name}: the all-false "
                                 "filter row matched")
        iters = 3 if Q * N > 1 << 24 else 20
        t_kern, t_plain = time_pair(
            lambda: fused_topk(w1, m1, deleted, k=k, **kw),
            lambda: fused_topk_plain(w1, m1, deleted, k=k, **kw), iters)
        # the library yardstick: one torch.matmul (TF32 off) of the score
        # part over the concatenated operands; the port never calls it
        wcat = torch.cat([w1, kw["w2"]], 1) if S else w1
        mcat = torch.cat([m1, kw["m2"]], 0) if S else m1
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
        rows.append(row)
        del w1, m1, deleted, kw
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


def build_index():
    """bench.py's corpus in one commit, plus a numeric fast field
    ``bucket = i % 16`` for the filtered batch (body text unchanged)."""
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
            "numeric_fields": [{"name": "bucket", "type": "i64",
                                "stored": False, "fast": True}]}))
    docs = bench.build_docs()
    for i, doc in enumerate(docs):
        doc["bucket"] = i % 16
    writer = index.writer()
    writer.add_documents(docs)
    writer.commit()
    log(f"index: {bench.N_DOCS} docs built in "
        f"{time.perf_counter() - t0:.1f} s")
    return index


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
    total = {"strip_topk": 0, "fused_topk": 0}
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
    fused_rows = check_fused_kernel()

    index = build_index()
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
        + budget_launches["strip_topk"],
        "max_abs_err": max(r["max_abs_err"] for r in stream_rows),
        # one coalesced 3,072-query launch set: the four stream tiers
        "ms": sum(r["ms"] for r in stream_rows),
        "plain_ms": sum(r["plain_ms"] for r in stream_rows),
        "bound_ms": sum(r["bound_ms"] for r in stream_rows),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                   for r in stream_rows) else "operations",
        "library_ms": None,  # no single PyTorch call computes it
    }, {
        "name": "fused_topk",
        "route": "cuda",
        "source": "searchlite_tpu_torch/csrc/fused_topk.cu",
        "replaces": "searchlite_tpu/ops/pallas_topk.py:32",
        "launches": stream_launches["fused_topk"]
        + budget_launches["fused_topk"],
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
