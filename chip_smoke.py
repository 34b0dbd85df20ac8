"""Chip smoke test of the PyTorch/CUDA port (searchlite_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

1. Finds the card (prints ``nvidia-smi`` name and power limit); exits
   non-zero when ``torch.cuda.is_available()`` is false.
2. Builds every CUDA kernel of the batched BM25 path from ``csrc/``.
3. Holds each kernel against its plain PyTorch version on the card, on
   seeded strips at the widths the path produces: scores and ids must be
   bit-identical on finite entries, match counts equal. Prints both times.
4. Drives the port's main path: ``bench.py``'s 100k-doc Zipf corpus (one
   commit), ``IndexReader(index, device="cuda").search_batch_many`` over
   three 1024-query batches with ``output="arrays"``, and one
   ``search_batch`` in pairs form; checks both against ``bench.py``'s f64
   oracle under ``SEARCHLITE_PRECISION=f32_strict`` and checks that the
   path launched the strip kernel and never ran a plain version.

Prints one JSON line of per-kernel results before the last line, and as
the last line ``{"ok": true, "device": {...}}``. Any failure exits
non-zero without that line. Never imports JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.modules["jax"] = None  # the port must run without JAX: fail loudly

# widths [rows, lanes] the headline stream gives the strip kernel: one
# coalesced 3,072-query launch set at 100k docs (tiers of 16/32/128/512
# blocks), then full strips and non-power-of-2 widths
STREAM_SHAPES = [(1536, 2048), (1536, 4096), (256, 16384), (48, 65536)]
EXTRA_SHAPES = [(64, 3072), (16, 49152), (4, 131072)]
K = 10


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


def make_strips(rng, B: int, L: int, n1: int, n_terms: int = 4):
    """Seeded [B, L] strips shaped like gathered posting blocks: per row
    ``n_terms`` doc-ascending runs of unique docs (docs repeat ACROSS
    runs, as multi-term matches do), then (sentinel, 0) pads. Row 0 is
    all sentinel, row 1 holds fewer matches than K, ~5% of values are 0
    (tombstoned docs)."""
    sent = n1 - 1
    d = np.full((B, L), sent, dtype=np.int32)
    v = np.zeros((B, L), dtype=np.float32)
    fill = rng.random(B)
    fill[0] = 0.0
    if B > 1:
        fill[1] = 3.0 / L
    seg = max(L // n_terms, 1)
    step = max(1, (n1 - 2) // seg)
    for t in range(n_terms):
        gaps = rng.integers(1, step + 1, size=(B, seg))
        docs = np.minimum(np.cumsum(gaps, axis=1) - 1, n1 - 2)
        d[:, t * seg:(t + 1) * seg] = docs
        v[:, t * seg:(t + 1) * seg] = rng.random((B, seg),
                                                 dtype=np.float32) + 0.1
    v[rng.random((B, L)) < 0.05] = 0.0
    live = np.arange(L)[None, :] < (fill * L)[:, None].astype(np.int64)
    d = np.where(live, d, sent).astype(np.int32)
    v = np.where(live, v, 0.0).astype(np.float32)
    return d, v


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


def check_strip_kernel(shapes, k: int = K, seed: int = 5):
    """Kernel vs plain version on the card, per width. Returns a list of
    per-shape dicts; raises on any disagreement."""
    import torch

    from searchlite_tpu_torch.ops.strip_topk import (
        strip_topk,
        strip_topk_plain,
    )

    rng = np.random.default_rng(seed)
    n1 = 131072  # the 100k-doc corpus' padded doc axis
    log2_run = 2  # 4-term queries: t_pad 4
    rows = []
    for B, L in shapes:
        d_np, v_np = make_strips(rng, B, L, n1)
        d = torch.from_numpy(d_np).cuda()
        v = torch.from_numpy(v_np).cuda()
        sent = torch.tensor([n1 - 1], dtype=torch.int32, device="cuda")
        ts, td, cnt = strip_topk(d, v, sent, k=k, log2_run=log2_run,
                                 with_counts=True)
        ps, pd, pc = strip_topk_plain(d, v, sent, k=k, log2_run=log2_run)
        torch.cuda.synchronize()
        ts, td, cnt = ts.cpu().numpy(), td.cpu().numpy(), cnt.cpu().numpy()
        ps, pd, pc = ps.cpu().numpy(), pd.cpu().numpy(), pc.cpu().numpy()
        fin = np.isfinite(ps)
        if not np.array_equal(np.isfinite(ts), fin):
            raise AssertionError(f"[{B}, {L}]: finite entries differ")
        if not np.array_equal(ts[fin].view(np.int32),
                              ps[fin].view(np.int32)):
            raise AssertionError(f"[{B}, {L}]: scores not bit-identical")
        if not np.array_equal(td[fin], pd[fin]):
            raise AssertionError(f"[{B}, {L}]: ids differ")
        if not np.array_equal(cnt, pc):
            raise AssertionError(f"[{B}, {L}]: match counts differ")
        if not (cnt[0] == 0 and np.isinf(ts[0]).all()):
            raise AssertionError(f"[{B}, {L}]: all-sentinel row matched")
        iters = 20 if B * L <= 8 << 20 else 5
        t_plain_a = time_ms(lambda: strip_topk_plain(
            d, v, sent, k=k, log2_run=log2_run), iters)
        t_kern = (time_ms(lambda: strip_topk(
            d, v, sent, k=k, log2_run=log2_run), iters)
            + time_ms(lambda: strip_topk(
                d, v, sent, k=k, log2_run=log2_run), iters)) / 2
        t_plain = (t_plain_a + time_ms(lambda: strip_topk_plain(
            d, v, sent, k=k, log2_run=log2_run), iters)) / 2
        row = {"rows": B, "lanes": L, "k": k,
               "max_abs_err": float(np.abs(ts[fin] - ps[fin]).max())
               if fin.any() else 0.0,
               "finite": int(fin.sum()), "ms": t_kern, "plain_ms": t_plain}
        log(f"strip_topk [{B}, {L}] k={k}: bit-identical "
            f"({row['finite']} finite entries); kernel {t_kern:.4f} ms, "
            f"plain {t_plain:.4f} ms")
        rows.append(row)
    return rows


def materialize(reader, arrays, n: int):
    scores, ids, segs = arrays
    out = []
    for qi in range(n):
        m = int(np.isfinite(scores[qi]).sum())
        out.append([(reader.segments[int(segs[qi, j])].doc_id(
            int(ids[qi, j])), float(scores[qi, j])) for j in range(m)])
    return out


def run_slice():
    """The port's main path on the card. Returns (launches, qps, build
    seconds of the index)."""
    import torch

    import bench
    from searchlite_tpu.api.types import IndexOptions, StorageType
    from searchlite_tpu.index import Index
    from searchlite_tpu.index.manifest import Schema
    from searchlite_tpu_torch.api.reader import IndexReader
    from searchlite_tpu_torch.ops.strip_topk import COUNTS

    t0 = time.perf_counter()
    index = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY),
        Schema.from_json({
            "text_fields": [{"name": "body", "analyzer": "default",
                             "stored": False, "indexed": True}]}))
    writer = index.writer()
    writer.add_documents(bench.build_docs())
    writer.commit()
    build_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    reader = IndexReader(index, device="cuda")
    log(f"index: {bench.N_DOCS} docs built in {build_s:.1f} s, reader "
        f"open + upload {time.perf_counter() - t1:.1f} s, "
        f"{len(reader.segments)} segment(s), n1={reader.device_segments[0].n1}")
    batches = bench.build_queries()
    stream = batches[1:]
    n_queries = sum(len(b) for b in stream)
    reader.search_batch_many(stream, limit=K, output="arrays")  # warm

    COUNTS.reset()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    arr_out = reader.search_batch_many(stream, limit=K, output="arrays")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t2
    launches, plain = COUNTS.launches, COUNTS.plain
    qps = n_queries / dt
    log(f"stream: {n_queries} queries in {dt * 1000:.1f} ms = {qps:.1f} "
        f"QPS; strip kernel launches {launches}, plain calls {plain}")
    if launches <= 0:
        raise AssertionError("the main path launched no strip kernel")
    if plain != 0:
        raise AssertionError("the main path ran the plain strip version")
    if len(arr_out) != len(stream):
        raise AssertionError("one result per batch expected")
    for sc, ids, sg in arr_out:
        if sc.shape != (1024, K) or ids.shape != (1024, K) \
                or sg.shape != (1024, K):
            raise AssertionError(f"bad result shape {sc.shape}")
        if np.isnan(sc).any():
            raise AssertionError("NaN scores")

    os.environ["SEARCHLITE_PRECISION"] = "f32_strict"
    first = stream[0]
    if not bench.verify_vs_oracle(reader, first,
                                  materialize(reader, arr_out[0],
                                              len(first))):
        raise AssertionError("arrays output disagrees with the oracle")
    log(f"arrays output: verify_vs_oracle true (f32_strict) on all "
        f"{len(first)} queries of the first batch")
    COUNTS.reset()
    pairs = reader.search_batch(first, limit=K)
    if COUNTS.launches <= 0 or COUNTS.plain != 0:
        raise AssertionError("search_batch did not run the strip kernel")
    if not bench.verify_vs_oracle(reader, first, pairs):
        raise AssertionError("pairs output disagrees with the oracle")
    log(f"pairs output: verify_vs_oracle true (f32_strict) on all "
        f"{len(first)} queries")
    return launches, qps


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
    _kernels.load("strip_topk")
    log(f"built strip_topk in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_kernels.BUILD_SECONDS.get('strip_topk', 0.0):.1f} s)")

    stream_rows = check_strip_kernel(STREAM_SHAPES)
    check_strip_kernel(EXTRA_SHAPES, seed=6)
    check_strip_kernel([(8, 4096)], k=1024, seed=7)
    launches, qps = run_slice()
    log(f"stream QPS {qps:.1f} on {card_line()} (information, not a "
        "benchmark)")
    if "jax" in sys.modules and sys.modules["jax"] is not None:
        raise AssertionError("JAX was imported")
    kernels = [{
        "name": "strip_topk",
        "route": "cuda",
        "source": "searchlite_tpu_torch/csrc/strip_topk.cu",
        "replaces": "searchlite_tpu/ops/pallas_strip.py:157",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in stream_rows),
        # one coalesced 3,072-query launch set: the four stream tiers
        "ms": sum(r["ms"] for r in stream_rows),
        "plain_ms": sum(r["plain_ms"] for r in stream_rows),
    }]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
