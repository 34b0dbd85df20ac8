"""Realtime serving benchmark: sustained commits beside a searcher.

    python -m searchlite_tpu_torch.tools.bench_realtime [--seconds N]
        [--batch N] [--base N] [--upsert F] [--no-auto-merge]
        [--device cuda]

The counterpart of ``tools/bench_realtime.py`` for the port. A writer
thread commits small batches without pause (tiered auto-merge folds them;
with ``--upsert F`` that fraction of every batch rewrites ids of the base
corpus, so every commit tombstones docs of the big segment) while a
searcher thread opens a fresh reader for every query. It reports commit
throughput, search latency percentiles (reader reopen included) and the
commit-to-visible lag: the time from ``commit()`` returning to a reader
counting the batch's sentinel docs.

What it exercises: every reopen goes through the process-wide segment
cache (``device/index.py::cached_segment``). A segment whose tombstones
moved is reopened as a clone that shares the big tensors; fresh segments
under ``SEARCHLITE_HOST_TIER_DOCS`` docs live on the CPU (the host tier)
and reach the card when a fold passes the threshold, warmed before the
swap (``Index._warm_fold``). The summary counts how many reopens cloned
and where the final reader's segments are placed.

Direct API, no HTTP: the numbers are the engine's own. Times are host
wall-clock: on a machine that shares its cores the writer, the merges and
the searcher take turns, and runs spread.

Prints ONE JSON line (the summary, with ``torch.__version__`` and the
card's name and power limit as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` gives them), also written to
``chiprun_out/bench_realtime.json``; the slowest searches with their
stage split go to stderr. Exits non-zero if a thread raised.
``--device cpu`` with a small ``--base`` is for tests.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run(seconds: float, batch: int, base_docs: int, upsert_frac: float,
        auto_merge: bool, device: str) -> dict:
    import torch

    import chip_smoke
    from searchlite_tpu_torch.api.types import IndexOptions
    from searchlite_tpu_torch.index import Index
    from searchlite_tpu_torch.index.manifest import Schema

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    path = tempfile.mkdtemp(prefix="rtbench_",
                            dir=os.path.join(REPO, "build"))
    idx = Index.create(
        IndexOptions(path=path, create_if_missing=True,
                     auto_merge_segments=4 if auto_merge else 0),
        Schema.from_json({"text_fields": [{
            "name": "body", "analyzer": "default", "stored": False,
            "indexed": True}]}))
    idx.device = device
    rng = np.random.default_rng(3)
    ranks = np.arange(1, 20_001)
    probs = (1.0 / ranks) / np.sum(1.0 / ranks)
    vocab = np.array([f"w{i}" for i in range(20_000)])

    t_base = time.perf_counter()
    w = idx.writer()
    toks = rng.choice(vocab, size=(base_docs, 30), p=probs)
    w.add_documents([{"_id": str(i), "body": " ".join(row)}
                     for i, row in enumerate(toks)])
    w.commit()
    reader = idx.reader()
    reader.search({"query": "w3 w17", "limit": 10})  # build the kernels
    base_s = time.perf_counter() - t_base
    base_id = idx.manifest.segments[0].id

    stop = threading.Event()
    lock = threading.Lock()
    stats = {"commits": 0, "docs": 0, "searches": 0, "cloned_reopens": 0,
             "errors": []}
    vis_lags: list[float] = []
    search_ms: list[float] = []
    reopen_ms: list[float] = []
    slow_log: list[dict] = []
    latest_sentinel = [None]  # (sentinel docs committed, commit-return time)

    def writer_loop():
        n = base_docs
        gen = np.random.default_rng(5)
        while not stop.is_set():
            try:
                wtr = idx.writer()
                rows = gen.choice(vocab, size=(batch, 30), p=probs)
                docs = []
                for row in rows:
                    if gen.random() < upsert_frac:
                        did = str(int(gen.integers(0, base_docs)))
                    else:
                        did = str(n)
                        n += 1
                    docs.append({"_id": did, "body": " ".join(row)
                                 + " freshsentinel"})
                wtr.add_documents(docs)
                wtr.commit()
                with lock:
                    stats["commits"] += 1
                    stats["docs"] += batch
                    # one visibility probe in flight at a time
                    if latest_sentinel[0] is None:
                        latest_sentinel[0] = (idx.manifest.generation,
                                              time.perf_counter())
            except Exception as e:  # noqa: BLE001
                with lock:
                    stats["errors"].append(f"writer: {e!r}")
                    stop.set()

    def searcher_loop():
        gen = np.random.default_rng(7)
        last_base = reader.device_segments[0]
        while not stop.is_set():
            try:
                q = " ".join(gen.choice(vocab[:2000], size=2))
                t0 = time.perf_counter()
                rdr = idx.reader()
                t1 = time.perf_counter()
                rdr.search({"query": q, "limit": 10})
                t2 = time.perf_counter()
                base_now = next((d for d in rdr.device_segments
                                 if d.reader.meta.id == base_id), None)
                with lock:
                    stats["searches"] += 1
                    search_ms.append((t2 - t0) * 1000)
                    reopen_ms.append((t1 - t0) * 1000)
                    pending = latest_sentinel[0]
                    if base_now is not None and base_now is not last_base \
                            and base_now.block_docs is last_base.block_docs:
                        stats["cloned_reopens"] += 1
                if base_now is not None:
                    last_base = base_now
                # visibility: the reader's snapshot is at or past the
                # probed commit, and the sentinel term is searchable in it
                t3 = t2
                if pending is not None \
                        and rdr.manifest.generation >= pending[0]:
                    out = rdr.search({"query": "freshsentinel", "limit": 1})
                    t3 = time.perf_counter()
                    if out.total_hits_estimate > 0:
                        with lock:
                            vis_lags.append(t3 - pending[1])
                            latest_sentinel[0] = None
                if (t3 - t0) * 1000 > 500:
                    with lock:
                        slow_log.append({
                            "at_s": round(t0 - t_start, 1),
                            "reopen_ms": round((t1 - t0) * 1e3, 1),
                            "search_ms": round((t2 - t1) * 1e3, 1),
                            "vis_ms": round((t3 - t2) * 1e3, 1),
                            "tier_segments": rdr.tier_segments,
                            "seg_docs": [int(s.doc_count)
                                         for s in rdr.segments[-3:]]})
            except Exception as e:  # noqa: BLE001
                with lock:
                    stats["errors"].append(f"searcher: {e!r}")
                    stop.set()

    threads = [threading.Thread(target=writer_loop, daemon=True),
               threading.Thread(target=searcher_loop, daemon=True)]
    t_start = time.perf_counter()
    for t in threads:
        t.start()
    while time.perf_counter() - t_start < seconds and not stop.is_set():
        time.sleep(0.25)
    stop.set()
    for t in threads:
        t.join(timeout=120)
    wall = time.perf_counter() - t_start
    from searchlite_tpu_torch.api.writer import wait_for_background_merges

    wait_for_background_merges(timeout=120)
    final = idx.reader()

    def pct(xs, p):
        return float(np.percentile(np.asarray(xs), p)) if xs else None

    summary = {
        "bench": "realtime_mixed",
        "device": device,
        "card": chip_smoke.card_line() if device != "cpu" else "cpu",
        "torch": torch.__version__,
        "seconds": wall,
        "base_docs": base_docs,
        "base_ingest_open_s": base_s,
        "batch": batch,
        "auto_merge": auto_merge,
        "upsert_frac": upsert_frac,
        "host_tier_docs": int(os.environ.get("SEARCHLITE_HOST_TIER_DOCS",
                                             16384)),
        "commits": stats["commits"],
        "commits_per_s": stats["commits"] / wall,
        "docs_per_s": stats["docs"] / wall,
        "searches": stats["searches"],
        "search_p50_ms": pct(search_ms, 50),
        "search_p99_ms": pct(search_ms, 99),
        "reopen_p50_ms": pct(reopen_ms, 50),
        "reopen_p99_ms": pct(reopen_ms, 99),
        "cloned_reopens": stats["cloned_reopens"],
        "visibility_probes": len(vis_lags),
        "visibility_p50_ms": pct([v * 1000 for v in vis_lags], 50),
        "visibility_max_ms": pct([v * 1000 for v in vis_lags], 100),
        "final_segments": len(final.segments),
        "final_tier_segments": final.tier_segments,
        "errors": stats["errors"][:5],
    }
    for rec in sorted(slow_log, key=lambda r: -(
            r["reopen_ms"] + r["search_ms"] + r["vis_ms"]))[:8]:
        print("SLOW:", json.dumps(rec), file=sys.stderr)
    shutil.rmtree(path, ignore_errors=True)
    return summary


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--batch", type=int, default=200)
    ap.add_argument("--base", type=int, default=100_000)
    ap.add_argument("--upsert", type=float, default=0.0)
    ap.add_argument("--no-auto-merge", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from searchlite_tpu_torch.tools._common import require_device

    require_device(args.device)
    summary = run(args.seconds, args.batch, args.base, args.upsert,
                  not args.no_auto_merge, args.device)
    line = json.dumps(summary)
    print(line, flush=True)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "bench_realtime.json"),
              "w") as fh:
        fh.write(line + "\n")
    return 1 if summary["errors"] else 0


if __name__ == "__main__":
    sys.exit(main())
