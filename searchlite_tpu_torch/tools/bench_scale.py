"""MS-MARCO-shaped scale benchmark through the port
(``tools/bench_scale.py`` on the port's reader): ingest + batched QPS at
millions of docs.

The corpus is synthetic with MS MARCO's shape: passages of ~60 tokens
drawn from a Zipf-distributed 120,000-term vocabulary, generated with
seed 7. Queries mix head and tail terms like the real query log (2-6
terms, rank-skewed). The generator, the queries, the phases and the
summary keys are the JAX tool's, so a run of either package at one
``n_docs`` measures the same workload.

Usage:
    python -m searchlite_tpu_torch.tools.bench_scale [n_docs]
        [--exec bm25|bmw|none] [--device cuda|cpu] [--cpu-engine]
        [--path DIR] [--build-only] [--no-aggs] [--aggs-only]

--path DIR persists the index on disk and reuses it on later runs (the
generated corpus is deterministic, so a reused index is identical to a
fresh one at the same n_docs).

--cpu-engine also measures the single-core C++ baseline engine
(``native/slt_cpu_engine.cpp``) on the same corpus and query stream, in
all three strategies, and keeps its bm25 top-10 ids and scores for the
whole stream before the engine is freed: they are the gate every batched
phase (bm25, bmw and the b4096 arrays row) is held to -- scores within
rtol 1e-5 / atol 1e-4 (D10), the top-k set equal but for docs tied within
that tolerance at the row's cut. The aggregation and field-sort requests
are also answered under ``SEARCHLITE_DEVICE_AGGS=1`` and ``=0`` and held
equal (floats to 1e-6). The summary's ``gate`` is the conjunction; the
tool exits 1 when it is false (and 2 when ``--device cuda`` finds no
card).

Prints one JSON line per phase (the bytes resident on the device after
the first stream among them; each timed stream with its rows per route
and each kernel's [launches, plain calls]) and a final summary line.
Positions are disabled (the workload has no phrase queries) to keep host
memory proportional to postings.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

VOCAB = 120_000
AVG_LEN = 60
BATCH = 1024
K = 10
CHUNK = 200_000
# the gate's tolerance per score (D10): f32 summation order between the
# C++ engine and the device paths
RTOL, ATOL = 1e-5, 1e-4


def log(**kv):
    print(json.dumps(kv), flush=True)


def gen_chunk(rng, probs, vocab, n, base):
    lengths = rng.integers(AVG_LEN // 2, AVG_LEN * 2, size=n)
    toks = rng.choice(VOCAB, size=int(lengths.sum()), p=probs)
    docs = []
    cursor = 0
    for i in range(n):
        ln = int(lengths[i])
        d = base + i
        docs.append({
            "_id": str(d),
            "body": " ".join(vocab[t]
                             for t in toks[cursor:cursor + ln]),
            # fast fields for the aggregation benchmark
            "cat": f"c{d % 7}",
            "price": float(d % 997),
        })
        cursor += ln
    return docs


def build_queries(rng, n_queries, vocab):
    """Rank-skewed queries: one head term (zipf), 1-5 mid/tail terms --
    the mixed-idf shape where block-max pruning has bite."""
    ranks = np.arange(1, VOCAB + 1, dtype=np.float64)
    probs = (1.0 / ranks) / np.sum(1.0 / ranks)
    out = []
    for _ in range(n_queries):
        n_terms = int(rng.integers(2, 7))
        terms = [vocab[int(rng.choice(VOCAB, p=probs))]]
        terms += [vocab[int(t)] for t in
                  rng.integers(100, VOCAB, size=n_terms - 1)]
        out.append(" ".join(terms))
    return out


def resident_bytes(dseg) -> dict:
    """Bytes of the segment's tensors on its device now, by family: the
    block tables, the flat postings, the doc-shard tables, the dense rows
    and the tile tables (each counted only when built)."""
    import torch

    def size(obj, seen) -> int:
        if id(obj) in seen:
            return 0
        seen.add(id(obj))
        if isinstance(obj, torch.Tensor):
            return 0 if obj.device.type == "cpu" else \
                obj.numel() * obj.element_size()
        if isinstance(obj, dict):
            return sum(size(v, seen) for v in obj.values())
        if isinstance(obj, (list, tuple)):
            return sum(size(v, seen) for v in obj)
        if hasattr(obj, "__dict__") and not isinstance(obj, type):
            return sum(size(v, seen) for k, v in vars(obj).items()
                       if k not in ("seg", "dseg", "host", "reader"))
        return 0

    seen: set = set()
    out = {
        "block_tables": size([dseg.block_docs, dseg.block_impacts,
                              dseg.sparse_sentinels, dseg.deleted,
                              dseg._sparse_tid_tbl,
                              dseg._block_impacts_live], seen),
        "flat_postings": size(dseg._shared.get("flat_postings"), seen),
        "doc_shards": size(dseg._shared.get("doc_shards"), seen),
        "dense_rows": size(dseg._dense_rows, seen),
        "tile_tables": size(dseg._tile_index, seen),
    }
    out["total"] = sum(out.values())
    return out


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= ATOL + RTOL * abs(b)


def check_rows(want_rows, got_rows) -> str | None:
    """None when each got row (a list of (doc_id, score)) holds the
    engine's row (the same): as many hits, every shared doc's score
    within the tolerance, and each doc in one row only tied within it to
    the engine's cut (its last score). Else the first difference."""
    for qi, (want, got) in enumerate(zip(want_rows, got_rows)):
        if len(got) != len(want):
            return f"row {qi}: {len(got)} hits, the engine {len(want)}"
        want_d, got_d = dict(want), dict(got)
        for d, s in got_d.items():
            if d in want_d and not _close(s, want_d[d]):
                return f"row {qi}: doc {d} score {s} != engine {want_d[d]}"
        if not want:
            continue
        cut = want[-1][1]
        for d, s in got + want:
            if (d not in want_d or d not in got_d) and not _close(s, cut):
                return (f"row {qi}: doc {d} ({s}) in one top-{K} only, "
                        f"not tied with the cut {cut}")
    return None


def engine_rows(seg, ids, scores):
    """The engine's [n, k] ordinals and scores as (doc_id, score) rows."""
    return [[(seg.doc_id(int(d)), float(s))
             for d, s in zip(ids[qi], scores[qi]) if d >= 0]
            for qi in range(ids.shape[0])]


def arrays_to_rows(seg, arrays):
    scores, ids, _segs = arrays
    out = []
    for qi in range(scores.shape[0]):
        m = int(np.isfinite(scores[qi]).sum())
        out.append([(seg.doc_id(int(ids[qi, j])), float(scores[qi, j]))
                    for j in range(m)])
    return out


def parse_args(argv: list):
    """The command line of the usage above."""
    import argparse

    ap = argparse.ArgumentParser(prog="bench_scale")
    ap.add_argument("n_docs", nargs="?", type=int, default=5_000_000)
    ap.add_argument("--exec", dest="execution", default=None,
                    choices=["bm25", "bmw", "wand", "none"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--cpu-engine", action="store_true")
    ap.add_argument("--path", default="")
    ap.add_argument("--build-only", action="store_true")
    ap.add_argument("--no-aggs", action="store_true")
    ap.add_argument("--aggs-only", action="store_true")
    return ap.parse_args(argv)


def run(argv: list) -> dict:
    """The bench with the command line ``argv``: logs every phase and
    returns the summary (``gate`` among its keys)."""
    from searchlite_tpu_torch.tools._common import (
        card_line, counts_since, kernel_counts, require_device)
    from searchlite_tpu_torch.tools.fuzz_matrix import agg_eq

    args = parse_args(argv)
    n_docs, device, path = args.n_docs, args.device, args.path
    executions = ["bm25", "bmw"]
    if args.execution is not None:
        # "none": cpu-engine-only runs
        executions = [] if args.execution == "none" else [args.execution]
    require_device(device)
    import torch

    log(phase="start", n_docs=n_docs, backend=device,
        card=card_line() if device == "cuda" else None,
        torch=torch.__version__)

    from searchlite_tpu_torch.api.types import IndexOptions, StorageType
    from searchlite_tpu_torch.index import Index
    from searchlite_tpu_torch.index.manifest import Schema

    rng = np.random.default_rng(7)
    ranks = np.arange(1, VOCAB + 1, dtype=np.float64)
    probs = (1.0 / ranks) / np.sum(1.0 / ranks)
    vocab = [f"t{i}" for i in range(VOCAB)]

    schema = Schema.from_json({
        "text_fields": [{"name": "body", "analyzer": "default",
                         "stored": False, "indexed": True}],
        "keyword_fields": [{"name": "cat", "stored": False,
                            "indexed": False, "fast": True}],
        "numeric_fields": [{"name": "price", "i64": False,
                            "stored": False, "fast": True}]})
    if path and os.path.exists(os.path.join(path, "MANIFEST.json")):
        index = Index.open(IndexOptions(path=path))
        log(phase="reuse", path=path)
    else:
        index = Index.create(
            IndexOptions(path=path, create_if_missing=True,
                         storage=(StorageType.FILESYSTEM if path
                                  else StorageType.IN_MEMORY),
                         enable_positions=False),
            schema)
        writer = index.writer()
        t0 = time.perf_counter()
        done = 0
        while done < n_docs:
            n = min(CHUNK, n_docs - done)
            writer.add_documents(gen_chunk(rng, probs, vocab, n, done))
            done += n
            log(phase="gen+buffer", docs=done,
                elapsed_s=round(time.perf_counter() - t0, 1))
        t1 = time.perf_counter()
        writer.commit()
        t2 = time.perf_counter()
        log(phase="ingest", docs=n_docs,
            gen_buffer_s=round(t1 - t0, 1), commit_s=round(t2 - t1, 1),
            docs_per_s=round(n_docs / (t2 - t0), 1))

    if args.build_only:
        # persist the corpus for a later run without paying any
        # search/upload phases
        log(phase="build_only_done", path=path)
        return {"gate": True}

    t0 = time.perf_counter()
    reader = index.reader(device=device)
    dseg = reader.device_segments[0]
    # host-side accounting of the block layout the strips read; what is
    # resident on the device is logged after the first stream
    post_bytes = int(dseg.host.block_docs_np.size * 4
                     + dseg.host.block_impacts_np.size * 4)
    log(phase="upload", upload_s=round(time.perf_counter() - t0, 1),
        hbm_block_bytes=post_bytes,
        n_blocks=int(dseg.n_block_rows))

    queries = build_queries(rng, BATCH * 3, vocab)
    batches = [queries[i * BATCH:(i + 1) * BATCH] for i in range(3)]

    summary = {"metric": f"scale_batched_qps_{n_docs // 1_000_000}m",
               "unit": "qps", "n_docs": n_docs}
    gate = {}
    seg = reader.segments[0]
    want = None

    if args.cpu_engine:
        from searchlite_tpu_torch.native import CpuEngine

        t0 = time.perf_counter()
        eng = CpuEngine(seg)
        log(phase="cpu_engine_build",
            build_s=round(time.perf_counter() - t0, 1))
        tpq = max(len(q.split()) for q in queries)
        qtids = np.full((len(queries), tpq), -1, dtype=np.int32)
        for qi, q in enumerate(queries):
            for ti, tok in enumerate(q.split()):
                qtids[qi, ti] = eng.tid(f"body:{tok}")
        for mode in ("bm25", "wand", "bmw"):
            eng.search_batch(qtids[:64], k=K, mode=mode)  # warm
            t0 = time.perf_counter()
            ids, scores = eng.search_batch(qtids, k=K, mode=mode)
            dt = time.perf_counter() - t0
            if mode == "bm25":
                # the gate's rows, every query of the stream
                want = engine_rows(seg, ids, scores)
            log(phase="cpu_engine", mode=mode,
                qps=round(len(queries) / dt, 1),
                ms_per_q=round(dt / len(queries) * 1e3, 2))
            summary[f"cpu_engine_qps_{mode}"] = round(
                len(queries) / dt, 1)
        # the engine holds its own full postings copy (GBs at multi-M
        # docs); free it before the device phases
        del eng

    def hold(name: str, qs_from: int, rows) -> None:
        """Hold ``rows`` ((doc_id, score) rows of queries[qs_from:...]) to the
        engine's rows; records the result under ``name``."""
        if want is None:
            return
        n = len(rows)
        err = check_rows(want[qs_from:qs_from + n], rows)
        gate[name] = err is None
        log(phase="gate", check=name, rows=n, ok=err is None, error=err)

    want_aggs = not args.no_aggs and (bool(executions) or args.aggs_only)
    resident_logged = False
    for execution in executions:
        # pruning can't engage when a huge batch's seed tiles cover the
        # whole corpus; bmw runs 64-query sub-batches through the
        # pipelined API (3 bulk fetches for the whole stream)
        sub = 64 if execution in ("wand", "bmw") else BATCH
        stream = [b[i:i + sub] for b in batches[1:]
                  for i in range(0, len(b), sub)]
        # warm every distinct batch the timed region will run
        t0 = time.perf_counter()
        reader.search_batch_many(
            [batches[0][i:i + sub] for i in range(0, BATCH, sub)],
            limit=K, execution=execution)
        reader.search_batch_many(stream, limit=K, execution=execution)
        warm = time.perf_counter() - t0
        if not resident_logged and device != "cpu":
            log(phase="resident", bytes=resident_bytes(dseg))
            resident_logged = True
        rows_before = dict(reader.route_rows)
        kernels_before = kernel_counts()
        rep_qps = []
        n = 0
        t0 = time.perf_counter()
        timed_out = None
        for _rep in range(2):
            t1 = time.perf_counter()
            timed_out = reader.search_batch_many(stream, limit=K,
                                                 execution=execution)
            nq = sum(len(b) for b in stream)
            rep_qps.append(round(nq / (time.perf_counter() - t1), 1))
            n += nq
        dt = time.perf_counter() - t0
        log(phase="batched", execution=execution, sub_batch=sub,
            warm_s=round(warm, 1), qps=round(n / dt, 1),
            rep_qps=rep_qps, route_rows={
                k: v - rows_before[k] for k, v in reader.route_rows.items()
                if v != rows_before[k]},
            kernels=counts_since(kernels_before))
        summary[f"qps_{execution}"] = round(n / dt, 1)
        hold(f"batched_{execution}", BATCH,
             [row for out in timed_out for row in out])

        if execution == "bm25":
            # wide-batch serving config (the headline protocol's b4096
            # row): same query stream re-chunked into one 4096-wide
            # launch -- per-batch host fixed costs amortize 4x further
            wide = [batches[1] + batches[2] + batches[1] + batches[2]]
            reader.search_batch_many(wide, limit=K, output="arrays",
                                     execution=execution)  # warm
            t0 = time.perf_counter()
            wide_out = reader.search_batch_many(
                wide, limit=K, output="arrays", execution=execution)
            dt = time.perf_counter() - t0
            log(phase="batched_wide", execution=execution,
                batch=len(wide[0]), qps=round(len(wide[0]) / dt, 1))
            summary["qps_bm25_arrays_b4096"] = round(
                len(wide[0]) / dt, 1)
            rows = arrays_to_rows(seg, wide_out[0])
            hold("arrays_b4096", BATCH, rows[:2 * BATCH])
            hold("arrays_b4096_repeat", BATCH, rows[2 * BATCH:])

        # p50 single-query latency over 9 queries, each warmed first
        for q in queries[:9]:
            reader.search({"query": q, "limit": K,
                           "execution": execution})
        lat = []
        for q in queries[:9]:
            t1 = time.perf_counter()
            reader.search({"query": q, "limit": K,
                           "execution": execution})
            lat.append((time.perf_counter() - t1) * 1000)
        summary[f"p50_single_ms_{execution}"] = round(
            sorted(lat)[len(lat) // 2], 1)

    def both_ways(name: str, req: dict) -> None:
        """The request under SEARCHLITE_DEVICE_AGGS=1 and =0: hits and
        aggregations equal (floats to 1e-6)."""
        out = {}
        for flag in ("1", "0"):
            os.environ["SEARCHLITE_DEVICE_AGGS"] = flag
            res = reader.search(dict(req))
            out[flag] = ([h.doc_id for h in res.hits],
                         res.to_json().get("aggregations", {}))
        os.environ.pop("SEARCHLITE_DEVICE_AGGS", None)
        err = None
        if out["1"][0] != out["0"][0]:
            err = f"hits {out['1'][0]} != {out['0'][0]}"
        else:
            err = agg_eq(out["1"][1], out["0"][1])
        gate[f"device_aggs_ab_{name}"] = err is None
        log(phase="gate", check=f"device_aggs_ab_{name}", ok=err is None,
            error=err)

    # aggregation p50 at scale: terms + stats + histogram over the
    # match set of a mid-frequency query (device-side partials vs the
    # host-collector mask-fetch path)
    if want_aggs:
        agg_req = {
            "query": queries[0], "limit": 5,
            "aggs": {
                "cats": {"type": "terms", "field": "cat"},
                "price_stats": {"type": "stats", "field": "price"},
                "price_hist": {"type": "histogram", "field": "price",
                               "interval": 100.0},
            }}
        for dev_flag, label in (("1", "device"), ("0", "host")):
            os.environ["SEARCHLITE_DEVICE_AGGS"] = dev_flag
            reader.search(agg_req)  # warm
            lat = []
            for _ in range(5):
                t1 = time.perf_counter()
                reader.search(agg_req)
                lat.append((time.perf_counter() - t1) * 1000)
            p50 = sorted(lat)[len(lat) // 2]
            log(phase="aggs", mode=label, p50_ms=round(p50, 1))
            summary[f"agg_p50_ms_{label}"] = round(p50, 1)
        os.environ.pop("SEARCHLITE_DEVICE_AGGS", None)
        both_ways("aggs", agg_req)

    # terms WITH a stats sub-agg: the sub-agg doc grouping at a
    # multi-M matched set rather than only on test shapes
    if want_aggs:
        subagg_req = {
            "query": queries[0], "limit": 5,
            "aggs": {
                "cats": {"type": "terms", "field": "cat",
                         "aggs": {"price_stats": {
                             "type": "stats", "field": "price"}}},
            }}
        reader.search(subagg_req)  # warm
        lat = []
        for _ in range(5):
            t1 = time.perf_counter()
            reader.search(subagg_req)
            lat.append((time.perf_counter() - t1) * 1000)
        p50 = sorted(lat)[len(lat) // 2]
        log(phase="subagg", p50_ms=round(p50, 1))
        summary["subagg_p50_ms"] = round(p50, 1)
        both_ways("subagg", subagg_req)

    # bounded-memory collectors at scale: t-digest percentiles (match
    # set >> the 4096 exact window) + cardinality with a
    # precision_threshold forced below the field's 997 distinct values,
    # so the HLL sketch path is the one timed
    if want_aggs:
        bounded_req = {
            "query": queries[0], "limit": 5,
            "aggs": {
                "price_pctl": {"type": "percentiles", "field": "price"},
                "price_card": {"type": "cardinality", "field": "price",
                               "precision_threshold": 500},
                "cat_card": {"type": "cardinality", "field": "cat"},
            }}
        reader.search(bounded_req)  # warm
        lat = []
        for _ in range(5):
            t1 = time.perf_counter()
            reader.search(bounded_req)
            lat.append((time.perf_counter() - t1) * 1000)
        p50 = sorted(lat)[len(lat) // 2]
        log(phase="bounded_aggs", p50_ms=round(p50, 1))
        summary["bounded_agg_p50_ms"] = round(p50, 1)
        both_ways("bounded", bounded_req)

    # field-sort p50 at scale: order the same mid-frequency match set
    # by a numeric fast field
    if want_aggs:
        sort_req = {"query": queries[0], "limit": K,
                    "sort": [{"field": "price", "order": "desc"}]}
        reader.search(sort_req)  # warm
        lat = []
        for _ in range(5):
            t1 = time.perf_counter()
            reader.search(sort_req)
            lat.append((time.perf_counter() - t1) * 1000)
        p50 = sorted(lat)[len(lat) // 2]
        log(phase="field_sort", p50_ms=round(p50, 1))
        summary["sort_p50_ms"] = round(p50, 1)
        both_ways("sort", sort_req)

    summary["value"] = summary.get("qps_bm25") or next(
        (summary[f"qps_{e}"] for e in executions
         if f"qps_{e}" in summary), 0)
    summary["gate"] = all(gate.values())
    log(phase="gate_summary", checks=gate, engine=want is not None)
    log(**summary)
    return summary


def main(argv=None) -> int:
    from searchlite_tpu_torch.tools._common import block_jax

    block_jax()
    summary = run(list(sys.argv[1:] if argv is None else argv))
    return 0 if summary["gate"] else 1


if __name__ == "__main__":
    sys.exit(main())
