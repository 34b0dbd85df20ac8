"""Micro-benchmarks mirroring the reference's criterion suite, through the
port (``benches/micro.py`` on the port's reader):

    index_small               50-doc commit loop
    search_small              20 docs, top-5
    search_nested_filters     40 docs, 2 nested clauses
    search_cursor_pagination  2500 docs, 20/page full drain
    aggs_terms_stats          1000 docs, terms + stats + histogram
    search_pruned             5000 docs, execution=bmw
    vector_hybrid             10k 64-dim vectors, vector-only + hybrid
    fresh_commit_visibility   a 200-doc commit, then a query that sees it
    merge_segments            10 x 200-doc segments folded into one

Prints one JSON line per scenario, each with ``tier``: where the
scenario's segments lived, from the reader's ``tier_segments`` (``card``,
``host``, or ``card+host`` for a mix; a CPU reader is ``host``). These
indexes are small: on the card they sit under the host tier's size rule
(``SEARCHLITE_HOST_TIER_DOCS``, 16,384 docs) and run on the CPU unless
that variable is 0. Run:

    python -m searchlite_tpu_torch.tools.micro [--device cuda|cpu]
"""

from __future__ import annotations

import json
import os
import sys
import time

SCHEMA = {
    "text_fields": [{"name": "body", "analyzer": "default", "stored": True,
                     "indexed": True}],
    "keyword_fields": [{"name": "tag", "stored": True, "indexed": True,
                        "fast": True}],
    "numeric_fields": [{"name": "n", "i64": True, "fast": True,
                        "stored": True}],
    "nested_fields": [{
        "name": "attrs",
        "fields": [
            {"type": "keyword", "name": "k", "stored": True,
             "indexed": False, "fast": True},
            {"type": "numeric", "name": "v", "i64": True, "fast": True,
             "stored": True},
        ],
        "nullable": True,
    }],
}


def fresh_index(device: str, schema=None):
    from searchlite_tpu_torch.api.types import IndexOptions, StorageType
    from searchlite_tpu_torch.index import Index
    from searchlite_tpu_torch.index.manifest import Schema

    index = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY),
        Schema.from_json(SCHEMA if schema is None else schema))
    index.device = device
    return index


def tier(reader) -> str:
    """Where the reader's segments live: ``card``, ``host`` or
    ``card+host``."""
    if reader.device.type == "cpu":
        return "host"
    card, host = reader.tier_segments["card"], reader.tier_segments["host"]
    return "card+host" if card and host else ("host" if host else "card")


def mk_doc(i: int, nested=False):
    doc = {"_id": str(i), "body": f"document number {i} with words "
                                  f"{'alpha' if i % 2 else 'beta'} gamma",
           "tag": f"t{i % 5}", "n": i}
    if nested:
        doc["attrs"] = [{"k": f"k{i % 3}", "v": i % 7},
                        {"k": f"k{(i + 1) % 3}", "v": (i + 1) % 7}]
    return doc


def timeit(fn, iters: int) -> float:
    fn()  # warmup
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters


def bench_index_small(device: str):
    last = []

    def run():
        index = fresh_index(device)
        writer = index.writer()
        for i in range(50):
            writer.add_document(mk_doc(i))
        writer.commit()
        last[:] = [index]

    value = round(timeit(run, 5) * 1000, 2)
    return {"bench": "index_small", "unit": "ms", "value": value,
            "tier": tier(last[0].reader())}


def bench_search_small(device: str):
    index = fresh_index(device)
    writer = index.writer()
    for i in range(20):
        writer.add_document(mk_doc(i))
    writer.commit()
    reader = index.reader()

    def run():
        reader.search({"query": "alpha gamma", "limit": 5})

    return {"bench": "search_small", "unit": "ms",
            "value": round(timeit(run, 20) * 1000, 2),
            "tier": tier(reader)}


def bench_search_nested_filters(device: str):
    index = fresh_index(device)
    writer = index.writer()
    for i in range(40):
        writer.add_document(mk_doc(i, nested=True))
    writer.commit()
    reader = index.reader()
    request = {
        "query": "document", "limit": 10,
        "filter": {"And": [
            {"Nested": {"path": "attrs", "filter": {
                "KeywordEq": {"field": "k", "value": "k1"}}}},
            {"Nested": {"path": "attrs", "filter": {
                "I64Range": {"field": "v", "min": 2, "max": 6}}}},
        ]},
    }

    def run():
        reader.search(request)

    return {"bench": "search_nested_filters", "unit": "ms",
            "value": round(timeit(run, 20) * 1000, 2),
            "tier": tier(reader)}


def bench_cursor_pagination(device: str):
    index = fresh_index(device)
    writer = index.writer()
    for i in range(2500):
        writer.add_document(mk_doc(i))
    writer.commit()
    reader = index.reader()

    def run():
        # the engine's drain API: block fetches, page-of-20 slices --
        # identical page sequence to the sequential loop
        pages = reader.search_scroll({"query": "document", "limit": 20})
        assert len(pages) >= 125

    def run_sequential():
        cursor = None
        pages = 0
        while True:
            req = {"query": "document", "limit": 20}
            if cursor:
                req["cursor"] = cursor
            res = reader.search(req)
            cursor = res.next_cursor
            pages += 1
            if cursor is None:
                break
        assert pages >= 125

    return [
        {"bench": "search_cursor_pagination_2500", "unit": "ms",
         "value": round(timeit(run, 2) * 1000, 2), "tier": tier(reader)},
        # the per-page loop: 125 sequential round trips
        {"bench": "search_cursor_pagination_2500_sequential",
         "unit": "ms",
         "value": round(timeit(run_sequential, 2) * 1000, 2),
         "tier": tier(reader)},
    ]


def bench_aggs(device: str):
    index = fresh_index(device)
    writer = index.writer()
    for i in range(1000):
        writer.add_document(mk_doc(i))
    writer.commit()
    reader = index.reader()
    request = {
        "query": "document", "limit": 1,
        "aggs": {
            "tags": {"type": "terms", "field": "tag",
                     "aggs": {"s": {"type": "stats", "field": "n"}}},
            "h": {"type": "histogram", "field": "n", "interval": 100},
        },
    }

    def run():
        reader.search(request)

    return {"bench": "aggs_terms_stats_histogram_1000", "unit": "ms",
            "value": round(timeit(run, 5) * 1000, 2), "tier": tier(reader)}


def bench_search_pruned(device: str):
    """Doc-tile pruned execution (execution=bmw) on a mixed-idf corpus:
    one rare + common-term query where block-max pruning has bite."""
    import random

    os.environ.setdefault("SEARCHLITE_PRUNE_MIN_POSTINGS", "1")
    rng = random.Random(9)
    index = fresh_index(device)
    writer = index.writer()
    vocab = [f"t{i}" for i in range(500)]
    weights = [1.0 / (j + 1) for j in range(500)]
    for i in range(5000):
        writer.add_document({
            "_id": str(i), "tag": "a", "n": i,
            "body": " ".join(rng.choices(vocab, weights=weights,
                                         k=20))})
    writer.commit()
    reader = index.reader()
    request = {"query": "t0 t1 t400 t450", "limit": 10,
               "execution": "bmw"}
    reader.search(request)  # warm

    def run():
        reader.search(request)

    return {"bench": "search_pruned_bmw_5000", "unit": "ms",
            "value": round(timeit(run, 10) * 1000, 2), "tier": tier(reader)}


def bench_vector_hybrid(device: str):
    """Vector-only + hybrid alpha-blend search over 10k 64-dim cosine
    vectors (exact similarity)."""
    import random

    from searchlite_tpu_torch.errors import QueryError

    rng = random.Random(17)
    index = fresh_index(device, {
        "text_fields": [{"name": "body", "analyzer": "default",
                         "stored": False, "indexed": True}],
        "vector_fields": [{"name": "emb", "dim": 64,
                           "metric": "Cosine"}],
    })
    writer = index.writer()
    vocab = [f"t{i}" for i in range(200)]
    for i in range(10_000):
        writer.add_document({
            "_id": str(i),
            "body": " ".join(rng.choices(vocab, k=12)),
            "emb": [rng.gauss(0, 1) for _ in range(64)]})
    writer.commit()
    reader = index.reader()
    qvec = [rng.gauss(0, 1) for _ in range(64)]
    vec_only = {"query": {"type": "vector", "field": "emb",
                          "vector": qvec, "alpha": 0.0}, "limit": 10}
    hybrid = {"query": "t1 t2 t3",
              "vector_query": {"field": "emb", "vector": qvec,
                               "alpha": 0.5},
              "limit": 10}
    out = []
    for name, req in (("vector_only_10k", vec_only),
                      ("hybrid_blend_10k", hybrid)):
        try:
            reader.search(req)  # warm

            def run(req=req):
                reader.search(req)

            out.append({"bench": name, "unit": "ms",
                        "value": round(timeit(run, 10) * 1000, 2),
                        "tier": tier(reader)})
        except QueryError as e:
            out.append({"bench": name, "error": str(e),
                        "tier": tier(reader)})
    return out


def bench_fresh_commit_visibility(device: str):
    """Commit-to-searchable latency for a realtime segment: one 200-doc
    commit followed immediately by a query that must see the new docs
    (the reopen + search path, on whichever tier the size rule gives)."""
    index = fresh_index(device)
    writer = index.writer()
    for i in range(500):
        writer.add_document(mk_doc(i))
    writer.commit()
    index.reader().search({"query": "alpha", "limit": 5})  # warm base
    n = [500]
    last = []

    def run():
        w = index.writer()
        for i in range(n[0], n[0] + 200):
            w.add_document(mk_doc(i))
        n[0] += 200
        w.commit()
        reader = index.reader()
        out = reader.search({"query": "alpha gamma", "limit": 5})
        assert out.hits
        last[:] = [reader]

    value = round(timeit(run, 5) * 1000, 2)
    return {"bench": "fresh_commit_visibility_200docs", "unit": "ms",
            "value": value, "tier": tier(last[0])}


def bench_merge_segments(device: str):
    """Structural fold of 10 x 200-doc segments into one
    (Index.merge_segments): the log-structured write story's maintenance
    op (no re-ingestion; contrast compact)."""
    last = []

    def run():
        index = fresh_index(device)
        for c in range(10):
            w = index.writer()
            for i in range(c * 200, (c + 1) * 200):
                w.add_document(mk_doc(i))
            w.commit()
        assert index.merge_segments() == 10
        last[:] = [index]

    value = round(timeit(run, 3) * 1000, 2)
    return {"bench": "merge_10x200doc_segments", "unit": "ms",
            "value": value, "tier": tier(last[0].reader())}


BENCHES = (bench_index_small, bench_search_small,
           bench_search_nested_filters, bench_cursor_pagination,
           bench_aggs, bench_search_pruned, bench_fresh_commit_visibility,
           bench_merge_segments, bench_vector_hybrid)


def run_all(device: str):
    """Every scenario on ``device``, in order: yields the result lines."""
    for bench in BENCHES:
        result = bench(device)
        yield from result if isinstance(result, list) else [result]


def main(argv=None) -> int:
    import argparse

    from searchlite_tpu_torch.tools._common import block_jax, require_device

    block_jax()
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    require_device(args.device)
    for line in run_all(args.device):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
