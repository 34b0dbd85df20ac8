"""Execution-strategy comparison through the port: bm25 (dense) vs wand
vs bmw (``tools/strategy_compare.py`` on the port's reader).

Builds a Zipf corpus, runs the same query set under every execution
strategy, and prints per-strategy ms/q, scored docs and postings
advanced (the counters of ``res.profile["execution"]``: the pruned
strategies run the doc-tile waves of ``ops/tiles.py``, so their posting
counts are postings actually touched). Then holds the reference's
exactness invariant: for every query, wand and bmw return bm25's top-k
docs, in order, with each score within rtol 1e-5 / atol 1e-4 (f32
summation order between the executors, D10).

Usage:
    python -m searchlite_tpu_torch.tools.strategy_compare [n_docs]
        [n_queries] [--vocab N] [--device cuda|cpu]

A small vocab (default 2k) puts a head term in every doc tile -- the
bound can't exclude tiles and dense wins. A large vocab (e.g. 50k) gives
queries rare tail terms whose tiles discipline the bound -- where
WAND-style pruning pays. Exits 1 when the invariant fails.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

VOCAB = 2_000
K = 10
RTOL, ATOL = 1e-5, 1e-4
STRATEGIES = ("bm25", "wand", "bmw")


def build(n_docs: int, n_queries: int, vocab_size: int, device: str):
    """(reader, queries): the JAX tool's corpus (seed 3) in the port's
    in-memory index, its reader on ``device``, and its mixed-idf
    queries."""
    from searchlite_tpu_torch.api.types import IndexOptions, StorageType
    from searchlite_tpu_torch.index import Index
    from searchlite_tpu_torch.index.manifest import Schema

    rng = np.random.default_rng(3)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = (1.0 / ranks) / np.sum(1.0 / ranks)
    vocab = [f"t{i}" for i in range(vocab_size)]

    index = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY,
                     enable_positions=False),
        Schema.from_json({
            "text_fields": [{"name": "body", "analyzer": "default",
                             "stored": False, "indexed": True}]}))
    index.device = device
    writer = index.writer()
    for i in range(n_docs):
        toks = rng.choice(vocab_size, size=int(rng.integers(20, 80)),
                          p=probs)
        writer.add_document(
            {"_id": str(i), "body": " ".join(vocab[t] for t in toks)})
    writer.commit()
    reader = index.reader()

    # mixed-idf queries: one head term + mid/tail terms
    queries = []
    for _ in range(n_queries):
        terms = [vocab[int(rng.choice(vocab_size, p=probs))]]
        terms += [vocab[int(t)]
                  for t in rng.integers(50, vocab_size, size=3)]
        queries.append(" ".join(terms))
    return reader, queries


def same_hits(want, got) -> str | None:
    """None when ``got`` holds ``want``'s docs in order, each score within
    the tolerance; else the first difference."""
    if [d for d, _ in got] != [d for d, _ in want]:
        return f"docs {[d for d, _ in got]} != {[d for d, _ in want]}"
    for (d, s), (_, r) in zip(got, want):
        if abs(s - r) > ATOL + RTOL * abs(r):
            return f"doc {d} score {s} != {r}"
    return None


def compare(reader, queries) -> dict:
    """Every strategy over ``queries`` (a full warm pass each first):
    {strategy: {"ms_per_q", "scored_docs", "postings_advanced"}} plus
    ``identical`` (the invariant) and ``mismatches`` (its first few
    failures)."""
    out = {}
    results = {}
    for strategy in STRATEGIES:
        # warm with a full unmeasured pass, so no strategy pays another's
        # first-use costs
        for q in queries:
            reader.search({"query": q, "limit": K,
                           "execution": strategy})
        scored = advanced = 0
        all_hits = []
        t0 = time.perf_counter()
        for q in queries:
            res = reader.search({"query": q, "limit": K,
                                 "execution": strategy, "profile": True})
            prof = res.profile["execution"]
            scored += prof["scored_docs"]
            advanced += prof["postings_advanced"]
            all_hits.append([(h.doc_id, h.score) for h in res.hits])
        dt = time.perf_counter() - t0
        results[strategy] = all_hits
        out[strategy] = {"ms_per_q": dt * 1000 / len(queries),
                         "scored_docs": int(scored),
                         "postings_advanced": int(advanced)}
    mismatches = []
    for strategy in ("wand", "bmw"):
        for qi, (want, got) in enumerate(zip(results["bm25"],
                                             results[strategy])):
            err = same_hits(want, got)
            if err:
                mismatches.append(f"{strategy} {queries[qi]!r}: {err}")
    out["identical"] = not mismatches
    out["mismatches"] = mismatches[:5]
    return out


def main(argv=None) -> int:
    import argparse

    from searchlite_tpu_torch.tools._common import block_jax, require_device

    block_jax()
    ap = argparse.ArgumentParser(prog="strategy_compare")
    ap.add_argument("n_docs", nargs="?", type=int, default=20_000)
    ap.add_argument("n_queries", nargs="?", type=int, default=100)
    ap.add_argument("--vocab", type=int, default=VOCAB)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    n_docs, n_queries = args.n_docs, args.n_queries
    vocab_size, device = args.vocab, args.device
    require_device(device)
    # make pruning eligible even for modest corpora
    os.environ.setdefault("SEARCHLITE_PRUNE_MIN_POSTINGS", "1")

    reader, queries = build(n_docs, n_queries, vocab_size, device)
    print(f"{n_docs} docs, {n_queries} queries, top-{K}, vocab "
          f"{vocab_size}, device {device}")
    out = compare(reader, queries)
    for strategy in STRATEGIES:
        row = out[strategy]
        print(f"{strategy:>4}: {row['ms_per_q']:>7.2f} ms/q, "
              f"scored {row['scored_docs']:>9} docs, advances "
              f"{row['postings_advanced']:>10}")
    if out["identical"]:
        print(f"top-k identical across strategies for all {n_queries} "
              "queries (exactness invariant)")
    else:
        print("exactness invariant FAILED: " + "; ".join(out["mismatches"]))
    print(json.dumps({"n_docs": n_docs, "n_queries": n_queries,
                      "vocab": vocab_size, **out}), flush=True)
    return 0 if out["identical"] else 1


if __name__ == "__main__":
    sys.exit(main())
