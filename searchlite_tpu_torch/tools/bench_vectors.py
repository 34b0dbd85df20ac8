"""Vector + hybrid search scale benchmark through the port
(``tools/bench_vectors.py`` on the port's reader).

The reference walks a single-layer HNSW per query; this engine answers
with exact brute-force similarity (``ops/vector.py``: one f32 matmul and
a top-k on the card). This bench measures that at scale: N docs x D dims,
vector-only singles (exact top-k) and hybrid (BM25 + vector blend)
singles. The spot check holds four vector queries' top 10 against f64
products over the vector buffer the reader searched (fetched back from
the device): each score within f32 reassociation (rtol 1e-5 / atol
1e-4), and the same docs in order but for swaps of docs tied within
that tolerance; ``ids_exact`` says whether no swap was needed. The tool
exits 1 when the check fails (2 when ``--device cuda`` finds no card).

Usage:
    python -m searchlite_tpu_torch.tools.bench_vectors [n_docs] [dim]
        [--device cuda|cpu]
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


# the f32 reassociation tolerance (D10): the card's products are exact
# f32 (TF32 off), so a hit's score differs from the f64 product by
# summation order alone
VEC_RTOL, VEC_ATOL = 1e-5, 1e-4


def log(**kv):
    print(json.dumps(kv), flush=True)


def searched_vectors(reader, field: str) -> np.ndarray:
    """The f32 vector buffer of segment 0's ``field`` that the reader's
    searches read, fetched from its device."""
    vdata = reader.device_segments[0].reader.vectors[field]
    cached = vdata.__dict__.get("_torch_vectors", {})
    for (_device, quant), entry in cached.items():
        if quant == "none":
            return entry[0].cpu().numpy()
    raise AssertionError(f"no f32 buffer of {field!r} was uploaded")


def main(argv=None) -> int:
    import argparse

    from searchlite_tpu_torch.tools._common import (
        block_jax, card_line, require_device)

    block_jax()
    ap = argparse.ArgumentParser(prog="bench_vectors")
    ap.add_argument("n_docs", nargs="?", type=int, default=500_000)
    ap.add_argument("dim", nargs="?", type=int, default=128)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    n_docs, dim, device = args.n_docs, args.dim, args.device
    require_device(device)
    log(phase="start", n_docs=n_docs, dim=dim, backend=device,
        card=card_line() if device == "cuda" else None)

    from searchlite_tpu_torch.api.types import IndexOptions, StorageType
    from searchlite_tpu_torch.index import Index
    from searchlite_tpu_torch.index.manifest import Schema

    rng = np.random.default_rng(5)
    vocab = [f"t{i}" for i in range(5000)]
    index = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY,
                     enable_positions=False),
        Schema.from_json({
            "text_fields": [{"name": "body", "analyzer": "default",
                             "stored": False, "indexed": True}],
            "vector_fields": [{"name": "emb", "dim": dim,
                               "metric": "cosine"}]}))
    index.device = device
    writer = index.writer()
    t0 = time.perf_counter()
    done = 0
    CHUNK = 100_000
    while done < n_docs:
        n = min(CHUNK, n_docs - done)
        vecs = rng.standard_normal((n, dim), dtype=np.float32)
        toks = rng.integers(0, 5000, size=(n, 8))
        writer.add_documents([
            {"_id": str(done + i),
             "body": " ".join(vocab[t] for t in toks[i]),
             "emb": vecs[i].tolist()} for i in range(n)])
        done += n
    writer.commit()
    log(phase="ingest", docs=n_docs, dim=dim,
        s=round(time.perf_counter() - t0, 1))

    reader = index.reader()
    queries = rng.standard_normal((64, dim)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)

    def vreq(i, k=10):
        return {"query": {"type": "vector", "field": "emb",
                          "vector": queries[i].tolist(),
                          "alpha": 0.0},
                "limit": k}

    reader.search(vreq(0))  # warm: uploads the vector buffer
    t0 = time.perf_counter()
    for i in range(32):
        reader.search(vreq(i))
    dt = time.perf_counter() - t0
    vec_qps = round(32 / dt, 1)
    log(phase="vector_single", p50_ish_ms=round(dt / 32 * 1e3, 1),
        qps=vec_qps)

    # exactness spot check at k=10 against f64 products over the
    # searched buffer: every hit's score within f32 reassociation of its
    # doc's (D10), and at each rank the hit's true similarity within
    # that tolerance of the true top-k's (docs may swap only at a tie)
    ordinal = {d: i for i, d in enumerate(reader.segments[0].doc_ids)}
    raw = searched_vectors(reader, "emb").astype(np.float64)
    want_ok = raw.shape == (n_docs, dim)
    ids_exact = want_ok
    max_err = 0.0
    for i in range(4):
        res = reader.search(vreq(i))
        sims = raw @ queries[i].astype(np.float64)
        top = np.argsort(-sims, kind="stable")[:10]
        got = [ordinal[h.doc_id] for h in res.hits]
        if len(got) != len(top):
            want_ok = ids_exact = False
            continue
        ids_exact = ids_exact and got == [int(t) for t in top]
        for hit, doc, ref in zip(res.hits, got, top):
            err = abs(float(hit.score) - sims[doc])
            max_err = max(max_err, err)
            if err > VEC_ATOL + VEC_RTOL * abs(sims[doc]) \
                    or abs(sims[doc] - sims[ref]) \
                    > VEC_ATOL + VEC_RTOL * abs(sims[ref]):
                want_ok = False
    log(phase="vector_exactness", ok=bool(want_ok),
        ids_exact=bool(ids_exact), max_abs_err=max_err)

    # hybrid singles (BM25 + blend)
    hreq = {"query": {"type": "bool", "must": [
                {"type": "query_string", "query": "t10 t20 t33"},
                {"type": "vector", "field": "emb",
                 "vector": queries[0].tolist(), "alpha": 0.5}]},
            "limit": 10}
    reader.search(hreq)
    t0 = time.perf_counter()
    for _ in range(16):
        reader.search(hreq)
    dt = time.perf_counter() - t0
    log(phase="hybrid_single", p50_ish_ms=round(dt / 16 * 1e3, 1))

    print(json.dumps({
        "metric": f"vector_exact_qps_{n_docs // 1000}k_{dim}d",
        "unit": "qps", "value": vec_qps}), flush=True)
    return 0 if want_ok else 1


if __name__ == "__main__":
    sys.exit(main())
