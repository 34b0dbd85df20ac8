"""A dry run of the mesh: every sharded path once, held to one device.

    python -m searchlite_tpu_torch.parallel.dryrun [N] [--device cpu]

The counterpart of ``__graft_entry__.py::dryrun_multichip`` and
``_dryrun_full_surface``. ``dryrun_multichip(n)`` builds an ``n``-shard
mesh (``[2, n/2]`` where ``n`` is even) over the visible CUDA devices, or
over ``devices`` (one device may be named several times, as
``[torch.device("cpu")] * 8``), and runs:

1. the sharded block-scatter scorer (``parallel/mesh.py::
   make_sharded_scorer``) on a synthetic index, against the same BM25 on
   one device;
2. the sharded impact-matmul scorer (``make_sharded_impact_scorer``)
   against ``W @ M`` over the whole flat postings on one device;
3. the full request surface through the port's reader (filters, a
   phrase, minimum_should_match with must_not, field sort, terms + stats
   aggregations, function_score, collapse, vector-only, hybrid, a cursor
   drain, a batch), each ``search(mesh=)`` against the same request
   without the mesh.

Raises on any disagreement (scores within rtol 2e-5 / atol 1e-5, ids equal
away from near-ties, counts and aggregations equal). Without arguments it
takes every visible CUDA device (at least two shards: one card is cut into
two logical shards).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from searchlite_tpu_torch.ops.impact import build_m, pow4_bucket
from searchlite_tpu_torch.ops.score import _matmul_f32, topk_by_doc
from searchlite_tpu_torch.parallel.mesh import (
    block_bases,
    make_mesh,
    make_sharded_impact_scorer,
    make_sharded_scorer,
    shard_blocks,
    shard_flat_postings,
    visible_devices,
)

RTOL, ATOL = 2e-5, 1e-5


def _synthetic_index(n_docs=512, n_terms=64, seed=0, block=128):
    """Tiny synthetic postings in the block layout (term-major blocks of
    128 docs, the dead doc ``n_docs`` padding each term's last block)."""
    rng = np.random.default_rng(seed)
    n1 = n_docs + 1
    term_start, term_count, all_docs, all_tfs = [], [], [], []
    total = 0
    for _t in range(n_terms):
        df = int(rng.integers(4, n_docs // 2))
        docs = np.sort(rng.choice(n_docs, size=df, replace=False))
        tfs = rng.integers(1, 5, size=df).astype(np.float32)
        nb = -(-df // block)
        bd = np.full((nb, block), n_docs, dtype=np.int32)
        bt = np.zeros((nb, block), dtype=np.float32)
        bd.reshape(-1)[:df] = docs
        bt.reshape(-1)[:df] = tfs
        term_start.append(total)
        term_count.append(nb)
        total += nb
        all_docs.append(bd)
        all_tfs.append(bt)
    doc_len = np.zeros((1, n1), dtype=np.float32)
    doc_len[0, :n_docs] = rng.integers(20, 200, size=n_docs)
    deleted = np.zeros(n1, dtype=bool)
    deleted[n_docs] = True
    return {
        "block_docs": np.concatenate(all_docs, axis=0),
        "block_tfs": np.concatenate(all_tfs, axis=0),
        "doc_len": doc_len,
        "avgdl": np.asarray([float(doc_len[0, :n_docs].mean())],
                            dtype=np.float32),
        "deleted": deleted,
        "term_start": np.asarray(term_start, dtype=np.int32),
        "term_count": np.asarray(term_count, dtype=np.int32),
        "n1": n1,
    }


def _query_batch(idx, batch=8, terms_per_query=4, seed=1):
    """Per-block-slot query arrays: each row's terms' blocks, weight 1."""
    rng = np.random.default_rng(seed)
    n_terms = len(idx["term_start"])
    rows = []
    for _ in range(batch):
        picks = rng.choice(n_terms, size=terms_per_query, replace=False)
        blks = []
        for t in picks:
            start = int(idx["term_start"][t])
            blks.extend(range(start, start + int(idx["term_count"][t])))
        rows.append(blks)
    t_max = max(max(len(r) for r in rows), 1)
    t_max = 1 << (t_max - 1).bit_length() if t_max > 1 else 1
    q_blk = np.zeros((batch, t_max), dtype=np.int32)
    q_weight = np.zeros((batch, t_max), dtype=np.float32)
    q_field = np.zeros((batch, t_max), dtype=np.int32)
    q_valid = np.zeros((batch, t_max), dtype=bool)
    for i, blks in enumerate(rows):
        q_blk[i, :len(blks)] = blks
        q_weight[i, :len(blks)] = 1.0
        q_valid[i, :len(blks)] = True
    return q_blk, q_weight, q_field, q_valid


def _bm25_blocks(idx, doc_len, deleted, qs, k, device, k1=0.9, b=0.4):
    """One device's block-slot BM25 top-k: the reference of step 1."""
    q_blk, q_weight, _q_field, q_valid = (torch.from_numpy(x).to(device)
                                          for x in qs)
    n1 = doc_len.shape[1]
    docs = torch.from_numpy(idx["block_docs"]).to(device)[q_blk.long()]
    tfs = torch.from_numpy(idx["block_tfs"]).to(device)[q_blk.long()]
    ok = q_valid[..., None] & (docs < n1 - 1)
    docs = torch.where(ok, docs, n1 - 1).long()
    dl = torch.from_numpy(doc_len[0]).to(device)[docs]
    norm = dl / float(idx["avgdl"][0])
    sc = q_weight[..., None] * tfs * (k1 + 1.0) / torch.clamp(
        tfs + k1 * (1.0 - b + b * norm), min=1e-6)
    q = q_blk.shape[0]
    flat = (torch.arange(q, device=device)[:, None, None] * n1
            + docs).reshape(-1)
    scores = torch.zeros(q * n1, device=device).index_add_(
        0, flat, torch.where(ok, sc, 0.0).reshape(-1)).reshape(q, n1)
    matched = torch.zeros(q * n1, device=device).index_add_(
        0, flat, ok.reshape(-1).float()).reshape(q, n1)
    dead = torch.from_numpy(deleted).to(device)
    return topk_by_doc(torch.where((matched > 0) & ~dead[None, :], scores,
                                   -np.inf), k)


def _same_topk(what, got, want):
    """Scores within RTOL/ATOL, ids equal away from near-ties."""
    gs, gi = (x.cpu().numpy() for x in got)
    ws, wi = (x.cpu().numpy() for x in want)
    fin = np.isfinite(ws)
    if gs.shape != ws.shape or not np.array_equal(np.isfinite(gs), fin) \
            or not np.allclose(gs[fin], ws[fin], rtol=RTOL, atol=ATOL):
        raise AssertionError(f"{what}: scores differ")
    tol = ATOL + RTOL * np.abs(np.where(fin, ws, 0.0))
    gap = np.full(ws.shape, np.inf)
    with np.errstate(invalid="ignore"):
        diff = np.abs(np.diff(ws, axis=1))
    gap[:, 1:] = np.minimum(gap[:, 1:], diff)
    gap[:, :-1] = np.minimum(gap[:, :-1], diff)
    clear = fin & (gap > tol)
    if not np.array_equal(gi[clear], wi[clear]):
        raise AssertionError(f"{what}: ids differ beyond near-ties")


def dryrun_multichip(n_devices: int, devices=None) -> str:
    """Run one sharded step of every mesh path over an ``n_devices``-shard
    mesh (on ``devices``, default the visible CUDA devices round robin)
    and hold each to one device. Returns the summary line it prints."""
    if devices is None:
        visible = visible_devices("cuda")
        if not visible:
            raise RuntimeError("the dry run takes the visible CUDA devices, "
                               "and there are none: pass devices=")
        devices = [visible[i % len(visible)] for i in range(n_devices)]
    mesh = make_mesh(n_devices, query_axis=2 if n_devices % 2 == 0 else 1,
                     devices=devices)
    dev0 = mesh.device
    n_shards = mesh.shape["shard"]
    n_queries = mesh.shape["query"] * 4

    # the doc space padded to a multiple of the shard count
    n_docs = 511
    n1 = -(-(n_docs + 1) // n_shards) * n_shards
    idx = _synthetic_index(n_docs=n_docs)
    doc_len = np.zeros((1, n1), dtype=np.float32)
    doc_len[:, :idx["doc_len"].shape[1]] = idx["doc_len"]
    deleted = np.ones(n1, dtype=bool)
    deleted[:idx["deleted"].shape[0]] = idx["deleted"]
    block_docs, block_tfs, _per = shard_blocks(
        idx["block_docs"], idx["block_tfs"], n_shards)
    bases = block_bases(block_docs.shape[0], n_shards)
    qs = _query_batch(idx, batch=n_queries)
    scores, ids = make_sharded_scorer(mesh, n1)(
        block_docs, block_tfs, doc_len, idx["avgdl"], deleted, *qs, 0.9,
        0.4, bases, k=10)
    if tuple(scores.shape) != (n_queries, 10) \
            or tuple(ids.shape) != (n_queries, 10):
        raise AssertionError(f"block scorer: shape {tuple(scores.shape)}")
    _same_topk("block scorer", (scores, ids),
               _bm25_blocks(idx, doc_len, deleted, qs, 10, dev0))

    # the impact-matmul scorer over flat postings
    nnz = idx["block_docs"].reshape(-1) < n_docs
    docs_flat = idx["block_docs"].reshape(-1)[nnz].astype(np.int32)
    tfs_flat = idx["block_tfs"].reshape(-1)[nnz]
    dl = doc_len[0, docs_flat]
    avg = float(idx["avgdl"][0])
    impacts_flat = (tfs_flat * 1.9 / np.maximum(
        tfs_flat + 0.9 * (0.6 + 0.4 * dl / avg), 1e-6)).astype(np.float32)
    term_df = []
    for t in range(len(idx["term_start"])):
        s0 = int(idx["term_start"][t])
        blk = idx["block_docs"][s0:s0 + int(idx["term_count"][t])]
        term_df.append(int((blk < n_docs).sum()))
    posting_base = np.concatenate([[0], np.cumsum(term_df)])
    rng = np.random.default_rng(5)
    s_pad = 16
    slot_terms = rng.choice(len(term_df), size=s_pad, replace=False)
    slot_start = posting_base[slot_terms].astype(np.int32)
    slot_len = np.asarray(term_df)[slot_terms].astype(np.int32)
    w = rng.random((n_queries, s_pad)).astype(np.float32)
    p_pad = pow4_bucket(int(slot_len.sum()), minimum=1024)
    sh_docs, sh_imps, per = shard_flat_postings(docs_flat, impacts_flat,
                                                n_shards)
    pbases = np.arange(n_shards, dtype=np.int32) * per
    got = make_sharded_impact_scorer(mesh, n1)(
        sh_docs, sh_imps, deleted, slot_start, slot_len, w, pbases, k=10,
        p_pad=p_pad)
    m = build_m(*(torch.from_numpy(x).to(dev0) for x in (
        docs_flat, impacts_flat, slot_start, slot_len)), n1, p_pad)
    ref = _matmul_f32(torch.from_numpy(w).to(dev0), m)
    dead = torch.from_numpy(deleted).to(dev0)
    _same_topk("impact scorer", got, topk_by_doc(
        torch.where((ref > 0) & ~dead[None, :], ref, -np.inf), 10))

    summary = _dryrun_full_surface(mesh)
    line = (f"dryrun_multichip ok: mesh={dict(mesh.shape)} devices="
            f"{sorted(set(mesh.key))} queries={n_queries} top10 verified "
            "against one device (block-scatter and impact-matmul paths); "
            f"full surface: {summary}")
    print(line, flush=True)
    return line


def _dryrun_full_surface(mesh) -> str:
    """The request surface over the mesh through the port's reader (on the
    mesh's first device), each against the same request without it.
    Returns the names verified, joined by '+'."""
    import random

    from searchlite_tpu_torch.api.reader import IndexReader
    from searchlite_tpu_torch.api.types import IndexOptions, StorageType
    from searchlite_tpu_torch.index import Index
    from searchlite_tpu_torch.index.manifest import Schema

    rng = random.Random(13)
    vocab = [f"w{i}" for i in range(40)]
    idx = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY),
        Schema.from_json({
            "text_fields": [{"name": "body", "analyzer": "default",
                             "stored": False, "indexed": True}],
            "keyword_fields": [{"name": "cat", "stored": False,
                                "indexed": True, "fast": True}],
            "numeric_fields": [{"name": "rank", "type": "i64",
                                "stored": False, "fast": True}],
            "vector_fields": [{"name": "emb", "dim": 8,
                               "metric": "Cosine"}],
        }))
    idx.device = str(mesh.device)
    writer = idx.writer()
    for i in range(600):
        doc = {
            "_id": str(i),
            "body": " ".join(rng.choices(
                vocab, weights=[1 / (j + 1) for j in range(40)],
                k=rng.randint(3, 18))),
            "cat": rng.choice(["a", "b", "c"]),
            "rank": rng.randint(0, 30),
        }
        if i % 5 != 0:  # some docs lack vectors
            doc["emb"] = [rng.uniform(-1, 1) for _ in range(8)]
        writer.add_document(doc)
    writer.commit()
    reader = IndexReader(idx, device=mesh.device)
    requests = {
        "filtered": {"query": "w1 w4", "limit": 10,
                     "filter": {"KeywordEq": {"field": "cat",
                                              "value": "b"}}},
        "phrase": {"query": '"w0 w1"', "limit": 10},
        "msm+must_not": {
            "query": {"type": "bool",
                      "should": [{"type": "term", "field": "body",
                                  "value": v} for v in ("w1", "w2", "w3")],
                      "minimum_should_match": 2,
                      "must_not": [{"type": "term", "field": "body",
                                    "value": "w0"}]},
            "limit": 10},
        "field_sort": {"query": "w1 w3", "limit": 10,
                       "sort": [{"field": "rank", "order": "asc"},
                                {"field": "_score", "order": "desc"}]},
        "aggs": {"query": "w2 w5", "limit": 5,
                 "aggs": {"cats": {"type": "terms", "field": "cat"},
                          "ranks": {"type": "stats", "field": "rank"}}},
        "function_score": {
            "query": {"type": "function_score",
                      "query": {"type": "term", "field": "body",
                                "value": "w3"},
                      "functions": [{"type": "field_value_factor",
                                     "field": "rank", "factor": 0.5,
                                     "modifier": "log1p"}],
                      "boost_mode": "sum"},
            "limit": 10},
        "collapse": {"query": "w1 w2", "limit": 10,
                     "collapse": {"field": "cat"}},
        "vector": {"query": {"type": "vector", "field": "emb",
                             "vector": [0.5] * 8, "alpha": 0.0},
                   "limit": 10},
        "hybrid": {"query": "w1 w3", "limit": 10,
                   "vector_query": {"field": "emb", "vector": [0.25] * 8,
                                    "alpha": 0.5}},
    }
    verified = []
    for name, req in requests.items():
        base = reader.search(dict(req))
        got = reader.search(dict(req), mesh=mesh)
        if [h.doc_id for h in got.hits] != [h.doc_id for h in base.hits] \
                or any(abs(a.score - b.score) >= 1e-4
                       for a, b in zip(base.hits, got.hits)) \
                or got.aggregations != base.aggregations \
                or got.total_hits_estimate != base.total_hits_estimate:
            raise AssertionError(f"full surface: {name} differs")
        verified.append(name)
    pages = []
    for kw in ({}, {"mesh": mesh}):
        got_pages, cursor = [], None
        for _ in range(3):
            r = reader.search({"query": "w1 w2 w5", "limit": 7,
                               **({"cursor": cursor} if cursor else {})},
                              **kw)
            got_pages.append([h.doc_id for h in r.hits])
            cursor = r.next_cursor
            if cursor is None:
                break
        pages.append(got_pages)
    if pages[0] != pages[1]:
        raise AssertionError("full surface: cursor pages differ")
    verified.append("cursor")
    batch = ["w1 w4", "w0", "w9 w12 w20", "", "w30 w30"]
    base_b = reader.search_batch(batch, limit=5)
    got_b = reader.search_batch(batch, limit=5, mesh=mesh)
    for qi, (br, gr) in enumerate(zip(base_b, got_b)):
        if [d for d, _ in br] != [d for d, _ in gr] or any(
                abs(s1 - s2) >= 1e-4 for (_a, s1), (_b, s2) in zip(br, gr)):
            raise AssertionError(f"full surface: batch row {qi} differs")
    verified.append("batch")
    return "+".join(verified)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="one sharded step of every mesh path, held to one "
                    "device")
    ap.add_argument("n", nargs="?", type=int, default=None,
                    help="shards (default: every visible CUDA device, at "
                         "least 2)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    visible = visible_devices(args.device)
    if not visible:
        print("FAILED: torch.cuda.is_available() is False")
        return 2
    n = args.n or max(len(visible), 2)
    dryrun_multichip(n, devices=[visible[i % len(visible)]
                                 for i in range(n)])
    return 0


if __name__ == "__main__":
    sys.exit(main())
