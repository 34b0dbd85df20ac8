"""The doc-tile pruning ops and routes of the torch port on the card
against the same code on the CPU (``cuda``-marked: skipped where there is
no NVIDIA GPU). Imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch:

    python -m pytest tests/test_torch_tiles_card.py -q -m cuda --noconftest

On the card the union run scorer ends in the hand-written fused kernel,
on the CPU in its plain version: ids must be equal and scores within
rtol 1e-6 / atol 1e-4 (the two sum in their own orders). The ops that are
torch ops on both sides must agree exactly, matmuls within the same
tolerance."""

import random
import types

import numpy as np
import pytest
import torch

from searchlite_tpu_torch.api.types import IndexOptions, StorageType
from searchlite_tpu_torch.index import Index
from searchlite_tpu_torch.index.manifest import Schema
from searchlite_tpu_torch.ops import fused_topk, tiles

RTOL, ATOL = 1e-6, 1e-4


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: compares the card with the CPU")


def synthetic_tiles(seed: int, n1: int = 8192, n_terms: int = 40,
                    width: int = 512):
    """A seeded segment as ``TileIndex`` reads one: Zipf posting lists
    with random impacts, 5% of docs deleted."""
    rng = np.random.default_rng(seed)
    docs, imps, dfs = [], [], []
    for r in range(1, n_terms + 1):
        d = np.unique(rng.integers(0, n1 - 1, size=max(3, n1 // r)))
        docs.append(d.astype(np.int32))
        imps.append((rng.random(len(d)) * 2 + 0.1).astype(np.float32))
        dfs.append(len(d))
    deleted = rng.random(n1) < 0.05
    deleted[n1 - 1] = True
    host = types.SimpleNamespace(docs_flat_np=np.concatenate(docs),
                                 impacts_flat_np=np.concatenate(imps),
                                 deleted_np=deleted)
    dseg = types.SimpleNamespace(
        host=host, n1=n1, device=torch.device("cpu"), _tile_index=None,
        reader=types.SimpleNamespace(postings=types.SimpleNamespace(
            term_df=np.asarray(dfs, dtype=np.int32))))
    return tiles.TileIndex(dseg, width), host, rng


def both(arr):
    x = torch.from_numpy(np.ascontiguousarray(arr))
    return x, x.cuda()


@pytest.mark.cuda
def test_tile_ops_on_card_match_cpu():
    need_card()
    tl, host, rng = synthetic_tiles(5)
    docs_flat, imps_flat = both(host.docs_flat_np), both(host.impacts_flat_np)
    deleted_tiles = both(tl.deleted_tiles_np)
    n_q, s_pad = 24, 16
    tids = np.sort(rng.choice(40, size=12, replace=False)).astype(np.int64)
    w = np.zeros((n_q, s_pad), dtype=np.float32)
    for q in range(n_q):
        cols = rng.choice(12, size=3, replace=False)
        w[q, cols] = rng.uniform(0.5, 4.0, size=3)
    nz = np.flatnonzero(w.reshape(-1))
    w_idx = np.arange(128, dtype=np.int32) + n_q * s_pad
    w_idx[:len(nz)] = nz
    w_val = np.zeros(128, dtype=np.float32)
    w_val[:len(nz)] = w.reshape(-1)[nz]
    w_idx, w_val = both(w_idx), both(w_val)

    # wave 1: bounds
    blk_idx, slot_row, _ = tl.ub_block_tables(tids)
    ub = [tiles.ub_scorer(a, b, c, d, e, f, n_t1=tl.n_tiles + 1,
                          s_pad=s_pad, n_queries=n_q)
          for a, b, c, d, e, f in zip(
              both(tl.tile_docs_np), both(tl.tile_maxes_np), both(blk_idx),
              both(slot_row), w_idx, w_val)]
    np.testing.assert_allclose(ub[1].cpu().numpy(), ub[0].numpy(),
                               rtol=RTOL, atol=ATOL)
    # the seed selector, on the CPU's bounds on both sides
    ub_np = ub[0].numpy()[:, :tl.n_tiles]
    processed = rng.random(ub_np.shape) < 0.2
    theta = np.where(rng.random(n_q) < 0.5, -np.inf, 2.0).astype(np.float32)
    sel = [tiles.seed_select(a, b, c, c=4) for a, b, c in zip(
        both(ub_np), both(processed), both(theta))]
    for g, want in zip(sel[1], sel[0]):
        np.testing.assert_array_equal(g.cpu().numpy(), want.numpy())

    # the union run scorer: the fused kernel against its plain version
    sel_tiles = np.asarray([0, 3, 4, 9, tl.n_tiles], dtype=np.int64)
    runs = tl.run_tables(tids, sel_tiles)
    rows = rng.random((3, 8192)) < 0.5
    rows[0] = True
    fidx = rng.integers(0, 3, size=n_q).astype(np.int32)
    launches = fused_topk.COUNTS.launches
    out = []
    for i in range(2):
        frows = tiles.gather_cols(
            both(rows)[i], *tiles.tile_cols(
                both(sel_tiles.astype(np.int32))[i], tl.T, 8192), False)
        out.append(tiles.run_batch_scorer(
            docs_flat[i], imps_flat[i], deleted_tiles[i],
            both(sel_tiles.astype(np.int32))[i], both(runs["packed"])[i],
            w_idx[i], w_val[i], frows, both(fidx)[i], k=50,
            n_cols=runs["n_cols"], n_post=runs["postings"], s_pad=s_pad,
            n_queries=n_q, fmt=runs["packed_fmt"]))
    assert fused_topk.COUNTS.launches == launches + 1
    (cs, ci), (gs, gi) = out[0], [x.cpu() for x in out[1]]
    fin = torch.isfinite(cs)
    assert fin.any() and torch.equal(torch.isfinite(gs), fin)
    np.testing.assert_allclose(gs[fin].numpy(), cs[fin].numpy(), rtol=RTOL,
                               atol=ATOL)
    assert torch.equal(gi[fin], ci[fin])

    # the per-query scorer and the merge
    q_tids = np.full((n_q, 4), -1, dtype=np.int64)
    w_b = np.zeros((n_q, 4), dtype=np.float32)
    for q in range(n_q):
        q_tids[q, :3] = np.sort(rng.choice(40, size=3, replace=False))
        w_b[q, :3] = rng.uniform(0.5, 4.0, size=3)
    q_tiles = np.sort(np.stack([rng.choice(tl.n_tiles + 1, size=4,
                                           replace=False)
                                for _ in range(n_q)]).astype(np.int64), 1)
    runs = tl.run_tables_per_query(q_tids, q_tiles, 4)
    pq = [tiles.pq_run_scorer(
        docs_flat[i], imps_flat[i], deleted_tiles[i],
        both(q_tiles.astype(np.int32))[i], both(w_b)[i],
        both(runs["packed"])[i], k=10, n_cols=runs["n_cols"],
        n_post=runs["postings"], tpq_pad=4, t=tl.T, fmt=runs["packed_fmt"])
        for i in range(2)]
    np.testing.assert_allclose(pq[1][0].cpu().numpy(), pq[0][0].numpy(),
                               rtol=RTOL, atol=ATOL)
    assert torch.equal(pq[1][1].cpu(), pq[0][1])
    lims = both(rng.integers(1, 11, size=n_q).astype(np.int32))
    s_a, d_a = both(pq[0][0].numpy()), both(pq[0][1].numpy())
    s_b = both(pq[0][0].numpy()[:, ::-1])   # the same scores: all ties
    d_b = both(pq[0][1].numpy()[:, ::-1] + 1)
    merged = [tiles.topk_merge(s_a[i], d_a[i], s_b[i], d_b[i], lims[i])
              for i in range(2)]
    for g, want in zip(merged[1], merged[0]):
        assert torch.equal(g.cpu(), want)


def build_index(seed: int = 23, n_docs: int = 3000):
    rng = random.Random(seed)
    vocab = [f"w{i}" for i in range(120)]
    weights = [1.0 / (j + 1) for j in range(120)]
    idx = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY),
        Schema.from_json({
            "text_fields": [{"name": "body", "analyzer": "default",
                             "stored": False, "indexed": True}],
            "numeric_fields": [{"name": "rank", "type": "i64",
                                "stored": False, "fast": True}]}))
    writer = idx.writer()
    for i in range(n_docs):
        writer.add_document({
            "_id": str(i), "rank": rng.randint(0, 100),
            "body": " ".join(rng.choices(vocab, weights=weights,
                                         k=rng.randint(2, 30)))})
        if i in (n_docs // 3, 2 * n_docs // 3):
            writer.commit()
    writer.commit()
    writer = idx.writer()
    writer.delete_documents([str(rng.randrange(n_docs)) for _ in range(80)])
    writer.commit()
    queries = [" ".join(rng.sample(vocab, k=rng.randint(1, 5)))
               for _ in range(24)] + [" ".join(vocab[:6])]
    return idx, queries


@pytest.mark.cuda
def test_pruned_routes_on_card_match_cpu(monkeypatch):
    need_card()
    monkeypatch.setenv("SEARCHLITE_TILE_WIDTH", "128")
    monkeypatch.setenv("SEARCHLITE_PRUNE_MIN_POSTINGS", "1")
    idx, queries = build_index()
    cpu, card = idx.reader(device="cpu"), idx.reader()

    def same_pairs(got, want):
        assert [[d for d, _ in r] for r in got] == \
            [[d for d, _ in r] for r in want]
        for a, b in zip(got, want):
            np.testing.assert_allclose([s for _, s in a],
                                       [s for _, s in b], rtol=RTOL,
                                       atol=ATOL)

    filt = {"I64Range": {"field": "rank", "min": 20, "max": 70}}
    for q in queries[:8]:
        for req in ({"query": q, "limit": 10, "execution": "wand",
                     "profile": True},
                    {"query": q, "limit": 10, "execution": "bmw",
                     "filter": filt, "profile": True}):
            got, want = card.search(dict(req)), cpu.search(dict(req))
            same_pairs([[(h.doc_id, h.score) for h in got.hits]],
                       [[(h.doc_id, h.score) for h in want.hits]])
            # the counts cover the tiles each side scored: a bound that
            # rounds another way on the card may pick another tile
            assert got.total_hits_estimate >= len(got.hits)
            assert got.profile["execution"]["pruning_simulated"] is False
    assert card.single_routes["pruned"] == cpu.single_routes["pruned"] > 0
    dense = cpu.search_batch(queries, limit=10)
    for env in ({"SEARCHLITE_BATCH_PRUNE": "pq",
                 "SEARCHLITE_WAND_SPARSE_BLOCKS": "0"},
                {"SEARCHLITE_BATCH_PRUNE": "pq",
                 "SEARCHLITE_WAND_SPARSE_BLOCKS": "2"},
                {"SEARCHLITE_BATCH_PRUNE": "union"}):
        for key, val in env.items():
            monkeypatch.setenv(key, val)
        same_pairs(card.search_batch(queries, limit=10, execution="wand"),
                   dense)
        monkeypatch.delenv("SEARCHLITE_WAND_SPARSE_BLOCKS", raising=False)
    filters = [filt if i % 2 else None for i in range(len(queries))]
    same_pairs(card.search_batch(queries, limit=10, filters=filters,
                                 execution="bmw"),
               cpu.search_batch(queries, limit=10, filters=filters))
    monkeypatch.setenv("SEARCHLITE_M_BUDGET_BYTES", "4096")
    chunked = card.search({"query": queries[0], "limit": 10,
                           "execution": "bm25"})
    assert card.single_routes["chunked"] == 3
    assert [h.doc_id for h in chunked.hits] == [d for d, _ in dense[0]]


# the doc-sharded scan hands the fused kernel N = shard_width + 1: odd for
# every power-of-two doc axis, so the kernel runs its scalar loads, with a
# last partial chunk, filter rows of the same odd width, and k up to the
# shard width
@pytest.mark.cuda
@pytest.mark.parametrize("n,k,q", [(65_537, 2_000, 32), (32_769, 2_000, 32),
                                   (65_537, 10, 256), (32_769, 1_024, 64)])
def test_fused_kernel_at_shard_shapes(n, k, q):
    need_card()
    rng = np.random.default_rng(n + k)
    s = 128
    w = ((rng.random((q, s)) * 3 + 0.5)
         * (rng.random((q, s)) < 4.0 / s)).astype(np.float32)
    w[0] = 0.0
    m = (rng.random((s, n)) * (rng.random((s, n)) < 0.05)).astype(
        np.float32)
    deleted = rng.random(n) < 0.05
    deleted[n - 1] = True
    rows = rng.random((4, n)) < 0.5
    rows[0] = True
    rows[3] = False
    fidx = rng.integers(0, 3, q).astype(np.int32)
    fidx[1] = 3
    args = [torch.from_numpy(x).cuda() for x in (w, m, deleted)]
    kw = dict(k=k, filter_rows=torch.from_numpy(rows).cuda(),
              fidx=torch.from_numpy(fidx).cuda())
    launches = fused_topk.COUNTS.launches
    got_s, got_i = fused_topk.fused_topk(*args, **kw)
    assert fused_topk.COUNTS.launches == launches + 1
    ref_s, ref_i = fused_topk.fused_topk_plain(*args, **kw)
    got_s, got_i = got_s.cpu().numpy(), got_i.cpu().numpy()
    ref_s, ref_i = ref_s.cpu().numpy(), ref_i.cpu().numpy()
    fin = np.isfinite(ref_s)
    assert np.array_equal(np.isfinite(got_s), fin) and fin.any()
    assert np.allclose(got_s[fin], ref_s[fin], rtol=RTOL, atol=ATOL)
    tol = ATOL + RTOL * np.abs(np.where(fin, ref_s, 0.0))
    gap = np.full(ref_s.shape, np.inf)
    with np.errstate(invalid="ignore"):
        diff = np.abs(np.diff(ref_s, axis=1))
    gap[:, 1:] = np.minimum(gap[:, 1:], diff)
    gap[:, :-1] = np.minimum(gap[:, :-1], diff)
    clear = fin & (gap > tol)
    assert np.array_equal(got_i[clear], ref_i[clear])
    assert np.isneginf(got_s[0]).all() and np.isneginf(got_s[1]).all()
    assert (got_i[~fin] == n - 1).all()
    # no filtered-out or deleted doc comes back
    ok = rows[fidx][np.arange(q)[:, None], got_i] & ~deleted[got_i]
    assert ok[fin].all()
