"""Pruned execution of the torch port's reader (``execution`` wand / bmw,
the chunked executor; searchlite_tpu_torch/api/reader.py, ``device="cpu"``)
against its own ``bm25`` route and against the JAX reader, both readers
open on one index directory: three segments, duplicate docs (exact score
ties), tombstones, ``SEARCHLITE_TILE_WIDTH=128`` so that the small corpus
spans several tiles.

After tests/test_pruning.py and tests/test_chunked.py. Hits must be the
same docs in the same order (ties doc-ascending); scores agree within
rtol 1e-6 / atol 1e-4 (f32_strict: the routes sum in their own orders);
the pruned route's counters (``postings_advanced``, ``total_hits_estimate``,
``pruning_simulated``) equal the JAX reader's."""

import numpy as np
import pytest
import torch

import searchlite_tpu.api.reader as jax_reader_mod
import searchlite_tpu_torch.api.reader as reader_mod
from searchlite_tpu_torch.errors import QueryError
from test_torch_tiles import build_corpus, open_readers

RTOL, ATOL = 1e-6, 1e-4


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_pruned")
    vocab, rng = build_corpus(path, seed=11)
    jreader, treader = open_readers(path)
    queries = [" ".join(rng.sample(vocab, k=rng.randint(1, 4)))
               for _ in range(12)]
    queries.append(" ".join(vocab[:6]))  # a head-heavy disjunction
    return {"path": path, "vocab": vocab, "jax": jreader, "torch": treader,
            "queries": queries}


@pytest.fixture(autouse=True)
def env(monkeypatch):
    monkeypatch.setenv("SEARCHLITE_PRECISION", "f32_strict")
    monkeypatch.setenv("SEARCHLITE_TILE_WIDTH", "128")


def close(a, b) -> bool:
    return abs(a - b) <= ATOL + RTOL * abs(b)


def assert_hits_equal(got, want, where=""):
    assert [h.doc_id for h in got.hits] == [h.doc_id for h in want.hits], \
        where
    for g, w in zip(got.hits, want.hits):
        assert close(g.score, w.score), (where, g.score, w.score)


def assert_pairs_equal(got, want, where=""):
    assert len(got) == len(want)
    for qi, (a, b) in enumerate(zip(got, want)):
        assert [d for d, _ in a] == [d for d, _ in b], (where, qi)
        for (_, sa), (_, sb) in zip(a, b):
            assert close(sa, sb), (where, qi, sa, sb)


def cursor_parts(reader, res, req):
    """The decoded ``next_cursor`` of a score-sorted page."""
    if res.next_cursor is None:
        return None
    mod = reader_mod if reader.__class__.__module__.startswith(
        "searchlite_tpu_torch") else jax_reader_mod
    plan = mod.SortPlan.from_request(reader.schema, None)
    state = mod.decode_cursor(res.next_cursor, reader.generation, plan, True)
    key = state["key"]
    return (state["returned"], key.segment_ord, key.doc_id,
            float(key.parts[0]))


# -- single queries ------------------------------------------------------------


@pytest.mark.parametrize("strategy", ["wand", "bmw"])
@pytest.mark.parametrize("query_i", range(13))
def test_single_pruned_matches_bm25_and_jax(corpus, query_i, strategy,
                                            monkeypatch):
    monkeypatch.setenv("SEARCHLITE_PRUNE_MIN_POSTINGS", "1")
    jreader, treader = corpus["jax"], corpus["torch"]
    query = corpus["queries"][query_i]
    base = treader.search({"query": query, "limit": 10,
                           "execution": "bm25", "profile": True})
    before = dict(treader.single_routes)
    req = {"query": query, "limit": 10, "execution": strategy,
           "profile": True}
    got = treader.search(dict(req))
    want = jreader.search(dict(req))
    n_seg = treader.single_routes["pruned"] - before["pruned"]
    assert n_seg > 0 and treader.single_routes["dense"] == before["dense"]
    assert_hits_equal(got, base, (strategy, query))
    assert_hits_equal(got, want, (strategy, query))
    # the pruned route's own counters, equal to the JAX reader's
    assert got.total_hits_estimate == want.total_hits_estimate
    assert got.total_hits_estimate <= base.total_hits_estimate
    gprof, wprof = got.profile["execution"], want.profile["execution"]
    assert gprof["pruning_simulated"] is False
    assert gprof == wprof
    assert gprof["postings_advanced"] <= \
        base.profile["execution"]["postings_advanced"]
    assert (got.next_cursor is None) == (want.next_cursor is None)
    gc, wc = (cursor_parts(treader, got, req),
              cursor_parts(jreader, want, req))
    if gc is not None:
        assert gc[:3] == wc[:3] and close(gc[3], wc[3])


def test_default_threshold_keeps_small_segments_dense(corpus):
    """Under SEARCHLITE_PRUNE_MIN_POSTINGS (100,000) a wand request runs
    the dense executor and says so: ``pruning_simulated`` true, the
    counterfactual postings model."""
    jreader, treader = corpus["jax"], corpus["torch"]
    before = dict(treader.single_routes)
    req = {"query": corpus["queries"][0], "limit": 10, "profile": True}
    got, want = treader.search(dict(req)), jreader.search(dict(req))
    assert treader.single_routes["pruned"] == before["pruned"]
    assert treader.single_routes["dense"] > before["dense"]
    assert_hits_equal(got, want)
    assert got.profile["execution"] == want.profile["execution"]
    assert got.profile["execution"]["pruning_simulated"] is True


STRUCTURED = {
    "min_should_match": {"query": {
        "type": "bool",
        "should": [{"type": "term", "field": "body", "value": f"w{i}"}
                   for i in range(5)],
        "minimum_should_match": 2}, "limit": 10},
    "must_not": {"query": {
        "type": "bool",
        "must": [{"type": "term", "field": "body", "value": "w3"}],
        "must_not": [{"type": "term", "field": "body", "value": "w0"}]},
        "limit": 10},
    "keyword_filter": {"query": "w1 w2 w3", "limit": 10,
                       "filter": {"KeywordEq": {"field": "cat",
                                                "value": "b"}}},
    "range_filter": {"query": "w4 w5", "limit": 10,
                     "filter": {"I64Range": {"field": "rank", "min": 20,
                                             "max": 70}}},
    "dis_max": {"query": {"type": "dis_max", "tie_breaker": 0.3,
                          "queries": [
                              {"type": "term", "field": "body",
                               "value": "w2"},
                              {"type": "term", "field": "body",
                               "value": "w7"}]}, "limit": 10},
    "bool_filter_phrase": {"query": {
        "type": "bool",
        "must": [{"type": "term", "field": "body", "value": "w1"}],
        "filter": [{"KeywordIn": {"field": "cat", "values": ["a", "c"]}}]},
        "limit": 7},
}


@pytest.mark.parametrize("strategy", ["wand", "bmw"])
@pytest.mark.parametrize("name", sorted(STRUCTURED))
def test_single_pruned_with_filters_and_msm(corpus, name, strategy,
                                            monkeypatch):
    monkeypatch.setenv("SEARCHLITE_PRUNE_MIN_POSTINGS", "1")
    jreader, treader = corpus["jax"], corpus["torch"]
    req = STRUCTURED[name]
    base = treader.search(dict(req, execution="bm25"))
    before = treader.single_routes["pruned"]
    got = treader.search(dict(req, execution=strategy))
    want = jreader.search(dict(req, execution=strategy))
    assert treader.single_routes["pruned"] > before
    assert_hits_equal(got, base, name)
    assert_hits_equal(got, want, name)
    assert got.total_hits_estimate == want.total_hits_estimate


@pytest.mark.parametrize("size", [64, 128, 300, 4096])
def test_bmw_block_size_knob(corpus, size, monkeypatch):
    monkeypatch.setenv("SEARCHLITE_PRUNE_MIN_POSTINGS", "1")
    monkeypatch.delenv("SEARCHLITE_TILE_WIDTH")
    jreader, treader = corpus["jax"], corpus["torch"]
    query = " ".join(corpus["vocab"][:4])
    base = treader.search({"query": query, "limit": 10,
                           "execution": "bm25"})
    req = {"query": query, "limit": 10, "execution": "bmw",
           "bmw_block_size": size}
    got, want = treader.search(dict(req)), jreader.search(dict(req))
    assert_hits_equal(got, base, size)
    assert_hits_equal(got, want, size)
    assert got.total_hits_estimate == want.total_hits_estimate
    width = max(128, -(-size // 128) * 128)
    assert treader.device_segments[0]._tile_index.T == width


def test_seed_tiles_env_and_survivor_wave(corpus, monkeypatch):
    """One seed tile leaves the real work to the survivor wave; a huge
    seed skips it. Both are exact and count what JAX counts."""
    monkeypatch.setenv("SEARCHLITE_PRUNE_MIN_POSTINGS", "1")
    jreader, treader = corpus["jax"], corpus["torch"]
    for seeds in ("1", "1000"):
        monkeypatch.setenv("SEARCHLITE_SEED_TILES", seeds)
        for query in corpus["queries"][:4]:
            req = {"query": query, "limit": 10, "execution": "wand",
                   "profile": True}
            base = treader.search(dict(req, execution="bm25"))
            got, want = treader.search(dict(req)), jreader.search(dict(req))
            assert_hits_equal(got, base, (seeds, query))
            assert got.profile["execution"] == want.profile["execution"]
            assert got.total_hits_estimate == want.total_hits_estimate


def test_negative_weight_falls_back_to_dense(corpus, monkeypatch):
    """A negative leaf weight breaks the upper bound: the pruned job gives
    the segment back and the dense executor answers (the planner rejects
    negative boosts, so the weight is forced in below the planner)."""
    monkeypatch.setenv("SEARCHLITE_PRUNE_MIN_POSTINGS", "1")
    jreader, treader = corpus["jax"], corpus["torch"]

    def negate(orig):
        def wrapped(self, *args, **kwargs):
            out = orig(self, *args, **kwargs)
            if out["n_slots"] > 1:
                out["w_leaf"][:, 0] *= -1.0
            return out
        return wrapped

    monkeypatch.setattr(reader_mod.IndexReader, "_segment_query_args",
                        negate(reader_mod.IndexReader._segment_query_args))
    monkeypatch.setattr(
        jax_reader_mod.IndexReader, "_segment_query_args",
        negate(jax_reader_mod.IndexReader._segment_query_args))
    before = dict(treader.single_routes)
    req = {"query": "w0 w1 w5", "limit": 10, "execution": "wand",
           "profile": True}
    got, want = treader.search(dict(req)), jreader.search(dict(req))
    assert treader.single_routes["pruned"] == before["pruned"]
    assert treader.single_routes["dense"] - before["dense"] == 3
    assert_hits_equal(got, want)
    assert got.total_hits_estimate == want.total_hits_estimate
    assert got.profile["execution"]["pruning_simulated"] is True


def test_cursor_and_custom_scoring_do_not_prune(corpus, monkeypatch):
    monkeypatch.setenv("SEARCHLITE_PRUNE_MIN_POSTINGS", "1")
    jreader, treader = corpus["jax"], corpus["torch"]
    req = {"query": "w1 w3 w8", "limit": 7, "execution": "wand"}
    first = treader.search(dict(req))
    before = dict(treader.single_routes)
    page2 = treader.search(dict(req, cursor=first.next_cursor))
    want2 = jreader.search(dict(
        req, cursor=jreader.search(dict(req)).next_cursor))
    assert treader.single_routes["pruned"] == before["pruned"]
    assert_hits_equal(page2, want2)
    fs = {"query": {"type": "function_score",
                    "query": {"type": "term", "field": "body",
                              "value": "w2"},
                    "functions": [{"type": "field_value_factor",
                                   "field": "rank", "factor": 0.1}]},
          "limit": 10, "execution": "bmw"}
    assert_hits_equal(treader.search(dict(fs)), jreader.search(dict(fs)))
    assert treader.single_routes["pruned"] == before["pruned"]


# -- the chunked executor ------------------------------------------------------

CHUNKED = [
    {"query": "w1 w5 w9", "limit": 10},
    {"query": "w2", "limit": 10,
     "filter": {"KeywordEq": {"field": "cat", "value": "b"}}},
    {"query": "w0 w3", "limit": 10,
     "sort": [{"field": "rank", "order": "asc"},
              {"field": "_score", "order": "desc"}]},
    {"query": {"type": "bool",
               "must": [{"type": "term", "field": "body", "value": "w2"}],
               "must_not": [{"type": "term", "field": "body",
                             "value": "w0"}]}, "limit": 10},
    {"query": {"type": "function_score",
               "query": {"type": "term", "field": "body", "value": "w4"},
               "functions": [{"type": "field_value_factor",
                              "field": "rank", "factor": 0.1,
                              "modifier": "log1p"}]}, "limit": 10},
    {"query": "w6 w2", "limit": 5, "collapse": {"field": "cat"}},
]
# s_pad 8 x n1 512 x 4 bytes = 16 KiB a segment: over this budget, and one
# 128-doc tile a chunk
CHUNK_BUDGET = "4096"


@pytest.mark.parametrize("req_i", range(len(CHUNKED)))
def test_chunked_matches_dense_and_jax(corpus, req_i, monkeypatch):
    jreader, treader = corpus["jax"], corpus["torch"]
    req = dict(CHUNKED[req_i], execution="bm25")
    base = treader.search(dict(req))
    monkeypatch.setenv("SEARCHLITE_M_BUDGET_BYTES", CHUNK_BUDGET)
    before = dict(treader.single_routes)
    waves = treader.tile_stats["wave_launches"]
    got, want = treader.search(dict(req)), jreader.search(dict(req))
    assert treader.single_routes["chunked"] - before["chunked"] == 3
    assert treader.single_routes["dense"] == before["dense"]
    assert treader.tile_stats["wave_launches"] - waves == 12  # 3 x 4 tiles
    for other in (base, want):
        assert_hits_equal(got, other, req_i)
        assert got.total_hits_estimate == other.total_hits_estimate
        assert got.total_groups == other.total_groups


def test_chunked_cursor_pagination(corpus, monkeypatch):
    jreader, treader = corpus["jax"], corpus["torch"]
    req = {"query": "w1 w3 w8", "limit": 7, "execution": "bm25"}

    def drain(reader):
        pages, cursor = [], None
        for _ in range(4):
            r = reader.search(dict(req, **({"cursor": cursor} if cursor
                                           else {})))
            pages.append([h.doc_id for h in r.hits])
            cursor = r.next_cursor
            if cursor is None:
                break
        return pages

    dense = drain(treader)
    monkeypatch.setenv("SEARCHLITE_M_BUDGET_BYTES", CHUNK_BUDGET)
    before = treader.single_routes["chunked"]
    assert drain(treader) == dense == drain(jreader)
    assert treader.single_routes["chunked"] > before


def test_chunked_with_pruning_preference(corpus, monkeypatch):
    """Over the budget, execution=bmw prefers the pruned path at any
    posting count; the hits are the dense ones, the total may undercount."""
    jreader, treader = corpus["jax"], corpus["torch"]
    req = {"query": "w1 w5 w9", "limit": 10}
    base = treader.search(dict(req, execution="bm25"))
    monkeypatch.setenv("SEARCHLITE_M_BUDGET_BYTES", CHUNK_BUDGET)
    before = dict(treader.single_routes)
    got = treader.search(dict(req, execution="bmw"))
    want = jreader.search(dict(req, execution="bmw"))
    assert treader.single_routes["pruned"] - before["pruned"] == 3
    assert treader.single_routes["chunked"] == before["chunked"]
    assert_hits_equal(got, base)
    assert_hits_equal(got, want)
    assert got.total_hits_estimate == want.total_hits_estimate \
        <= base.total_hits_estimate


# -- batches -------------------------------------------------------------------


@pytest.mark.parametrize("strategy", ["wand", "bmw"])
@pytest.mark.parametrize("limit", [1, 10, 37])
@pytest.mark.parametrize("mode", [pytest.param("pq", id="per_query"),
                                  "union"])
def test_batch_pruned_matches_bm25_and_jax(corpus, mode, limit, strategy,
                                           monkeypatch):
    monkeypatch.setenv("SEARCHLITE_BATCH_PRUNE", mode)
    jreader, treader = corpus["jax"], corpus["torch"]
    queries = corpus["queries"] + ["missing-term", corpus["vocab"][0], ""]
    dense = treader.search_batch(queries, limit=limit)
    got = treader.search_batch(queries, limit=limit, execution=strategy)
    want = jreader.search_batch(queries, limit=limit, execution=strategy)
    assert_pairs_equal(got, dense, (mode, limit, strategy))
    assert_pairs_equal(got, want, (mode, limit, strategy))


@pytest.mark.parametrize("seed_c", ["1", "1000"])
def test_batch_pq_seed_extremes(corpus, seed_c, monkeypatch):
    """``SEARCHLITE_SEED_TILES_PER_QUERY`` 1 forces many survivor rounds,
    a large value one round; the tile waves are pinned on (no row rides
    the strips)."""
    monkeypatch.setenv("SEARCHLITE_BATCH_PRUNE", "pq")
    monkeypatch.setenv("SEARCHLITE_WAND_SPARSE_BLOCKS", "0")
    monkeypatch.setenv("SEARCHLITE_SEED_TILES_PER_QUERY", seed_c)
    jreader, treader = corpus["jax"], corpus["torch"]
    queries = corpus["queries"] + [corpus["vocab"][0], "missing-term"]
    limits = [1 + (7 * i) % 25 for i in range(len(queries))]
    dense = treader.search_batch(queries, limit=30, limits=limits)
    rounds = treader.tile_stats["rounds"]
    strips = treader.route_rows["strip"]
    got = treader.search_batch(queries, limit=30, limits=limits,
                               execution="bmw")
    want = jreader.search_batch(queries, limit=30, limits=limits,
                                execution="bmw")
    assert treader.route_rows["strip"] == strips
    n_rounds = treader.tile_stats["rounds"] - rounds
    assert n_rounds > 3 if seed_c == "1" else n_rounds == 3
    assert [len(r) for r in got] == [len(r) for r in dense]
    assert_pairs_equal(got, dense, seed_c)
    assert_pairs_equal(got, want, seed_c)


@pytest.mark.parametrize("seeds", ["1", "1000"])
def test_batch_union_seed_extremes(corpus, seeds, monkeypatch):
    monkeypatch.setenv("SEARCHLITE_BATCH_PRUNE", "union")
    monkeypatch.setenv("SEARCHLITE_SEED_TILES", seeds)
    jreader, treader = corpus["jax"], corpus["torch"]
    queries = corpus["queries"]
    dense = treader.search_batch(queries, limit=10)
    got = treader.search_batch(queries, limit=10, execution="bmw")
    assert_pairs_equal(got, dense, seeds)
    assert_pairs_equal(got, jreader.search_batch(queries, limit=10,
                                                 execution="bmw"), seeds)


def test_batch_pq_memory_capped_rounds(corpus, monkeypatch):
    """A small M budget caps the tiles a round may take; exactness
    survives the extra rounds."""
    monkeypatch.setenv("SEARCHLITE_BATCH_PRUNE", "pq")
    monkeypatch.setenv("SEARCHLITE_WAND_SPARSE_BLOCKS", "0")
    jreader, treader = corpus["jax"], corpus["torch"]
    queries = corpus["queries"]
    dense = treader.search_batch(queries, limit=10)
    monkeypatch.setenv("SEARCHLITE_M_BUDGET_BYTES", "200000")
    rounds = treader.tile_stats["rounds"]
    got = treader.search_batch(queries, limit=10, execution="wand")
    assert treader.tile_stats["rounds"] - rounds > 3
    assert_pairs_equal(got, dense)
    assert_pairs_equal(got, jreader.search_batch(queries, limit=10,
                                                 execution="wand"))


@pytest.mark.parametrize("cap", ["1", "2", "512"])
def test_batch_pq_light_heavy_split(corpus, cap, monkeypatch):
    """Light rows ride the candidate strips, heavy ones the tile waves,
    both live in one batch (the row-recombination contract)."""
    monkeypatch.setenv("SEARCHLITE_BATCH_PRUNE", "pq")
    monkeypatch.setenv("SEARCHLITE_WAND_SPARSE_BLOCKS", cap)
    jreader, treader = corpus["jax"], corpus["torch"]
    queries = corpus["queries"] + [corpus["vocab"][0], "missing-term", ""]
    limits = [1 + (5 * i) % 20 for i in range(len(queries))]
    dense = treader.search_batch(queries, limit=20, limits=limits)
    rows = dict(treader.route_rows)
    got = treader.search_batch(queries, limit=20, limits=limits,
                               execution="wand")
    strip = treader.route_rows["strip"] - rows["strip"]
    tiles = treader.route_rows["tiles"] - rows["tiles"]
    assert strip > 0
    assert (tiles == 0) if cap == "512" else (tiles > 0)
    assert_pairs_equal(got, dense, cap)
    assert_pairs_equal(got, jreader.search_batch(
        queries, limit=20, limits=limits, execution="wand"), cap)


def test_filtered_batches_take_the_union_path(corpus, monkeypatch):
    jreader, treader = corpus["jax"], corpus["torch"]
    queries = corpus["queries"][:8]
    flt = {"KeywordEq": {"field": "cat", "value": "a"}}
    rng_f = {"I64Range": {"field": "rank", "min": 10, "max": 60}}
    filters = [flt if i % 3 == 0 else rng_f if i % 3 == 1 else None
               for i in range(len(queries))]
    calls = []
    orig = reader_mod.IndexReader._search_batch_pruned_many

    def spy(self, *args, **kwargs):
        calls.append(1)
        return orig(self, *args, **kwargs)

    monkeypatch.setattr(reader_mod.IndexReader,
                        "_search_batch_pruned_many", spy)
    dense = treader.search_batch(queries, limit=10, filters=filters)
    for strategy in ("wand", "bmw"):
        got = treader.search_batch(queries, limit=10, filters=filters,
                                   execution=strategy)
        assert_pairs_equal(got, dense, strategy)
        assert_pairs_equal(got, jreader.search_batch(
            queries, limit=10, filters=filters, execution=strategy))
    assert len(calls) == 2
    # every filtered hit passes its filter
    single = treader.search({"query": queries[0], "limit": 10,
                             "filter": flt, "execution": "bm25"})
    assert [d for d, _ in dense[0]] == [h.doc_id for h in single.hits]


@pytest.mark.parametrize("mode", [pytest.param("pq", id="per_query"),
                                  "union"])
def test_explicit_runs_format(corpus, mode, monkeypatch):
    """``SEARCHLITE_RUNS_FMT=4`` sends the explicit [4, r_pad] run upload
    through every pruned path."""
    monkeypatch.setenv("SEARCHLITE_BATCH_PRUNE", mode)
    monkeypatch.setenv("SEARCHLITE_WAND_SPARSE_BLOCKS", "0")
    monkeypatch.setenv("SEARCHLITE_PRUNE_MIN_POSTINGS", "1")
    treader = corpus["torch"]
    queries = corpus["queries"]
    dense = treader.search_batch(queries, limit=10)
    base = treader.search({"query": queries[0], "limit": 10,
                           "execution": "bm25"})
    monkeypatch.setenv("SEARCHLITE_RUNS_FMT", "4")
    for strategy in ("wand", "bmw"):
        assert_pairs_equal(treader.search_batch(
            queries, limit=10, execution=strategy), dense, strategy)
    assert_hits_equal(treader.search({"query": queries[0], "limit": 10,
                                      "execution": "bmw"}), base)


def test_waves_chunked_by_a_small_budget(corpus, monkeypatch):
    """A tiny M budget splits every exact-scoring wave into several chunk
    launches, batched and single; results stay the dense ones."""
    monkeypatch.setenv("SEARCHLITE_BATCH_PRUNE", "union")
    monkeypatch.setenv("SEARCHLITE_PRUNE_MIN_POSTINGS", "1")
    jreader, treader = corpus["jax"], corpus["torch"]
    queries = corpus["queries"]
    dense = treader.search_batch(queries, limit=10)
    singles = [treader.search({"query": q, "limit": 10,
                               "execution": "bm25"}) for q in queries[:4]]
    monkeypatch.setenv("SEARCHLITE_M_BUDGET_BYTES", "131072")
    ub, waves = (treader.tile_stats["ub_launches"],
                 treader.tile_stats["wave_launches"])
    got = treader.search_batch(queries, limit=10, execution="bmw")
    # 3 segments, one UB launch each, more than one chunk a wave
    assert treader.tile_stats["ub_launches"] - ub == 3
    assert treader.tile_stats["wave_launches"] - waves > 3
    assert_pairs_equal(got, dense)
    assert_pairs_equal(got, jreader.search_batch(queries, limit=10,
                                                 execution="bmw"))
    monkeypatch.setenv("SEARCHLITE_M_BUDGET_BYTES", "40000")
    for q, exp in zip(queries[:4], singles):
        assert_hits_equal(treader.search(
            {"query": q, "limit": 10, "execution": "bmw"}), exp, q)


def test_plan_wave_chunks_equal_jax(corpus, monkeypatch):
    """The wave budgets split a tile set where the JAX reader splits it."""
    from searchlite_tpu.ops.tiles import get_tile_index as jax_tile_index
    from searchlite_tpu_torch.ops.tiles import get_tile_index

    jdseg = corpus["jax"].device_segments[0]
    tdseg = corpus["torch"].device_segments[0]
    jtl, ttl = jax_tile_index(jdseg, 128), get_tile_index(tdseg, 128)
    tids = np.arange(6, dtype=np.int64)
    tiles = np.arange(jtl.n_tiles, dtype=np.int64)
    for budget in ("40000", "131072", "1000000"):
        monkeypatch.setenv("SEARCHLITE_M_BUDGET_BYTES", budget)
        want = jax_reader_mod.IndexReader._plan_wave_chunks(
            jtl, tids, tiles, 64)
        got = reader_mod.IndexReader._plan_wave_chunks(ttl, tids, tiles, 64)
        assert [c.tolist() for c in got] == [c.tolist() for c in want]
    assert len(got) == 1 and len(reader_mod.IndexReader._plan_wave_chunks(
        ttl, tids, tiles, 8)) == 1


@pytest.mark.parametrize("path", ["union", "single"])
def test_oom_on_first_launch_evicts_and_retries(corpus, path, monkeypatch):
    """An injected ``torch.OutOfMemoryError`` on the first wave launches
    evicts the rebuildable device caches and retries the same launch;
    results stay exact. Any other error is not caught."""
    monkeypatch.setenv("SEARCHLITE_BATCH_PRUNE", "union")
    monkeypatch.setenv("SEARCHLITE_PRUNE_MIN_POSTINGS", "1")
    treader = corpus["torch"]
    queries = corpus["queries"][:8]
    dseg = treader.device_segments[0]
    dseg.dense_rows(2 * 1024**3)  # eviction targets
    dseg.flat_postings()
    assert dseg._dense_rows and dseg._flat_postings is not None
    fails = {"left": 2, "error": torch.OutOfMemoryError}

    if path == "union":
        dense = treader.search_batch(queries, limit=10)
        orig = reader_mod.IndexReader._launch_tile_runs_one

        def flaky(self, *args, **kwargs):
            if fails["left"] > 0:
                fails["left"] -= 1
                raise fails["error"]("CUDA out of memory (injected)")
            return orig(self, *args, **kwargs)

        monkeypatch.setattr(reader_mod.IndexReader,
                            "_launch_tile_runs_one", flaky)

        def run():
            return treader.search_batch(queries, limit=10, execution="bmw")

        check = lambda got: assert_pairs_equal(got, dense)  # noqa: E731
    else:
        dense = treader.search({"query": queries[0], "limit": 10,
                                "execution": "bm25"})
        from searchlite_tpu_torch.ops.score import CompiledQuery

        orig = CompiledQuery.tile_execute

        def flaky(self, *args, **kwargs):
            if fails["left"] > 0:
                fails["left"] -= 1
                raise fails["error"]("CUDA out of memory (injected)")
            return orig(self, *args, **kwargs)

        monkeypatch.setattr(CompiledQuery, "tile_execute", flaky)

        def run():
            return treader.search({"query": queries[0], "limit": 10,
                                   "execution": "bmw"})

        check = lambda got: assert_hits_equal(got, dense)  # noqa: E731

    got = run()
    assert fails["left"] == 0
    assert not dseg._dense_rows  # evicted (the launch re-uploads the rest)
    check(got)
    fails.update(left=1, error=RuntimeError)
    with pytest.raises(RuntimeError, match="injected"):
        run()


def test_oom_past_the_launch_reruns_the_pass(corpus, monkeypatch):
    """An out-of-memory error outside a wave launch (a fetch, a merge)
    re-runs the whole pruned pass once after the eviction."""
    treader = corpus["torch"]
    queries = corpus["queries"][:6]
    dense = treader.search_batch(queries, limit=10)
    fails = {"left": 1}
    orig = reader_mod.IndexReader._search_batch_pruned_pq

    def flaky(self, *args, **kwargs):
        out = orig(self, *args, **kwargs)
        if fails["left"] > 0:
            fails["left"] -= 1
            raise torch.OutOfMemoryError("CUDA out of memory (injected)")
        return out

    monkeypatch.setattr(reader_mod.IndexReader, "_search_batch_pruned_pq",
                        flaky)
    assert_pairs_equal(treader.search_batch(queries, limit=10,
                                            execution="wand"), dense)
    assert fails["left"] == 0


def test_unknown_execution_raises(corpus):
    treader = corpus["torch"]
    with pytest.raises(QueryError):
        treader.search_batch(["w1"], limit=5, execution="turbo")
    with pytest.raises(QueryError):
        treader.search_batch_many([["w1"]], limit=5, execution="")


@pytest.mark.parametrize("mode", ["auto", "union"])
def test_wand_stream_arrays_equal_bm25(corpus, mode, monkeypatch):
    """A coalesced stream of batches in arrays form: the same (scores,
    doc ords, seg ords) as ``bm25``, and as the JAX reader's wand."""
    monkeypatch.setenv("SEARCHLITE_BATCH_PRUNE", mode)
    jreader, treader = corpus["jax"], corpus["torch"]
    queries = corpus["queries"]
    batches = [queries[:5], queries[5:9], queries[9:]]
    limits = [None, [3, 1, 10, 7], None]
    kw = dict(limit=10, limits=limits, output="arrays")
    dense = treader.search_batch_many(batches, **kw)
    got = treader.search_batch_many(batches, execution="wand", **kw)
    want = jreader.search_batch_many(batches, execution="wand", **kw)
    assert len(got) == len(batches)
    for (gs, gd, gg), (ds, dd, dg), (ws, wd, wg) in zip(got, dense, want):
        assert gs.shape == ds.shape == ws.shape
        fin = np.isfinite(ds)
        np.testing.assert_array_equal(np.isfinite(gs), fin)
        np.testing.assert_array_equal(np.isfinite(ws), fin)
        np.testing.assert_allclose(gs[fin], ds[fin], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(gs[fin], ws[fin], rtol=RTOL, atol=ATOL)
        for a, b in ((gd, dd), (gg, dg), (gd, wd), (gg, wg)):
            np.testing.assert_array_equal(a[fin], b[fin])


def test_large_corpus_hint_routes_wand_to_the_strips(corpus, monkeypatch):
    """Where every segment holds at least ``SEARCHLITE_BATCH_STRIP_MIN_DOCS``
    docs, auto mode treats wand as a hint and runs the bm25 routes;
    ``SEARCHLITE_BATCH_PRUNE=pq`` pins the tile path."""
    monkeypatch.setenv("SEARCHLITE_BATCH_STRIP_MIN_DOCS", "100")
    treader = corpus["torch"]
    queries = corpus["queries"]
    dense = treader.search_batch(queries, limit=10)
    ub = treader.tile_stats["ub_launches"]
    assert_pairs_equal(treader.search_batch(queries, limit=10,
                                            execution="wand"), dense)
    assert treader.tile_stats["ub_launches"] == ub
    monkeypatch.setenv("SEARCHLITE_BATCH_PRUNE", "pq")
    monkeypatch.setenv("SEARCHLITE_WAND_SPARSE_BLOCKS", "0")
    assert_pairs_equal(treader.search_batch(queries, limit=10,
                                            execution="wand"), dense)
    assert treader.tile_stats["ub_launches"] > ub
