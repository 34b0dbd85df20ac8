"""Vector and hybrid search of the torch port (``ops/vector.py::vector_topk``
and the reader's vector plan, ``device="cpu"``) against the JAX package:
the same numpy vectors, masks and queries through both.

Tolerances: ids equal (equal scores: lowest doc first, as
``jax.lax.top_k``); scores rtol 1e-5, atol 1e-6 (f32 dot products summed
in another order; for ``int8`` the integer dot is exact in both and only
the f32 rescale differs in the last ulp). The requests are those of the
JAX package's vector tests, plus cursors, collapse and aggregations under
a vector-only request.
"""

import numpy as np
import pytest

from searchlite_tpu.api.types import IndexOptions, StorageType
from searchlite_tpu.errors import QueryError as JaxQueryError
from searchlite_tpu.index import Index
from searchlite_tpu.index.manifest import Schema
from searchlite_tpu.index.segment import VectorData as JaxVectorData
from searchlite_tpu.ops import vector as jax_vector
from searchlite_tpu_torch.api.reader import IndexReader
from searchlite_tpu_torch.errors import QueryError
from searchlite_tpu_torch.index.segment import VectorData
from searchlite_tpu_torch.ops import vector as port_vector

RTOL, ATOL = 1e-5, 1e-6


def both_topk(vecs, present, mask, queries, k, metric, quant):
    ref = jax_vector.vector_topk(
        JaxVectorData(dim=vecs.shape[1], metric=metric, vectors=vecs,
                      present=present),
        mask, queries, k, metric, quantization=quant)
    got = port_vector.vector_topk(
        VectorData(dim=vecs.shape[1], metric=metric, vectors=vecs,
                   present=present),
        mask, queries, k, metric, quantization=quant, device="cpu")
    return got, ref


def assert_topk_equal(got, ref):
    gs, gi = got
    rs, ri = ref
    assert gs.shape == rs.shape and gi.shape == ri.shape
    assert gs.dtype == np.float32 and gi.dtype == np.int64
    fin = np.isfinite(rs)
    assert np.array_equal(np.isfinite(gs), fin)
    assert np.allclose(gs[fin], rs[fin], rtol=RTOL, atol=ATOL)
    # ids equal away from near-ties of the reference's neighbours
    tol = ATOL + RTOL * np.abs(np.where(fin, rs, 0.0))
    gap = np.full(rs.shape, np.inf)
    with np.errstate(invalid="ignore"):
        diff = np.abs(np.diff(rs, axis=1))
    gap[:, 1:] = np.minimum(gap[:, 1:], diff)
    gap[:, :-1] = np.minimum(gap[:, :-1], diff)
    clear = fin & ((gap > 2 * tol) | (gap == 0))
    assert np.array_equal(gi[clear], ri[clear])


@pytest.mark.parametrize("metric", ["cosine", "l2"])
@pytest.mark.parametrize("quant", [None, "bf16", "int8"])
def test_vector_topk_matches_jax(metric, quant):
    rng = np.random.default_rng(11)
    n, dim = 3000, 24
    vecs = rng.normal(size=(n, dim)).astype(np.float32)
    if metric == "cosine":
        vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    present = rng.random(n) < 0.9
    mask = rng.random(n) < 0.7
    queries = rng.normal(size=(3, dim)).astype(np.float32)
    got, ref = both_topk(vecs, present, mask, queries, 50, metric, quant)
    assert_topk_equal(got, ref)
    ok = present & mask
    assert ok[got[1]].all()


@pytest.mark.parametrize("quant", [None, "bf16", "int8"])
def test_quantized_scores_match_numpy_on_the_same_values(quant):
    """Against numpy f64 run on the SAME quantized operands: bf16 x bf16
    products and int8 x int8 sums are exact, so only the f32 sum order
    (and for int8 the f32 rescale) separates the two."""
    import torch

    rng = np.random.default_rng(12)
    n, dim = 500, 16
    vecs = rng.normal(size=(n, dim)).astype(np.float32)
    query = rng.normal(size=(1, dim)).astype(np.float32)
    vdata = VectorData(dim=dim, metric="cosine", vectors=vecs,
                       present=np.ones(n, dtype=bool))
    scores, ids = port_vector.vector_topk(
        vdata, np.ones(n, dtype=bool), query, 10, "cosine",
        quantization=quant, device="cpu")
    if quant == "int8":
        qv, vs = port_vector.quantize_int8(vecs)
        qq, qs = port_vector.quantize_int8(query)
        sims = (qq.astype(np.int64) @ qv.astype(np.int64).T).astype(
            np.float32) * (qs[:, None] * vs[None, :])
    else:
        def rounded(x):
            t = torch.from_numpy(x)
            if quant == "bf16":
                t = t.to(torch.bfloat16)
            return t.to(torch.float64).numpy()

        sims = rounded(query) @ rounded(vecs).T
    order = np.argsort(-sims[0], kind="stable")[:10]
    assert np.array_equal(ids[0], order)
    assert np.allclose(scores[0], sims[0][order], rtol=1e-6, atol=1e-6)


def test_int8_wide_vectors_multiply_in_f64():
    """Past dim 1,040 an f32 sum of int8 products may round: the port
    multiplies in f64 there and stays exact."""
    rng = np.random.default_rng(13)
    dim = port_vector.INT8_F32_EXACT_DIM + 60
    assert port_vector.INT8_F32_EXACT_DIM == 1040
    vecs = np.sign(rng.normal(size=(40, dim))).astype(np.float32)
    query = np.sign(rng.normal(size=(1, dim))).astype(np.float32)
    vecs[0] = query[0]  # dot = dim * 127^2 > 2^24, odd
    vdata = VectorData(dim=dim, metric="cosine", vectors=vecs,
                       present=np.ones(40, dtype=bool))
    scores, ids = port_vector.vector_topk(
        vdata, np.ones(40, dtype=bool), query, 3, "cosine",
        quantization="int8", device="cpu")
    qv, vs = port_vector.quantize_int8(vecs)
    qq, qs = port_vector.quantize_int8(query)
    dots = qq.astype(np.int64) @ qv.astype(np.int64).T
    assert int(dots[0, 0]) == dim * 127 * 127 > 1 << 24
    sims = dots.astype(np.float32) * (qs[:, None] * vs[None, :])
    order = np.argsort(-sims[0], kind="stable")[:3]
    assert np.array_equal(ids[0], order)
    assert np.array_equal(scores[0], sims[0][order])


def test_ties_come_back_lowest_doc_first():
    vecs = np.tile(np.array([[1.0, 0.0], [0.0, 1.0]], dtype=np.float32),
                   (6, 1))  # 12 docs, two distinct vectors
    present = np.ones(12, dtype=bool)
    mask = np.ones(12, dtype=bool)
    mask[2] = False
    q = np.array([[1.0, 0.0]], dtype=np.float32)
    for quant in (None, "bf16", "int8"):
        got, ref = both_topk(vecs, present, mask, q, 8, "cosine", quant)
        assert got[1][0].tolist() == [0, 4, 6, 8, 10, 1, 3, 5]
        assert np.array_equal(got[1], ref[1])
        assert np.array_equal(got[0], ref[0])


def test_k_past_n_and_no_present_vector():
    rng = np.random.default_rng(14)
    vecs = rng.normal(size=(5, 4)).astype(np.float32)
    q = rng.normal(size=(2, 4)).astype(np.float32)
    present = np.array([True, False, True, True, False])
    got, ref = both_topk(vecs, present, np.ones(5, dtype=bool), q, 50,
                         "l2", None)
    assert got[0].shape == (2, 5)
    assert_topk_equal(got, ref)
    assert np.isneginf(got[0][:, 3:]).all()
    none = np.zeros(5, dtype=bool)
    got, ref = both_topk(vecs, none, np.ones(5, dtype=bool), q, 3,
                         "cosine", None)
    assert np.isneginf(got[0]).all() and np.isneginf(ref[0]).all()
    empty = np.zeros((0, 4), dtype=np.float32)
    got, ref = both_topk(empty, np.zeros(0, dtype=bool),
                         np.zeros(0, dtype=bool), q, 3, "cosine", None)
    assert got[0].shape == ref[0].shape == (2, 0)
    assert got[1].dtype == ref[1].dtype


def test_device_cache_is_keyed_and_evicted():
    rng = np.random.default_rng(15)
    index = random_index(rng, n=60, dim=4)
    port = IndexReader(index, device="cpu")
    req = {"query": {"type": "vector", "field": "embedding",
                     "vector": [1, 0, 0, 0], "alpha": 0.0}, "limit": 3}
    port.search(req)
    dseg = port.device_segments[0]
    vdata = dseg.reader.vectors["embedding"]
    cache = vdata.__dict__["_torch_vectors"]
    assert list(cache) == [("cpu", "none")]
    first = cache[("cpu", "none")]
    port.search(req)
    assert vdata.__dict__["_torch_vectors"][("cpu", "none")] is first
    dseg.evict_device_caches()
    assert "_torch_vectors" not in vdata.__dict__
    assert port.search(req).hits


# -- the reader ----------------------------------------------------------


def make_vector_index(metric="Cosine", docs=None, extra=None):
    schema = Schema.from_json({
        "text_fields": [{"name": "body", "analyzer": "default",
                         "stored": True, "indexed": True}],
        "keyword_fields": [{"name": "tag", "stored": True, "indexed": True,
                            "fast": True}],
        "numeric_fields": [],
        "vector_fields": [{"name": "embedding", "dim": 4,
                           "metric": metric}],
    })
    index = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY), schema)
    writer = index.writer()
    default_docs = [
        {"_id": "a", "body": "alpha document", "tag": "x",
         "embedding": [1.0, 0.0, 0.0, 0.0]},
        {"_id": "b", "body": "beta document", "tag": "x",
         "embedding": [0.9, 0.1, 0.0, 0.0]},
        {"_id": "c", "body": "gamma document", "tag": "y",
         "embedding": [0.0, 1.0, 0.0, 0.0]},
        {"_id": "d", "body": "delta document without vector", "tag": "y"},
    ]
    for doc in (docs if docs is not None else default_docs):
        writer.add_document(doc)
    writer.commit()
    for doc in extra or []:
        writer.add_document(doc)
    if extra:
        writer.commit()
    return index


def random_index(rng, n=400, dim=8, metric="Cosine", quantization=None,
                 delete_every=9):
    """Two segments of random vectors (some docs without one), Zipf-free
    three-word bodies, a keyword, tombstones."""
    schema = Schema.from_json({
        "text_fields": [{"name": "body", "analyzer": "default",
                         "stored": False, "indexed": True}],
        "keyword_fields": [{"name": "tag", "stored": False,
                            "indexed": True, "fast": True}],
        "vector_fields": [{"name": "embedding", "dim": dim,
                           "metric": metric,
                           "quantization": quantization}],
    })
    index = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY), schema)
    writer = index.writer()
    words = [f"w{i}" for i in range(12)]
    for i in range(n):
        doc = {"_id": str(i), "tag": "xyz"[i % 3],
               "body": " ".join(rng.choice(words, size=3))}
        if rng.random() < 0.85:
            doc["embedding"] = rng.normal(size=dim).astype(
                np.float32).tolist()
        writer.add_document(doc)
        if i == n // 2:
            writer.commit()
    writer.commit()
    if delete_every:
        for i in range(2, n, delete_every):
            writer.delete_document(str(i))
        writer.commit()
    return index


def vec_node(vector, **kw):
    return {"type": "vector", "field": "embedding", "vector": vector, **kw}


E1 = [1.0, 0.0, 0.0, 0.0]
E2 = [0.0, 1.0, 0.0, 0.0]
# name -> (index key, request)
REQUESTS = {
    "cosine_ranking": ("cosine", {"query": vec_node(E1, alpha=0.0),
                                  "limit": 3}),
    "l2_ranking": ("l2", {"query": vec_node([0.9, 0.1, 0.0, 0.0],
                                            alpha=0.0), "limit": 3}),
    "missing_vector_excluded": ("cosine", {
        "query": vec_node(E1, alpha=0.0), "limit": 10}),
    "vector_filter": ("cosine", {
        "query": vec_node(E1, alpha=0.0), "limit": 10,
        "vector_filter": {"KeywordEq": {"field": "tag", "value": "y"}}}),
    "root_filter": ("cosine", {
        "query": vec_node(E1, alpha=0.0), "limit": 10,
        "filter": {"KeywordEq": {"field": "tag", "value": "x"}}}),
    "legacy_tuple_form": ("cosine", {
        "query": "alpha", "vector_query": ["embedding", E1, 0.5],
        "limit": 5}),
    "hybrid_blend": ("cosine", {
        "query": "document",
        "vector_query": {"field": "embedding", "vector": E2, "alpha": 0.5},
        "limit": 5}),
    "hybrid_requires_text_match": ("cosine", {
        "query": "alpha",
        "vector_query": {"field": "embedding", "vector": E2, "alpha": 0.5},
        "limit": 5}),
    "missing_vector_penalty": ("cosine", {
        "query": "document",
        "vector_query": {"field": "embedding", "vector": E1, "alpha": 0.5},
        "limit": 10}),
    "alpha_one_is_text_only": ("cosine", {
        "query": "alpha",
        "vector_query": {"field": "embedding", "vector": E2, "alpha": 1.0},
        "limit": 5}),
    "bool_with_vector_clause": ("cosine", {
        "query": {"type": "bool", "should": [
            {"type": "term", "field": "body", "value": "alpha"},
            vec_node(E2, alpha=0.0)]},
        "limit": 10}),
    "hybrid_with_filter_and_boost": ("cosine", {
        "query": "document",
        "vector_query": {"field": "embedding", "vector": E1, "alpha": 0.3,
                         "boost": 2.0, "k": 2},
        "filter": {"KeywordEq": {"field": "tag", "value": "x"}},
        "limit": 5}),
    "hybrid_explain_profile": ("cosine", {
        "query": "document", "explain": True, "profile": True,
        "vector_query": {"field": "embedding", "vector": E2, "alpha": 0.5},
        "limit": 5}),
    "across_segments": ("two_segments", {
        "query": vec_node(E1, alpha=0.0), "limit": 3}),
    "hybrid_across_segments": ("two_segments", {
        "query": "document epsilon",
        "vector_query": {"field": "embedding", "vector": E1, "alpha": 0.5},
        "limit": 5}),
    "vector_only_aggs": ("two_segments", {
        "query": vec_node(E1, alpha=0.0, k=3), "limit": 2,
        "aggs": {"tags": {"type": "terms", "field": "tag"}}}),
    "vector_only_collapse": ("two_segments", {
        "query": vec_node(E1, alpha=0.0), "limit": 5,
        "collapse": {"field": "tag"}}),
    "vector_only_no_hits": ("two_segments", {
        "query": vec_node(E1, alpha=0.0), "limit": 5,
        "return_hits": False,
        "aggs": {"tags": {"type": "terms", "field": "tag"}}}),
    "hybrid_aggs": ("two_segments", {
        "query": "document",
        "vector_query": {"field": "embedding", "vector": E1, "alpha": 0.5},
        "limit": 3, "aggs": {"tags": {"type": "terms", "field": "tag"}}}),
}
BAD_REQUESTS = {
    "unknown_field": {"query": {"type": "vector", "field": "nope",
                                "vector": [1, 0, 0, 0]}, "limit": 5},
    "wrong_dim": {"query": {"type": "vector", "field": "embedding",
                            "vector": [1, 0]}, "limit": 5},
    "bad_alpha": {"query": vec_node([1, 0, 0, 0], alpha=1.5), "limit": 5},
    "bad_boost": {"query": vec_node([1, 0, 0, 0], boost=-1.0), "limit": 5},
    "conflicting_specs": {
        "query": vec_node([1, 0, 0, 0]),
        "vector_query": {"field": "embedding", "vector": [1, 0, 0, 0]},
        "limit": 5},
    "too_many_clauses": {
        "query": {"type": "bool", "should": [vec_node(E1)] * 9},
        "limit": 5},
}


@pytest.fixture(scope="module")
def indexes():
    built = {}

    def get(name):
        if name not in built:
            if name == "two_segments":
                built[name] = make_vector_index(extra=[
                    {"_id": "e", "body": "epsilon", "tag": "z",
                     "embedding": [0.95, 0.05, 0.0, 0.0]}])
            else:
                built[name] = make_vector_index(
                    metric="L2" if name == "l2" else "Cosine")
        return built[name]

    return get


def assert_results_equal(got, ref):
    assert [h.doc_id for h in got.hits] == [h.doc_id for h in ref.hits]
    for g, r in zip(got.hits, ref.hits):
        assert g.score == pytest.approx(r.score, rel=RTOL, abs=ATOL)
        assert (g.vector_score is None) == (r.vector_score is None)
        if r.vector_score is not None:
            assert g.vector_score == pytest.approx(r.vector_score,
                                                   rel=RTOL, abs=ATOL)
        assert (g.explanation is None) == (r.explanation is None)
        assert len(g.inner_hits or []) == len(r.inner_hits or [])
    assert got.total_hits_estimate == ref.total_hits_estimate
    assert got.total_groups == ref.total_groups
    assert got.aggregations == ref.aggregations
    assert (got.next_cursor is None) == (ref.next_cursor is None)
    assert (got.profile is None) == (ref.profile is None)


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_request_matches_jax_reader(indexes, name):
    key, req = REQUESTS[name]
    index = indexes(key)
    got = IndexReader(index, device="cpu").search(req)
    ref = index.reader().search(req)
    assert ref.hits or not req.get("return_hits", True)
    assert_results_equal(got, ref)


@pytest.mark.parametrize("name", sorted(BAD_REQUESTS))
def test_bad_request_raises_in_both(indexes, name):
    index = indexes("cosine")
    with pytest.raises(JaxQueryError) as ref:
        index.reader().search(BAD_REQUESTS[name])
    with pytest.raises(QueryError) as got:
        IndexReader(index, device="cpu").search(BAD_REQUESTS[name])
    assert str(got.value) == str(ref.value)


def test_mesh_still_raises(indexes):
    port = IndexReader(indexes("cosine"), device="cpu")
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        port.search(REQUESTS["cosine_ranking"][1], mesh=object())


@pytest.mark.parametrize("quant", [None, "bf16", "int8"])
@pytest.mark.parametrize("metric", ["Cosine", "L2"])
def test_random_corpus_vector_only_and_hybrid(metric, quant):
    rng = np.random.default_rng(16)
    index = random_index(rng, metric=metric, quantization=quant)
    port = IndexReader(index, device="cpu")
    jax_reader = index.reader()
    q = rng.normal(size=8).astype(np.float32).tolist()
    for req in (
            {"query": vec_node(q, alpha=0.0), "limit": 20},
            {"query": vec_node(q, alpha=0.0, k=7, candidate_size=30),
             "limit": 5,
             "vector_filter": {"KeywordEq": {"field": "tag",
                                             "value": "y"}}},
            {"query": "w1 w2",
             "vector_query": {"field": "embedding", "vector": q,
                              "alpha": 0.5},
             "filter": {"KeywordIn": {"field": "tag",
                                      "values": ["x", "z"]}},
             "limit": 15},
            {"query": {"type": "bool", "must": [
                {"type": "term", "field": "body", "value": "w3"}],
                "should": [vec_node(q, alpha=0.2, boost=1.5)]},
             "limit": 10}):
        assert_results_equal(port.search(req), jax_reader.search(req))


def test_cursors_page_through_vector_and_hybrid_results():
    rng = np.random.default_rng(17)
    index = random_index(rng, n=200)
    q = rng.normal(size=8).astype(np.float32).tolist()
    for base in (
            {"query": vec_node(q, alpha=0.0, k=40, candidate_size=40),
             "limit": 7},
            {"query": "w1 w4 w7", "limit": 6, "candidate_size": 60,
             "vector_query": {"field": "embedding", "vector": q,
                              "alpha": 0.5, "k": 30}}):
        port = IndexReader(index, device="cpu")
        jax_reader = index.reader()
        # each reader follows its own cursor: the key inside holds the
        # score, which may differ in the last ulp between the two
        cursor = ref_cursor = None
        pages = 0
        seen = []
        while pages < 4:
            got = port.search(dict(base, cursor=cursor) if cursor else base)
            ref = jax_reader.search(
                dict(base, cursor=ref_cursor) if ref_cursor else base)
            assert_results_equal(got, ref)
            seen.extend(h.doc_id for h in got.hits)
            cursor, ref_cursor = got.next_cursor, ref.next_cursor
            pages += 1
            if cursor is None:
                break
        assert pages >= 2 and len(seen) == len(set(seen))


def test_hybrid_over_the_dense_budget_takes_the_chunked_route(monkeypatch):
    """A hybrid request on a segment over the dense-M budget: the chunked
    executor hands back the text mask the vector clauses need."""
    rng = np.random.default_rng(18)
    index = random_index(rng, n=300)
    q = rng.normal(size=8).astype(np.float32).tolist()
    req = {"query": "w1 w2", "limit": 10,
           "vector_query": {"field": "embedding", "vector": q,
                            "alpha": 0.5}}
    under = IndexReader(index, device="cpu").search(req)
    monkeypatch.setenv("SEARCHLITE_M_BUDGET_BYTES", "4096")
    monkeypatch.setenv("SEARCHLITE_TILE_WIDTH", "128")
    port = IndexReader(index, device="cpu")
    got = port.search(req)
    assert port.single_routes["chunked"] == 2
    assert_results_equal(got, under)
    assert_results_equal(got, index.reader().search(req))
