"""Single-query ``search()`` / ``search_scroll()`` of the torch port
(searchlite_tpu_torch/api/reader.py, ``device="cpu"``) against the JAX
reader, on one seeded corpus written once by the JAX package and opened
by both packages' ``Index``: three segments, tombstones, text, keyword and
numeric fields.

Requests are drawn from tests/test_search.py, tests/test_reader_details.py
and tests/test_scroll.py. Tolerance is f32_strict per score (rtol 1e-6,
atol 1e-4, bench.py's gate): the two executors sum leaf weights in their
own orders (divergence D10). Hit sets must match, ids and order must
match except at near-ties, and total_hits_estimate, total_groups, cursors
and page sequences must be equal."""

import json

import numpy as np
import pytest
import torch

from searchlite_tpu.api.types import IndexOptions as JaxIndexOptions
from searchlite_tpu.index import Index as JaxIndex
from searchlite_tpu.index.manifest import Schema as JaxSchema
from searchlite_tpu_torch.api.types import IndexOptions
from searchlite_tpu.errors import QueryError as JaxQueryError
from searchlite_tpu_torch.errors import CursorError, QueryError
from searchlite_tpu_torch.index import Index
from searchlite_tpu_torch.ops.score import topk_by_doc

RTOL, ATOL = 1e-6, 1e-4

SCHEMA = {
    "text_fields": [
        {"name": "title", "analyzer": "default", "stored": True,
         "indexed": True},
        {"name": "body", "analyzer": "default", "stored": True,
         "indexed": True},
    ],
    "keyword_fields": [
        {"name": "tag", "stored": True, "indexed": True, "fast": True}],
    "numeric_fields": [
        {"name": "year", "i64": True, "fast": True, "stored": True},
        {"name": "rating", "i64": False, "fast": True, "stored": True},
    ],
}
WORDS = ("systems memory safe language fun recipes flavor rust python "
         "scripting goroutines channels concurrent dinner search engine "
         "index posting block cursor scroll vector tensor kernel card "
         "matrix sparse dense strip merge").split()


def write_corpus(path, seed=5, n_docs=420):
    """Three commits (three segments), then deletions."""
    rng = np.random.default_rng(seed)
    probs = 1.0 / np.arange(1, len(WORDS) + 1) ** 0.8
    probs /= probs.sum()
    idx = JaxIndex.create(JaxIndexOptions(path=str(path),
                                          create_if_missing=True),
                          JaxSchema.from_json(SCHEMA))
    w = idx.writer()
    for i in range(n_docs):
        body = " ".join(rng.choice(WORDS, size=int(rng.integers(3, 30)),
                                   p=probs))
        if i % 7 == 0:
            body += " memory safe systems"
        w.add_document({
            "_id": f"d{i}",
            "title": " ".join(rng.choice(WORDS, size=2, p=probs)),
            "body": body,
            "tag": "abcde"[int(rng.integers(0, 5))],
            "year": int(1990 + rng.integers(0, 35)),
            "rating": float(np.round(rng.uniform(1, 5), 2)),
        })
        if i in (n_docs // 3, 2 * n_docs // 3):
            w.commit()
    w.commit()
    for i in range(2, n_docs, 13):
        w.delete_document(f"d{i}")
    w.commit()


@pytest.fixture(scope="module")
def readers(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_search")
    write_corpus(path)
    jidx = JaxIndex.open(JaxIndexOptions(path=str(path)))
    tidx = Index.open(IndexOptions(path=str(path)))
    return jidx.reader(), tidx.reader(device="cpu")


@pytest.fixture(autouse=True)
def strict(monkeypatch):
    monkeypatch.setenv("SEARCHLITE_PRECISION", "f32_strict")


def close(a, b) -> bool:
    return abs(a - b) <= ATOL + RTOL * abs(b)


def assert_close_tree(a, b, where=""):
    """Equal JSON-like trees, floats within the score tolerance."""
    if isinstance(b, float) or isinstance(a, float):
        assert a is not None and b is not None and close(a, b), \
            (where, a, b)
    elif isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b), (where, a, b)
        for key in b:
            assert_close_tree(a[key], b[key], f"{where}.{key}")
    elif isinstance(b, list):
        assert isinstance(a, list) and len(a) == len(b), (where, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert_close_tree(x, y, f"{where}[{i}]")
    else:
        assert a == b, (where, a, b)


def assert_hits_equal(got, want, where="hits"):
    assert len(got) == len(want), (where, len(got), len(want))
    want_score = {h.doc_id: h.score for h in want}
    for i, (g, w) in enumerate(zip(got, want)):
        assert close(g.score, w.score), (where, i, g.score, w.score)
        if g.doc_id != w.doc_id:
            # a near-tie swap: the doc sits elsewhere with a tied score
            assert g.doc_id in want_score, (where, i, g.doc_id)
            assert close(want_score[g.doc_id], w.score), \
                (where, i, g.doc_id, w.doc_id)
            continue
        assert g.fields == w.fields, (where, i)
        assert g.snippet == w.snippet, (where, i)
        assert g.highlights == w.highlights, (where, i)
        assert_close_tree(g.explanation, w.explanation,
                          f"{where}[{i}].explanation")
        assert_hits_equal(g.inner_hits or [], w.inner_hits or [],
                          f"{where}[{i}].inner_hits")


def assert_cursors_equal(got, want):
    """Two ``next_cursor`` strings by their decoded payloads: a cursor
    encodes the last hit's f32 score, which the two executors may round an
    ulp apart (divergence D10), so float key parts compare within the
    score tolerance and everything else for equality."""
    if got is None or want is None:
        assert got is want, (got, want)
        return
    assert_close_tree(json.loads(bytes.fromhex(got)),
                      json.loads(bytes.fromhex(want)), "next_cursor")


def assert_results_equal(got, want):
    assert got.total_hits_estimate == want.total_hits_estimate
    assert got.total_groups == want.total_groups
    assert_hits_equal(got.hits, want.hits)
    assert_cursors_equal(got.next_cursor, want.next_cursor)
    assert got.suggest == want.suggest
    assert got.aggregations == want.aggregations == {}


def term(field, value, **kw):
    return {"type": "term", "field": field, "value": value, **kw}


FS_BASE = {"type": "term", "field": "body", "value": "recipes"}
REQUESTS = {
    "match_or": {"query": "systems memory", "limit": 10},
    "match_single": {"query": "rust", "limit": 25},
    "match_fields": {"query": "rust python", "limit": 10,
                     "fields": ["title"]},
    "match_missing": {"query": "zebra", "limit": 10},
    "candidate_size": {"query": "fun dinner", "limit": 5,
                       "candidate_size": 40},
    "return_hits_false": {"query": "systems", "limit": 5,
                          "return_hits": False},
    "bool_must_should_not_filter": {"query": {
        "type": "bool",
        "must": [term("body", "memory")],
        "should": [term("body", "rust"), term("title", "python")],
        "must_not": [term("body", "dinner")],
        "filter": [{"KeywordIn": {"field": "tag", "values": ["a", "c"]}}]},
        "limit": 20},
    "bool_min_should": {"query": {
        "type": "bool", "should": [term("body", "fun"),
                                   term("body", "systems"),
                                   term("body", "kernel")],
        "minimum_should_match": 2}, "limit": 15},
    "bool_filter_only": {"query": {
        "type": "bool",
        "filter": [{"I64Range": {"field": "year", "min": 2000,
                                 "max": 2010}}]}, "limit": 30},
    "dis_max": {"query": {"type": "dis_max", "tie_breaker": 0.3,
                          "queries": [term("body", "recipes"),
                                      term("title", "recipes"),
                                      term("body", "goroutines")]},
                "limit": 10},
    "query_string": {"query": 'memory -dinner +safe "fun recipes"',
                     "limit": 10},
    "multi_match_best": {"query": {
        "type": "multi_match", "query": "systems rust",
        "fields": [{"field": "title", "boost": 2.0}, "body"]},
        "limit": 10},
    "multi_match_cross_and": {"query": {
        "type": "multi_match", "query": "rust search",
        "fields": ["title", "body"], "match_type": "cross_fields",
        "operator": "and"}, "limit": 10},
    "match_all": {"query": {"type": "match_all"}, "limit": 12},
    "root_filter": {"query": "systems", "limit": 10,
                    "filter": {"And": [
                        {"KeywordEq": {"field": "tag", "value": "b"}},
                        {"Not": {"F64Range": {"field": "rating",
                                              "min": 4.0, "max": 5.0}}}]}},
    "phrase": {"query": {"type": "phrase", "field": "body",
                         "terms": ["memory", "safe", "systems"]},
               "limit": 10},
    "phrase_slop": {"query": {"type": "phrase", "field": "body",
                              "terms": ["memory", "systems"], "slop": 1},
                    "limit": 10},
    "fuzzy": {"query": "sistems", "limit": 10,
              "fuzzy": {"max_edits": 1, "prefix_length": 0}},
    "prefix": {"query": {"type": "prefix", "field": "body",
                         "value": "con"}, "limit": 10},
    "wildcard": {"query": {"type": "wildcard", "field": "body",
                           "value": "s*s"}, "limit": 10},
    "regex": {"query": {"type": "regex", "field": "body",
                        "value": "re[a-z]+s"}, "limit": 10},
    "constant_score": {"query": {"type": "constant_score",
                                 "filter": {"KeywordEq": {"field": "tag",
                                                          "value": "d"}},
                                 "boost": 3.5}, "limit": 10},
    "fs_weight": {"query": {"type": "function_score", "query": FS_BASE,
                            "functions": [{"type": "weight",
                                           "weight": 2.0}]},
                  "limit": 10},
    "fs_field_value_factor": {"query": {
        "type": "function_score", "query": {"type": "match_all"},
        "functions": [{"type": "field_value_factor", "field": "rating",
                       "factor": 1.5, "modifier": "log1p"}],
        "boost_mode": "replace"}, "limit": 10},
    "fs_decay_gauss": {"query": {
        "type": "function_score", "query": term("body", "systems"),
        "functions": [{"type": "decay", "field": "year", "origin": 2015,
                       "scale": 7, "function": "gauss"},
                      {"type": "weight", "weight": 3.0,
                       "filter": {"KeywordEq": {"field": "tag",
                                                "value": "a"}}}],
        "score_mode": "sum", "boost_mode": "multiply"}, "limit": 15},
    "fs_decay_exp_min_score": {"query": {
        "type": "function_score", "query": {"type": "match_all"},
        "functions": [{"type": "decay", "field": "year", "origin": 2020,
                       "scale": 10}],
        "boost_mode": "replace", "min_score": 0.6}, "limit": 10},
    "rank_feature": {"query": {"type": "rank_feature", "field": "rating",
                               "modifier": "sqrt"}, "limit": 10},
    "script_score": {"query": {"type": "script_score",
                               "query": term("body", "systems"),
                               "script": "_score * 2 + rating / k",
                               "params": {"k": 4.0}}, "limit": 10},
    "script_div_zero": {"query": {"type": "script_score",
                                  "query": {"type": "match_all"},
                                  "script": "1 / (year - 2020)"},
                        "limit": 10},
    "sort_year_asc": {"query": "memory", "limit": 10,
                      "sort": [{"field": "year", "order": "asc"}]},
    "sort_tag_desc_score": {"query": {"type": "match_all"}, "limit": 10,
                            "sort": [{"field": "tag", "order": "desc"},
                                     {"field": "_score"}]},
    "collapse": {"query": "systems", "limit": 5,
                 "collapse": {"field": "tag"}},
    "collapse_inner": {"query": "fun", "limit": 5,
                       "collapse": {"field": "tag",
                                    "inner_hits": {"size": 2}}},
    "rescore": {"query": "systems", "limit": 10,
                "rescore": {"window_size": 20,
                            "query": term("body", "memory"),
                            "score_mode": "total"}},
    "explain_fs": {"query": {
        "type": "function_score", "query": term("body", "rust"),
        "functions": [{"type": "weight", "weight": 1.75},
                      {"type": "field_value_factor", "field": "rating",
                       "factor": 0.75}],
        "score_mode": "sum"}, "limit": 5, "explain": True},
    "highlight": {"query": "systems memory", "limit": 5,
                  "highlight": {"fields": {"body": {}}},
                  "highlight_field": "body", "return_stored": True},
    "suggest": {"query": {"type": "match_all"}, "limit": 1,
                "suggest": {"s1": {"type": "completion", "field": "body",
                                   "prefix": "re", "size": 4},
                            "s2": {"type": "completion", "field": "body",
                                   "prefix": "sistem", "size": 3,
                                   "fuzzy": {"max_edits": 1}}}},
    "profile_wand": {"query": "systems memory rust", "limit": 5,
                     "execution": "wand", "profile": True},
}


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_request_matches_jax(readers, name):
    jreader, treader = readers
    req = REQUESTS[name]
    want = jreader.search(dict(req))
    got = treader.search(dict(req))
    assert_results_equal(got, want)
    if req.get("profile"):
        assert got.profile["execution"]["pruning_simulated"] is True
        assert got.profile["execution"]["scored_docs"] == \
            want.profile["execution"]["scored_docs"]


@pytest.mark.parametrize("req", [
    {"query": "systems memory", "limit": 7},
    {"query": {"type": "match_all"}, "limit": 25,
     "sort": [{"field": "year", "order": "desc"}]},
    {"query": "fun", "limit": 4, "sort": [{"field": "rating"}]},
], ids=["score", "year_desc", "rating_asc"])
def test_cursor_pages_match_jax(readers, req):
    jreader, treader = readers
    cur_j = cur_t = None
    for _page in range(6):
        want = jreader.search({**req, "cursor": cur_j})
        got = treader.search({**req, "cursor": cur_t})
        assert_results_equal(got, want)
        cur_j, cur_t = want.next_cursor, got.next_cursor
        if cur_j is None:
            break


@pytest.mark.parametrize("req,block", [
    ({"query": "systems", "limit": 6}, 18),
    ({"query": {"type": "match_all"}, "limit": 50,
      "sort": [{"field": "year"}]}, 100),
], ids=["score", "year"])
def test_scroll_pages_match_jax(readers, req, block):
    jreader, treader = readers
    want = jreader.search_scroll(dict(req), block_docs=block)
    got = treader.search_scroll(dict(req), block_docs=block)
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert_results_equal(g, w)
    # the scroll's page sequence is the cursor loop's
    loop, cur = [], None
    while True:
        res = treader.search({**req, "cursor": cur})
        if not res.hits:
            break
        loop.append([h.doc_id for h in res.hits])
        cur = res.next_cursor
        if cur is None:
            break
    assert loop == [[h.doc_id for h in p.hits] for p in got]


def test_stale_cursor_raises(readers):
    _jreader, treader = readers
    res = treader.search({"query": "systems", "limit": 2})
    with pytest.raises(CursorError):
        treader.search({"query": "memory", "limit": 2,
                        "cursor": res.next_cursor})


def test_default_requests_take_the_dense_route(readers):
    _jreader, treader = readers
    before = dict(treader.single_routes)
    treader.search({"query": "systems memory", "limit": 10})
    n_seg = sum(1 for s in treader.segments if s.doc_count)
    assert treader.single_routes["dense"] - before["dense"] == n_seg
    assert treader.single_routes["sparse_plain"] == before["sparse_plain"]


def test_unported_options_raise(readers, monkeypatch):
    """Nothing is left unported: aggregations and vector clauses answer as
    the JAX reader does, and a mesh with the one-device answer."""
    jreader, treader = readers
    agg_req = {"query": "systems", "limit": 5,
               "aggs": {"t": {"type": "terms", "field": "tag"},
                        "y": {"type": "value_count", "field": "year"}}}
    got = treader.search(agg_req)
    want = jreader.search(agg_req)
    assert got.aggregations == want.aggregations
    assert got.aggregations["t"]["buckets"]
    assert_hits_equal(got.hits, want.hits)
    vec_req = {"query": {"type": "bool", "should": [
        term("body", "rust"),
        {"type": "vector", "field": "emb", "vector": [1.0, 0.0]}]},
        "limit": 5}
    # the corpus has no vector field: both readers refuse the clause
    with pytest.raises(JaxQueryError, match="unknown vector field"):
        jreader.search(vec_req)
    with pytest.raises(QueryError, match="unknown vector field"):
        treader.search(vec_req)
    from searchlite_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(devices=["cpu"] * 4)
    assert_results_equal(
        treader.search({"query": "systems", "limit": 5}, mesh=mesh),
        treader.search({"query": "systems", "limit": 5}))
    # a segment over the dense-M budget no longer raises: the chunked
    # tile executor answers it with the dense executor's hits
    dense = treader.search({"query": "systems", "limit": 5})
    monkeypatch.setenv("SEARCHLITE_M_BUDGET_BYTES", "1")
    before = treader.single_routes["chunked"]
    assert_results_equal(treader.search({"query": "systems", "limit": 5,
                                         "execution": "bm25"}), dense)
    assert treader.single_routes["chunked"] > before


def test_ties_break_toward_lowest_doc(tmp_path):
    """Identical docs score identically; the executor's top-k returns
    them doc-ascending, across a page boundary too."""
    idx = Index.create(IndexOptions(path=str(tmp_path),
                                    create_if_missing=True),
                       None)
    w = idx.writer()
    for i in range(40):
        w.add_document({"_id": f"{i:02d}", "body": "same words here"})
    w.commit()
    reader = idx.reader(device="cpu")
    first = reader.search({"query": "same", "limit": 15})
    assert [h.doc_id for h in first.hits] == [f"{i:02d}" for i in range(15)]
    assert len({h.score for h in first.hits}) == 1
    second = reader.search({"query": "same", "limit": 15,
                            "cursor": first.next_cursor})
    assert [h.doc_id for h in second.hits] == \
        [f"{i:02d}" for i in range(15, 30)]


def test_topk_by_doc_ties_and_signed_zero():
    rng = np.random.default_rng(0)
    vals = rng.choice(np.float32([-np.inf, -1.5, -0.0, 0.0, 0.25, 2.0]),
                      size=5000)
    masked = torch.from_numpy(vals)
    for k in (1, 7, 300, 5000):
        ts, ti = topk_by_doc(masked, k)
        # (value desc, index asc), -0.0 and +0.0 one value
        order = np.lexsort((np.arange(len(vals)), -(vals + 0.0)))[:k]
        assert np.array_equal(ti.numpy(), order)
        assert np.array_equal(ts.numpy(), vals[order])
