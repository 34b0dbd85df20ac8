"""Aggregations through the torch port's reader (``search()`` with
``aggs``, ``device="cpu"``) against the JAX reader: the request sets of the
JAX package's aggregation tests (``test_aggs.py``, ``test_aggs_bounded.py``'s
kinds, ``test_device_aggs.py``) and 200 seeded fuzz requests held to a
naive recount.

Each request runs with ``SEARCHLITE_DEVICE_AGGS`` 1 and 0. Tolerances:
bucket keys, counts, min / max and every non-float value equal; floats
rtol 1e-6 on the host route, 1e-5 where a segment reduced on the device
(the JAX partials sum in f32; D8-class). The port's route per segment
(``IndexReader.agg_routes``: device reductions or host collectors) must
equal the JAX reader's (a spy on its ``launch_device_aggs``), under
``f32_strict`` and not.
"""

import math
import random

import pytest

import searchlite_tpu.ops.device_aggs as jax_da
from searchlite_tpu.api.types import IndexOptions, StorageType
from searchlite_tpu.errors import QueryError as JaxQueryError
from searchlite_tpu.index import Index
from searchlite_tpu.index.manifest import Schema
from searchlite_tpu_torch.api.reader import IndexReader
from searchlite_tpu_torch.errors import QueryError
from test_torch_device_aggs import build_index as build_device_index

HOST_RTOL, DEVICE_RTOL = 1e-6, 1e-5


def assert_json_close(got, ref, rtol, path="$"):
    if isinstance(ref, dict):
        assert isinstance(got, dict) and set(got) == set(ref), path
        for key in ref:
            assert_json_close(got[key], ref[key], rtol, f"{path}.{key}")
    elif isinstance(ref, list):
        assert isinstance(got, list) and len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_json_close(g, r, rtol, f"{path}[{i}]")
    elif isinstance(ref, float) and isinstance(got, float):
        if math.isnan(ref) or math.isinf(ref):
            assert (math.isnan(got) and math.isnan(ref)) or got == ref, path
        else:
            assert got == pytest.approx(ref, rel=rtol, abs=1e-9), path
    else:
        assert got == ref and type(got) is type(ref), path


def run_both(index, req, monkeypatch, device_aggs: str):
    """The request through both readers; returns (port result, JAX
    result, port routes, JAX routes) with routes = (device, host)
    segment counts."""
    monkeypatch.setenv("SEARCHLITE_DEVICE_AGGS", device_aggs)
    jax_calls = []
    real = jax_da.launch_device_aggs

    def spy(dseg, plan, mask):
        jax_calls.append(dseg.ord)
        return real(dseg, plan, mask)

    monkeypatch.setattr(jax_da, "launch_device_aggs", spy)
    jax_reader = index.reader()
    ref = jax_reader.search(req)
    port = IndexReader(index, device="cpu")
    got = port.search(req)
    live = sum(1 for s in jax_reader.segments if s.doc_count > 0)
    return (got, ref, (port.agg_routes["device"], port.agg_routes["host"]),
            (len(jax_calls), live - len(jax_calls)))


def check_both(index, req, monkeypatch, device_aggs: str,
               expect_device=None):
    got, ref, routes, jax_routes = run_both(index, req, monkeypatch,
                                            device_aggs)
    assert routes == jax_routes
    if device_aggs == "0":
        assert routes[0] == 0
    if expect_device is not None:
        assert (routes[0] > 0) == expect_device
    rtol = DEVICE_RTOL if routes[0] else HOST_RTOL
    assert_json_close(got.aggregations, ref.aggregations, rtol)
    assert got.total_hits_estimate == ref.total_hits_estimate
    assert [h.doc_id for h in got.hits] == [h.doc_id for h in ref.hits]
    return got


# -- the request set of test_aggs.py ------------------------------------------

DAY = 86_400_000
DOCS = [
    {"_id": "1", "body": "match one", "tag": "a", "price": 10,
     "score": 1.0, "ts": 0 * DAY, "day": "2024-01-01"},
    {"_id": "2", "body": "match two", "tag": "a", "price": 20,
     "score": 2.0, "ts": 0 * DAY + 1000, "day": "2024-01-01"},
    {"_id": "3", "body": "match three", "tag": "b", "price": 30,
     "score": 3.0, "ts": 1 * DAY, "day": "2024-01-02"},
    {"_id": "4", "body": "match four", "tag": "b", "price": 40,
     "score": 4.0, "ts": 2 * DAY, "day": "2024-01-03"},
    {"_id": "5", "body": "match five", "tag": "c", "price": 50,
     "score": 5.0, "ts": 2 * DAY + 1, "day": "2024-01-03"},
    {"_id": "6", "body": "other text", "tag": "c", "price": 60,
     "score": 6.0, "ts": 3 * DAY, "day": "2024-01-04"},
]


def flat_docs(n, **fixed):
    return [{"_id": str(i), "body": "match", "tag": "a", "price": i,
             "score": 0.0, "ts": 0, **{k: (v(i) if callable(v) else v)
                                       for k, v in fixed.items()}}
            for i in range(n)]


CORPORA = {
    "docs": (DOCS, False),
    "docs_per_segment": (DOCS, True),
    "missing_tag": (DOCS + [{"_id": "7", "body": "match seven",
                             "price": 70, "score": 7.0, "ts": 0}], False),
    "months": ([
        {"_id": "1", "body": "match", "tag": "a", "price": 1, "score": 0.0,
         "ts": 0, "day": "2024-01-05"},
        {"_id": "2", "body": "match", "tag": "a", "price": 1, "score": 0.0,
         "ts": 1706918400000, "day": "2024-02-03"},
        {"_id": "3", "body": "match", "tag": "a", "price": 1, "score": 0.0,
         "ts": 1708732800000, "day": "2024-02-24"}], False),
    "hours": (flat_docs(5, price=1, ts=lambda i: i * 3_600_000), False),
    "two_ts": ([
        {"_id": "1", "body": "match", "tag": "a", "price": 1, "score": 0.0,
         "ts": 1_000},
        {"_id": "0", "body": "match", "tag": "a", "price": 1, "score": 0.0,
         "ts": 0}], False),
    "multivalued": ([
        {"_id": "1", "body": "match", "tag": "a", "price": [1, 2, 3],
         "score": 0.0, "ts": 0},
        {"_id": "2", "body": "match", "tag": "a", "price": 4, "score": 0.0,
         "ts": 0}], False),
    "hundred": (flat_docs(101), False),
    "ten": (flat_docs(11)[1:], False),
    "fifty_tags": (flat_docs(50, tag=lambda i: f"t{i % 3}"), False),
    "sixty_tags": (flat_docs(60, tag=lambda i: f"t{i % 5}"), False),
}

STATS_SUB = {"type": "stats", "field": "price"}
TAG_SOURCE = [{"type": "terms", "name": "tag", "field": "tag"}]
# name -> (corpus, aggs, extra request fields)
REQUESTS = {
    "terms": ("docs", {"tags": {"type": "terms", "field": "tag"}}, {}),
    "terms_size_min_count": ("docs", {"tags": {
        "type": "terms", "field": "tag", "size": 1, "min_doc_count": 2}},
        {}),
    "terms_missing": ("missing_tag", {"tags": {
        "type": "terms", "field": "tag", "missing": "none"}}, {}),
    "terms_numeric": ("docs", {"p": {"type": "terms", "field": "price"}},
                      {}),
    "terms_sub_stats": ("docs", {"tags": {
        "type": "terms", "field": "tag", "aggs": {"prices": STATS_SUB}}},
        {}),
    "histogram": ("docs", {"h": {"type": "histogram", "field": "price",
                                 "interval": 20}}, {}),
    "histogram_extended_bounds": ("docs", {"h": {
        "type": "histogram", "field": "price", "interval": 20,
        "min_doc_count": 0, "extended_bounds": {"min": 0, "max": 100}}},
        {}),
    "range": ("docs", {"r": {
        "type": "range", "field": "price", "keyed": False,
        "ranges": [{"to": 25}, {"from": 25, "to": 45},
                   {"from": 45, "key": "big"}]}}, {}),
    "filter_sub_count": ("docs", {"cheap": {
        "type": "filter",
        "filter": {"I64Range": {"field": "price", "min": 0, "max": 25}},
        "aggs": {"cnt": {"type": "value_count", "field": "price"}}}}, {}),
    "date_histogram_day": ("docs", {"days": {
        "type": "date_histogram", "field": "ts",
        "calendar_interval": "day"}}, {}),
    "date_histogram_month": ("months", {"m": {
        "type": "date_histogram", "field": "ts",
        "calendar_interval": "month", "format": "strict_date"}}, {}),
    "date_histogram_fixed_offset": ("hours", {"h": {
        "type": "date_histogram", "field": "ts", "fixed_interval": "2h",
        "offset": "1h", "format": "epoch_millis"}}, {}),
    "date_histogram_hard_bounds": ("two_ts", {"h": {
        "type": "date_histogram", "field": "ts", "fixed_interval": "1s",
        "min_doc_count": 0,
        "hard_bounds": {"min": "1970-01-01T00:00:01Z",
                        "max": "1970-01-01T00:00:02Z"}}}, {}),
    "histogram_hard_bounds": ("docs", {"h": {
        "type": "histogram", "field": "price", "interval": 20,
        "hard_bounds": {"min": 40, "max": 100}}}, {}),
    "pipeline_gap_policy": ("docs", {
        "h": {"type": "histogram", "field": "price", "interval": 20},
        "d": {"type": "derivative", "buckets_path": "h>missing.metric",
              "gap_policy": "insert_zeros", "unit": 1.0}}, {}),
    "month_1M": ("docs", {"m": {"type": "date_histogram", "field": "ts",
                                "calendar_interval": "1M"}}, {}),
    "month_1m": ("docs", {"m": {"type": "date_histogram", "field": "ts",
                                "calendar_interval": "1m"}}, {}),
    "composite_histogram_source": ("docs", {"c": {
        "type": "composite", "size": 10, "sources": [
            {"type": "histogram", "name": "p", "field": "price",
             "interval": 20},
            {"type": "terms", "name": "t", "field": "tag"}]}}, {}),
    "date_range": ("docs", {"dr": {
        "type": "date_range", "field": "ts", "keyed": False, "ranges": [
            {"key": "early", "to": 1 * DAY},
            {"key": "late", "from": 1 * DAY}]}}, {}),
    "composite_page_1": ("docs", {"c": {
        "type": "composite", "size": 2, "sources": TAG_SOURCE}}, {}),
    "composite_page_2": ("docs", {"c": {
        "type": "composite", "size": 2, "after": {"tag": "b"},
        "sources": TAG_SOURCE}}, {}),
    "significant_terms": ("docs", {"sig": {
        "type": "significant_terms", "field": "tag"}},
        {"query": "match five"}),
    "rare_terms": ("docs", {"rare": {
        "type": "rare_terms", "field": "tag", "max_doc_count": 1}}, {}),
    "stats_and_extended": ("docs", {
        "s": STATS_SUB, "e": {"type": "extended_stats", "field": "score"}},
        {}),
    "value_count_multivalued": ("multivalued", {"vc": {
        "type": "value_count", "field": "price"}}, {}),
    "cardinality": ("docs", {"card": {"type": "cardinality",
                                      "field": "tag"}}, {}),
    "percentiles": ("hundred", {"p": {
        "type": "percentiles", "field": "price", "percents": [50, 95]}},
        {}),
    "percentile_ranks": ("ten", {"pr": {
        "type": "percentile_ranks", "field": "price", "values": [5]}}, {}),
    "top_hits": ("docs", {"tags": {
        "type": "terms", "field": "tag", "aggs": {"top": {
            "type": "top_hits", "size": 1, "fields": ["body"]}}}}, {}),
    "avg_and_sum_bucket": ("docs", {
        "tags": {"type": "terms", "field": "tag", "aggs": {"p": STATS_SUB}},
        "avg_price": {"type": "avg_bucket", "buckets_path": "tags>p.avg"},
        "sum_count": {"type": "sum_bucket", "buckets_path": "tags"}}, {}),
    "derivative_moving_avg": ("docs", {
        "h": {"type": "histogram", "field": "price", "interval": 20,
              "aggs": {"s": STATS_SUB}},
        "d": {"type": "derivative", "buckets_path": "h"},
        "m": {"type": "moving_avg", "buckets_path": "h", "window": 2}},
        {}),
    "bucket_script": ("docs", {
        "tags": {"type": "terms", "field": "tag", "aggs": {"p": STATS_SUB}},
        "ratio": {"type": "bucket_script",
                  "buckets_path": {"total": "tags>p.sum", "n": "tags"},
                  "script": "total / n"}}, {}),
    "bucket_sort": ("docs", {
        "tags": {"type": "terms", "field": "tag"},
        "sorter": {"type": "bucket_sort", "sort": [{"_count": "asc"}],
                   "size": 2}}, {}),
    "cross_segment_merge": ("docs_per_segment", {
        "tags": {"type": "terms", "field": "tag", "aggs": {"s": STATS_SUB}},
        "st": STATS_SUB,
        "card": {"type": "cardinality", "field": "tag"}}, {}),
    "top_hits_across_segments": ("docs_per_segment", {"tags": {
        "type": "terms", "field": "tag", "aggs": {"top": {
            "type": "top_hits", "size": 5, "fields": ["body"]}}}}, {}),
    "sampling_size": ("fifty_tags", {"tags": {
        "type": "terms", "field": "tag",
        "sampling": {"size": 10, "seed": 7}}}, {}),
    "sampling_probability": ("sixty_tags", {"tags": {
        "type": "terms", "field": "tag",
        "sampling": {"probability": 0.5, "seed": 3}}}, {}),
    "root_filter": ("docs", {"st": STATS_SUB}, {
        "filter": {"KeywordEq": {"field": "tag", "value": "a"}}}),
    "no_hits_wanted": ("docs", {"tags": {"type": "terms", "field": "tag"}},
                       {"return_hits": False}),
    "field_sort": ("docs", {"tags": {"type": "terms", "field": "tag"},
                            "st": STATS_SUB},
                   {"sort": [{"field": "price", "order": "desc"}]}),
    "collapse": ("docs", {"tags": {"type": "terms", "field": "tag"}},
                 {"collapse": {"field": "tag"}, "limit": 5}),
    "wand_execution": ("docs", {"tags": {"type": "terms", "field": "tag"}},
                       {"execution": "wand", "profile": True}),
}

# requests both readers refuse with a QueryError
BAD_REQUESTS = {
    "densify_histogram": {"h": {
        "type": "histogram", "field": "price", "interval": 0.001,
        "extended_bounds": {"min": 0, "max": 1e6}}},
    "densify_date_histogram": {"h": {
        "type": "date_histogram", "field": "ts", "fixed_interval": "1s",
        "hard_bounds": {"min": "1970-01-01T00:00:00Z",
                        "max": "2100-01-01T00:00:00Z"}}},
    "unknown_type": {"x": {"type": "bogus", "field": "tag"}},
    "stats_on_keyword": {"x": {"type": "stats", "field": "tag"}},
    "stats_on_text": {"x": {"type": "stats", "field": "body"}},
}


def make_index(docs, commits_per_doc=False):
    schema = Schema.from_json({
        "text_fields": [{"name": "body", "analyzer": "default",
                         "stored": True, "indexed": True}],
        "keyword_fields": [
            {"name": "tag", "stored": True, "indexed": True, "fast": True},
            {"name": "day", "stored": True, "indexed": True, "fast": True},
        ],
        "numeric_fields": [
            {"name": "price", "i64": True, "fast": True, "stored": True},
            {"name": "score", "i64": False, "fast": True, "stored": True},
            {"name": "ts", "i64": True, "fast": True, "stored": True},
        ],
    })
    index = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY), schema)
    writer = index.writer()
    for doc in docs:
        writer.add_document(doc)
        if commits_per_doc:
            writer.commit()
    if not commits_per_doc:
        writer.commit()
    return index


@pytest.fixture(scope="module")
def corpora():
    built = {}

    def get(name):
        if name not in built:
            built[name] = make_index(*CORPORA[name])
        return built[name]

    return get


@pytest.mark.parametrize("device_aggs", ["1", "0"])
@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_request_matches_jax_reader(corpora, monkeypatch, name, device_aggs):
    corpus, aggs, extra = REQUESTS[name]
    req = {"query": "match", "limit": 1, "aggs": aggs, **extra}
    got = check_both(corpora(corpus), req, monkeypatch, device_aggs)
    assert got.aggregations


@pytest.mark.parametrize("name", sorted(BAD_REQUESTS))
def test_bad_request_raises_in_both(corpora, name):
    req = {"query": "match", "limit": 1, "aggs": BAD_REQUESTS[name]}
    index = corpora("docs")
    with pytest.raises(JaxQueryError) as ref:
        index.reader().search(req)
    with pytest.raises(QueryError) as got:
        IndexReader(index, device="cpu").search(req)
    assert str(got.value) == str(ref.value)


def test_significant_terms_respects_deletions(monkeypatch):
    index = make_index([
        {"_id": "1", "body": "keep me", "tag": "foo", "price": 1,
         "score": 0.0, "ts": 0},
        {"_id": "2", "body": "delete me", "tag": "foo", "price": 1,
         "score": 0.0, "ts": 0}])
    writer = index.writer()
    writer.delete_document("2")
    writer.commit()
    req = {"query": "keep", "limit": 1, "aggs": {"sig": {
        "type": "significant_terms", "field": "tag", "size": 5}}}
    got = check_both(index, req, monkeypatch, "1", expect_device=True)
    buckets = got.aggregations["sig"]["buckets"]
    assert [(b["key"], b["doc_count"]) for b in buckets] == [("foo", 1)]


# -- the request set of test_device_aggs.py ---------------------------------

AGGS = {
    "cats": {"type": "terms", "field": "cat", "size": 10},
    "price_hist": {"type": "histogram", "field": "price", "interval": 7.5},
    "price_ranges": {"type": "range", "field": "price", "ranges": [
        {"to": 25.0}, {"from": 20.0, "to": 60.0}, {"from": 60.0}]},
    "qty_stats": {"type": "stats", "field": "qty"},
    "qty_count": {"type": "value_count", "field": "qty"},
}
WIDE_AGGS = {
    "tags": {"type": "terms", "field": "tags"},
    "cats_missing": {"type": "terms", "field": "cat", "missing": "none"},
    "qty_terms": {"type": "terms", "field": "qty"},
    "qty_hist_missing": {"type": "histogram", "field": "qty",
                         "interval": 10.0, "missing": 0,
                         "hard_bounds": {"min": 0, "max": 45}},
    "by_day": {"type": "date_histogram", "field": "day",
               "calendar_interval": "day"},
    "by_12h": {"type": "date_histogram", "field": "day",
               "fixed_interval": "12h"},
    "day_ranges": {"type": "date_range", "field": "qty",
                   "ranges": [{"to": 20}, {"from": 20}]},
    "only_a": {"type": "filter",
               "filter": {"KeywordEq": {"field": "cat", "value": "a"}}},
    "scores_count": {"type": "value_count", "field": "scores"},
    "scores_stats": {"type": "stats", "field": "scores"},
    "tag_count_missing": {"type": "value_count", "field": "tags",
                          "missing": "?"},
    "sig": {"type": "significant_terms", "field": "tags"},
    "sig_bg": {"type": "significant_terms", "field": "cat",
               "background_filter": {"KeywordEq": {"field": "cat",
                                                   "value": "a"}}},
    "rare": {"type": "rare_terms", "field": "cat", "max_doc_count": 500},
}
SUB_AGGS = {
    "cats_sub": {"type": "terms", "field": "cat", "aggs": {
        "q": {"type": "stats", "field": "qty"},
        "n": {"type": "value_count", "field": "scores"}}},
    "hist_sub": {"type": "histogram", "field": "qty", "interval": 10.0,
                 "aggs": {"s": {"type": "stats", "field": "scores",
                                "missing": 3}}},
    "range_sub": {"type": "range", "field": "qty",
                  "ranges": [{"to": 25}, {"from": 25}],
                  "aggs": {"s": {"type": "stats", "field": "scores"}}},
    "filter_sub": {"type": "filter",
                   "filter": {"KeywordEq": {"field": "cat", "value": "b"}},
                   "aggs": {"q": {"type": "stats", "field": "qty"}}},
    "day_sub": {"type": "date_histogram", "field": "day",
                "calendar_interval": "week",
                "aggs": {"n": {"type": "value_count", "field": "qty"}}},
}
FILTER_PIPELINE = {
    "hist": {"type": "histogram", "field": "price", "interval": 20.0},
    "total": {"type": "sum_bucket", "buckets_path": "hist>_count"},
}
FALLBACK = {
    "sampled": {"type": "terms", "field": "cat",
                "sampling": {"size": 50, "seed": 7}},
    "card": {"type": "cardinality", "field": "cat"},
}
# (aggs, query, extra, segments reduce on the device by default)
DEVICE_SETS = {
    "aggs_w1": (AGGS, "w1", {}, True),
    "aggs_three_terms": (AGGS, "w2 w9 w17", {}, True),
    "aggs_w40": (AGGS, "w40", {}, True),
    "wide_w1": (WIDE_AGGS, "w1", {}, True),
    "wide_three_terms": (WIDE_AGGS, "w3 w11 w24", {}, True),
    "sub_w1": (SUB_AGGS, "w1", {}, True),
    "sub_two_terms": (SUB_AGGS, "w5 w31", {}, True),
    "inexact_floats": ({"p": {"type": "stats", "field": "price"}}, "w2",
                       {}, False),
    "fallback_kinds": (FALLBACK, "w5", {}, False),
    "filter_and_pipeline": (FILTER_PIPELINE, "w1 w2 w3", {
        "filter": {"KeywordEq": {"field": "cat", "value": "a"}}}, True),
    "match_all_no_hits": (AGGS, {"type": "match_all"},
                          {"return_hits": False}, True),
    "phrase_query": (WIDE_AGGS, {"type": "phrase", "field": "body",
                                 "terms": ["w1", "w2"], "slop": 3}, {},
                     True),
    "field_sort_keeps_host": (AGGS, "w1", {
        "sort": [{"field": "qty", "order": "asc"}]}, False),
    "cursor_page": (AGGS, "w1 w2", {"limit": 3}, True),
}


@pytest.fixture(scope="module")
def device_index():
    return build_device_index()


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("device_aggs", ["1", "0"])
@pytest.mark.parametrize("name", sorted(DEVICE_SETS))
def test_device_set_matches_jax_reader(device_index, monkeypatch, name,
                                       device_aggs, strict):
    aggs, query, extra, on_device = DEVICE_SETS[name]
    if strict:
        monkeypatch.setenv("SEARCHLITE_PRECISION", "f32_strict")
    req = {"query": query, "limit": 5, "aggs": aggs, **extra}
    has_stats = any(
        spec["type"] in ("stats", "extended_stats")
        or any(sub["type"] in ("stats", "extended_stats")
               for sub in spec.get("aggs", {}).values())
        for spec in aggs.values())
    expect = (device_aggs == "1" and on_device
              and not (strict and has_stats))
    got = check_both(device_index, req, monkeypatch, device_aggs,
                     expect_device=expect)
    if name == "cursor_page" and got.next_cursor:
        # the next page carries the aggregations of the rest
        check_both(device_index, {**req, "cursor": got.next_cursor},
                   monkeypatch, device_aggs)


def test_vcap_exceeded_falls_back(monkeypatch):
    monkeypatch.setenv("SEARCHLITE_DEVICE_AGG_VCAP", "1")
    index = build_device_index(n_docs=300, seed=7)
    req = {"query": "w3", "limit": 5,
           "aggs": {"t": {"type": "terms", "field": "tags"}}}
    check_both(index, req, monkeypatch, "1", expect_device=False)
    single = {"query": "w3", "limit": 5,
              "aggs": {"c": {"type": "terms", "field": "cat"}}}
    check_both(index, single, monkeypatch, "1", expect_device=True)


def test_significant_terms_bg_refreshes_after_delete(monkeypatch):
    """The background counts are live-doc statics. The port opens a new
    DeviceSegment on a delete commit, so the structures it caches there
    are the new segment's."""
    idx = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY),
        Schema.from_json({
            "text_fields": [{"name": "body", "analyzer": "default",
                             "stored": False, "indexed": True}],
            "keyword_fields": [{"name": "cat", "stored": False,
                                "indexed": True, "fast": True}]}))
    writer = idx.writer()
    for i in range(60):
        writer.add_document({"_id": str(i), "body": "hit",
                             "cat": "a" if i % 3 else "b"})
    writer.commit()
    req = {"query": "hit", "limit": 1, "aggs": {
        "sig": {"type": "significant_terms", "field": "cat"}}}
    before_reader = IndexReader(idx, device="cpu")
    before = before_reader.search(req).aggregations
    assert before["sig"]["bg_count"] == 60
    assert before_reader.agg_routes == {"device": 1, "host": 0}
    for i in range(0, 60, 2):
        writer.delete_document(str(i))
    writer.commit()
    after_reader = IndexReader(idx, device="cpu")
    assert after_reader.device_segments[0] is not \
        before_reader.device_segments[0]
    after = after_reader.search(req).aggregations
    assert after_reader.agg_routes == {"device": 1, "host": 0}
    monkeypatch.setenv("SEARCHLITE_DEVICE_AGGS", "0")
    host = IndexReader(idx, device="cpu").search(req).aggregations
    assert after == host
    assert after["sig"]["bg_count"] == 30
    assert_json_close(after, idx.reader().search(req).aggregations,
                      HOST_RTOL)


def test_empty_segment_and_empty_index(monkeypatch):
    """A segment whose docs are all deleted still reduces (to nothing);
    an index without segments answers with empty aggregations."""
    index = make_index(DOCS[:2])
    writer = index.writer()
    writer.delete_document("1")
    writer.delete_document("2")
    writer.commit()
    req = {"query": "match", "limit": 1, "aggs": {
        "tags": {"type": "terms", "field": "tag"}, "st": STATS_SUB}}
    for mode in ("1", "0"):
        check_both(index, req, monkeypatch, mode)
    empty = make_index([])
    for mode in ("1", "0"):
        check_both(empty, req, monkeypatch, mode)


def test_chunked_segments_collect_on_the_host(device_index, monkeypatch):
    """Over the dense-M budget a segment runs the chunked executor and
    its aggregations collect on the host over the stitched mask."""
    monkeypatch.setenv("SEARCHLITE_M_BUDGET_BYTES", "4096")
    monkeypatch.setenv("SEARCHLITE_TILE_WIDTH", "128")
    req = {"query": "w1 w2", "limit": 5, "aggs": AGGS}
    port = IndexReader(device_index, device="cpu")
    got = port.search(req)
    assert port.single_routes["chunked"] == 2
    assert port.agg_routes == {"device": 0, "host": 2}
    ref = device_index.reader().search(req)
    assert_json_close(got.aggregations, ref.aggregations, DEVICE_RTOL)
    assert [h.doc_id for h in got.hits] == [h.doc_id for h in ref.hits]


# -- seeded fuzz: aggregation values against a naive recount ----------------

VOCAB = [f"w{i}" for i in range(40)] + ["café", "naïve"]
TAGS = ["a", "b", "c", None]
N_FUZZ = 200


@pytest.fixture(scope="module")
def fuzz_index():
    rng = random.Random(99)
    schema = Schema.from_json({
        "text_fields": [{"name": "body", "analyzer": "default",
                         "stored": True, "indexed": True}],
        "keyword_fields": [{"name": "tag", "stored": True, "indexed": True,
                            "fast": True, "nullable": True}],
        "numeric_fields": [{"name": "n", "i64": True, "fast": True,
                            "stored": True, "nullable": True}],
    })
    idx = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY), schema)
    writer = idx.writer()
    docs = {}
    for i in range(150):
        doc = {"_id": str(i),
               "body": " ".join(rng.choices(VOCAB, k=rng.randint(1, 15)))}
        tag = rng.choice(TAGS)
        if tag:
            doc["tag"] = tag
        if rng.random() < 0.8:
            doc["n"] = rng.randint(-5, 100)
        writer.add_document(doc)
        docs[str(i)] = doc
        if i == 70:
            writer.commit()
    writer.commit()
    for i in range(4, 150, 17):
        writer.delete_document(str(i))
        del docs[str(i)]
    writer.commit()
    return idx, docs


def random_filter(rng, depth=0):
    """The filter generator of the JAX package's fuzz test."""
    kinds = ["KeywordEq", "KeywordIn", "I64Range"]
    if depth < 1:
        kinds += ["And", "Or", "Not"]
    kind = rng.choice(kinds)
    if kind == "KeywordEq":
        return {"KeywordEq": {"field": "tag",
                              "value": rng.choice(["a", "b", "z"])}}
    if kind == "KeywordIn":
        return {"KeywordIn": {"field": "tag", "values": ["a", "c"]}}
    if kind == "I64Range":
        lo = rng.randint(-10, 50)
        return {"I64Range": {"field": "n", "min": lo,
                             "max": lo + rng.randint(0, 60)}}
    if kind == "And":
        return {"And": [random_filter(rng, depth + 1)
                        for _ in range(rng.randint(1, 2))]}
    if kind == "Or":
        return {"Or": [random_filter(rng, depth + 1)
                       for _ in range(rng.randint(1, 2))]}
    return {"Not": random_filter(rng, depth + 1)}


def naive_pass(flt, doc) -> bool:
    if "KeywordEq" in flt:
        return doc.get("tag") == flt["KeywordEq"]["value"]
    if "KeywordIn" in flt:
        return doc.get("tag") in flt["KeywordIn"]["values"]
    if "I64Range" in flt:
        r = flt["I64Range"]
        return doc.get("n") is not None and r["min"] <= doc["n"] <= r["max"]
    if "And" in flt:
        return all(naive_pass(f, doc) for f in flt["And"])
    if "Or" in flt:
        return any(naive_pass(f, doc) for f in flt["Or"])
    return not naive_pass(flt["Not"], doc)


@pytest.mark.parametrize("trial", range(N_FUZZ))
def test_fuzz_aggs_match_naive_oracle(fuzz_index, monkeypatch, trial):
    index, docs = fuzz_index
    rng = random.Random(3100 + trial)
    flt = random_filter(rng) if trial % 7 else None
    device_aggs = "1" if trial % 4 else "0"
    req = {"query": {"type": "match_all"}, "limit": 1,
           "return_hits": False,
           "aggs": {
               "t": {"type": "terms", "field": "tag"},
               "c": {"type": "value_count", "field": "n"},
               "s": {"type": "stats", "field": "n"},
               "h": {"type": "histogram", "field": "n", "interval": 25}}}
    if flt is not None:
        req["filter"] = flt
    monkeypatch.setenv("SEARCHLITE_DEVICE_AGGS", device_aggs)
    port = IndexReader(index, device="cpu")
    aggs = port.search(req).aggregations
    assert port.agg_routes == ({"device": 2, "host": 0}
                               if device_aggs == "1"
                               else {"device": 0, "host": 2})
    matched = [d for d in docs.values() if flt is None or naive_pass(flt, d)]
    values = [d["n"] for d in matched if d.get("n") is not None]
    want_terms = {}
    for d in matched:
        if d.get("tag") is not None:
            want_terms[d["tag"]] = want_terms.get(d["tag"], 0) + 1
    assert {b["key"]: b["doc_count"]
            for b in aggs["t"]["buckets"]} == want_terms, flt
    assert aggs["c"]["value"] == len(values), flt
    if values:
        assert aggs["s"]["count"] == len(values)
        assert aggs["s"]["min"] == min(values)
        assert aggs["s"]["max"] == max(values)
        assert abs(aggs["s"]["sum"] - sum(values)) < 1e-6
        want_h = {}
        for v in values:
            key = math.floor(v / 25) * 25.0
            want_h[key] = want_h.get(key, 0) + 1
        assert {b["key"]: b["doc_count"] for b in aggs["h"]["buckets"]
                if b["doc_count"] > 0} == want_h, flt
    if trial % 10 == 0:
        ref = index.reader().search(req).aggregations
        assert_json_close(aggs, ref, DEVICE_RTOL)
