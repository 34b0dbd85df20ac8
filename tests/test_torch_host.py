"""The torch port's own host layers against the JAX package's.

searchlite_tpu_torch keeps its own copies of the host modules it needs
(storage, index, analysis, query, native prep, the numpy halves of
``ops/impact.py``, ``ops/sparse.py`` and ``device/index.py``). On one
seeded two-segment corpus with tombstones, written to disk by the JAX
package's writer and opened by each package through its own ``Index``:

- the segment's host build (``HostSegment`` against the JAX
  ``DeviceSegment(reader, ord, jnp=numpy)``), the native and Python query
  prep, the strip partitions (tiered, term split, explicit table), the
  dense tables (``split_impact_batch``, ``subset_impact_batch``, block
  tables) and the dense rows are equal array for array, dtype and bits;
- an index written by either package opens and searches in the other with
  the same results;
- ``Index.reader()`` of the port gives the port's reader on the card, and
  raises on a host without CUDA unless the caller asks for the CPU;
- the host aggregation collectors (``query/aggs.py``) give the same
  intermediates and the same finalized output on seeded matched sets, and
  the sketches (``query/sketches.py``: t-digest, HyperLogLog, the
  exact-then-sketch states) the same state, byte for byte.
"""

import numpy as np
import pytest
import torch

from searchlite_tpu.api.types import IndexOptions as JaxOptions
from searchlite_tpu.device.index import DeviceSegment as JaxSegment
from searchlite_tpu.index import Index as JaxIndex
from searchlite_tpu.index.manifest import Schema as JaxSchema
from searchlite_tpu.ops import impact as jax_impact
from searchlite_tpu.ops import sparse as jax_sparse
from searchlite_tpu_torch.api.reader import IndexReader
from searchlite_tpu_torch.api.types import IndexOptions
from searchlite_tpu_torch.device.index import DeviceSegment, HostSegment
from searchlite_tpu_torch.index import Index
from searchlite_tpu_torch.index.manifest import Schema
from searchlite_tpu_torch.ops import impact as port_impact
from searchlite_tpu_torch.ops import sparse as port_sparse

VOCAB = [f"w{i}" for i in range(200)]
SCHEMA = {
    "text_fields": [{"name": "body", "analyzer": "default",
                     "stored": False, "indexed": True}],
    "keyword_fields": [{"name": "cat", "stored": False, "indexed": True,
                        "fast": True}],
    "numeric_fields": [{"name": "rank", "type": "i64", "stored": False,
                        "fast": True}]}
RTOL, ATOL = 1e-6, 1e-4  # bench.py's f32_strict gate


def fill(index, seed=21, n_docs=1600, delete_every=11):
    """Two commits of Zipf docs, then tombstones (either package's
    writer: the same calls)."""
    rng = np.random.default_rng(seed)
    probs = 1.0 / np.arange(1, len(VOCAB) + 1)
    probs /= probs.sum()
    writer = index.writer()
    for i in range(n_docs):
        n = int(rng.integers(4, 60))
        writer.add_document({"_id": str(i), "body": " ".join(
            rng.choice(VOCAB, size=n, p=probs)), "rank": i % 16,
            "cat": "abc"[i % 3]})
        if i == n_docs * 2 // 3:
            writer.commit()
    writer.commit()
    w2 = index.writer()
    for i in range(3, n_docs, delete_every):
        w2.delete_document(str(i))
    w2.commit()
    return index


def queries(seed, n, max_terms=6):
    rng = np.random.default_rng(seed)
    probs = 1.0 / np.arange(1, len(VOCAB) + 1) ** 0.7
    probs /= probs.sum()
    out = []
    for i in range(n):
        terms = list(rng.choice(VOCAB, size=int(rng.integers(1, max_terms)),
                                p=probs))
        if rng.random() < 0.2:
            terms.append(terms[0])  # a repeated term: occ 2
        if i % 17 == 0:
            terms.append("absent")
        out.append(" ".join(terms))
    return out


@pytest.fixture(scope="module")
def jax_written(tmp_path_factory):
    """(path, JAX Index, port Index): written by the JAX writer, opened by
    both packages."""
    path = str(tmp_path_factory.mktemp("jax_written"))
    fill(JaxIndex.create(JaxOptions(path=path, create_if_missing=True),
                         JaxSchema.from_json(SCHEMA)))
    return (path, JaxIndex.open(JaxOptions(path=path)),
            Index.open(IndexOptions(path=path)))


@pytest.fixture(scope="module")
def segments(jax_written):
    """Per segment: (JAX SegmentReader, JAX numpy build, port
    SegmentReader, port HostSegment)."""
    from searchlite_tpu.index.segment import SegmentReader as JaxReader
    from searchlite_tpu_torch.index.segment import SegmentReader

    _path, jidx, pidx = jax_written
    out = []
    for i, (jm, pm) in enumerate(zip(jidx.manifest.segments,
                                     pidx.manifest.segments)):
        jseg = JaxReader(jm, jidx.storage)
        pseg = SegmentReader(pm, pidx.storage)
        out.append((jseg, JaxSegment(jseg, i, jnp=np), pseg,
                    HostSegment(pseg, i)))
    assert len(out) == 2
    return out


def assert_same(a, b, where="value"):
    """Equal structure, dtypes, shapes and bits (dicts, lists, arrays,
    scalars)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), where
        for key in a:
            assert_same(a[key], b[key], f"{where}[{key!r}]")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert a.tobytes() == b.tobytes(), where
    else:
        assert type(a) is type(b) and a == b, where


HOST_ARRAYS = ["n_docs", "n1", "n_block_rows", "live_docs", "block_docs_np",
               "block_impacts_np", "deleted_np", "posting_base",
               "docs_flat_np", "impacts_flat_np", "idf_table", "idf32",
               "sparse_tid_tbl", "sparse_sentinels"]


@pytest.mark.parametrize("name", HOST_ARRAYS)
def test_host_segment_equals_jax_build(segments, name):
    for _js, jd, _ps, hd in segments:
        assert_same(getattr(jd, name), getattr(hd, name), name)


@pytest.mark.parametrize("term_cap", [1, 4, 32])
def test_heavy_lookup_host_equal(segments, term_cap):
    heavy = 0
    for _js, jd, _ps, hd in segments:
        ref = jd.heavy_lookup_host(term_cap)
        assert_same(ref, hd.heavy_lookup_host(term_cap))
        heavy += int((ref["base"] >= 0).sum())
    assert heavy > 0 or term_cap == 32


@pytest.fixture(scope="module")
def analyses(jax_written):
    """Each package's (schema, analyzers), as its reader builds them."""
    _path, jidx, pidx = jax_written
    return ((jidx.manifest.schema, jidx.manifest.schema.build_analyzers()),
            (pidx.manifest.schema, pidx.manifest.schema.build_analyzers()))


def prep_both(segments, analyses, batch, native=True):
    """Per segment: (JAX qb, port qb) for one batch of raw queries."""
    (jschema, janalysis), (pschema, panalysis) = analyses
    out = []
    for js, jd, ps, hd in segments:
        if native:
            jqb = jax_impact.build_impact_batch_native(
                js, jd, batch, ["body"], janalysis, jschema,
                lazy_tables=True)
            pqb = port_impact.build_impact_batch_native(
                ps, hd, batch, ["body"], panalysis, pschema,
                lazy_tables=True)
        else:
            analyzed = [[("body", t) for t in q.split()] for q in batch]
            jqb = jax_impact.build_impact_batch(js, jd, analyzed,
                                                lazy_tables=True)
            pqb = port_impact.build_impact_batch(ps, hd, analyzed,
                                                 lazy_tables=True)
        out.append((jqb, pqb))
    return out


@pytest.mark.parametrize("native", [True, False])
def test_query_prep_equal(segments, analyses, native):
    for jqb, pqb in prep_both(segments, analyses, queries(1, 64),
                              native=native):
        assert jqb is not None and pqb is not None
        assert_same(jax_impact.ensure_dense_tables(jqb),
                    port_impact.ensure_dense_tables(pqb))


@pytest.mark.parametrize("max_blocks,k", [(4, 10), (32, 10), (8, 300)])
def test_tiered_partition_equal(segments, analyses, max_blocks, k):
    for (_js, jd, _ps, hd), (jqb, pqb) in zip(
            segments, prep_both(segments, analyses, queries(2, 96))):
        assert_same(jax_sparse.partition_sparse_batch_tiered(
                        jqb, max_blocks, jd.idf32, k),
                    port_sparse.partition_sparse_batch_tiered(
                        pqb, max_blocks, hd.idf32, k))
        assert_same(jax_sparse.partition_sparse_batch(jqb, max_blocks),
                    port_sparse.partition_sparse_batch(pqb, max_blocks))


@pytest.mark.parametrize("term_cap,ub_ratio", [(2, 0.0), (2, 0.5), (4, 0.5)])
def test_split_partition_equal(segments, analyses, term_cap, ub_ratio):
    split_rows = 0
    for (_js, jd, _ps, hd), (jqb, pqb) in zip(
            segments, prep_both(segments, analyses, queries(3, 96))):
        ref = jax_sparse.partition_sparse_batch_split(
            jqb, 8, jd.idf32, 10, term_cap, 4,
            maximp=jd.heavy_lookup_host(term_cap)["maximp"],
            ub_ratio=ub_ratio)
        got = port_sparse.partition_sparse_batch_split(
            pqb, 8, hd.idf32, 10, term_cap, 4,
            maximp=hd.heavy_lookup_host(term_cap)["maximp"],
            ub_ratio=ub_ratio)
        assert_same(ref, got)
        if ref is not None:
            split_rows += sum(int((g["hvy"][1] != 0).any(axis=1).sum())
                              for g in ref["groups"] if g["hvy"] is not None)
    assert split_rows > 0  # the term split really took head-term rows


def test_dense_tables_equal(segments, analyses):
    for (js, jd, _ps, hd), (jqb, pqb) in zip(
            segments, prep_both(segments, analyses, queries(4, 80))):
        jax_impact.ensure_dense_tables(jqb)
        port_impact.ensure_dense_tables(pqb)
        # the head terms as dense rows, as DeviceSegment.dense_rows picks
        df = js.postings.term_df
        rows_of = {int(t): i for i, t in enumerate(np.argsort(-df)[:12])}
        assert_same(
            jax_impact.split_impact_batch(jqb, rows_of, n_rows=12, n1=jd.n1),
            port_impact.split_impact_batch(pqb, rows_of, n_rows=12, n1=hd.n1))
        pick = np.arange(0, 80, 3)
        assert_same(jax_impact.subset_impact_batch(jqb, pick),
                    port_impact.subset_impact_batch(pqb, pick))
        assert_same(
            jax_impact.build_block_tables(jqb["slot_bstart"],
                                          jqb["slot_bcnt"], 7),
            port_impact.build_block_tables(pqb["slot_bstart"],
                                           pqb["slot_bcnt"], 7))


def test_dense_rows_equal(segments, monkeypatch):
    monkeypatch.setenv("SEARCHLITE_PRECISION", "f32_strict")  # f32 rows
    for js, jd, ps, hd in segments:
        budget = 40 * jd.n1 * 4
        ref = jd.dense_rows(budget)
        dev = DeviceSegment(ps, 0, "cpu")
        got = dev.dense_rows(budget)
        assert ref is not None and got is not None
        assert ref["row_of_tid"] == got["row_of_tid"]
        assert_same(np.asarray(ref["m_dense"]), got["m_dense"].numpy())


def assert_close(ref, got):
    """Two readers' (scores, ids, segs): finite masks equal, scores within
    tolerance, ids equal except near-ties."""
    rs, ri, rg = ref
    gs, gi, gg = got
    fin = np.isfinite(rs)
    assert np.array_equal(np.isfinite(gs), fin)
    assert np.allclose(gs[fin], rs[fin], rtol=RTOL, atol=ATOL)
    tol = ATOL + RTOL * np.abs(np.where(fin, rs, 0.0))
    gap = np.full(rs.shape, np.inf)
    with np.errstate(invalid="ignore"):
        diff = np.abs(np.diff(rs, axis=1))
    gap[:, 1:] = np.minimum(gap[:, 1:], diff)
    gap[:, :-1] = np.minimum(gap[:, :-1], diff)
    clear = fin & (gap > tol)
    assert np.array_equal(gi[clear], ri[clear])
    assert np.array_equal(gg[clear], rg[clear])


def search_both(jidx, pidx, batch, **kw):
    ref = jidx.reader().search_batch_many([batch], output="arrays", **kw)[0]
    got = pidx.reader(device="cpu").search_batch_many(
        [batch], output="arrays", **kw)[0]
    return ref, got


def test_jax_written_index_searches_in_the_port(jax_written, monkeypatch):
    monkeypatch.setenv("SEARCHLITE_PRECISION", "f32_strict")
    _path, jidx, pidx = jax_written
    batch = queries(5, 48)
    assert_close(*search_both(jidx, pidx, batch, limit=10))
    filters = [None, {"I64Range": {"field": "rank", "min": 0, "max": 5}},
               {"I64Range": {"field": "rank", "min": 40, "max": 50}}]
    assert_close(*search_both(
        jidx, pidx, batch, limit=12,
        filters=[[filters[i % 3] for i in range(len(batch))]]))


def test_port_written_index_searches_in_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("SEARCHLITE_PRECISION", "f32_strict")
    path = str(tmp_path / "port_written")
    fill(Index.create(IndexOptions(path=path, create_if_missing=True),
                      Schema.from_json(SCHEMA)), seed=33, n_docs=900)
    jidx = JaxIndex.open(JaxOptions(path=path))
    pidx = Index.open(IndexOptions(path=path))
    assert [m.id for m in jidx.manifest.segments] == \
        [m.id for m in pidx.manifest.segments]
    assert jidx.stats()["documents"] == pidx.stats()["documents"]
    assert_close(*search_both(jidx, pidx, queries(6, 40), limit=8))


def test_port_index_reader_is_the_port_reader(jax_written):
    _path, _jidx, pidx = jax_written
    reader = pidx.reader(device="cpu")
    assert isinstance(reader, IndexReader)
    assert reader.device == torch.device("cpu")
    if torch.cuda.is_available():
        assert pidx.reader().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            pidx.reader()
        with pytest.raises(RuntimeError, match="CUDA"):
            IndexReader(pidx)


# host modules the single-query path copied verbatim: the same source as
# the JAX package's, up to the package name (score_functions.py and
# script.py differ: their dense evaluators also take a torch namespace)
VERBATIM = ["models/bm25.py", "query/datetime_util.py", "query/phrase.py",
            "query/planner.py", "query/sort.py", "index/highlight.py",
            "query/aggs.py", "query/sketches.py"]


@pytest.mark.parametrize("rel", VERBATIM)
def test_copied_host_modules_match_the_jax_package(rel):
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "searchlite_tpu", rel)) as fh:
        jax_src = fh.read()
    with open(os.path.join(repo, "searchlite_tpu_torch", rel)) as fh:
        port_src = fh.read()
    assert port_src == jax_src.replace("searchlite_tpu.",
                                       "searchlite_tpu_torch.")


# -- host aggregation collectors and sketches ---------------------------------

HOST_AGGS = {
    "terms_sub": {"type": "terms", "field": "cat", "aggs": {
        "r": {"type": "stats", "field": "rank"},
        "top": {"type": "top_hits", "size": 2}}},
    "terms_numeric_missing": {"type": "terms", "field": "rank",
                              "missing": 99, "size": 5},
    "histogram": {"type": "histogram", "field": "rank", "interval": 3,
                  "offset": 1, "aggs": {
                      "n": {"type": "value_count", "field": "rank"}}},
    "date_histogram": {"type": "date_histogram", "field": "rank",
                       "fixed_interval": "4ms"},
    "range": {"type": "range", "field": "rank", "ranges": [
        {"to": 4}, {"from": 4, "to": 12}, {"from": 10}]},
    "filter": {"type": "filter",
               "filter": {"KeywordEq": {"field": "cat", "value": "b"}},
               "aggs": {"r": {"type": "extended_stats", "field": "rank"}}},
    "stats": {"type": "stats", "field": "rank"},
    "extended_stats": {"type": "extended_stats", "field": "rank"},
    "value_count": {"type": "value_count", "field": "cat"},
    "percentiles": {"type": "percentiles", "field": "rank",
                    "percents": [5, 50, 99]},
    "percentile_ranks": {"type": "percentile_ranks", "field": "rank",
                         "values": [3, 9]},
    "cardinality": {"type": "cardinality", "field": "rank"},
    "cardinality_sketch": {"type": "cardinality", "field": "rank",
                           "precision_threshold": 4},
    "significant_terms": {"type": "significant_terms", "field": "cat"},
    "rare_terms": {"type": "rare_terms", "field": "rank",
                   "max_doc_count": 70},
    "composite": {"type": "composite", "size": 7, "sources": [
        {"type": "terms", "name": "c", "field": "cat"},
        {"type": "histogram", "name": "r", "field": "rank",
         "interval": 4}]},
    "sampled": {"type": "terms", "field": "cat",
                "sampling": {"probability": 0.5, "seed": 3}},
    "top_hits": {"type": "top_hits", "size": 3,
                 "sort": [{"field": "rank", "order": "desc"}]},
    "pipeline": {"type": "sum_bucket", "buckets_path": "histogram>n.value"},
}


def state_of(obj):
    """A collector state as plain data: dataclasses and sketch objects by
    their attributes, sets sorted, arrays as (dtype, shape, bytes)."""
    if isinstance(obj, np.ndarray):
        return ("array", str(obj.dtype), obj.shape, obj.tobytes())
    if isinstance(obj, dict):
        return {repr(k): state_of(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [state_of(v) for v in obj]
    if isinstance(obj, (set, frozenset)):
        return sorted(repr(v) for v in obj)
    if hasattr(obj, "__dict__"):
        return (type(obj).__name__, state_of(vars(obj)))
    if hasattr(obj, "__slots__"):
        return (type(obj).__name__,
                {k: state_of(getattr(obj, k)) for k in obj.__slots__})
    return obj


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_agg_collectors_equal(segments, seed):
    """The same seeded matched sets through both packages' collectors:
    equal per-segment intermediates (sketch states included, byte for
    byte) and equal merged, finalized output."""
    from searchlite_tpu.query.aggs import AggregationPipeline as JaxPipe
    from searchlite_tpu_torch.query.aggs import AggregationPipeline

    rng = np.random.default_rng(seed)
    jpipe = JaxPipe(HOST_AGGS, ["w1"], None)
    ppipe = AggregationPipeline(HOST_AGGS, ["w1"], None)
    j_inter, p_inter = [], []
    for so, (jseg, _jd, pseg, _pd) in enumerate(segments):
        keep = rng.random(jseg.doc_count) < (0.2, 0.6, 1.0)[seed]
        matched = np.flatnonzero(keep).astype(np.int64)
        j_inter.append(jpipe.collect_segment(jseg, so, matched))
        p_inter.append(ppipe.collect_segment(pseg, so, matched.copy()))
        assert state_of(p_inter[-1]) == state_of(j_inter[-1])
    j_inter.append(jpipe.empty_intermediate())
    p_inter.append(ppipe.empty_intermediate())
    want = jpipe.merge_and_finalize(j_inter)
    got = ppipe.merge_and_finalize(p_inter)
    assert got == want
    assert set(got) == set(HOST_AGGS)
    assert got["cardinality"]["value"] == 16


@pytest.mark.parametrize("seed", [0, 1])
def test_sketch_states_equal_byte_for_byte(seed):
    from searchlite_tpu.query import sketches as jax_sk
    from searchlite_tpu_torch.query import sketches as port_sk

    rng = np.random.default_rng(seed)
    a = rng.normal(500, 100, 60_000)
    b = rng.integers(-1000, 1000, 9_000).astype(np.float64)
    states = []
    for sk in (jax_sk, port_sk):
        q1, q2 = sk.QuantileState(), sk.QuantileState()
        q1.push_values(a)          # past the exact window: a t-digest
        q2.push_values(b)
        q1.merge(q2)
        hll = sk.HllSketch()
        hll.add_hashes(sk.hash_f64(a))
        hll.add_hashes(sk.hash_i64(b.astype(np.int64)))
        card = sk.CardinalityState(precision_threshold=100)
        card.add_hashes(sk.hash_str_dict([f"k{i}" for i in range(500)]))
        exact = sk.CardinalityState()
        exact.add_hashes(sk.hash_i64(np.arange(50)))
        card.merge(exact)
        states.append(state_of({
            "quantile": q1, "hll": hll, "card": card,
            "answers": [q1.percentile(50.0), q1.percentile_rank(480.0),
                        hll.estimate(), card.value(),
                        int(sk.hash_str("abc"))]}))
        assert not q1.is_exact
    assert states[0] == states[1]
