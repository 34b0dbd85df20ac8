"""The torch port's batched reader (searchlite_tpu_torch/api/reader.py,
``device="cpu"``) against the JAX reader and a numpy BM25 oracle, on a
two-segment index with tombstones.

Tolerance is bench.py's f32_strict gate (``verify_vs_oracle``: rtol 1e-6,
atol 1e-4 per score, plus a top-k set check): the JAX reader may take its
dense route, whose sums run in another order (divergence D10). Ids are
compared where scores are finite and not near-tied. Also covered: state
carried from the JAX segment (``from_host_arrays``, bit for bit), rows
over the strip cap, the JAX reader on the oversized-corpus route,
coalesced streams, per-query limits, both outputs, and the options that
once raised (mesh, aggregations, the doc-sharded scan)."""

import numpy as np
import pytest
import torch

from searchlite_tpu.api.types import IndexOptions, StorageType
from searchlite_tpu.index import Index
from searchlite_tpu.index.manifest import Schema
from searchlite_tpu_torch.api.reader import IndexReader
from searchlite_tpu_torch.device.index import TENSOR_KEYS, from_host_arrays

VOCAB = [f"w{i}" for i in range(200)]
RTOL, ATOL = 1e-6, 1e-4  # bench.py:205-207, f32_strict


def build_index(seed=21, n_docs=1600, delete_every=11):
    rng = np.random.default_rng(seed)
    probs = 1.0 / np.arange(1, len(VOCAB) + 1)
    probs /= probs.sum()
    idx = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY),
        Schema.from_json({
            "text_fields": [{"name": "body", "analyzer": "default",
                             "stored": False, "indexed": True}],
            "keyword_fields": [{"name": "cat", "stored": False,
                                "indexed": True, "fast": True}],
            "numeric_fields": [{"name": "rank", "type": "i64",
                                "stored": False, "fast": True}]}))
    writer = idx.writer()
    for i in range(n_docs):
        n = int(rng.integers(4, 60))
        writer.add_document({"_id": str(i), "body": " ".join(
            rng.choice(VOCAB, size=n, p=probs)), "rank": i % 16,
            "cat": "abc"[i % 3]})
        if i == n_docs * 2 // 3:
            writer.commit()
    writer.commit()
    w2 = idx.writer()
    for i in range(3, n_docs, delete_every):
        w2.delete_document(str(i))
    w2.commit()
    return idx


def make_queries(seed, n, max_terms=5):
    rng = np.random.default_rng(seed)
    probs = 1.0 / np.arange(1, len(VOCAB) + 1) ** 0.7
    probs /= probs.sum()
    out = []
    for _ in range(n):
        terms = list(rng.choice(VOCAB, size=int(rng.integers(1, max_terms)),
                                p=probs))
        if rng.random() < 0.2:
            terms.append(terms[0])  # repeated term: occ 2
        out.append(" ".join(terms))
    return out


@pytest.fixture(scope="module")
def index():
    return build_index()


@pytest.fixture(autouse=True)
def strict(monkeypatch):
    monkeypatch.setenv("SEARCHLITE_PRECISION", "f32_strict")


def oracle(reader, raw):
    """{(seg_ord, doc): f32 BM25 score} of the live docs matching
    ``raw`` (bench.py::_oracle_scores per segment, tombstones dropped)."""
    k1, b = 0.9, 0.4
    out = {}
    for so, (seg, dseg) in enumerate(zip(reader.segments,
                                         reader.device_segments)):
        col = seg.fast.column("_len:body")
        doc_len = np.zeros(seg.doc_count, dtype=np.float32)
        doc_len[col.row_ids] = col.values.astype(np.float32)
        avg = seg.avg_field_length("body")
        live = float(dseg.live_docs)
        scores = np.zeros(seg.doc_count, dtype=np.float32)
        for token in raw.split():
            tid = seg.terms.get(f"body:{token}")
            if tid is None:
                continue
            df = float(seg.postings.term_df[tid])
            ratio = (live - df + 0.5) / (df + 0.5)  # df counts tombstones
            idf = max(np.log(ratio), 0.0) + 1.0 if ratio > 0 else 1.0
            docs, tfs = seg.postings.term_postings(tid)
            denom = np.maximum(
                tfs + k1 * (1 - b + b * doc_len[docs] / avg), 1e-6)
            np.add.at(scores, docs, idf * tfs * (k1 + 1) / denom)
        for d in np.flatnonzero(scores > 0):
            if int(d) not in seg.deleted:
                out[(so, int(d))] = float(scores[d])
    return out


def check_vs_oracle(reader, queries, arrays, limits):
    scores, ids, segs = arrays
    for qi, raw in enumerate(queries):
        truth = oracle(reader, raw)
        n = int(np.isfinite(scores[qi]).sum())
        assert n == min(int(limits[qi]), len(truth)), raw
        got = {(int(segs[qi, j]), int(ids[qi, j])) for j in range(n)}
        for j in range(n):
            want = truth[(int(segs[qi, j]), int(ids[qi, j]))]
            assert abs(scores[qi, j] - want) <= ATOL + RTOL * abs(want), raw
        if n:
            floor = min(truth[key] for key in got)
            best_out = max((s for key, s in truth.items() if key not in got),
                           default=0.0)
            assert best_out <= floor + ATOL + RTOL * abs(best_out), raw


def assert_close_arrays(ref, got):
    """(scores, ids, segs) of two readers: finite masks equal, scores
    within tolerance, ids equal except near-ties."""
    rs, ri, rg = ref
    gs, gi, gg = got
    assert rs.shape == gs.shape
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


def pairs_to_arrays(reader, pairs, k):
    """Pairs output -> (scores, ids, segs) arrays for the shared checks
    (doc ids are unique across segments in these corpora)."""
    where = {}
    for so, seg in enumerate(reader.segments):
        for ordinal, doc_id in enumerate(seg.doc_ids):
            where[doc_id] = (so, ordinal)
    q = len(pairs)
    scores = np.full((q, k), -np.inf, dtype=np.float32)
    ids = np.zeros((q, k), dtype=np.int32)
    segs = np.zeros((q, k), dtype=np.int32)
    for qi, row in enumerate(pairs):
        for j, (doc_id, s) in enumerate(row):
            scores[qi, j] = s
            segs[qi, j], ids[qi, j] = where[doc_id]
    return scores, ids, segs


def test_from_host_arrays_carries_jax_segment_state(index):
    jax_reader = index.reader()
    port = IndexReader(index, device="cpu")
    assert len(port.device_segments) == 2
    tombstoned = 0
    for jd, td in zip(jax_reader.device_segments, port.device_segments):
        arrays = {key: np.asarray(getattr(jd, key)) for key in TENSOR_KEYS}
        carried = from_host_arrays(arrays, "cpu")
        for key in TENSOR_KEYS:
            a, b = carried[key], getattr(td, key)
            assert a.dtype == b.dtype and a.shape == b.shape, key
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8)), key
        # the live table is derived on the device from the raw one
        live = np.asarray(jd.block_impacts_live)
        assert torch.equal(td.block_impacts_live.view(torch.uint8),
                           torch.from_numpy(live.copy()).view(torch.uint8))
        tombstoned += int((live != jd.block_impacts_np).sum())
        assert td.n1 == jd.n1 and td.live_docs == jd.live_docs
    assert tombstoned > 0  # the tombstones really fold into the impacts


@pytest.mark.parametrize("output", ["arrays", "pairs"])
def test_matches_jax_and_oracle_with_limits(index, output):
    queries = make_queries(1, 48)
    limits = np.random.default_rng(2).integers(1, 16, len(queries))
    port = IndexReader(index, device="cpu")
    got = port.search_batch_many([queries], limit=10, limits=[limits],
                                 output=output)[0]
    ref = index.reader().search_batch_many([queries], limit=10,
                                           limits=[limits], output=output)[0]
    if output == "pairs":
        k = int(limits.max())
        got = pairs_to_arrays(port, got, k)
        ref = pairs_to_arrays(port, ref, k)
    assert_close_arrays(ref, got)
    check_vs_oracle(port, queries, got, limits)


def test_coalesced_stream_matches_batches(index, monkeypatch):
    batches = [make_queries(s, 24) for s in (3, 4, 5, 6, 7)]
    port = IndexReader(index, device="cpu")
    monkeypatch.setenv("SEARCHLITE_BATCH_COALESCE", "64")
    stream = port.search_batch_many(batches, limit=7, output="arrays")
    monkeypatch.setenv("SEARCHLITE_BATCH_COALESCE", "0")
    jax_reader = index.reader()
    for b, got in zip(batches, stream):
        assert got[0].shape == (24, 7)
        own = port.search_batch_many([b], limit=7, output="arrays")[0]
        assert_close_arrays(own, got)
        ref = jax_reader.search_batch_many([b], limit=7, output="arrays")[0]
        assert_close_arrays(ref, got)
    check_vs_oracle(port, batches[2], stream[2], np.full(24, 7))


def test_rows_over_the_cap_take_full_strips(index, monkeypatch):
    """Over the dense-M budget, rows over the strip cap (and unsound
    term-split rows) are scored on full strips."""
    monkeypatch.setenv("SEARCHLITE_M_BUDGET_BYTES", "1")
    monkeypatch.setenv("SEARCHLITE_SPARSE_MAX_BLOCKS", "2")
    port = IndexReader(index, device="cpu")
    calls = []
    full = port._full_strip_launch

    def spy(dseg, qb, k):
        calls.append(int(qb["n_queries"]))
        return full(dseg, qb, k)

    monkeypatch.setattr(port, "_full_strip_launch", spy)
    queries = make_queries(8, 40, max_terms=7)
    got = port.search_batch_many([queries], limit=10, output="arrays")[0]
    assert calls  # some rows were over the 2-block cap
    ref = index.reader().search_batch_many([queries], limit=10,
                                           output="arrays")[0]
    assert_close_arrays(ref, got)
    check_vs_oracle(port, queries, got, np.full(len(queries), 10))


def test_jax_on_the_oversized_route_agrees(index, monkeypatch):
    """SEARCHLITE_M_BUDGET_BYTES=1 sends the JAX reader down the route
    the headline corpus takes (oversized strips, term-split)."""
    monkeypatch.setenv("SEARCHLITE_M_BUDGET_BYTES", "1")
    queries = make_queries(9, 40)
    ref = index.reader().search_batch_many([queries], limit=10,
                                           output="arrays")[0]
    got = IndexReader(index, device="cpu").search_batch_many(
        [queries], limit=10, output="arrays")[0]
    assert_close_arrays(ref, got)


def test_explicit_table_route(index, monkeypatch):
    """A query repeating one term more than 31 times cannot use the
    packed upload (OCC_MAX): the whole batch rides the explicit table."""
    import searchlite_tpu_torch.api.reader as port_reader

    calls = []
    scorer = port_reader.sparse_candidate_scorer

    def spy(*args, **kwargs):
        calls.append(kwargs["nblk"])
        return scorer(*args, **kwargs)

    monkeypatch.setattr(port_reader, "sparse_candidate_scorer", spy)
    queries = make_queries(10, 30) + [" ".join(["w5"] * 33 + ["w9"]),
                                      "w2 " * 40]
    got = IndexReader(index, device="cpu").search_batch_many(
        [queries], limit=12, output="arrays")[0]
    assert calls
    ref = index.reader().search_batch_many([queries], limit=12,
                                           output="arrays")[0]
    assert_close_arrays(ref, got)


def test_python_prep_for_queries_native_prep_rejects(index):
    """Field prefixes and hyphens send a batch through the Python
    analyzer (build_impact_batch) instead of the native prep."""
    queries = ["body:w3 w4", "w10-w11 w2", "w7", "body:w1 body:w12 w40"]
    got = IndexReader(index, device="cpu").search_batch_many(
        [queries], limit=8, output="arrays")[0]
    ref = index.reader().search_batch_many([queries], limit=8,
                                           output="arrays")[0]
    assert np.isfinite(got[0]).all()
    assert_close_arrays(ref, got)


def test_unported_options_raise(index, monkeypatch):
    """Nothing raises any more: a batch over a mesh answers with the
    one-device answer, search()'s aggregations answer, and over the
    dense-M budget filtered and k > 1024 batches take the doc-sharded
    scan, with the under-budget answers."""
    from searchlite_tpu_torch.parallel.mesh import make_mesh

    port = IndexReader(index, device="cpu")
    q = ["w1 w2"]
    mesh = make_mesh(devices=[torch.device("cpu")] * 2)
    assert_close_arrays(
        port.search_batch_many([q], limit=10, output="arrays")[0],
        port.search_batch_many([q], limit=10, output="arrays",
                               mesh=mesh)[0])
    for execution in ("wand", "bmw"):
        assert port.search_batch(q, execution=execution) == \
            port.search_batch(q)
    agg_req = {"query": "w1", "limit": 5,
               "aggs": {"c": {"type": "terms", "field": "cat"}}}
    assert port.search(agg_req).aggregations == \
        index.reader().search(agg_req).aggregations
    assert port.search({"query": "w1", "limit": 5}).hits
    assert port.search_batch([], limit=5) == []
    assert port.search_batch(q, filters=[None])[0]
    cases = ({"limit": 1025},
             {"filters": [{"I64Range": {"field": "rank",
                                        "min": 0, "max": 3}}]})
    under = [port.search_batch(q, **kwargs) for kwargs in cases]
    monkeypatch.setenv("SEARCHLITE_M_BUDGET_BYTES", "4096")
    for kwargs, want in zip(cases, under):
        got = port.search_batch(q, **kwargs)
        assert [d for d, _s in got[0]] == [d for d, _s in want[0]]
        assert np.allclose([s for _d, s in got[0]],
                           [s for _d, s in want[0]], rtol=RTOL, atol=ATOL)
        assert len(got[0]) > 5
    assert port.route_rows["sharded"] > 0
    assert port.search_batch([], limit=5) == []


# -- the under-budget route: term split, dense scorers, filters, k > 1024 --

FILTERS = [None, {"I64Range": {"field": "rank", "min": 0, "max": 3}},
           {"KeywordEq": {"field": "cat", "value": "a"}},
           {"And": [{"KeywordEq": {"field": "cat", "value": "b"}},
                    {"I64Range": {"field": "rank", "min": 4, "max": 11}}]},
           {"I64Range": {"field": "rank", "min": 100, "max": 200}}]


def filtered_oracle(reader, raw, filt):
    """:func:`oracle` restricted to the docs passing ``filt``."""
    from searchlite_tpu.api.types import Filter
    from searchlite_tpu.query.filters import compute_filters_mask

    truth = oracle(reader, raw)
    if filt is None:
        return truth
    masks = [compute_filters_mask(seg.fast, [Filter.from_json(filt)])
             for seg in reader.segments]
    return {key: s for key, s in truth.items() if masks[key[0]][key[1]]}


def check_filtered_vs_oracle(reader, queries, filters, arrays, limit):
    scores, ids, segs = arrays
    for qi, (raw, filt) in enumerate(zip(queries, filters)):
        truth = filtered_oracle(reader, raw, filt)
        n = int(np.isfinite(scores[qi]).sum())
        assert n == min(limit, len(truth)), (raw, filt)
        for j in range(n):
            want = truth[(int(segs[qi, j]), int(ids[qi, j]))]
            assert abs(scores[qi, j] - want) <= ATOL + RTOL * abs(want)


def split_env(monkeypatch, max_blocks="4"):
    """Small strip caps, so the 1,600-doc corpus has head terms: rows
    with them take the term split, rows over the cap go dense."""
    monkeypatch.setenv("SEARCHLITE_SPARSE_MAX_BLOCKS", max_blocks)
    monkeypatch.setenv("SEARCHLITE_SPLIT_UB_RATIO", "0")


def test_term_split_and_dense_remainder(index, monkeypatch):
    split_env(monkeypatch)
    queries = make_queries(11, 64, max_terms=6)
    port = IndexReader(index, device="cpu")
    got = port.search_batch_many([queries], limit=10, output="arrays")[0]
    assert port.route_rows["split"] > 0 and port.route_rows["dense"] > 0
    assert port.route_rows["strip"] > 0
    ref = index.reader().search_batch_many([queries], limit=10,
                                           output="arrays")[0]
    assert_close_arrays(ref, got)
    check_vs_oracle(port, queries, got, np.full(len(queries), 10))


def test_forced_fallbacks_match_jax_counts(index, monkeypatch):
    """A limit past a rare light term's df leaves theta at -inf under a
    head term's HUB: the certificate fails and the row is re-scored in
    the fallback wave, in both packages alike."""
    split_env(monkeypatch)
    queries = ["w199 w0", "w198 w1 w2", "w0 w197", "w150 w3",
               "w190 w0 w1"] * 3 + make_queries(12, 20)
    port = IndexReader(index, device="cpu")
    jax_reader = index.reader()
    got = port.search_batch_many([queries], limit=40, output="arrays")[0]
    ref = jax_reader.search_batch_many([queries], limit=40,
                                       output="arrays")[0]
    fallbacks = getattr(jax_reader, "_split_fallback_rows", 0)
    assert fallbacks > 0
    assert port._split_fallback_rows == fallbacks
    assert port.route_rows["fallback"] == fallbacks
    assert_close_arrays(ref, got)
    check_vs_oracle(port, queries, got, np.full(len(queries), 40))


@pytest.mark.parametrize("limit", [10, 70])
def test_filtered_batches(index, limit):
    rng = np.random.default_rng(limit)
    queries = make_queries(13 + limit, 40)
    filters = [FILTERS[int(i)] for i in rng.integers(0, len(FILTERS),
                                                     len(queries))]
    filters[0] = FILTERS[-1]  # matches nothing
    port = IndexReader(index, device="cpu")
    got = port.search_batch_many([queries], limit=limit, filters=[filters],
                                 output="arrays")[0]
    # filtered rows go dense, in each of the two segments
    assert port.route_rows["dense"] == 2 * len(queries)
    assert np.isneginf(got[0][0]).all()
    ref = index.reader().search_batch_many(
        [queries], limit=limit, filters=[filters], output="arrays")[0]
    assert_close_arrays(ref, got)
    check_filtered_vs_oracle(port, queries, filters, got, limit)
    pairs = port.search_batch(queries, limit=limit, filters=filters)
    assert_close_arrays(ref, pairs_to_arrays(port, pairs, limit))


def test_k_over_1024_goes_dense(index):
    queries = make_queries(14, 12)
    port = IndexReader(index, device="cpu")
    got = port.search_batch_many([queries], limit=1100, output="arrays")[0]
    # k clamps to each segment's n1: a segment of n1 <= 1024 keeps strips
    wide = sum(d.n1 > 1024 for d in port.device_segments)
    assert wide and port.route_rows["dense"] == 12 * wide
    assert port.route_rows["strip"] == 12 * (2 - wide)
    ref = index.reader().search_batch_many([queries], limit=1100,
                                           output="arrays")[0]
    assert got[0].shape == (12, 1100)
    assert_close_arrays(ref, got)
    check_vs_oracle(port, queries, got, np.full(len(queries), 1100))


@pytest.mark.parametrize("env,scorer", [
    ("SEARCHLITE_SPARSE_MAX_BLOCKS", "split_impact_scorer"),
    ("SEARCHLITE_DENSE_M_BYTES", "impact_scorer")])
def test_all_dense_routes(index, monkeypatch, env, scorer):
    """SEARCHLITE_SPARSE_MAX_BLOCKS=0 sends every row dense (the split
    scorer: the head terms have resident rows); with
    SEARCHLITE_DENSE_M_BYTES=0 too there are no dense rows and the plain
    block scorer runs."""
    import searchlite_tpu_torch.api.reader as port_reader

    monkeypatch.setenv("SEARCHLITE_SPARSE_MAX_BLOCKS", "0")
    monkeypatch.setenv(env, "0")
    calls = []
    real = getattr(port_reader, scorer)

    def spy(*args, **kwargs):
        calls.append(kwargs["k"])
        return real(*args, **kwargs)

    monkeypatch.setattr(port_reader, scorer, spy)
    queries = make_queries(15, 30)
    got = IndexReader(index, device="cpu").search_batch_many(
        [queries], limit=10, output="arrays")[0]
    assert len(calls) == 2  # one launch per segment
    ref = index.reader().search_batch_many([queries], limit=10,
                                           output="arrays")[0]
    assert_close_arrays(ref, got)
    check_vs_oracle(IndexReader(index, device="cpu"), queries, got,
                    np.full(len(queries), 10))


def test_oversized_route_admits_term_split_rows(index, monkeypatch):
    monkeypatch.setenv("SEARCHLITE_M_BUDGET_BYTES", "1")
    monkeypatch.setenv("SEARCHLITE_SPARSE_MAX_BLOCKS", "8")
    monkeypatch.setenv("SEARCHLITE_HEAVY_TERM_BLOCKS", "3")
    monkeypatch.setenv("SEARCHLITE_SPLIT_UB_RATIO", "0")
    queries = make_queries(16, 48) + ["w199 w0", "w198 w1 w2"]
    port = IndexReader(index, device="cpu")
    got = port.search_batch_many([queries], limit=30, output="arrays")[0]
    assert port.route_rows["split"] > 0 and port.route_rows["dense"] == 0
    jax_reader = index.reader()
    ref = jax_reader.search_batch_many([queries], limit=30,
                                       output="arrays")[0]
    assert port._split_fallback_rows == getattr(
        jax_reader, "_split_fallback_rows", 0)
    assert_close_arrays(ref, got)
    check_vs_oracle(port, queries, got, np.full(len(queries), 30))


def test_oversized_route_without_light_rows(index, monkeypatch):
    """Over the budget with a strip cap of 0 no row is light: every row
    rides full strips (the JAX reader takes its doc-sharded scan here;
    both are exact)."""
    monkeypatch.setenv("SEARCHLITE_M_BUDGET_BYTES", "1")
    monkeypatch.setenv("SEARCHLITE_SPARSE_MAX_BLOCKS", "0")
    queries = make_queries(17, 24)
    port = IndexReader(index, device="cpu")
    got = port.search_batch_many([queries], limit=10, output="arrays")[0]
    assert port.route_rows["strip"] == 2 * len(queries)
    ref = index.reader().search_batch_many([queries], limit=10,
                                           output="arrays")[0]
    assert_close_arrays(ref, got)
    check_vs_oracle(port, queries, got, np.full(len(queries), 10))
