"""Single-query ``search(mesh=)`` and the aggregation partials of the torch
port (``parallel/query.py``, ``IndexReader._search_segment_sharded``,
``ops/vector.py::vector_topk_sharded``) against the JAX package's mesh
(tests/test_parallel.py ``TestShardedFullQuery``, ``TestShardedVectors``,
``TestShardedAggPartials``): the same index through both readers, the
JAX reader on its virtual CPU devices, the port on as many CPU shards.
The port's mesh answer is also held to its own one-device answer.

Tolerance: f32_strict (rtol 1e-6, atol 1e-4 a score; ids equal away from
near-ties); counts, groups and aggregation keys equal; cursors compared
by their decoded keys (divergence D10); the partials exact (counts) or
within f32 reassociation of numpy's f64 sums.
"""

import random

import numpy as np
import pytest
import torch

import test_parallel
from searchlite_tpu.api.types import IndexOptions, StorageType
from searchlite_tpu.index import Index
from searchlite_tpu.index.manifest import Schema
from searchlite_tpu.parallel.mesh import make_mesh as jax_make_mesh
from searchlite_tpu.parallel.query import (
    make_sharded_range_counts as jax_range_counts,
    make_sharded_stats_partial as jax_stats_partial,
    make_sharded_terms_counts as jax_terms_counts,
)
from searchlite_tpu_torch.api.reader import IndexReader
from searchlite_tpu_torch.parallel.mesh import make_mesh
from searchlite_tpu_torch.parallel.query import (
    make_sharded_range_counts,
    make_sharded_stats_partial,
    make_sharded_terms_counts,
    pad_doc_axis,
)
from test_torch_search import (
    assert_close_tree,
    assert_cursors_equal,
    assert_hits_equal,
)

CPU = torch.device("cpu")
SHARDS = [1, 2, 4, 8]
REQUESTS = test_parallel.TestShardedFullQuery.REQUESTS


@pytest.fixture(autouse=True)
def strict(monkeypatch):
    monkeypatch.setenv("SEARCHLITE_PRECISION", "f32_strict")


def cpu_mesh(n):
    return make_mesh(devices=[CPU] * n)


def assert_same_result(got, want):
    assert got.total_hits_estimate == want.total_hits_estimate
    assert got.total_groups == want.total_groups
    assert_hits_equal(got.hits, want.hits)
    assert_cursors_equal(got.next_cursor, want.next_cursor)
    assert_close_tree(got.aggregations, want.aggregations, "aggregations")


@pytest.fixture(scope="module")
def full_index():
    """tests/test_parallel.py's two-segment index with tombstones."""
    rng = random.Random(31)
    vocab = [f"w{i}" for i in range(50)]
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
        }))
    writer = idx.writer()
    n = 0
    for _seg in range(2):
        for _ in range(400):
            writer.add_document({
                "_id": str(n),
                "body": " ".join(rng.choices(
                    vocab, weights=[1 / (j + 1) for j in range(50)],
                    k=rng.randint(3, 20))),
                "cat": rng.choice(["a", "b", "c"]),
                "rank": rng.randint(0, 40),
            })
            n += 1
        writer.commit()
    writer = idx.writer()
    writer.delete_documents([str(i) for i in range(0, 50, 7)])
    writer.commit()
    return idx


@pytest.fixture(scope="module")
def readers(full_index):
    return full_index.reader(), IndexReader(full_index, device="cpu")


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("req_i", range(len(REQUESTS)))
def test_mesh_matches_jax_mesh(readers, req_i, n):
    jreader, port = readers
    req = REQUESTS[req_i]
    want = jreader.search(dict(req), mesh=jax_make_mesh(n, query_axis=1))
    before = port.single_routes["mesh"]
    got = port.search(dict(req), mesh=cpu_mesh(n))
    assert port.single_routes["mesh"] - before == 2  # both segments
    assert_same_result(got, want)
    assert_same_result(got, port.search(dict(req)))


def test_mesh_cursor_pagination(readers):
    """Each reader follows its own cursors; pages and decoded cursor keys
    agree with the JAX mesh and with the port's own meshless pages."""
    jreader, port = readers
    req = {"query": "w1 w2 w5", "limit": 7}
    runs = ((jreader, {"mesh": jax_make_mesh(8, query_axis=1)}),
            (port, {"mesh": cpu_mesh(8)}), (port, {}))
    pages = []
    for reader, kw in runs:
        cursor, results = None, []
        for _ in range(4):
            r = reader.search(dict(req, **({"cursor": cursor}
                                           if cursor else {})), **kw)
            results.append(r)
            cursor = r.next_cursor
            if cursor is None:
                break
        pages.append(results)
    assert len(pages[0]) == len(pages[1]) == len(pages[2]) == 4
    for ref, got, own in zip(*pages):
        assert_same_result(got, ref)
        assert_same_result(got, own)


def test_mesh_scroll_drains_like_one_device(readers):
    _jreader, port = readers
    req = {"query": "w3 w4", "limit": 9,
           "sort": [{"field": "rank", "order": "asc"}]}
    got = port.search_scroll(dict(req), mesh=cpu_mesh(4), block_docs=40)
    want = port.search_scroll(dict(req), block_docs=40)
    assert [h.doc_id for p in got for h in p.hits] == \
        [h.doc_id for p in want for h in p.hits]


def test_mesh_profile_counts_the_route(readers):
    _jreader, port = readers
    req = {"query": "w1 w4 w9", "limit": 10, "profile": True,
           "execution": "wand"}
    got = port.search(dict(req), mesh=cpu_mesh(4))
    want = port.search(dict(req))
    assert got.profile["execution"]["scored_docs"] \
        == want.profile["execution"]["scored_docs"]


def test_device_side_terms_agg_partials(readers):
    """Per-shard bucket counts summed across shards equal the JAX mesh's
    and a host count over the same mask."""
    _jreader, port = readers
    seg = port.segments[0]
    dseg = port.device_segments[0]
    col = seg.fast.column("cat")
    n1 = dseg.n1
    ids = np.full(n1, -1, dtype=np.int32)
    present = np.diff(col.offsets) > 0
    first = col.offsets[:-1][present]
    ids[:seg.doc_count][present] = col.value_ids[first] \
        if hasattr(col, "value_ids") else col.values[first]
    mask = np.zeros(n1, dtype=bool)
    docs, _tfs = seg.postings.term_postings(seg.terms.get("body:w1"))
    mask[docs] = True
    mask &= ~dseg.host.deleted_np
    n_buckets = int(ids.max()) + 1
    expected = np.bincount(ids[mask & (ids >= 0)], minlength=n_buckets)
    import jax.numpy as jnp

    for n in SHARDS:
        n1p = -(-n1 // n) * n
        got = make_sharded_terms_counts(cpu_mesh(n))(
            pad_doc_axis(ids, n1p, -1), pad_doc_axis(mask, n1p, False),
            n_buckets=n_buckets)
        ref = jax_terms_counts(jax_make_mesh(n, query_axis=1))(
            jnp.asarray(pad_doc_axis(ids, n1p, -1)),
            jnp.asarray(pad_doc_axis(mask, n1p, False)),
            n_buckets=n_buckets)
        assert got.dtype == torch.int64
        assert np.array_equal(got.numpy(), expected)
        assert np.array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("n", SHARDS)
def test_sharded_stats_and_range_partials(n):
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    n1 = 1024
    vals = rng.uniform(0, 100, size=n1).astype(np.float32)
    has = rng.random(n1) < 0.8
    mask = rng.random(n1) < 0.5
    mask[n1 - 1] = False
    n1p = -(-n1 // n) * n
    args = [pad_doc_axis(x, n1p, fill)
            for x, fill in ((vals, 0.0), (has, False), (mask, False))]
    count, total, total_sq, vmin, vmax = make_sharded_stats_partial(
        cpu_mesh(n))(*args)
    jc, jt, jts, jmin, jmax = (np.asarray(x) for x in jax_stats_partial(
        jax_make_mesh(n, query_axis=1))(*(jnp.asarray(a) for a in args)))
    ok = has & mask
    ref64 = vals[ok].astype(np.float64)
    assert count.dtype == torch.int64 and int(count) == int(ok.sum()) \
        == int(jc)
    assert total.dtype == torch.float64
    assert float(vmin) == float(vals[ok].min()) == float(jmin)
    assert float(vmax) == float(vals[ok].max()) == float(jmax)
    assert float(total) == pytest.approx(float(ref64.sum()), rel=1e-12)
    assert float(total_sq) == pytest.approx(float((ref64 ** 2).sum()),
                                            rel=1e-12)
    # the JAX sums accumulate in f32
    assert float(total) == pytest.approx(float(jt), rel=1e-5)
    assert float(total_sq) == pytest.approx(float(jts), rel=1e-4)
    rows = np.stack([(vals >= 0) & (vals < 30) & has,
                     (vals >= 20) & (vals < 80) & has,  # overlaps
                     (vals >= 80) & has])
    rows_p = pad_doc_axis(rows, n1p, False)
    mask_p = pad_doc_axis(mask, n1p, False)
    counts = make_sharded_range_counts(cpu_mesh(n))(rows_p, mask_p)
    ref = np.asarray(jax_range_counts(jax_make_mesh(n, query_axis=1))(
        jnp.asarray(rows_p), jnp.asarray(mask_p)))
    want = (rows & mask).sum(axis=1)
    assert np.array_equal(counts.numpy(), want)
    assert np.array_equal(counts.numpy(), ref)


def test_stats_partial_on_an_empty_selection():
    z = np.zeros(64, dtype=bool)
    count, total, total_sq, vmin, vmax = make_sharded_stats_partial(
        cpu_mesh(4))(np.ones(64, dtype=np.float32), z, z)
    assert (int(count), float(total), float(total_sq)) == (0, 0.0, 0.0)
    assert float(vmin) == np.inf and float(vmax) == -np.inf


# -- vectors -----------------------------------------------------------------


def vector_index(seed, metric, quantization, n=300, dim=8):
    rng = random.Random(seed)
    idx = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY),
        Schema.from_json({
            "text_fields": [{"name": "body", "analyzer": "default",
                             "stored": False, "indexed": True}],
            "keyword_fields": [{"name": "tag", "stored": False,
                                "indexed": True, "fast": True}],
            "vector_fields": [{"name": "emb", "dim": dim, "metric": metric,
                               "quantization": quantization}],
        }))
    writer = idx.writer()
    for i in range(n):
        doc = {"_id": str(i), "tag": "xyz"[i % 3],
               "body": " ".join(rng.choices(
                   [f"w{j}" for j in range(30)], k=8))}
        if i % 7 != 0:  # some docs lack vectors
            doc["emb"] = [rng.gauss(0, 1) for _ in range(dim)]
        writer.add_document(doc)
        if i == n // 2:
            writer.commit()
    writer.commit()
    writer.delete_documents([str(i) for i in range(3, n, 11)])
    writer.commit()
    return idx


@pytest.mark.parametrize("quant", [None, "bf16", "int8"])
@pytest.mark.parametrize("metric", ["Cosine", "L2"])
def test_vector_and_hybrid_mesh_match(metric, quant):
    index = vector_index(47, metric, quant)
    jreader = index.reader()
    port = IndexReader(index, device="cpu")
    rng = random.Random(3)
    q = [rng.gauss(0, 1) for _ in range(8)]
    reqs = [
        {"query": {"type": "vector", "field": "emb", "vector": q,
                   "alpha": 0.0}, "limit": 10},
        {"query": {"type": "bool", "should": [
            {"type": "term", "field": "body", "value": "w3"},
            {"type": "vector", "field": "emb", "vector": q,
             "alpha": 0.5}]}, "limit": 10},
        {"query": "w1 w2", "limit": 8,
         "filter": {"KeywordIn": {"field": "tag", "values": ["x", "z"]}},
         "vector_query": {"field": "emb", "vector": q, "alpha": 0.5}},
    ]
    for req in reqs:
        want = jreader.search(dict(req), mesh=jax_make_mesh(8, query_axis=1))
        got = port.search(dict(req), mesh=cpu_mesh(8))
        assert_same_result(got, want)
        assert [h.vector_score is None for h in got.hits] == \
            [h.vector_score is None for h in want.hits]
        assert_same_result(got, port.search(dict(req)))


@pytest.mark.parametrize("n", [1, 3, 8])
def test_vector_topk_sharded_equals_one_device(n):
    """``vector_topk_sharded`` at any shard count (rows pad to a multiple
    of it) equals ``vector_topk``; buffers cache per mesh and eviction
    drops them."""
    from searchlite_tpu_torch.ops.vector import (
        vector_topk,
        vector_topk_sharded,
    )

    index = vector_index(5, "Cosine", "int8", n=101)
    port = IndexReader(index, device="cpu")
    dseg = port.device_segments[0]
    vdata = dseg.reader.vectors["emb"]
    rows = vdata.vectors.shape[0]
    mask = np.random.default_rng(1).random(rows) < 0.7
    q = np.random.default_rng(2).normal(size=(2, 8)).astype(np.float32)
    for quant in (None, "bf16", "int8"):
        for metric in ("cosine", "l2"):
            got = vector_topk_sharded(vdata, mask, q, 12, metric,
                                      cpu_mesh(n), quantization=quant)
            want = vector_topk(vdata, mask, q, 12, metric,
                               quantization=quant, device="cpu")
            assert np.array_equal(got[1], want[1])
            assert np.array_equal(got[0], want[0])
    assert vdata.__dict__["_torch_sharded"]
    dseg.evict_device_caches()
    assert "_torch_sharded" not in vdata.__dict__
