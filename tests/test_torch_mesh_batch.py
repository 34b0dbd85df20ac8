"""Batched search doc-sharded over a mesh in the torch port
(``search_batch_many(mesh=)``: ``DeviceSegment.mesh_sparse_tables``,
``parallel/query.py::make_sharded_batch_scorer`` /
``make_sharded_dense_batch_scorer``) against the JAX package's mesh path,
the cases of tests/test_mesh_batch.py: the JAX reader on its 8 virtual CPU
devices, the port on 8 (or fewer) CPU shards, both over the same index.

Tolerance: bench.py's f32_strict gate (rtol 1e-6, atol 1e-4, ids equal
away from near-ties); tables array for array; the rows per route
(``route_rows["mesh_strip"]`` / ``["mesh_dense"]``) equal to the rows the
JAX reader sent each way.
"""

import dataclasses
import random

import numpy as np
import pytest
import torch

import searchlite_tpu.api.reader as jax_reader_mod
from searchlite_tpu.parallel.mesh import make_mesh as jax_make_mesh
from searchlite_tpu_torch.api.reader import IndexReader
from searchlite_tpu_torch.parallel.mesh import make_mesh
from test_sparse_batch import VOCAB, build_index, make_queries
from test_torch_reader import assert_close_arrays, pairs_to_arrays

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def index():
    return build_index(seed=9, n_docs=1600, segments=2, delete_every=11)


@pytest.fixture(autouse=True)
def strict(monkeypatch):
    monkeypatch.setenv("SEARCHLITE_PRECISION", "f32_strict")


def cpu_mesh(n):
    return make_mesh(devices=[CPU] * n)


def spy_jax_routes(monkeypatch, jreader):
    """Rows the JAX reader's mesh path sent to the shards' strips and to
    the heavy remainder, per call."""
    seen = {"light": 0, "heavy": 0}
    real = jax_reader_mod.IndexReader._launch_batch_mesh_segment

    def spy(self, *args, **kwargs):
        e = real(self, *args, **kwargs)
        seen["light"] += sum(len(rows) for rows, _s, _d in e["tiers"])
        seen["heavy"] += len(e["heavy_idx"])
        return e

    monkeypatch.setattr(jax_reader_mod.IndexReader,
                        "_launch_batch_mesh_segment", spy)
    return seen


def compare(index, port, queries, limit, n=8, **kw):
    """The JAX mesh answer, the port's mesh answer and the port's own
    one-device answer, held together (arrays)."""
    jreader = index.reader()
    ref = jreader.search_batch_many([queries], limit=limit, output="arrays",
                                    mesh=jax_make_mesh(n, query_axis=1),
                                    **kw)[0]
    got = port.search_batch_many([queries], limit=limit, output="arrays",
                                 mesh=cpu_mesh(n), **kw)[0]
    own = port.search_batch_many([queries], limit=limit, output="arrays",
                                 **kw)[0]
    assert_close_arrays(ref, got)
    assert_close_arrays(own, got)
    return got


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_mesh_matches_jax_mesh(index, n):
    port = IndexReader(index, device="cpu")
    queries = make_queries(random.Random(3), 40)
    compare(index, port, queries, 10, n=n)


@pytest.mark.parametrize("cap", [1, 2, 6])
def test_mesh_light_heavy_mix(index, monkeypatch, cap):
    """Tiny per-shard caps send head-term rows to the shards' dense
    scorer; the partition is taken on the worst shard, as in JAX."""
    monkeypatch.setenv("SEARCHLITE_SPARSE_MAX_BLOCKS", str(cap))
    port = IndexReader(index, device="cpu")
    jreader = index.reader()
    queries = make_queries(random.Random(4), 32)
    seen = spy_jax_routes(monkeypatch, jreader)
    ref = jreader.search_batch(queries, limit=7,
                               mesh=jax_make_mesh(8, query_axis=1))
    before = dict(port.route_rows)
    got = port.search_batch(queries, limit=7, mesh=cpu_mesh(8))
    rows = {k: port.route_rows[k] - before[k] for k in before}
    assert rows["mesh_strip"] == seen["light"]
    assert rows["mesh_dense"] == seen["heavy"]
    # both routes ran where the cap is under the head terms' blocks
    assert rows["mesh_strip"] and (rows["mesh_dense"] or cap == 6)
    assert rows["mesh_strip"] + rows["mesh_dense"] == len(queries) * 2
    assert_close_arrays(pairs_to_arrays(port, ref, 7),
                        pairs_to_arrays(port, got, 7))


def test_mesh_edge_queries(index, monkeypatch):
    monkeypatch.setenv("SEARCHLITE_SPARSE_MAX_BLOCKS", "4")
    queries = [
        "",                      # no terms
        "zzz_not_in_vocab",      # unknown term
        "w0",                    # head term
        "w149 w149 w149",        # repeated term: occ>1 packed weights
        " ".join(VOCAB[140:149]),  # many tail terms
    ]
    compare(index, IndexReader(index, device="cpu"), queries, 10)


def test_mesh_per_query_limits_and_wand(index):
    port = IndexReader(index, device="cpu")
    jreader = index.reader()
    queries = make_queries(random.Random(5), 12)
    limits = [1 + (i % 7) for i in range(len(queries))]
    ref = jreader.search_batch(queries, limit=8, limits=limits)
    for execution in ("bm25", "wand", "bmw"):
        got = port.search_batch(queries, limit=8, limits=limits,
                                mesh=cpu_mesh(8), execution=execution)
        jgot = jreader.search_batch(queries, limit=8, limits=limits,
                                    mesh=jax_make_mesh(8, query_axis=1),
                                    execution=execution)
        assert_close_arrays(pairs_to_arrays(port, ref, 8),
                            pairs_to_arrays(port, got, 8))
        assert_close_arrays(pairs_to_arrays(port, jgot, 8),
                            pairs_to_arrays(port, got, 8))


def test_mesh_arrays_output(index):
    port = IndexReader(index, device="cpu")
    queries = make_queries(random.Random(6), 16)
    got = compare(index, port, queries, 10)
    assert got[0].shape == (16, 10) and got[2].dtype == np.int32


def test_mesh_batch_stream(index):
    """A multi-batch stream enqueues everything before one copy back;
    rows stitch back per batch."""
    port = IndexReader(index, device="cpu")
    rng = random.Random(7)
    batches = [make_queries(rng, 9) for _ in range(4)]
    ref = index.reader().search_batch_many(
        batches, limit=6, output="arrays",
        mesh=jax_make_mesh(8, query_axis=1))
    got = port.search_batch_many(batches, limit=6, output="arrays",
                                 mesh=cpu_mesh(8))
    own = port.search_batch_many(batches, limit=6, output="arrays")
    assert len(got) == len(batches)
    for r, g, o in zip(ref, got, own):
        assert_close_arrays(r, g)
        assert_close_arrays(o, g)


def test_mesh_dense_remainder_matches_fallback(index, monkeypatch):
    """Heavy rows on the shards' dense scorer; SEARCHLITE_MESH_DENSE=0
    sends them to the one-device dense scorers instead: same answers."""
    port = IndexReader(index, device="cpu")
    queries = ["w0", "w0 w1", "w1 w2 w3"] + make_queries(
        random.Random(10), 13)
    monkeypatch.setenv("SEARCHLITE_SPARSE_MAX_BLOCKS", "1")
    monkeypatch.setenv("SEARCHLITE_MESH_DENSE", "0")
    before = dict(port.route_rows)
    fallback = port.search_batch(queries, limit=9, mesh=cpu_mesh(8))
    assert port.route_rows["mesh_dense"] == before["mesh_dense"]
    assert port.route_rows["dense"] > before["dense"]
    monkeypatch.setenv("SEARCHLITE_MESH_DENSE", "1")
    sharded = port.search_batch(queries, limit=9, mesh=cpu_mesh(8))
    assert port.route_rows["mesh_dense"] > before["mesh_dense"]
    assert_close_arrays(pairs_to_arrays(port, fallback, 9),
                        pairs_to_arrays(port, sharded, 9))
    ref = index.reader().search_batch(queries, limit=9,
                                      mesh=jax_make_mesh(8, query_axis=1))
    assert_close_arrays(pairs_to_arrays(port, ref, 9),
                        pairs_to_arrays(port, sharded, 9))


def test_mesh_fallback_over_the_budget_takes_the_scan(index, monkeypatch):
    """Heavy rows refused by the shards' dense scorer, over the dense-M
    budget: the one-device doc-sharded scan, padded to k columns."""
    port = IndexReader(index, device="cpu")
    queries = ["w0 w1", "w2"] + make_queries(random.Random(12), 6)
    monkeypatch.setenv("SEARCHLITE_SPARSE_MAX_BLOCKS", "1")
    monkeypatch.setenv("SEARCHLITE_MESH_DENSE", "0")
    monkeypatch.setenv("SEARCHLITE_M_BUDGET_BYTES", "65536")
    before = port.route_rows["sharded"]
    got = port.search_batch_many([queries], limit=12, output="arrays",
                                 mesh=cpu_mesh(4))[0]
    assert port.route_rows["sharded"] > before
    monkeypatch.delenv("SEARCHLITE_M_BUDGET_BYTES")
    assert_close_arrays(port.search_batch_many([queries], limit=12,
                                               output="arrays")[0], got)


def test_mesh_smaller_than_eight(index):
    port = IndexReader(index, device="cpu")
    queries = make_queries(random.Random(8), 10)
    for n in (2, 4):
        compare(index, port, queries, 10, n=n)


def test_mesh_empty_index():
    from searchlite_tpu.api.types import IndexOptions, StorageType
    from searchlite_tpu.index import Index
    from searchlite_tpu.index.manifest import Schema

    idx = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY),
        Schema.from_json({
            "text_fields": [{"name": "body", "analyzer": "default",
                             "stored": False, "indexed": True}]}))
    port = IndexReader(idx, device="cpu")
    assert port.search_batch(["a b"], limit=5, mesh=cpu_mesh(8)) == [[]]
    (s, _d, _g), = port.search_batch_many(
        [["a", "b c"]], limit=3, output="arrays", mesh=cpu_mesh(8))
    assert s.shape == (2, 3) and (s == -np.inf).all()


MESH_HOST_KEYS = ("blocks", "local_start_np")


def assert_tables_equal(got, ref, n_shards):
    assert got["width"] == ref["width"] and got["bp"] == ref["bp"]
    assert got["n_terms"] == ref["n_terms"]
    for key in MESH_HOST_KEYS:
        assert np.array_equal(got[key], ref[key]), key
    for key, jkey in (("block_docs", "block_docs"),
                      ("block_impacts", "block_impacts"),
                      ("tid_tbl", "tid_tbl")):
        have = torch.cat([t[None] if key == "tid_tbl" else t
                          for t in got[key]]).numpy()
        want = np.asarray(ref[jkey])
        assert have.dtype == want.dtype and have.shape == want.shape, key
        assert np.array_equal(have.view(np.uint8), want.view(np.uint8)), key
    sent = np.asarray(ref["sent"])
    for t in got["sent"]:
        assert np.array_equal(t.numpy(), sent)
    for t in got["dead"]:
        assert t.shape == (got["width"] + 1,) and int(t.sum()) == 1 \
            and bool(t[-1])
    assert len(got["block_docs"]) == n_shards


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_mesh_sparse_tables_equal_jax(index, n_shards):
    jreader = index.reader()
    port = IndexReader(index, device="cpu")
    devs = [CPU] * n_shards
    for jd, td in zip(jreader.device_segments, port.device_segments):
        ref = jd.mesh_sparse_tables(n_shards)
        got = td.mesh_sparse_tables(n_shards, devs)
        assert td.mesh_sparse_tables(n_shards, devs) is got  # cached
        assert_tables_equal(got, ref, n_shards)
        # logical shards on one device do not alias
        ptrs = {t.data_ptr() for t in got["block_docs"]}
        assert len(ptrs) == n_shards


def test_tombstone_clone_tables_equal_fresh_build(index):
    """A tombstone clone builds its own mesh tables (they fold its
    tombstones): equal to a fresh build at that state, never the base's;
    eviction drops them."""
    from searchlite_tpu_torch.device.index import DeviceSegment

    port = IndexReader(index, device="cpu")
    base = port.device_segments[0]
    devs = [CPU] * 4
    base_tables = base.mesh_sparse_tables(4, devs)
    reader = base.reader
    extra = sorted(set(range(0, reader.doc_count, 5))
                   - set(reader.deleted))[:40]
    clone_reader = reader.clone_with_tombstones(dataclasses.replace(
        reader.meta, deleted_docs=sorted(set(reader.deleted) | set(extra))))
    clone = base.clone_with_tombstones(clone_reader, base.ord)
    got = clone.mesh_sparse_tables(4, devs)
    assert got is not base_tables
    assert not any(a is b for a, b in zip(got["block_impacts"],
                                          base_tables["block_impacts"]))
    fresh = DeviceSegment(clone_reader, base.ord, "cpu")
    want = fresh.mesh_sparse_tables(4, devs)
    for key in ("block_docs", "block_impacts", "tid_tbl", "sent", "dead"):
        for a, b in zip(got[key], want[key]):
            assert torch.equal(a.view(torch.uint8) if a.dtype != torch.bool
                               else a, b.view(torch.uint8)
                               if b.dtype != torch.bool else b), key
    for key in MESH_HOST_KEYS:
        assert np.array_equal(got[key], want[key])
    # the extra tombstones really changed the impacts
    assert not all(torch.equal(a, b) for a, b in zip(
        got["block_impacts"], base_tables["block_impacts"]))
    clone.evict_device_caches()
    assert clone.mesh_sparse_tables(4, devs) is not got
    # another device list is another cache entry
    assert base.mesh_sparse_tables(2, [CPU] * 2) is not base_tables


def test_mesh_with_host_tier_segments(index, monkeypatch):
    """SEARCHLITE_HOST_TIER=force flags the small segments as tiered; the
    mesh route shards them like any other (as the JAX reader iterates
    every segment)."""
    monkeypatch.setenv("SEARCHLITE_HOST_TIER", "force")
    port = IndexReader(index, device="cpu")
    assert port.tier_segments["host"] == 2
    queries = make_queries(random.Random(11), 20)
    got = port.search_batch_many([queries], limit=10, output="arrays",
                                 mesh=cpu_mesh(4))[0]
    ref = index.reader().search_batch_many(
        [queries], limit=10, output="arrays",
        mesh=jax_make_mesh(4, query_axis=1))[0]
    assert_close_arrays(ref, got)
