"""The doc-sharded dense scan of the torch port
(``DeviceSegment.doc_shards``, ``ops/impact.py::expand_block_tables`` /
``expand_impact_scorer``, ``IndexReader._search_batch_sharded``) against
the JAX package on the CPU: the same numpy inputs through both, on the
two-segment tombstoned corpus of ``test_torch_reader.py``.

Tolerances: tables are compared array for array (exact); scores with
bench.py's f32_strict gate (rtol 1e-6, atol 1e-4, the sums run in another
order, divergence D10); ids where scores are finite and not near-tied.
"""

import numpy as np
import pytest
import torch

import searchlite_tpu.api.reader as jax_reader_mod
import searchlite_tpu_torch.api.reader as port_reader_mod
from searchlite_tpu.ops.impact import (
    build_block_tables as jax_build_block_tables,
    expand_block_tables_dev,
)
from searchlite_tpu_torch.api.reader import IndexReader
from searchlite_tpu_torch.ops.impact import (
    build_block_tables,
    expand_block_tables,
)
from test_torch_reader import (
    FILTERS,
    assert_close_arrays,
    build_index,
    check_filtered_vs_oracle,
    check_vs_oracle,
    make_queries,
)


@pytest.fixture(scope="module")
def index():
    return build_index()


@pytest.fixture(autouse=True)
def strict(monkeypatch):
    monkeypatch.setenv("SEARCHLITE_PRECISION", "f32_strict")


HOST_KEYS = ("block_base", "blocks", "counts", "docs_sh_np", "imps_sh_np",
             "posting_base")


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_doc_shards_tables_equal_jax(index, n_shards):
    jax_reader = index.reader()
    port = IndexReader(index, device="cpu")
    for jd, td in zip(jax_reader.device_segments, port.device_segments):
        ref = jd.doc_shards(n_shards)
        got = td.doc_shards(n_shards)
        assert td.doc_shards(n_shards) is got  # cached per n_shards
        for key in ("n_shards", "shard_width", "sentinel_row", "n_terms"):
            assert got[key] == ref[key], key
        for key in HOST_KEYS:
            assert np.array_equal(got[key], ref[key]), key
            assert got[key].dtype == ref[key].dtype, key
        for key in ("block_docs", "block_impacts"):
            want = np.asarray(ref[key])
            have = got[key].numpy()
            assert have.dtype == want.dtype and have.shape == want.shape
            assert np.array_equal(have.view(np.uint8), want.view(np.uint8))
        # local docs stay under the shard width; pads hold the sentinel
        assert int(got["block_docs"].max()) == got["shard_width"]


def test_eviction_drops_the_shard_cache(index):
    port = IndexReader(index, device="cpu")
    dseg = port.device_segments[0]
    first = dseg.doc_shards(2)
    first["deleted_stack"] = torch.zeros(1)
    dseg.evict_device_caches()
    again = dseg.doc_shards(2)
    assert again is not first and "deleted_stack" not in again
    assert torch.equal(again["block_docs"], first["block_docs"])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_expand_block_tables(seed):
    """Against the host builder and the JAX device op, at the exact size,
    with pad positions, and with the last end landing ON nb_pad (the mark
    JAX drops)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    s = int(rng.integers(1, 40))
    bcnt = rng.integers(0, 9, s).astype(np.int32)
    if seed == 3:
        bcnt[:] = 0  # no block at all
    bstart = rng.integers(0, 5000, s).astype(np.int32)
    total = int(bcnt.sum())
    sentinel = 7777
    for nb_pad in (max(total, 1), total + 13):
        blk, row = expand_block_tables(
            torch.from_numpy(bstart), torch.from_numpy(bcnt), sentinel,
            nb_pad)
        jb, jr = expand_block_tables_dev(
            jnp, jnp.asarray(bstart), jnp.asarray(bcnt), jnp.int32(sentinel),
            nb_pad)
        assert blk.dtype == torch.int32 and row.dtype == torch.int32
        assert np.array_equal(blk.numpy(), np.asarray(jb))
        assert np.array_equal(row.numpy(), np.asarray(jr))
    hb, hr, nb_pad = build_block_tables(bstart, bcnt, sentinel_row=sentinel)
    jhb, jhr, jnb = jax_build_block_tables(bstart, bcnt,
                                           sentinel_row=sentinel)
    assert nb_pad == jnb and np.array_equal(hb, jhb)
    blk, row = expand_block_tables(
        torch.from_numpy(bstart), torch.from_numpy(bcnt), sentinel, nb_pad)
    assert np.array_equal(blk.numpy(), hb)
    assert np.array_equal(row.numpy(), hr)


def spy_on_shards(monkeypatch, port):
    """Record (n_shards, live shard launches) of every sharded scan."""
    calls = []
    real = port_reader_mod.expand_impact_scorer
    shard_fn = port._search_batch_sharded

    def scorer_spy(*args, **kwargs):
        calls[-1]["launches"] += 1
        calls[-1]["n"].append(int(args[2].shape[0]))
        return real(*args, **kwargs)

    def sharded_spy(dseg, *args, **kwargs):
        calls.append({"launches": 0, "n": []})
        out = shard_fn(dseg, *args, **kwargs)
        calls[-1]["n_shards"] = dseg._doc_shards["n_shards"]
        return out

    monkeypatch.setattr(port_reader_mod, "expand_impact_scorer", scorer_spy)
    monkeypatch.setattr(port, "_search_batch_sharded", sharded_spy)
    return calls


@pytest.mark.parametrize("limit", [10, 70])
def test_filtered_batch_over_the_budget(index, monkeypatch, limit):
    rng = np.random.default_rng(limit)
    queries = make_queries(30 + limit, 40)
    filters = [FILTERS[int(i)] for i in rng.integers(0, len(FILTERS),
                                                     len(queries))]
    filters[0] = FILTERS[-1]  # matches nothing
    under = IndexReader(index, device="cpu").search_batch_many(
        [queries], limit=limit, filters=[filters], output="arrays")[0]
    monkeypatch.setenv("SEARCHLITE_M_BUDGET_BYTES", "4096")
    port = IndexReader(index, device="cpu")
    calls = spy_on_shards(monkeypatch, port)
    got = port.search_batch_many([queries], limit=limit, filters=[filters],
                                 output="arrays")[0]
    assert len(calls) == 2 and all(c["n_shards"] > 1 for c in calls)
    assert port.route_rows["sharded"] == 2 * len(queries)
    assert port.route_rows["dense"] == 0
    ref = index.reader().search_batch_many(
        [queries], limit=limit, filters=[filters], output="arrays")[0]
    assert np.isneginf(got[0][0]).all()
    assert_close_arrays(ref, got)
    assert_close_arrays(under, got)
    check_filtered_vs_oracle(port, queries, filters, got, limit)


def test_k_over_1024_over_the_budget(index, monkeypatch):
    queries = make_queries(31, 12)
    under = IndexReader(index, device="cpu").search_batch_many(
        [queries], limit=1100, output="arrays")[0]
    monkeypatch.setenv("SEARCHLITE_M_BUDGET_BYTES", "4096")
    port = IndexReader(index, device="cpu")
    got = port.search_batch_many([queries], limit=1100, output="arrays")[0]
    ref = index.reader().search_batch_many([queries], limit=1100,
                                           output="arrays")[0]
    wide = sum(d.n1 > 1024 for d in port.device_segments)
    assert wide and port.route_rows["sharded"] == 12 * wide
    assert got[0].shape == (12, 1100)
    assert_close_arrays(ref, got)
    assert_close_arrays(under, got)
    check_vs_oracle(port, queries, got, np.full(len(queries), 1100))


def test_lowered_flat_index_limit_shards_more(index, monkeypatch):
    """Under the byte budget but past (a lowered) int32 bound the batch
    still shards, and the second loop doubles the shards until one
    shard's scatter fits: both packages split alike."""
    queries = make_queries(32, 24)
    filters = [FILTERS[i % 4] for i in range(len(queries))]
    limit = 40_000
    monkeypatch.setattr(port_reader_mod, "FLAT_INDEX_LIMIT", limit)
    monkeypatch.setattr(jax_reader_mod, "FLAT_INDEX_LIMIT", limit)
    port = IndexReader(index, device="cpu")
    calls = spy_on_shards(monkeypatch, port)
    got = port.search_batch_many([queries], limit=25, filters=[filters],
                                 output="arrays")[0]
    jax_reader = index.reader()
    ref = jax_reader.search_batch_many([queries], limit=25,
                                       filters=[filters], output="arrays")[0]
    assert len(calls) == 2
    for call, jd in zip(calls, jax_reader.device_segments):
        assert call["n_shards"] > 1
        assert call["n_shards"] == jd._doc_shards["n_shards"]
    assert_close_arrays(ref, got)
    check_filtered_vs_oracle(port, queries, filters, got, 25)


def test_trailing_empty_shard_is_skipped(monkeypatch):
    """n1 = 384 (256 + 128: the doc axis pads to a power of two only up
    to SEARCHLITE_PAD_DOCS_MAX) in 256 shards of width 2: the last 64
    shards start past n1 and launch nothing."""
    monkeypatch.setenv("SEARCHLITE_PAD_DOCS_MAX", "0")
    index = build_index(seed=5, n_docs=383, delete_every=7)
    queries = make_queries(33, 8)
    filters = [FILTERS[1]] * len(queries)
    port = IndexReader(index, device="cpu")
    sizes = [d.n1 for d in port.device_segments]
    calls = spy_on_shards(monkeypatch, port)
    scores, ids = [], []
    for dseg in port.device_segments:
        qb = port._qb_lazy_native(dseg.reader, dseg, [queries], 0, ["body"],
                                  [None], lazy_tables=False)
        fidx = np.ones(len(queries), dtype=np.int32)
        from searchlite_tpu_torch.api.types import Filter
        s, i = port._search_batch_sharded(
            dseg, qb, 10, 3 * dseg.n1, 1, fidx,
            [Filter.from_json(FILTERS[1])])
        scores.append(s.numpy())
        ids.append(i.numpy())
    for call, n1 in zip(calls, sizes):
        width = -(-n1 // call["n_shards"])
        live = -(-n1 // width)
        assert live < call["n_shards"]  # some trailing shard is empty
        assert call["launches"] == live
        assert set(call["n"]) == {width + 1}
    per_segment = [(o, s, i) for o, (s, i) in enumerate(zip(scores, ids))]
    got = port._merge_batch_arrays(per_segment, np.full(len(queries), 10))
    ref = index.reader().search_batch_many(
        [queries], limit=10, filters=[filters], output="arrays")[0]
    assert_close_arrays(ref, got)


# -- the three outcomes of a row subset over the budget ----------------------


def remainder_env(monkeypatch, budget: str):
    monkeypatch.setenv("SEARCHLITE_M_BUDGET_BYTES", budget)
    monkeypatch.setenv("SEARCHLITE_SPARSE_MAX_BLOCKS", "2")


def spy_routes(monkeypatch, port):
    seen = {"full": 0, "full_none": 0, "sharded": 0, "dense": 0,
            "dense_calls": []}
    full = port._full_strip_launch
    sharded = port._search_batch_sharded
    dense = port._launch_batch_segment

    def full_spy(dseg, qb, k):
        out = full(dseg, qb, k)
        seen["full" if out is not None else "full_none"] += 1
        return out

    def sharded_spy(*args, **kwargs):
        seen["sharded"] += 1
        return sharded(*args, **kwargs)

    def dense_spy(dseg, *args, **kwargs):
        seen["dense"] += 1
        seen["dense_calls"].append((dseg.n1,
                                    kwargs.get("allow_sparse", True)))
        return dense(dseg, *args, **kwargs)

    monkeypatch.setattr(port, "_full_strip_launch", full_spy)
    monkeypatch.setattr(port, "_search_batch_sharded", sharded_spy)
    monkeypatch.setattr(port, "_launch_batch_segment", dense_spy)
    return seen


def no_full_strips(monkeypatch, port):
    """Full strips that cannot hold the rows (on the card: k past the
    strip cap or a batch past the strip's lanes)."""
    monkeypatch.setattr(port, "_full_strip_launch", lambda *a: None)


@pytest.mark.parametrize("outcome", ["full", "sharded", "dense"])
def test_heavy_rows_over_the_budget(index, monkeypatch, outcome):
    """Rows over the strip cap beside light rows, over the budget: full
    strips; the scan when full strips cannot hold them and the subset is
    still over the budget; the dense scorer when the subset fits."""
    # 1,340,000 bytes: in the larger segment (n1 = 2,048) the 40-row
    # batch is over it (estimate 1,376,256) and its re-packed heavy
    # subset under it (1,310,720); the smaller segment is under it
    remainder_env(monkeypatch, "1" if outcome != "dense" else "1340000")
    queries = make_queries(34, 40, max_terms=7)
    port = IndexReader(index, device="cpu")
    if outcome != "full":
        no_full_strips(monkeypatch, port)
    seen = spy_routes(monkeypatch, port)
    got = port.search_batch_many([queries], limit=10, output="arrays")[0]
    if outcome == "full":
        assert seen["full"] and not seen["sharded"] and not seen["dense"]
    elif outcome == "sharded":
        assert seen["sharded"] and not seen["dense"]
        assert port.route_rows["sharded"] > 0
    else:
        assert (2048, False) in seen["dense_calls"]
        assert not seen["sharded"]
    assert port.route_rows["strip"] > 0
    ref = index.reader().search_batch_many([queries], limit=10,
                                           output="arrays")[0]
    assert_close_arrays(ref, got)
    check_vs_oracle(port, queries, got, np.full(len(queries), 10))


@pytest.mark.parametrize("outcome", ["full", "sharded", "dense"])
def test_split_fallbacks_over_the_budget(index, monkeypatch, outcome):
    """Rows whose term-split certificate failed, over the budget, reach
    the same three outcomes in the fallback wave."""
    # 400,000 bytes: both segments' batches are over it (892,928 and
    # 446,464), every re-packed fallback subset under it
    monkeypatch.setenv("SEARCHLITE_M_BUDGET_BYTES",
                       "1" if outcome != "dense" else "400000")
    monkeypatch.setenv("SEARCHLITE_SPARSE_MAX_BLOCKS", "8")
    monkeypatch.setenv("SEARCHLITE_HEAVY_TERM_BLOCKS", "3")
    monkeypatch.setenv("SEARCHLITE_SPLIT_UB_RATIO", "0")
    queries = ["w199 w0", "w198 w1 w2", "w0 w197", "w150 w3",
               "w190 w0 w1"] * 3 + make_queries(35, 30)
    port = IndexReader(index, device="cpu")
    if outcome != "full":
        no_full_strips(monkeypatch, port)
    seen = spy_routes(monkeypatch, port)
    got = port.search_batch_many([queries], limit=40, output="arrays")[0]
    jax_reader = index.reader()
    ref = jax_reader.search_batch_many([queries], limit=40,
                                       output="arrays")[0]
    assert port.route_rows["fallback"] > 0
    assert port._split_fallback_rows == getattr(
        jax_reader, "_split_fallback_rows", 0)
    if outcome == "full":
        assert seen["full"] and not seen["sharded"] and not seen["dense"]
    elif outcome == "sharded":
        assert seen["sharded"] and not seen["dense"]
    else:
        assert seen["dense"] and not seen["sharded"]
    assert_close_arrays(ref, got)
    check_vs_oracle(port, queries, got, np.full(len(queries), 40))


def test_sharded_merge_order_is_the_lexsort(index, monkeypatch):
    """Equal scores across shards come back doc ascending, and -inf
    entries end each row: the device merge is np.lexsort((ids, -scores))."""
    monkeypatch.setenv("SEARCHLITE_M_BUDGET_BYTES", "4096")
    # one-term queries: every doc with the same tf and length ties
    queries = ["w150", "w180", "w199", "w42 w42"]
    filters = [FILTERS[1], None, FILTERS[2], None]
    port = IndexReader(index, device="cpu")
    got = port.search_batch_many([queries], limit=300, filters=[filters],
                                 output="arrays")[0]
    scores, ids, segs = got
    for row in range(len(queries)):
        fin = np.isfinite(scores[row])
        n = int(fin.sum())
        assert fin[:n].all()  # -inf only at the end
        key = list(zip(-scores[row, :n], segs[row, :n], ids[row, :n]))
        assert key == sorted(key)
    ref = index.reader().search_batch_many(
        [queries], limit=300, filters=[filters], output="arrays")[0]
    assert_close_arrays(ref, got)
