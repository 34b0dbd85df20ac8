"""The precision modes of the torch port (``ops/precision.py``) against the
JAX package's (``searchlite_tpu/ops/precision.py``) on the CPU:
``SEARCHLITE_PRECISION`` and ``SEARCHLITE_DEVICE_IMPACTS`` set alike for
both packages, both readers over the same two-segment tombstoned corpus
(``test_torch_reader.build_index``, 700 docs).

- The storage dtype of every device table (``block_impacts``, the flat
  postings, ``m_dense`` and its row count, the doc-shard and mesh tables)
  equals JAX's, bit for bit, in each row of the contract table; the
  port's dtypes on the card follow the same table except for the default,
  which stays exact f32 there.
- Under ``bf16`` + ``SEARCHLITE_DEVICE_IMPACTS=bf16`` each route (the
  split scorer under the budget, the strips over it, the doc-sharded scan,
  a 2-shard mesh; dense, sparse and wand / bmw singles) answers as the JAX
  reader does: hits and order equal away from near-ties, scores within
  the f32_strict tolerance (rtol 1e-6, atol 1e-4: both sum the same
  bf16-rounded impacts in f32, in their own orders, divergence D10). The
  JAX reader keeps no per-route counters, so the port's ``route_rows`` /
  ``single_routes`` in the bf16 mode must equal its own in f32_strict
  (the routing never reads the storage dtype), and the term split's
  fallback rows equal the JAX reader's ``_split_fallback_rows``.
- The port's bf16 answers are within 2^-7 (``tests/test_impacts_dtype.py``)
  of its exact f32_strict answers on common docs, at most 2 swapped.
- Each kernel's plain version on bf16 operands equals the plain version
  on the operands widened to f32, exactly.
- A reader opened after a mode switch gets fresh tables of the new dtype.
- ``SEARCHLITE_HOST_PROFILE``: both readers end the same calls with the
  same profile keys and batch count; unset, the port keeps no profile.
"""

import numpy as np
import pytest
import torch

from searchlite_tpu_torch.api.reader import IndexReader
from searchlite_tpu_torch.ops import fused_topk as fused_mod
from searchlite_tpu_torch.ops import precision
from searchlite_tpu_torch.ops import strip_topk as strip_mod
from searchlite_tpu_torch.parallel.mesh import make_mesh
from test_torch_reader import (
    FILTERS,
    assert_close_arrays,
    build_index,
    make_queries,
)

CPU = torch.device("cpu")
F32, BF16 = torch.float32, torch.bfloat16
EXACT_RTOL, EXACT_ATOL = 2.0 ** -7, 1e-4  # tests/test_impacts_dtype.py
# a dense-row budget of a few rows, so the bf16 itemsize shows in the count
DENSE_ROWS_AT_F32 = 5

# (SEARCHLITE_PRECISION, SEARCHLITE_DEVICE_IMPACTS) -> expected on the CPU
# (impacts, dense rows) and, for the port, impacts on the card
MODES = {
    "unset": ((None, None), (F32, F32), F32),
    "f32": (("f32", None), (F32, F32), F32),
    "f32_strict": (("f32_strict", None), (F32, F32), F32),
    "bf16": (("bf16", None), (F32, BF16), BF16),
    "impacts=bf16": ((None, "bf16"), (BF16, F32), BF16),
    "bf16+impacts=f32": (("bf16", "f32"), (F32, BF16), F32),
    "bf16+impacts=bf16": (("bf16", "bf16"), (BF16, BF16), BF16),
    "f32_strict+impacts=bf16": (("f32_strict", "bf16"), (F32, F32), F32),
}


@pytest.fixture(scope="module")
def index():
    return build_index(seed=41, n_docs=700)


def set_mode(monkeypatch, name):
    (prec, imps), _cpu, _card = MODES[name]
    for key, val in (("SEARCHLITE_PRECISION", prec),
                     ("SEARCHLITE_DEVICE_IMPACTS", imps)):
        if val is None:
            monkeypatch.delenv(key, raising=False)
        else:
            monkeypatch.setenv(key, val)


def jax_reader(index):
    """A JAX reader whose device tables are built in the current mode (its
    segment cache keys on no dtype: drop what an earlier mode built)."""
    reader = index.reader()
    for dseg in reader.device_segments:
        dseg.evict_device_caches()
    return reader


def bits(x) -> np.ndarray:
    """The raw bits of a port tensor or a JAX / numpy array."""
    if isinstance(x, torch.Tensor):
        view = torch.int16 if x.dtype == BF16 else torch.int32
        return x.contiguous().view(view).numpy()
    arr = np.asarray(x)
    return arr.view(np.int16 if arr.dtype.itemsize == 2 else np.int32)


def torch_dtype(x):
    return BF16 if np.asarray(x).dtype.name == "bfloat16" else F32


def same_table(port, ref, dtype, what):
    assert port.dtype == dtype, what
    assert torch_dtype(ref) == dtype, what
    np.testing.assert_array_equal(bits(port), bits(ref), err_msg=what)


# -- the policy -----------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(MODES))
def test_policy_follows_the_contract_table(name, monkeypatch):
    set_mode(monkeypatch, name)
    _env, (cpu_imps, dense), card_imps = MODES[name]
    assert precision.impacts_store_dtype("cpu") == cpu_imps
    assert precision.impacts_store_dtype(torch.device("cuda")) == card_imps
    assert precision.dense_store_dtype() == dense
    assert precision.m_store_dtype() == F32
    assert precision.strict() == name.startswith("f32_strict")


@pytest.mark.parametrize("name", sorted(MODES))
def test_storage_dtypes_equal_jax(index, name, monkeypatch):
    set_mode(monkeypatch, name)
    _env, (imps, dense), _card = MODES[name]
    port = IndexReader(index, device="cpu")
    ref = jax_reader(index)
    for td, jd in zip(port.device_segments, ref.device_segments):
        assert td.impact_dtype == imps
        same_table(td.block_impacts, jd.block_impacts, imps, "block_impacts")
        same_table(td.block_impacts_live, jd.block_impacts_live, imps,
                   "block_impacts_live")
        same_table(td.flat_postings()["impacts_flat"], jd.impacts_flat, imps,
                   "impacts_flat")
        budget = DENSE_ROWS_AT_F32 * td.n1 * 4
        trows, jrows = td.dense_rows(budget), jd.dense_rows(budget)
        assert trows["row_of_tid"] == jrows["row_of_tid"]
        # one budget holds twice the bf16 rows
        assert len(trows["row_of_tid"]) == DENSE_ROWS_AT_F32 * (
            2 if dense == BF16 else 1)
        same_table(trows["m_dense"], jrows["m_dense"], dense, "m_dense")
        same_table(td.doc_shards(2)["block_impacts"],
                   jd.doc_shards(2)["block_impacts"], imps, "doc_shards")
        mesh = td.mesh_sparse_tables(2, [CPU, CPU])
        same_table(torch.cat(mesh["block_impacts"]),
                   jd.mesh_sparse_tables(2)["block_impacts"], imps,
                   "mesh tables")
    # the host build stays f32 whatever the mode
    assert port.device_segments[0].host.block_impacts_np.dtype == np.float32


def test_a_mode_switch_opens_fresh_tables(index, monkeypatch):
    set_mode(monkeypatch, "f32_strict")
    exact = IndexReader(index, device="cpu").device_segments[0]
    set_mode(monkeypatch, "bf16+impacts=bf16")
    bf16 = IndexReader(index, device="cpu").device_segments[0]
    assert bf16 is not exact
    assert (exact.block_impacts.dtype, bf16.block_impacts.dtype) == (F32,
                                                                     BF16)
    assert torch.equal(bf16.block_impacts,
                       exact.block_impacts.to(BF16))
    # back in the first mode, the first segment's tables again (a cache
    # hit), never the other dtype's
    set_mode(monkeypatch, "f32_strict")
    again = IndexReader(index, device="cpu").device_segments[0]
    assert again is exact and again.block_impacts.dtype == F32


# -- the routes in the bf16 mode ----------------------------------------------


def close_to_exact(exact, got):
    """(scores, ids, segs) arrays in bf16 against the exact ones: the same
    finite count a row, at most 2 docs swapped, common docs' scores within
    2^-7."""
    es, ei, eg = exact
    gs, gi, gg = got
    assert np.array_equal(np.isfinite(es), np.isfinite(gs))
    for q in range(es.shape[0]):
        fin = np.isfinite(es[q])
        want = dict(zip(zip(eg[q][fin], ei[q][fin]), es[q][fin]))
        have = dict(zip(zip(gg[q][fin], gi[q][fin]), gs[q][fin]))
        common = set(want) & set(have)
        assert len(common) >= len(want) - 2, q
        for key in common:
            assert abs(have[key] - want[key]) <= \
                EXACT_ATOL + EXACT_RTOL * abs(want[key]), (q, key)


BATCH_ROUTES = {
    # the split scorer under the budget: bf16 dense rows, rows past a
    # 2-block strip cap
    "under_budget": ({"SEARCHLITE_SPARSE_MAX_BLOCKS": "2"}, False,
                     ("dense",)),
    # over the budget: the strips and the term split
    "over_budget": ({"SEARCHLITE_M_BUDGET_BYTES": "1",
                     "SEARCHLITE_SPARSE_MAX_BLOCKS": "2",
                     "SEARCHLITE_SPLIT_UB_RATIO": "0"}, False,
                    ("strip", "split")),
    # filtered over the budget: the doc-sharded scan over bf16 shards
    "scan": ({"SEARCHLITE_M_BUDGET_BYTES": "4096"}, True, ("sharded",)),
    # a 2-shard mesh over bf16 mesh tables
    "mesh": ({"SEARCHLITE_SPARSE_MAX_BLOCKS": "2"}, False,
             ("mesh_strip", "mesh_dense")),
}


def run_batch(reader, queries, filters, mesh=None):
    return reader.search_batch_many([queries], limit=10, output="arrays",
                                    filters=None if filters is None
                                    else [filters], mesh=mesh)[0]


@pytest.mark.parametrize("route", sorted(BATCH_ROUTES))
def test_bf16_batch_routes_equal_jax(index, route, monkeypatch):
    from searchlite_tpu.parallel.mesh import make_mesh as jax_make_mesh

    env, filtered, taken = BATCH_ROUTES[route]
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    queries = make_queries(50 + len(route), 40, max_terms=7)
    filters = None
    if filtered:
        rng = np.random.default_rng(3)
        filters = [FILTERS[int(i)] for i in rng.integers(0, len(FILTERS),
                                                         len(queries))]
    on_mesh = route == "mesh"

    set_mode(monkeypatch, "f32_strict")
    exact_reader = IndexReader(index, device="cpu")
    exact = run_batch(exact_reader, queries, filters,
                      make_mesh(devices=[CPU] * 2) if on_mesh else None)
    set_mode(monkeypatch, "bf16+impacts=bf16")
    port = IndexReader(index, device="cpu")
    ref_reader = jax_reader(index)
    got = run_batch(port, queries, filters,
                    make_mesh(devices=[CPU] * 2) if on_mesh else None)
    ref = ref_reader.search_batch_many(
        [queries], limit=10, output="arrays",
        filters=None if filters is None else [filters],
        mesh=jax_make_mesh(2, query_axis=1) if on_mesh else None)[0]
    assert all(d.impact_dtype == BF16 for d in port.device_segments)
    assert_close_arrays(ref, got)
    close_to_exact(exact, got)
    assert port.route_rows == exact_reader.route_rows
    assert all(port.route_rows[key] > 0 for key in taken), port.route_rows
    assert getattr(port, "_split_fallback_rows", 0) == getattr(
        ref_reader, "_split_fallback_rows", 0)


SINGLE_ROUTES = {
    "dense": ({}, "bm25", "dense"),
    "sparse_plain": ({"SEARCHLITE_SINGLE_SPARSE_MIN_DOCS": "0"}, "bm25",
                     "sparse_plain"),
    "sparse_split": ({"SEARCHLITE_SINGLE_SPARSE_MIN_DOCS": "0",
                      "SEARCHLITE_SINGLE_SPARSE_BLOCKS": "2",
                      "SEARCHLITE_SPLIT_UB_RATIO": "0"}, "bm25",
                     "sparse_split"),
    "wand": ({"SEARCHLITE_TILE_WIDTH": "128",
              "SEARCHLITE_PRUNE_MIN_POSTINGS": "1"}, "wand", "pruned"),
    "bmw": ({"SEARCHLITE_TILE_WIDTH": "128",
             "SEARCHLITE_PRUNE_MIN_POSTINGS": "1"}, "bmw", "pruned"),
}


def single_arrays(reader, queries, execution):
    """Singles' hits as (scores, ids, segs) arrays (doc ids are ints)."""
    scores = np.full((len(queries), 10), -np.inf, dtype=np.float32)
    ids = np.zeros((len(queries), 10), dtype=np.int64)
    for qi, q in enumerate(queries):
        res = reader.search({"query": q, "limit": 10,
                             "execution": execution})
        for j, h in enumerate(res.hits):
            scores[qi, j], ids[qi, j] = h.score, int(h.doc_id)
    return scores, ids, np.zeros_like(ids)


@pytest.mark.parametrize("route", sorted(SINGLE_ROUTES))
def test_bf16_singles_equal_jax(index, route, monkeypatch):
    env, execution, taken = SINGLE_ROUTES[route]
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    queries = make_queries(70, 12, max_terms=5) + ["w0 w1 w17", "w0 w2"]
    set_mode(monkeypatch, "f32_strict")
    exact_reader = IndexReader(index, device="cpu")
    exact = single_arrays(exact_reader, queries, execution)
    set_mode(monkeypatch, "bf16+impacts=bf16")
    port = IndexReader(index, device="cpu")
    got = single_arrays(port, queries, execution)
    ref = single_arrays(jax_reader(index), queries, execution)
    assert_close_arrays(ref, got)
    close_to_exact(exact, got)
    assert port.single_routes == exact_reader.single_routes
    assert port.single_routes[taken] > 0, port.single_routes


# -- the plain versions ---------------------------------------------------------


def strip_operands(seed=4, n_rows=64, B=6, t_pad=4, nblk=12):
    """Seeded block tables (doc-ascending slots, sentinel tails) and rows."""
    rng = np.random.default_rng(seed)
    n1 = 4096
    docs = np.sort(rng.choice(n1 - 1, size=(n_rows, 128)), axis=1)
    docs[:, 100:] = n1 - 1
    docs = np.vstack([docs, np.full((1, 128), n1 - 1)]).astype(np.int32)
    imps = rng.random((n_rows + 1, 128)).astype(np.float32) * 3
    imps[-1] = 0
    bstart = rng.integers(0, n_rows - 4, size=(B, t_pad)).astype(np.int32)
    bcnt = rng.integers(0, 4, size=(B, t_pad)).astype(np.int32)
    w = (rng.random((B, t_pad)) * 4).astype(np.float32)
    sent = np.array([n_rows, n1 - 1], dtype=np.int32)
    return [torch.from_numpy(x) for x in (docs, imps, bstart, bcnt, w,
                                          sent)], nblk


@pytest.mark.parametrize("kernel", ["strip_topk", "strip_lanes",
                                    "fused_m1", "fused_m1_m2"])
def test_plain_versions_widen_bf16(kernel):
    if kernel.startswith("strip"):
        (docs, imps, bstart, bcnt, w, sent), nblk = strip_operands()
        narrow = imps.to(BF16)
        if kernel == "strip_topk":
            counts, fn = strip_mod.COUNTS_BF16, strip_mod.strip_topk_blocks
            kw = dict(k=10, nblk=nblk, log2_run=2, with_counts=True)
        else:
            counts, fn = (strip_mod.LANES_COUNTS_BF16,
                          strip_mod.strip_lanes_blocks)
            kw = dict(nblk=nblk, log2_run=2)
        before = counts.plain
        got = fn(docs, narrow, bstart, bcnt, w, sent, **kw)
        want = fn(docs, narrow.float(), bstart, bcnt, w, sent, **kw)
        assert counts.plain == before + 1
    else:
        g = torch.Generator().manual_seed(9)
        q, r, s, n = 8, 12, 6, 700
        w1 = (torch.rand((q, r), generator=g) * 3).to(BF16).float()
        w2 = (torch.rand((q, s), generator=g) * 3).to(BF16).float()
        m1 = torch.rand((r, n), generator=g).to(BF16)
        m2 = torch.rand((s, n), generator=g)
        if kernel == "fused_m1_m2":
            m2 = m2.to(BF16)
        deleted = torch.rand(n, generator=g) < 0.1
        before = fused_mod.COUNTS_BF16.plain
        got = fused_mod.fused_topk(w1, m1, deleted, k=20, w2=w2, m2=m2)
        want = fused_mod.fused_topk(w1, m1.float(), deleted, k=20, w2=w2,
                                    m2=m2.float())
        assert fused_mod.COUNTS_BF16.plain == before + 1
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_wrappers_take_only_f32_weights():
    (docs, imps, bstart, bcnt, w, sent), nblk = strip_operands()
    with pytest.raises(ValueError):
        strip_mod.strip_topk_blocks(docs, imps.half(), bstart, bcnt, w,
                                    sent, k=10, nblk=nblk, log2_run=2)
    with pytest.raises(ValueError):
        fused_mod.fused_topk(torch.ones((2, 3), dtype=BF16),
                             torch.ones((3, 5)), torch.zeros(5, dtype=bool),
                             k=2)


# -- SEARCHLITE_HOST_PROFILE ----------------------------------------------------


@pytest.mark.parametrize("enabled", [True, False])
def test_host_profile_matches_jax(index, enabled, monkeypatch):
    set_mode(monkeypatch, "f32_strict")
    if enabled:
        monkeypatch.setenv("SEARCHLITE_HOST_PROFILE", "1")
    else:
        monkeypatch.delenv("SEARCHLITE_HOST_PROFILE", raising=False)
    port = IndexReader(index, device="cpu")
    ref = index.reader()
    calls = [
        dict(batches=[make_queries(80, 20)]),
        dict(batches=[make_queries(81, 12), make_queries(82, 9)],
             filters=[[FILTERS[1]] * 12, None]),
        # a stream of narrow batches, coalesced into one launch set
        dict(batches=[make_queries(83 + i, 8) for i in range(3)]),
    ]
    for kw in calls:
        port.search_batch_many(limit=10, **kw)
        ref.search_batch_many(limit=10, **kw)
    if not enabled:
        assert not hasattr(port, "_host_profile")
        assert not hasattr(ref, "_host_profile")
        return
    got, want = port._host_profile, ref._host_profile
    assert sorted(got) == sorted(want)
    assert got["batches"] == want["batches"] > 0
    assert all(got[key] >= 0.0 for key in got)


@pytest.mark.cuda
def test_bf16_variants_match_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    (docs, imps, bstart, bcnt, w, sent), nblk = strip_operands()
    narrow = imps.to(BF16)
    on_card = [t.cuda() for t in (docs, narrow, bstart, bcnt, w, sent)]
    launches = strip_mod.COUNTS_BF16.launches
    got = strip_mod.strip_topk_blocks(*on_card, k=10, nblk=nblk, log2_run=2,
                                      with_counts=True)
    assert strip_mod.COUNTS_BF16.launches == launches + 1
    want = strip_mod.strip_topk_blocks_plain(docs, narrow.float(), bstart,
                                             bcnt, w, sent, k=10, nblk=nblk,
                                             log2_run=2)
    fin = torch.isfinite(want[0])
    assert torch.equal(got[0].cpu()[fin], want[0][fin])
    assert torch.equal(got[1].cpu()[fin], want[1][fin])
    assert torch.equal(got[2].cpu(), want[2])
    g = torch.Generator().manual_seed(9)
    for n in (4096, 4099):  # 16-byte loads, and the scalar path
        w1 = (torch.rand((8, 12), generator=g) * 3).to(BF16).float()
        m1 = (torch.rand((12, n), generator=g)
              * (torch.rand((12, n), generator=g) < 0.1)).to(BF16)
        deleted = torch.rand(n, generator=g) < 0.1
        launches = fused_mod.COUNTS_BF16.launches
        ts, td = fused_mod.fused_topk(w1.cuda(), m1.cuda(), deleted.cuda(),
                                      k=20)
        assert fused_mod.COUNTS_BF16.launches == launches + 1
        ps, pd = fused_mod.fused_topk_plain(w1, m1, deleted, k=20)
        fin = torch.isfinite(ps)
        assert torch.equal(torch.isfinite(ts.cpu()), fin)
        assert torch.allclose(ts.cpu()[fin], ps[fin], rtol=1e-6, atol=1e-4)
