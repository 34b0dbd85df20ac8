"""Doc-tile pruning ops of the torch port (searchlite_tpu_torch/ops/tiles.py)
against the JAX module (searchlite_tpu/ops/tiles.py) on the CPU.

One seeded corpus (three segments, duplicate docs for exact score ties,
tombstones) is written once by the JAX package and opened by both
packages' ``Index``. (a) The host tables of both ``TileIndex`` are equal,
array for array, at ``SEARCHLITE_TILE_WIDTH`` 128 and at the default
width; ``pack_runs`` round-trips in both formats. (b) Each device op runs
on the same numpy arrays (the JAX ``TileIndex``'s, carried into torch by
``from_host_arrays``) through its JAX function and its torch counterpart:
ids equal, scores within rtol 1e-6 / atol 1e-4 (f32_strict: the two sum in
their own orders), bounds >= every exact score in their tile. (c) Equal
scores across two tiles come out doc-ascending from the run scorers and
the merge."""

import random
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from searchlite_tpu.api.types import IndexOptions as JaxIndexOptions
from searchlite_tpu.index import Index as JaxIndex
from searchlite_tpu.index.manifest import Schema as JaxSchema
from searchlite_tpu.ops import tiles as jtiles
from searchlite_tpu_torch.api.types import IndexOptions
from searchlite_tpu_torch.device.index import FLAT_KEYS, from_host_arrays
from searchlite_tpu_torch.index import Index
from searchlite_tpu_torch.ops import tiles as ttiles

RTOL, ATOL = 1e-6, 1e-4
SCHEMA = {
    "text_fields": [{"name": "body", "analyzer": "default",
                     "stored": False, "indexed": True}],
    "keyword_fields": [{"name": "cat", "stored": False, "indexed": True,
                        "fast": True}],
    "numeric_fields": [{"name": "rank", "type": "i64", "stored": False,
                        "fast": True}],
}


def build_corpus(path, seed: int, segments: int = 3,
                 docs_per_segment: int = 400, vocab_size: int = 80,
                 delete: int = 50):
    """tests/test_pruning.py's corpus, on disk: Zipf-ish bodies, 8% of
    docs duplicated (exact score ties), one commit a segment, then
    tombstones. Returns (vocab, rng)."""
    rng = random.Random(seed)
    vocab = [f"w{i}" for i in range(vocab_size)]
    weights = [1.0 / (j + 1) for j in range(vocab_size)]
    idx = JaxIndex.create(
        JaxIndexOptions(path=str(path), create_if_missing=True),
        JaxSchema.from_json(SCHEMA))
    n = 0
    for _seg in range(segments):
        writer = idx.writer()
        for _i in range(docs_per_segment):
            doc = {"body": " ".join(rng.choices(vocab, weights=weights,
                                                k=rng.randint(2, 30))),
                   "cat": rng.choice(["a", "b", "c"]),
                   "rank": rng.randint(0, 100)}
            writer.add_document({"_id": str(n), **doc})
            n += 1
            if rng.random() < 0.08:  # duplicate: exact score ties
                writer.add_document({"_id": str(n), **doc})
                n += 1
        writer.commit()
    if delete:
        writer = idx.writer()
        writer.delete_documents(
            [str(rng.randrange(n)) for _ in range(delete)])
        writer.commit()
    return vocab, rng


def open_readers(path):
    """(JAX reader, torch reader on the CPU) over one index directory."""
    jidx = JaxIndex.open(JaxIndexOptions(path=str(path)))
    tidx = Index.open(IndexOptions(path=str(path)))
    return jidx.reader(), tidx.reader(device="cpu")


@pytest.fixture(scope="module")
def readers(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_tiles")
    build_corpus(path, seed=57)
    return open_readers(path)


@pytest.fixture(autouse=True)
def strict(monkeypatch):
    monkeypatch.setenv("SEARCHLITE_PRECISION", "f32_strict")


def t(arr):
    return torch.from_numpy(np.ascontiguousarray(arr))


def tile_pair(readers, seg_i: int, width):
    jdseg = readers[0].device_segments[seg_i]
    tdseg = readers[1].device_segments[seg_i]
    return (jtiles.TileIndex(jdseg, width), ttiles.TileIndex(tdseg, width),
            jdseg, tdseg)


def slot_tables(jdseg, rng, n_slots=6, n_queries=5):
    """Seeded term slots and COO weights of a small batch."""
    n_terms = len(jdseg.reader.postings.term_df)
    tids = np.sort(rng.choice(n_terms, size=n_slots, replace=False))
    s_pad = 8
    w = np.zeros((n_queries, s_pad), dtype=np.float32)
    for q in range(n_queries):
        cols = rng.choice(n_slots, size=int(rng.integers(1, 4)),
                          replace=False)
        w[q, cols] = rng.uniform(0.5, 4.0, size=len(cols))
    nz = np.flatnonzero(w.reshape(-1))
    w_pad = 32
    w_idx = np.arange(w_pad, dtype=np.int32) + n_queries * s_pad
    w_idx[:len(nz)] = nz
    w_val = np.zeros(w_pad, dtype=np.float32)
    w_val[:len(nz)] = w.reshape(-1)[nz]
    return tids.astype(np.int64), s_pad, w, w_idx, w_val


def dense_scores(jdseg, tids, w):
    """Exact f64 scores [Q, n1] of the batch over the raw impacts."""
    m = np.zeros((w.shape[1], jdseg.n1))
    base = jdseg.posting_base
    for s, tid in enumerate(tids):
        lo, hi = int(base[tid]), int(base[tid + 1])
        m[s, jdseg.docs_flat_np[lo:hi]] = jdseg.impacts_flat_np[lo:hi]
    return w.astype(np.float64) @ m


# -- (a) host tables -----------------------------------------------------------


@pytest.mark.parametrize("width", [128, None])
@pytest.mark.parametrize("seg_i", [0, 1, 2])
def test_tile_index_tables_equal_jax(readers, seg_i, width):
    jtl, ttl, jdseg, tdseg = tile_pair(readers, seg_i, width)
    assert (ttl.T, ttl.n_tiles, ttl.sentinel_row) == \
        (jtl.T, jtl.n_tiles, jtl.sentinel_row)
    for name in ("entry_term", "entry_tile", "entry_max", "entry_start",
                 "entry_len", "entry_base", "eb_start", "eb_cnt"):
        np.testing.assert_array_equal(getattr(ttl, name),
                                      getattr(jtl, name), err_msg=name)
    arrays = ttl.host_arrays()
    np.testing.assert_array_equal(arrays["tile_docs"],
                                  np.asarray(jtl.tile_docs))
    np.testing.assert_array_equal(arrays["tile_maxes"],
                                  np.asarray(jtl.tile_maxes))
    np.testing.assert_array_equal(arrays["deleted_tiles"],
                                  np.asarray(jtl.deleted_tiles))
    assert jdseg.deleted_np[:jdseg.n_docs].any()  # tombstones are in
    for key in ttiles.TILE_KEYS:
        got = getattr(ttl, key)
        assert got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), arrays[key])


@pytest.mark.parametrize("seg_i", [0, 2])
def test_run_tables_equal_jax(readers, seg_i):
    jtl, ttl, jdseg, _tdseg = tile_pair(readers, seg_i, 128)
    rng = np.random.default_rng(3 + seg_i)
    tids, _s_pad, _w, _wi, _wv = slot_tables(jdseg, rng)
    tiles = np.sort(rng.choice(jtl.n_tiles, size=max(1, jtl.n_tiles // 2),
                               replace=False)).astype(np.int64)
    for fmt_env in (None, "4"):
        with pytest.MonkeyPatch.context() as mp:
            if fmt_env:
                mp.setenv("SEARCHLITE_RUNS_FMT", fmt_env)
            want = jtl.run_tables(tids, tiles)
            got = ttl.run_tables(tids, tiles)
            assert got["packed_fmt"] == want["packed_fmt"] == \
                (4 if fmt_env else 3)
            np.testing.assert_array_equal(got["packed"], want["packed"])
            assert {k: got[k] for k in ("p_pad", "n_cols", "postings")} \
                == {k: want[k] for k in ("p_pad", "n_cols", "postings")}
            # per-query runs: each query's own terms and tiles
            q_tids = np.full((3, 4), -1, dtype=np.int64)
            q_tids[0, :2] = tids[:2]
            q_tids[1, :3] = tids[2:5]
            q_tiles = np.sort(np.stack([
                rng.choice(jtl.n_tiles + 1, size=2, replace=False)
                for _ in range(3)]).astype(np.int64), axis=1)
            want = jtl.run_tables_per_query(q_tids, q_tiles, 4)
            got = ttl.run_tables_per_query(q_tids, q_tiles, 4)
            np.testing.assert_array_equal(got["packed"], want["packed"])
            assert {k: got[k] for k in ("packed_fmt", "p_pad", "n_cols",
                                        "postings")} == \
                {k: want[k] for k in ("packed_fmt", "p_pad", "n_cols",
                                      "postings")}
    np.testing.assert_array_equal(ttl.tile_postings(tids, tiles),
                                  jtl.tile_postings(tids, tiles))
    # the device forms of the JAX index's host gathers into tile space
    np.testing.assert_array_equal(
        ttl.deleted_tiles[t(tiles)].reshape(-1).numpy(),
        jtl.deleted_cols(tiles))
    vals = rng.random((2, jdseg.n1)).astype(np.float32)
    last = np.asarray([jtl.n_tiles - 1, jtl.n_tiles], dtype=np.int64)
    cols, oob = ttiles.tile_cols(t(last), jtl.T, jdseg.n1)
    np.testing.assert_array_equal(
        ttiles.gather_cols(t(vals), cols, oob, -1.0).numpy(),
        jtl.gather_cols(vals, last, fill=-1.0))
    ids = rng.integers(0, len(tiles) * 128, size=(3, 5))
    np.testing.assert_array_equal(ttl.map_ids(tiles, ids),
                                  jtl.map_ids(tiles, ids))
    # the UB block tables: the same real entries, each with its own pad
    jb, js, _ = jtl.ub_block_tables(tids)
    tb, ts, _ = ttl.ub_block_tables(tids)
    n_real = int(jtl.eb_cnt[tids].sum())
    np.testing.assert_array_equal(tb[:n_real], jb[:n_real])
    np.testing.assert_array_equal(ts[:n_real], js[:n_real])
    assert (tb[n_real:] == ttl.sentinel_row).all()


def test_default_tile_width_and_cache(readers):
    for n1 in (256, 131072, 1 << 20, 5_000_000):
        assert ttiles.default_tile_width(n1) == \
            jtiles.default_tile_width(n1)
    tdseg = readers[1].device_segments[0]
    tl = ttiles.get_tile_index(tdseg, 128)
    assert ttiles.get_tile_index(tdseg, 128) is tl
    assert ttiles.get_tile_index(tdseg, 256) is not tl
    flat = tdseg.flat_postings()
    assert tdseg.flat_postings() is flat
    np.testing.assert_array_equal(flat["docs_flat"].numpy(),
                                  tdseg.host.docs_flat_np)
    np.testing.assert_array_equal(flat["impacts_flat"].numpy(),
                                  tdseg.host.impacts_flat_np)
    ttiles.get_tile_index(tdseg, 256).tile_docs  # upload
    tdseg.evict_device_caches()
    assert tdseg._flat_postings is None
    assert tdseg._tile_index._tensors is None


@pytest.mark.parametrize("fmt", [3, 4])
def test_pack_runs_roundtrip(fmt):
    rng = np.random.default_rng(3)
    n = 37
    start = rng.integers(0, 2**30, size=n)
    off = rng.integers(-(2**25), 2**25, size=n)
    ln = rng.integers(0, 2**16, size=n)
    slot = rng.integers(0, 2**15, size=n)
    if fmt == 4:
        slot[5] = 2**15  # an oversized slot forces the explicit format
    packed, got_fmt = ttiles.pack_runs(start, off, ln, slot, 64)
    want, want_fmt = jtiles.pack_runs(start, off, ln, slot, 64)
    assert got_fmt == want_fmt == fmt and packed.shape == (fmt, 64)
    np.testing.assert_array_equal(packed, want)
    unpacked = [x.numpy() for x in ttiles.unpack_runs(t(packed), fmt)]
    for mine, theirs in zip(unpacked, jtiles.unpack_runs_np(packed, fmt)):
        np.testing.assert_array_equal(mine, theirs)
    s2, l2, sl2, o2 = unpacked
    np.testing.assert_array_equal(s2[:n], start)
    np.testing.assert_array_equal(l2[:n], ln)
    np.testing.assert_array_equal(sl2[:n], slot)
    np.testing.assert_array_equal(o2[:n], off)
    z = np.zeros(0, dtype=np.int64)
    packed0, fmt0 = ttiles.pack_runs(z, z, z, z, 64)
    assert fmt0 == 3 and packed0.shape == (3, 64) and not packed0.any()


# -- (b) device ops against their JAX functions --------------------------------


def carried(jtl, jdseg):
    """The JAX TileIndex's and segment's numpy arrays as torch tensors."""
    tens = from_host_arrays(
        {"tile_docs": np.asarray(jtl.tile_docs),
         "tile_maxes": np.asarray(jtl.tile_maxes),
         "deleted_tiles": np.asarray(jtl.deleted_tiles)},
        "cpu", keys=ttiles.TILE_KEYS)
    tens.update(from_host_arrays(
        {"docs_flat": jdseg.docs_flat_np,
         "impacts_flat": jdseg.impacts_flat_np}, "cpu", keys=FLAT_KEYS))
    return tens


@pytest.mark.parametrize("fmt_env", [None, "4"])
def test_build_m_from_runs_equal_jax(readers, fmt_env, monkeypatch):
    if fmt_env:
        monkeypatch.setenv("SEARCHLITE_RUNS_FMT", fmt_env)
    jtl, _ttl, jdseg, _ = tile_pair(readers, 1, 128)
    tens = carried(jtl, jdseg)
    rng = np.random.default_rng(9)
    tids, s_pad, _w, _wi, _wv = slot_tables(jdseg, rng)
    tiles = np.asarray([0, 2, 3], dtype=np.int64)
    runs = jtl.run_tables(tids, tiles)
    rs, rl, rsl, ro = jtiles.unpack_runs_np(runs["packed"],
                                            runs["packed_fmt"])
    want = np.asarray(jtiles.build_m_from_runs(
        jnp, jnp.asarray(jdseg.docs_flat_np),
        jnp.asarray(jdseg.impacts_flat_np), jnp.asarray(rs),
        jnp.asarray(rl), jnp.asarray(rsl), jnp.asarray(ro),
        runs["n_cols"], s_pad, runs["p_pad"]))
    urs, url, ursl, uro = ttiles.unpack_runs(t(runs["packed"]),
                                             runs["packed_fmt"])
    got = ttiles.build_m_from_runs(
        tens["docs_flat"], tens["impacts_flat"], urs, url, ursl, uro,
        runs["n_cols"], s_pad, runs["postings"]).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want > 0).sum() == runs["postings"] > 0
    # no posting in the selection: an all-zero M, no device gather
    empty = jtl.run_tables(tids[:0], tiles)
    urs, url, ursl, uro = ttiles.unpack_runs(t(empty["packed"]),
                                             empty["packed_fmt"])
    assert empty["postings"] == 0 and not ttiles.build_m_from_runs(
        tens["docs_flat"], tens["impacts_flat"], urs, url, ursl, uro,
        empty["n_cols"], s_pad, 0).any()


@pytest.mark.parametrize("seg_i", [0, 1, 2])
def test_ub_scorer_bounds_and_equals_jax(readers, seg_i):
    jtl, ttl, jdseg, _ = tile_pair(readers, seg_i, 128)
    tens = carried(jtl, jdseg)
    rng = np.random.default_rng(21 + seg_i)
    tids, s_pad, w, w_idx, w_val = slot_tables(jdseg, rng)
    blk_idx, slot_row, _ = jtl.ub_block_tables(tids)
    want = np.asarray(jtiles.make_ub_scorer()(
        jtl.tile_docs, jtl.tile_maxes, jnp.asarray(blk_idx),
        jnp.asarray(slot_row), jnp.asarray(w_idx), jnp.asarray(w_val),
        n_t1=jtl.n_tiles + 1, s_pad=s_pad, n_queries=w.shape[0]))
    got = ttiles.ub_scorer(
        tens["tile_docs"], tens["tile_maxes"], t(blk_idx), t(slot_row),
        t(w_idx), t(w_val), n_t1=jtl.n_tiles + 1, s_pad=s_pad,
        n_queries=w.shape[0]).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # the port's own block tables (another pad) give the same bounds
    blk2, row2, _ = ttl.ub_block_tables(tids)
    got2 = ttiles.ub_scorer(
        tens["tile_docs"], tens["tile_maxes"], t(blk2), t(row2), t(w_idx),
        t(w_val), n_t1=jtl.n_tiles + 1, s_pad=s_pad,
        n_queries=w.shape[0]).numpy()
    np.testing.assert_array_equal(got2, got)
    # sound: UB >= every exact score in its tile
    exact = dense_scores(jdseg, tids, w)
    pad = jtl.n_tiles * jtl.T - jdseg.n1
    per_tile = np.pad(exact, ((0, 0), (0, pad))).reshape(
        w.shape[0], jtl.n_tiles, jtl.T).max(axis=2)
    assert (got[:, :jtl.n_tiles] >= per_tile).all()
    assert (got[:, jtl.n_tiles] == 0).all()  # the dump column


def test_seed_selector_equal_jax():
    rng = np.random.default_rng(5)
    q, n_tiles = 6, 9
    ub = rng.uniform(0.0, 4.0, size=(q, n_tiles)).astype(np.float32)
    ub[0, :] = 0.0           # nothing qualifies
    ub[1, :] = 1.0
    ub[1, 2:6] = 3.0         # a tie: the lowest tiles win
    ub[2, :7] = 0.0          # fewer tiles than c qualify
    theta = np.asarray([-np.inf, -np.inf, -np.inf, 2.0, -np.inf, 3.9],
                       dtype=np.float32)
    processed = rng.random((q, n_tiles)) < 0.2
    select = jtiles.make_seed_selector()
    for c in (1, 4, 16):
        want = select(jnp.asarray(ub), jnp.asarray(processed),
                      jnp.asarray(theta), c=c)
        got = ttiles.seed_select(t(ub), t(processed), t(theta), c=c)
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
        assert got[0].dtype == torch.int32
    ids = ttiles.seed_select(t(ub), t(np.zeros_like(processed)),
                             t(np.full(q, -np.inf, np.float32)),
                             c=2)[0].numpy()
    assert ids[1].tolist() == [2, 3] and (ids[0] == n_tiles).all()


def pq_inputs(jtl, jdseg, rng, q=5, tpq_pad=4, c=2):
    n_terms = len(jdseg.reader.postings.term_df)
    q_tids = np.full((q, tpq_pad), -1, dtype=np.int64)
    w_b = np.zeros((q, tpq_pad), dtype=np.float32)
    for i in range(q):
        n = int(rng.integers(1, tpq_pad + 1))
        q_tids[i, :n] = np.sort(rng.choice(n_terms, size=n, replace=False))
        w_b[i, :n] = rng.uniform(0.5, 4.0, size=n)
    q_tiles = np.sort(np.stack([
        rng.choice(jtl.n_tiles + 1, size=c, replace=False)
        for _ in range(q)]).astype(np.int64), axis=1)
    return q_tids, w_b, q_tiles


@pytest.mark.parametrize("fmt_env", [None, "4"])
def test_pq_run_scorer_equal_jax(readers, fmt_env, monkeypatch):
    if fmt_env:
        monkeypatch.setenv("SEARCHLITE_RUNS_FMT", fmt_env)
    jtl, _ttl, jdseg, _ = tile_pair(readers, 2, 128)
    tens = carried(jtl, jdseg)
    rng = np.random.default_rng(31)
    q_tids, w_b, q_tiles = pq_inputs(jtl, jdseg, rng)
    runs = jtl.run_tables_per_query(q_tids, q_tiles, 4)
    scorer = jtiles.make_pq_run_scorer()
    for k in (10, 300):  # 300 > n_cols: the scorer returns n_cols wide
        ws, wd = scorer(
            jnp.asarray(jdseg.docs_flat_np),
            jnp.asarray(jdseg.impacts_flat_np), jtl.deleted_tiles,
            jnp.asarray(q_tiles.astype(np.int32)), jnp.asarray(w_b),
            jnp.asarray(runs["packed"]), k=k, n_cols=runs["n_cols"],
            p_pad=runs["p_pad"], tpq_pad=4, t=jtl.T,
            fmt=runs["packed_fmt"])
        gs, gd = ttiles.pq_run_scorer(
            tens["docs_flat"], tens["impacts_flat"], tens["deleted_tiles"],
            t(q_tiles.astype(np.int32)), t(w_b), t(runs["packed"]), k=k,
            n_cols=runs["n_cols"], n_post=runs["postings"],
            tpq_pad=4, t=jtl.T, fmt=runs["packed_fmt"])
        ws, wd = np.asarray(ws), np.asarray(wd)
        assert gs.shape == ws.shape and gd.dtype == torch.int32
        np.testing.assert_array_equal(np.isfinite(gs.numpy()),
                                      np.isfinite(ws))
        np.testing.assert_allclose(gs.numpy(), ws, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(gd.numpy(), wd)
        assert np.isfinite(ws).any()
        # no deleted doc comes back
        fin = np.isfinite(ws)
        assert not jdseg.deleted_np[wd[fin]].any()


def test_topk_merge_equal_jax():
    rng = np.random.default_rng(41)
    q, k = 7, 6
    merge = jtiles.make_topk_merge()

    def side(width):
        s = np.round(rng.uniform(0, 3, size=(q, width)), 1).astype(
            np.float32)  # rounded: plenty of exact ties
        s[rng.random((q, width)) < 0.3] = -np.inf
        d = rng.permutation(q * width * 4)[:q * width].reshape(
            q, width).astype(np.int32)
        d[~np.isfinite(s)] = 0
        return s, d

    lims = np.asarray([1, 3, 6, 6, 2, 5, 4], dtype=np.int32)
    for wb in (0, 3, 6):
        s_a, d_a = side(k)
        s_b, d_b = side(wb)
        want = merge(jnp.asarray(s_a), jnp.asarray(d_a), jnp.asarray(s_b),
                     jnp.asarray(d_b), jnp.asarray(lims))
        got = ttiles.topk_merge(t(s_a), t(d_a), t(s_b), t(d_b), t(lims))
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


@pytest.mark.parametrize("use_filters", [False, True])
def test_run_batch_scorer_equal_jax(readers, use_filters):
    jtl, _ttl, jdseg, tdseg = tile_pair(readers, 0, 128)
    tens = carried(jtl, jdseg)
    rng = np.random.default_rng(51)
    tids, s_pad, w, w_idx, w_val = slot_tables(jdseg, rng, n_queries=6)
    tiles = np.asarray([1, 3, jtl.n_tiles], dtype=np.int64)  # a sentinel
    runs = jtl.run_tables(tids, tiles)
    rows = rng.random((3, jdseg.n1)) < 0.5
    rows[0] = True
    fidx = rng.integers(0, 3, size=w.shape[0]).astype(np.int32)
    rows_t = jtl.gather_cols(rows, tiles, fill=False)
    cols, oob = ttiles.tile_cols(t(tiles.astype(np.int32)), jtl.T,
                                 jdseg.n1)
    got_rows = ttiles.gather_cols(t(rows), cols, oob, False)
    np.testing.assert_array_equal(got_rows.numpy(), rows_t)
    vals = rng.random((2, jdseg.n1)).astype(np.float32)
    for arr, fill in ((vals, -1.0), (vals[0], 0.0), (rows[1], True)):
        got = ttiles.gather_cols(t(arr), cols, oob, fill)
        assert got.dtype == t(arr).dtype and got.is_contiguous()
        np.testing.assert_array_equal(
            got.numpy(), jtl.gather_cols(arr, tiles, fill=fill))
    k = 100
    ws, wi = jtiles.make_run_batch_scorer()(
        jnp.asarray(jdseg.docs_flat_np), jnp.asarray(jdseg.impacts_flat_np),
        jtl.deleted_tiles, jnp.asarray(tiles.astype(np.int32)),
        jnp.asarray(runs["packed"]), jnp.asarray(w_idx), jnp.asarray(w_val),
        jnp.asarray(rows_t), jnp.asarray(fidx), k=k, n_cols=runs["n_cols"],
        p_pad=runs["p_pad"], s_pad=s_pad, n_queries=w.shape[0],
        use_filters=use_filters, fmt=runs["packed_fmt"])
    gs, gi = ttiles.run_batch_scorer(
        tens["docs_flat"], tens["impacts_flat"], tens["deleted_tiles"],
        t(tiles.astype(np.int32)), t(runs["packed"]), t(w_idx), t(w_val),
        got_rows if use_filters else None,
        t(fidx) if use_filters else None, k=k, n_cols=runs["n_cols"],
        n_post=runs["postings"], s_pad=s_pad,
        n_queries=w.shape[0], fmt=runs["packed_fmt"])
    ws, wi, gs, gi = np.asarray(ws), np.asarray(wi), gs.numpy(), gi.numpy()
    fin = np.isfinite(ws)
    assert fin.any()
    np.testing.assert_array_equal(np.isfinite(gs), fin)
    np.testing.assert_allclose(gs[fin], ws[fin], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(gi[fin], wi[fin])
    # against the exact dense scores, mapped back to doc ordinals
    exact = dense_scores(jdseg, tids, w)
    docs = jtl.map_ids(tiles, gi)
    for q_i in range(w.shape[0]):
        for s, d in zip(gs[q_i][fin[q_i]], docs[q_i][fin[q_i]]):
            assert abs(s - exact[q_i, d]) <= ATOL + RTOL * abs(s)
            assert not tdseg.host.deleted_np[d]


# -- (c) ties across tiles ------------------------------------------------------


def tie_segment():
    """A synthetic segment of 4 tiles of 128 docs: term 0 holds one doc
    at the same offset of every tile with the same impact, term 1 a doc in
    tiles 1 and 3, so equal scores sit in different tiles."""
    docs0 = np.asarray([3, 131, 259, 387], dtype=np.int32)
    docs1 = np.asarray([131, 387], dtype=np.int32)
    host = types.SimpleNamespace(
        docs_flat_np=np.concatenate([docs0, docs1]),
        impacts_flat_np=np.asarray([2.0] * 4 + [1.0] * 2, dtype=np.float32),
        deleted_np=np.zeros(512, dtype=bool))
    postings = types.SimpleNamespace(
        term_df=np.asarray([4, 2], dtype=np.int32))
    dseg = types.SimpleNamespace(
        host=host, n1=512, device=torch.device("cpu"),
        reader=types.SimpleNamespace(postings=postings), _tile_index=None)
    return ttiles.TileIndex(dseg, 128), host


def test_ties_across_tiles_come_out_doc_ascending():
    tl, host = tie_segment()
    docs_flat, imps_flat = t(host.docs_flat_np), t(host.impacts_flat_np)
    # per-query runs: query 0 = term 0 over tiles (2, 0)->(0, 2) and
    # (1, 3); the equal scores of a row sit in two tiles
    q_tids = np.asarray([[0, -1], [0, 1], [0, -1]], dtype=np.int64)
    q_tiles = np.asarray([[0, 2], [1, 3], [1, 2]], dtype=np.int64)
    runs = tl.run_tables_per_query(q_tids, q_tiles, 2)
    w_b = np.asarray([[1.0, 0.0], [1.0, 1.0], [1.5, 0.0]], np.float32)
    s, d = ttiles.pq_run_scorer(
        docs_flat, imps_flat, tl.deleted_tiles,
        t(q_tiles.astype(np.int32)), t(w_b), t(runs["packed"]), k=2,
        n_cols=runs["n_cols"], n_post=runs["postings"], tpq_pad=2, t=128,
        fmt=runs["packed_fmt"])
    assert s.tolist() == [[2.0, 2.0], [3.0, 3.0], [3.0, 3.0]]
    assert d.tolist() == [[3, 259], [131, 387], [131, 259]]
    # the merge: equal scores from two waves, the later wave's docs lower
    lims = t(np.asarray([2, 2, 1], dtype=np.int32))
    s_b = t(np.asarray([[2.0, -np.inf], [3.0, 3.0], [3.0, 1.0]],
                       np.float32))
    d_b = t(np.asarray([[131, 0], [3, 259], [3, 400]], np.int32))
    ms, md, theta = ttiles.topk_merge(s, d, s_b, d_b, lims)
    assert md.tolist() == [[3, 131], [3, 131], [3, 131]]
    assert ms.tolist() == [[2.0, 2.0], [3.0, 3.0], [3.0, 3.0]]
    assert theta.tolist() == [2.0, 3.0, 3.0]
    # the union scorer over every tile: all four docs of term 0 tie
    tiles = np.arange(4, dtype=np.int64)
    runs = tl.run_tables(np.asarray([0, 1]), tiles)
    w_idx = np.asarray([0, 8, 9, 19, 20, 21, 22, 23], dtype=np.int32)
    w_val = np.asarray([1.0, 1.0, 1.0, 0, 0, 0, 0, 0], dtype=np.float32)
    s, i = ttiles.run_batch_scorer(
        docs_flat, imps_flat, tl.deleted_tiles, t(tiles.astype(np.int32)),
        t(runs["packed"]), t(w_idx), t(w_val), k=3, n_cols=runs["n_cols"],
        n_post=runs["postings"], s_pad=8, n_queries=2,
        fmt=runs["packed_fmt"])
    assert s.tolist() == [[2.0, 2.0, 2.0], [3.0, 3.0, 2.0]]
    assert tl.map_ids(tiles, i.numpy()).tolist() == \
        [[3, 131, 259], [131, 387, 3]]
