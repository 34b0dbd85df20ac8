"""Dense impact scorers of the torch port
(searchlite_tpu_torch/ops/impact.py, device/index.py::dense_rows and
heavy_lookup) against the JAX package's (searchlite_tpu/ops/impact.py,
device/index.py) on the same segments and the same host tables.

The M build and the weight densify move values only: bit-identical. So
are the resident dense rows and the heavy lookup tables, built by the
port and carried across from a JAX segment (``from_host_arrays``). The
scorers' sums run in another order (torch.matmul vs XLA's dot), so their
scores agree within rtol 1e-6 / atol 1e-4 (bench.py's f32_strict gate,
divergence D10) and ids where scores are finite and not near-tied."""

import random

import numpy as np
import pytest
import torch

from searchlite_tpu.api.types import IndexOptions, StorageType
from searchlite_tpu.index import Index
from searchlite_tpu.index.manifest import Schema
from searchlite_tpu.ops.impact import (
    _densify_w,
    build_impact_batch,
    build_m_from_blocks as jax_build_m,
    ensure_dense_tables,
    make_impact_scorer,
    make_split_impact_scorer,
    split_impact_batch,
)
from searchlite_tpu_torch.device.index import (HEAVY_KEYS, DeviceSegment,
                                               from_host_arrays)
from searchlite_tpu_torch.ops.impact import (build_m_from_blocks, densify_w,
                                             impact_scorer,
                                             split_impact_scorer)

from test_torch_fused_topk import assert_topk_close

VOCAB = [f"w{i}" for i in range(150)]
HEADS = ["head0", "head1"]


def build_index(seed=12, n_docs=1500, delete_every=9):
    rng = np.random.default_rng(seed)
    probs = 1.0 / np.arange(1, len(VOCAB) + 1)
    probs /= probs.sum()
    idx = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY),
        Schema.from_json({
            "text_fields": [{"name": "body", "analyzer": "default",
                             "stored": False, "indexed": True}]}))
    writer = idx.writer()
    for i in range(n_docs):
        toks = list(rng.choice(VOCAB, size=int(rng.integers(4, 40)),
                               p=probs))
        for h, p in zip(HEADS, (0.7, 0.4)):
            if rng.random() < p:
                toks.append(h)
        writer.add_document({"_id": str(i), "body": " ".join(toks)})
        if i == n_docs // 2:
            writer.commit()
    writer.commit()
    w2 = idx.writer()
    for i in range(0, n_docs, delete_every):
        w2.delete_document(str(i))
    w2.commit()
    return idx


@pytest.fixture(autouse=True)
def strict(monkeypatch):
    monkeypatch.setenv("SEARCHLITE_PRECISION", "f32_strict")


@pytest.fixture(scope="module")
def segments():
    """(SegmentReader, JAX DeviceSegment, port DeviceSegment) per
    segment of a two-segment index with tombstones."""
    reader = build_index().reader()
    return [(seg, jd, DeviceSegment(seg, jd.ord, "cpu"))
            for seg, jd in zip(reader.segments, reader.device_segments)]


def make_qb(seg, jd, n=40, seed=5):
    rng = random.Random(seed)
    weights = [1.0 / r for r in range(1, len(VOCAB) + 1)]
    queries = []
    for _ in range(n):
        terms = rng.choices(VOCAB, weights, k=rng.randint(1, 5))
        if rng.random() < 0.5:
            terms.append(rng.choice(HEADS))
        if rng.random() < 0.2:
            terms.append(terms[0])  # occ 2
        queries.append([("body", tok) for tok in terms])
    return ensure_dense_tables(build_impact_batch(seg, jd, queries,
                                                  lazy_tables=True))


def t(x):
    return None if x is None else torch.from_numpy(
        np.ascontiguousarray(np.asarray(x)))


def filters_for(jd, qb, seed):
    rng = np.random.default_rng(seed)
    rows = rng.random((4, jd.n1)) < 0.6
    rows[0] = True
    rows[3] = False  # matches nothing
    fidx = rng.integers(0, 4, qb["n_queries"]).astype(np.int32)
    return rows, fidx


def test_build_m_and_densify_w_bit_identical(segments):
    import jax.numpy as jnp

    for seg, jd, td in segments:
        qb = make_qb(seg, jd)
        ref = jax_build_m(jnp, jd.block_docs, jd.block_impacts_live,
                          jnp.asarray(qb["blk_idx"]),
                          jnp.asarray(qb["slot_row"]), jd.n1, qb["s_pad"])
        got = build_m_from_blocks(td.block_docs, td.block_impacts_live,
                                  t(qb["blk_idx"]), t(qb["slot_row"]),
                                  td.n1, qb["s_pad"])
        assert np.array_equal(got.numpy().view(np.int32),
                              np.asarray(ref).view(np.int32))
        assert (got.numpy() > 0).sum() > 100
        ref_w = _densify_w(jnp, jnp.asarray(qb["w_idx"]),
                           jnp.asarray(qb["w_val"]), qb["n_queries"],
                           qb["s_pad"])
        got_w = densify_w(t(qb["w_idx"]), t(qb["w_val"]), qb["n_queries"],
                          qb["s_pad"])
        assert np.array_equal(got_w.numpy().view(np.int32),
                              np.asarray(ref_w).view(np.int32))


def test_dense_rows_and_heavy_lookup_carried_across(segments):
    budget = 24 * 2048 * 4
    for _seg, jd, td in segments:
        ref = jd.dense_rows(budget)
        got = td.dense_rows(budget)
        assert got is td.dense_rows(budget)  # cached per budget
        assert got["row_of_tid"] == ref["row_of_tid"]
        carried = from_host_arrays({"m_dense": np.asarray(ref["m_dense"])},
                                   "cpu", keys=("m_dense",))["m_dense"]
        assert carried.dtype == got["m_dense"].dtype == torch.float32
        assert torch.equal(carried.view(torch.int32),
                           got["m_dense"].view(torch.int32))
        assert not got["m_dense"][-1].any()  # the zero pad row
        for cap in (2, 4):
            ref_h = {key: np.asarray(v)
                     for key, v in jd.heavy_lookup(cap).items()}
            carried_h = from_host_arrays(ref_h, "cpu", keys=HEAVY_KEYS)
            got_h = td.heavy_lookup(cap)
            for key in HEAVY_KEYS:
                a, b = carried_h[key], got_h[key]
                assert a.dtype == b.dtype and a.shape == b.shape, key
                assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
            assert (got_h["base"] >= 0).any()  # some term is heavy
    assert segments[0][2].dense_rows(1) is None  # no row fits


@pytest.mark.parametrize("k,filtered", [(10, False), (37, True),
                                        (300, False)])
def test_impact_scorer_matches_jax(segments, k, filtered):
    import jax.numpy as jnp

    jax_scorer = make_impact_scorer()
    for seg, jd, td in segments:
        qb = make_qb(seg, jd, seed=k)
        rows, fidx = filters_for(jd, qb, k) if filtered else (None, None)
        ref = jax_scorer(
            jd.block_docs, jd.block_impacts, jd.deleted,
            jnp.asarray(qb["blk_idx"]), jnp.asarray(qb["slot_row"]),
            jnp.asarray(qb["w_idx"]), jnp.asarray(qb["w_val"]),
            jnp.asarray(rows if filtered else np.zeros((1, 1), bool)),
            jnp.asarray(fidx if filtered else np.zeros(1, np.int32)),
            k=k, s_pad=qb["s_pad"], n_queries=qb["n_queries"],
            use_filters=filtered)
        got = impact_scorer(
            td.block_docs, td.block_impacts_live, td.deleted,
            t(qb["blk_idx"]), t(qb["slot_row"]), t(qb["w_idx"]),
            t(qb["w_val"]), t(rows), t(fidx), k=k, s_pad=qb["s_pad"],
            n_queries=qb["n_queries"])
        assert_topk_close(ref[0], ref[1], got[0].numpy(), got[1].numpy())
        assert np.isfinite(got[0].numpy()).sum() > qb["n_queries"]


@pytest.mark.parametrize("k,filtered", [(10, False), (25, True),
                                        (600, True)])
def test_split_impact_scorer_matches_jax(segments, k, filtered):
    import jax.numpy as jnp

    jax_scorer = make_split_impact_scorer()
    budget = 24 * 2048 * 4
    for seg, jd, td in segments:
        qb = make_qb(seg, jd, seed=k + 1)
        dense = td.dense_rows(budget)
        split = split_impact_batch(qb, dense["row_of_tid"],
                                   n_rows=len(dense["row_of_tid"]),
                                   n1=td.n1)
        assert split is not None and split["ws_pad"] > 0
        rows, fidx = filters_for(jd, qb, k) if filtered else (None, None)
        kw = dict(k=k, s_pad=split["s_pad"], n_queries=qb["n_queries"],
                  nb_pad=split["nb_pad"], wd_pad=split["wd_pad"],
                  ws_pad=split["ws_pad"])
        ref = jax_scorer(
            jd.block_docs, jd.block_impacts, jd.dense_rows(budget)["m_dense"],
            jd.deleted, jnp.asarray(split["packed"]),
            jnp.asarray(rows if filtered else np.zeros((1, 1), bool)),
            jnp.asarray(fidx if filtered else np.zeros(1, np.int32)),
            use_filters=filtered, **kw)
        got = split_impact_scorer(
            td.block_docs, td.block_impacts_live, dense["m_dense"],
            td.deleted, t(split["packed"]), t(rows), t(fidx), **kw)
        assert_topk_close(ref[0], ref[1], got[0].numpy(), got[1].numpy())
        if filtered:
            assert np.isneginf(got[0].numpy()[fidx == 3]).all()
