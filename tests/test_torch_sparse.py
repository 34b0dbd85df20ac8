"""Sparse candidate scorers of the torch port
(searchlite_tpu_torch/ops/sparse.py) against the JAX package's
(searchlite_tpu/ops/sparse.py, default sort core) on the same segments
and the same host partitions.

Gathered strips and the packed weight decode must be bit-identical (the
contract tests/test_sparse_packed.py holds between the packed and the
explicit uploads). The scorers sort stably in both packages and add each
run in the same order, so their scores are bit-identical too; ids are
compared where scores are finite. Group gather and row combiner move
values only: exact."""

import random

import numpy as np
import pytest
import torch

from searchlite_tpu.api.types import IndexOptions, StorageType
from searchlite_tpu.index import Index
from searchlite_tpu.index.manifest import Schema
from searchlite_tpu.ops.impact import build_impact_batch
from searchlite_tpu.ops.sparse import (
    _strip_gather,
    make_group_gather,
    make_row_combiner,
    make_sparse_candidate_scorer,
    make_sparse_candidate_scorer_packed,
    partition_sparse_batch,
    partition_sparse_batch_packed,
    partition_sparse_batch_tiered,
)
from searchlite_tpu_torch.device.index import DeviceSegment
from searchlite_tpu_torch.ops.sparse import (
    decode_packed,
    group_gather,
    row_combine,
    sparse_candidate_scorer,
    sparse_candidate_scorer_packed,
    strip_gather,
)

VOCAB = [f"w{i}" for i in range(150)]


def build_index(seed=4, n_docs=1200, delete_every=13):
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
        n = int(rng.integers(4, 40))
        writer.add_document({"_id": str(i), "body": " ".join(
            rng.choice(VOCAB, size=n, p=probs))})
        if i == n_docs // 2:
            writer.commit()
    writer.commit()
    w2 = idx.writer()
    for i in range(0, n_docs, delete_every):
        w2.delete_document(str(i))
    w2.commit()
    return idx


@pytest.fixture(scope="module")
def segments():
    """(SegmentReader, JAX DeviceSegment, port DeviceSegment) per
    segment of a two-segment index with tombstones."""
    reader = build_index().reader()
    return [(seg, jd, DeviceSegment(seg, jd.ord, "cpu"))
            for seg, jd in zip(reader.segments, reader.device_segments)]


def make_qb(seg, jdseg, n=48, seed=3, max_terms=6):
    rng = random.Random(seed)
    weights = [1.0 / r for r in range(1, len(VOCAB) + 1)]
    queries = []
    for _ in range(n):
        # Zipf-weighted terms: head terms span several blocks, so rows
        # land in several block-count tiers
        terms = rng.choices(VOCAB, weights, k=rng.randint(1, max_terms))
        if rng.random() < 0.3:
            terms += [terms[0]] * rng.randint(1, 3)  # occ > 1
        queries.append([("body", t) for t in terms])
    return build_impact_batch(seg, jdseg, queries, lazy_tables=True)


def t(x):
    return torch.as_tensor(np.ascontiguousarray(np.asarray(x)))


def assert_same_topk(ref, got):
    ts_ref, td_ref = (np.asarray(x) for x in ref[:2])
    ts, td = (x.numpy() for x in got[:2])
    fin = np.isfinite(ts_ref)
    assert np.array_equal(np.isfinite(ts), fin)
    assert np.array_equal(ts[fin].view(np.int32), ts_ref[fin].view(np.int32))
    assert np.array_equal(td[fin], td_ref[fin])
    if len(ref) == 3:
        assert np.array_equal(got[2].numpy(), np.asarray(ref[2]))


def test_strip_gather_matches_jax(segments):
    import jax
    import jax.numpy as jnp

    for seg, jd, td in segments:
        part = partition_sparse_batch(make_qb(seg, jd), 64)
        tbl = part["tbl"]
        w = tbl[2].view(np.float32)
        d_ref, v_ref, _ = _strip_gather(
            jax, jnp, jd.block_docs, jd.block_impacts_live, tbl[0], tbl[1],
            w, jd.n_block_rows, t_pad=part["t_pad"], nblk=part["nblk"])
        d, v = strip_gather(
            td.block_docs, td.block_impacts_live, t(tbl[0]), t(tbl[1]),
            t(w), td.sparse_sentinels[0], t_pad=part["t_pad"],
            nblk=part["nblk"])
        assert np.array_equal(d.numpy(), np.asarray(d_ref))
        assert np.array_equal(v.numpy().view(np.int32),
                              np.asarray(v_ref).view(np.int32))


def test_packed_decode_bit_identical_to_explicit(segments):
    for seg, jd, td in segments:
        qb = make_qb(seg, jd, seed=8)
        pp = partition_sparse_batch_packed(qb, 10_000, jd.idf32)
        pe = partition_sparse_batch(qb, 10_000)
        bstart, bcnt, w = decode_packed(
            td.sparse_tid_tbl, t(pp["packed"]), t(pp["ovr"]),
            n_ovr=pp["n_ovr"])
        used = pe["tbl"][1] > 0
        assert np.array_equal(bstart.numpy()[used], pe["tbl"][0][used])
        assert np.array_equal(bcnt.numpy(), pe["tbl"][1])
        assert np.array_equal(w.numpy().view(np.int32), pe["tbl"][2])


def test_packed_override_scatter():
    """A weight whose f32(occ)*f32(idf) double-rounds away from the
    host's f32(occ*idf) ships as an override; the decode must land it."""
    rng = np.random.default_rng(0)
    found = None
    while found is None:
        idf = float(rng.uniform(1.0, 12.0))
        for occ in (3, 5, 7, 9):
            if np.float32(occ * idf) != np.float32(occ) * np.float32(idf):
                found = (occ, idf)
                break
    occ, idf = found
    qb = {
        "qs_start": np.array([0, 1], dtype=np.int64),
        "qs_slot": np.array([0], dtype=np.int32),
        "qs_w": np.array([occ * idf], dtype=np.float32),
        "qs_cnt": np.array([occ], dtype=np.int32),
        "slot_tids": np.array([0], dtype=np.int64),
        "slot_bstart": np.array([0], dtype=np.int64),
        "slot_bcnt": np.array([1], dtype=np.int64),
        "q_nblk": np.array([1], dtype=np.int64),
    }
    idf32 = np.array([idf], dtype=np.float32)
    pp = partition_sparse_batch_packed(qb, 8, idf32)
    assert pp["n_ovr"] > 0
    tid_tbl = np.zeros((3, 4), dtype=np.int32)
    tid_tbl[1, 0] = 1
    tid_tbl[2, 0] = idf32.view(np.int32)[0]
    _, _, w = decode_packed(t(tid_tbl), t(pp["packed"]), t(pp["ovr"]),
                            n_ovr=pp["n_ovr"])
    assert w.numpy()[0, 0].view(np.int32) == qb["qs_w"].view(np.int32)[0]


@pytest.mark.parametrize("k,with_counts", [(10, False), (25, True)])
def test_packed_scorer_matches_jax(segments, k, with_counts):
    jax_scorer = make_sparse_candidate_scorer_packed()
    for seg, jd, td in segments:
        part = partition_sparse_batch_tiered(make_qb(seg, jd, seed=k),
                                             64, jd.idf32, k)
        assert len(part["groups"]) > 1  # several tiers
        for g in part["groups"]:
            kw = dict(k=k, t_pad=g["t_pad"], nblk=g["nblk"],
                      log2_run=g["log2_run"], n_ovr=g["n_ovr"],
                      with_counts=with_counts)
            ref = jax_scorer(jd.block_docs, jd.block_impacts_live,
                             jd.sparse_tid_tbl, g["packed"], g["ovr"],
                             jd.sparse_sentinels, core="sort", **kw)
            got = sparse_candidate_scorer_packed(
                td.block_docs, td.block_impacts_live, td.sparse_tid_tbl,
                t(g["packed"]), t(g["ovr"]), td.sparse_sentinels, **kw)
            assert_same_topk(ref, got)


@pytest.mark.parametrize("k", [10, 40])
def test_explicit_scorer_matches_jax(segments, k):
    jax_scorer = make_sparse_candidate_scorer()
    for seg, jd, td in segments:
        part = partition_sparse_batch(make_qb(seg, jd, seed=k + 1), 64)
        kw = dict(k=k, t_pad=part["t_pad"], nblk=part["nblk"],
                  log2_run=part["log2_run"], with_counts=True)
        ref = jax_scorer(jd.block_docs, jd.block_impacts_live, part["tbl"],
                         jd.sparse_sentinels, core="sort", **kw)
        got = sparse_candidate_scorer(
            td.block_docs, td.block_impacts_live, t(part["tbl"]),
            td.sparse_sentinels, **kw)
        assert_same_topk(ref, got)


def test_group_gather_matches_jax():
    rng = np.random.default_rng(2)
    k, bl = 7, 40
    sizes = [16, 24, 8]
    group_s = [rng.random((n, k), dtype=np.float32) for n in sizes]
    group_i = [rng.integers(0, 999, (n, k)).astype(np.int32) for n in sizes]
    order = rng.permutation(bl)[:30]
    posmaps = np.full(sum(sizes), bl, dtype=np.int32)
    posmaps[[0, 1, 2, 3, 5, 8, 9, 16, 17, 18, 20, 40, 41, 42, 44, 45, 46,
             47, 10, 11, 12, 13, 14, 15, 30, 31, 32, 33, 34, 35]] = order
    s_ref, i_ref = make_group_gather()(tuple(group_s), tuple(group_i),
                                       posmaps, bl=bl)
    s, i = group_gather([t(x) for x in group_s], [t(x) for x in group_i],
                        t(posmaps), bl=bl)
    assert np.array_equal(s.numpy(), np.asarray(s_ref))
    assert np.array_equal(i.numpy(), np.asarray(i_ref))


def test_row_combiner_matches_jax():
    rng = np.random.default_rng(5)
    k, n_rows = 5, 30
    light_s = rng.random((24, k), dtype=np.float32)
    light_i = rng.integers(0, 99, (24, k)).astype(np.int32)
    heavy_s = rng.random((16, k), dtype=np.float32)
    heavy_i = rng.integers(0, 99, (16, k)).astype(np.int32)
    rows = rng.permutation(n_rows)
    light_map = np.full(24, n_rows, dtype=np.int32)
    light_map[:20] = rows[:20]
    heavy_map = np.full(16, n_rows, dtype=np.int32)
    heavy_map[:8] = rows[20:28]  # rows 28, 29 stay -inf
    maps = np.concatenate([light_map, heavy_map])
    s_ref, i_ref = make_row_combiner()(light_s, light_i, heavy_s, heavy_i,
                                       maps, n_rows=n_rows)
    s, i = row_combine(t(light_s), t(light_i), t(heavy_s), t(heavy_i),
                       t(maps), n_rows=n_rows)
    assert np.array_equal(s.numpy(), np.asarray(s_ref))
    assert np.array_equal(i.numpy(), np.asarray(i_ref))
    assert np.isneginf(s.numpy()[rows[28:]]).all()
