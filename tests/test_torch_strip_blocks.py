"""The strip core read in place from the posting blocks
(searchlite_tpu_torch/ops/strip_topk.py::strip_topk_blocks and the
``csrc/strip_topk.cu`` kernel behind it).

(a) The kernel's precondition holds on real segments: every term's block
    range is strictly doc-ascending up to a sentinel tail in its last
    block, and the slots of each light row name distinct posting lists.
(b) A numpy mirror of the kernel's per-lane rule -- a lane owns its doc
    when no later slot holds it, and the owner sums the earlier slots'
    values in the plain scan's tree order -- is bit-identical to
    ``strip_topk_blocks_plain`` on seeded block tables.
(c) ``strip_topk_blocks_plain`` against the JAX scorer
    (``make_sparse_candidate_scorer``, default sort core) within the D10
    tolerance (rtol 1e-6 / atol 1e-6), with equal match counts.
(d) On the card, the kernel against its plain version: bit-identical on
    finite entries, equal ids and counts (skipped without a GPU).
"""

import numpy as np
import pytest
import torch

from searchlite_tpu.api.types import IndexOptions, StorageType
from searchlite_tpu.index import Index
from searchlite_tpu.index.manifest import Schema
from searchlite_tpu.ops.sparse import (
    TID_LIMIT,
    make_sparse_candidate_scorer,
    partition_sparse_batch,
    partition_sparse_batch_tiered,
)
from searchlite_tpu_torch.device.index import DeviceSegment
from searchlite_tpu_torch.ops.strip_topk import (
    COUNTS,
    GATHER_CALLS,
    strip_topk,
    strip_topk_blocks,
    strip_topk_blocks_plain,
)

from test_torch_sparse import VOCAB, build_index, make_qb, t

RTOL = ATOL = 1e-6


# ---------------------------------------------------------------- tables


def make_segment(rng, n1, n_terms, max_len, delete_rate=0.05):
    """A seeded block layout: ``n_terms`` posting lists of Zipf lengths
    (rank r asks for max_len / r docs, plus a few 1-5 doc lists), each
    doc-ascending and unique, cut into 128-lane block rows whose last one
    is padded with the sentinel ``n1-1``; a trailing all-sentinel row.
    Deleted docs (``delete_rate``) carry impact 0. Returns (block_docs,
    block_impacts, term_start, term_blocks)."""
    sent = n1 - 1
    lens = [max(1, int(max_len / r)) for r in range(1, n_terms + 1)]
    lens += list(rng.integers(1, 6, size=4))
    deleted = rng.random(n1) < delete_rate
    docs_rows, imps_rows, starts, counts = [], [], [], []
    row = 0
    for n in lens:
        docs = np.unique(rng.integers(0, n1 - 1, size=n)).astype(np.int32)
        imps = (rng.random(len(docs), dtype=np.float32) * 2 + 0.1)
        imps[deleted[docs]] = 0.0
        nb = -(-len(docs) // 128)
        bd = np.full(nb * 128, sent, dtype=np.int32)
        bi = np.zeros(nb * 128, dtype=np.float32)
        bd[:len(docs)] = docs
        bi[:len(docs)] = imps
        docs_rows.append(bd.reshape(nb, 128))
        imps_rows.append(bi.reshape(nb, 128))
        starts.append(row)
        counts.append(nb)
        row += nb
    docs_rows.append(np.full((1, 128), sent, dtype=np.int32))
    imps_rows.append(np.zeros((1, 128), dtype=np.float32))
    return (np.concatenate(docs_rows), np.concatenate(imps_rows),
            np.asarray(starts), np.asarray(counts))


def make_rows(rng, term_start, term_blocks, B, t_pad, nblk, n_used=None):
    """Per-row slot tables over distinct terms whose blocks fit ``nblk``:
    the first slot a large term (a quarter to half the width where one
    exists), the rest random. Row 0 has no slot (all sentinel); row 1 one
    tiny term (fewer matches than k). Returns (bstart, bcnt, w)."""
    n_terms = len(term_start)
    bstart = np.zeros((B, t_pad), dtype=np.int32)
    bcnt = np.zeros((B, t_pad), dtype=np.int32)
    w = np.zeros((B, t_pad), dtype=np.float32)
    tiny = np.flatnonzero(term_blocks == 1)[-4:]
    for b in range(B):
        if b == 0:
            continue
        if b == 1:
            chosen = [int(tiny[-1])]
        else:
            used = t_pad if n_used is None else n_used
            used = int(rng.integers(max(1, used // 2), used + 1))
            big = np.flatnonzero((term_blocks > nblk // 4)
                                 & (term_blocks <= nblk // 2))
            chosen = [int(rng.choice(big))] if len(big) else []
            room = nblk - int(term_blocks[chosen].sum())
            for tid in rng.permutation(n_terms):
                if len(chosen) >= used:
                    break
                if tid not in chosen and term_blocks[tid] <= room:
                    chosen.append(int(tid))
                    room -= int(term_blocks[tid])
            chosen = [chosen[i] for i in rng.permutation(len(chosen))]
        for s, tid in enumerate(chosen):
            bstart[b, s] = term_start[tid]
            bcnt[b, s] = term_blocks[tid]
            w[b, s] = np.float32(rng.uniform(0.5, 5.0))
    return bstart, bcnt, w


# ---------------------------------------------------------------- mirror


def tree_sum(leaves, log2_run):
    """The plain scan's value at a run end: the last 2**log2_run leaves,
    right-aligned, summed pairwise (right + left) level by level; missing
    leaves add nothing."""
    width = 1 << log2_run
    nodes = [None] * width
    tail = leaves[-width:]
    nodes[width - len(tail):] = tail
    while len(nodes) > 1:
        nxt = []
        for left, right in zip(nodes[0::2], nodes[1::2]):
            if left is None or right is None:
                nxt.append(right if left is None else left)
            else:
                nxt.append(np.float32(right + left))
        nodes = nxt
    return nodes[0]


def mirror_strip_topk(block_docs, block_impacts, bstart, bcnt, w, sent, *,
                      k, nblk, log2_run):
    """The kernel's per-lane rule in numpy: (ts, td, counts)."""
    B, T = bstart.shape
    dead = int(sent[1])
    ts = np.full((B, k), -np.inf, dtype=np.float32)
    td = np.full((B, k), dead, dtype=np.int32)
    counts = np.zeros(B, dtype=np.int32)
    for b in range(B):
        slots, begin = [], 0
        for s in range(T):
            c = int(bcnt[b, s])
            eff = max(0, min(c, nblk - begin))
            begin += c
            r0 = int(bstart[b, s])
            docs = block_docs[r0:r0 + eff].ravel()
            vals = (block_impacts[r0:r0 + eff].ravel()
                    * np.float32(w[b, s])).astype(np.float32)
            slots.append(dict(zip(docs.tolist(), vals.tolist())))
        found = []
        for s, slot in enumerate(slots):
            for doc in slot:
                if doc == dead or any(doc in slots[x]
                                      for x in range(s + 1, T)):
                    continue  # sentinel, or a later slot owns the doc
                leaves = [np.float32(slots[x][doc]) for x in range(s + 1)
                          if doc in slots[x]]
                score = tree_sum(leaves, log2_run)
                if score > 0:
                    found.append((-float(score), doc, score))
        found.sort()
        counts[b] = len(found)
        for r, (_, doc, score) in enumerate(found[:k]):
            ts[b, r] = score
            td[b, r] = doc
    return ts, td, counts


def assert_bit_identical(ref, got):
    ts_ref, td_ref, c_ref = (np.asarray(x) for x in ref)
    ts, td, c = (np.asarray(x) for x in got)
    fin = np.isfinite(ts_ref)
    assert np.array_equal(np.isfinite(ts), fin)
    assert np.array_equal(ts[fin].view(np.int32), ts_ref[fin].view(np.int32))
    assert np.array_equal(td[fin], td_ref[fin])
    assert np.array_equal(c, c_ref)


def plain(tables, **kw):
    return [x.numpy() for x in strip_topk_blocks_plain(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in tables), **kw)]


def log2_run_of(t_pad):
    return max((t_pad - 1).bit_length(), 1)


# ------------------------------------------------------------------ (a)


def assert_runs_sorted(host):
    """Every term's block range: docs strictly ascending, then only the
    sentinel, and the sentinel only inside the last block."""
    docs = np.asarray(host.block_docs_np)
    tbl = np.asarray(host.sparse_tid_tbl)
    sent = host.n1 - 1
    n_checked = 0
    for tid in np.flatnonzero(tbl[1] > 0):
        b0, nb = int(tbl[0, tid]), int(tbl[1, tid])
        run = docs[b0:b0 + nb].ravel()
        pad = np.flatnonzero(run == sent)
        live = run if not len(pad) else run[:pad[0]]
        assert len(live) > 0
        assert (np.diff(live) > 0).all(), f"term {tid} not ascending"
        if len(pad):
            assert (run[pad[0]:] == sent).all()
            assert pad[0] > (nb - 1) * 128 - 1, f"term {tid}: early pad"
        n_checked += 1
    assert n_checked > 0


def two_field_index():
    rng = np.random.default_rng(12)
    idx = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY),
        Schema.from_json({"text_fields": [
            {"name": "title", "analyzer": "default", "stored": False,
             "indexed": True},
            {"name": "body", "analyzer": "default", "stored": False,
             "indexed": True}]}))
    probs = 1.0 / np.arange(1, len(VOCAB) + 1)
    probs /= probs.sum()
    writer = idx.writer()
    for i in range(900):
        writer.add_document({
            "_id": str(i),
            "title": " ".join(rng.choice(VOCAB, size=3, p=probs)),
            "body": " ".join(rng.choice(VOCAB, size=int(rng.integers(4, 30)),
                                        p=probs))})
    writer.commit()
    return idx


def segment_variants():
    """(name, index) of the real segment shapes the precondition must
    hold on."""
    zipf = build_index(seed=21, n_docs=1500, delete_every=10**9)
    deleted = build_index(seed=21, n_docs=1500, delete_every=9)
    merged = build_index(seed=22, n_docs=1500, delete_every=11)
    merged.merge_segments()
    return [("zipf", zipf), ("deleted", deleted), ("merged", merged),
            ("two fields", two_field_index())]


@pytest.fixture(scope="module")
def variants():
    out = []
    for name, idx in segment_variants():
        reader = idx.reader()
        segs = [(seg, jd, DeviceSegment(seg, jd.ord, "cpu"))
                for seg, jd in zip(reader.segments, reader.device_segments)]
        out.append((name, segs))
    return out


@pytest.mark.parametrize("which", ["zipf", "deleted", "merged",
                                   "two fields"])
def test_precondition_holds_on_real_segments(variants, which):
    segs = dict(variants)[which]
    if which == "merged":
        assert len(segs) == 1
    for _seg, _jd, td in segs:
        assert_runs_sorted(td.host)


@pytest.mark.parametrize("which", ["zipf", "merged", "two fields"])
def test_light_rows_name_distinct_posting_lists(variants, which):
    for seg, jd, _td in dict(variants)[which]:
        qb = make_qb(seg, jd, seed=5)
        part = partition_sparse_batch(qb, 64)
        bstart, bcnt = part["tbl"][0], part["tbl"][1]
        for b in range(bstart.shape[0]):
            used = bstart[b][bcnt[b] > 0]
            assert len(np.unique(used)) == len(used)
        tiered = partition_sparse_batch_tiered(qb, 64, jd.idf32, 10)
        for g in tiered["groups"]:
            packed = g["packed"]
            occ = packed >> 26
            tid = packed & (TID_LIMIT - 1)
            for b in range(packed.shape[0]):
                used = tid[b][occ[b] > 0]
                assert len(np.unique(used)) == len(used)


# ------------------------------------------------------------------ (b)

MIRROR_CASES = [
    # (t_pad, k, B, nblk, seed): k = 10, and k = kp (the strip width)
    (2, 10, 12, 8, 1),
    (4, 10, 16, 16, 2),
    (4, 2048, 6, 16, 3),
    (8, 10, 10, 24, 4),
    (8, 64, 8, 16, 5),
    (16, 10, 8, 32, 6),
    (16, 4096, 4, 32, 7),
]


@pytest.mark.parametrize("t_pad,k,B,nblk,seed", MIRROR_CASES)
def test_mirror_bit_identical_to_plain(t_pad, k, B, nblk, seed):
    rng = np.random.default_rng(seed)
    n1 = 3000  # small doc axis: docs land in many slots at once
    bd, bi, ts_, tb = make_segment(rng, n1, 60, 1800)
    bstart, bcnt, w = make_rows(rng, ts_, tb, B, t_pad, nblk)
    sent = np.array([bd.shape[0] - 1, n1 - 1], dtype=np.int32)
    kw = dict(k=k, nblk=nblk, log2_run=log2_run_of(t_pad))
    tables = (bd, bi, bstart, bcnt, w, sent)
    ref = plain(tables, **kw)
    got = mirror_strip_topk(*tables, **kw)
    assert_bit_identical(ref, got)
    assert ref[2][0] == 0 and np.isneginf(ref[0][0]).all()
    assert ref[2][1] < 10  # fewer matches than k
    # docs held by 3 and 4 slots of one row occur
    in_slots = []
    for b in range(B):
        docs = np.concatenate([bd[bstart[b, s]:bstart[b, s] + bcnt[b, s]]
                               .ravel() for s in range(t_pad)])
        docs = docs[docs != n1 - 1]
        in_slots.append(np.bincount(docs, minlength=n1).max()
                        if len(docs) else 0)
    if t_pad >= 4:
        assert max(in_slots) >= 3


def tree_order_case(n_slots):
    """One row whose doc 7 sits in ``n_slots`` slots, with values for
    which a left-to-right sum differs from the scan's tree in the last
    bit."""
    rng = np.random.default_rng(40 + n_slots)
    while True:
        u = (rng.random(n_slots) * rng.choice([1.0, 1e-3, 1e3], n_slots)
             ).astype(np.float32)
        seq = np.float32(0.0)
        for x in u:
            seq = np.float32(seq + x)
        if seq != tree_sum(list(u), 2):
            break
    n1 = 64
    bd = np.full((n_slots + 1, 128), n1 - 1, dtype=np.int32)
    bi = np.zeros((n_slots + 1, 128), dtype=np.float32)
    for s in range(n_slots):
        bd[s, :3] = [2 + s, 7, 40 + s]
        bi[s, :3] = [0.5, u[s], 0.25]
    bstart = np.zeros((1, 4), dtype=np.int32)
    bcnt = np.zeros((1, 4), dtype=np.int32)
    bstart[0, :n_slots] = np.arange(n_slots)
    bcnt[0, :n_slots] = 1
    w = np.zeros((1, 4), dtype=np.float32)
    w[0, :n_slots] = 1.0
    sent = np.array([n_slots, n1 - 1], dtype=np.int32)
    return (bd, bi, bstart, bcnt, w, sent), seq


@pytest.mark.parametrize("n_slots", [3, 4])
def test_tree_order_matters(n_slots):
    tables, seq = tree_order_case(n_slots)
    kw = dict(k=10, nblk=n_slots, log2_run=2)
    ref = plain(tables, **kw)
    assert_bit_identical(ref, mirror_strip_topk(*tables, **kw))
    at = int(np.flatnonzero(ref[1][0] == 7)[0])
    assert ref[0][0, at] != seq  # a left-to-right sum would miss a bit
    assert ref[2][0] == 1 + 2 * n_slots


def test_strip_cut_at_nblk_and_sentinel_rows():
    """Rows whose blocks overrun the strip are cut where it ends, as the
    gather cuts them; padded rows past the batch's real rows match
    nothing."""
    rng = np.random.default_rng(3)
    bd, bi, ts_, tb = make_segment(rng, 20000, 30, 15000)
    # rows filled to 48 blocks on a 16-block strip: the last slots lose
    # blocks
    bstart, bcnt, w = make_rows(rng, ts_, tb, 6, 4, 48)
    assert (bcnt.sum(axis=1) > 16).any()
    sent = np.array([bd.shape[0] - 1, 19999], dtype=np.int32)
    kw = dict(k=12, nblk=16, log2_run=2)
    tables = (bd, bi, bstart, bcnt, w, sent)
    assert_bit_identical(plain(tables, **kw), mirror_strip_topk(*tables,
                                                                **kw))


def test_dispatch_and_counts():
    rng = np.random.default_rng(8)
    bd, bi, ts_, tb = make_segment(rng, 1000, 10, 600)
    bstart, bcnt, w = make_rows(rng, ts_, tb, 4, 2, 8)
    sent = np.array([bd.shape[0] - 1, 999], dtype=np.int32)
    args = [torch.from_numpy(a) for a in (bd, bi, bstart, bcnt, w, sent)]
    before = (COUNTS.launches, COUNTS.plain, GATHER_CALLS.get("cpu"))
    out = strip_topk_blocks(*args, k=5, nblk=8, log2_run=1)
    assert len(out) == 2
    assert (COUNTS.launches, COUNTS.plain, GATHER_CALLS.get("cpu")) == (
        before[0], before[1] + 1, before[2] + 1)
    with pytest.raises(NotImplementedError):
        strip_topk_blocks(*(a.to("meta") for a in args), k=5, nblk=8,
                          log2_run=1)
    with pytest.raises(ValueError):
        strip_topk_blocks(*args[:5], args[5][:1], k=5, nblk=8, log2_run=1)
    with pytest.raises(ValueError):
        strip_topk_blocks(args[0], *args[1:4], args[4].double(), args[5],
                          k=5, nblk=8, log2_run=1)


# ------------------------------------------------------------------ (c)


@pytest.mark.parametrize("k", [10, 64])
def test_plain_matches_jax_scorer(variants, k):
    jax_scorer = make_sparse_candidate_scorer()
    for seg, jd, td in dict(variants)["deleted"]:
        part = partition_sparse_batch(make_qb(seg, jd, seed=k + 3), 64)
        tbl = part["tbl"]
        kw = dict(k=k, nblk=part["nblk"], log2_run=part["log2_run"])
        ts_ref, td_ref, c_ref = jax_scorer(
            jd.block_docs, jd.block_impacts_live, tbl, jd.sparse_sentinels,
            t_pad=part["t_pad"], with_counts=True, core="sort", **kw)
        ts, ids, cnt = strip_topk_blocks(
            td.block_docs, td.block_impacts_live, t(tbl[0]), t(tbl[1]),
            t(tbl[2].view(np.float32)), td.sparse_sentinels,
            with_counts=True, **kw)
        ts_ref, td_ref = np.asarray(ts_ref), np.asarray(td_ref)
        fin = np.isfinite(ts_ref)
        assert np.array_equal(np.isfinite(ts.numpy()), fin)
        assert np.allclose(ts.numpy()[fin], ts_ref[fin], rtol=RTOL,
                           atol=ATOL)
        assert np.array_equal(ids.numpy()[fin], td_ref[fin])
        assert np.array_equal(cnt.numpy(), np.asarray(c_ref))


# ------------------------------------------------------------------ (d)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    rng = np.random.default_rng(11)
    n1 = 131072
    bd, bi, ts_, tb = make_segment(rng, n1, 800, 2 * n1)
    cases = [(2, 10, 64, 16), (4, 10, 32, 128), (4, 10, 4, 1024),
             (8, 10, 16, 64), (16, 10, 8, 32), (4, 4096, 8, 32),
             (4, 40, 8, 64), (4, 8192, 2, 128), (4, 10, 2, 4096)]
    for t_pad, k, B, nblk in cases:
        bstart, bcnt, w = make_rows(rng, ts_, tb, B, t_pad, nblk)
        sent = np.array([bd.shape[0] - 1, n1 - 1], dtype=np.int32)
        args = [torch.from_numpy(a).cuda()
                for a in (bd, bi, bstart, bcnt, w, sent)]
        kw = dict(k=k, nblk=nblk, log2_run=log2_run_of(t_pad))
        launches = COUNTS.launches
        got = strip_topk_blocks(*args, with_counts=True, **kw)
        assert COUNTS.launches == launches + 1
        ref = strip_topk_blocks_plain(*args, **kw)
        torch.cuda.synchronize()
        assert_bit_identical([x.cpu().numpy() for x in ref],
                             [x.cpu().numpy() for x in got])
    # the gathered (d, v) path is the CPU plain version only
    d = torch.zeros((2, 8), dtype=torch.int32, device="cuda")
    with pytest.raises(NotImplementedError, match="strip_topk_blocks"):
        strip_topk(d, d.float(), 9, k=2, log2_run=1)
