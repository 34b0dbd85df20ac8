"""Term-split candidate scoring of the torch port
(searchlite_tpu_torch/ops/sparse.py::candidate_core_split and its packed
scorer, group_gather_sound) against the JAX package's
(searchlite_tpu/ops/sparse.py::make_sparse_candidate_scorer_split,
make_group_gather_sound) on the same segments and the same host
partitions (partition_sparse_batch_split).

The strip core is bit-identical to the JAX default core and the heavy
lookups add each slot in the JAX source order, so scores mostly agree bit
for bit; XLA:CPU's fusion reassociates ``tv + heavy_sum`` for some
shapes (one ulp on rows with two or more head terms), so finite scores
are held to rtol 1e-6 / atol 1e-6 and ids where not near-tied. The
soundness flags -- which pick the rows of the fallback wave -- must agree
exactly. Entries past a row's matches are -inf in both; their ids differ
(the port pads with the dead slot) and are not compared."""

import random

import numpy as np
import pytest
import torch

from searchlite_tpu.ops.impact import build_impact_batch
from searchlite_tpu.ops.sparse import (make_group_gather_sound,
                                       make_sparse_candidate_scorer_split,
                                       partition_sparse_batch_split)
from searchlite_tpu_torch.device.index import DeviceSegment
from searchlite_tpu_torch.ops.sparse import (group_gather_sound,
                                             sparse_candidate_scorer_split)

from test_torch_dense import HEADS, VOCAB, build_index
from test_torch_fused_topk import assert_topk_close


@pytest.fixture(scope="module")
def segments():
    reader = build_index(seed=31, n_docs=1800, delete_every=7).reader()
    return [(seg, jd, DeviceSegment(seg, jd.ord, "cpu"))
            for seg, jd in zip(reader.segments, reader.device_segments)]


def make_qb(seg, jd, n=64, seed=9):
    rng = random.Random(seed)
    queries = []
    for _ in range(n):
        terms = [rng.choice(VOCAB[20:]) for _ in range(rng.randint(1, 3))]
        for _h in range(rng.randint(0, 3)):
            terms.append(rng.choice(HEADS + VOCAB[:4]))
        if rng.random() < 0.2:
            terms.append(terms[0])  # occ 2
        rng.shuffle(terms)
        queries.append([("body", tok) for tok in terms])
    return build_impact_batch(seg, jd, queries, lazy_tables=True)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


# (k, kp, max_blocks, term_cap, ub_ratio): kp under the candidate band
# leaves rows "excluded" and so unsound; the ub predictor off admits rows
# whose HUB rivals their light terms
CASES = [(10, 4096, 8, 4, 0.5), (10, 64, 8, 2, 0.0), (25, 128, 16, 4, 0.0),
         (3, 1024, 8, 3, 0.5)]


@pytest.mark.parametrize("k,kp,max_blocks,term_cap,ub_ratio", CASES)
def test_split_scorer_matches_jax(segments, k, kp, max_blocks, term_cap,
                                  ub_ratio):
    jax_scorer = make_sparse_candidate_scorer_split()
    sound_seen = []
    n_groups = 0
    for seg, jd, td in segments:
        qb = make_qb(seg, jd, seed=k + kp)
        hl_host = jd.heavy_lookup_host(term_cap)
        part = partition_sparse_batch_split(
            qb, max_blocks, jd.idf32, k, term_cap, 4,
            maximp=hl_host["maximp"], ub_ratio=ub_ratio)
        assert part is not None
        jhl = jd.heavy_lookup(term_cap)
        hl = td.heavy_lookup(term_cap)
        for g in part["groups"]:
            if g.get("hvy") is None:
                continue
            n_groups += 1
            kw = dict(k=k, kp=kp, t_pad=g["t_pad"], nblk=g["nblk"],
                      log2_run=g["log2_run"], h_pad=g["h_pad"],
                      n_ovr=g["n_ovr"])
            rs, ri, rsnd = jax_scorer(
                jd.block_docs, jd.block_impacts_live, jd.sparse_tid_tbl,
                jhl["tbl"], jhl["base"], jhl["log2g"], jhl["maximp"],
                g["packed"], g["ovr"], g["hvy"], jd.sparse_sentinels, **kw)
            gs, gi, gsnd = sparse_candidate_scorer_split(
                td.block_docs, td.block_impacts_live, td.sparse_tid_tbl,
                hl["tbl"], hl["base"], hl["log2g"], hl["maximp"],
                t(g["packed"]), t(g["ovr"]), t(g["hvy"]),
                td.sparse_sentinels, **kw)
            rs, ri, rsnd = (np.asarray(x) for x in (rs, ri, rsnd))
            assert_topk_close(rs, ri, gs.numpy(), gi.numpy(), atol=1e-6)
            assert np.array_equal(gsnd.numpy(), rsnd)
            # the reader's form: lookups only on rows with a head term
            heavy_rows = np.flatnonzero((g["hvy"][1] != 0).any(axis=1))
            assert 0 < len(heavy_rows) <= len(g["pos_in_light"])
            hs, hi, hsnd = sparse_candidate_scorer_split(
                td.block_docs, td.block_impacts_live, td.sparse_tid_tbl,
                hl["tbl"], hl["base"], hl["log2g"], hl["maximp"],
                t(g["packed"]), t(g["ovr"]), t(g["hvy"]),
                td.sparse_sentinels, heavy_rows=t(heavy_rows), **kw)
            assert torch.equal(hs.view(torch.int32), gs.view(torch.int32))
            assert torch.equal(hi, gi) and torch.equal(hsnd, gsnd)
            sound_seen.extend(rsnd[:len(g["pos_in_light"])].tolist())
    assert n_groups > 0
    if kp <= 128:
        assert not all(sound_seen)  # the certificate really fails here
    else:
        assert any(sound_seen)


def test_group_gather_sound_matches_jax():
    rng = np.random.default_rng(4)
    k, bl = 6, 40
    sizes = [16, 24]
    group_s = [rng.random((n, k), dtype=np.float32) for n in sizes]
    group_i = [rng.integers(0, 999, (n, k)).astype(np.int32) for n in sizes]
    group_f = [rng.random(n) < 0.5 for n in sizes]
    posmaps = np.full(sum(sizes), bl, dtype=np.int32)
    perm = rng.permutation(bl)
    posmaps[:10] = perm[:10]
    posmaps[16:36] = perm[10:30]  # rows perm[30:] stay unmapped: True
    s_ref, i_ref, f_ref = make_group_gather_sound()(
        tuple(group_s), tuple(group_i), tuple(group_f), posmaps, bl=bl)
    s, i, f = group_gather_sound([t(x) for x in group_s],
                                 [t(x) for x in group_i],
                                 [t(x) for x in group_f], t(posmaps), bl=bl)
    assert np.array_equal(s.numpy(), np.asarray(s_ref))
    assert np.array_equal(i.numpy(), np.asarray(i_ref))
    assert np.array_equal(f.numpy(), np.asarray(f_ref))
    assert f.numpy()[perm[30:]].all() and not f.numpy().all()
