"""The torch port's mesh layer (``searchlite_tpu_torch/parallel/mesh.py``,
``parallel/dryrun.py``) against the JAX package's ``parallel/mesh.py``
on the CPU: the host helpers array for array, the two sharded scorers on
the same numpy inputs (the JAX mesh on its virtual CPU devices, the port
on as many CPU shards), the spec parser's every form, and the dry run.

Tolerance: f32_strict (rtol 1e-6, atol 1e-4 a score; ids equal away from
near-ties: the partial sums meet in another order, divergence D10).
"""

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from searchlite_tpu.parallel import mesh as jax_mesh
from searchlite_tpu_torch.ops.impact import pow4_bucket
from searchlite_tpu_torch.ops.score import topk_by_doc
from searchlite_tpu_torch.parallel import mesh as port_mesh
from searchlite_tpu_torch.parallel.dryrun import dryrun_multichip
from searchlite_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    merge_topk,
    parse_mesh_spec,
)

CPU = torch.device("cpu")
RTOL, ATOL = 1e-6, 1e-4


def assert_topk_close(got, ref):
    gs, gi = (np.asarray(x) for x in got)
    rs, ri = (np.asarray(x) for x in ref)
    assert gs.shape == rs.shape
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


@pytest.mark.parametrize("n_shards", [1, 2, 3, 8])
def test_host_helpers_equal_jax(n_shards):
    idx = graft._synthetic_index(n_docs=300, n_terms=20, seed=3)
    got = port_mesh.shard_blocks(idx["block_docs"], idx["block_tfs"],
                                 n_shards)
    ref = jax_mesh.shard_blocks(idx["block_docs"], idx["block_tfs"],
                                n_shards)
    for a, b in zip(got[:2], ref[:2]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got[2] == ref[2]
    assert np.array_equal(port_mesh.block_bases(got[0].shape[0], n_shards),
                          jax_mesh.block_bases(ref[0].shape[0], n_shards))
    rng = np.random.default_rng(n_shards)
    docs = rng.integers(0, 300, 997).astype(np.int32)
    imps = rng.random(997).astype(np.float32)
    got = port_mesh.shard_flat_postings(docs, imps, n_shards)
    ref = jax_mesh.shard_flat_postings(docs, imps, n_shards)
    for a, b in zip(got[:2], ref[:2]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got[2] == ref[2]


def scorer_inputs(n_shards, n_queries, seed=0):
    n_docs = 511
    n1 = -(-(n_docs + 1) // n_shards) * n_shards
    idx = graft._synthetic_index(n_docs=n_docs, seed=seed)
    doc_len = np.zeros((1, n1), dtype=np.float32)
    doc_len[:, :idx["doc_len"].shape[1]] = idx["doc_len"]
    deleted = np.ones(n1, dtype=bool)
    deleted[:idx["deleted"].shape[0]] = idx["deleted"]
    deleted[::37] = True  # tombstones
    return idx, n1, doc_len, deleted, graft._query_batch(
        idx, batch=n_queries, seed=seed + 1)


@pytest.mark.parametrize("n,query_axis", [(1, 1), (2, 1), (4, 1), (8, 1),
                                          (8, 2), (4, 2)])
def test_sharded_scorer_matches_jax(n, query_axis):
    import jax.numpy as jnp

    jm = jax_mesh.make_mesh(n, query_axis=query_axis)
    pm = make_mesh(n, query_axis=query_axis, devices=[CPU] * 8)
    assert pm.shape == dict(jm.shape)
    n_shards = pm.shape["shard"]
    n_queries = pm.shape["query"] * 4
    idx, n1, doc_len, deleted, qs = scorer_inputs(n_shards, n_queries)
    bd, bt, _per = jax_mesh.shard_blocks(idx["block_docs"],
                                         idx["block_tfs"], n_shards)
    bases = jax_mesh.block_bases(bd.shape[0], n_shards)
    ref = jax_mesh.make_sharded_scorer(jm, n1)(
        jnp.asarray(bd), jnp.asarray(bt), jnp.asarray(doc_len),
        jnp.asarray(idx["avgdl"]), jnp.asarray(deleted),
        *(jnp.asarray(x) for x in qs), jnp.float32(0.9), jnp.float32(0.4),
        jnp.asarray(bases), k=10)
    got = port_mesh.make_sharded_scorer(pm, n1)(
        bd, bt, doc_len, idx["avgdl"], deleted, *qs, 0.9, 0.4, bases, k=10)
    assert got[0].dtype == torch.float32
    assert_topk_close([x.numpy() for x in got], ref)


@pytest.mark.parametrize("n,query_axis", [(1, 1), (2, 1), (4, 1), (8, 1),
                                          (8, 2)])
def test_sharded_impact_scorer_matches_jax(n, query_axis):
    import jax.numpy as jnp

    jm = jax_mesh.make_mesh(n, query_axis=query_axis)
    pm = make_mesh(n, query_axis=query_axis, devices=[CPU] * n)
    n_shards = pm.shape["shard"]
    n_queries = pm.shape["query"] * 4
    idx, n1, doc_len, deleted, _qs = scorer_inputs(n_shards, n_queries, 4)
    nnz = idx["block_docs"].reshape(-1) < 511
    docs_flat = idx["block_docs"].reshape(-1)[nnz].astype(np.int32)
    impacts = np.random.default_rng(2).random(len(docs_flat)).astype(
        np.float32) + 0.1
    counts = [int((idx["block_docs"][s:s + c] < 511).sum())
              for s, c in zip(idx["term_start"], idx["term_count"])]
    base = np.concatenate([[0], np.cumsum(counts)])
    rng = np.random.default_rng(5)
    terms = rng.choice(len(counts), size=16, replace=False)
    slot_start = base[terms].astype(np.int32)
    slot_len = np.asarray(counts)[terms].astype(np.int32)
    w = rng.random((n_queries, 16)).astype(np.float32)
    w[w < 0.3] = 0.0
    p_pad = pow4_bucket(int(slot_len.sum()), minimum=1024)
    sd, si, per = jax_mesh.shard_flat_postings(docs_flat, impacts, n_shards)
    pbases = np.arange(n_shards, dtype=np.int32) * per
    ref = jax_mesh.make_sharded_impact_scorer(jm, n1)(
        jnp.asarray(sd), jnp.asarray(si), jnp.asarray(deleted),
        jnp.asarray(slot_start), jnp.asarray(slot_len), jnp.asarray(w),
        jnp.asarray(pbases), k=10, p_pad=p_pad)
    got = port_mesh.make_sharded_impact_scorer(pm, n1)(
        sd, si, deleted, slot_start, slot_len, w, pbases, k=10,
        p_pad=p_pad)
    assert_topk_close([x.numpy() for x in got], ref)


def test_build_m_matches_jax():
    import jax.numpy as jnp

    from searchlite_tpu.ops.impact import build_m as jax_build_m
    from searchlite_tpu_torch.ops.impact import build_m

    rng = np.random.default_rng(7)
    n1 = 300
    lens = [0, 5, 40, 0, 17, 3, 0, 0]
    docs, start = [], []
    for n in lens:
        start.append(sum(len(d) for d in docs))
        docs.append(np.sort(rng.choice(n1 - 1, size=n, replace=False)))
    docs_flat = np.concatenate(docs).astype(np.int32)
    imps = rng.random(len(docs_flat)).astype(np.float32)
    slot_start = np.asarray(start, dtype=np.int32)
    slot_len = np.asarray(lens, dtype=np.int32)
    for p_pad in (int(slot_len.sum()), 1024):
        ref = np.asarray(jax_build_m(
            jnp, jnp.asarray(docs_flat), jnp.asarray(imps),
            jnp.asarray(slot_start), jnp.asarray(slot_len), n1, p_pad))
        got = build_m(*(torch.from_numpy(x) for x in (
            docs_flat, imps, slot_start, slot_len)), n1, p_pad).numpy()
        assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_pow4_bucket_matches_jax():
    from searchlite_tpu.ops.impact import pow4_bucket as jax_pow4

    for n in (0, 1, 4096, 4097, 70_000, 10**7):
        for minimum in (64, 1024, 4096):
            assert pow4_bucket(n, minimum=minimum) == jax_pow4(
                n, minimum=minimum)
    assert pow4_bucket(5000) == jax_pow4(5000)


def test_merge_topk_breaks_ties_by_shard_then_doc():
    """Shard-major candidates: equal scores come back lowest position
    (lowest doc) first, whatever order torch.topk would pick."""
    s0 = torch.tensor([[2.0, 1.0, 1.0]])
    i0 = torch.tensor([[3, 1, 2]])
    s1 = torch.tensor([[2.0, 1.0, -np.inf]])
    i1 = torch.tensor([[10, 11, 0]])
    fs, fi = merge_topk([s0, s1], [i0, i1], 5, CPU)
    assert fs.tolist() == [[2.0, 2.0, 1.0, 1.0, 1.0]]
    assert fi.tolist() == [[3, 10, 1, 2, 11]]
    fs, fi = merge_topk([s0, s1], [i0, i1], 99, CPU)
    assert fs.shape == (1, 6)
    masked = torch.tensor([1.0, 3.0, 3.0, -0.0, 0.0])
    assert topk_by_doc(masked, 5)[1].tolist() == [1, 2, 0, 3, 4]


def test_mesh_object_and_make_mesh(monkeypatch):
    m = make_mesh(devices=[CPU] * 6, query_axis=2)
    assert isinstance(m, Mesh) and m.shape == {"query": 2, "shard": 3}
    assert m.axis_names == ("query", "shard")
    assert m.shard_devices == (CPU,) * 3 and m.device == CPU
    assert make_mesh(4, devices=[CPU] * 8).shape == {"query": 1, "shard": 4}
    assert make_mesh(devices=[CPU] * 5, query_axis=2).shape["shard"] == 5
    assert make_mesh(devices=[CPU] * 2).key == make_mesh(
        devices=["cpu", "cpu"]).key
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no"):
        make_mesh()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert [str(d) for d in make_mesh().shard_devices] == ["cuda:0",
                                                           "cuda:1"]
    with pytest.raises(ValueError):
        Mesh([])


def test_parse_mesh_spec_every_form(monkeypatch):
    monkeypatch.delenv("SEARCHLITE_TORCH_DEVICE", raising=False)
    for spec in (None, "", "off", "none", "0", 0, "1", 1):
        assert parse_mesh_spec(spec) is None
        assert parse_mesh_spec(spec, device="cpu") is None
    with pytest.raises(ValueError, match="invalid mesh spec"):
        parse_mesh_spec("many")
    # the CPU is one device: auto is ignored, a count builds that many
    # shards on it
    assert parse_mesh_spec("auto", device="cpu") is None
    m = parse_mesh_spec("4", device="cpu")
    assert m.shape == {"query": 1, "shard": 4} and set(m.key) == {"cpu"}
    # the card: auto takes every visible card; N shards go round robin
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert parse_mesh_spec("auto") is None
    assert [str(d) for d in parse_mesh_spec(4).shard_devices] == \
        ["cuda:0"] * 4
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert [str(d) for d in parse_mesh_spec("auto").shard_devices] == \
        ["cuda:0", "cuda:1"]
    assert [str(d) for d in parse_mesh_spec("3").shard_devices] == \
        ["cuda:0", "cuda:1", "cuda:0"]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert parse_mesh_spec("auto") is None
    with pytest.raises(RuntimeError, match="CUDA"):
        parse_mesh_spec("2")
    monkeypatch.setenv("SEARCHLITE_TORCH_DEVICE", "cpu")
    assert parse_mesh_spec(2).shape["shard"] == 2


@pytest.mark.parametrize("n", [2, 4, 8])
def test_dryrun_multichip(n, capsys):
    line = dryrun_multichip(n, devices=[CPU] * n)
    assert "dryrun_multichip ok" in line and "batch" in line
    assert "cursor" in capsys.readouterr().out


def test_dryrun_module_runs_on_the_cpu(capsys):
    from searchlite_tpu_torch.parallel.dryrun import main

    assert main(["2", "--device", "cpu"]) == 0
    assert "dryrun_multichip ok" in capsys.readouterr().out


@pytest.mark.cuda
def test_mesh_on_the_card(monkeypatch):
    """Four logical shards on one card: a batch with light and heavy rows
    launches each kernel once a shard per launch, no plain version runs,
    and batch and single answers equal the port's own CPU reader."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from searchlite_tpu_torch.ops import fused_topk, strip_topk
    from test_torch_live_card import build_index, queries, same_pairs

    monkeypatch.setenv("SEARCHLITE_HOST_TIER_DOCS", "0")
    monkeypatch.setenv("SEARCHLITE_SPARSE_MAX_BLOCKS", "2")
    idx, rng = build_index()
    card = idx.reader(device="cuda")
    host = idx.reader(device="cpu")
    mesh = make_mesh(devices=[torch.device("cuda", 0)] * 4)
    qs = queries(rng)
    want = host.search_batch(qs, limit=10)
    for c in (strip_topk.COUNTS, fused_topk.COUNTS):
        c.reset()
    got = card.search_batch(qs, limit=10, mesh=mesh)
    torch.cuda.synchronize()
    same_pairs(got, want)
    assert card.route_rows["mesh_strip"] and card.route_rows["mesh_dense"]
    for c in (strip_topk.COUNTS, fused_topk.COUNTS):
        assert c.plain == 0 and c.launches and c.launches % 4 == 0
    for q in qs[:6]:
        a = card.search({"query": q, "limit": 10}, mesh=mesh)
        b = host.search({"query": q, "limit": 10})
        same_pairs([[(h.doc_id, h.score) for h in a.hits]],
                   [[(h.doc_id, h.score) for h in b.hits]])
        assert a.total_hits_estimate == b.total_hits_estimate
