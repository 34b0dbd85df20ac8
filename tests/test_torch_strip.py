"""Strip core of the torch port (searchlite_tpu_torch/ops/strip_topk.py)
against the JAX package's strip cores on the same numpy strips: the
default sort core (ops/sparse.py::make_strip_prune_probe) and the Pallas
kernel in interpret mode (ops/pallas_strip.py, as test_pallas_strip.py
runs it).

Tolerance: scores within rtol 1e-6 / atol 1e-6 -- the Pallas core's
bitonic sort is unstable, so a run's values may be summed in another
order (f32 reassociation, divergence D10). Against the stable sort core
the port is bit-identical. Ids must agree wherever the reference score is
finite and not within tolerance of a neighbour (near-ties may swap under
reassociation). Match counts are exact."""

import numpy as np
import pytest
import torch

from searchlite_tpu.ops.pallas_strip import (make_pallas_strip_core,
                                             pallas_strip_topk)
from searchlite_tpu.ops.sparse import make_strip_prune_probe
from searchlite_tpu_torch.ops.strip_topk import (COUNTS, LANES_COUNTS,
                                                 strip_lanes_blocks,
                                                 strip_lanes_blocks_plain,
                                                 strip_topk,
                                                 strip_topk_blocks,
                                                 strip_topk_plain)

RTOL = ATOL = 1e-6


def build_strips(rng, B, L, n1, n_terms=4, zero_rate=0.05):
    """Seeded strips shaped like gathered posting blocks: ``n_terms``
    doc-ascending runs of unique docs per row (docs repeat across runs),
    (sentinel, 0) pads after a random fill, some zero values. Row 0 is
    all sentinel; row 1's values are all 0 (a row of -inf results)."""
    sent = n1 - 1
    d = np.full((B, L), sent, dtype=np.int32)
    v = np.zeros((B, L), dtype=np.float32)
    per = L // n_terms
    for b in range(B):
        cur = 0
        for _t in range(n_terms):
            n = int(rng.integers(per // 3, per + 1))
            docs = np.unique(rng.integers(0, n1 - 1, n)).astype(np.int32)
            d[b, cur:cur + len(docs)] = docs
            v[b, cur:cur + len(docs)] = rng.random(len(docs),
                                                   dtype=np.float32) + 0.1
            cur += len(docs)
    v[rng.random((B, L)) < zero_rate] = 0.0
    d[0] = sent
    v[0] = 0.0
    v[1] = 0.0
    return d, v


def assert_topk_close(ts_ref, td_ref, ts, td):
    ts_ref, td_ref = np.asarray(ts_ref), np.asarray(td_ref)
    ts, td = np.asarray(ts), np.asarray(td)
    assert ts.shape == ts_ref.shape and td.shape == td_ref.shape
    fin = np.isfinite(ts_ref)
    assert np.array_equal(np.isfinite(ts), fin)
    assert np.allclose(ts[fin], ts_ref[fin], rtol=RTOL, atol=ATOL)
    tol = ATOL + RTOL * np.abs(ts_ref)
    with np.errstate(invalid="ignore"):  # -inf - -inf
        diff = np.abs(np.diff(ts_ref, axis=1))
    gap_prev = np.full(ts_ref.shape, np.inf)
    gap_prev[:, 1:] = diff
    gap_next = np.full(ts_ref.shape, np.inf)
    gap_next[:, :-1] = diff
    clear = fin & (gap_prev > tol) & (gap_next > tol)
    assert np.array_equal(td[clear], td_ref[clear])


CASES = [
    # (B, L, k, log2_run, n1)
    (16, 512, 10, 3, 5000),
    (8, 384, 10, 2, 3000),     # non-power-of-2 width: padded in place
    (8, 200, 64, 2, 400),      # k past most rows' matches, dense dups
]


@pytest.mark.parametrize("B,L,k,log2_run,n1", CASES)
def test_plain_matches_jax_sort_core(B, L, k, log2_run, n1):
    _, sort_core = make_strip_prune_probe()
    rng = np.random.default_rng(B * L + k)
    d, v = build_strips(rng, B, L, n1)
    t_of = np.zeros((B, L), dtype=np.int32)
    ts_ref, td_ref, _ok = sort_core(d, v, t_of, n1 - 1, k=k, c=k,
                                    t_pad=4, log2_run=log2_run)
    ts, td = strip_topk(torch.from_numpy(d), torch.from_numpy(v), n1 - 1,
                        k=k, log2_run=log2_run)
    assert_topk_close(ts_ref, td_ref, ts.numpy(), td.numpy())
    # the stable sort core sums every run in the same order: bit-identical
    fin = np.isfinite(np.asarray(ts_ref))
    assert np.array_equal(np.asarray(ts_ref)[fin].view(np.int32),
                          ts.numpy()[fin].view(np.int32))


@pytest.mark.parametrize("B,L,k,log2_run,n1", CASES)
def test_plain_matches_pallas_interpret(B, L, k, log2_run, n1):
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(B * L + k + 1)
    d, v = build_strips(rng, B, L, n1)
    core = make_pallas_strip_core(rows_per_block=8, interpret=True)
    ts_ref, td_ref = core(d, v, n1 - 1, k=k, log2_run=log2_run)
    counted = jax.jit(lambda d, v: pallas_strip_topk(
        jax, jnp, d, v, n1 - 1, k=k, log2_run=log2_run, with_counts=True,
        interpret=True))
    cnt_ref = np.asarray(counted(d, v)[2])
    ts, td, cnt = strip_topk(torch.from_numpy(d), torch.from_numpy(v),
                             n1 - 1, k=k, log2_run=log2_run,
                             with_counts=True)
    assert_topk_close(ts_ref, td_ref, ts.numpy(), td.numpy())
    assert np.array_equal(cnt.numpy(), cnt_ref)
    assert cnt_ref[0] == 0 and cnt_ref[1] == 0
    assert np.isneginf(ts.numpy()[:2]).all()


def test_k_wider_than_strip_pads_with_neg_inf():
    d = torch.tensor([[3, 1, 1, 9]], dtype=torch.int32)
    v = torch.tensor([[0.5, 1.0, 0.25, 0.0]], dtype=torch.float32)
    ts, td, cnt = strip_topk(d, v, 9, k=6, log2_run=1, with_counts=True)
    assert ts.tolist() == [[1.25, 0.5] + [float("-inf")] * 4]
    assert td[0, :2].tolist() == [1, 3]
    assert cnt.tolist() == [2]


def test_ties_break_doc_ascending():
    # docs 7 and 2 tie at 1.0 (7 via a two-lane run); 5 scores higher
    d = torch.tensor([[7, 5, 2, 7, 11, 11]], dtype=torch.int32)
    v = torch.tensor([[0.5, 2.0, 1.0, 0.5, 0.0, 0.0]])
    ts, td = strip_topk(d, v, 11, k=3, log2_run=1)
    assert ts.tolist() == [[2.0, 1.0, 1.0]]
    assert td.tolist() == [[5, 2, 7]]


def test_dispatch_counts_cpu_calls_and_refuses_other_devices():
    d = torch.zeros((2, 8), dtype=torch.int32)
    v = torch.ones((2, 8), dtype=torch.float32)
    before = (COUNTS.launches, COUNTS.plain)
    strip_topk(d, v, 9, k=2, log2_run=1)
    assert (COUNTS.launches, COUNTS.plain) == (before[0], before[1] + 1)
    with pytest.raises(NotImplementedError):
        strip_topk(d.to("meta"), v.to("meta"), 9, k=2, log2_run=1)
    with pytest.raises(ValueError):
        strip_topk(d, v.double(), 9, k=2, log2_run=1)
    with pytest.raises(ValueError):
        strip_topk(d, v[:, :4], 9, k=2, log2_run=1)


def strips_to_blocks(d, v, sent):
    """Block tables holding the same strips: each row's doc-ascending
    runs become term slots of 128-lane block rows (sentinel-padded), with
    weight 1 so every value is its impact. Returns (block_docs,
    block_impacts, bstart, bcnt, w, sent [2], nblk)."""
    docs_rows, imps_rows, slots = [], [], []
    for b in range(d.shape[0]):
        live = np.flatnonzero(d[b] != sent)
        cuts = np.flatnonzero(np.diff(d[b, live]) <= 0) + 1
        row = []
        for run in np.split(live, cuts):
            if not len(run):
                continue
            nb = -(-len(run) // 128)
            bd = np.full(nb * 128, sent, dtype=np.int32)
            bi = np.zeros(nb * 128, dtype=np.float32)
            bd[:len(run)] = d[b, run]
            bi[:len(run)] = v[b, run]
            row.append((sum(len(x) for x in docs_rows), nb))
            docs_rows.append(bd.reshape(nb, 128))
            imps_rows.append(bi.reshape(nb, 128))
        slots.append(row)
    docs_rows.append(np.full((1, 128), sent, dtype=np.int32))
    imps_rows.append(np.zeros((1, 128), dtype=np.float32))
    t_pad = max(2, max(len(r) for r in slots))
    bstart = np.zeros((d.shape[0], t_pad), dtype=np.int32)
    bcnt = np.zeros_like(bstart)
    w = np.zeros(bstart.shape, dtype=np.float32)
    for b, row in enumerate(slots):
        for s_, (r0, nb) in enumerate(row):
            bstart[b, s_], bcnt[b, s_], w[b, s_] = r0, nb, 1.0
    block_docs = np.concatenate(docs_rows)
    nblk = max(int(bcnt.sum(axis=1).max()), 1)
    return (block_docs, np.concatenate(imps_rows), bstart, bcnt, w,
            np.array([block_docs.shape[0] - 1, sent], dtype=np.int32), nblk)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from searchlite_tpu_torch.ops.strip_topk import strip_topk_blocks

    rng = np.random.default_rng(9)
    for B, L, k in [(64, 2048, 10), (16, 12288, 10), (4, 65536, 10),
                    (2, 131072, 10), (4, 4096, 1024)]:
        d, v = build_strips(rng, B, L, 131072)
        *tables, nblk = strips_to_blocks(d, v, 131071)
        launches = COUNTS.launches
        ts, td, cnt = strip_topk_blocks(
            *(torch.from_numpy(a).cuda() for a in tables), k=k, nblk=nblk,
            log2_run=2, with_counts=True)
        assert COUNTS.launches == launches + 1
        ps, pd, pc = strip_topk_plain(torch.from_numpy(d),
                                      torch.from_numpy(v),
                                      torch.tensor([131071],
                                                   dtype=torch.int32),
                                      k=k, log2_run=2)
        ts, td, ps, pd = (x.cpu().numpy() for x in (ts, td, ps, pd))
        fin = np.isfinite(ps)
        assert np.array_equal(np.isfinite(ts), fin)
        assert np.array_equal(ts[fin].view(np.int32), ps[fin].view(np.int32))
        assert np.array_equal(td[fin], pd[fin])
        assert np.array_equal(cnt.cpu().numpy(), pc.numpy())
    # the gathered (d, v) strip has no kernel: the card reads blocks
    d = torch.tensor([[3, 1, 1, 9, 3]], dtype=torch.int32, device="cuda")
    v = torch.tensor([[0.5, 1.0, 0.25, 2.0, 0.5]], device="cuda")
    with pytest.raises(NotImplementedError, match="strip_topk_blocks"):
        strip_topk(d, v, 9, k=8, log2_run=1)


def lanes_as_set(scores, docs):
    """{doc: score bits} of a strip's kept lanes."""
    keep = np.isfinite(scores)
    return dict(zip(docs[keep].tolist(),
                    scores[keep].view(np.int32).tolist()))


def test_lanes_match_the_top_k_at_the_strip_width():
    """strip_lanes_blocks: every kept doc once with its score -- the set
    strip_topk_blocks returns at k = the strip's width, bit for bit."""
    rng = np.random.default_rng(4)
    d, v = build_strips(rng, 6, 1024, 3000)
    *tables, nblk = strips_to_blocks(d, v, 2999)
    args = [torch.from_numpy(a) for a in tables]
    ls, ld, lc = strip_lanes_blocks(*args, nblk=nblk, log2_run=2)
    ts, td, tc = strip_topk_blocks(*args, k=nblk * 128, nblk=nblk,
                                   log2_run=2, with_counts=True)
    assert torch.equal(lc, tc)
    for b in range(6):
        got = lanes_as_set(ls[b].numpy(), ld[b].numpy())
        assert got == lanes_as_set(ts[b].numpy(), td[b].numpy())
        assert len(got) == int(lc[b])
    assert int(lc[0]) == 0 and int(lc[1]) == 0


@pytest.mark.cuda
def test_lanes_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    rng = np.random.default_rng(19)
    for B, L in [(2, 24576), (2, 65536), (3, 8192)]:
        d, v = build_strips(rng, B, L, 131072)
        *tables, nblk = strips_to_blocks(d, v, 131071)
        launches = LANES_COUNTS.launches
        ks, kd, kc = strip_lanes_blocks(
            *(torch.from_numpy(a).cuda() for a in tables), nblk=nblk,
            log2_run=2)
        assert LANES_COUNTS.launches == launches + 1
        ps, pd, pc = strip_lanes_blocks_plain(
            *(torch.from_numpy(a) for a in tables), nblk=nblk, log2_run=2)
        assert torch.equal(kc.cpu(), pc)
        for b in range(B):
            assert lanes_as_set(ks[b].cpu().numpy(), kd[b].cpu().numpy()) \
                == lanes_as_set(ps[b].numpy(), pd[b].numpy())
