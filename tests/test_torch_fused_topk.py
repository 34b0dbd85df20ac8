"""The fused score + mask + top-k of the torch port
(searchlite_tpu_torch/ops/fused_topk.py) against the JAX package's: the
Pallas kernel in interpret mode (ops/pallas_topk.py, on
tests/test_pallas.py's shapes and seeds) and the dense scorers' XLA tail
(ops/impact.py::_score_m, and the split scorer's two dots) for k past 16,
deleted docs, filter rows, all-filtered rows and exact ties.

Tolerance: scores within rtol 1e-6 / atol 1e-4 (bench.py's f32_strict
gate) -- both sum in f32, in different orders (divergence D10). Ids must
agree wherever the reference score is finite and not within tolerance of
a neighbour; with integer-valued inputs every sum is exact, so ties are
real and ids must agree everywhere the score is finite (doc ascending)."""

import numpy as np
import pytest
import torch

from searchlite_tpu.ops.pallas_topk import C, QT, make_fused_topk
from searchlite_tpu_torch.ops.fused_topk import (CHUNK, COUNTS, _lib,
                                                 fused_topk, fused_topk_plain)

RTOL, ATOL = 1e-6, 1e-4


def assert_topk_close(ref_s, ref_i, got_s, got_i, exact_ids=False,
                      atol=ATOL):
    ref_s, ref_i = np.asarray(ref_s), np.asarray(ref_i)
    got_s, got_i = np.asarray(got_s), np.asarray(got_i)
    assert got_s.shape == ref_s.shape and got_i.shape == ref_i.shape
    fin = np.isfinite(ref_s)
    assert np.array_equal(np.isfinite(got_s), fin)
    assert np.allclose(got_s[fin], ref_s[fin], rtol=RTOL, atol=atol)
    if exact_ids:
        clear = fin
    else:
        tol = atol + RTOL * np.abs(np.where(fin, ref_s, 0.0))
        gap = np.full(ref_s.shape, np.inf)
        with np.errstate(invalid="ignore"):
            diff = np.abs(np.diff(ref_s, axis=1))
        gap[:, 1:] = np.minimum(gap[:, 1:], diff)
        gap[:, :-1] = np.minimum(gap[:, :-1], diff)
        clear = fin & (gap > tol)
    assert np.array_equal(got_i[clear], ref_i[clear])


def sparse(rng, shape, density, integer=False):
    vals = rng.integers(1, 4, shape) if integer else rng.random(shape)
    return (vals * (rng.random(shape) < density)).astype(np.float32)


def t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("seed", [3, 7])
def test_plain_matches_pallas_interpret(seed):
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    q, s, n = QT, 64, C * 2
    w = (rng.random((q, s)) * (rng.random((q, s)) < 0.3)).astype(np.float32)
    m = (rng.random((s, n)) * (rng.random((s, n)) < 0.2)).astype(np.float32)
    valid = np.ones(n, dtype=np.float32)
    valid[-37:] = 0.0
    ref_s, ref_i = make_fused_topk(interpret=True)(
        jnp.asarray(w), jnp.asarray(m), jnp.asarray(valid), k=10)
    got_s, got_i = fused_topk(t(w), t(m), t(valid == 0), k=10)
    assert_topk_close(ref_s, ref_i, got_s.numpy(), got_i.numpy())


def test_plain_all_filtered_like_pallas():
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    q, s, n = QT, 32, C
    w = rng.random((q, s)).astype(np.float32)
    m = rng.random((s, n)).astype(np.float32)
    valid = np.zeros(n, dtype=np.float32)
    ref_s, _ = make_fused_topk(interpret=True)(
        jnp.asarray(w), jnp.asarray(m), jnp.asarray(valid), k=5)
    got_s, got_i = fused_topk(t(w), t(m), t(valid == 0), k=5)
    assert np.all(np.asarray(ref_s) == -np.inf)
    assert np.all(got_s.numpy() == -np.inf)
    assert np.all(got_i.numpy() == n - 1)  # -inf rows carry the dead slot


def jax_tail(w1, m1, deleted, k, w2=None, m2=None, filter_rows=None,
             fidx=None):
    """The JAX dense scorers' tail on dense W: ``_score_m`` for one
    operand pair (its COO W built from the dense one), the split scorer's
    two dots + mask + ``lax.top_k`` for two."""
    import jax
    import jax.numpy as jnp

    from searchlite_tpu.ops.impact import _score_m

    if w2 is None:
        q, s = w1.shape
        nz = np.flatnonzero(w1.reshape(-1))
        pad = 16 - len(nz) % 16
        w_idx = np.concatenate([nz, q * s + np.arange(pad)]).astype(np.int32)
        w_val = np.concatenate([w1.reshape(-1)[nz],
                                np.zeros(pad)]).astype(np.float32)
        return _score_m(jax, jnp, jnp.asarray(m1), jnp.asarray(deleted),
                        jnp.asarray(w_idx), jnp.asarray(w_val), k, s, q,
                        None if filter_rows is None
                        else jnp.asarray(filter_rows),
                        None if fidx is None else jnp.asarray(fidx))
    scores = (jnp.dot(w1, m1, preferred_element_type=jnp.float32)
              + jnp.dot(w2, m2, preferred_element_type=jnp.float32))
    ok = (scores > 0.0) & ~jnp.asarray(deleted)[None, :]
    if filter_rows is not None:
        ok = ok & jnp.asarray(filter_rows)[jnp.asarray(fidx)]
    return jax.lax.top_k(jnp.where(ok, scores, -jnp.inf), k)


CASES = [
    # (q, s1, s2, n, k, n_filters, integer)
    (24, 40, 0, 700, 10, 0, False),
    (24, 40, 0, 700, 50, 3, False),     # k past the Pallas kernel's 16
    (17, 30, 12, 600, 40, 4, False),    # two operand pairs, filters
    (16, 20, 8, 513, 200, 2, True),     # exact ties, ragged doc axis
    (9, 12, 0, 300, 300, 0, True),      # k = the whole doc axis
]


@pytest.mark.parametrize("q,s1,s2,n,k,nf,integer", CASES)
def test_plain_matches_jax_dense_tail(q, s1, s2, n, k, nf, integer):
    rng = np.random.default_rng(q * n + k)
    w1 = sparse(rng, (q, s1), 0.3, integer)
    m1 = sparse(rng, (s1, n), 0.25, integer)
    w2 = sparse(rng, (q, s2), 0.4, integer) if s2 else None
    m2 = sparse(rng, (s2, n), 0.2, integer) if s2 else None
    deleted = rng.random(n) < 0.1
    filter_rows = fidx = None
    if nf:
        filter_rows = rng.random((nf, n)) < 0.5
        filter_rows[0] = True
        filter_rows[-1] = False  # a filter that matches nothing
        fidx = rng.integers(0, nf, q).astype(np.int32)
        fidx[0] = nf - 1
    ref_s, ref_i = jax_tail(w1, m1, deleted, k, w2, m2, filter_rows, fidx)
    got_s, got_i = fused_topk(t(w1), t(m1), t(deleted), k=k, w2=t(w2),
                              m2=t(m2), filter_rows=t(filter_rows),
                              fidx=t(fidx))
    assert_topk_close(ref_s, ref_i, got_s.numpy(), got_i.numpy(),
                      exact_ids=integer)
    if nf:
        assert np.isneginf(got_s.numpy()[0]).all()  # the all-false filter
    assert (got_i.numpy()[np.isneginf(got_s.numpy())] == n - 1).all()


def test_dispatch_counts_and_refuses_bad_operands():
    w = torch.rand(3, 4)
    m = torch.rand(4, 9)
    deleted = torch.zeros(9, dtype=torch.bool)
    before = (COUNTS.launches, COUNTS.plain)
    fused_topk(w, m, deleted, k=2)
    assert (COUNTS.launches, COUNTS.plain) == (before[0], before[1] + 1)
    with pytest.raises(NotImplementedError):
        fused_topk(w.to("meta"), m.to("meta"), deleted.to("meta"), k=2)
    for kwargs in ({"k": 0}, {"k": 10}, {"k": 2, "w2": w},
                   {"k": 2, "filter_rows": deleted[None]},
                   {"k": 2, "w2": w, "m2": torch.rand(4, 8)}):
        with pytest.raises(ValueError):
            fused_topk(w, m, deleted, **kwargs)
    with pytest.raises(ValueError):
        fused_topk(w.double(), m, deleted, k=2)
    s, i = fused_topk_plain(w[:0], m, deleted, k=2)
    assert s.shape == (0, 2) and i.shape == (0, 2)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    for q, s1, s2, n, k, nf, integer in CASES + [
            (70, 300, 64, 20000, 10, 3, False),
            (4, 16, 8, 40000, 20000, 0, True)]:  # the global sort path
        rng = np.random.default_rng(q + n + k)
        w1 = sparse(rng, (q, s1), 0.3, integer)
        m1 = sparse(rng, (s1, n), 0.25, integer)
        w2 = sparse(rng, (q, s2), 0.4, integer) if s2 else None
        m2 = sparse(rng, (s2, n), 0.2, integer) if s2 else None
        deleted = rng.random(n) < 0.1
        filter_rows = fidx = None
        if nf:
            filter_rows = rng.random((nf, n)) < 0.5
            filter_rows[-1] = False
            fidx = rng.integers(0, nf, q).astype(np.int32)

        def cuda(x):
            return None if x is None else t(x).cuda()

        args = (cuda(w1), cuda(m1), cuda(deleted))
        kw = dict(k=k, w2=cuda(w2), m2=cuda(m2),
                  filter_rows=cuda(filter_rows), fidx=cuda(fidx))
        launches = COUNTS.launches
        got_s, got_i = fused_topk(*args, **kw)
        assert COUNTS.launches == launches + 1
        ref_s, ref_i = fused_topk_plain(*args, **kw)
        assert_topk_close(ref_s.cpu().numpy(), ref_i.cpu().numpy(),
                          got_s.cpu().numpy(), got_i.cpu().numpy(),
                          exact_ids=integer)
        assert np.array_equal(np.isneginf(got_s.cpu().numpy()),
                              np.isneginf(ref_s.cpu().numpy()))
        assert (got_i.cpu().numpy()[np.isneginf(got_s.cpu().numpy())]
                == n - 1).all()


# the redesigned kernel's edges: (q, s1, s2, n, k, filter rows). Every case
# also has a query without any weight (row 0) and, with filters, a filter
# row that matches nothing (row 1's).
EDGE_CASES = [
    (40, 300, 64, 5 * CHUNK - 37, 10, 3),      # N not a multiple of CHUNK
    (16, 200, 32, 20 * CHUNK, CHUNK - 1, 0),   # k one under the chunk
    (16, 200, 32, 20 * CHUNK, CHUNK, 2),       # k = the chunk
    (16, 200, 32, 20 * CHUNK, CHUNK + 1, 2),   # k one over it
    (13, 120, 0, 8 * CHUNK, 10, 0),            # Q not a multiple of 8
    (9, 50, 7, 3 * CHUNK + 1, 37, 2),          # odd N: scalar loads
    (300, 64, 16, 4 * CHUNK, 5, 4),            # many rows, one select level
]


@pytest.mark.cuda
@pytest.mark.parametrize("q,s1,s2,n,k,nf", EDGE_CASES)
def test_kernel_edges_match_plain_on_card(q, s1, s2, n, k, nf):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    rng = np.random.default_rng(q * 7 + k)
    w1 = sparse(rng, (q, s1), 4.0 / s1)
    w1[0] = 0.0
    m1 = sparse(rng, (s1, n), 0.05)
    w2 = m2 = None
    if s2:
        w2 = sparse(rng, (q, s2), 2.0 / s2)
        w2[0] = 0.0
        m2 = sparse(rng, (s2, n), 0.05)
    deleted = rng.random(n) < 0.05
    filter_rows = fidx = None
    if nf:
        filter_rows = rng.random((nf, n)) < 0.5
        filter_rows[0] = True
        filter_rows[-1] = False
        fidx = rng.integers(0, nf - 1, q).astype(np.int32)
        fidx[1] = nf - 1

    def cuda(x):
        return None if x is None else t(x).cuda()

    args = (cuda(w1), cuda(m1), cuda(deleted))
    kw = dict(k=k, w2=cuda(w2), m2=cuda(m2), filter_rows=cuda(filter_rows),
              fidx=cuda(fidx))
    launches = COUNTS.launches
    got_s, got_i = fused_topk(*args, **kw)
    assert COUNTS.launches == launches + 1
    assert _lib().fused_topk_chunk() == CHUNK
    ref_s, ref_i = fused_topk_plain(*args, **kw)
    got_s, got_i = got_s.cpu().numpy(), got_i.cpu().numpy()
    assert_topk_close(ref_s.cpu().numpy(), ref_i.cpu().numpy(), got_s, got_i)
    assert np.isneginf(got_s[0]).all() and (got_i[0] == n - 1).all()
    if nf:
        assert np.isneginf(got_s[1]).all() and (got_i[1] == n - 1).all()
    assert (got_i[np.isneginf(got_s)] == n - 1).all()
    assert np.isfinite(got_s).sum() > 0
