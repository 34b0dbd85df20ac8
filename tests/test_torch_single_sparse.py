"""The port's sparse single-query routes against the JAX reader's
(``_try_sparse_single``, ``make_sparse_single_split_scorer``), with
``SEARCHLITE_SINGLE_SPARSE_MIN_DOCS=0`` (the JAX package's own knob, as in
tests/test_single_sparse.py) on a small corpus with head terms and
tombstones, so ``live_term_df`` differs from ``df``.

``SEARCHLITE_SINGLE_SPARSE_BLOCKS=4`` sets the strip cap so the corpus's
head terms pass it and the term split runs; ``SEARCHLITE_SPLIT_UB_RATIO=0``
keeps the routing predictor from declining it. Per split call the port's
``n_strip``, ``overlap`` and ``sound`` equal the JAX scorer's exactly; per
request the match counts are equal and the hits agree within the
f32_strict tolerance (the two sum a doc's terms in their own orders,
D10)."""

import numpy as np
import pytest
import torch

from searchlite_tpu.api.types import IndexOptions as JaxIndexOptions
from searchlite_tpu.index import Index as JaxIndex
from searchlite_tpu.index.manifest import Schema as JaxSchema
from searchlite_tpu_torch.api import reader as torch_reader_mod
from searchlite_tpu_torch.api.types import IndexOptions
from searchlite_tpu_torch.index import Index
from searchlite_tpu_torch.index.manifest import Schema
from searchlite_tpu_torch.ops.sparse import sparse_single_split_scorer
from searchlite_tpu_torch.ops.strip_topk import COUNTS, LANES_COUNTS

RTOL, ATOL = 1e-6, 1e-4
HEADS = ["h0", "h1", "h2"]
MIDS = [f"m{i}" for i in range(40)]


def write_corpus(path, seed=31, n_docs=2600, package="jax"):
    """Two commits, then tombstones; written by the JAX package (the
    CPU parity tests) or the port (the card's test: no JAX there)."""
    index_cls, options_cls, schema_cls = (
        (JaxIndex, JaxIndexOptions, JaxSchema) if package == "jax"
        else (Index, IndexOptions, Schema))
    rng = np.random.default_rng(seed)
    idx = index_cls.create(
        options_cls(path=str(path), create_if_missing=True),
        schema_cls.from_json({"text_fields": [
            {"name": "body", "analyzer": "default", "stored": False,
             "indexed": True}]}))
    w = idx.writer()
    mid_p = 1.0 / np.arange(1, len(MIDS) + 1)
    mid_p /= mid_p.sum()
    for i in range(n_docs):
        toks = list(rng.choice(MIDS, size=int(rng.integers(2, 12)),
                               p=mid_p))
        for h, p in zip(HEADS, (0.75, 0.5, 0.35)):
            if rng.random() < p:
                toks += [h] * int(rng.integers(1, 3))
        rng.shuffle(toks)
        w.add_document({"_id": str(i), "body": " ".join(toks)})
        if i == n_docs // 2:
            w.commit()
    w.commit()
    for i in range(0, n_docs, 9):
        w.delete_document(str(i))
    w.commit()


@pytest.fixture(scope="module")
def readers(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_single_sparse")
    write_corpus(path)
    jidx = JaxIndex.open(JaxIndexOptions(path=str(path)))
    tidx = Index.open(IndexOptions(path=str(path)))
    return jidx.reader(), tidx.reader(device="cpu")


@pytest.fixture(autouse=True)
def routes(monkeypatch):
    monkeypatch.setenv("SEARCHLITE_PRECISION", "f32_strict")
    monkeypatch.setenv("SEARCHLITE_SINGLE_SPARSE_MIN_DOCS", "0")
    monkeypatch.setenv("SEARCHLITE_SINGLE_SPARSE_BLOCKS", "4")
    monkeypatch.setenv("SEARCHLITE_SPLIT_UB_RATIO", "0")


def make_queries(seed=7, n=40):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        terms = list(rng.choice(MIDS[8:], size=int(rng.integers(1, 4))))
        if i % 4 != 3:  # most queries hold one or two head terms
            terms += list(rng.choice(HEADS, size=1 + i % 2, replace=False))
        out.append(" ".join(terms))
    return out


def spy_split(jreader, monkeypatch):
    """Record (n_strip, overlap, sound) of every split-scorer call of
    both readers."""
    calls = {"jax": [], "torch": []}
    make = jreader._sparse_single_split_scorer

    def jax_scorer():
        inner = make()

        def run(*args, **kwargs):
            out = inner(*args, **kwargs)
            calls["jax"].append(tuple(np.asarray(x) for x in out[2:]))
            return out
        return run

    def torch_scorer(*args, **kwargs):
        out = sparse_single_split_scorer(*args, **kwargs)
        calls["torch"].append(tuple(x.numpy() for x in out[2:]))
        return out

    monkeypatch.setattr(jreader, "_sparse_single_split_scorer", jax_scorer)
    monkeypatch.setattr(torch_reader_mod, "sparse_single_split_scorer",
                        torch_scorer)
    return calls


def assert_same_topk(got, want):
    assert got.total_hits_estimate == want.total_hits_estimate
    assert len(got.hits) == len(want.hits)
    want_score = {h.doc_id: h.score for h in want.hits}
    for g, w in zip(got.hits, want.hits):
        assert abs(g.score - w.score) <= ATOL + RTOL * abs(w.score)
        if g.doc_id != w.doc_id:  # near-tie swap
            assert abs(want_score[g.doc_id] - w.score) <= \
                ATOL + RTOL * abs(w.score)


@pytest.mark.parametrize("limit", [3, 10, 40])
def test_split_and_plain_routes_match_jax(readers, monkeypatch, limit):
    jreader, treader = readers
    calls = spy_split(jreader, monkeypatch)
    before = dict(treader.single_routes)
    plain = (COUNTS.plain, LANES_COUNTS.plain)
    for q in make_queries(seed=limit):
        req = {"query": q, "limit": limit}
        assert_same_topk(treader.search(dict(req)), jreader.search(dict(req)))
    assert len(calls["torch"]) == len(calls["jax"]) > 0
    for (tn, tov, tsd), (jn, jov, jsd) in zip(calls["torch"], calls["jax"]):
        assert np.array_equal(tn, jn)
        assert np.array_equal(tov, jov)
        assert np.array_equal(tsd, jsd)
    routes = {k: treader.single_routes[k] - before[k] for k in before}
    assert routes["sparse_split"] == len(calls["torch"])
    assert routes["sparse_plain"] > 0
    assert routes["sparse_split"] > routes["split_fallthrough"]
    # the strip core, top-k (plain route) and all lanes (split route):
    # their plain versions here
    assert COUNTS.plain > plain[0] and LANES_COUNTS.plain > plain[1]


def test_tombstones_change_live_df(readers):
    _jreader, treader = readers
    for dseg in treader.device_segments:
        tid = dseg.reader.terms.get("body:h0")
        df = int(dseg.reader.postings.term_df[tid])
        live = dseg.live_term_df(tid)
        assert 0 < live < df
        docs, _tfs = dseg.reader.postings.term_postings(tid)
        assert live == sum(1 for d in docs.tolist()
                           if d not in dseg.reader.deleted)


def test_one_heavy_term_count_is_exact(readers):
    """With one heavy term the split route's count is exact: it equals
    the dense executor's."""
    _jreader, treader = readers
    for q in ("h0 m20", "h0 m31 m33", "h1 m25"):
        fast = treader.search({"query": q, "limit": 10})
        dense = treader.search({"query": q, "limit": 10, "explain": True})
        assert fast.total_hits_estimate == dense.total_hits_estimate
        assert [h.doc_id for h in fast.hits] == \
            [h.doc_id for h in dense.hits]


@pytest.mark.cuda
def test_split_scorer_kernel_matches_plain_on_card(tmp_path, monkeypatch):
    """The split scorer on the card (the strip kernel at k = the strip's
    width) against the same call on CPU copies (the plain version): the
    certificate bits exactly, scores and ids bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    write_corpus(tmp_path, package="torch")
    creader = Index.open(IndexOptions(path=str(tmp_path))).reader(
        device="cuda")
    calls = []

    def record(*args, **kwargs):
        out = sparse_single_split_scorer(*args, **kwargs)
        cpu_args = [a.cpu() if isinstance(a, torch.Tensor) else a
                    for a in args]
        calls.append((out, sparse_single_split_scorer(*cpu_args, **kwargs)))
        return out

    monkeypatch.setattr(torch_reader_mod, "sparse_single_split_scorer",
                        record)
    for q in make_queries(seed=3, n=12):
        creader.search({"query": q, "limit": 10})
    assert calls
    for card, plain in calls:
        ts, ids, n_strip, overlap, sound = (x.cpu() for x in card)
        pts, pids, pn, pov, psd = plain
        assert torch.equal(n_strip, pn) and torch.equal(overlap, pov)
        assert torch.equal(sound, psd)
        fin = torch.isfinite(pts)
        assert torch.equal(torch.isfinite(ts), fin)
        assert torch.equal(ts[fin], pts[fin]) and torch.equal(ids[fin],
                                                              pids[fin])
