"""The torch port's on-device aggregation reductions and static structures
(``searchlite_tpu_torch/ops/device_aggs.py``) against the JAX package's
(``searchlite_tpu/ops/device_aggs.py``) on the CPU: the same seeded numpy
codes, masks and moment vectors through both.

Tolerances: counts and min / max exact; sums rtol 1e-6 (the JAX functions
accumulate in f32, the port in f64 over the same f32 moments); structures
array for array (exact, dtype included); ``spec_device_able`` equal on a
table of specs, under ``f32_strict`` and not. The ``cuda``-marked cases
run the reductions on the card against numpy, twice, for the run-to-run
bound the module states (rtol 1e-12); the module imports the JAX package
only inside the tests that compare with it, so those cases run on a
machine that has only PyTorch:

    python -m pytest tests/test_torch_device_aggs.py -q -m cuda --noconftest
"""

import random

import numpy as np
import pytest
import torch

from searchlite_tpu_torch.ops import device_aggs as port_da

SUM_RTOL = 1e-6
RUN_TO_RUN_RTOL = 1e-12


def seeded_inputs(seed, n=20_000, v=3, n_buckets=37, rows=5):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, n_buckets, (n, v)).astype(np.int32)
    # pads (-1) behind each doc's distinct codes, some docs with none
    width = rng.integers(0, v + 1, n)
    codes[np.arange(v)[None, :] >= width[:, None]] = -1
    mask = rng.random(n) < 0.4
    has = rng.random(n) < 0.8
    cnt = np.where(has, rng.integers(1, 4, n), 0).astype(np.float32)
    vals = rng.integers(-20, 100, n).astype(np.float32)
    sm = np.where(has, vals * cnt, 0).astype(np.float32)
    ss = np.where(has, vals * vals * cnt, 0).astype(np.float32)
    mn = np.where(has, vals - 3, 0).astype(np.float32)
    mx = np.where(has, vals + 5, 0).astype(np.float32)
    range_rows = rng.random((rows, n)) < 0.3
    return {"codes": codes, "mask": mask, "has": has, "cnt": cnt, "sm": sm,
            "ss": ss, "mn": mn, "mx": mx, "rows": range_rows,
            "n_buckets": n_buckets}


def numpy_reductions(x):
    """The nine reductions in numpy f64: the oracle of the card cases."""
    nb = x["n_buckets"]
    codes, mask = x["codes"], x["mask"]
    sel = mask[:, None] & (codes >= 0)
    flat = codes[sel]
    out = {"counts2d": np.bincount(flat, minlength=nb)}

    def wsum(vec, pick=sel):
        w = np.broadcast_to(vec.astype(np.float64)[:, None], codes.shape)
        return np.bincount(codes[pick], weights=w[pick], minlength=nb)

    out["wsum2d"] = wsum(x["cnt"])
    sel_has = sel & x["has"][:, None]
    lo = np.full(nb, np.inf, dtype=np.float32)
    hi = np.full(nb, -np.inf, dtype=np.float32)
    np.minimum.at(lo, codes[sel_has], np.broadcast_to(
        x["mn"][:, None], codes.shape)[sel_has])
    np.maximum.at(hi, codes[sel_has], np.broadcast_to(
        x["mx"][:, None], codes.shape)[sel_has])
    out["substats"] = (wsum(x["cnt"]), wsum(x["sm"]), wsum(x["ss"]), lo, hi)
    rows = x["rows"]
    out["range_counts"] = (rows & mask[None, :]).sum(axis=1)
    w = mask.astype(np.float64)
    out["row_wsum"] = rows.astype(np.float64) @ (w * x["cnt"])
    rsel = rows & (mask & x["has"])[None, :]
    out["row_substats"] = (
        rows.astype(np.float64) @ (w * x["cnt"]),
        rows.astype(np.float64) @ (w * x["sm"]),
        rows.astype(np.float64) @ (w * x["ss"]),
        np.where(rsel, x["mn"][None, :], np.inf).min(axis=1),
        np.where(rsel, x["mx"][None, :], -np.inf).max(axis=1))
    ok = mask & x["has"]
    out["vec_stats"] = (
        (w * x["cnt"]).sum(), (w * x["sm"]).sum(), (w * x["ss"]).sum(),
        np.where(ok, x["mn"], np.inf).min(),
        np.where(ok, x["mx"], -np.inf).max())
    out["masked_dot"] = (w * x["sm"]).sum()
    out["mask_count"] = int(mask.sum())
    return out


def port_reductions(x, device):
    t = {k: torch.from_numpy(v).to(device) for k, v in x.items()
         if isinstance(v, np.ndarray)}
    nb = x["n_buckets"]
    moments = (t["cnt"], t["sm"], t["ss"], t["mn"], t["mx"], t["has"])
    return {
        "counts2d": port_da.bucket_counts2d(t["codes"], t["mask"],
                                            n_buckets=nb),
        "wsum2d": port_da.bucket_wsum2d(t["codes"], t["mask"], t["cnt"],
                                        n_buckets=nb),
        "substats": port_da.bucket_substats(t["codes"], t["mask"],
                                            *moments, n_buckets=nb),
        "range_counts": port_da.range_counts(t["rows"], t["mask"]),
        "row_wsum": port_da.row_wsum(t["rows"], t["mask"], t["cnt"]),
        "row_substats": port_da.row_substats(t["rows"], t["mask"],
                                             *moments),
        "vec_stats": port_da.vec_stats(t["mask"], *moments),
        "masked_dot": port_da.masked_dot(t["mask"], t["sm"]),
        "mask_count": port_da.mask_count(t["mask"]),
    }


def jax_reductions(x):
    import jax.numpy as jnp

    from searchlite_tpu.ops import device_aggs as jax_da

    j = {k: jnp.asarray(v) for k, v in x.items()
         if isinstance(v, np.ndarray)}
    nb = x["n_buckets"]
    moments = (j["cnt"], j["sm"], j["ss"], j["mn"], j["mx"], j["has"])
    return {
        "counts2d": jax_da.make_bucket_counts2d()(
            j["codes"], j["mask"], n_buckets=nb),
        "wsum2d": jax_da.make_bucket_wsum2d()(
            j["codes"], j["mask"], j["cnt"], n_buckets=nb),
        "substats": jax_da.make_bucket_substats()(
            j["codes"], j["mask"], *moments, n_buckets=nb),
        "range_counts": jax_da.make_range_counts()(j["rows"], j["mask"]),
        "row_wsum": jax_da.make_row_wsum()(j["rows"], j["mask"], j["cnt"]),
        "row_substats": jax_da.make_row_substats()(j["rows"], j["mask"],
                                                   *moments),
        "vec_stats": jax_da.make_vec_stats()(j["mask"], *moments),
        "masked_dot": jax_da.make_masked_dot()(j["mask"], j["sm"]),
        "mask_count": jax_da.make_mask_count()(j["mask"]),
    }


# per reduction: which outputs are exact (counts, min / max), which sums
EXACT = {"counts2d": [0], "wsum2d": [0], "substats": [0, 3, 4],
         "range_counts": [0], "row_wsum": [0], "row_substats": [0, 3, 4],
         "vec_stats": [0, 3, 4], "masked_dot": [], "mask_count": [0]}
REDUCTIONS = sorted(EXACT)


def as_tuple(v):
    if not isinstance(v, tuple):
        v = (v,)
    return [np.asarray(p.cpu() if isinstance(p, torch.Tensor) else p,
                       dtype=np.float64) for p in v]


def assert_reduction(name, got, ref, rtol=SUM_RTOL):
    got, ref = as_tuple(got), as_tuple(ref)
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape, (name, i)
        if i in EXACT[name]:
            assert np.array_equal(g, r), (name, i)
        else:
            assert np.allclose(g, r, rtol=rtol, atol=0), (name, i)


@pytest.mark.parametrize("name", REDUCTIONS)
@pytest.mark.parametrize("seed", [0, 1])
def test_reduction_matches_jax_and_numpy(name, seed):
    x = seeded_inputs(seed, n=4_000 + 700 * seed, v=2 + seed)
    got = port_reductions(x, "cpu")[name]
    assert_reduction(name, got, jax_reductions(x)[name])
    assert_reduction(name, got, numpy_reductions(x)[name], rtol=1e-12)


def test_reductions_on_an_empty_mask():
    x = seeded_inputs(3, n=500)
    x["mask"][:] = False
    got = port_reductions(x, "cpu")
    ref = jax_reductions(x)
    for name in REDUCTIONS:
        assert_reduction(name, got[name], ref[name])
    assert np.isposinf(as_tuple(got["vec_stats"])[3])
    assert np.isneginf(as_tuple(got["substats"])[4]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("name", REDUCTIONS)
def test_reductions_on_the_card(name):
    """On CUDA tensors against numpy, twice: counts and min / max equal,
    sums within rtol 1e-12 of numpy's f64 and of each other (the f64
    ``index_add_`` adds in no fixed order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = seeded_inputs(5, n=400_000, v=4, n_buckets=300, rows=8)
    ref = numpy_reductions(x)[name]
    first = port_reductions(x, "cuda")[name]
    second = port_reductions(x, "cuda")[name]
    assert_reduction(name, first, ref, rtol=RUN_TO_RUN_RTOL)
    assert_reduction(name, second, first, rtol=RUN_TO_RUN_RTOL)


# -- structures ------------------------------------------------------------

DAYS = ["2024-01-0%dT0%d:00:00Z" % (d, h)
        for d in range(1, 8) for h in range(0, 6)]


def build_index(n_docs=700, seed=91, delete_every=13):
    """The corpus of the JAX package's device-aggregation tests: single-
    and multi-valued keyword and numeric fast fields with gaps, a date
    keyword, two segments, tombstones."""
    from searchlite_tpu.api.types import IndexOptions, StorageType
    from searchlite_tpu.index import Index
    from searchlite_tpu.index.manifest import Schema

    rng = random.Random(seed)
    vocab = [f"w{i}" for i in range(50)]
    idx = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY),
        Schema.from_json({
            "text_fields": [{"name": "body", "analyzer": "default",
                             "stored": False, "indexed": True}],
            "keyword_fields": [
                {"name": "cat", "stored": False, "indexed": True,
                 "fast": True},
                {"name": "tags", "stored": False, "indexed": True,
                 "fast": True},
                {"name": "day", "stored": False, "indexed": False,
                 "fast": True}],
            "numeric_fields": [
                {"name": "price", "i64": False, "stored": False,
                 "fast": True},
                {"name": "qty", "i64": True, "stored": False,
                 "fast": True},
                {"name": "scores", "i64": True, "stored": False,
                 "fast": True}],
        }))
    writer = idx.writer()
    for i in range(n_docs):
        doc = {"_id": str(i),
               "body": " ".join(rng.choices(vocab, k=rng.randint(3, 15))),
               "cat": rng.choice(["a", "b", "c", "d"]),
               "tags": rng.sample(["x", "y", "z", "u"],
                                  k=rng.randint(1, 3))}
        if rng.random() < 0.9:
            doc["price"] = round(rng.uniform(0, 100), 2)
        if rng.random() < 0.8:
            doc["qty"] = rng.randint(0, 50)
        if rng.random() < 0.85:
            doc["day"] = rng.choice(DAYS)
        if rng.random() < 0.7:
            doc["scores"] = rng.sample(range(100), k=rng.randint(1, 4))
        writer.add_document(doc)
        if i == n_docs // 2:
            writer.commit()
    writer.commit()
    if delete_every:
        for i in range(5, n_docs, delete_every):
            writer.delete_document(str(i))
        writer.commit()
    return idx


# (kind, spec): every device kind, with missing / hard_bounds / offsets
STRUCT_SPECS = {
    "terms": ("terms", {"field": "cat"}),
    "terms_multi": ("terms", {"field": "tags"}),
    "terms_missing": ("terms", {"field": "cat", "missing": "none"}),
    "terms_numeric": ("terms", {"field": "qty", "missing": 7}),
    "terms_absent_field": ("terms", {"field": "nope", "missing": "m"}),
    "significant": ("significant_terms", {"field": "tags"}),
    "rare": ("rare_terms", {"field": "cat", "max_doc_count": 500}),
    "histogram": ("histogram", {"field": "price", "interval": 7.5}),
    "histogram_bounds": ("histogram", {
        "field": "qty", "interval": 10.0, "missing": 0, "offset": 3,
        "hard_bounds": {"min": 0, "max": 45}}),
    "histogram_multi": ("histogram", {"field": "scores", "interval": 20}),
    "date_calendar": ("date_histogram", {"field": "day",
                                         "calendar_interval": "day"}),
    "date_fixed": ("date_histogram", {
        "field": "day", "fixed_interval": "12h", "offset": "1h",
        "missing": "2024-01-03T00:00:00Z"}),
    "date_bounds": ("date_histogram", {
        "field": "day", "fixed_interval": "6h",
        "hard_bounds": {"min": "2024-01-02T00:00:00Z",
                        "max": "2024-01-05T00:00:00Z"}}),
    "range": ("range", {"field": "price", "ranges": [
        {"to": 25.0}, {"from": 20.0, "to": 60.0}, {"from": 60.0}]}),
    "range_missing": ("range", {"field": "qty", "missing": 12, "ranges": [
        {"to": 10}, {"from": 10}]}),
    "date_range": ("date_range", {"field": "qty", "ranges": [
        {"to": 20}, {"from": 20}]}),
    "filter": ("filter", {"filter": {"KeywordEq": {"field": "cat",
                                                   "value": "a"}}}),
    "stats": ("stats", {"field": "qty"}),
    "stats_multi_missing": ("extended_stats", {"field": "scores",
                                               "missing": 3}),
    "stats_inexact": ("stats", {"field": "price"}),
    "value_count": ("value_count", {"field": "scores"}),
    "value_count_missing": ("value_count", {"field": "tags",
                                            "missing": "?"}),
}


@pytest.fixture(scope="module")
def readers():
    from searchlite_tpu_torch.api.reader import IndexReader

    index = build_index()
    return index.reader(), IndexReader(index, device="cpu")


def assert_struct_equal(got, ref, where):
    assert (got is None) == (ref is None), where
    if ref is None:
        return
    assert set(got) == set(ref), where
    for key, want in ref.items():
        have = got[key]
        if isinstance(have, torch.Tensor):
            have = have.numpy()
            want = np.asarray(want)
            assert have.dtype == want.dtype and have.shape == want.shape, \
                (where, key)
            assert np.array_equal(have.view(np.uint8),
                                  want.view(np.uint8)), (where, key)
        else:
            assert have == want, (where, key)
            if isinstance(want, list):
                assert [type(v) for v in have] == [type(v) for v in want]


@pytest.mark.parametrize("name", sorted(STRUCT_SPECS))
def test_agg_bucket_structure_equals_jax(readers, name):
    from searchlite_tpu.ops import device_aggs as jax_da

    kind, spec = STRUCT_SPECS[name]
    spec = {"type": kind, **spec}
    jax_reader, port = readers
    some = False
    for jd, td in zip(jax_reader.device_segments, port.device_segments):
        ref = jax_da.agg_bucket_structure(jd, spec, kind)
        got = port_da.agg_bucket_structure(td, spec, kind)
        assert port_da.agg_bucket_structure(td, spec, kind) is got  # cached
        assert_struct_equal(got, ref, name)
        some = some or got is not None
        if kind == "significant_terms":
            assert port_da._sig_bg_structure(td, spec) == \
                jax_da._sig_bg_structure(jd, spec)
    assert some == (name != "stats_inexact")


def test_structures_sit_on_the_segment_and_are_evicted(readers):
    _jax_reader, port = readers
    dseg = port.device_segments[0]
    kind, spec = STRUCT_SPECS["terms"]
    first = port_da.agg_bucket_structure(dseg, {"type": kind, **spec}, kind)
    assert first["codes2d"].device == dseg.device
    dseg.evict_device_caches()
    assert dseg.agg_struct_cache == {}
    again = port_da.agg_bucket_structure(dseg, {"type": kind, **spec}, kind)
    assert again is not first
    assert torch.equal(again["codes2d"], first["codes2d"])


SUBS = {"q": {"type": "stats", "field": "qty"},
        "n": {"type": "value_count", "field": "scores"}}
ABLE_SPECS = {
    **{name: {"type": kind, **spec}
       for name, (kind, spec) in STRUCT_SPECS.items()},
    "terms_sub": {"type": "terms", "field": "cat", "aggs": SUBS},
    "terms_sub_count": {"type": "terms", "field": "cat",
                        "aggs": {"n": SUBS["n"]}},
    "range_sub": {"type": "range", "field": "qty",
                  "ranges": [{"to": 25}, {"from": 25}],
                  "aggs": {"q": SUBS["q"]}},
    "filter_sub": {"type": "filter",
                   "filter": {"KeywordEq": {"field": "cat", "value": "b"}},
                   "aggs": {"q": SUBS["q"]}},
    "sub_of_sub": {"type": "terms", "field": "cat", "aggs": {
        "t": {"type": "terms", "field": "tags"}}},
    "sub_inexact": {"type": "terms", "field": "cat", "aggs": {
        "p": {"type": "stats", "field": "price"}}},
    "sub_with_pipeline": {"type": "histogram", "field": "qty",
                          "interval": 10, "aggs": {
                              "q": SUBS["q"],
                              "d": {"type": "derivative",
                                    "buckets_path": "q.sum"}}},
    "stats_sub_under_stats": {"type": "stats", "field": "qty",
                              "aggs": {"n": SUBS["n"]}},
    "sampled": {"type": "terms", "field": "cat",
                "sampling": {"size": 50, "seed": 7}},
    "no_field": {"type": "terms"},
    "cardinality": {"type": "cardinality", "field": "cat"},
    "percentiles": {"type": "percentiles", "field": "qty"},
    "top_hits": {"type": "top_hits", "size": 1},
    "composite": {"type": "composite", "sources": [
        {"type": "terms", "name": "c", "field": "cat"}]},
    "bad_interval": {"type": "histogram", "field": "qty", "interval": 0},
    "bad_date": {"type": "date_histogram", "field": "day",
                 "fixed_interval": "nonsense"},
}


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("name", sorted(ABLE_SPECS))
def test_spec_device_able_equals_jax(readers, name, strict):
    from searchlite_tpu.ops import device_aggs as jax_da
    from searchlite_tpu.query.aggs import agg_kind

    spec = ABLE_SPECS[name]
    kind = agg_kind(spec)
    jax_reader, port = readers
    for jd, td in zip(jax_reader.device_segments, port.device_segments):
        want = jax_da.spec_device_able(jd, spec, kind, strict)
        assert port_da.spec_device_able(td, spec, kind, strict) == want
        plan = port_da.plan_device_aggs(td, {"x": spec}, strict)
        assert (plan is not None) == (
            jax_da.plan_device_aggs(jd, {"x": spec}, strict) is not None)


def test_vcap_gate(readers, monkeypatch):
    from searchlite_tpu.ops import device_aggs as jax_da

    jax_reader, port = readers
    spec = {"type": "terms", "field": "tags"}
    monkeypatch.setenv("SEARCHLITE_DEVICE_AGG_VCAP", "1")
    jd, td = jax_reader.device_segments[0], port.device_segments[0]
    saved = td.agg_struct_cache
    td.agg_struct_cache = {}
    jd._agg_structs = {}
    try:
        assert not port_da.spec_device_able(td, spec, "terms", False)
        assert not jax_da.spec_device_able(jd, spec, "terms", False)
    finally:
        td.agg_struct_cache = saved
        jd._agg_structs = {}
