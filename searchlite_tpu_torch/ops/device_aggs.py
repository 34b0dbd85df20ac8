"""Aggregation partials reduced on the device from the match mask: bucket
counts, metric partials and one level of sub-aggregation metrics, so an
aggregation request copies back a few KB of partials and not a doc-axis
bool mask per segment.

The port of ``searchlite_tpu/ops/device_aggs.py``. The split that keeps
results equal to the host collectors (``query/aggs.py``) rests on one
observation: everything in an aggregation spec except the match mask is
query-independent. Bucket membership (terms dictionary ids, histogram /
date-histogram keys, range / date-range / filter membership), ``missing``
substitution, ``hard_bounds`` clipping and per-doc metric moments (count,
sum, sum of squares, min, max of a field's values) are static per
(segment, spec): computed ONCE on the host in the f64 arithmetic the host
collectors use (the numpy half of this module is the JAX module's,
unchanged, with every gate), uploaded to the segment's device and cached
on the ``DeviceSegment`` (``agg_struct_cache``, dropped by
``evict_device_caches``). The per-QUERY work is a handful of masked
reductions:

- bucket doc counts  ``counts[c] = sum_d mask[d] * [c in codes(d)]``
- metric partials    ``sum = sum_d mask[d] * doc_sum[d]`` (and count,
  sum of squares), ``min = min_d mask[d] ? doc_min[d]`` (and max)
- sub-agg metrics    ``sum[c] = sum_d mask[d] * [c in codes(d)] * doc_sum[d]``

Covered kinds: ``terms`` / ``significant_terms`` / ``rare_terms`` /
``histogram`` / ``date_histogram`` (single- and multi-valued columns,
``missing``, ``hard_bounds``; each doc's distinct buckets, at most
``SEARCHLITE_DEVICE_AGG_VCAP`` of them, live in a padded [n1, V] code
table), ``range`` / ``date_range`` / ``filter`` (static membership rows),
``value_count``, ``stats`` / ``extended_stats``, plus ONE level of
``stats`` / ``extended_stats`` / ``value_count`` sub-aggregations under
any bucket kind. Everything else (``sampling``, composite, top_hits,
percentiles / cardinality, nested sub-aggs) stays with the host
collectors.

The reductions are plain functions on tensors, rewritten for a GPU (the
JAX module scans a one-hot contraction over 8,192-doc chunks because
scatter-adds collide on its device): counts are an integer
``index_add_`` over the code table (pad -1 goes to a spare slot),
per-bucket sums an f64 ``index_add_``, per-bucket min / max a
``scatter_reduce_`` (amin / amax), the [R, n1] row forms one masked
reduce or one f64 matrix-vector product.

Exactness contract. Every COUNT is exact (integer accumulators). Min /
max are exact (values are gated to the f32-exact range when the structure
is built). ``sum`` / ``sum_sq`` accumulate IN F64 ON THE DEVICE over the
f32 per-doc moments: they differ from the host collectors' f64-over-f64
sums by the f32 rounding of the per-doc moments (a D8-class divergence,
within rtol 1e-6 on the tested corpora), so ``f32_strict`` still routes
stats, top-level and sub-agg, to the host collector
(:func:`spec_device_able`). A float ``index_add_`` on CUDA adds in no
fixed order; in f64 two runs differ by f64 reassociation only (rtol
1e-12 is the tested run-to-run bound), far inside the contract, and no
global deterministic-algorithms switch is set.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from searchlite_tpu_torch.ops.precision import strict

DEVICE_AGG_KINDS = ("terms", "significant_terms", "rare_terms",
                    "histogram", "date_histogram", "range",
                    "date_range", "filter", "stats", "extended_stats",
                    "value_count")
DEVICE_SUB_KINDS = ("stats", "extended_stats", "value_count")
_CODES_KINDS = ("terms", "significant_terms", "rare_terms",
                "histogram", "date_histogram")
_ROWS_KINDS = ("range", "date_range", "filter")
MAX_BUCKETS_DEV = 65536
SUB_C_CAP = 4096  # bucket cap of sub-aggregations under a codes kind
_F32_EXACT = float(1 << 24)


def _v_cap() -> int:
    return int(os.environ.get("SEARCHLITE_DEVICE_AGG_VCAP", "8"))


# ---------------------------------------------------------------------------
# The reductions (torch, any device)
# ---------------------------------------------------------------------------


def _slots(codes2d, sel, n_buckets: int):
    """Flat int64 accumulator slots of a [n1, V] code table: a doc's
    codes where ``sel`` [n1] holds, the spare slot ``n_buckets`` for pad
    codes (-1) and unselected docs."""
    ok = sel[:, None] & (codes2d >= 0)
    return torch.where(ok, codes2d, n_buckets).long().reshape(-1)


def _per_code(vec, v: int):
    """A per-doc vector repeated once a code column, flat like
    :func:`_slots`."""
    return vec[:, None].expand(-1, v).reshape(-1)


def bucket_counts2d(codes2d, mask, *, n_buckets: int):
    """Exact doc counts over a [n1, V] distinct-codes table: a doc adds 1
    to each of its (at most V) distinct buckets. int32 [n_buckets]."""
    slots = _slots(codes2d, mask, n_buckets)
    acc = torch.zeros(n_buckets + 1, dtype=torch.int32, device=mask.device)
    acc.index_add_(0, slots, torch.ones_like(slots, dtype=torch.int32))
    return acc[:n_buckets]


def bucket_wsum2d(codes2d, mask, vec, *, n_buckets: int):
    """Per-bucket weighted sums ``out[c] = sum_d mask * vec[d] *
    [c in codes(d)]``: the sub-agg value_count / sum reduction. f64
    [n_buckets]."""
    slots = _slots(codes2d, mask, n_buckets)
    acc = torch.zeros(n_buckets + 1, dtype=torch.float64,
                      device=mask.device)
    acc.index_add_(0, slots, _per_code(vec.double(), codes2d.shape[1]))
    return acc[:n_buckets]


def bucket_substats(codes2d, mask, cnt, sm, ss, mn, mx, has, *,
                    n_buckets: int):
    """Per-bucket stats partials over per-doc moment vectors: (count, sum,
    sum_sq) f64 by ``index_add_``, (min, max) f32 by ``scatter_reduce_``
    over the docs that hold a value; empty buckets keep +inf / -inf."""
    v = codes2d.shape[1]
    dev = mask.device
    slots = _slots(codes2d, mask, n_buckets)
    sums = []
    for vec in (cnt, sm, ss):
        acc = torch.zeros(n_buckets + 1, dtype=torch.float64, device=dev)
        acc.index_add_(0, slots, _per_code(vec.double(), v))
        sums.append(acc[:n_buckets])
    slots_has = _slots(codes2d, mask & has, n_buckets)
    lo = torch.full((n_buckets + 1,), float("inf"), dtype=torch.float32,
                    device=dev)
    lo.scatter_reduce_(0, slots_has, _per_code(mn, v), "amin")
    hi = torch.full((n_buckets + 1,), float("-inf"), dtype=torch.float32,
                    device=dev)
    hi.scatter_reduce_(0, slots_has, _per_code(mx, v), "amax")
    return sums[0], sums[1], sums[2], lo[:n_buckets], hi[:n_buckets]


def range_counts(rows, mask):
    """``counts[r] = sum_d mask[d] * rows[r, d]``, exact. int32 [R]."""
    return (rows & mask[None, :]).sum(dim=1, dtype=torch.int32)


def row_wsum(rows, mask, vec):
    """Per-row weighted sums ``out[r] = sum_d rows[r, d] * mask * vec[d]``:
    the range / filter sub-agg value_count / sum reduction. f64 [R]."""
    return rows.double() @ (mask.double() * vec.double())


def row_substats(rows, mask, cnt, sm, ss, mn, mx, has):
    """Per-row stats partials (range / date_range / filter sub-aggs):
    three f64 matrix-vector products and masked min / max over the
    [R, n1] bool rows."""
    rf = rows.double()
    w = mask.double()
    c = rf @ (w * cnt.double())
    s1 = rf @ (w * sm.double())
    s2 = rf @ (w * ss.double())
    sel = rows & (mask & has)[None, :]
    lo = torch.where(sel, mn[None, :], float("inf")).amin(dim=1)
    hi = torch.where(sel, mx[None, :], float("-inf")).amax(dim=1)
    return c, s1, s2, lo, hi


def vec_stats(mask, cnt, sm, ss, mn, mx, has):
    """Top-level stats over per-doc moment vectors: count / sum / sum_sq
    masked f64 sums, masked min / max."""
    w = mask.double()
    ok = mask & has
    return ((w * cnt.double()).sum(), (w * sm.double()).sum(),
            (w * ss.double()).sum(),
            torch.where(ok, mn, float("inf")).amin(),
            torch.where(ok, mx, float("-inf")).amax())


def masked_dot(mask, vec):
    """``sum_d mask[d] * vec[d]`` in f64."""
    return (mask.double() * vec.double()).sum()


def mask_count(mask):
    """Exact matched-doc count: significant_terms' foreground total."""
    return mask.sum()

# ---------------------------------------------------------------------------
# Host-side static structures (cached per segment + spec params)
# ---------------------------------------------------------------------------

_BUILD_ERRS = (ValueError, TypeError, KeyError)


def _up(dseg, arr: np.ndarray) -> torch.Tensor:
    """A structure's array on the segment's device."""
    return torch.from_numpy(np.ascontiguousarray(arr)).to(dseg.device)


def _all_value_pairs(col, n_docs):
    """(values, owner_docs, lens) of EVERY doc's column values — the
    static analogue of the host collectors' matched-value gather."""
    lens = np.diff(col.offsets).astype(np.int64)
    owners = np.repeat(np.arange(n_docs, dtype=np.int64), lens)
    return col.values, owners, lens


def _doc_distinct_codes(owners, codes, n1: int, n_docs: int):
    """[n1, V] int32 (pad −1): each doc's DISTINCT bucket codes — the
    vectorized per-doc ``set()`` of the host collect loops. None when a
    doc spans more than SEARCHLITE_DEVICE_AGG_VCAP distinct buckets."""
    if len(owners) == 0:
        return np.full((n1, 1), -1, dtype=np.int32)
    order = np.lexsort((codes, owners))
    o = owners[order]
    c = codes[order]
    keep = np.ones(len(o), dtype=bool)
    keep[1:] = (o[1:] != o[:-1]) | (c[1:] != c[:-1])
    o = o[keep]
    c = c[keep]
    newdoc = np.ones(len(o), dtype=bool)
    newdoc[1:] = o[1:] != o[:-1]
    starts = np.flatnonzero(newdoc)
    lens = np.diff(np.append(starts, len(o)))
    v_max = int(lens.max())
    if v_max > _v_cap():
        return None
    pos = np.arange(len(o)) - np.repeat(starts, lens)
    out = np.full((n1, max(v_max, 1)), -1, dtype=np.int32)
    out[o, pos] = c
    return out


def _match_missing_key(keys: list, missing):
    """Index of an existing bucket key equal to the ``missing`` literal
    (Python ``==``/dict semantics: 2 == 2.0, str == str), else None."""
    for i, k in enumerate(keys):
        try:
            if k == missing:
                return i
        except Exception:  # noqa: BLE001 — mixed-type compares
            continue
    return None


def _terms_structure(dseg, spec):
    field = spec["field"]
    missing = spec.get("missing")
    col = dseg.reader.fast.column(field)
    n1, nd = dseg.n1, dseg.n_docs
    if col is None:
        if missing is None:
            return None
        codes2d = np.full((n1, 1), -1, dtype=np.int32)
        codes2d[:nd, 0] = 0
        return {"codes2d": _up(dseg, codes2d), "n_buckets": 1,
                "keys": [missing]}
    values, owners, lens = _all_value_pairs(col, nd)
    if col.kind == "str":
        if len(col.dictionary) > MAX_BUCKETS_DEV:
            return None
        keys = list(col.dictionary)
        codes = values.astype(np.int64)
    else:
        uniq = np.unique(values)
        if len(uniq) > MAX_BUCKETS_DEV:
            return None
        keys = uniq.tolist()
        codes = np.searchsorted(uniq, values).astype(np.int64)
    if missing is not None:
        mcode = _match_missing_key(keys, missing)
        if mcode is None:
            mcode = len(keys)
            keys = keys + [missing]
        miss_docs = np.flatnonzero(lens == 0)
        if len(miss_docs):
            owners = np.concatenate([owners, miss_docs])
            codes = np.concatenate(
                [codes, np.full(len(miss_docs), mcode, dtype=np.int64)])
    codes2d = _doc_distinct_codes(owners, codes, n1, nd)
    if codes2d is None:
        return None
    return {"codes2d": _up(dseg, codes2d),
            "n_buckets": max(len(keys), 1), "keys": keys}


def _histogram_structure(dseg, spec):
    field = spec["field"]
    interval = float(spec.get("interval", 0) or 0)
    if interval <= 0:
        return None  # host collector raises the proper QueryError
    offset = float(spec.get("offset") or 0.0)
    missing = spec.get("missing")
    hard = spec.get("hard_bounds")
    col = dseg.reader.fast.column(field)
    n1, nd = dseg.n1, dseg.n_docs
    numeric = col is not None and col.kind != "str"
    vals = np.zeros(0, dtype=np.float64)
    owners = np.zeros(0, dtype=np.int64)
    if numeric:
        raw, owners, lens = _all_value_pairs(col, nd)
        vals = raw.astype(np.float64)
    if missing is not None:
        mval = float(missing)  # TypeError/ValueError → host raises too
        if numeric:
            miss_docs = np.flatnonzero(lens == 0)
        else:
            miss_docs = np.arange(nd, dtype=np.int64)
        if len(miss_docs):
            vals = np.concatenate(
                [vals, np.full(len(miss_docs), mval)])
            owners = np.concatenate([owners, miss_docs])
    if hard is not None and len(vals):
        ok = (vals >= float(hard["min"])) & (vals <= float(hard["max"]))
        vals, owners = vals[ok], owners[ok]
    # EXACT host f64 keys — identical to query/aggs.py::_histogram_key
    keys = np.floor((vals - offset) / interval) * interval + offset
    uniq, inv = np.unique(keys, return_inverse=True)
    if len(uniq) > MAX_BUCKETS_DEV:
        return None
    codes2d = _doc_distinct_codes(owners, inv.astype(np.int64), n1, nd)
    if codes2d is None:
        return None
    return {"codes2d": _up(dseg, codes2d),
            "n_buckets": max(len(uniq), 1),
            "keys": [float(k) for k in uniq]}


def _date_histogram_structure(dseg, spec):
    from searchlite_tpu_torch.query import datetime_util as dtu
    from searchlite_tpu_torch.query.aggs import _MS_SENTINEL, _date_dict_millis
    from searchlite_tpu_torch.errors import QueryError

    field = spec["field"]
    calendar = spec.get("calendar_interval")
    fixed = spec.get("fixed_interval")
    if calendar is None and fixed is None:
        return None  # host raises
    col = dseg.reader.fast.column(field)
    n1, nd = dseg.n1, dseg.n_docs
    try:
        offset_ms = dtu.parse_duration_millis(spec["offset"]) \
            if spec.get("offset") else 0
        missing_ms = dtu.parse_datetime_millis(spec["missing"]) \
            if spec.get("missing") else None
        hard = spec.get("hard_bounds")
        hard_min = dtu.parse_datetime_millis(hard["min"]) if hard \
            else None
        hard_max = dtu.parse_datetime_millis(hard["max"]) if hard \
            else None
        width = dtu.parse_duration_millis(fixed) \
            if calendar is None else 0
    except (QueryError, *_BUILD_ERRS):
        return None  # host raises the proper error
    ms = np.zeros(0, dtype=np.int64)
    owners = np.zeros(0, dtype=np.int64)
    if col is not None:
        raw, owners, _lens = _all_value_pairs(col, nd)
        if col.kind == "str":
            ms = _date_dict_millis(col)[raw]
            ok = ms != _MS_SENTINEL
            if not ok.all():
                ms, owners = ms[ok], owners[ok]
        else:
            ms = np.asarray(raw, dtype=np.int64)
    if missing_ms is not None:
        # docs contributing no parseable values take the substitute
        miss = np.setdiff1d(np.arange(nd, dtype=np.int64),
                            np.unique(owners))
        if len(miss):
            ms = np.concatenate(
                [ms, np.full(len(miss), missing_ms, dtype=np.int64)])
            owners = np.concatenate([owners, miss])
    if hard_min is not None and len(ms):
        ok = (ms >= hard_min) & (ms <= hard_max)
        ms, owners = ms[ok], owners[ok]
    if calendar is not None:
        keys = dtu.calendar_bucket_vec(ms, calendar)
    else:
        keys = ((ms - offset_ms) // width) * width + offset_ms
    uniq, inv = np.unique(keys, return_inverse=True)
    if len(uniq) > MAX_BUCKETS_DEV:
        return None
    codes2d = _doc_distinct_codes(owners, inv.astype(np.int64), n1, nd)
    if codes2d is None:
        return None
    return {"codes2d": _up(dseg, codes2d),
            "n_buckets": max(len(uniq), 1),
            "keys": [int(k) for k in uniq]}


def _range_rows_structure(dseg, spec, kind: str):
    """Static membership rows for range/date_range: a doc belongs to a
    range when ANY of its values (or its `missing` substitute) falls in
    [from, to) — host-f64 comparisons, ranges may overlap."""
    from searchlite_tpu_torch.query import datetime_util as dtu
    from searchlite_tpu_torch.errors import QueryError

    field = spec["field"]
    ranges = spec.get("ranges", [])
    if not ranges:
        return None
    missing = spec.get("missing")
    try:
        if kind == "date_range":
            shadow = []
            for r in ranges:
                shadow.append({
                    "from": dtu.parse_datetime_millis(r["from"])
                    if r.get("from") is not None else None,
                    "to": dtu.parse_datetime_millis(r["to"])
                    if r.get("to") is not None else None})
            ranges = shadow
            if missing is not None:
                missing = dtu.parse_datetime_millis(missing)
        elif missing is not None:
            missing = float(missing)
    except (QueryError, *_BUILD_ERRS):
        return None  # host raises the proper error
    col = dseg.reader.fast.column(field)
    n1, nd = dseg.n1, dseg.n_docs
    numeric = col is not None and col.kind != "str"
    vals = np.zeros(0, dtype=np.float64)
    owners = np.zeros(0, dtype=np.int64)
    miss_docs = np.zeros(0, dtype=np.int64)
    if numeric:
        raw, owners, lens = _all_value_pairs(col, nd)
        vals = raw.astype(np.float64)
        if missing is not None:
            miss_docs = np.flatnonzero(lens == 0)
    elif missing is not None:
        miss_docs = np.arange(nd, dtype=np.int64)
    rows = np.zeros((len(ranges), n1), dtype=bool)
    for i, r in enumerate(ranges):
        lo = r.get("from")
        hi = r.get("to")
        m = np.ones(len(vals), dtype=bool)
        if lo is not None:
            m &= vals >= float(lo)
        if hi is not None:
            m &= vals < float(hi)
        if m.any():
            rows[i, owners[m]] = True
        if missing is not None and len(miss_docs):
            mv = float(missing)
            if (lo is None or mv >= float(lo)) \
                    and (hi is None or mv < float(hi)):
                rows[i, miss_docs] = True
    return {"range_rows": _up(dseg, rows), "n_buckets": len(ranges)}


def _filter_rows_structure(dseg, spec):
    from searchlite_tpu_torch.api.types import Filter
    from searchlite_tpu_torch.query.filters import compute_filter_mask

    filt = spec.get("filter")
    try:
        filt = Filter.from_json(filt) if not isinstance(filt, Filter) \
            else filt
        mask = compute_filter_mask(dseg.reader.fast, filt)
    except Exception:  # noqa: BLE001 — host raises the proper error
        return None
    row = np.zeros((1, dseg.n1), dtype=bool)
    row[0, :dseg.n_docs] = mask[:dseg.n_docs]
    return {"range_rows": _up(dseg, row), "n_buckets": 1}


def _valstats_structure(dseg, field, missing):
    """Per-doc moment vectors (count, sum, sum², min, max, has) of a
    NUMERIC field's values — the static payload of stats/extended_stats
    (which ignore str columns, parity with `_numeric_doc_values`).
    `missing` contributes one value per value-less doc."""
    cache = dseg.agg_struct_cache
    params = ("valstats", field, repr(missing))
    if params in cache:
        return cache[params]
    out = None
    col = dseg.reader.fast.column(field) if field is not None else None
    n1, nd = dseg.n1, dseg.n_docs
    numeric = col is not None and col.kind != "str"
    cnt = np.zeros(nd, dtype=np.float64)
    sm = np.zeros(nd, dtype=np.float64)
    ss = np.zeros(nd, dtype=np.float64)
    mn = np.zeros(nd, dtype=np.float64)
    mx = np.zeros(nd, dtype=np.float64)
    has = np.zeros(nd, dtype=bool)
    ok = True
    if numeric:
        lens = np.diff(col.offsets).astype(np.int64)
        vals = col.values.astype(np.float64)
        # f32-exact gate: min/max must ROUND-TRIP f32 exactly — large
        # i64 values (epoch millis) don't fit, and neither do most
        # decimal fractions (99.28 → 99.2799987…)
        if len(vals) and not bool(
                (vals.astype(np.float32).astype(np.float64)
                 == vals).all()):
            ok = False
        nz = lens > 0
        if ok and nz.any():
            starts = col.offsets[:-1][nz]
            cnt[nz] = lens[nz]
            sm[nz] = np.add.reduceat(vals, starts)
            ss[nz] = np.add.reduceat(vals * vals, starts)
            mn[nz] = np.minimum.reduceat(vals, starts)
            mx[nz] = np.maximum.reduceat(vals, starts)
            has[nz] = True
    if ok and missing is not None:
        try:
            mval = float(missing)
        except _BUILD_ERRS:
            mval = None
        if mval is None or float(np.float32(mval)) != mval:
            ok = False
        else:
            need = ~has
            cnt[need] = 1.0
            sm[need] = mval
            ss[need] = mval * mval
            mn[need] = mval
            mx[need] = mval
            has[need] = True
    if ok and float(cnt.sum()) >= _F32_EXACT:
        ok = False  # count exactness gate
    if ok:
        def vec(x, dtype=np.float32):
            full = np.zeros(n1, dtype=dtype)
            full[:nd] = x
            return _up(dseg, full)

        hfull = np.zeros(n1, dtype=bool)
        hfull[:nd] = has
        out = {"cnt": vec(cnt), "sm": vec(sm), "ss": vec(ss),
               "mn": vec(mn), "mx": vec(mx),
               "has": _up(dseg, hfull)}
    cache[params] = out
    return out


def _vcount_structure(dseg, field, missing):
    """Per-doc value counts for value_count: ALL raw values (any column
    kind, parity with the host collector's offsets arithmetic) plus 1
    per value-less doc when `missing` is set."""
    cache = dseg.agg_struct_cache
    params = ("vcount", field, repr(missing))
    if params in cache:
        return cache[params]
    out = None
    col = dseg.reader.fast.column(field) if field is not None else None
    n1, nd = dseg.n1, dseg.n_docs
    cnt = np.zeros(nd, dtype=np.float64)
    if col is not None:
        lens = np.diff(col.offsets).astype(np.int64)
        cnt[:] = lens
        if missing is not None:
            cnt[lens == 0] += 1.0
    elif missing is not None:
        cnt[:] = 1.0
    if float(cnt.sum()) < _F32_EXACT:  # count exactness gate
        full = np.zeros(n1, dtype=np.float32)
        full[:nd] = cnt
        out = {"cnt": _up(dseg, full)}
    cache[params] = out
    return out


def _sig_bg_structure(dseg, spec):
    """significant_terms background counts: docs passing
    ``background_filter`` (or all LIVE docs) counted once per distinct
    key — the host collector's per-doc loop vectorized. Deletion-
    DERIVED (live set): it caches on ``dseg._sig_bg_cache``, and a
    delete commit opens a new ``DeviceSegment`` (the segment cache keys
    on the tombstones), so the counts are always the live set's."""
    cache = getattr(dseg, "_sig_bg_cache", None)
    if cache is None:
        cache = dseg._sig_bg_cache = {}
    field = spec["field"]
    bg_filter = spec.get("background_filter")
    try:
        params = (field, json.dumps(bg_filter, sort_keys=True,
                                    default=str))
    except _BUILD_ERRS:
        return None
    if params in cache:
        return cache[params]
    from searchlite_tpu_torch.api.types import Filter
    from searchlite_tpu_torch.query.filters import compute_filter_mask

    nd = dseg.n_docs
    live = ~dseg.host.deleted_np[:nd]
    if bg_filter is not None:
        try:
            filt = Filter.from_json(bg_filter) if not isinstance(
                bg_filter, Filter) else bg_filter
            live = live & np.asarray(
                compute_filter_mask(dseg.reader.fast, filt)[:nd])
        except Exception:  # noqa: BLE001 — host raises the error
            cache[params] = None
            return None
    col = dseg.reader.fast.column(field)
    bg_counts: dict = {}
    if col is not None:
        values, owners, _lens = _all_value_pairs(col, nd)
        keep = live[owners]
        values, owners = values[keep], owners[keep]
        # per-doc distinct keys (the host loop's set()), then count
        order = np.lexsort((values, owners))
        v = values[order]
        o = owners[order]
        dedup = np.ones(len(v), dtype=bool)
        dedup[1:] = (o[1:] != o[:-1]) | (v[1:] != v[:-1])
        v = v[dedup]
        if col.kind == "str":
            counts = np.bincount(v, minlength=len(col.dictionary))
            for code in np.flatnonzero(counts):
                bg_counts[col.dictionary[code]] = int(counts[code])
        else:
            uniq, counts = np.unique(v, return_counts=True)
            for k, c in zip(uniq.tolist(), counts.tolist()):
                bg_counts[k] = int(c)
    out = {"bg_counts": bg_counts, "bg_total": int(live.sum())}
    cache[params] = out
    return out


def agg_bucket_structure(dseg, spec: dict, kind: str):
    """Device-resident static structure for (segment, spec): bucket
    codes / membership rows / per-doc moment vectors. Cached on the
    DeviceSegment by a spec-params key; None when the spec can't run
    device-side (the host collectors take over, including raising any
    spec errors)."""
    cache = dseg.agg_struct_cache
    field = spec.get("field")
    missing = repr(spec.get("missing"))
    if kind in ("terms", "significant_terms", "rare_terms"):
        # the bucket-code structure is identical for the three
        # terms-shaped kinds (significant_terms' background counts are
        # a separate deletion-derived cache, _sig_bg_structure)
        params = ("terms", field, missing)
    elif kind == "histogram":
        params = (kind, field, float(spec.get("interval", 0) or 0),
                  float(spec.get("offset") or 0.0), missing,
                  json.dumps(spec.get("hard_bounds"), sort_keys=True,
                             default=str))
    elif kind == "date_histogram":
        params = (kind, field, spec.get("calendar_interval"),
                  spec.get("fixed_interval"), spec.get("offset"),
                  missing,
                  json.dumps(spec.get("hard_bounds"), sort_keys=True,
                             default=str))
    elif kind in ("range", "date_range"):
        params = (kind, field,
                  json.dumps(spec.get("ranges", []), sort_keys=True,
                             default=str), missing)
    elif kind == "filter":
        try:
            params = (kind, json.dumps(spec.get("filter"),
                                       sort_keys=True, default=str))
        except _BUILD_ERRS:
            return None
    else:  # stats / extended_stats / value_count
        params = ("value", kind, field, missing)
    if params in cache:
        return cache[params]

    try:
        if kind in ("terms", "significant_terms", "rare_terms"):
            out = _terms_structure(dseg, spec)
        elif kind == "histogram":
            out = _histogram_structure(dseg, spec)
        elif kind == "date_histogram":
            out = _date_histogram_structure(dseg, spec)
        elif kind in ("range", "date_range"):
            out = _range_rows_structure(dseg, spec, kind)
        elif kind == "filter":
            out = _filter_rows_structure(dseg, spec)
        elif kind == "value_count":
            out = _vcount_structure(dseg, field, spec.get("missing"))
        else:  # stats / extended_stats
            out = _valstats_structure(dseg, field, spec.get("missing"))
    except _BUILD_ERRS:
        out = None  # malformed spec → host collector raises
    cache[params] = out
    return out


# ---------------------------------------------------------------------------
# Plan gating
# ---------------------------------------------------------------------------

def _sub_plan(dseg, spec: dict, kind: str, strict: bool):
    """Validate + resolve this bucket spec's sub-aggregations. Returns
    a list of (sub_name, sub_kind, struct) — empty when no sub-aggs —
    or None when any sub-agg can't run device-side."""
    from searchlite_tpu_torch.query.aggs import PIPELINE_AGGS, agg_kind

    sub_specs = spec.get("aggs") or {}
    out = []
    for sub_name, sub_spec in sub_specs.items():
        skind = agg_kind(sub_spec)
        if skind in PIPELINE_AGGS:
            continue  # applied at finalize, host-side
        if skind not in DEVICE_SUB_KINDS:
            return None
        if sub_spec.get("aggs") or sub_spec.get("sampling") is not None:
            return None
        if skind in ("stats", "extended_stats"):
            if strict:
                return None  # device sums are f32
            struct = _valstats_structure(
                dseg, sub_spec.get("field"), sub_spec.get("missing"))
        else:
            struct = _vcount_structure(
                dseg, sub_spec.get("field"), sub_spec.get("missing"))
        if struct is None:
            return None
        out.append((sub_name, skind, struct))
    return out


def spec_device_able(dseg, spec: dict, kind: str, strict: bool) -> bool:
    """Can this aggregation spec reduce device-side on this segment?"""
    if kind not in DEVICE_AGG_KINDS:
        return False
    if spec.get("sampling") is not None:
        return False
    if kind in ("stats", "extended_stats") and strict:
        return False  # device sum is f32; strict keeps host f64
    if kind != "filter" and spec.get("field") is None:
        return False
    struct = agg_bucket_structure(dseg, spec, kind)
    if struct is None:
        return False
    if kind == "significant_terms" \
            and _sig_bg_structure(dseg, spec) is None:
        return False
    if spec.get("aggs"):
        if kind not in _CODES_KINDS and kind not in _ROWS_KINDS:
            return False
        if kind in _CODES_KINDS and struct["n_buckets"] > SUB_C_CAP:
            return False  # the JAX package's gate: both route alike
        if _sub_plan(dseg, spec, kind, strict) is None:
            return False
    return True

def plan_device_aggs(dseg, aggs: dict, strict: bool):
    """Return a launch plan when EVERY non-pipeline aggregation of the
    request can reduce device-side on this segment, else None."""
    from searchlite_tpu_torch.query.aggs import PIPELINE_AGGS, agg_kind

    plan = []
    for name, spec in (aggs or {}).items():
        kind = agg_kind(spec)
        if kind in PIPELINE_AGGS:
            continue
        if not spec_device_able(dseg, spec, kind, strict):
            return None
        plan.append((name, spec, kind))
    return plan


# ---------------------------------------------------------------------------
# Launch + intermediate reconstruction
# ---------------------------------------------------------------------------

def _launch_subs(dseg, spec, kind, struct, mask, refs):
    """Enqueue this bucket spec's sub-agg reductions; returns sub-agg
    metadata [(sub_name, sub_kind, n_refs)]."""
    subs = _sub_plan(dseg, spec, kind, strict=False)
    sub_meta = []
    for sub_name, skind, vstruct in subs:
        if skind == "value_count":
            if kind in _CODES_KINDS:
                out = bucket_wsum2d(struct["codes2d"], mask, vstruct["cnt"],
                                    n_buckets=struct["n_buckets"])
            else:
                out = row_wsum(struct["range_rows"], mask, vstruct["cnt"])
            refs.append(out)
            sub_meta.append((sub_name, skind, 1))
        else:  # stats / extended_stats
            args = (mask, vstruct["cnt"], vstruct["sm"], vstruct["ss"],
                    vstruct["mn"], vstruct["mx"], vstruct["has"])
            if kind in _CODES_KINDS:
                out = bucket_substats(struct["codes2d"], *args,
                                      n_buckets=struct["n_buckets"])
            else:
                out = row_substats(struct["range_rows"], *args)
            refs.extend(out)
            sub_meta.append((sub_name, skind, len(out)))
    return sub_meta


def launch_device_aggs(dseg, plan, mask):
    """Enqueue the plan's reductions against a match mask on the
    segment's device ([n1] bool, sentinel False). Returns (meta, refs):
    the flat tensors to fetch and per-agg reconstruction metadata."""
    refs = []
    meta = []
    for name, spec, kind in plan:
        struct = agg_bucket_structure(dseg, spec, kind)
        if kind in _CODES_KINDS:
            refs.append(bucket_counts2d(struct["codes2d"], mask,
                                        n_buckets=struct["n_buckets"]))
            n_refs = 1
            if kind == "significant_terms":
                # foreground total = matched docs (host: len(matched))
                refs.append(mask_count(mask))
                n_refs = 2
            sub_meta = _launch_subs(dseg, spec, kind, struct, mask, refs)
            extra = _sig_bg_structure(dseg, spec) \
                if kind == "significant_terms" else None
            meta.append((name, kind, spec, struct, n_refs, sub_meta, extra))
        elif kind in _ROWS_KINDS:
            refs.append(range_counts(struct["range_rows"], mask))
            sub_meta = _launch_subs(dseg, spec, kind, struct, mask, refs)
            meta.append((name, kind, spec, struct, 1, sub_meta, None))
        elif kind == "value_count":
            refs.append(masked_dot(mask, struct["cnt"]))
            meta.append((name, kind, spec, struct, 1, [], None))
        else:  # stats / extended_stats
            out = vec_stats(mask, struct["cnt"], struct["sm"], struct["ss"],
                            struct["mn"], struct["mx"], struct["has"])
            refs.extend(out)
            meta.append((name, kind, spec, struct, len(out), [], None))
    return meta, refs


def _stats_inter(count, total, total_sq, vmin, vmax):
    import math

    from searchlite_tpu_torch.query.aggs import Intermediate

    if count == 0:
        return Intermediate("stats", {
            "count": 0, "sum": 0.0, "sum_sq": 0.0,
            "min": math.inf, "max": -math.inf})
    return Intermediate("stats", {
        "count": int(round(count)), "sum": float(total),
        "sum_sq": float(total_sq), "min": float(vmin),
        "max": float(vmax)})


def _sub_inters(sub_meta, sub_vals: dict, bucket_idx: int):
    """Per-bucket sub-agg Intermediates from the fetched per-bucket
    partial arrays."""
    from searchlite_tpu_torch.query.aggs import Intermediate

    out = {}
    for sub_name, skind, _n in sub_meta:
        vals = sub_vals[sub_name]
        if skind == "value_count":
            out[sub_name] = Intermediate(
                "value_count",
                {"value": int(round(float(vals[0][bucket_idx])))})
        else:
            c, s1, s2, lo, hi = (float(v[bucket_idx]) for v in vals)
            out[sub_name] = _stats_inter(round(c), s1, s2, lo, hi)
    return out


def build_intermediates(meta, fetched) -> dict:
    """Reconstruct query/aggs.py Intermediates from fetched partials —
    the exact shapes the host collectors produce, so merge/finalize
    and cross-segment merges are oblivious to where collection ran."""
    from searchlite_tpu_torch.query.aggs import (
        BucketIntermediate,
        Intermediate,
    )

    it = iter(fetched)
    out = {}
    for name, kind, spec, struct, n_refs, sub_meta, extra in meta:
        vals = [np.asarray(next(it)) for _ in range(n_refs)]
        sub_vals = {}
        for sub_name, _skind, n in sub_meta:
            sub_vals[sub_name] = [np.asarray(next(it))
                                  for _ in range(n)]
        if kind in _CODES_KINDS:
            counts = vals[0]
            buckets = {}
            for code in np.flatnonzero(counts):
                b = BucketIntermediate(doc_count=int(counts[code]))
                if sub_meta:
                    b.sub = _sub_inters(sub_meta, sub_vals, int(code))
                buckets[struct["keys"][code]] = b
            payload = {"buckets": buckets}
            if kind == "date_histogram":
                payload["format"] = spec.get("format")
            elif kind == "significant_terms":
                payload["bg_counts"] = dict(extra["bg_counts"])
                payload["bg_total"] = extra["bg_total"]
                payload["doc_count"] = int(round(float(vals[1])))
            out[name] = Intermediate(kind, payload)
        elif kind == "filter":
            sub = _sub_inters(sub_meta, sub_vals, 0) if sub_meta else {}
            out[name] = Intermediate(
                "filter", {"doc_count": int(vals[0][0]), "sub": sub})
        elif kind in ("range", "date_range"):
            counts = vals[0]
            buckets = []
            for i, c in enumerate(counts):
                b = BucketIntermediate(doc_count=int(c))
                if sub_meta:
                    b.sub = _sub_inters(sub_meta, sub_vals, i)
                buckets.append(b)
            out[name] = Intermediate(kind, {"buckets": buckets})
        elif kind == "value_count":
            out[name] = Intermediate(
                "value_count", {"value": int(round(float(vals[0])))})
        else:  # stats / extended_stats
            count, total, total_sq, vmin, vmax = (float(v)
                                                  for v in vals)
            out[name] = _stats_inter(round(count), total, total_sq,
                                     vmin, vmax)
    return out
