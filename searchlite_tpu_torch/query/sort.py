"""Sort plans and totally-ordered sort keys.

Parity with searchlite-core `query/sort.rs`: ``_score`` or fast
keyword/numeric fields; multi-valued fields pick min for asc / max for
desc; missing values sort last regardless of order; keys are totally
ordered with (segment_ord, doc_id) tiebreak so cursors are stable.
The plan hash (crc32 of the resolved spec) is embedded in cursors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

from searchlite_tpu_torch.errors import QueryError
from searchlite_tpu_torch.index.manifest import Schema
from searchlite_tpu_torch.utils.checksum import crc32

SCORE_FIELD = "_score"


@dataclass(frozen=True)
class ResolvedSortField:
    field: str        # field name or "_score"
    kind: str         # "score" | "str" | "i64" | "f64"
    order: str        # "asc" | "desc"


class SortKey:
    """Totally ordered sort key. Comparison respects per-part order and
    missing-last semantics; ties break by (segment_ord, doc_id) asc."""

    __slots__ = ("parts", "orders", "segment_ord", "doc_id")

    def __init__(self, parts: list[Any], orders: list[str],
                 segment_ord: int, doc_id: int):
        self.parts = parts       # values or None for missing
        self.orders = orders
        self.segment_ord = segment_ord
        self.doc_id = doc_id

    def _cmp(self, other: "SortKey") -> int:
        for (a, b, order) in zip(self.parts, other.parts, self.orders):
            if a is None and b is None:
                continue
            if a is None:
                return 1   # missing last
            if b is None:
                return -1
            if a != b:
                less = a < b
                if order == "desc":
                    less = not less
                return -1 if less else 1
        if self.segment_ord != other.segment_ord:
            return -1 if self.segment_ord < other.segment_ord else 1
        if self.doc_id != other.doc_id:
            return -1 if self.doc_id < other.doc_id else 1
        return 0

    def __lt__(self, other):
        return self._cmp(other) < 0

    def __le__(self, other):
        return self._cmp(other) <= 0

    def __eq__(self, other):
        return isinstance(other, SortKey) and self._cmp(other) == 0

    def __hash__(self):
        return hash((tuple(self.parts), self.segment_ord, self.doc_id))

    def to_json(self) -> dict:
        return {
            "parts": [
                None if p is None else
                {"t": "s", "v": p} if isinstance(p, str) else
                {"t": "f", "v": float(p)} if isinstance(p, float) else
                {"t": "i", "v": int(p)}
                for p in self.parts
            ],
            "segment_ord": self.segment_ord,
            "doc_id": self.doc_id,
        }

    @classmethod
    def from_json(cls, obj: dict, orders: list[str]) -> "SortKey":
        parts = []
        for p in obj["parts"]:
            if p is None:
                parts.append(None)
            elif p["t"] == "s":
                parts.append(str(p["v"]))
            elif p["t"] == "f":
                parts.append(float(p["v"]))
            else:
                parts.append(int(p["v"]))
        return cls(parts, orders, int(obj["segment_ord"]), int(obj["doc_id"]))


class SortPlan:
    def __init__(self, fields: list[ResolvedSortField]):
        self.fields = fields
        payload = ";".join(
            f"{f.field}:{f.kind}:{f.order}" for f in fields).encode()
        self.hash = crc32(payload)

    @classmethod
    def from_request(cls, schema: Schema, specs: list) -> "SortPlan":
        if not specs:
            resolved_specs = [(SCORE_FIELD, None)]
        else:
            resolved_specs = [(s.field, s.order) for s in specs]
        fields: list[ResolvedSortField] = []
        for field, order in resolved_specs:
            if order is None:
                order = "desc" if field == SCORE_FIELD else "asc"
            if field == SCORE_FIELD:
                fields.append(ResolvedSortField(SCORE_FIELD, "score", order))
                continue
            meta = schema.field_meta(field)
            if meta is None:
                raise QueryError(f"unknown sort field `{field}`")
            if meta.kind == "keyword":
                if not meta.fast:
                    raise QueryError(
                        f"sort field `{field}` must be marked as fast")
                fields.append(ResolvedSortField(field, "str", order))
            elif meta.kind == "numeric":
                if not meta.fast:
                    raise QueryError(
                        f"sort field `{field}` must be marked as fast")
                kind = "i64" if meta.numeric_i64 else "f64"
                fields.append(ResolvedSortField(field, kind, order))
            else:
                raise QueryError(
                    f"sort field `{field}` must be a fast keyword or "
                    "numeric field")
        return cls(fields)

    @property
    def orders(self) -> list[str]:
        return [f.order for f in self.fields]

    def is_score_only(self) -> bool:
        return len(self.fields) == 1 and self.fields[0].kind == "score"

    def uses_score(self) -> bool:
        return any(f.kind == "score" for f in self.fields)

    def primary_order(self) -> Optional[str]:
        return self.fields[0].order if self.fields else None

    def build_keys_bulk(self, fast_fields, docs, scores, segment_ord: int
                        ) -> list[SortKey]:
        """Vectorized ``build_key`` over an array of doc ordinals.

        ``docs``: sorted int array; ``scores``: float array aligned with
        docs (ignored for field-only plans). Multi-valued fields pick
        min for asc / max for desc; missing values become None.
        """
        import numpy as _np

        n = len(docs)
        per_field: list[list] = []
        for f in self.fields:
            if f.kind == "score":
                per_field.append([float(s) for s in scores])
                continue
            col = fast_fields.column(f.field)
            out: list = [None] * n
            if col is not None and len(col.values):
                lo = col.offsets[docs]
                hi = col.offsets[_np.asarray(docs) + 1]
                lens = (hi - lo).astype(_np.int64)
                has = lens > 0
                if has.any():
                    lens_h = lens[has]
                    starts = lo[has]
                    cum = _np.cumsum(lens_h)
                    total = int(cum[-1])
                    pos = (_np.arange(total)
                           - _np.repeat(cum - lens_h, lens_h)
                           + _np.repeat(starts, lens_h))
                    bounds = _np.concatenate([[0], cum[:-1]])
                    if col.kind == "str":
                        rank, sorted_vals = col.dict_ranks()
                        vals = rank[col.values[pos]]
                    else:
                        vals = col.values[pos]
                    if f.order == "asc":
                        red = _np.minimum.reduceat(vals, bounds)
                    else:
                        red = _np.maximum.reduceat(vals, bounds)
                    idxs = _np.flatnonzero(has)
                    if col.kind == "str":
                        for i, v in zip(idxs, red):
                            out[i] = sorted_vals[int(v)]
                    elif f.kind == "i64":
                        for i, v in zip(idxs, red):
                            out[i] = int(v)
                    else:
                        for i, v in zip(idxs, red):
                            out[i] = float(v)
            per_field.append(out)
        orders = self.orders
        return [
            SortKey([per_field[j][i] for j in range(len(self.fields))],
                    orders, segment_ord, int(docs[i]))
            for i in range(n)
        ]

    def rank_arrays(self, fast_fields, docs, scores):
        """Vectorized comparable ranks for the matched-doc array: one
        float64 array per sort field where smaller sorts earlier
        (order folded in via negation; missing always ranks +inf =
        last). Used with np.lexsort for top-k selection without
        materializing SortKey objects."""
        import numpy as _np

        n = len(docs)
        out: list[_np.ndarray] = []
        for f in self.fields:
            if f.kind == "score":
                vals = _np.asarray(scores, dtype=_np.float64)
                rank = -vals if f.order == "desc" else vals.copy()
                out.append(rank)
                continue
            rank = _np.full(n, _np.inf, dtype=_np.float64)
            col = fast_fields.column(f.field)
            if col is not None and len(col.values) and n:
                lo = col.offsets[docs]
                hi = col.offsets[_np.asarray(docs) + 1]
                lens = (hi - lo).astype(_np.int64)
                has = lens > 0
                if has.any():
                    lens_h = lens[has]
                    starts = lo[has]
                    cum = _np.cumsum(lens_h)
                    pos = (_np.arange(int(cum[-1]))
                           - _np.repeat(cum - lens_h, lens_h)
                           + _np.repeat(starts, lens_h))
                    bounds = _np.concatenate([[0], cum[:-1]])
                    if col.kind == "str":
                        dict_rank, _sorted_vals = col.dict_ranks()
                        vals = dict_rank[col.values[pos]].astype(
                            _np.float64)
                    else:
                        vals = col.values[pos].astype(_np.float64)
                    if f.order == "asc":
                        red = _np.minimum.reduceat(vals, bounds)
                    else:
                        red = -_np.maximum.reduceat(vals, bounds)
                    rank[has] = red
            out.append(rank)
        return out

    def cursor_ranks(self, cursor_key: "SortKey", fast_fields):
        """The cursor key's rank tuple under the same encoding."""
        import numpy as _np

        ranks = []
        for f, part in zip(self.fields, cursor_key.parts):
            if part is None:
                ranks.append(_np.inf)
            elif f.kind == "score":
                ranks.append(-float(part) if f.order == "desc"
                             else float(part))
            elif f.kind == "str":
                col = fast_fields.column(f.field)
                if col is None:
                    ranks.append(_np.inf)
                else:
                    _rank, sorted_vals = col.dict_ranks()
                    import bisect

                    # rank of the string within this segment's dictionary
                    # order; absent values get a half-rank so comparisons
                    # remain consistent
                    i = bisect.bisect_left(sorted_vals, part)
                    if i < len(sorted_vals) and sorted_vals[i] == part:
                        r = float(i)
                    else:
                        r = i - 0.5
                    ranks.append(-r if f.order == "desc" else r)
            else:
                v = float(part)
                ranks.append(-v if f.order == "desc" else v)
        return ranks

    def build_key(self, fast_fields, doc: int, score: float,
                  segment_ord: int) -> SortKey:
        parts: list[Any] = []
        for f in self.fields:
            if f.kind == "score":
                parts.append(float(score))
            elif f.kind == "str":
                values = fast_fields.str_values(f.field, doc)
                if not values:
                    parts.append(None)
                else:
                    parts.append(min(values) if f.order == "asc"
                                 else max(values))
            else:
                if f.kind == "i64":
                    values = fast_fields.i64_values(f.field, doc)
                else:
                    values = fast_fields.f64_values(f.field, doc)
                if not values:
                    parts.append(None)
                else:
                    v = min(values) if f.order == "asc" else max(values)
                    parts.append(int(v) if f.kind == "i64" else float(v))
        return SortKey(parts, self.orders, segment_ord, doc)
