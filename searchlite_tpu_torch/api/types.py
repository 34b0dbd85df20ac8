"""Request/response type system.

Wire-format parity with searchlite-core `api/types.rs`:

- ``SearchRequest`` JSON with query (string or typed node), filter,
  limit, sort, cursor, execution strategy, fuzzy, vector_query,
  highlight, collapse, aggs, suggest, rescore, explain, profile.
- ``QueryNode``: internally-tagged ``{"type": "...", ...}`` with 15
  variants.
- ``Filter``: externally tagged (``{"KeywordEq": {...}}``, ``{"And":
  [...]}``), 8 variants.
- Aggregations: internally tagged, 22 variants (parsed into plain
  dataclasses; execution lives in query/aggs.py).

Python surfaces accept plain dicts and convert via ``from_json``.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Any, Optional, Union

from searchlite_tpu_torch.errors import QueryError


class StorageType:
    FILESYSTEM = "Filesystem"
    IN_MEMORY = "InMemory"


@dataclass
class VectorDefaults:
    dim: int
    metric: str = "cosine"


@dataclass
class IndexOptions:
    path: str
    create_if_missing: bool = False
    enable_positions: bool = True
    bm25_k1: float = 0.9
    bm25_b: float = 0.4
    storage: str = StorageType.FILESYSTEM
    # False | True (zstd, the reference codec) | "zstd" | "zlib"
    compress_docstore: Any = False
    vector_defaults: Optional[VectorDefaults] = None
    # tiered auto-merge: after a commit, once MORE than this many
    # segments sit at or under auto_merge_docs, structurally fold them
    # into one (Index.merge_segments — no stored fields needed,
    # tombstones expunged). 0 = off. Env overrides:
    # SEARCHLITE_AUTO_MERGE / SEARCHLITE_AUTO_MERGE_DOCS.
    auto_merge_segments: int = 0
    auto_merge_docs: Optional[int] = None
    # fold on a background thread instead of inside commit() — commit
    # latency never pays the merge (SEARCHLITE_AUTO_MERGE_ASYNC=1)
    auto_merge_async: bool = False


# ---------------------------------------------------------------------------
# Query AST
# ---------------------------------------------------------------------------

@dataclass
class FieldSpec:
    field: str
    boost: Optional[float] = None

    @staticmethod
    def parse_list(raw) -> list["FieldSpec"]:
        out = []
        for item in raw:
            if isinstance(item, str):
                out.append(FieldSpec(item))
            elif isinstance(item, dict):
                out.append(FieldSpec(item["field"], item.get("boost")))
            else:
                raise QueryError("invalid field spec")
        return out


@dataclass
class QueryNode:
    """One node of the typed query AST. ``kind`` matches the reference's
    snake_case type tag; ``params`` holds the variant payload."""

    kind: str
    params: dict[str, Any]

    VALID_KINDS = frozenset((
        "match_all", "query_string", "multi_match", "dis_max", "term",
        "prefix", "wildcard", "regex", "phrase", "bool", "constant_score",
        "function_score", "rank_feature", "script_score", "vector",
    ))

    @classmethod
    def from_json(cls, obj: dict) -> "QueryNode":
        if not isinstance(obj, dict):
            raise QueryError("query node must be an object")
        kind = obj.get("type")
        if kind not in cls.VALID_KINDS:
            raise QueryError(f"unknown query node type `{kind}`")
        params = {k: v for k, v in obj.items() if k != "type"}
        # recursively parse child nodes
        if kind == "dis_max":
            params["queries"] = [cls.from_json(q)
                                 for q in params.get("queries", [])]
        elif kind == "bool":
            for key in ("must", "should", "must_not"):
                params[key] = [cls.from_json(q) for q in params.get(key, [])]
            params["filter"] = [Filter.from_json(f)
                                for f in params.get("filter", [])]
        elif kind in ("function_score", "script_score"):
            params["query"] = cls.from_json(params["query"])
            if kind == "function_score":
                params["functions"] = [
                    FunctionSpec.from_json(f)
                    for f in params.get("functions", [])]
        elif kind == "constant_score":
            params["filter"] = Filter.from_json(params["filter"])
        if kind in ("query_string", "multi_match") and "fields" in params \
                and params["fields"] is not None:
            params["fields"] = FieldSpec.parse_list(params["fields"])
        return cls(kind, params)

    def get(self, key: str, default=None):
        return self.params.get(key, default)


@dataclass
class FunctionSpec:
    kind: str  # "weight" | "field_value_factor" | "decay"
    params: dict[str, Any]

    @classmethod
    def from_json(cls, obj: dict) -> "FunctionSpec":
        kind = obj.get("type")
        if kind not in ("weight", "field_value_factor", "decay"):
            raise QueryError(f"unknown function spec type `{kind}`")
        params = {k: v for k, v in obj.items() if k != "type"}
        if params.get("filter") is not None:
            params["filter"] = Filter.from_json(params["filter"])
        return cls(kind, params)


@dataclass
class Filter:
    """Filter AST node. ``kind`` is the reference's variant name."""

    kind: str  # KeywordEq | KeywordIn | I64Range | F64Range | Nested | And | Or | Not
    params: Any

    VALID = frozenset((
        "KeywordEq", "KeywordIn", "I64Range", "F64Range", "Nested",
        "And", "Or", "Not",
    ))

    @classmethod
    def from_json(cls, obj) -> "Filter":
        if isinstance(obj, Filter):
            return obj
        if not isinstance(obj, dict) or len(obj) != 1:
            raise QueryError(
                "filter must be a single-variant object like "
                '{"KeywordEq": {...}}')
        kind, payload = next(iter(obj.items()))
        if kind not in cls.VALID:
            raise QueryError(f"unknown filter variant `{kind}`")
        if kind in ("And", "Or"):
            return cls(kind, [cls.from_json(f) for f in payload])
        if kind == "Not":
            return cls(kind, cls.from_json(payload))
        if kind == "Nested":
            return cls(kind, {"path": payload["path"],
                              "filter": cls.from_json(payload["filter"])})
        return cls(kind, dict(payload))

    def to_json(self):
        if self.kind in ("And", "Or"):
            return {self.kind: [f.to_json() for f in self.params]}
        if self.kind == "Not":
            return {self.kind: self.params.to_json()}
        if self.kind == "Nested":
            return {self.kind: {"path": self.params["path"],
                                "filter": self.params["filter"].to_json()}}
        return {self.kind: self.params}


# ---------------------------------------------------------------------------
# Request options
# ---------------------------------------------------------------------------

@dataclass
class FuzzyOptions:
    max_edits: int = 1
    prefix_length: int = 1
    max_expansions: int = 50
    min_length: int = 3

    @classmethod
    def from_json(cls, obj: dict) -> "FuzzyOptions":
        return cls(
            max_edits=int(obj.get("max_edits", 1)),
            prefix_length=int(obj.get("prefix_length", 1)),
            max_expansions=int(obj.get("max_expansions", 50)),
            min_length=int(obj.get("min_length", 3)),
        )


@dataclass
class SortSpec:
    field: str
    order: Optional[str] = None  # "asc" | "desc"

    @classmethod
    def from_json(cls, obj) -> "SortSpec":
        if isinstance(obj, str):
            return cls(obj)
        return cls(obj["field"], obj.get("order"))


@dataclass
class HighlightField:
    pre_tag: str = "<em>"
    post_tag: str = "</em>"
    fragment_size: int = 160
    number_of_fragments: int = 1

    @classmethod
    def from_json(cls, obj: dict) -> "HighlightField":
        return cls(
            pre_tag=obj.get("pre_tag", "<em>"),
            post_tag=obj.get("post_tag", "</em>"),
            fragment_size=int(obj.get("fragment_size", 160)),
            number_of_fragments=int(obj.get("number_of_fragments", 1)),
        )


@dataclass
class HighlightRequest:
    fields: dict[str, HighlightField] = dc_field(default_factory=dict)

    @classmethod
    def from_json(cls, obj: dict) -> "HighlightRequest":
        return cls(fields={
            name: HighlightField.from_json(f or {})
            for name, f in obj.get("fields", {}).items()
        })


@dataclass
class InnerHitsRequest:
    size: Optional[int] = None
    from_: int = 0
    sort: list[SortSpec] = dc_field(default_factory=list)


@dataclass
class CollapseRequest:
    field: str
    inner_hits: Optional[InnerHitsRequest] = None

    @classmethod
    def from_json(cls, obj: dict) -> "CollapseRequest":
        ih = obj.get("inner_hits")
        inner = None
        if ih is not None:
            inner = InnerHitsRequest(
                size=ih.get("size"),
                from_=int(ih.get("from", 0)),
                sort=[SortSpec.from_json(s) for s in ih.get("sort", [])],
            )
        return cls(field=obj["field"], inner_hits=inner)


@dataclass
class RescoreRequest:
    window_size: int
    query: QueryNode
    score_mode: str = "total"  # total|multiply|sum|max|min

    @classmethod
    def from_json(cls, obj: dict) -> "RescoreRequest":
        mode = obj.get("score_mode", "total")
        if mode not in ("total", "multiply", "sum", "max", "min"):
            raise QueryError(f"unknown rescore mode `{mode}`")
        return cls(
            window_size=int(obj["window_size"]),
            query=QueryNode.from_json(obj["query"]),
            score_mode=mode,
        )


@dataclass
class SuggestRequest:
    field: str
    prefix: str
    size: int = 5
    fuzzy: Optional[FuzzyOptions] = None

    @classmethod
    def from_json(cls, obj: dict) -> "SuggestRequest":
        if obj.get("type") != "completion":
            raise QueryError("suggest request must have type `completion`")
        return cls(
            field=obj["field"],
            prefix=obj["prefix"],
            size=int(obj.get("size", 5)),
            fuzzy=FuzzyOptions.from_json(obj["fuzzy"])
            if obj.get("fuzzy") is not None else None,
        )


@dataclass
class VectorQuery:
    field: str
    vector: list[float]
    k: Optional[int] = None
    alpha: Optional[float] = None
    ef_search: Optional[int] = None
    candidate_size: Optional[int] = None
    boost: Optional[float] = None

    @classmethod
    def from_json(cls, obj) -> "VectorQuery":
        if isinstance(obj, list):
            # legacy tuple form [field, vector, alpha]
            if len(obj) != 3:
                raise QueryError("legacy vector query must be [field, vector, alpha]")
            return cls(field=obj[0], vector=list(obj[1]), alpha=float(obj[2]))
        return cls(
            field=obj["field"],
            vector=[float(v) for v in obj["vector"]],
            k=obj.get("k"),
            alpha=obj.get("alpha"),
            ef_search=obj.get("ef_search"),
            candidate_size=obj.get("candidate_size"),
            boost=obj.get("boost"),
        )


# ---------------------------------------------------------------------------
# SearchRequest
# ---------------------------------------------------------------------------

@dataclass
class SearchRequest:
    query: Union[str, QueryNode]
    limit: int = 10
    fields: Optional[list[str]] = None
    filter: Optional[Filter] = None
    return_hits: bool = True
    candidate_size: Optional[int] = None
    sort: list[SortSpec] = dc_field(default_factory=list)
    cursor: Optional[str] = None
    execution: str = "wand"  # bm25 | wand | bmw
    bmw_block_size: Optional[int] = None
    fuzzy: Optional[FuzzyOptions] = None
    vector_query: Optional[VectorQuery] = None
    vector_filter: Optional[Filter] = None
    return_stored: bool = False
    highlight_field: Optional[str] = None
    highlight: Optional[HighlightRequest] = None
    collapse: Optional[CollapseRequest] = None
    aggs: dict[str, Any] = dc_field(default_factory=dict)
    suggest: dict[str, SuggestRequest] = dc_field(default_factory=dict)
    rescore: Optional[RescoreRequest] = None
    explain: bool = False
    profile: bool = False

    @classmethod
    def from_json(cls, obj: dict) -> "SearchRequest":
        if "query" not in obj:
            raise QueryError("search request requires `query`")
        raw_query = obj["query"]
        if isinstance(raw_query, str):
            query: Union[str, QueryNode] = raw_query
        elif isinstance(raw_query, dict):
            query = QueryNode.from_json(raw_query)
        elif isinstance(raw_query, QueryNode):
            query = raw_query
        else:
            raise QueryError("query must be a string or query node")
        execution = obj.get("execution", "wand")
        if execution not in ("bm25", "wand", "bmw"):
            raise QueryError(f"unknown execution strategy `{execution}`")
        if "limit" not in obj:
            raise QueryError("search request requires `limit`")
        vq = obj.get("vector_query")
        return cls(
            query=query,
            limit=int(obj["limit"]),
            fields=obj.get("fields"),
            filter=Filter.from_json(obj["filter"])
            if obj.get("filter") is not None else None,
            return_hits=bool(obj.get("return_hits", True)),
            candidate_size=obj.get("candidate_size"),
            sort=[SortSpec.from_json(s) for s in obj.get("sort", [])],
            cursor=obj.get("cursor"),
            execution=execution,
            bmw_block_size=obj.get("bmw_block_size"),
            fuzzy=FuzzyOptions.from_json(obj["fuzzy"])
            if obj.get("fuzzy") is not None else None,
            vector_query=VectorQuery.from_json(vq) if vq is not None else None,
            vector_filter=Filter.from_json(obj["vector_filter"])
            if obj.get("vector_filter") is not None else None,
            return_stored=bool(obj.get("return_stored", False)),
            highlight_field=obj.get("highlight_field"),
            highlight=HighlightRequest.from_json(obj["highlight"])
            if obj.get("highlight") is not None else None,
            collapse=CollapseRequest.from_json(obj["collapse"])
            if obj.get("collapse") is not None else None,
            aggs=dict(obj.get("aggs", {})),
            suggest={name: SuggestRequest.from_json(s)
                     for name, s in obj.get("suggest", {}).items()},
            rescore=RescoreRequest.from_json(obj["rescore"])
            if obj.get("rescore") is not None else None,
            explain=bool(obj.get("explain", False)),
            profile=bool(obj.get("profile", False)),
        )


# ---------------------------------------------------------------------------
# Responses (plain dataclasses; to_json produces the wire shape)
# ---------------------------------------------------------------------------

@dataclass
class Hit:
    doc_id: str
    score: float
    vector_score: Optional[float] = None
    fields: Optional[dict] = None
    snippet: Optional[str] = None
    explanation: Optional[dict] = None
    highlights: Optional[dict[str, list[str]]] = None
    inner_hits: Optional[list] = None
    # engine-internal: the hit's full sort key (reader.SortKey), used by
    # search_scroll to mint exact per-page cursors; never serialized
    sort_key: Optional[Any] = None

    def to_json(self) -> dict:
        out: dict[str, Any] = {
            "doc_id": self.doc_id,
            "score": self.score,
            "fields": self.fields,
            "snippet": self.snippet,
        }
        if self.vector_score is not None:
            out["vector_score"] = self.vector_score
        if self.explanation is not None:
            out["explanation"] = self.explanation
        if self.highlights is not None:
            out["highlights"] = self.highlights
        if self.inner_hits is not None:
            out["inner_hits"] = [h.to_json() for h in self.inner_hits]
        return out


@dataclass
class SearchResult:
    total_hits_estimate: int
    total_groups: Optional[int] = None
    hits: list[Hit] = dc_field(default_factory=list)
    next_cursor: Optional[str] = None
    aggregations: dict[str, Any] = dc_field(default_factory=dict)
    suggest: dict[str, Any] = dc_field(default_factory=dict)
    profile: Optional[dict] = None

    def to_json(self) -> dict:
        out: dict[str, Any] = {
            "total_hits_estimate": self.total_hits_estimate,
            "hits": [h.to_json() for h in self.hits],
        }
        if self.total_groups is not None:
            out["total_groups"] = self.total_groups
        if self.next_cursor is not None:
            out["next_cursor"] = self.next_cursor
        if self.aggregations:
            out["aggregations"] = self.aggregations
        if self.suggest:
            out["suggest"] = self.suggest
        if self.profile is not None:
            out["profile"] = self.profile
        return out
