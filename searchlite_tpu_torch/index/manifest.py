"""Manifest + Schema: the committed snapshot of an index.

Behavioral parity with searchlite-core `index/manifest.rs`:

- ``MANIFEST.json`` holds version, uuid, segment metas (id, generation,
  paths, doc_count, blockmax flag, deleted-doc tombstones, per-field avg
  lengths, per-file crc32 checksums), committed_at, and the schema.
- Atomic store via ``Storage.atomic_write``.
- Schema: doc_id_field (default ``_id``), named analyzers, text /
  keyword / numeric / nested / vector fields. Nested fields flatten to
  dotted paths. ``tokenizer`` is accepted as an alias of ``analyzer``.
- search_as_you_type text fields get an auto-generated edge-ngram index
  analyzer named ``{base}__saty_{field}``.
"""

from __future__ import annotations

import json
import uuid as uuid_mod
from dataclasses import dataclass, field as dc_field
from datetime import datetime, timezone
from typing import Any, Optional

from searchlite_tpu_torch.analysis.analyzer import Analyzer, AnalyzerRegistry, analyzer_from_def
from searchlite_tpu_torch.errors import SchemaError, StorageError
from searchlite_tpu_torch.storage import Storage

MANIFEST_PATH = "MANIFEST.json"


# ---------------------------------------------------------------------------
# Field definitions
# ---------------------------------------------------------------------------

@dataclass
class TextField:
    name: str
    analyzer: str = "default"
    search_analyzer: Optional[str] = None
    stored: bool = True
    indexed: bool = True
    nullable: bool = False
    search_as_you_type: Optional[dict] = None  # {"min_gram": n, "max_gram": m}

    @classmethod
    def from_json(cls, obj: dict) -> "TextField":
        analyzer = obj.get("analyzer")
        tokenizer = obj.get("tokenizer")
        if analyzer is not None and tokenizer is not None:
            raise SchemaError(
                "text field cannot set both `tokenizer` and `analyzer`")
        primary = analyzer or tokenizer
        saty = obj.get("search_as_you_type")
        if primary is None:
            if saty is not None:
                primary = "default"
            else:
                raise SchemaError(
                    "text field must set `analyzer` (or `tokenizer` as an alias)")
        search_analyzer = obj.get("search_analyzer")
        search_tokenizer = obj.get("search_tokenizer")
        if search_analyzer is not None and search_tokenizer is not None:
            raise SchemaError(
                "text field cannot set both `search_analyzer` and `search_tokenizer`")
        if saty is not None:
            saty = dict(saty)
            saty.setdefault("min_gram", 1)
            saty.setdefault("max_gram", 15)
            if saty["min_gram"] <= 0 or saty["max_gram"] <= 0:
                raise SchemaError(
                    "invalid search_as_you_type configuration: min_gram and "
                    "max_gram must both be greater than zero")
            if saty["min_gram"] > saty["max_gram"]:
                raise SchemaError(
                    "invalid search_as_you_type configuration: min_gram must "
                    "be less than or equal to max_gram")
        return cls(
            name=obj["name"],
            analyzer=primary,
            search_analyzer=search_analyzer or search_tokenizer,
            stored=bool(obj.get("stored", True)),
            indexed=bool(obj.get("indexed", True)),
            nullable=bool(obj.get("nullable", False)),
            search_as_you_type=saty,
        )

    def to_json(self) -> dict:
        out: dict[str, Any] = {
            "name": self.name,
            # serialized under `tokenizer` for manifest compatibility with
            # the reference (`index/manifest.rs` TextFieldSerde)
            "tokenizer": self.analyzer,
            "stored": self.stored,
            "indexed": self.indexed,
            "nullable": self.nullable,
        }
        if self.search_analyzer is not None:
            out["search_analyzer"] = self.search_analyzer
        if self.search_as_you_type is not None:
            out["search_as_you_type"] = self.search_as_you_type
        return out


@dataclass
class KeywordField:
    name: str
    stored: bool = True
    indexed: bool = True
    fast: bool = False
    nullable: bool = False

    @classmethod
    def from_json(cls, obj: dict) -> "KeywordField":
        return cls(
            name=obj["name"],
            stored=bool(obj.get("stored", True)),
            indexed=bool(obj.get("indexed", True)),
            fast=bool(obj.get("fast", False)),
            nullable=bool(obj.get("nullable", False)),
        )

    def to_json(self) -> dict:
        return {
            "name": self.name, "stored": self.stored, "indexed": self.indexed,
            "fast": self.fast, "nullable": self.nullable,
        }


@dataclass
class NumericField:
    name: str
    i64: bool = True
    fast: bool = True
    stored: bool = False
    nullable: bool = False

    @classmethod
    def from_json(cls, obj: dict) -> "NumericField":
        return cls(
            name=obj["name"],
            i64=bool(obj.get("i64", True)),
            fast=bool(obj.get("fast", True)),
            stored=bool(obj.get("stored", False)),
            nullable=bool(obj.get("nullable", False)),
        )

    def to_json(self) -> dict:
        return {
            "name": self.name, "i64": self.i64, "fast": self.fast,
            "stored": self.stored, "nullable": self.nullable,
        }


@dataclass
class VectorField:
    name: str
    dim: int
    metric: str = "cosine"  # "cosine" | "l2"
    # device-side quantization (None | "bf16" | "int8") — realizes the
    # reference's quantization stub (`vectors/quant.rs:1-3`) as an
    # opt-in: vectors are stored f32 on disk and quantized at upload
    # (bf16: half the HBM + 2x MXU; int8: quarter HBM, int8 MXU matmul
    # with per-vector f32 scales). Scores become approximate.
    quantization: Optional[str] = None

    @classmethod
    def from_json(cls, obj: dict) -> "VectorField":
        metric = obj.get("metric", "Cosine")
        if isinstance(metric, str):
            metric = metric.lower()
        if metric not in ("cosine", "l2"):
            raise SchemaError(f"unknown vector metric `{metric}`")
        quant = obj.get("quantization")
        if isinstance(quant, str):
            quant = quant.lower()
            if quant in ("none", ""):
                quant = None
        if quant not in (None, "bf16", "int8"):
            raise SchemaError(
                f"unknown vector quantization `{quant}` "
                "(expected bf16 or int8)")
        return cls(name=obj["name"], dim=int(obj["dim"]), metric=metric,
                   quantization=quant)

    def to_json(self) -> dict:
        out = {
            "name": self.name, "dim": self.dim,
            "metric": "Cosine" if self.metric == "cosine" else "L2",
        }
        if self.quantization is not None:
            out["quantization"] = self.quantization
        return out


@dataclass
class NestedField:
    name: str
    fields: list = dc_field(default_factory=list)  # list[NestedProperty]
    nullable: bool = False

    @classmethod
    def from_json(cls, obj: dict) -> "NestedField":
        return cls(
            name=obj["name"],
            fields=[NestedProperty.from_json(f) for f in obj.get("fields", [])],
            nullable=bool(obj.get("nullable", False)),
        )

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "fields": [f.to_json() for f in self.fields],
            "nullable": self.nullable,
        }

    def validate(self, value: Any) -> None:
        if value is None:
            if self.nullable:
                return
            raise SchemaError(f"nested field {self.name} cannot be null")
        if isinstance(value, list):
            for v in value:
                self.validate(v)
            return
        if isinstance(value, dict):
            for k, v in value.items():
                prop = next((p for p in self.fields if p.name == k), None)
                if prop is None:
                    raise SchemaError(f"unknown nested field {k}")
                prop.validate_value(k, v)
            for prop in self.fields:
                if prop.name in value or prop.is_nullable():
                    continue
                raise SchemaError(
                    f"missing required nested field {self.name}.{prop.name}")
            return
        raise SchemaError(f"nested field {self.name} must be object or array")

    def collect_fields(self, prefix: Optional[str], out: list) -> None:
        full = f"{prefix}.{self.name}" if prefix else self.name
        for prop in self.fields:
            prop.collect_fields(full, out)


@dataclass
class NestedProperty:
    kind: str  # "text" | "keyword" | "numeric" | "object"
    inner: Any  # the matching field dataclass

    @property
    def name(self) -> str:
        return self.inner.name

    def is_nullable(self) -> bool:
        return self.inner.nullable

    @classmethod
    def from_json(cls, obj: dict) -> "NestedProperty":
        kind = obj.get("type")
        rest = {k: v for k, v in obj.items() if k != "type"}
        if kind == "text":
            return cls("text", TextField.from_json(rest))
        if kind == "keyword":
            return cls("keyword", KeywordField.from_json(rest))
        if kind == "numeric":
            return cls("numeric", NumericField.from_json(rest))
        if kind == "object":
            return cls("object", NestedField.from_json(rest))
        raise SchemaError(f"unknown nested property type `{kind}`")

    def to_json(self) -> dict:
        out = {"type": self.kind}
        out.update(self.inner.to_json())
        return out

    def validate_value(self, key: str, v: Any) -> None:
        if self.kind in ("text", "keyword"):
            if v is None:
                if self.inner.nullable:
                    return
                raise SchemaError(f"nested field {key} cannot be null")
            if not isinstance(v, (str, list)):
                raise SchemaError(f"nested field {key} must be string or array")
            return
        if self.kind == "numeric":
            if v is None:
                if self.inner.nullable:
                    return
                raise SchemaError(f"nested field {key} cannot be null")
            if not isinstance(v, (int, float, list)) or isinstance(v, bool):
                raise SchemaError(f"nested field {key} must be number or array")
            return
        if self.kind == "object":
            if v is None:
                if self.inner.nullable:
                    return
                raise SchemaError(f"nested field {key} cannot be null")
            self.inner.validate(v)

    def collect_fields(self, prefix: str, out: list) -> None:
        path = f"{prefix}.{self.name}"
        if self.kind == "text":
            f = self.inner
            out.append(ResolvedField(path, "text", f.indexed, f.stored, False,
                                     None, f.nullable))
        elif self.kind == "keyword":
            f = self.inner
            out.append(ResolvedField(path, "keyword", f.indexed, f.stored,
                                     f.fast, None, f.nullable))
        elif self.kind == "numeric":
            f = self.inner
            out.append(ResolvedField(path, "numeric", True, f.stored, f.fast,
                                     f.i64, f.nullable))
        else:
            self.inner.collect_fields(prefix, out)


@dataclass
class ResolvedField:
    path: str
    kind: str  # "text" | "keyword" | "numeric" | "unknown"
    indexed: bool
    stored: bool
    fast: bool
    numeric_i64: Optional[bool]
    nullable: bool


# ---------------------------------------------------------------------------
# Schema
# ---------------------------------------------------------------------------

@dataclass
class SchemaAnalyzers:
    registry: AnalyzerRegistry
    field_map: dict[str, tuple[str, str]]  # path -> (index_name, search_name)

    def index_analyzer(self, field: str) -> Optional[Analyzer]:
        refs = self.field_map.get(field)
        return self.registry.get(refs[0]) if refs else None

    def search_analyzer(self, field: str) -> Optional[Analyzer]:
        refs = self.field_map.get(field)
        return self.registry.get(refs[1]) if refs else None


@dataclass
class Schema:
    doc_id_field: str = "_id"
    analyzers: list[dict] = dc_field(default_factory=list)
    text_fields: list[TextField] = dc_field(default_factory=list)
    keyword_fields: list[KeywordField] = dc_field(default_factory=list)
    numeric_fields: list[NumericField] = dc_field(default_factory=list)
    nested_fields: list[NestedField] = dc_field(default_factory=list)
    vector_fields: list[VectorField] = dc_field(default_factory=list)

    @classmethod
    def default_text_body(cls) -> "Schema":
        return cls(text_fields=[TextField(name="body")])

    @classmethod
    def from_json(cls, obj: dict) -> "Schema":
        return cls(
            doc_id_field=obj.get("doc_id_field", "_id"),
            analyzers=list(obj.get("analyzers", [])),
            text_fields=[TextField.from_json(f)
                         for f in obj.get("text_fields", [])],
            keyword_fields=[KeywordField.from_json(f)
                            for f in obj.get("keyword_fields", [])],
            numeric_fields=[NumericField.from_json(f)
                            for f in obj.get("numeric_fields", [])],
            nested_fields=[NestedField.from_json(f)
                           for f in obj.get("nested_fields", [])],
            vector_fields=[VectorField.from_json(f)
                           for f in obj.get("vector_fields", [])],
        )

    def to_json(self) -> dict:
        out: dict[str, Any] = {
            "doc_id_field": self.doc_id_field,
            "text_fields": [f.to_json() for f in self.text_fields],
            "keyword_fields": [f.to_json() for f in self.keyword_fields],
            "numeric_fields": [f.to_json() for f in self.numeric_fields],
            "nested_fields": [f.to_json() for f in self.nested_fields],
            "vector_fields": [f.to_json() for f in self.vector_fields],
        }
        if self.analyzers:
            out["analyzers"] = self.analyzers
        return out

    # -- field resolution ---------------------------------------------------
    # Schemas are immutable after creation, so the resolved list and the
    # path->field map are cached (hot on the ingest validation path).

    def resolved_fields(self) -> list[ResolvedField]:
        cached = self.__dict__.get("_resolved_cache")
        if cached is not None:
            return cached
        fields = self._resolve_fields()
        self.__dict__["_resolved_cache"] = fields
        self.__dict__["_resolved_map"] = {f.path: f for f in fields}
        return fields

    def _resolve_fields(self) -> list[ResolvedField]:
        fields: list[ResolvedField] = []
        for f in self.text_fields:
            fields.append(ResolvedField(f.name, "text", f.indexed, f.stored,
                                        False, None, f.nullable))
        for f in self.keyword_fields:
            fields.append(ResolvedField(f.name, "keyword", f.indexed, f.stored,
                                        f.fast, None, f.nullable))
        for f in self.numeric_fields:
            fields.append(ResolvedField(f.name, "numeric", True, f.stored,
                                        f.fast, f.i64, f.nullable))
        for nested in self.nested_fields:
            nested.collect_fields(None, fields)
        return fields

    def field_meta(self, field: str) -> Optional[ResolvedField]:
        self.resolved_fields()
        return self.__dict__["_resolved_map"].get(field)

    def nested_map(self) -> dict:
        """name -> NestedField, cached (hot on ingest validation)."""
        cached = self.__dict__.get("_nested_map")
        if cached is None:
            cached = {n.name: n for n in self.nested_fields}
            self.__dict__["_nested_map"] = cached
        return cached

    def vector_names(self) -> frozenset:
        """Vector field names, cached (hot on ingest collection)."""
        cached = self.__dict__.get("_vector_names")
        if cached is None:
            cached = frozenset(vf.name for vf in self.vector_fields)
            self.__dict__["_vector_names"] = cached
        return cached

    def field_kind(self, field: str) -> str:
        meta = self.field_meta(field)
        return meta.kind if meta else "unknown"

    def is_indexed_field(self, field: str) -> bool:
        meta = self.field_meta(field)
        return bool(meta and meta.indexed)

    def is_stored_field(self, field: str) -> bool:
        meta = self.field_meta(field)
        return bool(meta and meta.stored)

    def fast_fields(self) -> list[str]:
        return [f.path for f in self.resolved_fields() if f.fast]

    def vector_field(self, field: str) -> Optional[VectorField]:
        for f in self.vector_fields:
            if f.name == field:
                return f
        return None

    def text_field_map(self) -> list[tuple[str, TextField]]:
        out: list[tuple[str, TextField]] = [
            (f.name, f) for f in self.text_fields]

        def collect(nested: NestedField, prefix: Optional[str]):
            full = f"{prefix}.{nested.name}" if prefix else nested.name
            for prop in nested.fields:
                if prop.kind == "text":
                    out.append((f"{full}.{prop.inner.name}", prop.inner))
                elif prop.kind == "object":
                    collect(prop.inner, full)

        for nested in self.nested_fields:
            collect(nested, None)
        return out

    # -- validation ---------------------------------------------------------

    def validate_config(self) -> None:
        if "." in self.doc_id_field:
            raise SchemaError(
                f"doc_id_field `{self.doc_id_field}` cannot be nested")
        self.build_analyzers()
        if any(f.path == self.doc_id_field for f in self.resolved_fields()):
            raise SchemaError(
                f"doc_id_field `{self.doc_id_field}` must not overlap with "
                "other schema fields")
        for vf in self.vector_fields:
            if vf.dim <= 0:
                raise SchemaError(f"vector field `{vf.name}` must have dim > 0")
            if any(f.path == vf.name for f in self.resolved_fields()):
                raise SchemaError(
                    f"vector field `{vf.name}` conflicts with another field")

    def build_analyzers(self) -> SchemaAnalyzers:
        """Wire per-field index/search analyzers, generating edge-ngram
        index analyzers for search_as_you_type fields
        (parity: `index/manifest.rs:174-245`)."""
        defs = [dict(d) for d in self.analyzers]

        def find_def(name: str) -> Optional[dict]:
            if name == "default":
                return {"name": "default", "tokenizer": "default", "filters": []}
            return next((d for d in defs if d.get("name") == name), None)

        field_refs: list[tuple[str, str, str]] = []
        for path, f in self.text_field_map():
            base = f.analyzer
            search_name = f.search_analyzer or base
            if f.search_as_you_type is not None:
                generated = f"{base}__saty_{path.replace('.', '_')}"
                if all(d.get("name") != generated for d in defs):
                    base_def = find_def(base)
                    if base_def is None:
                        raise SchemaError(
                            f"field `{path}` references unknown analyzer `{base}`")
                    filters = list(base_def.get("filters", []))
                    filters.append({
                        "type": "edge_ngram",
                        "edge_ngram": {
                            "min": f.search_as_you_type["min_gram"],
                            "max": f.search_as_you_type["max_gram"],
                        },
                    })
                    defs.append({
                        "name": generated,
                        "tokenizer": base_def.get("tokenizer", "default"),
                        "filters": filters,
                    })
                index_name = generated
            else:
                index_name = base
            field_refs.append((path, index_name, search_name))

        registry = AnalyzerRegistry.from_defs(defs)
        field_map: dict[str, tuple[str, str]] = {}
        for path, index_name, search_name in field_refs:
            if registry.get(index_name) is None:
                raise SchemaError(
                    f"field `{path}` references unknown analyzer `{index_name}`")
            if registry.get(search_name) is None:
                raise SchemaError(
                    f"field `{path}` references unknown search analyzer "
                    f"`{search_name}`")
            if path in field_map:
                raise SchemaError(f"duplicate field `{path}` in analyzer map")
            field_map[path] = (index_name, search_name)
        return SchemaAnalyzers(registry, field_map)

    def validate_documents(self, docs: list) -> None:
        """Bulk validation with columnar fast checks (the per-doc loop
        costs ~2 µs/doc of dict traversal — measurable at bulk ingest).
        Columns whose every value passes a STRICT subset of the
        per-doc accept set are cleared wholesale; anything else —
        nested/vector schemas, non-dict docs, subclasses, unusual
        values — falls back to the per-doc loop, which raises the
        exact same first error it always did."""
        if (self.nested_fields or self.vector_fields
                or not isinstance(docs, list)
                or any(type(d) is not dict for d in docs)):
            for d in docs:
                self.validate_document(d)
            return
        _MISSING = object()
        ids = [d.get(self.doc_id_field) for d in docs]
        if not all(type(x) is str and x.strip() for x in ids):
            for d in docs:
                self.validate_document(d)
            return
        for meta in self.resolved_fields():
            if meta.path == self.doc_id_field:
                continue
            col = [d.get(meta.path, _MISSING) for d in docs]
            if meta.kind in ("text", "keyword"):
                def ok(x):
                    return (type(x) is str
                            or (type(x) is list
                                and all(type(v) is str for v in x)))
            elif meta.kind == "numeric":
                if meta.numeric_i64:
                    def ok(x):
                        return (type(x) is int
                                or (type(x) is list
                                    and all(type(v) is int
                                            for v in x)))
                else:
                    def ok(x):
                        return (type(x) in (int, float)
                                or (type(x) is list
                                    and all(type(v) in (int, float)
                                            for v in x)))
            else:  # pragma: no cover — unknown kind: be conservative
                def ok(x):
                    return False
            nullable = meta.nullable
            if not all(x is _MISSING or (x is None and nullable)
                       or ok(x) for x in col):
                for d in docs:
                    self.validate_document(d)
                return

    def validate_document(self, doc: dict) -> None:
        doc_id = doc.get(self.doc_id_field)
        if not (isinstance(doc_id, str) and doc_id.strip()):
            raise SchemaError(
                f"missing or empty required document id field "
                f"`{self.doc_id_field}`")
        for name, value in doc.items():
            nested = self.nested_map().get(name)
            if nested is not None:
                nested.validate(value)
                continue
            meta = self.field_meta(name)
            if meta is not None:
                _validate_field_value(meta, value)


def _validate_field_value(meta: ResolvedField, value: Any) -> None:
    if value is None:
        if meta.nullable:
            return
        raise SchemaError(f"field `{meta.path}` cannot be null")
    if meta.kind in ("text", "keyword"):
        ok = isinstance(value, str) or (
            isinstance(value, list) and all(isinstance(v, str) for v in value))
        if not ok:
            raise SchemaError(
                f"field `{meta.path}` must be a string or array of strings")
    elif meta.kind == "numeric":
        def is_num(v):
            if isinstance(v, bool):
                return False
            if meta.numeric_i64:
                return isinstance(v, int)
            return isinstance(v, (int, float))

        ok = is_num(value) or (
            isinstance(value, list) and all(is_num(v) for v in value))
        if not ok:
            raise SchemaError(
                f"field `{meta.path}` must be a number or array of numbers")


# ---------------------------------------------------------------------------
# Segment metadata + manifest
# ---------------------------------------------------------------------------

@dataclass
class SegmentMeta:
    id: str
    generation: int
    doc_count: int
    max_doc_id: int
    blockmax: bool = True
    deleted_docs: list[int] = dc_field(default_factory=list)
    avg_field_lengths: dict[str, float] = dc_field(default_factory=dict)
    checksums: dict[str, int] = dc_field(default_factory=dict)
    has_vectors: bool = False

    @classmethod
    def from_json(cls, obj: dict) -> "SegmentMeta":
        return cls(
            id=obj["id"],
            generation=int(obj["generation"]),
            doc_count=int(obj["doc_count"]),
            max_doc_id=int(obj.get("max_doc_id", 0)),
            blockmax=bool(obj.get("blockmax", True)),
            deleted_docs=list(obj.get("deleted_docs", [])),
            avg_field_lengths=dict(obj.get("avg_field_lengths", {})),
            checksums=dict(obj.get("checksums", {})),
            has_vectors=bool(obj.get("has_vectors", False)),
        )

    def to_json(self) -> dict:
        return {
            "id": self.id,
            "generation": self.generation,
            "doc_count": self.doc_count,
            "max_doc_id": self.max_doc_id,
            "blockmax": self.blockmax,
            "deleted_docs": self.deleted_docs,
            "avg_field_lengths": self.avg_field_lengths,
            "checksums": self.checksums,
            "has_vectors": self.has_vectors,
        }


@dataclass
class Manifest:
    schema: Schema
    version: int = 1
    uuid: str = dc_field(default_factory=lambda: str(uuid_mod.uuid4()))
    segments: list[SegmentMeta] = dc_field(default_factory=list)
    committed_at: str = dc_field(
        default_factory=lambda: datetime.now(timezone.utc).isoformat())
    generation: int = 0

    @classmethod
    def load(cls, storage: Storage) -> "Manifest":
        try:
            data = storage.read_to_end(MANIFEST_PATH)
        except StorageError as e:
            raise StorageError(f"reading manifest: {e}") from e
        try:
            obj = json.loads(data)
        except json.JSONDecodeError as e:
            raise StorageError(f"parsing manifest: {e}") from e
        return cls(
            schema=Schema.from_json(obj["schema"]),
            version=int(obj.get("version", 1)),
            uuid=obj.get("uuid", str(uuid_mod.uuid4())),
            segments=[SegmentMeta.from_json(s)
                      for s in obj.get("segments", [])],
            committed_at=obj.get("committed_at", ""),
            generation=int(obj.get("generation", 0)),
        )

    def store(self, storage: Storage) -> None:
        self.committed_at = datetime.now(timezone.utc).isoformat()
        data = json.dumps(self.to_json(), indent=2).encode()
        storage.atomic_write(MANIFEST_PATH, data)

    def to_json(self) -> dict:
        return {
            "version": self.version,
            "uuid": self.uuid,
            "generation": self.generation,
            "segments": [s.to_json() for s in self.segments],
            "committed_at": self.committed_at,
            "schema": self.schema.to_json(),
        }

    def total_docs(self) -> int:
        return sum(s.doc_count for s in self.segments)

    def total_deleted(self) -> int:
        return sum(len(s.deleted_docs) for s in self.segments)
