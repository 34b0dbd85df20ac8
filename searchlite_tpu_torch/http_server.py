"""HTTP service: single-index server.

Route parity with searchlite-http (`searchlite-http/src/lib.rs:327-344`):
GET  /healthz /inspect /stats
POST /init /add (x-ndjson) /bulk /delete /commit /refresh /compact /merge
/search /search_batch (beyond the reference: one launch a route per batch)

Error shape ``{"error": {"type": ..., "reason": ...}}``
(`lib.rs:110-120`). Config knobs mirror ServeArgs with SEARCHLITE_* env
fallbacks: bind, require_existing_index, max_body_bytes (50 MiB),
request_timeout, refresh_on_commit (`lib.rs:44-82`).

Built on the stdlib ThreadingHTTPServer; a writer lock serializes
mutating routes (the engine is single-writer / multi-reader).

The server's readers run on the card (``device=None``: the index's
default, ``searchlite_tpu_torch.default_device()``); ``device="cpu"``
asks for the CPU, and without CUDA the first search on the card answers
with the reader's error. A ``/commit`` reopens the reader through the
process-wide segment cache (``device/index.py::cached_segment``): a
segment whose tombstones alone moved is reopened as a clone that shares
every deletion-independent tensor with the one it replaces.
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from searchlite_tpu_torch.api.types import IndexOptions, SearchRequest
from searchlite_tpu_torch.errors import (
    CursorError,
    QueryError,
    SchemaError,
    SearchliteError,
    StorageError,
)
from searchlite_tpu_torch.index import Index
from searchlite_tpu_torch.index.manifest import Schema

DEFAULT_MAX_BODY = 50 * 1024 * 1024


class HttpError(Exception):
    def __init__(self, status: int, err_type: str, reason: str):
        super().__init__(reason)
        self.status = status
        self.err_type = err_type
        self.reason = reason


class AppState:
    def __init__(self, index_path: str, require_existing_index: bool = False,
                 refresh_on_commit: bool = True,
                 max_body_bytes: int = DEFAULT_MAX_BODY,
                 max_concurrency: int = 64,
                 mesh: str | int | None = None, device=None):
        self.index_path = index_path
        # the readers' torch device; None = the index's default (the card)
        self.device = device
        # doc-sharded execution over a mesh: "auto" = every visible device
        # of the readers' type, an int = that many shards round robin on
        # them. Parsed on the first search (parallel/mesh.py::
        # parse_mesh_spec), one mesh a server; "auto" on one device is
        # ignored.
        self.mesh_spec = mesh
        self._mesh = None
        self.refresh_on_commit = refresh_on_commit
        self.max_body_bytes = max_body_bytes
        # concurrency cap, parity with the reference's tower layer
        # (`searchlite-http/src/lib.rs:319-325`, default 64)
        self.concurrency = threading.BoundedSemaphore(max_concurrency)
        self.writer_lock = threading.Lock()
        self._index_lock = threading.Lock()
        self._index: Index | None = None
        self._reader = None
        manifest_path = os.path.join(index_path, "MANIFEST.json")
        if os.path.exists(manifest_path):
            self._index = Index.open(self._options(False))
        elif require_existing_index:
            raise StorageError(
                f"index does not exist at {index_path} "
                "(require_existing_index set)")

    def _options(self, create: bool) -> IndexOptions:
        return IndexOptions(path=self.index_path, create_if_missing=create,
                            bm25_k1=0.9, bm25_b=0.4)

    def require_index(self) -> Index:
        with self._index_lock:
            if self._index is None:
                raise HttpError(404, "index_missing",
                                "index has not been initialized")
            return self._index

    def set_index(self, index: Index) -> None:
        with self._index_lock:
            self._index = index
            self._reader = None

    def reader(self):
        index = self.require_index()
        with self._index_lock:
            if self._reader is None or \
                    self._reader.generation != index.manifest.generation:
                self._reader = index.reader(device=self.device)
            return self._reader

    def refresh(self) -> None:
        index = self.require_index()
        index.reload_manifest()
        with self._index_lock:
            self._reader = index.reader(device=self.device)

    @property
    def mesh(self):
        if self.mesh_spec in (None, "", "off", "none", "0", 0):
            return None
        # concurrent first requests must not build two meshes: the
        # per-shard tables cache per mesh
        with self._index_lock:
            spec = self.mesh_spec
            if spec is None:
                return None
            if self._mesh is None:
                from searchlite_tpu_torch import default_device
                from searchlite_tpu_torch.parallel.mesh import (
                    parse_mesh_spec,
                )

                self._mesh = parse_mesh_spec(
                    spec, device=self.device or default_device())
                if self._mesh is None:
                    # one device: the mesh buys nothing, skip for good
                    self.mesh_spec = None
            return self._mesh


def _error_payload(err_type: str, reason: str) -> bytes:
    return json.dumps(
        {"error": {"type": err_type, "reason": reason}}).encode()


class Handler(BaseHTTPRequestHandler):
    state: AppState = None  # set by run_server
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet by default
        if os.environ.get("SEARCHLITE_HTTP_LOG"):
            super().log_message(fmt, *args)

    # -- helpers ---------------------------------------------------------------

    def _send_json(self, status: int, payload) -> None:
        body = payload if isinstance(payload, bytes) else \
            json.dumps(payload, ensure_ascii=False).encode()
        self.send_response(status)
        self.send_header("content-type", "application/json")
        self.send_header("content-length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _read_body(self) -> bytes:
        length = int(self.headers.get("content-length") or 0)
        if length > self.state.max_body_bytes:
            # drain the request in chunks (never buffering it) so the
            # client can still read the 413 response
            remaining = length
            while remaining > 0:
                chunk = self.rfile.read(min(remaining, 1 << 20))
                if not chunk:
                    break
                remaining -= len(chunk)
            raise HttpError(413, "body_too_large",
                            "request body exceeds the configured limit")
        return self.rfile.read(length)

    def _json_body(self) -> dict:
        try:
            return json.loads(self._read_body() or b"{}")
        except json.JSONDecodeError as e:
            raise HttpError(400, "invalid_json", str(e)) from e

    def _dispatch(self, method: str) -> None:
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        routes = {
            ("GET", "/healthz"): self.handle_healthz,
            ("GET", "/inspect"): self.handle_inspect,
            ("GET", "/stats"): self.handle_stats,
            ("POST", "/init"): self.handle_init,
            ("POST", "/add"): self.handle_add,
            ("POST", "/bulk"): self.handle_bulk,
            ("POST", "/delete"): self.handle_delete,
            ("POST", "/commit"): self.handle_commit,
            ("POST", "/refresh"): self.handle_refresh,
            ("POST", "/compact"): self.handle_compact,
            ("POST", "/merge"): self.handle_merge,
            ("POST", "/search"): self.handle_search,
            ("POST", "/search_batch"): self.handle_search_batch,
        }
        handler = routes.get((method, path))
        if handler is None:
            self._send_json(404, _error_payload("not_found",
                                                f"no route {method} {path}"))
            return
        if not self.state.concurrency.acquire(timeout=30.0):
            self._send_json(503, _error_payload(
                "overloaded", "too many concurrent requests"))
            return
        try:
            handler()
        except HttpError as e:
            self._send_json(e.status, _error_payload(e.err_type, e.reason))
        except (QueryError, SchemaError, CursorError) as e:
            self._send_json(400, _error_payload("bad_request", str(e)))
        except SearchliteError as e:
            self._send_json(500, _error_payload("internal", str(e)))
        except Exception as e:  # noqa: BLE001
            self._send_json(500, _error_payload("internal", str(e)))
        finally:
            self.state.concurrency.release()

    def do_GET(self):  # noqa: N802
        self._dispatch("GET")

    def do_POST(self):  # noqa: N802
        self._dispatch("POST")

    # -- handlers ----------------------------------------------------------------

    def handle_healthz(self):
        self._send_json(200, {"status": "ok"})

    def handle_init(self):
        body = self._json_body()
        schema_json = body.get("schema", body)
        if os.path.exists(os.path.join(self.state.index_path,
                                       "MANIFEST.json")):
            raise HttpError(409, "index_exists",
                            "index has already been initialized")
        try:
            schema = Schema.from_json(schema_json)
            index = Index.create(self.state._options(True), schema)
        except (SchemaError, StorageError) as e:
            raise HttpError(400, "init_failed", str(e)) from e
        self.state.set_index(index)
        self._send_json(200, {"created": True})

    def _iter_ndjson_lines(self):
        """Stream the request body as NDJSON lines WITHOUT buffering the
        raw bytes (reference parity: `searchlite-http/src/lib.rs:327-344`
        streams x-ndjson). Reads 1 MiB chunks off the socket and yields
        (line_number, line_bytes); enforces max_body_bytes while
        streaming."""
        length = int(self.headers.get("content-length") or 0)
        if length > self.state.max_body_bytes:
            self._read_body()  # drains + raises 413
        remaining = length
        buf = b""
        line_number = 0
        while remaining > 0:
            chunk = self.rfile.read(min(remaining, 1 << 20))
            if not chunk:
                break
            remaining -= len(chunk)
            parts = (buf + chunk).split(b"\n")
            buf = parts.pop()
            for line in parts:
                line_number += 1
                line = line.strip()
                if line:
                    yield line_number, line
        tail = buf.strip()
        if tail:
            yield line_number + 1, tail

    def handle_add(self):
        index = self.state.require_index()
        docs = []
        raws = []
        for line_number, line in self._iter_ndjson_lines():
            try:
                docs.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise HttpError(
                    400, "invalid_document",
                    f"invalid JSON document on NDJSON line {line_number}: "
                    f"{e}") from e
            raws.append(line)
        if not docs:
            self._send_json(200, {"queued": 0})
            return
        with self.state.writer_lock:
            writer = index.writer()
            try:
                # one bulk WAL append; the client's raw line bytes ride
                # through as the WAL payloads (no re-serialization)
                writer.add_documents(docs, raws=raws)
            except SchemaError as e:
                writer.rollback()
                raise HttpError(400, "add_failed", str(e)) from e
        self._send_json(200, {"queued": len(docs)})

    def handle_bulk(self):
        index = self.state.require_index()
        body = self._json_body()
        docs = body.get("docs") or []
        if not docs:
            raise HttpError(400, "missing_documents",
                            "docs array must contain at least one document")
        with self.state.writer_lock:
            writer = index.writer()
            try:
                writer.add_documents(docs)
            except SchemaError as e:
                writer.rollback()
                raise HttpError(400, "add_failed", str(e)) from e
        self._send_json(200, {"queued": len(docs)})

    def handle_delete(self):
        index = self.state.require_index()
        body = self._json_body()
        ids = body.get("ids") or []
        if not ids:
            raise HttpError(400, "missing_ids",
                            "ids array must contain at least one document id")
        for doc_id in ids:
            if not isinstance(doc_id, str) or not doc_id.strip():
                raise HttpError(400, "invalid_id",
                                "document ids must be non-empty strings")
        with self.state.writer_lock:
            writer = index.writer()
            writer.delete_documents(ids)
        self._send_json(200, {"queued": len(ids)})

    def handle_commit(self):
        index = self.state.require_index()
        with self.state.writer_lock:
            writer = index.writer()
            writer.commit()
        if self.state.refresh_on_commit:
            self.state.refresh()
        self._send_json(200, {"committed": True})

    def handle_refresh(self):
        self.state.refresh()
        self._send_json(200, {"refreshed": True})

    def handle_compact(self):
        index = self.state.require_index()
        with self.state.writer_lock:
            index.compact()
        self.state.refresh()
        self._send_json(200, {"compacted": True})

    def handle_merge(self):
        """Structural segment merge (beyond the reference's routes):
        body {"max_docs": N} bounds which segments fold; tombstones
        are expunged and no stored fields are required (contrast
        /compact)."""
        index = self.state.require_index()
        body = self._json_body()
        max_docs = body.get("max_docs")
        if max_docs is not None and (not isinstance(max_docs, int)
                                     or isinstance(max_docs, bool)):
            raise HttpError(400, "invalid_request",
                            "max_docs must be an integer")
        with self.state.writer_lock:
            n = index.merge_segments(max_docs=max_docs)
        self.state.refresh()
        self._send_json(200, {"merged_segments": n})

    def handle_search(self):
        reader = self.state.reader()
        body = self._json_body()
        try:
            request = SearchRequest.from_json(body)
            result = reader.search(request, mesh=self.state.mesh)
        except (QueryError, CursorError, SchemaError) as e:
            raise HttpError(400, "search_failed", str(e)) from e
        self._send_json(200, result.to_json())

    def handle_search_batch(self):
        """Beyond the reference surface: score a batch of structured
        queries together.

        Body: {"queries": [...], "limit": N?, "fields": [...]?,
               "execution": "bm25"|"wand"|"bmw"?,
               "filters": [Filter|null, ...]?, "limits": [N, ...]?}

        Each entry of "queries" is a query string OR an object
        {"query": str, "filter": Filter?, "limit": N?} — the object
        form sets that query's filter/limit (overriding the aligned
        top-level lists). Response:
        {"results": [[{"doc_id", "score"}...] per query]}."""
        reader = self.state.reader()
        body = self._json_body()
        raw_queries = body.get("queries")
        if not isinstance(raw_queries, list):
            raise HttpError(400, "bad_request",
                            "`queries` must be a list")
        limit = int(body.get("limit", 10))
        fields = body.get("fields")
        execution = body.get("execution", "bm25")
        filters = body.get("filters")
        limits = body.get("limits")
        if filters is not None and (not isinstance(filters, list)
                                    or len(filters) != len(raw_queries)):
            raise HttpError(400, "bad_request",
                            "`filters` must align with `queries`")
        if limits is not None and (not isinstance(limits, list)
                                   or len(limits) != len(raw_queries)):
            raise HttpError(400, "bad_request",
                            "`limits` must align with `queries`")
        queries: list[str] = []
        q_filters = list(filters) if filters is not None \
            else [None] * len(raw_queries)
        q_limits = [int(x) for x in limits] if limits is not None \
            else [limit] * len(raw_queries)
        for i, q in enumerate(raw_queries):
            if isinstance(q, str):
                queries.append(q)
            elif isinstance(q, dict) and isinstance(q.get("query"), str):
                queries.append(q["query"])
                if "filter" in q:
                    q_filters[i] = q["filter"]
                if "limit" in q:
                    q_limits[i] = int(q["limit"])
            else:
                raise HttpError(
                    400, "bad_request",
                    "each query must be a string or "
                    '{"query": ..., "filter"?: ..., "limit"?: ...}')
        try:
            rows = reader.search_batch(
                queries, limit=max(q_limits, default=limit),
                fields=fields, execution=execution,
                filters=(q_filters if any(f is not None
                                          for f in q_filters) else None),
                limits=q_limits, mesh=self.state.mesh)
        except (QueryError, CursorError, SchemaError) as e:
            raise HttpError(400, "search_failed", str(e)) from e
        self._send_json(200, {"results": [
            [{"doc_id": doc_id, "score": score} for doc_id, score in row]
            for row in rows]})

    def handle_inspect(self):
        index = self.state.require_index()
        self._send_json(200, index.manifest.to_json())

    def handle_stats(self):
        index = self.state.require_index()
        stats = index.stats()
        stats["path"] = self.state.index_path
        self._send_json(200, stats)


def make_server(index_path: str, bind: str = "127.0.0.1:7700",
                require_existing_index: bool = False,
                refresh_on_commit: bool = True,
                mesh: str | int | None = None,
                device=None) -> ThreadingHTTPServer:
    host, _, port = bind.rpartition(":")
    state = AppState(
        index_path,
        require_existing_index=require_existing_index
        or bool(os.environ.get("SEARCHLITE_REQUIRE_EXISTING_INDEX")),
        refresh_on_commit=refresh_on_commit,
        max_body_bytes=int(os.environ.get("SEARCHLITE_MAX_BODY_BYTES",
                                          DEFAULT_MAX_BODY)),
        max_concurrency=int(os.environ.get("SEARCHLITE_MAX_CONCURRENCY",
                                           64)),
        mesh=mesh if mesh is not None
        else os.environ.get("SEARCHLITE_MESH") or None,
        device=device,
    )

    handler = type("BoundHandler", (Handler,), {
        "state": state,
        # per-connection socket timeout (reference request_timeout 30s)
        "timeout": float(os.environ.get("SEARCHLITE_REQUEST_TIMEOUT", 30)),
    })
    return ThreadingHTTPServer((host or "127.0.0.1", int(port)), handler)


def run_server(index_path: str, bind: str = "127.0.0.1:7700",
               require_existing_index: bool = False,
               mesh: str | int | None = None, device=None) -> None:
    server = make_server(index_path, bind, require_existing_index,
                         mesh=mesh, device=device)
    print(f"searchlite-tpu-torch http listening on {server.server_address}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
