"""Write-ahead log: append-only redo log for uncommitted operations.

Format parity with searchlite-core `index/wal.rs:50-62`: each entry is
``varint payload_len + type byte + payload + crc32_le(type + payload)``.
Entry types: AddDoc=1 (JSON document), Commit=2 (empty), DeleteDocId=3
(utf-8 doc id). Replay stops at the first corrupt/truncated entry
(`index/wal.rs:92-155`); ``last_pending_ops`` returns the ops after the
last Commit marker so an uncommitted batch survives a crash.
"""

from __future__ import annotations

import json
from typing import Any

from searchlite_tpu_torch.storage import Storage
from searchlite_tpu_torch.utils import varint
from searchlite_tpu_torch.utils.checksum import crc32

WAL_PATH = "wal.log"

ADD_DOC = 1
COMMIT = 2
DELETE_DOC_ID = 3

# json.dumps(..., sort_keys=True) builds a fresh JSONEncoder per call;
# reusing one instance is ~18% faster on the bulk path, byte-identical
_encode_json = json.JSONEncoder(sort_keys=True).encode


class Wal:
    def __init__(self, storage: Storage, path: str = WAL_PATH):
        self._storage = storage
        self._path = path
        if not storage.exists(path):
            storage.write_all(path, b"")

    def _append_entry(self, entry_type: int, payload: bytes) -> None:
        buf = bytearray()
        buf += varint.encode_u64(len(payload))
        buf.append(entry_type)
        buf += payload
        checksum = crc32(bytes([entry_type]) + payload)
        buf += checksum.to_bytes(4, "little")
        self._storage.append_all(self._path, bytes(buf))

    def append_add_doc(self, doc: dict) -> None:
        self._append_entry(
            ADD_DOC,
            _encode_json({"fields": doc}).encode())

    def append_add_docs(self, docs: list[dict],
                        raws: list[bytes | None] | None = None) -> None:
        """Bulk form of :meth:`append_add_doc`: one storage append for
        the whole batch, byte-identical entries (hot at ingest — on FS
        storage a per-doc append costs an open+close each).

        ``raws`` (optional, aligned with ``docs``): the client's raw
        JSON bytes for a doc, as received on an NDJSON surface. When
        given, the entry payload is spliced as ``{"fields":<raw>}``
        instead of re-serializing the parsed dict — replay semantics
        are identical (:meth:`replay` json-decodes the payload), and
        skipping ``json.dumps`` is the dominant WAL cost at bulk
        ingest. Callers must guarantee ``json.loads(raws[i]) ==
        docs[i]`` (true by construction when the doc came from that
        line)."""
        buf = bytearray()
        type_crc = crc32(bytes([ADD_DOC]))
        for i, doc in enumerate(docs):
            raw = raws[i] if raws is not None else None
            if raw is not None:
                payload = b'{"fields":' + raw + b"}"
            else:
                payload = _encode_json({"fields": doc}).encode()
            buf += varint.encode_u64(len(payload))
            buf.append(ADD_DOC)
            buf += payload
            checksum = crc32(payload, type_crc)
            buf += checksum.to_bytes(4, "little")
        if buf:
            self._storage.append_all(self._path, bytes(buf))

    def append_commit(self) -> None:
        self._append_entry(COMMIT, b"")

    def append_delete_doc_id(self, doc_id: str) -> None:
        self._append_entry(DELETE_DOC_ID, doc_id.encode())

    def append_delete_doc_ids(self, doc_ids: list[str]) -> None:
        """Bulk deletes: one storage append, byte-identical entries."""
        buf = bytearray()
        type_crc = crc32(bytes([DELETE_DOC_ID]))
        for doc_id in doc_ids:
            payload = doc_id.encode()
            buf += varint.encode_u64(len(payload))
            buf.append(DELETE_DOC_ID)
            buf += payload
            buf += crc32(payload, type_crc).to_bytes(4, "little")
        if buf:
            self._storage.append_all(self._path, bytes(buf))

    def truncate(self) -> None:
        self._storage.write_all(self._path, b"")

    def length(self) -> int:
        if not self._storage.exists(self._path):
            return 0
        return len(self._storage.read_to_end(self._path))

    def truncate_to(self, length: int) -> None:
        data = self._storage.read_to_end(self._path)
        self._storage.write_all(self._path, data[:length])

    @staticmethod
    def replay(storage: Storage, path: str = WAL_PATH) -> list[tuple[int, Any]]:
        """Decode entries until the first corruption. Returns a list of
        ``(entry_type, payload)`` where payload is a document dict for
        AddDoc, a doc-id string for DeleteDocId, None for Commit."""
        if not storage.exists(path):
            return []
        data = storage.read_to_end(path)
        cursor = 0
        entries: list[tuple[int, Any]] = []
        n = len(data)
        while cursor < n:
            try:
                length, cursor2 = varint.decode_u64(data, cursor)
            except ValueError:
                break
            cursor = cursor2
            if cursor >= n:
                break
            entry_type = data[cursor]
            cursor += 1
            payload_end = cursor + length
            checksum_end = payload_end + 4
            if checksum_end > n:
                break
            payload = data[cursor:payload_end]
            stored_crc = int.from_bytes(data[payload_end:checksum_end], "little")
            cursor = checksum_end
            if crc32(bytes([entry_type]) + payload) != stored_crc:
                break
            if entry_type == ADD_DOC:
                try:
                    obj = json.loads(payload)
                except json.JSONDecodeError:
                    continue
                fields = obj.get("fields") if isinstance(obj, dict) else None
                if isinstance(fields, dict):
                    entries.append((ADD_DOC, fields))
            elif entry_type == COMMIT:
                entries.append((COMMIT, None))
            elif entry_type == DELETE_DOC_ID:
                try:
                    entries.append((DELETE_DOC_ID, payload.decode()))
                except UnicodeDecodeError:
                    continue
        return entries

    @staticmethod
    def last_pending_ops(storage: Storage,
                         path: str = WAL_PATH) -> list[tuple[int, Any]]:
        pending: list[tuple[int, Any]] = []
        for entry_type, payload in Wal.replay(storage, path):
            if entry_type == COMMIT:
                pending.clear()
            else:
                pending.append((entry_type, payload))
        return pending
