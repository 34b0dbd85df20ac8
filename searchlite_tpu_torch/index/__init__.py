"""Index root: create/open, writer/reader handles, compaction.

Parity with searchlite-core `index/mod.rs`: single-writer/multi-reader
via a writer lock + manifest lock; ``compact()`` rewrites all live docs
from every segment into a single segment at generation max+1, swaps the
manifest atomically, then deletes the old files; compaction refuses to
run when any indexed/fast field isn't stored (the rewrite would lose
data, `index/mod.rs:202-212`).
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Optional

from searchlite_tpu_torch.errors import SchemaError, StorageError
from searchlite_tpu_torch.index import directory
from searchlite_tpu_torch.index.manifest import Manifest, Schema
from searchlite_tpu_torch.index.segment import SegmentReader, SegmentWriter
from searchlite_tpu_torch.index.wal import Wal
from searchlite_tpu_torch.storage import FsStorage, InMemoryStorage, Storage

logger = logging.getLogger("searchlite_tpu_torch.index")


class Index:
    def __init__(self, storage: Storage, manifest: Manifest, options=None):
        from searchlite_tpu_torch.api.types import IndexOptions

        self.storage = storage
        self._manifest = manifest
        self._manifest_lock = threading.RLock()
        self.writer_lock = threading.RLock()
        # de-locked structural merges: ids being folded right now
        # (guarded by _merge_guard, see merge_segments)
        self._merge_guard = threading.Lock()
        self._merging_ids: set = set()
        self.options = options or IndexOptions(path="")
        # where this index's readers (and the merge warm) put segments:
        # the card unless the caller sets "cpu"
        self.device = "cuda"

    # -- constructors --------------------------------------------------------

    @classmethod
    def create(cls, options, schema: Optional[Schema] = None) -> "Index":
        storage = cls._make_storage(options, create=True)
        return cls.create_with_storage(storage, options, schema)

    @classmethod
    def create_with_storage(cls, storage: Storage, options,
                            schema: Optional[Schema] = None) -> "Index":
        if storage.exists("MANIFEST.json"):
            raise StorageError("index already exists")
        schema = schema or Schema.default_text_body()
        schema.validate_config()
        manifest = Manifest(schema=schema)
        manifest.store(storage)
        return cls(storage, manifest, options)

    @classmethod
    def open(cls, options, schema: Optional[Schema] = None) -> "Index":
        storage = cls._make_storage(options, create=options.create_if_missing)
        return cls.open_with_storage(storage, options, schema)

    @classmethod
    def open_with_storage(cls, storage: Storage, options,
                          schema: Optional[Schema] = None) -> "Index":
        if not storage.exists("MANIFEST.json"):
            if options.create_if_missing:
                return cls.create_with_storage(storage, options, schema)
            raise StorageError("index does not exist (no MANIFEST.json)")
        manifest = Manifest.load(storage)
        return cls(storage, manifest, options)

    @staticmethod
    def _make_storage(options, create: bool) -> Storage:
        from searchlite_tpu_torch.api.types import StorageType

        if options.storage == StorageType.IN_MEMORY:
            return InMemoryStorage()
        return FsStorage(str(options.path), create=create)

    # -- manifest access ------------------------------------------------------

    @property
    def manifest(self) -> Manifest:
        with self._manifest_lock:
            return self._manifest

    def set_manifest(self, manifest: Manifest) -> None:
        with self._manifest_lock:
            self._manifest = manifest

    def reload_manifest(self) -> Manifest:
        with self._manifest_lock:
            self._manifest = Manifest.load(self.storage)
            return self._manifest

    @property
    def schema(self) -> Schema:
        return self.manifest.schema

    # -- handles ---------------------------------------------------------------

    def writer(self):
        from searchlite_tpu_torch.api.writer import IndexWriter

        return IndexWriter(self)

    def reader(self, device=None):
        """The port's reader over this index, with every segment on
        ``device`` (default ``self.device``: the card unless the caller
        asks for the CPU). Raises where CUDA is absent."""
        from searchlite_tpu_torch.api.reader import IndexReader

        return IndexReader(self, device=self.device if device is None
                           else device)

    # -- maintenance -----------------------------------------------------------

    def ensure_compact_safe(self) -> None:
        for f in self.schema.resolved_fields():
            if (f.indexed or f.fast) and not f.stored:
                raise SchemaError(
                    f"cannot compact: field `{f.path}` is indexed/fast but "
                    "not stored; rewriting would lose data")
        # vector values never reach the docstore (the reference skips
        # them in collect, `index/segment.rs:534-539`), so its compact
        # silently DROPS every vector on the re-ingest — a reference
        # bug we refuse to inherit (divergence D11): use the
        # structural merge, which carries vector rows losslessly
        if self.schema.vector_fields and any(
                s.has_vectors for s in self.manifest.segments):
            raise SchemaError(
                "cannot compact: vector values are not stored in the "
                "docstore and a re-ingest would drop them; use "
                "merge_segments() (structural merge preserves vectors)")

    def merge_segments(self, segment_ids: Optional[list[str]] = None,
                       max_docs: Optional[int] = None) -> int:
        """STRUCTURAL merge (index/merge.py): fold segments into one by
        concatenating postings/fast columns/docstore/vectors with doc
        ordinals remapped and tombstones expunged — no re-ingestion, so
        unlike ``compact()`` it works with indexed/fast-but-not-stored
        fields. Selection: explicit ``segment_ids``, or every segment
        with ``doc_count <= max_docs`` (None = all segments). The
        merged segment APPENDS at the manifest tail: in the realtime
        pattern (big base segments first, small fresh ones after) the
        survivors' ordinals never shift, so their cached device
        uploads stay valid — placing the fold mid-list would evict
        and re-upload every later survivor for nothing.
        Returns the number of segments merged (0 = nothing to do).

        Warm-before-swap: once the fold's files exist but BEFORE the
        manifest swap, the merged segment is opened, uploaded to
        ``self.device`` and searched once on THIS thread
        (``_warm_fold``), filling the process-wide segment cache. Until
        the swap, readers serve the pre-merge snapshot -- a fold is
        content-neutral, so serving the old segments during the warm is
        exact. Without it the first search that touches a fold pays its
        upload. ``SEARCHLITE_MERGE_WARM=0`` disables.

        DE-LOCKED: the fold and the warm run OUTSIDE the writer lock, so
        a background merge never blocks a commit. Concurrency contract:

        - selection runs under the lock and marks the chosen ids in
          ``_merging_ids`` — a second merge never selects an
          in-progress input;
        - chosen segments' FILES are immutable; concurrent commits can
          only ADD tombstones to their manifest entries (LWW upserts /
          deletes);
        - the swap re-takes the lock and carries tombstones added
          since the snapshot onto the fold via the live-ordinal remap
          (``_carry_late_tombstones``), so a doc upserted mid-merge is
          never resurrected by the fold;
        - the fold's generation is re-bumped past any segment a
          concurrent commit minted, keeping reader.generation (the
          cursor epoch) strictly increasing across the swap;
        - if an input vanished meanwhile (concurrent ``compact()``),
          the fold is discarded and the merge reports 0."""
        import copy

        from searchlite_tpu_torch.index.merge import merge_segment_readers

        with self.writer_lock:
            manifest = self.reload_manifest()
            with self._merge_guard:
                chosen = [
                    m for m in manifest.segments
                    if (segment_ids is None or m.id in segment_ids)
                    and (max_docs is None or m.doc_count <= max_docs)
                    and m.id not in self._merging_ids]
                if len(chosen) < 2 and not any(m.deleted_docs
                                               for m in chosen):
                    return 0
                chosen_ids = {m.id for m in chosen}
                self._merging_ids |= chosen_ids
            # deep-snapshot: the fold must see one consistent tombstone
            # state; the live metas keep moving once the lock drops
            snapshot = [copy.deepcopy(m) for m in chosen]
            next_gen = max((s.generation for s in manifest.segments),
                           default=0) + 1

        new_meta = None
        swapped = False
        try:
            try:
                readers = [SegmentReader(m, self.storage)
                           for m in snapshot]
                new_meta = merge_segment_readers(
                    manifest.schema, self.storage, readers, next_gen,
                    compress=self.options.compress_docstore)
            except Exception:
                # benign race: a concurrent compact() may delete the
                # chosen files mid-fold — if the inputs are gone from
                # the live manifest, the merge is simply obsolete
                current = {m.id for m in self.reload_manifest().segments}
                if chosen_ids <= current:
                    raise
                return 0
            if new_meta is not None and os.environ.get(
                    "SEARCHLITE_MERGE_WARM", "1") != "0":
                preview = [m for m in manifest.segments
                           if m.id not in chosen_ids] + [new_meta]
                self._warm_fold(manifest, preview)

            with self.writer_lock:
                manifest = self.reload_manifest()
                live_by_id = {m.id: m for m in manifest.segments}
                if not chosen_ids <= set(live_by_id):
                    # a concurrent compact() swallowed an input — its
                    # docs live elsewhere now; the fold is stale
                    return 0
                if new_meta is not None:
                    _carry_late_tombstones(snapshot, live_by_id,
                                           new_meta)
                    new_meta.generation = max(
                        next_gen,
                        max((s.generation for s in manifest.segments),
                            default=0) + 1)
                segments = [m for m in manifest.segments
                            if m.id not in chosen_ids]
                if new_meta is not None:
                    segments.append(new_meta)
                manifest.segments = segments
                manifest.generation += 1
                manifest.store(self.storage)
                self.set_manifest(manifest)
                swapped = True
                self.cleanup_segments(sorted(chosen_ids))
                return len(chosen)
        finally:
            if new_meta is not None and not swapped:
                try:
                    self.cleanup_segments([new_meta.id])
                except Exception:  # noqa: BLE001
                    logger.warning("orphaned fold files for %s",
                                   new_meta.id, exc_info=True)
            with self._merge_guard:
                self._merging_ids -= chosen_ids

    def compact(self) -> None:
        with self.writer_lock:
            manifest = self.reload_manifest()
            if len(manifest.segments) <= 1 and not manifest.total_deleted():
                return
            self.ensure_compact_safe()
            old_segments = list(manifest.segments)
            next_gen = max(
                (s.generation for s in old_segments), default=0) + 1

            def live_docs():
                for seg_meta in old_segments:
                    reader = SegmentReader(seg_meta, self.storage)
                    for ordinal in reader.live_docs():
                        yield reader.get_doc(ordinal)

            writer = SegmentWriter(
                manifest.schema, self.storage,
                enable_positions=self.options.enable_positions,
                compress=self.options.compress_docstore)
            new_meta = writer.write_segment(live_docs(), next_gen)
            manifest.segments = [new_meta]
            manifest.generation += 1
            manifest.store(self.storage)
            self.set_manifest(manifest)
            self.cleanup_segments([s.id for s in old_segments])

    def cleanup_segments(self, segment_ids: list[int]) -> None:
        for seg_id in segment_ids:
            paths = directory.segment_paths(seg_id)
            for path in paths.all_files():
                try:
                    self.storage.remove_if_exists(path)
                except StorageError:
                    pass
            for f in list(self.storage.list_files()):
                if f.startswith(paths.vector_dir + "/"):
                    self.storage.remove_if_exists(f)

    # -- stats ------------------------------------------------------------------

    def stats(self) -> dict:
        m = self.manifest
        return {
            "documents": m.total_docs() - m.total_deleted(),
            "deleted_documents": m.total_deleted(),
            "segments": len(m.segments),
            "committed_at": m.committed_at,
            "uuid": m.uuid,
        }

    @property
    def wal(self) -> Wal:
        return Wal(self.storage)


    def _warm_fold(self, manifest, segments) -> None:
        """Open + search the post-merge segment list through a shadow
        Index whose manifest is the POST-swap state, while the live
        manifest still serves the pre-merge snapshot. Opening the reader
        on ``self.device`` fills the process-wide ``cached_segment``
        entries (the fold's upload); the searches run the two most common
        request shapes (multi-term limit-10 and single-term limit-1).
        Best-effort: any failure is logged and the first search pays the
        warm; the merge never fails for it. Runs on the merge thread
        OUTSIDE the writer lock."""
        import copy

        try:
            shadow_manifest = copy.copy(manifest)
            shadow_manifest.segments = list(segments)
            shadow = Index(self.storage, shadow_manifest, self.options)
            reader = shadow.reader(device=self.device)
            seg = reader.segments[-1]

            # pick index terms that round-trip through their field's
            # SEARCH analyzer unchanged, so a plain query string is
            # guaranteed to hit the fold's postings
            def round_trips(key: str) -> Optional[str]:
                field, _, tok = key.partition(":")
                analyzer = reader.analysis.search_analyzer(field)
                if analyzer is None or not tok:
                    return None
                out = analyzer.analyze(tok)
                if len(out) == 1 and out[0].text == tok \
                        and seg.term_id(key) is not None:
                    return tok
                return None

            toks: list[str] = []
            all_terms = seg.terms.terms
            step = max(1, len(all_terms) // 64)
            for key in all_terms[::step]:
                tok = round_trips(key)
                if tok is not None:
                    toks.append(tok)
                    if len(toks) >= 2:
                        break
            if not toks:
                # keys sort by field name, so the strided pass can land
                # entirely in one analyzer-mangling field: scan densely
                # before giving up
                for key in all_terms[:4096]:
                    tok = round_trips(key)
                    if tok is not None:
                        toks.append(tok)
                        if len(toks) >= 2:
                            break
            if toks:
                reader.search({"query": " ".join(toks), "limit": 10})
                reader.search({"query": toks[0], "limit": 1})
        except Exception:  # noqa: BLE001 -- warm is best-effort
            logger.warning("merge warm failed (the first search will pay "
                           "the fold's upload)", exc_info=True)


def _carry_late_tombstones(snapshot, live_by_id, new_meta) -> None:
    """Map tombstones that landed on the merge inputs AFTER the fold's
    snapshot onto the fold's ordinals, in place. Fold ordinals are the
    snapshot-live docs ascending, segments concatenated in snapshot
    order (index/merge.py::_live_remaps) — a late-deleted doc was live
    at the snapshot (commits only tombstone live docs), so its fold
    ordinal is base + rank(ordinal among snapshot-live)."""
    import numpy as np

    late: set[int] = set()
    base = 0
    for m_old in snapshot:
        dead = np.zeros(m_old.doc_count, dtype=bool)
        old_dead = [d for d in m_old.deleted_docs
                    if 0 <= d < m_old.doc_count]
        if old_dead:
            dead[old_dead] = True
        live = np.flatnonzero(~dead)
        m_now = live_by_id[m_old.id]
        extra = sorted(set(m_now.deleted_docs) - set(m_old.deleted_docs))
        if extra:
            extra_a = np.asarray(extra, dtype=np.int64)
            pos = np.searchsorted(live, extra_a)
            pos_c = np.minimum(pos, max(len(live) - 1, 0))
            ok = (len(live) > 0) & (live[pos_c] == extra_a)
            late.update((base + pos_c[ok]).tolist())
        base += len(live)
    if late:
        new_meta.deleted_docs = sorted(
            set(new_meta.deleted_docs) | late)
