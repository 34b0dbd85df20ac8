"""Structural segment merge: N segments -> 1, without re-ingestion.

``Index.compact()`` follows the reference's design (`index/mod.rs:102`):
re-collect every live document from the docstore and re-ingest it,
which is why both engines refuse to compact a schema with indexed- or
fast-but-not-stored fields — the data to re-tokenize simply isn't
there. This module merges segments STRUCTURALLY instead: postings,
positions, fast-field columns, docstore records, and vector rows are
concatenated with doc ordinals remapped (tombstones expunged), entirely
vectorized over the existing numpy structures. No analyzer runs, no
stored fields are required, and the output is logically identical to
re-ingesting the same live docs in the same order — equivalence is
enforced by tests/test_merge.py against both ``compact()`` and a
single-commit rebuild.

This is also the host tier's graduation policy (docs/architecture.md
"The host tier"): small realtime segments merge past
SEARCHLITE_HOST_TIER_DOCS and re-enter the segment cache on the
accelerator tier. The reference has no segment-merge counterpart — its
only fold is the stored-field-gated compact.

Doc ordering: live docs keep their order within each segment, and
segments concatenate in manifest order, so merged doc ordinals (and
therefore BM25 tie order, which is (score desc, doc asc)) match what a
single-segment re-ingest of the same stream would produce. BM25
scores change exactly like compact's do: df/avgdl become corpus-wide
instead of per-segment — that is the defined semantic of merging
segments, not drift.
"""

from __future__ import annotations

import io
import json
import uuid as uuid_mod
from itertools import compress as _compress

import numpy as np

from searchlite_tpu_torch.errors import StorageError
from searchlite_tpu_torch.index import directory
from searchlite_tpu_torch.index.docstore import DocStoreWriter, resolve_codec
from searchlite_tpu_torch.index.fastfields import Column, FastFields
from searchlite_tpu_torch.index.manifest import Schema, SegmentMeta
from searchlite_tpu_torch.index.postings import BLOCK, PostingsData
from searchlite_tpu_torch.index.segment import SegmentReader
from searchlite_tpu_torch.index.terms import write_terms
from searchlite_tpu_torch.utils.checksum import crc32


def _ragged_gather(values: np.ndarray, starts: np.ndarray,
                   lens: np.ndarray) -> np.ndarray:
    """values[starts[i] : starts[i]+lens[i]] for all i, concatenated."""
    total = int(lens.sum())
    if total == 0:
        return values[:0]
    ends = np.cumsum(lens)
    idx = np.repeat(starts, lens) \
        + np.arange(total, dtype=np.int64) \
        - np.repeat(ends - lens, lens)
    return values[idx]


def _live_remaps(readers: list[SegmentReader]):
    """Per segment: live-doc bool mask and old->new ordinal map (-1 for
    tombstoned docs); new ordinals run live docs in order, segments
    concatenated in the given order."""
    lives, remaps = [], []
    base = 0
    for r in readers:
        n = r.doc_count
        live = np.ones(n, dtype=bool)
        dead = [d for d in r.deleted if 0 <= d < n]
        if dead:
            live[dead] = False
        remap = np.where(live, np.cumsum(live) - 1 + base,
                         -1).astype(np.int64)
        lives.append(live)
        remaps.append(remap)
        base += int(live.sum())
    return lives, remaps, base


def _flat_postings(p: PostingsData):
    """(docs, tfs, term_of_posting) with block pads stripped; postings
    stay term-major (the block spans are laid out in term order)."""
    flat_docs = p.block_docs.reshape(-1)
    real = flat_docs >= 0
    docs = flat_docs[real].astype(np.int64)
    tfs = p.block_tfs.reshape(-1)[real]
    tids = np.repeat(np.arange(p.n_terms, dtype=np.int64),
                     p.term_df.astype(np.int64))
    if len(tids) != len(docs):  # corrupt block/df disagreement
        raise StorageError("postings block pads disagree with term_df")
    return docs, tfs, tids


def _merge_postings(readers, lives, remaps, has_positions: bool):
    """Merged PostingsData over live docs with remapped ordinals."""
    term_union = sorted(set().union(
        *[set(r.postings.terms) for r in readers])) \
        if readers else []
    term_pos = {t: i for i, t in enumerate(term_union)}

    mtids_all, docs_all, tfs_all = [], [], []
    plens_all, pvals_all = [], []
    for r, live, remap in zip(readers, lives, remaps):
        p = r.postings
        if p.n_terms == 0:
            continue
        docs, tfs, tids = _flat_postings(p)
        keep = live[docs]
        local2m = np.fromiter((term_pos[t] for t in p.terms),
                              dtype=np.int64, count=p.n_terms)
        mtids_all.append(local2m[tids[keep]])
        docs_all.append(remap[docs[keep]])
        tfs_all.append(tfs[keep])
        if has_positions:
            lens = np.diff(p.pos_offsets)
            starts = p.pos_offsets[:-1]
            kidx = np.flatnonzero(keep)
            klens = lens[kidx]
            plens_all.append(klens)
            pvals_all.append(_ragged_gather(p.pos_values,
                                            starts[kidx], klens))

    if not mtids_all or not sum(len(a) for a in mtids_all):
        return PostingsData(
            terms=[], block_docs=np.full((0, BLOCK), -1, np.int32),
            block_tfs=np.zeros((0, BLOCK), np.float32),
            block_term=np.zeros(0, np.int32),
            term_block_start=np.zeros(0, np.int32),
            term_block_count=np.zeros(0, np.int32),
            term_df=np.zeros(0, np.int32),
            term_max_tf=np.zeros(0, np.float32),
            block_max_tf=np.zeros(0, np.float32),
            block_last_doc=np.zeros(0, np.int32),
            pos_values=np.zeros(0, np.int32),
            pos_offsets=np.zeros(1, np.int64),
            has_positions=has_positions)

    mtids = np.concatenate(mtids_all)
    docs = np.concatenate(docs_all)
    tfs = np.concatenate(tfs_all)
    # group by merged term; the stable sort keeps segment order inside
    # each group, and remapped doc ranges ascend by segment, so each
    # term's postings come out doc-sorted — the builder's invariant
    order = np.argsort(mtids, kind="stable")
    mtids, docs, tfs = mtids[order], docs[order], tfs[order]

    df_full = np.bincount(mtids, minlength=len(term_union)) \
        .astype(np.int64)
    alive_terms = df_full > 0  # terms whose postings all died drop out
    terms = [t for t, a in zip(term_union, alive_terms) if a]
    new_tid = np.cumsum(alive_terms) - 1  # old union pos -> compacted
    term_df = df_full[alive_terms]
    n_terms = len(terms)

    blocks = -(-term_df // BLOCK)
    term_block_start = np.concatenate(
        [[0], np.cumsum(blocks)[:-1]]).astype(np.int32)
    total_blocks = int(blocks.sum())
    df_base = np.concatenate([[0], np.cumsum(term_df)])
    # destination slot of each posting inside the padded block matrix
    tid_of_posting = new_tid[mtids]
    within = np.arange(len(docs), dtype=np.int64) \
        - df_base[:-1][tid_of_posting]
    dest = term_block_start.astype(np.int64)[tid_of_posting] * BLOCK \
        + within
    block_docs = np.full((total_blocks, BLOCK), -1, dtype=np.int32)
    block_tfs = np.zeros((total_blocks, BLOCK), dtype=np.float32)
    block_docs.reshape(-1)[dest] = docs.astype(np.int32)
    block_tfs.reshape(-1)[dest] = tfs.astype(np.float32)
    block_term = np.repeat(np.arange(n_terms, dtype=np.int32),
                           blocks.astype(np.int64))

    # per-term max tf: postings are term-major and every term has
    # df >= 1, so a reduceat over the term boundaries is exact
    term_max_tf = np.maximum.reduceat(
        tfs, df_base[:-1]).astype(np.float32) if len(tfs) else \
        np.zeros(0, dtype=np.float32)

    if has_positions:
        klens = np.concatenate(plens_all) if plens_all else \
            np.zeros(0, np.int64)
        pvals = np.concatenate(pvals_all) if pvals_all else \
            np.zeros(0, np.int32)
        # reorder the per-posting position slices into the merged
        # term-major posting order
        klens_sorted = klens[order]
        kstarts = np.concatenate([[0], np.cumsum(klens)])[:-1]
        pos_values = _ragged_gather(pvals, kstarts[order],
                                    klens_sorted)
        pos_offsets = np.concatenate(
            [[0], np.cumsum(klens_sorted)]).astype(np.int64)
    else:
        pos_values = np.zeros(0, dtype=np.int32)
        pos_offsets = np.zeros(1, dtype=np.int64)

    return PostingsData(
        terms=terms,
        block_docs=block_docs,
        block_tfs=block_tfs,
        block_term=block_term,
        term_block_start=term_block_start,
        term_block_count=blocks.astype(np.int32),
        term_df=term_df.astype(np.int32),
        term_max_tf=term_max_tf,
        block_max_tf=block_tfs.max(axis=1) if total_blocks else
        np.zeros(0, np.float32),
        block_last_doc=(block_docs.max(axis=1).astype(np.int32)
                        if total_blocks else np.zeros(0, np.int32)),
        pos_values=np.asarray(pos_values, dtype=np.int32),
        pos_offsets=pos_offsets,
        has_positions=has_positions,
    )


def _merge_fast(readers, lives, remaps, n_total: int) -> FastFields:
    """Concatenate every fast column over live docs; str codes re-
    encode against a merged dictionary (first occurrence in merged
    value-stream order, like FastFieldsWriter.build)."""
    names: list[str] = []
    for r in readers:
        for name in r.fast.columns:
            if name not in names:
                names.append(name)

    live_counts = [int(live.sum()) for live in lives]
    columns: dict[str, Column] = {}
    for name in names:
        kind = nested = None
        counts_parts, vals_parts, objs_parts = [], [], []
        for r, live, remap in zip(readers, lives, remaps):
            col = r.fast.columns.get(name)
            n_live = int(live.sum())
            if col is None:
                counts_parts.append(np.zeros(n_live, dtype=np.int64))
                continue
            if kind is None:
                kind, nested = col.kind, col.nested
            elif (kind, nested) != (col.kind, col.nested):
                raise StorageError(
                    f"cannot merge: column `{name}` disagrees across "
                    f"segments ({kind}/{nested} vs "
                    f"{col.kind}/{col.nested})")
            counts = np.diff(col.offsets)
            counts_parts.append(counts[live])
            rowmask = live[col.row_ids]
            vals = col.values[rowmask]
            if col.kind == "str":
                dic = np.asarray(col.dictionary, dtype=object)
                vals = dic[vals] if len(vals) else \
                    np.zeros(0, dtype=object)
            vals_parts.append(vals)
            if nested:
                objs_parts.append(col.objects[rowmask])
        counts_all = np.concatenate(counts_parts) if counts_parts \
            else np.zeros(0, np.int64)
        assert len(counts_all) == n_total
        offsets = np.zeros(n_total + 1, dtype=np.int64)
        np.cumsum(counts_all, out=offsets[1:])
        row_ids = np.repeat(
            np.arange(n_total, dtype=np.int64),
            counts_all).astype(np.int32)
        dictionary: list[str] = []
        if kind == "str":
            stream = (np.concatenate(vals_parts) if vals_parts
                      else np.zeros(0, dtype=object))
            uniq: dict[str, int] = {}
            values = np.fromiter(
                (uniq.setdefault(s, len(uniq)) for s in stream),
                dtype=np.int32, count=len(stream))
            dictionary = list(uniq)
        elif kind == "i64":
            values = (np.concatenate(vals_parts).astype(np.int64)
                      if vals_parts else np.zeros(0, np.int64))
        else:
            values = (np.concatenate(vals_parts).astype(np.float64)
                      if vals_parts else np.zeros(0, np.float64))
        columns[name] = Column(
            kind=kind or "i64",
            nested=bool(nested),
            offsets=offsets,
            values=values,
            row_ids=row_ids,
            objects=(np.concatenate(objs_parts).astype(np.int32)
                     if nested else None),
            dictionary=dictionary,
            is_list=bool(counts_all.max(initial=0) > 1),
        )
    return FastFields(columns=columns, n_docs=n_total)


def _merge_docstore(readers, lives, compress) -> tuple[bytes, list[int]]:
    """Live docstore records, raw-copied when every input shares the
    target codec (no decode), re-encoded otherwise."""
    target = resolve_codec(compress)
    raw_ok = all(r.docstore._codec == target for r in readers)
    if raw_ok:
        chunks: list[bytes] = []
        offsets: list[int] = []
        pos = 0
        for r, live in zip(readers, lives):
            data = r.docstore._data
            offs = np.asarray(r.docstore._offsets, dtype=np.int64)
            bounds = np.concatenate([offs, [len(data)]])
            mv = memoryview(data)
            # tombstones are sparse: copy contiguous LIVE runs (one
            # slice per run) instead of one bytes object per record,
            # and derive per-record offsets from the offset deltas
            padded = np.concatenate([[False], live, [False]])
            starts = np.flatnonzero(padded[1:] & ~padded[:-1])
            ends = np.flatnonzero(~padded[1:] & padded[:-1])
            for lo, hi in zip(starts, ends):
                byte_lo = int(bounds[lo])
                chunks.append(bytes(mv[byte_lo:int(bounds[hi])]))
                offsets.extend(
                    (bounds[lo:hi] - byte_lo + pos).tolist())
                pos += int(bounds[hi]) - byte_lo
        return b"".join(chunks), offsets
    buf = io.BytesIO()
    writer = DocStoreWriter(buf, compress=compress)
    for r, live in zip(readers, lives):
        for o in np.flatnonzero(live):
            writer.add_document(r.docstore.get(int(o)))
    writer.flush()
    return buf.getvalue(), writer.offsets


def merge_segment_readers(schema: Schema, storage, readers, generation,
                          compress=False) -> SegmentMeta | None:
    """Write one merged segment from ``readers`` (manifest order) with
    tombstones expunged. Returns the new SegmentMeta, or None when no
    live docs remain (callers drop the inputs from the manifest)."""
    lives, remaps, n_total = _live_remaps(readers)
    if n_total == 0:
        return None

    has_positions = all(r.enable_positions for r in readers)
    postings = _merge_postings(readers, lives, remaps, has_positions)
    fast = _merge_fast(readers, lives, remaps, n_total)

    doc_ids: list[str] = []
    for r, live in zip(readers, lives):
        doc_ids.extend(_compress(r.doc_ids, live.tolist()))

    # avgdl over the merged live docs from the _len columns — what a
    # re-ingest of the same docs would compute (token total / n_docs)
    avg_field_lengths: dict[str, float] = {}
    for name, col in fast.columns.items():
        if name.startswith("_len:"):
            avg_field_lengths[name[len("_len:"):]] = (
                float(col.values.sum()) / n_total if n_total else 0.0)

    seg_id = uuid_mod.uuid4().hex
    paths = directory.segment_paths(seg_id)
    checksums: dict[str, int] = {}

    def _write(key: str, path: str, payload: bytes) -> None:
        # checksum the buffer in hand — re-reading multi-GB files just
        # written (segment.py's pattern) doubles a fold's IO
        storage.write_all(path, payload)
        checksums[key] = crc32(payload)

    _write("terms", paths.terms, write_terms(postings.terms))
    _write("postings", paths.postings, postings.to_bytes())
    _write("fast", paths.fast, fast.to_bytes())
    doc_bytes, doc_offsets = _merge_docstore(readers, lives, compress)
    _write("docstore", paths.docstore, doc_bytes)

    has_vectors = False
    vector_meta: dict[str, dict] = {}
    for vf in schema.vector_fields:
        rows = np.zeros((n_total, vf.dim), dtype=np.float32)
        present = np.zeros(n_total, dtype=bool)
        base = 0
        for r, live in zip(readers, lives):
            n_live = int(live.sum())
            vdata = r.vectors.get(vf.name)
            if vdata is not None:
                rows[base:base + n_live] = vdata.vectors[live]
                present[base:base + n_live] = vdata.present[live]
            base += n_live
        buf = io.BytesIO()
        np.savez(buf, vectors=rows, present=present)
        _write(f"vector_{vf.name}",
               directory.vector_paths(paths, vf.name), buf.getvalue())
        vector_meta[vf.name] = {"dim": vf.dim, "metric": vf.metric,
                                "vectors": int(present.sum())}
        has_vectors = True

    codec = resolve_codec(compress)
    seg_file_meta = {
        "doc_offsets": doc_offsets,
        "doc_ids": doc_ids,
        "avg_field_lengths": avg_field_lengths,
        "vector_fields": vector_meta,
        "compress": codec or False,
        "enable_positions": has_positions,
        "doc_id_field": schema.doc_id_field,
    }
    _write("meta", paths.meta, json.dumps(seg_file_meta).encode())

    return SegmentMeta(
        id=seg_id,
        generation=generation,
        doc_count=n_total,
        max_doc_id=max(n_total - 1, 0),
        blockmax=True,
        deleted_docs=[],
        avg_field_lengths=avg_field_lengths,
        checksums=checksums,
        has_vectors=has_vectors,
    )
