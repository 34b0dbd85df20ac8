"""Index directory layout.

Parity with searchlite-core `index/directory.rs:12-46`: one directory per
index holding ``wal.log``, ``MANIFEST.json`` and per-segment files
``seg_<id>.{terms,post,docs,fast,meta}`` plus ``seg_<id>_vectors/``.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class SegmentPaths:
    terms: str
    postings: str
    docstore: str
    fast: str
    meta: str
    vector_dir: str

    def all_files(self) -> list[str]:
        return [self.terms, self.postings, self.docstore, self.fast, self.meta]


def segment_paths(segment_id: str) -> SegmentPaths:
    base = f"seg_{segment_id}"
    return SegmentPaths(
        terms=f"{base}.terms",
        postings=f"{base}.post",
        docstore=f"{base}.docs",
        fast=f"{base}.fast",
        meta=f"{base}.meta",
        vector_dir=f"{base}_vectors",
    )


def vector_paths(paths: SegmentPaths, field: str) -> str:
    return f"{paths.vector_dir}/{field}.npz"
