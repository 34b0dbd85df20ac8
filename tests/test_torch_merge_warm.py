"""Warm-before-swap on structural merge in the port
(searchlite_tpu_torch/index/__init__.py::Index._warm_fold), after
tests/test_merge_warm.py, on the CPU (``index.device = "cpu"``).

The contract: (a) the merged segment is already in the process-wide
segment cache, on the index's device, when the first real reader opens;
(b) the warm never changes results and never breaks a merge, also on
term-free schemas; (c) the warm searches the pre-swap snapshot; (d) a
warm that fails is logged, not raised."""

import numpy as np

from searchlite_tpu_torch.api import reader as reader_mod
from searchlite_tpu_torch.api.types import IndexOptions, StorageType
from searchlite_tpu_torch.device import index as device_mod
from searchlite_tpu_torch.index import Index
from searchlite_tpu_torch.index.manifest import Schema

SCHEMA = {
    "text_fields": [{"name": "body", "analyzer": "default",
                     "stored": True, "indexed": True}],
}

VOCAB = [f"w{i}" for i in range(40)]


def new_index():
    idx = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY),
        Schema.from_json(SCHEMA))
    idx.device = "cpu"
    return idx


def build(chunks, monkeypatch=None, warm="1"):
    if monkeypatch is not None:
        monkeypatch.setenv("SEARCHLITE_MERGE_WARM", warm)
    idx = new_index()
    rng = np.random.default_rng(3)
    it = 0
    for chunk in chunks:
        w = idx.writer()
        for _ in range(chunk):
            w.add_document({
                "_id": str(it),
                "body": " ".join(rng.choice(VOCAB, size=8))})
            it += 1
        w.commit()
    return idx


def cached_ids(device="cpu"):
    with device_mod._LOCK:
        return {k[0] for k in device_mod._SEGMENTS if k[4] == device}


def test_warm_populates_segment_cache(monkeypatch):
    idx = build([30, 30, 30], monkeypatch)
    assert idx.merge_segments() == 3
    meta = idx.manifest.segments[-1]
    assert meta.id in cached_ids(), \
        "warm-before-swap must leave the fold in the segment cache"


def test_warm_off_leaves_cache_cold(monkeypatch):
    idx = build([30, 30], monkeypatch, warm="0")
    assert idx.merge_segments() == 2
    assert idx.manifest.segments[-1].id not in cached_ids()


def test_warm_off_is_equivalent(monkeypatch):
    out = {}
    for warm in ("1", "0"):
        idx = build([25, 25], monkeypatch, warm=warm)
        assert idx.merge_segments() == 2
        res = idx.reader().search({"query": "w3 w7", "limit": 10})
        out[warm] = [(h.doc_id, h.score) for h in res.hits]
    assert out["1"] == out["0"] and out["1"]


def test_warm_survives_termless_segments(monkeypatch):
    # empty-body docs: the fold has no terms to warm with -- the warm
    # must silently no-op, not fail the merge
    monkeypatch.setenv("SEARCHLITE_MERGE_WARM", "1")
    idx = new_index()
    for chunk in (5, 5):
        w = idx.writer()
        for i in range(chunk):
            w.add_document({"_id": f"{chunk}-{i}", "body": ""})
        w.commit()
    assert idx.merge_segments() == 2
    assert idx.reader().search(
        {"query": "w1", "limit": 5}).total_hits_estimate == 0


def test_warm_search_runs_pre_swap_snapshot(monkeypatch):
    # while the warm runs, the LIVE manifest must still be pre-merge
    idx = build([20, 20], monkeypatch)
    seen = {}
    orig = reader_mod.IndexReader.search

    def spy(self, req, mesh=None):
        if "live_segments" not in seen:
            seen["live_segments"] = len(idx.manifest.segments)
        return orig(self, req, mesh=mesh)

    monkeypatch.setattr(reader_mod.IndexReader, "search", spy)
    assert idx.merge_segments() == 2
    assert seen["live_segments"] == 2
    assert len(idx.manifest.segments) == 1


def test_failed_warm_is_logged_not_raised(monkeypatch, caplog):
    idx = build([10, 10], monkeypatch)

    def boom(self, req, mesh=None):
        raise RuntimeError("warm search failed")

    monkeypatch.setattr(reader_mod.IndexReader, "search", boom)
    assert idx.merge_segments() == 2
    assert len(idx.manifest.segments) == 1
    assert "merge warm failed" in caplog.text
