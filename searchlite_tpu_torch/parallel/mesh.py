"""Doc-sharded execution over a mesh of torch devices.

The counterpart of ``searchlite_tpu/parallel/mesh.py``. The JAX mesh is
single-controller: one Python call in one process shards a segment over
the chips with ``shard_map``, and collectives merge the shards' results.
The port keeps that shape without collectives, because the reader's API is
one call in one process and the items merged are small:

- :class:`Mesh` holds a ``[query, shard]`` grid of ``torch.device``;
  ``mesh.shape`` is ``{"query": Q, "shard": D}`` as in JAX. A device may
  appear more than once: four logical shards on one card are the
  counterpart of the JAX tests' virtual CPU devices, and each shard's
  tensors are its own.
- per-shard work runs on its shard's device (the kernel wrappers launch
  on their operands' card, on its current stream);
- ``all_gather`` + the final ``top_k`` become :func:`merge_topk`: the
  shards' lists concatenated on the mesh's first device, shard-major (so
  doc-ascending), and one top-k over unique int64 keys
  (``ops/score.py::topk_by_doc``), ties by score descending then doc
  ascending;
- ``psum`` / ``pmin`` / ``pmax`` are sums, minima and maxima on that
  device, and ``psum_scatter`` (the two dryrun scorers below) is each
  owner shard summing its doc slice of every shard's partials.
  Cross-device copies are ``.to(device, non_blocking=True)``.

:func:`make_sharded_scorer` (block-scatter BM25) and
:func:`make_sharded_impact_scorer` (flat postings, ``W @ M``) are the JAX
module's two sharded scorers as plain per-shard torch functions; the
reader's routes live in ``parallel/query.py``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from searchlite_tpu_torch.ops.impact import build_m
from searchlite_tpu_torch.ops.score import _matmul_f32, topk_by_doc


class Mesh:
    """A ``[query, shard]`` grid of torch devices (the JAX ``Mesh`` with
    axis names ``("query", "shard")``)."""

    axis_names = ("query", "shard")

    def __init__(self, devices):
        grid = tuple(tuple(torch.device(d) for d in row) for row in devices)
        if not grid or not grid[0] or len({len(r) for r in grid}) != 1:
            raise ValueError("a mesh needs a non-empty rectangular grid of "
                             "devices")
        self.devices = grid
        self.shape = {"query": len(grid), "shard": len(grid[0])}

    @property
    def shard_devices(self) -> tuple:
        """The devices of the shard axis (the first query row): where the
        reader's doc-sharded routes place their shards."""
        return self.devices[0]

    @property
    def device(self) -> torch.device:
        """The mesh's first device, where merges land."""
        return self.devices[0][0]

    @property
    def key(self) -> tuple:
        """Identifies the grid: caches of per-shard tensors key on it."""
        return tuple(str(d) for row in self.devices for d in row)

    def __repr__(self) -> str:
        return f"Mesh(shape={self.shape}, devices={list(self.key)})"


def visible_devices(device_type: str) -> list:
    """The visible devices of one type: every CUDA device, or the one
    CPU device torch has."""
    if device_type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(device_type)]


def make_mesh(n_devices: int | None = None, query_axis: int = 1,
              devices=None) -> Mesh:
    """A ``("query", "shard")`` mesh (JAX ``make_mesh``): over ``devices``
    (a list, which may name one device several times) or, by default,
    the visible CUDA devices; the first ``n_devices`` of them. With
    ``query_axis`` > 1 dividing the count, the grid is ``[query_axis,
    n / query_axis]``, else ``[1, n]``. Raises where no CUDA device is
    visible and no ``devices`` are given: the default is the card."""
    if devices is None:
        devices = visible_devices("cuda")
        if not devices:
            raise RuntimeError(
                "make_mesh() takes the visible CUDA devices, and there are "
                "none: pass devices= (e.g. [torch.device('cpu')] * 8)")
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if query_axis > 1 and n % query_axis == 0:
        rows, cols = query_axis, n // query_axis
    else:
        rows, cols = 1, n
    return Mesh([devices[r * cols:(r + 1) * cols] for r in range(rows)])


def parse_mesh_spec(spec, device=None):
    """``--mesh`` / ``SEARCHLITE_MESH`` value -> a mesh, or None when unset,
    disabled ("", "off", "none", "0") or when only one device would take
    part (the JAX package's one-device rule: a count of 1, or ``auto`` with
    one visible device). ``auto`` takes every visible device of the
    reader's type (``device``, default the card); an integer ``N > 1``
    places N shards round robin on them, so ``--mesh 4 --device cpu``
    builds four CPU shards and ``--mesh 4`` on one card four shards on it
    (where the JAX package would build a one-shard mesh: same answers).
    Shared by the CLI and the HTTP server."""
    if spec in (None, "", "off", "none", "0", 0):
        return None
    if spec == "auto":
        n = None
    else:
        try:
            n = int(spec)
        except (TypeError, ValueError):
            raise ValueError(
                f"invalid mesh spec {spec!r}: expected `auto` or a "
                "device count") from None
    if device is None:
        from searchlite_tpu_torch import default_device

        device = default_device()
    visible = visible_devices(torch.device(device).type)
    if (n or len(visible)) <= 1:
        return None
    if not visible:
        raise RuntimeError(f"a mesh of {n} shards on {device} needs a "
                           "visible CUDA device, and there is none")
    n = n or len(visible)
    return make_mesh(devices=[visible[i % len(visible)] for i in range(n)])


# -- per-shard helpers --------------------------------------------------------


def put(x, device: torch.device) -> torch.Tensor:
    """``x`` (a tensor or a numpy array) on ``device``."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device, non_blocking=True)


def part(x, d: int, n: int, device: torch.device, dim: int = 0):
    """Shard ``d`` of ``n`` equal slices of ``x`` along ``dim`` on
    ``device``; a list or tuple is taken as already per shard."""
    if isinstance(x, (list, tuple)):
        return x[d]
    size = x.shape[dim] // n
    if isinstance(x, np.ndarray):
        idx = [slice(None)] * x.ndim
        idx[dim] = slice(d * size, (d + 1) * size)
        return put(x[tuple(idx)], device)
    return put(x.narrow(dim, d * size, size).contiguous(), device)


def merge_topk(scores: list, ids: list, k: int, device: torch.device):
    """The ``all_gather`` + final ``top_k``: the shards' (scores, global
    ids) lists ([..., kk] each, in shard order) concatenated on ``device``
    and cut to the top ``min(k, D*kk)`` by (score desc, position asc). The
    layout is shard-major and each shard's list is (score desc, doc asc),
    so position order is doc order among equal scores. Returns (scores,
    ids) on ``device``."""
    cat_s = torch.cat([put(s, device) for s in scores], dim=-1)
    cat_i = torch.cat([put(i, device) for i in ids], dim=-1)
    fs, pos = topk_by_doc(cat_s, min(k, cat_s.shape[-1]))
    return fs, torch.gather(cat_i, -1, pos.long())


def pad_topk(scores: torch.Tensor, ids: torch.Tensor, k: int):
    """Pad a [Q, k'] result to k columns: -inf scores, id 0 (JAX
    ``parallel/query.py``'s tiny-strip pad)."""
    if scores.shape[-1] >= k:
        return scores, ids
    pad = (0, k - scores.shape[-1])
    return (torch.nn.functional.pad(scores, pad, value=-math.inf),
            torch.nn.functional.pad(ids, pad, value=0))


def shard_blocks(block_docs: np.ndarray, block_tfs: np.ndarray,
                 n_shards: int):
    """Pad the block arrays to a multiple of n_shards (padding rows are
    sentinel-only so they score zero)."""
    n_blocks, width = block_docs.shape
    per = -(-max(n_blocks, 1) // n_shards)
    total = per * n_shards
    docs = np.full((total, width), np.iinfo(np.int32).max, dtype=np.int32)
    tfs = np.zeros((total, width), dtype=np.float32)
    docs[:n_blocks] = block_docs
    tfs[:n_blocks] = block_tfs
    return docs, tfs, per


def block_bases(n_blocks_padded: int, n_shards: int) -> np.ndarray:
    per = n_blocks_padded // n_shards
    return (np.arange(n_shards, dtype=np.int32) * per)


def shard_flat_postings(docs_flat: np.ndarray, impacts_flat: np.ndarray,
                        n_shards: int):
    """Pad the flat posting arrays to a multiple of n_shards; padding
    rows carry zero impact so they never contribute."""
    nnz = len(docs_flat)
    per = -(-max(nnz, 1) // n_shards)
    total = per * n_shards
    docs = np.zeros(total, dtype=np.int32)
    imps = np.zeros(total, dtype=np.float32)
    docs[:nnz] = docs_flat
    imps[:nnz] = impacts_flat
    return docs, imps, per


def _psum_scatter(partials: list, slice_len: int, devices) -> list:
    """Each owner shard ``o`` sums its doc slice ``[o*L, (o+1)*L)`` of
    every shard's ``[..., n1]`` partial, on its own device."""
    out = []
    for o, dev in enumerate(devices):
        lo = o * slice_len
        acc = None
        for p in partials:
            piece = put(p[..., lo:lo + slice_len], dev)
            acc = piece if acc is None else acc + piece
        out.append(acc)
    return out


def make_sharded_scorer(mesh: Mesh, n1: int):
    """The sharded block-scatter BM25 scorer (JAX ``make_sharded_scorer``).

    Inputs: ``block_docs`` / ``block_tfs`` [B, 128] (sharded by rows),
    ``doc_len`` [F, n1], ``avgdl`` [F], ``deleted`` [n1] (replicated),
    ``q_blk`` / ``q_weight`` / ``q_field`` / ``q_valid`` [Q, T] (sharded
    over ``query``, holding GLOBAL block ids), ``k1``, ``b``,
    ``block_base`` [n_shards] (each shard's first global block). Each
    shard scores its own blocks into a partial [Q, n1]; the owner of each
    doc slice sums them (``psum_scatter``), masks unmatched and deleted
    docs, takes its local top-k, and the lists merge. Returns (scores
    [Q, k], ids [Q, k]) on the mesh's first device. ``n1`` must be a
    multiple of the shard count."""
    n_shards = mesh.shape["shard"]
    n_rows = mesh.shape["query"]
    if n1 % n_shards:
        raise ValueError("the doc space must pad to the shard count")
    slice_len = n1 // n_shards

    def partial_scores(block_docs, block_tfs, doc_len, avgdl, q_blk,
                       q_weight, q_field, q_valid, k1, b, base):
        n_local = block_docs.shape[0]
        n_docs = n1 - 1
        q = q_blk.shape[0]
        local = q_blk.long() - base
        ok_slot = q_valid & (local >= 0) & (local < n_local)
        local = torch.where(ok_slot, local, 0)
        docs = block_docs[local].long()                    # [Q, T, 128]
        tfs = block_tfs[local]
        ok = ok_slot[..., None] & (docs < n_docs)
        docs = torch.where(ok, docs, n_docs)
        fields = q_field.long()[..., None].expand_as(docs)
        dl = doc_len[fields, docs]
        avg = avgdl[q_field.long()][..., None]
        norm = torch.where(avg > 0, dl / torch.where(avg > 0, avg, 1.0),
                           1.0)
        denom = torch.clamp(tfs + k1 * (1.0 - b + b * norm), min=1e-6)
        sc = q_weight[..., None] * tfs * (k1 + 1.0) / denom
        sc = torch.where(ok, sc, 0.0)
        flat = (torch.arange(q, device=docs.device)[:, None, None] * n1
                + docs).reshape(-1)
        scores = torch.zeros(q * n1, dtype=torch.float32,
                             device=docs.device)
        scores.index_add_(0, flat, sc.reshape(-1))
        matched = torch.zeros(q * n1, dtype=torch.float32,
                              device=docs.device)
        matched.index_add_(0, flat, ok.reshape(-1).to(torch.float32))
        return scores.reshape(q, n1), matched.reshape(q, n1)

    def run(block_docs, block_tfs, doc_len, avgdl, deleted, q_blk,
            q_weight, q_field, q_valid, k1, b, block_base, *, k: int):
        k1, b = float(k1), float(b)
        bases = np.asarray(block_base.cpu() if isinstance(
            block_base, torch.Tensor) else block_base).astype(np.int64)
        row_scores, row_ids = [], []
        for qi, devs in enumerate(mesh.devices):
            parts_s, parts_m = [], []
            for d, dev in enumerate(devs):
                s, m = partial_scores(
                    part(block_docs, d, n_shards, dev),
                    part(block_tfs, d, n_shards, dev),
                    put(doc_len, dev), put(avgdl, dev),
                    *(part(x, qi, n_rows, dev)  # P("query", None)
                      for x in (q_blk, q_weight, q_field, q_valid)),
                    k1, b, int(bases[d]))
                parts_s.append(s)
                parts_m.append(m)
            my_scores = _psum_scatter(parts_s, slice_len, devs)
            my_matched = _psum_scatter(parts_m, slice_len, devs)
            loc_s, loc_i = [], []
            for d, dev in enumerate(devs):
                lo = d * slice_len
                dead = put(deleted, dev)[lo:lo + slice_len]
                masked = torch.where((my_matched[d] > 0) & ~dead[None, :],
                                     my_scores[d], -math.inf)
                s, i = topk_by_doc(masked, min(k, slice_len))
                loc_s.append(s)
                loc_i.append(i + lo)
            fs, fi = merge_topk(loc_s, loc_i, k, mesh.device)
            row_scores.append(fs)
            row_ids.append(fi)
        return torch.cat(row_scores), torch.cat(row_ids)

    return run


def make_sharded_impact_scorer(mesh: Mesh, n1: int):
    """The sharded impact-matmul scorer (JAX ``make_sharded_impact_
    scorer``): each shard densifies its slice of the flat postings into a
    partial M [S, n1] (``ops/impact.py::build_m`` over the slots' local
    ranges), the owner of each doc slice completes its columns
    (``psum_scatter``), runs ``W @ M_slice`` (f32, TF32 off), masks
    ``score > 0`` and not deleted, and takes its local top-k; the lists
    merge. Inputs: ``docs_flat`` / ``impacts_flat`` [D*per] (sharded),
    ``deleted`` [n1], ``slot_start`` / ``slot_len`` [S] (GLOBAL posting
    ranges), ``w`` [Q, S] (sharded over ``query``), ``posting_base``
    [n_shards]. Returns (scores [Q, k], ids [Q, k]) on the mesh's first
    device."""
    n_shards = mesh.shape["shard"]
    n_rows = mesh.shape["query"]
    if n1 % n_shards:
        raise ValueError("the doc space must pad to the shard count")
    slice_len = n1 // n_shards

    def run(docs_flat, impacts_flat, deleted, slot_start, slot_len, w,
            posting_base, *, k: int, p_pad: int):
        bases = np.asarray(posting_base.cpu() if isinstance(
            posting_base, torch.Tensor) else posting_base).astype(np.int64)
        row_scores, row_ids = [], []
        for qi, devs in enumerate(mesh.devices):
            partials = []
            for d, dev in enumerate(devs):
                docs = part(docs_flat, d, n_shards, dev)
                imps = part(impacts_flat, d, n_shards, dev)
                n_local = docs.shape[0]
                start = put(slot_start, dev).long() - int(bases[d])
                end = start + put(slot_len, dev).long()
                lo = torch.clamp(start, 0, n_local)
                ln = torch.clamp(torch.clamp(end, 0, n_local) - lo,
                                 min=0)
                partials.append(build_m(docs, imps, lo, ln, n1, p_pad))
            m_slices = _psum_scatter(partials, slice_len, devs)
            loc_s, loc_i = [], []
            for d, dev in enumerate(devs):
                lo = d * slice_len
                dead = put(deleted, dev)[lo:lo + slice_len]
                scores = _matmul_f32(part(w, qi, n_rows, dev),
                                     m_slices[d])
                masked = torch.where((scores > 0.0) & ~dead[None, :],
                                     scores, -math.inf)
                s, i = topk_by_doc(masked, min(k, slice_len))
                loc_s.append(s)
                loc_i.append(i + lo)
            fs, fi = merge_topk(loc_s, loc_i, k, mesh.device)
            row_scores.append(fs)
            row_ids.append(fi)
        return torch.cat(row_scores), torch.cat(row_ids)

    return run
