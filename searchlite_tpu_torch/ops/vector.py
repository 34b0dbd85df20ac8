"""Exact vector similarity: one matrix product and a top-k, with opt-in
quantization.

The port of ``searchlite_tpu/ops/vector.py`` (``vector_topk``,
``quantize_int8``, the device cache, and ``vector_topk_sharded``, the
mesh form). Brute force over every present, unmasked vector: one
``[Q, dim] @ [dim, n_docs]`` product (``torch.matmul``: the JAX package
computes the similarity matrix with a plain dot outside any hand-written
kernel, and so does the port), then the top-k by (score desc, doc asc).

Quantization (opt-in per vector field via the schema):

- ``bf16``: vectors and queries ROUNDED to bfloat16, multiplied with f32
  accumulation. The operands are held as f32 tensors of bf16-representable
  values and multiplied in f32 with TF32 off: a product of two bf16 values
  is exact in f32, so this is the bf16 x bf16 -> f32 product (a bf16
  ``torch.matmul`` would round its result to bf16).
- ``int8``: symmetric per-vector quantization ``q = round(v * 127 /
  max|v|)`` with f32 scales; the dot accumulates the integer products and
  is rescaled ``dot * scale_v * scale_q`` in f32. ``torch.matmul`` has no
  integer product on CUDA: products are at most 127^2 = 16,129, so an f32
  product of the int8 values is exact while ``dim * 16,129 < 2^24``
  (dim <= :data:`INT8_F32_EXACT_DIM`); wider vectors multiply in f64
  (exact to 2^53). L2 uses the exact f32 norms with the quantized
  cross-term.

Metric semantics: ``cosine`` is the dot product over ingest-normalized
vectors, ``l2`` the negated euclidean distance (higher is better). Missing
vectors never match.

The buffers are cached on the ``VectorData`` object per (device,
quantization), and the mesh form's per-shard buffers per (quantization,
padded rows, mesh devices), so repeated searches upload only the query;
``DeviceSegment.evict_device_caches`` drops both.
"""

from __future__ import annotations

import numpy as np
import torch

from searchlite_tpu_torch.ops.score import _matmul_f32, topk_by_doc

# an f32 accumulation of int8 x int8 products is exact up to this width:
# dim * 127^2 < 2^24
INT8_F32_EXACT_DIM = (1 << 24) // (127 * 127)  # 1,040


def quantize_int8(vectors: np.ndarray):
    """Symmetric per-row int8: returns (q [N,D] int8, scale [N] f32)."""
    amax = np.abs(vectors).max(axis=1) if vectors.size else \
        np.zeros(vectors.shape[0], dtype=np.float32)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(vectors / scale[:, None]), -127, 127)
    return q.astype(np.int8), scale


def _operand(values: np.ndarray, quantization: str, device):
    """A product operand on ``device``: f32 as is, bf16 rounded to
    bfloat16 and widened back to f32, int8 codes as f32 (f64 past
    :data:`INT8_F32_EXACT_DIM`)."""
    t = torch.from_numpy(np.ascontiguousarray(values)).to(device)
    if quantization == "bf16":
        return t.to(torch.bfloat16).to(torch.float32)
    if quantization == "int8":
        wide = values.shape[1] > INT8_F32_EXACT_DIM
        return t.to(torch.float64 if wide else torch.float32)
    return t


def _device_vectors(vdata, quantization: str, device):
    """Upload (and cache on vdata) the buffers of one quantization level
    on ``device``: (vectors [N, D], v_scale [N] f32, v_sq [N] f32,
    present [N] bool)."""
    device = torch.device(device)
    cache = vdata.__dict__.setdefault("_torch_vectors", {})
    key = (str(device), quantization)
    hit = cache.get(key)
    if hit is not None:
        return hit
    vecs = vdata.vectors
    v_sq = np.sum(vecs.astype(np.float32) ** 2, axis=1)
    scale = np.ones(vecs.shape[0], dtype=np.float32)
    if quantization == "int8":
        vecs, scale = quantize_int8(vecs)
    entry = (_operand(vecs, quantization, device),
             torch.from_numpy(scale).to(device),
             torch.from_numpy(v_sq).to(device),
             torch.from_numpy(np.ascontiguousarray(vdata.present)).to(device))
    cache[key] = entry
    return entry


def vector_scores(vectors, v_scale, v_sq, present, mask, queries, q_scale,
                  *, metric: str, quantization: str):
    """The masked similarity matrix [Q, N] f32 on the operands' device:
    -inf where a vector is missing or masked out."""
    dots = _matmul_f32(queries, vectors.T)
    if quantization == "int8":
        dots = dots.to(torch.float32) * (q_scale[:, None] * v_scale[None, :])
    if metric == "cosine":
        sims = dots
    else:
        # -||v - q|| by the expanded square, with exact f32 norms
        # whatever the quantization
        qf = queries.to(torch.float32)
        if quantization == "int8":
            qf = qf * q_scale[:, None]
        q_sq = (qf ** 2).sum(dim=1)
        sims = -torch.sqrt(torch.clamp(
            v_sq[None, :] + q_sq[:, None] - 2.0 * dots, min=0.0))
    ok = (present & mask)[None, :]
    return torch.where(ok, sims, float("-inf"))


def vector_topk(vdata, mask: np.ndarray, queries: np.ndarray, k: int,
                metric: str, quantization: str | None = None,
                device="cuda"):
    """vdata: VectorData (vectors [N, D] f32 + present [N]). Top-k of the
    similarity of every ``queries`` row [Q, D] to the present vectors that
    ``mask`` [N] admits, equal scores lowest doc first. Returns (scores
    [Q, k] f32, ids [Q, k] int64) numpy, -inf past the matches."""
    quant = quantization or "none"
    n = vdata.vectors.shape[0]
    k = min(k, n) if n else 0
    if k == 0 or n == 0:
        q = queries.shape[0]
        return (np.zeros((q, 0), dtype=np.float32),
                np.zeros((q, 0), dtype=np.int64))
    device = torch.device(device)
    vectors, v_scale, v_sq, present = _device_vectors(vdata, quant, device)
    queries, q_scale = _prepare_query(queries, quant)
    masked = vector_scores(
        vectors, v_scale, v_sq, present,
        torch.from_numpy(np.ascontiguousarray(mask)).to(device),
        _operand(queries, quant, device).to(vectors.dtype),
        torch.from_numpy(q_scale).to(device),
        metric=metric, quantization=quant)
    scores, ids = topk_by_doc(masked, k)
    return scores.cpu().numpy(), ids.cpu().numpy().astype(np.int64)


def _prepare_query(queries: np.ndarray, quant: str):
    """(query operand values, q_scale) of ``queries`` at ``quant``."""
    queries = np.asarray(queries, dtype=np.float32)
    q_scale = np.ones(queries.shape[0], dtype=np.float32)
    if quant == "int8":
        queries, q_scale = quantize_int8(queries)
    return queries, q_scale


def vector_topk_sharded(vdata, mask: np.ndarray, queries: np.ndarray, k: int,
                        metric: str, mesh, quantization: str | None = None):
    """Mesh form of :func:`vector_topk` (JAX ``vector_topk_sharded``):
    vector rows, padded to a multiple of the shard count (pads absent),
    shard over the mesh (``parallel/query.py::make_sharded_vector_topk``);
    each shard's exact similarity and local top-k, then the merge. The
    same results as :func:`vector_topk`. Returns (scores [Q, k] f32, ids
    [Q, k] int64) numpy."""
    from searchlite_tpu_torch.parallel.query import make_sharded_vector_topk

    quant = quantization or "none"
    n = vdata.vectors.shape[0]
    k = min(k, n) if n else 0
    if k == 0 or n == 0:
        q = queries.shape[0]
        return (np.zeros((q, 0), dtype=np.float32),
                np.zeros((q, 0), dtype=np.int64))
    devs = mesh.shard_devices
    n_shards = len(devs)
    per = -(-n // n_shards)
    n_pad = per * n_shards
    cache = vdata.__dict__.setdefault("_torch_sharded", {})
    key = (quant, n_pad, mesh.key)
    entry = cache.get(key)
    if entry is None:
        vecs = vdata.vectors
        v_sq = np.zeros(n_pad, dtype=np.float32)
        v_sq[:n] = np.sum(vecs.astype(np.float32) ** 2, axis=1)
        present = np.zeros(n_pad, dtype=bool)
        present[:n] = vdata.present
        scale = np.ones(n_pad, dtype=np.float32)
        if quant == "int8":
            vecs, scale[:n] = quantize_int8(vecs)
        padded = np.zeros((n_pad, vecs.shape[1]), dtype=vecs.dtype)
        padded[:n] = vecs
        sl = [slice(d * per, (d + 1) * per) for d in range(n_shards)]
        entry = ([_operand(padded[s], quant, dev) for s, dev in zip(sl, devs)],
                 [torch.from_numpy(scale[s]).to(dev)
                  for s, dev in zip(sl, devs)],
                 [torch.from_numpy(v_sq[s]).to(dev)
                  for s, dev in zip(sl, devs)],
                 [torch.from_numpy(present[s]).to(dev)
                  for s, dev in zip(sl, devs)])
        cache[key] = entry
    vectors, v_scale, v_sq, present = entry
    mask_pad = np.zeros(n_pad, dtype=bool)
    mask_pad[:len(mask)] = mask
    qvals, q_scale = _prepare_query(queries, quant)
    run = make_sharded_vector_topk(mesh)
    scores, ids = run(vectors, v_scale, v_sq, present, mask_pad,
                      _operand(qvals, quant, mesh.device), q_scale, k=k,
                      metric=metric, quantization=quant)
    return scores.cpu().numpy(), ids.cpu().numpy().astype(np.int64)
