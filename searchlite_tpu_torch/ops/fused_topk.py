"""Fused dense scoring + mask + top-k: the tail of the dense scorers.

The port of ``searchlite_tpu/ops/pallas_topk.py::_kernel`` (entry
``make_fused_topk``) and of the JAX scorer tails it was written for
(``ops/impact.py::_score_m`` and ``make_split_impact_scorer``). Per query
row: ``score = W1 @ M1 (+ W2 @ M2)``, docs with ``score > 0``, not
deleted and (with filters) passing the query's filter row stay, and the
top-k of those by (score desc, doc asc) comes back with -inf past the
row's matches, at any k up to the doc axis. Entries that are -inf carry
the dead doc slot ``N-1`` as their id.

:func:`fused_topk` dispatches on the tensors' device: CPU tensors take
:func:`fused_topk_plain`, CUDA tensors the hand-written Hopper kernel
(``csrc/fused_topk.cu``). There is no fallback between the two. Both sum
in f32 (the plain version with TF32 off), in different orders, so scores
agree to f32 reassociation (divergence D10).

``M1`` and ``M2`` may each be f32 or bf16 (the resident dense rows under
``SEARCHLITE_PRECISION=bf16``, beside an f32 ``M2``); ``W1`` / ``W2`` stay
f32, rounded by the caller where the JAX scorer rounds them. The kernel
widens each bf16 element where it loads it; the plain version widens the
bf16 operands to f32 before its product (``torch.matmul`` on bf16 tensors
would round its result to bf16). ``COUNTS`` counts launches with two f32
operands, ``COUNTS_BF16`` launches with a bf16 one.
"""

from __future__ import annotations

import ctypes

import torch

from searchlite_tpu_torch.ops.strip_topk import LaunchCounts

COUNTS = LaunchCounts()
COUNTS_BF16 = LaunchCounts()

# the kernel's doc chunk (csrc/fused_topk.cu kChunk): each (query, chunk)
# keeps its top min(k, CHUNK) candidates for the row's selection
CHUNK = 1024


def _check(w1, m1, deleted, k, w2, m2, filter_rows, fidx):
    if w1.dim() != 2 or m1.dim() != 2 or w1.shape[1] != m1.shape[0]:
        raise ValueError(f"w1 {tuple(w1.shape)} @ m1 {tuple(m1.shape)} "
                         "is not a matrix product")
    q, n = w1.shape[0], m1.shape[1]
    if (w2 is None) != (m2 is None):
        raise ValueError("w2 and m2 come together")
    if w2 is not None and (w2.dim() != 2 or m2.dim() != 2
                           or w2.shape[0] != q or m2.shape[1] != n
                           or w2.shape[1] != m2.shape[0]):
        raise ValueError(f"w2 {tuple(w2.shape)} @ m2 {tuple(m2.shape)} "
                         f"does not match [{q}, {n}]")
    mats = [w1, m1] + ([w2, m2] if w2 is not None else [])
    if any(t.dtype != torch.float32 for t in mats[::2]) or any(
            t.dtype not in (torch.float32, torch.bfloat16)
            for t in mats[1::2]):
        raise ValueError("w must be float32 and m float32 or bfloat16")
    if deleted.shape != (n,) or deleted.dtype != torch.bool:
        raise ValueError(f"deleted must be bool [{n}]")
    if (filter_rows is None) != (fidx is None):
        raise ValueError("filter_rows and fidx come together")
    if filter_rows is not None and (
            filter_rows.dim() != 2 or filter_rows.shape[1] != n
            or filter_rows.dtype != torch.bool or fidx.shape != (q,)
            or fidx.dtype != torch.int32):
        raise ValueError("filter_rows must be bool [F+1, N] and fidx "
                         "int32 [Q]")
    tensors = mats + [deleted] + ([filter_rows, fidx]
                                  if filter_rows is not None else [])
    if any(t.device != w1.device for t in tensors):
        raise ValueError("every operand must be on one device")
    if not 0 < k <= n:
        raise ValueError(f"k must be in [1, {n}], got {k}")


def fused_topk(w1: torch.Tensor, m1: torch.Tensor, deleted: torch.Tensor,
               *, k: int, w2: torch.Tensor | None = None,
               m2: torch.Tensor | None = None,
               filter_rows: torch.Tensor | None = None,
               fidx: torch.Tensor | None = None):
    """Top-k of ``W1 @ M1 (+ W2 @ M2)`` per row under the match, deletion
    and filter masks. ``deleted`` is bool [N]; ``filter_rows`` bool
    [F+1, N] with ``fidx`` int32 [Q] selecting each row's mask. Returns
    (scores [Q,k] f32, ids [Q,k] int32)."""
    _check(w1, m1, deleted, k, w2, m2, filter_rows, fidx)
    if w1.device.type == "cpu":
        _counts(m1, m2).plain += 1
        return fused_topk_plain(w1, m1, deleted, k=k, w2=w2, m2=m2,
                                filter_rows=filter_rows, fidx=fidx)
    if w1.device.type == "cuda":
        return _fused_topk_cuda(w1, m1, deleted, k=k, w2=w2, m2=m2,
                                filter_rows=filter_rows, fidx=fidx)
    raise NotImplementedError(
        f"fused_topk has no path for device {w1.device}")


def _counts(m1, m2) -> LaunchCounts:
    bf16 = m1.dtype == torch.bfloat16 or (
        m2 is not None and m2.dtype == torch.bfloat16)
    return COUNTS_BF16 if bf16 else COUNTS


def fused_topk_plain(w1, m1, deleted, *, k: int, w2=None, m2=None,
                     filter_rows=None, fidx=None):
    """The plain PyTorch version: ``torch.matmul`` (TF32 off) of the
    operands in f32 (a bf16 ``M`` widened first), the masks, a stable
    descending sort, the first k. (``torch.topk`` promises no tie order,
    so it is not used.)"""
    scores = torch.matmul(w1, m1.to(torch.float32))
    if w2 is not None:
        scores = scores + torch.matmul(w2, m2.to(torch.float32))
    ok = (scores > 0.0) & ~deleted[None, :]
    if filter_rows is not None:
        ok = ok & filter_rows[fidx.long()]
    masked = torch.where(ok, scores, float("-inf"))
    del scores, ok
    ts, pos = torch.sort(masked, dim=1, descending=True, stable=True)
    ts = ts[:, :k].contiguous()
    td = pos[:, :k].to(torch.int32)
    td[torch.isneginf(ts)] = m1.shape[1] - 1
    return ts, td


_LIB = None


def _set_signatures(lib):
    """Set the C signatures of a build of ``csrc/fused_topk.cu``."""
    lib.fused_topk_chunk.restype = ctypes.c_int
    lib.fused_topk_chunk.argtypes = []
    lib.fused_topk_workspace_bytes.restype = ctypes.c_longlong
    lib.fused_topk_workspace_bytes.argtypes = [ctypes.c_int] * 5
    fn = lib.fused_topk_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p, ctypes.c_longlong]
                   + [ctypes.c_void_p] * 3)
    # the bf16 entry; a build of an older source (tools/fused_ab.py) has
    # only the f32 one
    typed = getattr(lib, "fused_topk_launch_typed", None)
    if typed is not None:
        typed.restype = ctypes.c_int
        typed.argtypes = (fn.argtypes[:6] + [ctypes.c_int] * 2
                          + fn.argtypes[6:])
    return lib


def _lib():
    """The kernel library, built on first use."""
    global _LIB
    if _LIB is None:
        from searchlite_tpu_torch.ops._kernels import load

        _LIB = _set_signatures(load("fused_topk"))
    return _LIB


def _fused_topk_cuda(w1, m1, deleted, *, k: int, w2, m2, filter_rows,
                     fidx):
    tensors = [w1, m1, deleted] + [t for t in (w2, m2, filter_rows, fidx)
                                   if t is not None]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_topk needs contiguous operands")
    lib = _lib()
    q, n = w1.shape[0], m1.shape[1]
    k1 = m1.shape[0]
    k2 = 0 if m2 is None else m2.shape[0]
    dev = w1.device
    ts = torch.empty((q, k), dtype=torch.float32, device=dev)
    td = torch.empty((q, k), dtype=torch.int32, device=dev)
    if q == 0:
        return ts, td
    ws_bytes = lib.fused_topk_workspace_bytes(q, n, k1, k2, k)
    ws = torch.empty((ws_bytes,), dtype=torch.uint8, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    counts = _counts(m1, m2)
    # f32 operands keep the f32 entry; a bf16 one takes the typed entry
    types = () if counts is COUNTS else (
        int(m1.dtype == torch.bfloat16),
        int(m2 is not None and m2.dtype == torch.bfloat16))
    launch = lib.fused_topk_launch_typed if types else lib.fused_topk_launch
    with torch.cuda.device(dev):  # launch on the operands' card
        err = launch(
            w1.data_ptr(), m1.data_ptr(), k1, ptr(w2), ptr(m2), k2, *types,
            deleted.data_ptr(), ptr(filter_rows), ptr(fidx), q, n, k,
            ws.data_ptr(), ws_bytes, ts.data_ptr(), td.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_topk launch failed: cudaError {err} "
                           f"(Q={q}, N={n}, k={k}, M {m1.dtype})")
    counts.launches += 1
    return ts, td
