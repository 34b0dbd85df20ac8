"""Strip core: sort + duplicate-doc combine + top-k over candidate strips.

The port of ``searchlite_tpu/ops/pallas_strip.py::_strip_kernel`` (and of
the JAX default sort core in ``ops/sparse.py::_candidate_core``). Per row
of a ``[B, L]`` strip of (doc int32, weighted impact f32): sort by doc,
sum equal-doc runs of at most ``2**log2_run`` lanes with shifted adds
(the total lands on the run's last lane), keep run ends whose doc is not
the sentinel ``n1-1`` and whose value is > 0, count them, and return the
top-k by (score desc, doc asc) with -inf padding.

:func:`strip_topk` dispatches on the tensors' device: CPU tensors take
:func:`strip_topk_plain`, CUDA tensors the hand-written Hopper kernel
(``csrc/strip_topk.cu``). There is no fallback between the two. Both are
bit-identical on finite entries: the kernel sorts on (doc, original lane),
which is the stable sort's order, so each run adds the same values in
the same order.
"""

from __future__ import annotations

import ctypes

import torch

from searchlite_tpu.ops.impact import next_pow2


class LaunchCounts:
    """How often each path of a wrapper ran: ``launches`` counts kernel
    launches (CUDA tensors), ``plain`` counts plain-version calls."""

    def __init__(self) -> None:
        self.launches = 0
        self.plain = 0

    def reset(self) -> None:
        self.launches = 0
        self.plain = 0


COUNTS = LaunchCounts()


def _sent_tensor(sent, device) -> torch.Tensor:
    if isinstance(sent, torch.Tensor):
        if sent.numel() != 1 or sent.dtype != torch.int32:
            raise ValueError("sent must be one int32 value")
        return sent.reshape(1)
    return torch.tensor([int(sent)], dtype=torch.int32, device=device)


def _check(d: torch.Tensor, v: torch.Tensor, k: int, log2_run: int):
    if d.dim() != 2 or d.shape != v.shape:
        raise ValueError(f"d {tuple(d.shape)} and v {tuple(v.shape)} "
                         "must be the same [B, L] shape")
    if d.dtype != torch.int32 or v.dtype != torch.float32:
        raise ValueError("d must be int32 and v float32")
    if d.device != v.device:
        raise ValueError("d and v must be on one device")
    if k <= 0 or log2_run < 0:
        raise ValueError("k must be > 0 and log2_run >= 0")


def strip_topk(d: torch.Tensor, v: torch.Tensor, sent, *, k: int,
               log2_run: int, with_counts: bool = False):
    """Top-k of each strip row. ``sent`` is the dead doc slot (an int or
    one int32 on the strip's device). Returns (ts [B,k] f32, td [B,k]
    int32[, counts [B] int32]); entries past a row's matches are -inf
    (their ids are unspecified)."""
    _check(d, v, k, log2_run)
    sent_t = _sent_tensor(sent, d.device)
    if sent_t.device != d.device:
        raise ValueError("sent must be on the strip's device")
    if d.device.type == "cpu":
        COUNTS.plain += 1
        out = strip_topk_plain(d, v, sent_t, k=k, log2_run=log2_run)
    elif d.device.type == "cuda":
        out = _strip_topk_cuda(d, v, sent_t, k=k, log2_run=log2_run)
    else:
        raise NotImplementedError(
            f"strip_topk has no path for device {d.device}")
    return out if with_counts else out[:2]


def strip_topk_plain(d: torch.Tensor, v: torch.Tensor, sent, *, k: int,
                     log2_run: int):
    """The plain PyTorch version: stable sort by doc, the shifted-add
    combine, a stable descending sort of the masked scores, the first k.
    (``torch.topk`` promises no tie order, so it is not used.) Returns
    (ts, td, counts)."""
    B, L = d.shape
    ds, order = torch.sort(d, dim=1, stable=True)
    vs = torch.gather(v, 1, order)
    off = 1
    for _ in range(log2_run):
        same = ds[:, off:] == ds[:, :-off]
        vs = torch.cat(
            [vs[:, :off], vs[:, off:] + torch.where(same, vs[:, :-off], 0.0)],
            dim=1)
        off *= 2
    run_end = torch.cat(
        [ds[:, 1:] != ds[:, :-1],
         torch.ones((B, min(L, 1)), dtype=torch.bool, device=d.device)],
        dim=1)
    ok = run_end & (ds != sent) & (vs > 0.0)
    score = torch.where(ok, vs, float("-inf"))
    ss, pos = torch.sort(score, dim=1, descending=True, stable=True)
    ts = ss[:, :k]
    td = torch.gather(ds, 1, pos[:, :k])
    if ts.shape[1] < k:  # strip narrower than k
        pad = k - ts.shape[1]
        ts = torch.cat([ts, torch.full((B, pad), float("-inf"),
                                       device=d.device)], dim=1)
        td = torch.cat([td, sent.reshape(1, 1).expand(B, pad)], dim=1)
    return ts, td, ok.sum(dim=1, dtype=torch.int32)


def _strip_topk_cuda(d, v, sent, *, k: int, log2_run: int):
    from searchlite_tpu_torch.ops._kernels import load

    lib = load("strip_topk")
    fn = lib.strip_topk_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 5)
    if not (d.is_contiguous() and v.is_contiguous()):
        raise ValueError("strip_topk needs contiguous d and v")
    B, L = d.shape
    L2 = next_pow2(L)
    ts = torch.empty((B, k), dtype=torch.float32, device=d.device)
    td = torch.empty((B, k), dtype=torch.int32, device=d.device)
    counts = torch.empty((B,), dtype=torch.int32, device=d.device)
    scratch = None
    if L2 > lib.strip_topk_smem_lanes():
        scratch = torch.empty((B, 3, L2), dtype=torch.int32,
                              device=d.device)
    stream = torch.cuda.current_stream(d.device).cuda_stream
    err = fn(d.data_ptr(), v.data_ptr(), sent.data_ptr(), B, L, L2, k,
             log2_run, ts.data_ptr(), td.data_ptr(), counts.data_ptr(),
             None if scratch is None else scratch.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"strip_topk launch failed: cudaError {err} "
                           f"(B={B}, L={L}, k={k})")
    if B:
        COUNTS.launches += 1
    return ts, td, counts
