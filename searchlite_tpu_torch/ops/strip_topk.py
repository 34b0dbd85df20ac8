"""Strip core: duplicate-doc combine + top-k over candidate strips.

The port of ``searchlite_tpu/ops/pallas_strip.py::_strip_kernel`` together
with the gather that feeds it (``ops/sparse.py::_strip_gather``) and the
JAX default sort core of ``_candidate_core``. A row's candidate strip is
the concatenation of its term slots' posting blocks, each weighted by the
slot's weight; per row: sort by doc, sum equal-doc runs of at most
``2**log2_run`` lanes with shifted adds (the total lands on the run's last
lane), keep run ends whose doc is not the sentinel ``n1-1`` and whose
value is > 0, count them, and return the top-k by (score desc, doc asc)
with -inf padding.

:func:`strip_topk_blocks` is the entry and dispatches on the tensors'
device. CPU tensors take :func:`strip_topk_blocks_plain`: the gather
(:func:`strip_gather`) materialises the strip and :func:`strip_topk_plain`
sorts it. CUDA tensors take the hand-written Hopper kernel
(``csrc/strip_topk.cu``), which never materialises the strip: it reads the
posting blocks in place and searches the slots' pre-sorted doc runs. There
is no fallback between the two. They are bit-identical on finite entries:
the kernel sums each doc's slot values in the plain scan's tree order.

:func:`strip_lanes_blocks` returns every kept doc of the strip with its
score instead of a top-k, for a caller that reads the whole strip (the
single-query term split): on CUDA the kernel's tile pass without its row
merge, on the CPU the plain scan.

:func:`strip_topk` over an already gathered (d, v) strip is the plain
version alone, for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch


class LaunchCounts:
    """How often each path of a wrapper ran: ``launches`` counts kernel
    launches (CUDA tensors), ``plain`` counts plain-version calls."""

    def __init__(self) -> None:
        self.launches = 0
        self.plain = 0

    def reset(self) -> None:
        self.launches = 0
        self.plain = 0


class DeviceCalls:
    """How often a function ran, per device type of its tensors."""

    def __init__(self) -> None:
        self.calls: dict[str, int] = {}

    def add(self, device: torch.device) -> None:
        self.calls[device.type] = self.calls.get(device.type, 0) + 1

    def get(self, device_type: str) -> int:
        return self.calls.get(device_type, 0)

    def reset(self) -> None:
        self.calls.clear()


COUNTS = LaunchCounts()
# strip_lanes_blocks' launches (the tile pass alone) and plain calls
LANES_COUNTS = LaunchCounts()
# strip_gather's calls: on CUDA only the plain version, never the main path
GATHER_CALLS = DeviceCalls()


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
    """Top-k of each row of a gathered (d, v) strip, by the plain version.
    ``sent`` is the dead doc slot (an int or one int32 on the strip's
    device). Returns (ts [B,k] f32, td [B,k] int32[, counts [B] int32]);
    entries past a row's matches are -inf (their ids are unspecified).
    CPU tensors only: on the card the strip is never gathered, and
    :func:`strip_topk_blocks` reads the posting blocks in place."""
    _check(d, v, k, log2_run)
    sent_t = _sent_tensor(sent, d.device)
    if sent_t.device != d.device:
        raise ValueError("sent must be on the strip's device")
    if d.device.type != "cpu":
        raise NotImplementedError(
            f"strip_topk has no path for device {d.device}: gathered strips "
            "are the CPU plain version; use strip_topk_blocks")
    COUNTS.plain += 1
    out = strip_topk_plain(d, v, sent_t, k=k, log2_run=log2_run)
    return out if with_counts else out[:2]


def _strip_scan(d: torch.Tensor, v: torch.Tensor, sent, log2_run: int):
    """The plain scan: a stable sort by doc, the shifted-add combine, the
    kept run ends. Returns (ds [B, L] doc-sorted, score [B, L] with -inf
    off the kept lanes, ok [B, L] bool)."""
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
    return ds, torch.where(ok, vs, float("-inf")), ok


def strip_topk_plain(d: torch.Tensor, v: torch.Tensor, sent, *, k: int,
                     log2_run: int):
    """The plain PyTorch version: stable sort by doc, the shifted-add
    combine, a stable descending sort of the masked scores, the first k.
    (``torch.topk`` promises no tie order, so it is not used.) Returns
    (ts, td, counts)."""
    B = d.shape[0]
    ds, score, ok = _strip_scan(d, v, sent, log2_run)
    ss, pos = torch.sort(score, dim=1, descending=True, stable=True)
    ts = ss[:, :k]
    td = torch.gather(ds, 1, pos[:, :k])
    if ts.shape[1] < k:  # strip narrower than k
        pad = k - ts.shape[1]
        ts = torch.cat([ts, torch.full((B, pad), float("-inf"),
                                       device=d.device)], dim=1)
        td = torch.cat([td, sent.reshape(1, 1).expand(B, pad)], dim=1)
    return ts, td, ok.sum(dim=1, dtype=torch.int32)


def strip_gather(block_docs, block_impacts, bstart, bcnt, w, sentinel_row,
                 *, t_pad: int, nblk: int):
    """Gather each row's posting blocks into an UNSORTED candidate strip
    (``ops/sparse.py::_strip_gather``). ``bstart``/``bcnt`` [B, t_pad]
    int32 are per-slot block starts and counts (0 for unused slots), ``w``
    [B, t_pad] f32 the slot weights. Returns (d int32, v f32), both
    [B, nblk*128]. Part of the plain version only."""
    GATHER_CALLS.add(bstart.device)
    B = bstart.shape[0]
    dev = bstart.device
    cum = torch.cumsum(bcnt, dim=1, dtype=torch.int32)         # [B, T]
    total = cum[:, -1]
    pos = torch.arange(nblk, dtype=torch.int32, device=dev)
    # owning term slot per gathered block: #{t : cum[t] <= pos}
    t_of = (pos[None, None, :] >= cum[:, :, None]).sum(
        dim=1, dtype=torch.int32)                              # [B, nblk]
    valid = pos[None, :] < total[:, None]
    t_safe = t_of.clamp(max=t_pad - 1).long()
    begin = cum - bcnt
    blk = (torch.gather(bstart, 1, t_safe)
           + (pos[None, :] - torch.gather(begin, 1, t_safe)))
    blk_idx = torch.where(valid, blk, sentinel_row).long()
    w_blk = torch.gather(w, 1, t_safe)
    d = block_docs[blk_idx].reshape(B, nblk * 128)
    v = (block_impacts[blk_idx] * w_blk[:, :, None]).reshape(B, nblk * 128)
    return d, v


def _check_blocks(block_docs, block_impacts, bstart, bcnt, w, sent, k: int,
                  nblk: int, log2_run: int):
    if block_docs.dim() != 2 or block_docs.shape[1] != 128 \
            or block_impacts.shape != block_docs.shape:
        raise ValueError(f"block_docs {tuple(block_docs.shape)} and "
                         f"block_impacts {tuple(block_impacts.shape)} must "
                         "be the same [R, 128] shape")
    if bstart.dim() != 2 or bcnt.shape != bstart.shape \
            or w.shape != bstart.shape:
        raise ValueError("bstart, bcnt and w must be the same [B, t_pad] "
                         "shape")
    if (block_docs.dtype, block_impacts.dtype, bstart.dtype, bcnt.dtype,
            w.dtype) != (torch.int32, torch.float32, torch.int32,
                         torch.int32, torch.float32):
        raise ValueError("block_docs, bstart, bcnt must be int32 and "
                         "block_impacts, w float32")
    if sent.shape != (2,) or sent.dtype != torch.int32:
        raise ValueError("sent must be int32 [2] (sentinel block row, "
                         "dead doc slot)")
    tensors = (block_docs, block_impacts, bstart, bcnt, w, sent)
    if any(t.device != bstart.device for t in tensors):
        raise ValueError("every operand must be on one device")
    if k <= 0 or nblk <= 0 or log2_run < 0 or bstart.shape[1] < 1:
        raise ValueError("k, nblk and t_pad must be > 0, log2_run >= 0")


def strip_topk_blocks(block_docs: torch.Tensor, block_impacts: torch.Tensor,
                      bstart: torch.Tensor, bcnt: torch.Tensor,
                      w: torch.Tensor, sent: torch.Tensor, *, k: int,
                      nblk: int, log2_run: int, with_counts: bool = False):
    """Top-k of each row's candidate strip, read from the posting blocks:
    ``block_docs`` [R, 128] int32 and ``block_impacts`` [R, 128] f32 (the
    segment's, tombstones zeroed); per row ``bstart``/``bcnt`` [B, t_pad]
    int32 block ranges and ``w`` [B, t_pad] f32 slot weights; ``sent``
    [2] int32 (sentinel block row, dead doc slot ``n1-1``); ``nblk`` the
    strip's width in blocks. Returns (ts [B,k] f32, td [B,k] int32[,
    counts [B] int32]); entries past a row's matches are -inf.

    The CUDA kernel needs each slot's docs ascending, each live doc at
    most once per slot, and sentinel docs only at the tail of a slot's
    last block -- what real segments hold by construction."""
    _check_blocks(block_docs, block_impacts, bstart, bcnt, w, sent, k, nblk,
                  log2_run)
    if bstart.device.type == "cpu":
        COUNTS.plain += 1
        out = strip_topk_blocks_plain(block_docs, block_impacts, bstart,
                                      bcnt, w, sent, k=k, nblk=nblk,
                                      log2_run=log2_run)
    elif bstart.device.type == "cuda":
        out = _strip_topk_blocks_cuda(block_docs, block_impacts, bstart,
                                      bcnt, w, sent, k=k, nblk=nblk,
                                      log2_run=log2_run)
    else:
        raise NotImplementedError(
            f"strip_topk_blocks has no path for device {bstart.device}")
    return out if with_counts else out[:2]


def strip_topk_blocks_plain(block_docs, block_impacts, bstart, bcnt, w,
                            sent, *, k: int, nblk: int, log2_run: int):
    """The plain version: :func:`strip_gather` then
    :func:`strip_topk_plain`. Returns (ts, td, counts)."""
    d, v = strip_gather(block_docs, block_impacts, bstart, bcnt, w, sent[0],
                        t_pad=bstart.shape[1], nblk=nblk)
    return strip_topk_plain(d, v, sent[1:2], k=k, log2_run=log2_run)


_LAUNCH = None  # (top-k launch fn, tile lanes, max slots, sort smem keys,
#                  all-lanes launch fn)


def _launcher():
    """The kernel's launch functions and geometry, read once."""
    global _LAUNCH
    if _LAUNCH is None:
        from searchlite_tpu_torch.ops._kernels import load

        lib = load("strip_topk")
        fn = lib.strip_topk_blocks_launch
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p] * 7)
        lanes = lib.strip_lanes_blocks_launch
        lanes.restype = ctypes.c_int
        lanes.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                          + [ctypes.c_void_p] * 4)
        _LAUNCH = (fn, lib.strip_topk_tile_lanes(),
                   lib.strip_topk_max_slots(),
                   lib.strip_topk_sort_smem_keys(), lanes)
    return _LAUNCH


def _n_tiles(nblk: int, t_pad: int, tile_lanes: int) -> int:
    """Tiles a row's strip may take: a slot's blocks split into tiles of
    tile_lanes / 128 blocks."""
    tile_blocks = tile_lanes // 128
    return max((nblk + (tile_blocks - 1) * t_pad) // tile_blocks, 1)


def _check_cuda_operands(block_docs, block_impacts, bstart, bcnt, w, sent,
                         log2_run: int, max_slots: int):
    tensors = (block_docs, block_impacts, bstart, bcnt, w, sent)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the strip kernel needs contiguous operands")
    if block_docs.data_ptr() % 16 or block_impacts.data_ptr() % 16:
        raise ValueError("block_docs and block_impacts must be 16-byte "
                         "aligned")
    if bstart.shape[1] > max_slots or log2_run > 8:
        raise ValueError(f"t_pad {bstart.shape[1]} / log2_run {log2_run} "
                         "past the kernel's slot table")


def _strip_topk_blocks_cuda(block_docs, block_impacts, bstart, bcnt, w,
                            sent, *, k: int, nblk: int, log2_run: int):
    fn, tile_lanes, max_slots, sort_smem, _lanes = _launcher()
    _check_cuda_operands(block_docs, block_impacts, bstart, bcnt, w, sent,
                         log2_run, max_slots)
    B, t_pad = bstart.shape
    dev = bstart.device
    kt = min(tile_lanes, max(16, k))
    n_tiles = max(_n_tiles(nblk, t_pad, tile_lanes), -(-k // kt))
    k2 = 1 << (k - 1).bit_length()  # the next power of two >= k
    # one allocation: the candidate keys, then ts, td, counts and the
    # per-tile counts as 32-bit words
    n_cand = B * n_tiles * kt
    n32 = 2 * B * k + B + B * n_tiles
    buf = torch.empty((n_cand + (n32 + 1) // 2,), dtype=torch.int64,
                      device=dev)
    words = buf[n_cand:].view(torch.int32)
    ts = words[:B * k].view(torch.float32).view(B, k)
    td = words[B * k:2 * B * k].view(B, k)
    counts = words[2 * B * k:2 * B * k + B]
    if B == 0:
        return ts, td, counts
    tile_counts = words[2 * B * k + B:n32]
    scratch = None
    if k2 > sort_smem:
        scratch = torch.empty((B, k2), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(block_docs.data_ptr(), block_impacts.data_ptr(),
             bstart.data_ptr(), bcnt.data_ptr(), w.data_ptr(),
             sent.data_ptr(), B, t_pad, nblk, k, k2, log2_run, kt, n_tiles,
             buf.data_ptr(), tile_counts.data_ptr(), ts.data_ptr(),
             td.data_ptr(), counts.data_ptr(),
             None if scratch is None else scratch.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"strip_topk launch failed: cudaError {err} "
                           f"(B={B}, t_pad={t_pad}, nblk={nblk}, k={k})")
    COUNTS.launches += 1
    return ts, td, counts


def strip_lanes_blocks(block_docs: torch.Tensor, block_impacts: torch.Tensor,
                       bstart: torch.Tensor, bcnt: torch.Tensor,
                       w: torch.Tensor, sent: torch.Tensor, *, nblk: int,
                       log2_run: int):
    """Every kept doc of each row's candidate strip with its summed score,
    in no set order, for callers that read the whole strip (the
    single-query term split): the operands as :func:`strip_topk_blocks`'s.
    Returns (scores [B, n] f32, docs [B, n] int32, counts [B] int32):
    each kept doc once with its score, -inf elsewhere (the dead doc
    ``sent[1]`` there), ``n`` at least the strip's width.

    CPU tensors take :func:`strip_lanes_blocks_plain` (the plain scan,
    doc-ordered); CUDA tensors the strip kernel's tile pass alone, writing
    (score, doc) per lane with no keys and no row merge -- the same kept
    (doc, score) set bit for bit, in lane order."""
    _check_blocks(block_docs, block_impacts, bstart, bcnt, w, sent, 1, nblk,
                  log2_run)
    if bstart.device.type == "cpu":
        LANES_COUNTS.plain += 1
        return strip_lanes_blocks_plain(block_docs, block_impacts, bstart,
                                        bcnt, w, sent, nblk=nblk,
                                        log2_run=log2_run)
    if bstart.device.type != "cuda":
        raise NotImplementedError(
            f"strip_lanes_blocks has no path for device {bstart.device}")
    return _strip_lanes_blocks_cuda(block_docs, block_impacts, bstart, bcnt,
                                    w, sent, nblk=nblk, log2_run=log2_run)


def strip_lanes_blocks_plain(block_docs, block_impacts, bstart, bcnt, w,
                             sent, *, nblk: int, log2_run: int):
    """The plain version: :func:`strip_gather`, then the plain scan's kept
    run ends. Returns (scores, docs, counts)."""
    d, v = strip_gather(block_docs, block_impacts, bstart, bcnt, w, sent[0],
                        t_pad=bstart.shape[1], nblk=nblk)
    ds, score, ok = _strip_scan(d, v, sent[1:2], log2_run)
    return (score, torch.where(ok, ds, sent[1:2]),
            ok.sum(dim=1, dtype=torch.int32))


def _strip_lanes_blocks_cuda(block_docs, block_impacts, bstart, bcnt, w,
                             sent, *, nblk: int, log2_run: int):
    _fn, tile_lanes, max_slots, _smem, lanes = _launcher()
    _check_cuda_operands(block_docs, block_impacts, bstart, bcnt, w, sent,
                         log2_run, max_slots)
    B, t_pad = bstart.shape
    n_tiles = _n_tiles(nblk, t_pad, tile_lanes)
    dev = bstart.device
    scores = torch.empty((B, n_tiles * tile_lanes), dtype=torch.float32,
                         device=dev)
    docs = torch.empty((B, n_tiles * tile_lanes), dtype=torch.int32,
                       device=dev)
    tile_counts = torch.empty((B, n_tiles), dtype=torch.int32, device=dev)
    if B:
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lanes(block_docs.data_ptr(), block_impacts.data_ptr(),
                    bstart.data_ptr(), bcnt.data_ptr(), w.data_ptr(),
                    sent.data_ptr(), B, t_pad, nblk, log2_run, n_tiles,
                    scores.data_ptr(), docs.data_ptr(),
                    tile_counts.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"strip_lanes launch failed: cudaError {err} "
                               f"(B={B}, t_pad={t_pad}, nblk={nblk})")
        LANES_COUNTS.launches += 1
    return scores, docs, tile_counts.sum(dim=1, dtype=torch.int32)
