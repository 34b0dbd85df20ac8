"""A/B of the fused score + mask + top-k kernel against another build.

    python -m searchlite_tpu_torch.tools.fused_ab --other DIR [--profile]

Run from the repository root on a machine with an NVIDIA GPU. ``DIR``
holds another tree's ``searchlite_tpu_torch/csrc/`` (``git archive
<commit> searchlite_tpu_torch/csrc | tar -x -C DIR``, or an edited copy):
its ``fused_topk.cu`` is built beside the current one and called through
whichever C interface it has (this one's, or the earlier per-tile one:
row lists per 64-query tile, KC candidates per 128-doc chunk). At each
of ``chip_smoke.FUSED_SHAPES`` and at edge shapes, on the same seeded
inputs:

1. the current kernel against the other one: ids equal and finite
   scores equal bit for bit (and against the plain version within the
   f32_strict tolerance);
2. CUDA-event times in turns other, current, current, other, beside
   the plain version and ``torch.matmul`` (TF32 off) of the score part on
   the concatenated operands, the library yardstick;
3. device time per kernel from ``torch.profiler``.

With ``--profile`` it also builds ``chip_smoke``'s 100k-doc index and
profiles the three under-budget batches through the reader (device busy
time, kernels by name, unprofiled wall). Prints one line per result and
writes everything to ``chiprun_out/fused_ab.json``; exits non-zero on any
disagreement.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np

from searchlite_tpu_torch.ops import _kernels

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# shapes beside FUSED_SHAPES: (name, Q, K1, K2, N, k, filter rows)
EDGE_SHAPES = [
    ("N not a multiple of the chunk", 40, 300, 64, 5000, 10, 3),
    ("k = chunk - 1", 16, 300, 64, 20000, 1023, 0),
    ("k = chunk", 16, 300, 64, 20000, 1024, 0),
    ("k = chunk + 1", 16, 300, 64, 20000, 1025, 2),
    ("Q not a multiple of the query group", 13, 200, 0, 8192, 10, 0),
    ("k > 16,384 (sort in scratch)", 4, 16, 8, 40000, 20000, 0),
    ("odd N, scalar loads", 9, 50, 7, 3001, 37, 2),
]


def _smoke():
    """``chip_smoke`` from the repository root (importing it blocks JAX and
    searchlite_tpu in this process)."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import chip_smoke

    return chip_smoke


def _device_events(prof, calls: int) -> dict[str, float]:
    """Self device time per call of each kernel in a profile, by name."""
    out: dict[str, float] = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        if t > 0 and "CUDA" in str(getattr(e, "device_type", "CUDA")):
            out[e.key] = out.get(e.key, 0.0) + t / 1000.0 / calls
    return out


def build_other(other_dir: str) -> ctypes.CDLL:
    csrc = os.path.join(other_dir, "searchlite_tpu_torch", "csrc")
    out_dir = os.path.join(REPO, "build", "kernels", "other")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "libfused_topk.so")
    cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", out,
           os.path.join(csrc, "fused_topk.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for the other kernel:\n"
                           f"{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(out)
    if hasattr(lib, "fused_topk_workspace_bytes"):
        from searchlite_tpu_torch.ops.fused_topk import _set_signatures

        _set_signatures(lib)
    return lib


def other_fused_topk(lib, w1, m1, deleted, *, k, w2=None, m2=None,
                     filter_rows=None, fidx=None):
    """The other build's launch, through its own C interface."""
    import torch

    if hasattr(lib, "fused_topk_workspace_bytes"):
        from searchlite_tpu_torch.ops import fused_topk as ft

        saved = ft._LIB
        try:
            ft._LIB = lib
            return ft._fused_topk_cuda(w1, m1, deleted, k=k, w2=w2, m2=m2,
                                       filter_rows=filter_rows, fidx=fidx)
        finally:
            ft._LIB = saved
    fn = lib.fused_topk_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 6)
    for name in ("fused_topk_chunk", "fused_topk_sort_smem_keys"):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = []
    q, n = w1.shape[0], m1.shape[1]
    dev = w1.device
    chunk = lib.fused_topk_chunk()
    ts = torch.empty((q, k), dtype=torch.float32, device=dev)
    td = torch.empty((q, k), dtype=torch.int32, device=dev)
    kc = min(chunk, max(16, k))
    n_chunks = -(-n // chunk)
    k2 = 1 << (k - 1).bit_length()
    k_rows = m1.shape[0] + (0 if m2 is None else m2.shape[0])
    rows = torch.empty((-(-q // 64) * (k_rows + 2),), dtype=torch.int32,
                       device=dev)
    cand = torch.empty((q, n_chunks * kc), dtype=torch.int64, device=dev)
    scratch = None
    if k2 > lib.fused_topk_sort_smem_keys():
        scratch = torch.empty((q, k2), dtype=torch.int64, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = fn(w1.data_ptr(), m1.data_ptr(), m1.shape[0], ptr(w2), ptr(m2),
             0 if m2 is None else m2.shape[0], deleted.data_ptr(),
             ptr(filter_rows), ptr(fidx), q, n, k, k2, kc, rows.data_ptr(),
             cand.data_ptr(), ts.data_ptr(), td.data_ptr(), ptr(scratch),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"other fused_topk failed: cudaError {err}")
    return ts, td


def edge_inputs(g, Q, K1, K2, N, nf):
    """Operands like chip_smoke.fused_inputs, with ragged widths, a query
    without any weight (row 0) and, with filters, a filter row that
    matches nothing (the last, given to row 1)."""
    w1, m1, deleted, kw = _smoke().fused_inputs(g, Q, K1, K2, N, nf)
    w1[0] = 0.0
    if "w2" in kw:
        kw["w2"][0] = 0.0
    if nf:
        kw["fidx"][1] = nf - 1
    return w1, m1, deleted, kw


def device_ms(fn, calls: int = 5) -> dict[str, float]:
    """Device time per call of each kernel ``fn`` launches, by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return _device_events(prof, calls)


def ab_shapes(other, results: list) -> None:
    import torch

    from searchlite_tpu_torch.ops.fused_topk import (
        fused_topk,
        fused_topk_plain,
    )

    chip_smoke = _smoke()
    g = torch.Generator(device="cuda")
    g.manual_seed(17)
    shapes = [(*s, True) for s in chip_smoke.FUSED_SHAPES] + \
        [(*s, False) for s in EDGE_SHAPES]
    for name, Q, K1, K2, N, k, nf, main in shapes:
        if main:
            w1, m1, deleted, kw = chip_smoke.fused_inputs(g, Q, K1, K2, N, nf)
        else:
            w1, m1, deleted, kw = edge_inputs(g, Q, K1, K2, N, nf)
        ts, td = fused_topk(w1, m1, deleted, k=k, **kw)
        os_, od = other_fused_topk(other, w1, m1, deleted, k=k, **kw)
        ps, pd = fused_topk_plain(w1, m1, deleted, k=k, **kw)
        torch.cuda.synchronize()
        ts, td, os_, od, ps, pd = (x.cpu().numpy()
                                   for x in (ts, td, os_, od, ps, pd))
        fin = np.isfinite(os_)
        same = (np.array_equal(np.isfinite(ts), fin)
                and np.array_equal(ts[fin].view(np.int32),
                                   os_[fin].view(np.int32))
                and np.array_equal(td, od))
        err = chip_smoke.same_topk(ps, pd, ts, td)
        if not main:
            if not np.isneginf(ts[0]).all() or not (td[0] == N - 1).all():
                raise AssertionError(f"{name}: the weightless row matched")
            if nf and not np.isneginf(ts[1]).all():
                raise AssertionError(f"{name}: the empty filter matched")
        rec = {"name": name, "shape": [Q, K1, K2, N], "k": k,
               "filters": nf, "bit_identical_to_other": bool(same),
               "max_abs_err_vs_plain": err,
               "finite": int(np.isfinite(ts).sum())}
        if not same:
            results.append(rec)
            raise AssertionError(f"{name}: not bit-identical to the "
                                 "other kernel")
        if main:
            def cur():
                return fused_topk(w1, m1, deleted, k=k, **kw)

            def old():
                return other_fused_topk(other, w1, m1, deleted, k=k, **kw)

            iters = 10 if Q * N > 1 << 24 else 30
            t_old1 = chip_smoke.time_ms(old, iters)
            t_new1 = chip_smoke.time_ms(cur, iters)
            t_new2 = chip_smoke.time_ms(cur, iters)
            t_old2 = chip_smoke.time_ms(old, iters)
            t_plain = chip_smoke.time_ms(
                lambda: fused_topk_plain(w1, m1, deleted, k=k, **kw), 3)
            wcat = torch.cat([w1, kw["w2"]], 1) if "w2" in kw else w1
            mcat = torch.cat([m1, kw["m2"]], 0) if "m2" in kw else m1
            t_lib = chip_smoke.time_ms(lambda: torch.matmul(wcat, mcat), 3)
            del wcat, mcat
            ops, nbytes = chip_smoke.fused_work(w1, m1, deleted, k, **kw)
            bms, by = chip_smoke.bound_ms(ops, nbytes)
            rec.update({
                "other_ms": [t_old1, t_old2], "ms": [t_new1, t_new2],
                "plain_ms": t_plain, "library_ms": t_lib,
                "bound_ms": bms, "bound_by": by, "bytes": nbytes,
                "ops": ops,
                "device_ms": device_ms(cur),
                "other_device_ms": device_ms(old)})
            print(f"{name}: bit-identical to the other kernel; "
                  f"other {t_old1:.4f}/{t_old2:.4f} ms, current "
                  f"{t_new1:.4f}/{t_new2:.4f} ms, plain {t_plain:.4f} ms, "
                  f"matmul {t_lib:.4f} ms, bound {bms:.4f} ms ({by})",
                  flush=True)
            for key in ("device_ms", "other_device_ms"):
                print(f"  {key}: " + ", ".join(
                    f"{kname[:40]} {v:.4f}" for kname, v in sorted(
                        rec[key].items(), key=lambda kv: -kv[1])[:6]),
                    flush=True)
        else:
            print(f"{name}: bit-identical to the other kernel, agrees "
                  f"with plain (max abs err {err:.3g})", flush=True)
        results.append(rec)
        del w1, m1, deleted, kw


def profile_batches(results: list) -> None:
    """The three under-budget batches through the reader: device time per
    call by kernel, device busy share, unprofiled wall per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    chip_smoke = _smoke()
    import bench

    index, _vectors = chip_smoke.build_index()
    reader = index.reader()
    queries = bench.build_queries()[1][:256]
    filters = [chip_smoke.FILTERS[i % len(chip_smoke.FILTERS)]
               for i in range(len(queries))]
    for name, qs, fs, limit in [("b256", queries, None, 10),
                                ("b256 filtered", queries, filters, 10),
                                ("b32 k=2000", queries[:32], None, 2000)]:
        def call():
            reader.search_batch(qs, limit=limit, filters=fs)
        call()
        torch.cuda.synchronize()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        calls = 5
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
            prof_wall = (time.perf_counter() - t0) * 1e3 / calls
        kernels = _device_events(prof, calls)
        n_ops = sum(e.count for e in prof.key_averages()
                    if e.key in kernels) / calls
        busy = sum(kernels.values())
        rec = {"name": name, "wall_ms": walls, "profiled_wall_ms": prof_wall,
               "device_busy_ms": busy, "busy_share": busy / prof_wall,
               "device_ops_per_call": n_ops, "kernels": kernels}
        results.append(rec)
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
        print(f"profile {name}: wall {min(walls):.2f}-{max(walls):.2f} ms, "
              f"device busy {busy:.4f} ms/call "
              f"({100 * busy / prof_wall:.1f}% of profiled wall), "
              f"{n_ops:.0f} device ops/call; "
              + ", ".join(f"{k[:40]} {v:.4f}" for k, v in top), flush=True)


def main() -> int:
    from searchlite_tpu_torch.tools._common import require_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    require_device("cuda")
    card = _smoke().card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    _kernels.build_all(["fused_topk"])
    other = build_other(args.other)
    print(f"built both kernels in {time.perf_counter() - t0:.1f} s",
          flush=True)
    with open(os.path.join(REPO, "build", "kernels",
                           "fused_topk.ptxas.txt")) as fh:
        print(fh.read().strip(), flush=True)
    out = {"card": card, "shapes": [], "profiles": []}
    status = 0
    try:
        ab_shapes(other, out["shapes"])
        if args.profile:
            profile_batches(out["profiles"])
    except AssertionError as e:
        print(f"FAILED: {e}", flush=True)
        status = 1
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "fused_ab.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    return status


if __name__ == "__main__":
    sys.exit(main())
