"""Profile of single-query ``search()`` on the card, per route.

    python -m searchlite_tpu_torch.tools.single_profile [--docs N]

Run from the repository root on a machine with an NVIDIA GPU. Builds
``chip_smoke``'s index over ``bench.py``'s corpus at ``N`` docs (default
100,000; the sparse single routes turn on by themselves from 1,000,000)
and, under ``SEARCHLITE_PRECISION=f32_strict``, runs three query sets
through the port's reader on the card:

1. ``bench.py``'s 9 single queries as default requests (at 100k docs the
   dense compiled executor);
2. 64 more of ``bench.py``'s queries, with
   ``SEARCHLITE_SINGLE_SPARSE_MIN_DOCS=0`` under 1M docs (at 100k docs the
   sparse plain route: the strip kernel at B = 1);
3. ``chip_smoke.split_queries()`` likewise (head terms: the single-query
   term split), A/B in turns (lanes, top-k, top-k, lanes) between the
   strip kernel's all-lanes pass (``strip_lanes_blocks``, what the port
   runs) and its top-k at k = the strip's width (``strip_topk_blocks``, the
   first design), which return the same kept (doc, score) set.

For each set: the segments per route, the unprofiled wall per query (host
clock around a call that ends in a synchronise; p50, min, max), and over
one profiled pass the device busy time per query, the busy share of the
profiled wall, device ops per query and the top kernels by name. Prints
one line per set and writes ``chiprun_out/single_profile[_<N>].json``;
exits non-zero when no card is found.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _smoke():
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import chip_smoke

    return chip_smoke


def _topk_at_width(block_docs, block_impacts, bstart, bcnt, w, sent, *,
                   nblk: int, log2_run: int):
    """The first design of the split's strip pass: the strip kernel's
    top-k at k = the strip's width (the same kept set, sorted)."""
    from searchlite_tpu_torch.ops.strip_topk import strip_topk_blocks

    return strip_topk_blocks(block_docs, block_impacts, bstart, bcnt, w,
                             sent, k=nblk * 128, nblk=nblk,
                             log2_run=log2_run, with_counts=True)


def measure(reader, queries, name: str, passes: int = 1) -> dict:
    """Wall per query over ``passes`` passes, then one profiled pass."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from searchlite_tpu_torch.tools.fused_ab import _device_events

    for q in queries:
        reader.search({"query": q, "limit": 10})  # warm
    before = dict(reader.single_routes)
    walls = []
    for _ in range(passes):
        for q in queries:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reader.search({"query": q, "limit": 10})
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for q in queries:
            reader.search({"query": q, "limit": 10})
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3 / len(queries)
    kernels = _device_events(prof, len(queries))
    n_ops = sum(e.count for e in prof.key_averages()
                if e.key in kernels) / len(queries)
    busy = sum(kernels.values())
    rec = {"name": name, "queries": len(queries),
           "routes": {k: reader.single_routes[k] - before[k]
                      for k in before},
           "wall_ms_p50": float(np.percentile(walls, 50)),
           "wall_ms_min": min(walls), "wall_ms_max": max(walls),
           "profiled_wall_ms": prof_wall, "device_busy_ms": busy,
           "busy_share": busy / prof_wall, "device_ops_per_query": n_ops,
           "kernels": kernels}
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    print(f"{name}: routes {rec['routes']}; wall p50 "
          f"{rec['wall_ms_p50']:.3f} ms (min "
          f"{rec['wall_ms_min']:.3f}, max {rec['wall_ms_max']:.3f}); device "
          f"busy {busy:.4f} ms/query ({100 * busy / prof_wall:.1f}% of "
          f"profiled wall), {n_ops:.0f} device ops/query; "
          + ", ".join(f"{k[:40]} {v:.4f}" for k, v in top), flush=True)
    return rec


def main() -> int:
    import torch

    chip_smoke = _smoke()
    import bench

    from searchlite_tpu_torch.ops import sparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=bench.N_DOCS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAILED: torch.cuda.is_available() is False")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    bench.N_DOCS = args.docs
    card = chip_smoke.card_line()
    print(card, flush=True)
    os.environ["SEARCHLITE_PRECISION"] = "f32_strict"
    reader = chip_smoke.build_index().reader()
    print(f"n1 = {reader.device_segments[0].n1}", flush=True)
    singles = bench.build_queries()[0]
    out = {"card": card, "docs": args.docs, "sets": []}
    out["sets"].append(measure(reader, singles[:9], "default singles",
                               passes=3))
    if args.docs < 1_000_000:
        os.environ["SEARCHLITE_SINGLE_SPARSE_MIN_DOCS"] = "0"
    out["sets"].append(measure(reader, singles[9:73], "bench singles"))
    split = chip_smoke.split_queries()
    lanes = sparse.strip_lanes_blocks
    for variant in ("lanes", "top-k", "top-k", "lanes"):
        sparse.strip_lanes_blocks = lanes if variant == "lanes" \
            else _topk_at_width
        try:
            out["sets"].append(measure(
                reader, split, f"sparse split ({variant})", passes=3))
        finally:
            sparse.strip_lanes_blocks = lanes
    routes = dict(reader.single_routes)
    out["single_routes"] = routes
    print(f"segments per route over the run: {routes}", flush=True)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    suffix = "" if args.docs == 100_000 else f"_{args.docs}"
    with open(os.path.join(REPO, "chiprun_out",
                           f"single_profile{suffix}.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
