"""Profile of single-query ``search()`` on the card, per route.

    python -m searchlite_tpu_torch.tools.single_profile [--docs N]
        [--streams-only] [--sharded] [--aggs] [--vectors] [--mesh N]

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

Then the routes of ``ops/tiles.py`` beside the dense executor, the sparse
single routes switched off (``SEARCHLITE_SINGLE_SPARSE=0``) so that the
9 single queries reach them at any corpus size:

4. ``execution="bm25"`` (the dense executor);
5. ``execution="wand"`` with ``SEARCHLITE_PRUNE_MIN_POSTINGS=0`` (the
   doc-tile pruned jobs), and at the default threshold;
6. ``execution="bm25"`` with ``SEARCHLITE_M_BUDGET_BYTES`` at a quarter of
   the queries' dense M (the chunked executor, four chunks);
7. ``bench.py``'s three 1024-query batches as one ``search_batch_many``
   stream in arrays form, ``bm25`` and ``wand`` in turns (bm25, wand,
   wand, bm25): wall per call and QPS, device busy time per call, the
   tile waves' counters per call (UB and wave launches, tiles scored,
   per-query rounds) and, over one call under cProfile, the host
   functions with the most own time. ``--streams-only`` runs only this
   set (and writes ``single_profile_streams[_<N>].json``).

``--sharded``, ``--aggs`` and ``--vectors`` run, in place of the sets
above, ``chip_smoke``'s phase-e requests (and write
``single_profile_phase_e[_<N>].json``):

8. ``--sharded``: the filtered 1024-query batch at the default budget (the
   doc-sharded dense scan, two shards at 100k docs) and the 32-query
   ``limit=2000`` batch with the budget at a quarter of its dense-M
   estimate (four shards), as ``search_batch`` calls;
9. ``--aggs``: the eight device-kind aggregation requests at the default
   precision, reduced on the card and, with ``SEARCHLITE_DEVICE_AGGS=0``,
   collected on the host over the fetched mask;
10. ``--vectors``: a vector-only request over the 128-wide cosine field,
    a hybrid request (alpha 0.5) with a filter, and a vector-only request
    on the bf16 and on the int8 field.

``--mesh N`` runs, in place of every set above, the 9 single queries and
the three 1024-query batches as one arrays stream (bm25), each without
and with an ``N``-shard mesh (``parallel/mesh.py::parse_mesh_spec``: N
logical shards on one card), in turns (one device, mesh, mesh, one
device), and writes ``single_profile_mesh[_<N>].json``.

For each set: the segments per route, the unprofiled wall per query (host
clock around a call that ends in a synchronise; p50, min, max), and over
one profiled pass the device busy time per query, the busy share of the
profiled wall, device ops per query and the top kernels by name. Prints
one line per set (and first the bytes the tile routes keep on the card:
the flat postings at 8 bytes a posting, the tile tables) and writes
``chiprun_out/single_profile[_<N>].json``;
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


def measure(reader, queries, name: str, passes: int = 1,
            extra: dict | None = None, env: dict | None = None,
            mesh=None) -> dict:
    """Wall per query over ``passes`` passes, then one profiled pass.
    ``extra`` holds more request fields, ``env`` environment settings
    for the set, ``mesh`` the mesh the requests run over."""
    saved = {k: os.environ.get(k) for k in env or {}}
    os.environ.update(env or {})
    try:
        return _measure(reader, queries, name, passes, extra or {}, mesh)
    finally:
        for k, v in saved.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def _measure(reader, queries, name: str, passes: int, extra: dict,
             mesh=None) -> dict:
    # after the warm pass: ``passes`` timed passes, one under
    # torch.profiler, one under cProfile
    import torch
    from torch.profiler import ProfilerActivity, profile

    from searchlite_tpu_torch.tools.fused_ab import _device_events

    def search(q):
        # a query string, or a whole request
        req = q if isinstance(q, dict) else {"query": q, "limit": 10}
        return reader.search({**req, **extra}, mesh=mesh)

    for q in queries:
        search(q)  # warm
    before = dict(reader.single_routes)
    stats = dict(reader.tile_stats)
    walls = []
    for _ in range(passes):
        for q in queries:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            search(q)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for q in queries:
            search(q)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3 / len(queries)
    host_top = _host_top(lambda: [search(q) for q in queries],
                         len(queries))
    kernels = _device_events(prof, len(queries))
    n_ops = sum(e.count for e in prof.key_averages()
                if e.key in kernels) / len(queries)
    busy = sum(kernels.values())
    rec = {"name": name, "queries": len(queries),
           "routes": {k: reader.single_routes[k] - before[k]
                      for k in before},
           "tile_stats_per_query": {
               k: (reader.tile_stats[k] - stats[k])
               / ((passes + 2) * len(queries)) for k in stats},
           "wall_ms_p50": float(np.percentile(walls, 50)),
           "wall_ms_min": min(walls), "wall_ms_max": max(walls),
           "profiled_wall_ms": prof_wall, "device_busy_ms": busy,
           "busy_share": busy / prof_wall, "device_ops_per_query": n_ops,
           "kernels": kernels, "host_top_ms_per_query": host_top}
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    print(f"{name}: routes {rec['routes']}; tile stats a query "
          f"{rec['tile_stats_per_query']}; wall p50 "
          f"{rec['wall_ms_p50']:.3f} ms (min "
          f"{rec['wall_ms_min']:.3f}, max {rec['wall_ms_max']:.3f}); device "
          f"busy {busy:.4f} ms/query ({100 * busy / prof_wall:.1f}% of "
          f"profiled wall), {n_ops:.0f} device ops/query; "
          + ", ".join(f"{k[:40]} {v:.4f}" for k, v in top)
          + "; host, own ms a query: "
          + ", ".join(f"{k} {v:.3f}" for k, v in host_top[:6]), flush=True)
    return rec


def _host_top(run, calls: int, n: int = 10) -> list:
    """The host functions with the most own time over one ``run()`` under
    cProfile, as [name, ms per call] (the profiler's overhead included:
    shares, not walls)."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.runcall(run)
    rows = sorted(pstats.Stats(prof).stats.items(),
                  key=lambda kv: -kv[1][2])[:n]
    return [[f"{os.path.basename(f)}:{line}:{name}", tt * 1e3 / calls]
            for (f, line, name), (_cc, _nc, tt, _ct, _callers) in rows]


def measure_stream(reader, stream, execution: str, calls: int = 3,
                   name: str | None = None, limit: int = 10,
                   filters=None, mesh=None) -> dict:
    """One ``search_batch_many`` stream in arrays form: wall per call over
    ``calls`` calls, then ``calls`` profiled calls, then one call under
    cProfile (the host functions with the most own time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from searchlite_tpu_torch.tools.fused_ab import _device_events

    name = name or f"stream {execution}"

    def call():
        reader.search_batch_many(stream, limit=limit, output="arrays",
                                 execution=execution, filters=filters,
                                 mesh=mesh)

    call()  # warm
    rows = dict(reader.route_rows)
    stats = dict(reader.tile_stats)
    walls = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3 / calls
    kernels = _device_events(prof, calls)
    busy = sum(kernels.values())
    n_queries = sum(len(b) for b in stream)
    wall = float(np.median(walls))
    rec = {"name": name, "queries": n_queries,
           "rows_per_route": {k: (reader.route_rows[k] - rows[k])
                              // (2 * calls) for k in rows},
           "tile_stats_per_call": {k: (reader.tile_stats[k] - stats[k])
                                   / (2 * calls) for k in stats},
           "host_top_ms_per_call": _host_top(call, 1),
           "wall_ms_median": wall, "wall_ms": walls,
           "qps": n_queries / wall * 1e3, "profiled_wall_ms": prof_wall,
           "device_busy_ms": busy, "busy_share": busy / prof_wall,
           "kernels": kernels}
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:4]
    print(f"{name}: {n_queries} queries a call, rows per route "
          f"{rec['rows_per_route']}, tile stats a call "
          f"{rec['tile_stats_per_call']}; wall median {wall:.2f} ms "
          f"({rec['qps']:.0f} QPS; calls "
          f"{', '.join(f'{w:.2f}' for w in walls)}); device busy "
          f"{busy:.3f} ms/call ({100 * busy / prof_wall:.1f}% of profiled "
          f"wall); " + ", ".join(f"{k[:40]} {v:.4f}" for k, v in top)
          + "; host, own ms a call: "
          + ", ".join(f"{k} {v:.3f}"
                      for k, v in rec["host_top_ms_per_call"][:6]),
          flush=True)
    return rec


def main() -> int:
    from searchlite_tpu_torch.tools._common import require_device

    chip_smoke = _smoke()
    import bench

    from searchlite_tpu_torch.ops import sparse
    from searchlite_tpu_torch.ops.tiles import get_tile_index

    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=bench.N_DOCS)
    ap.add_argument("--streams-only", action="store_true",
                    help="skip the single-query sets")
    ap.add_argument("--sharded", action="store_true",
                    help="the doc-sharded batches of chip_smoke's phase e")
    ap.add_argument("--aggs", action="store_true",
                    help="the aggregation requests of phase e")
    ap.add_argument("--vectors", action="store_true",
                    help="the vector and hybrid requests of phase e")
    ap.add_argument("--mesh", type=int, default=None,
                    help="the singles and the stream without and with a "
                         "mesh of this many shards, in turns")
    args = ap.parse_args()
    require_device("cuda")
    bench.N_DOCS = args.docs
    card = chip_smoke.card_line()
    print(card, flush=True)
    os.environ["SEARCHLITE_PRECISION"] = "f32_strict"
    index, vectors = chip_smoke.build_index()
    reader = index.reader()
    dseg = reader.device_segments[0]
    tl = get_tile_index(dseg)
    n_post = int(dseg.reader.postings.term_df.sum())
    # what the tile routes keep on the card beside the block layout
    resident = {
        "postings": n_post, "flat_postings_bytes": 8 * n_post,
        "tile_width": tl.T, "n_tiles": tl.n_tiles,
        "tile_entries": len(tl.entry_start),
        "tile_table_bytes": tl.tile_docs_np.nbytes + tl.tile_maxes_np.nbytes
        + tl.deleted_tiles_np.nbytes}
    print(f"n1 = {dseg.n1}; tile routes' residents: {resident}", flush=True)
    singles = bench.build_queries()[0]
    out = {"card": card, "docs": args.docs, "resident": resident,
           "sets": []}
    if args.mesh:
        from searchlite_tpu_torch.parallel.mesh import parse_mesh_spec

        mesh = parse_mesh_spec(args.mesh)
        out["mesh"] = {"shape": mesh.shape, "devices": list(mesh.key)}
        stream = bench.build_queries()[1:]
        for which in ("one device", "mesh", "mesh", "one device"):
            m = mesh if which == "mesh" else None
            out["sets"].append(measure(reader, singles[:9],
                                       f"singles, {which}", passes=3,
                                       mesh=m))
            out["sets"].append(measure_stream(reader, stream, "bm25",
                                              name=f"stream, {which}",
                                              mesh=m))
        return write(out, "_mesh", args.docs)
    if args.sharded or args.aggs or args.vectors:
        phase_e(reader, chip_smoke, vectors, args, out)
        return write(out, "_phase_e", args.docs)
    if not args.streams_only:
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
        # the tile routes beside the dense executor
        no_sparse = {"SEARCHLITE_SINGLE_SPARSE": "0"}
        n1 = reader.device_segments[0].n1
        out["sets"].append(measure(
            reader, singles[:9], "dense singles (bm25)", passes=3,
            extra={"execution": "bm25"}, env=no_sparse))
        out["sets"].append(measure(
            reader, singles[:9], "pruned singles (wand, threshold 0)",
            passes=3,
            extra={"execution": "wand"},
            env={**no_sparse, "SEARCHLITE_PRUNE_MIN_POSTINGS": "0"}))
        out["sets"].append(measure(
            reader, singles[:9], "wand singles (default threshold)", passes=3,
            extra={"execution": "wand"}, env=no_sparse))
        out["sets"].append(measure(
            reader, singles[:9], "chunked singles (bm25, 4 chunks)", passes=3,
            extra={"execution": "bm25"},
            env={**no_sparse, "SEARCHLITE_M_BUDGET_BYTES": str(8 * n1)}))
    stream = bench.build_queries()[1:]
    for execution in ("bm25", "wand", "wand", "bm25"):
        out["sets"].append(measure_stream(reader, stream, execution))
    routes = dict(reader.single_routes)
    out["single_routes"] = routes
    print(f"segments per route over the run: {routes}", flush=True)
    return write(out, "_streams" if args.streams_only else "", args.docs)


def write(out: dict, suffix: str, docs: int) -> int:
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    suffix += "" if docs == 100_000 else f"_{docs}"
    with open(os.path.join(REPO, "chiprun_out",
                           f"single_profile{suffix}.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    return 0


def phase_e(reader, chip_smoke, vectors, args, out: dict) -> None:
    """The sets of ``--sharded``, ``--aggs`` and ``--vectors``."""
    import bench

    if args.sharded:
        dseg = reader.device_segments[0]
        b1024 = bench.build_queries()[1]
        filters = [chip_smoke.FILTERS[i % len(chip_smoke.FILTERS)]
                   for i in range(len(b1024))]
        out["sets"].append(measure_stream(
            reader, [b1024], "bm25", name="sharded b1024 filtered",
            filters=[filters]))
        qb = reader._qb_lazy_native(dseg.reader, dseg, [b1024[:32]], 0,
                                    ["body"], [None])
        est = (qb["s_pad"] + 32) * dseg.n1 * 4
        os.environ["SEARCHLITE_M_BUDGET_BYTES"] = str(est // 4)
        try:
            out["sets"].append(measure_stream(
                reader, [b1024[:32]], "bm25", name="sharded b32 k=2000",
                limit=2000))
        finally:
            del os.environ["SEARCHLITE_M_BUDGET_BYTES"]
        out["route_rows"] = dict(reader.route_rows)
    if args.aggs:
        # at the default precision: under f32_strict stats stay on the host
        precision = os.environ.pop("SEARCHLITE_PRECISION")
        try:
            reqs = [{"query": "tok5 tok9 tok40", "limit": 10, "aggs": aggs}
                    for _name, aggs, on_device in chip_smoke.agg_requests()
                    if on_device]
            out["sets"].append(measure(reader, reqs, "aggs on the card",
                                       passes=3))
            out["sets"].append(measure(
                reader, reqs, "aggs on the host collectors", passes=3,
                env={"SEARCHLITE_DEVICE_AGGS": "0"}))
        finally:
            os.environ["SEARCHLITE_PRECISION"] = precision
        out["agg_routes"] = dict(reader.agg_routes)
    if args.vectors:
        def vec_req(field, row):
            return {"query": {"type": "vector", "field": field,
                              "vector": vectors[field][row].tolist(),
                              "alpha": 0.0}, "limit": 10}

        rows = [17, 4321, 9000, 12345, 15000]
        out["sets"].append(measure(
            reader, [vec_req("vec", r) for r in rows],
            "vector-only (f32 cosine)", passes=3))
        out["sets"].append(measure(
            reader, [{"query": "tok57 tok300", "limit": 10,
                      "filter": {"I64Range": {"field": "bucket", "min": 2,
                                              "max": 9}},
                      "vector_query": {"field": "vec", "alpha": 0.5,
                                       "vector": vectors["vec"][r].tolist()}}
                     for r in rows], "hybrid alpha 0.5 + filter", passes=3))
        for field in ("vec_bf16", "vec_int8"):
            out["sets"].append(measure(
                reader, [vec_req(field, r % len(vectors[field]))
                         for r in rows], f"vector-only ({field})", passes=3))


if __name__ == "__main__":
    sys.exit(main())
