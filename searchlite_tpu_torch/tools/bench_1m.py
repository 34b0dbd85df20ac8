"""The 1M-doc protocol through the port: ``tools/bench_1m.py`` on the card.

    python -m searchlite_tpu_torch.tools.bench_1m [--docs N] [--mesh N]
        [--device cuda|cpu]

Run from the repository root. ``bench.py``'s Zipf corpus at 1,000,000
docs over a 50,000-term vocabulary (``bench.build_docs``), two query
batches of 1,024 (``bench.build_queries``), ingested in one commit through
the port's own ``Index`` and writer (in memory), then, on the port's
reader:

1. a warm pass of each strategy (``execution`` bm25 and wand) over the
   first batch;
2. batched QPS of the stream (the two timed batches three times, 6,144
   queries in one ``search_batch_many`` call: every launch enqueued, one
   copy back) for bm25 and wand, pairs and arrays, each warmed on the
   batches first, and the same queries re-chunked at 4,096 a batch (bm25,
   arrays);
3. the in-run single-core C++ baseline (the port's ``CpuEngine``,
   ``native/slt_cpu_engine.cpp``, best of bm25 / wand / bmw) on the same
   batch;
4. the warmed single-query p50 over 30 of the batch's queries at the
   default routing (the sparse single routes are on at this size);
5. the f64 oracle gate (``bench.verify_vs_oracle`` under
   ``SEARCHLITE_PRECISION=f32_strict``) on 16 queries of each strategy's
   pairs and of the timed arrays;
6. with ``--mesh N``: the arrays stream and the singles again over an
   N-shard mesh (``parallel/mesh.py::parse_mesh_spec``: round robin on the
   visible cards, N logical shards on one), with the same gate.

Prints progress lines and ONE JSON line (``{"metric", "value", "unit",
"vs_baseline", "detail"}``, ``value`` the bm25 arrays stream QPS, the card's
name and power limit in ``detail.card``), also written to
``chiprun_out/bench_1m[_<docs>].json``. Exits 1 when the gate fails, 2
when ``--device cuda`` finds no card. ``--device cpu`` with a small
``--docs`` is for tests.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def log(*parts) -> None:
    print(*parts, flush=True)


def build_index(docs):
    """One commit of ``docs`` into an in-memory port index."""
    from searchlite_tpu_torch.api.types import IndexOptions, StorageType
    from searchlite_tpu_torch.index import Index
    from searchlite_tpu_torch.index.manifest import Schema

    index = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY, bm25_k1=0.9,
                     bm25_b=0.4),
        Schema.from_json({
            "text_fields": [{"name": "body", "analyzer": "default",
                             "stored": False, "indexed": True}]}))
    writer = index.writer()
    writer.add_documents(docs)
    writer.commit()
    return index


def run(docs: int, device: str, mesh_spec=None) -> dict:
    import torch

    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import bench
    from searchlite_tpu_torch.tools.bench import cpp_engine_qps

    bench.N_DOCS = docs
    bench.VOCAB = 50_000
    bench.N_BATCHES = 2
    K = bench.K
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    os.environ["SEARCHLITE_PRECISION"] = "f32_strict"
    card = None
    if on_card:
        from searchlite_tpu_torch.tools._common import card_line

        card = card_line()
        log(card)
    detail = {"platform": "gpu" if on_card else "cpu", "card": card,
              "torch": torch.__version__, "docs": docs,
              "vocab": bench.VOCAB, "score_mode": "f32_strict"}

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    corpus, dt = timed(bench.build_docs)
    detail["gen_s"] = round(dt, 1)
    log(f"gen {dt:.1f} s")
    index, dt = timed(lambda: build_index(corpus))
    del corpus
    detail["ingest_s"] = round(dt, 1)
    log(f"ingest {dt:.1f} s")
    batches = bench.build_queries()

    def open_and_warm():
        reader = index.reader(device=device)
        for execution in ("bm25", "wand"):
            reader.search_batch(batches[0], limit=K, execution=execution)
        return reader

    reader, dt = timed(open_and_warm)
    detail["upload_warm_s"] = round(dt, 1)
    detail["segments"] = len(reader.segments)
    log(f"upload + warm {dt:.1f} s, {len(reader.segments)} segment(s), "
        f"n1 = {reader.device_segments[0].n1}")

    stream = batches[1:] * 3
    n = sum(len(b) for b in stream)
    verify = batches[1][:16]
    gate = {}
    qps = {}
    arrays_out = None
    for execution in ("bm25", "wand"):
        for output in ("pairs", "arrays"):
            reader.search_batch_many(batches[1:], limit=K,
                                     execution=execution, output=output)
            out, dt = timed(lambda: reader.search_batch_many(
                stream, limit=K, execution=execution, output=output))
            qps[f"{execution}/{output}"] = n / dt
            log(f"1M-doc batched QPS [{execution}/{output}]: {n / dt:.1f}")
            if output == "pairs":
                gate[execution] = bool(bench.verify_vs_oracle(
                    reader, verify, out[0][:16]))
            elif execution == "bm25":
                arrays_out = out
    flat_q = [q for b in stream for q in b]
    wide = [flat_q[i:i + 4096] for i in range(0, len(flat_q), 4096)]
    reader.search_batch_many(wide, limit=K, output="arrays")
    wide_out, dt = timed(lambda: reader.search_batch_many(
        wide, limit=K, output="arrays"))
    qps["bm25/arrays/b4096"] = len(flat_q) / dt
    log(f"1M-doc batched QPS [bm25/arrays/b4096]: {len(flat_q) / dt:.1f}")

    from chip_smoke import materialize

    gate["arrays"] = bool(bench.verify_vs_oracle(
        reader, verify, materialize(reader, arrays_out[0], 16)))
    gate["arrays_b4096"] = bool(bench.verify_vs_oracle(
        reader, verify, materialize(reader, wide_out[0], 16)))

    best = cpp_engine_qps(reader, batches[1], K)
    if best is not None:
        detail["cpp_engine_mode"] = best[0]
        detail["cpp_engine_qps"] = round(best[1], 1)
        log(f"1M-doc C++ engine (1 core, same workload): {best[1]:.1f} qps "
            f"[{best[0]}]")

    def single_p50(kw):
        singles = batches[1][:30]
        for q in singles[:5]:
            reader.search({"query": q, "limit": K}, **kw)  # warm
        lat = sorted(timed(lambda: reader.search({"query": q, "limit": K},
                                                 **kw))[1] * 1000
                     for q in singles)
        return lat[len(lat) // 2]

    before = dict(reader.single_routes)
    detail["p50_single_query_ms"] = round(single_p50({}), 3)
    detail["single_routes"] = {k: reader.single_routes[k] - before[k]
                               for k in before}
    log(f"1M-doc single-query p50 (default routing): "
        f"{detail['p50_single_query_ms']} ms; routes "
        f"{detail['single_routes']}")

    if mesh_spec:
        from searchlite_tpu_torch.parallel.mesh import parse_mesh_spec

        mesh = parse_mesh_spec(mesh_spec, device=device)
        if mesh is None:
            raise SystemExit(f"--mesh {mesh_spec}: one device would take "
                             "part; nothing to shard")
        reader.search_batch_many(batches[1:], limit=K, output="arrays",
                                 mesh=mesh)
        out, dt = timed(lambda: reader.search_batch_many(
            stream, limit=K, output="arrays", mesh=mesh))
        qps["mesh bm25/arrays"] = n / dt
        gate["mesh_arrays"] = bool(bench.verify_vs_oracle(
            reader, verify, materialize(reader, out[0], 16)))
        detail["mesh"] = {"shape": mesh.shape, "devices": list(mesh.key),
                          "route_rows": dict(reader.route_rows),
                          "p50_single_query_ms": round(
                              single_p50({"mesh": mesh}), 3)}
        log(f"1M-doc batched QPS over {mesh} [bm25/arrays]: {n / dt:.1f}; "
            f"single-query p50 {detail['mesh']['p50_single_query_ms']} ms")

    for name, value in qps.items():
        detail[f"qps {name}"] = round(value, 1)
    detail["verified"] = gate
    detail["verified_vs_oracle"] = all(gate.values())
    vs = round(qps["bm25/arrays"] / best[1], 2) if best else 0
    return {"metric": f"port_batched_bm25_top{K}_qps_{docs // 1000}k_docs",
            "value": round(qps["bm25/arrays"], 1), "unit": "qps",
            "vs_baseline": vs, "detail": detail}


def main(argv=None) -> int:
    from searchlite_tpu_torch.tools._common import require_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=1_000_000)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--mesh", default=None,
                    help="also run the stream and singles over a mesh of "
                         "this many shards")
    args = ap.parse_args(argv)
    require_device(args.device)
    result = run(args.docs, args.device, args.mesh)
    line = json.dumps(result)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    suffix = "" if args.docs == 1_000_000 else f"_{args.docs}"
    with open(os.path.join(REPO, "chiprun_out", f"bench_1m{suffix}.json"),
              "w") as fh:
        fh.write(line + "\n")
    print(line, flush=True)
    return 0 if result["detail"]["verified_vs_oracle"] else 1


if __name__ == "__main__":
    sys.exit(main())
