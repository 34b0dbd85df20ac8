"""The port's bench row: ``bench.py``'s protocol through the torch reader.

    python -m searchlite_tpu_torch.tools.bench [--docs N] [--device cuda]

Run from the repository root. Builds ``bench.py``'s Zipf corpus
(``bench.build_docs``, 100,000 docs by default) through the port's own
``Index`` and writer, opens the port's reader on the card and runs the
protocol of ``bench.py`` (``main``, the part after the index build):

1. a warm pass over every batch (``search_batch``, ``execution="bm25"``);
2. the sustained stream, three 1024-query batches of 4 terms times 8,
   through ``search_batch_many`` in pairs form with ``bm25`` and with
   ``wand`` (each warmed on every batch first; timed in turns bm25,
   wand, wand, bm25, the mean of each pair recorded beside its samples);
3. the arrays row: the same stream with ``output="arrays"``, recorded as
   ``qps_protocol_b1024``, and the stream re-chunked at 4096 a batch;
4. the oracle gate (``bench.verify_vs_oracle`` under
   ``SEARCHLITE_PRECISION=f32_strict``): ``bm25`` and ``wand`` pairs of 16
   queries, and the first 16 rows of the TIMED arrays runs;
5. the same-run single-core C++ engine
   (``native/slt_cpu_engine.cpp``, best of its three modes), three turns
   interleaved with re-runs of the arrays stream, medians quoted;
6. ``p50_single_query_ms`` over ``bench.py``'s 9 single queries as default
   requests (each warmed first), with the route the first one took.

Prints ONE JSON line ``{"metric", "value", "unit", "vs_baseline",
"detail"}``: ``value`` is the median arrays-stream QPS, ``detail`` holds
every row, ``torch.__version__``, and the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them; the line is also written to ``chiprun_out/bench_torch[_<N>].json``.
Exits non-zero when the gate fails, or when ``--device cuda`` finds no
card. ``--device cpu`` (with a small ``--docs``) is for tests.
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


def cpp_engine_qps(reader, queries, k: int):
    """Best-mode single-core QPS of the C++ baseline engine on this
    workload as (mode, qps), or None without a toolchain."""
    from searchlite_tpu_torch.native import CpuEngine

    try:
        eng = CpuEngine(reader.segments[0])
    except (RuntimeError, OSError):
        return None
    tpq = max(len(q.split()) for q in queries)
    qtids = np.full((len(queries), tpq), -1, dtype=np.int32)
    for qi, q in enumerate(queries):
        for ti, tok in enumerate(q.split()):
            qtids[qi, ti] = eng.tid(f"body:{tok}")
    best = None
    for mode in ("bm25", "wand", "bmw"):
        eng.search_batch(qtids[:64], k=k, mode=mode)  # warm
        t0 = time.perf_counter()
        eng.search_batch(qtids, k=k, mode=mode)
        qps = len(queries) / (time.perf_counter() - t0)
        if best is None or qps > best[1]:
            best = (mode, qps)
    return best


def run(docs: int, device: str, repeat: int = 8) -> dict:
    """The protocol; returns the result dict (``detail.verified_vs_oracle``
    says whether the gate passed)."""
    import torch

    chip_smoke = _smoke()
    import bench

    bench.N_DOCS = docs
    K = bench.K
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    os.environ["SEARCHLITE_PRECISION"] = "f32_strict"
    detail = {"platform": "gpu" if on_card else "cpu",
              "torch": torch.__version__,
              "card": chip_smoke.card_line() if on_card else None,
              "docs": docs, "score_mode": "f32_strict"}
    t0 = time.perf_counter()
    index, _vectors = chip_smoke.build_index()
    detail["index_build_s"] = round(time.perf_counter() - t0, 2)
    reader = index.reader(device=device)
    batches = bench.build_queries()

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    for batch in batches:
        reader.search_batch(batch, limit=K)  # warm
    stream = batches[1:] * repeat
    n_queries = sum(len(b) for b in stream)
    qps = {}
    samples = {"bm25": [], "wand": []}
    for execution in ("bm25", "wand"):
        reader.search_batch_many(batches, limit=K, execution=execution)
    for execution in ("bm25", "wand", "wand", "bm25"):  # in turns
        _out, dt = timed(lambda: reader.search_batch_many(
            stream, limit=K, execution=execution))
        samples[execution].append(n_queries / dt)
    for execution, vals in samples.items():
        qps[execution] = sum(vals) / len(vals)
        detail[f"qps_{execution}_samples"] = [round(v, 1) for v in vals]
    arr_out, dt = timed(lambda: reader.search_batch_many(
        stream, limit=K, output="arrays"))
    qps["bm25_arrays"] = n_queries / dt
    flat_q = [q for b in stream for q in b]
    wide = [flat_q[i:i + 4096] for i in range(0, len(flat_q), 4096)]
    reader.search_batch_many(wide, limit=K, output="arrays")  # warm
    wide_out, dt = timed(lambda: reader.search_batch_many(
        wide, limit=K, output="arrays"))
    qps["bm25_arrays_b4096"] = len(flat_q) / dt
    for name, value in qps.items():
        detail[f"qps_{name}"] = round(value, 2)
    detail["qps_protocol_b1024"] = detail["qps_bm25_arrays"]

    # the gate: both strategies' pairs, and the timed arrays runs' rows
    verify = batches[1][:16]
    ok = {}
    for execution in ("bm25", "wand"):
        ok[execution] = bool(bench.verify_vs_oracle(
            reader, verify,
            reader.search_batch(verify, limit=K, execution=execution)))
    ok["arrays"] = bool(bench.verify_vs_oracle(
        reader, verify, chip_smoke.materialize(reader, arr_out[0], 16)))
    ok["arrays_b4096"] = bool(bench.verify_vs_oracle(
        reader, verify, chip_smoke.materialize(reader, wide_out[0], 16)))
    detail["verified"] = ok
    detail["verified_vs_oracle"] = all(ok.values())
    detail["batch"] = bench.BATCH
    detail["terms_per_query"] = bench.TERMS_PER_QUERY

    eng_samples = [qps["bm25_arrays"]]
    cpp_samples = []
    for _rep in range(3):
        sample = cpp_engine_qps(reader, batches[1], K)
        if sample is None:
            break
        cpp_samples.append(sample)
        _out, dt = timed(lambda: reader.search_batch_many(
            stream, limit=K, output="arrays"))
        eng_samples.append(n_queries / dt)
    value = sorted(eng_samples)[len(eng_samples) // 2]
    vs_baseline = 0
    detail["engine_qps_samples"] = [round(q, 1) for q in eng_samples]
    if cpp_samples:
        cpp_samples.sort(key=lambda ms: ms[1])
        mode, qps_cpp = cpp_samples[len(cpp_samples) // 2]
        vs_baseline = round(value / qps_cpp, 2)
        detail["cpp_engine_qps"] = round(qps_cpp, 1)
        detail["cpp_engine_qps_samples"] = [round(q, 1)
                                            for _, q in cpp_samples]
        detail["cpp_engine_mode"] = mode
        detail["baseline_kind"] = "cpp-engine-1core"

    singles = batches[0][:9]
    for q in singles:
        reader.search({"query": q, "limit": K})  # warm
    lat = []
    before = dict(reader.single_routes)
    for q in singles:
        _res, dt = timed(lambda: reader.search({"query": q, "limit": K}))
        lat.append(dt * 1000)
    detail["p50_single_query_ms"] = round(sorted(lat)[len(lat) // 2], 3)
    detail["single_routes"] = {k: reader.single_routes[k] - before[k]
                               for k in before}
    prof = reader.search({"query": singles[0], "limit": K,
                          "profile": True}).profile
    detail["p50_route_stats"] = {
        k: v for k, v in prof["execution"].items()
        if isinstance(v, (int, float, bool, str))}
    return {"metric": f"port_batched_bm25_top{K}_qps_{docs // 1000}k_docs",
            "value": round(value, 2), "unit": "qps",
            "vs_baseline": vs_baseline, "detail": detail}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=100_000)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--repeat", type=int, default=8,
                    help="how many times the three batches make the stream")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("FAILED: torch.cuda.is_available() is False")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    result = run(args.docs, args.device, args.repeat)
    line = json.dumps(result)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    suffix = "" if args.docs == 100_000 else f"_{args.docs}"
    with open(os.path.join(REPO, "chiprun_out",
                           f"bench_torch{suffix}.json"), "w") as fh:
        fh.write(line + "\n")
    print(line, flush=True)
    return 0 if result["detail"]["verified_vs_oracle"] else 1


if __name__ == "__main__":
    sys.exit(main())
