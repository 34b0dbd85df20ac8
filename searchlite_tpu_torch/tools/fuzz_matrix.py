"""Randomized knob-matrix differential fuzz of the port's batched engine
(``tools/fuzz_matrix.py`` on the port's reader).

Every iteration builds a random corpus (size, vocabulary shape,
segments, deletes, positions) through the port's own ``Index``, picks a
random combination of the engine's routing knobs (packed sparse uploads,
term split, batch prune mode, dense split budget, precision, memory
budget, single-sparse gate, wand blocks, heavy-term blocks, mesh dense,
runs format, host tier), and checks that EVERY execution strategy and
output surface of ``search_batch_many`` -- streams, meshes, structural
merges, per-query filters, the single path and an aggs + sort A/B --
agrees with an exact f64 BM25 oracle. The draws are the JAX tool's, call
for call, so a seed names the same campaign in both packages; the mesh
draw is the one a JAX process with 8 devices makes, and the mesh is
``make_mesh(n, devices=[device] * n)``: n logical shards on the reader's
device. On the card, ``SEARCHLITE_HOST_TIER=force`` keeps the host tier's
size rule (segments under ``SEARCHLITE_HOST_TIER_DOCS`` live on the CPU,
as JAX puts them on its last CPU device); without it the tier is off and
every segment is on the card, as in a JAX process on one backend. Run:

    python -m searchlite_tpu_torch.tools.fuzz_matrix [n_iters] [seed]
        [--device cuda|cpu]

Prints one line per iteration with the launches and plain calls of each
kernel it caused (``{kernel: [launches, plain]}``), and for each reader
where its segments lived and the plain calls made while it served;
exits non-zero on the first mismatch with a repro header (iteration
seed + knob dict). The scores are held to the tolerance of the mode the
port computes (:func:`held_tols`): unset precision is exact f32 here.
"""

from __future__ import annotations

import json
import os
import random
import sys
import time

import numpy as np

from searchlite_tpu_torch.tools._common import counts_since, kernel_counts


def build_corpus(rng: random.Random, n_docs: int, vocab: int,
                 positions: bool, n_segments: int, delete_frac: float,
                 device: str = "cuda"):
    from searchlite_tpu_torch.api.types import IndexOptions, StorageType
    from searchlite_tpu_torch.index import Index
    from searchlite_tpu_torch.index.manifest import Schema

    index = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY,
                     enable_positions=positions),
        Schema.from_json({
            "text_fields": [{"name": "body", "analyzer": "default",
                             "stored": False, "indexed": True}],
            "keyword_fields": [{"name": "cat", "stored": False,
                                "indexed": False, "fast": True}],
            "numeric_fields": [{"name": "price", "i64": True,
                                "stored": False, "fast": True}]}))
    index.device = device  # readers and the merge warm
    writer = index.writer()
    alpha = rng.uniform(0.8, 1.6)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = (1.0 / ranks ** alpha)
    probs /= probs.sum()
    nrng = np.random.default_rng(rng.randrange(2**31))
    per_seg = max(1, n_docs // n_segments)
    docs_written = 0
    for _s in range(n_segments):
        batch = []
        for _ in range(per_seg):
            n = nrng.integers(3, 80)
            toks = nrng.choice(vocab, size=n, p=probs)
            batch.append({"_id": str(docs_written),
                          "body": " ".join(f"t{t}" for t in toks),
                          "cat": f"c{docs_written % 5}",
                          "price": docs_written % 97})
            docs_written += 1
        writer.add_documents(batch)
        writer.commit()
    if delete_frac > 0:
        dels = [str(i) for i in range(docs_written)
                if rng.random() < delete_frac]
        if dels:
            writer.delete_documents(dels)
            writer.commit()
    return index


def oracle_scores(reader, raw_query: str) -> dict[str, float]:
    """Exact f64-accumulated BM25 per doc_id across all segments."""
    out: dict[str, float] = {}
    k1, b = 0.9, 0.4
    for seg, dseg in zip(reader.segments, reader.device_segments):
        postings = seg.postings
        n_docs = seg.doc_count
        col = seg.fast.column("_len:body")
        doc_len = np.zeros(n_docs, dtype=np.float64)
        doc_len[col.row_ids] = col.values.astype(np.float64)
        avg = seg.avg_field_length("body")
        live = float(dseg.live_docs)
        scores = np.zeros(n_docs, dtype=np.float64)
        touched = np.zeros(n_docs, dtype=bool)
        for token in raw_query.split():
            tid = seg.terms.get(f"body:{token}")
            if tid is None:
                continue
            df = float(postings.term_df[tid])
            # mirror device/index.py::idf_table -- the ratio is clamped
            # before the log so df > live (tombstones) stays finite
            ratio = max((live - df + 0.5) / (df + 0.5), 1e-300)
            idf = max(np.log(ratio), 0.0) + 1.0
            docs, tfs = postings.term_postings(tid)
            tfs = tfs.astype(np.float64)
            norm = doc_len[docs] / avg
            denom = np.maximum(tfs + k1 * (1 - b + b * norm), 1e-6)
            # weight = count x idf per engine convention: a repeated
            # query term multiplies the idf; oracle handles repeats by
            # just accumulating again, same total
            scores[docs] += idf * tfs * (k1 + 1) / denom
            touched[docs] = True
        deleted = np.asarray(dseg.host.deleted_np[:n_docs])
        for d in np.flatnonzero(touched & ~deleted):
            out[seg.doc_id(int(d))] = out.get(
                seg.doc_id(int(d)), 0.0) + float(scores[d])
    return out


def mode_tols(precision: str) -> tuple:
    """Score tolerance per precision mode. f32_strict is bit-exact
    (1e-5 covers f32 summation-order ulps between paths, D10);
    fast-f32 rounds matmul INPUTS to bf16 once (~2^-8 relative);
    bf16 additionally stores impacts in bf16 -- two roundings per
    term, so multi-term scores can drift past 6e-3 (a fuzz run
    measured 0.63% on a 5-term query). The JAX tool's table, row for
    row: :func:`held_tols` is what the port is held to."""
    if precision == "f32_strict":
        return 1e-5, 1e-4
    if precision == "bf16":
        return 2e-2, 1e-3
    return 6e-3, 1e-3


def held_tols(precision: str) -> tuple:
    """The tolerance the port is held to: :func:`mode_tols` of the mode
    it computes. Unset (or ``f32``) the port computes exact f32 on every
    device (f32 tables, TF32 off), where the JAX package on an
    accelerator rounds its dot inputs, so it is held to f32_strict's."""
    return mode_tols("f32_strict" if precision in ("", "f32")
                     else precision)


def check_topk(queries, got_rows, oracles, strict, tag: str,
               limit: int):
    rtol, atol = strict if isinstance(strict, tuple) else (
        (1e-5, 1e-4) if strict else (6e-3, 1e-3))
    for q, row, oracle in zip(queries, got_rows, oracles):
        want_n = min(limit, len(oracle))
        if len(row) != want_n:
            return f"{tag}: {q!r} returned {len(row)} hits, want {want_n}"
        floor = None
        for doc_id, score in row:
            ref = oracle.get(doc_id)
            if ref is None:
                return f"{tag}: {q!r} returned non-matching doc {doc_id}"
            tol = atol + rtol * abs(ref)
            if abs(score - ref) > tol:
                return (f"{tag}: {q!r} doc {doc_id} score {score} "
                        f"!= oracle {ref}")
            floor = ref if floor is None else min(floor, ref)
        if row:
            others = [s for d, s in oracle.items()
                      if d not in {d2 for d2, _ in row}]
            if others:
                best_out = max(others)
                if best_out > floor + atol + rtol * abs(best_out):
                    return (f"{tag}: {q!r} missed doc scoring "
                            f"{best_out} > floor {floor}")
    return None


# meshes per (shard count, device), made once a process as the JAX tool
# makes one per device count
_MESHES: dict = {}

KNOB_SPACE = {
    "SEARCHLITE_SPARSE_PACKED": ("0", "1"),
    "SEARCHLITE_TERM_SPLIT": ("0", "1"),
    "SEARCHLITE_BATCH_PRUNE": ("auto", "union"),
    "SEARCHLITE_DENSE_M_BYTES": ("0", str(256 << 20)),
    "SEARCHLITE_PRECISION": ("", "f32_strict", "bf16"),
    "SEARCHLITE_M_BUDGET_BYTES": ("", "200000"),
    "SEARCHLITE_SINGLE_SPARSE_MIN_DOCS": ("", "1000"),
    "SEARCHLITE_WAND_SPARSE_BLOCKS": ("", "8"),
    "SEARCHLITE_HEAVY_TERM_BLOCKS": ("", "4"),
    "SEARCHLITE_MESH_DENSE": ("", "0"),
    "SEARCHLITE_RUNS_FMT": ("", "4"),
    # host tier: on the card "force" keeps the size rule (small segments
    # on the CPU); on a CPU reader it flags them, so the tier's routing
    # runs (results must be unchanged either way)
    "SEARCHLITE_HOST_TIER": ("", "force"),
}

# the mesh's shard counts: a JAX run over 8 devices draws from (2, 4, 8)
MESH_DEVICES = 8


def _placement(reader) -> dict:
    """Where the reader's segments live, by device type (``plain``, the
    plain-version calls made while it was the iteration's reader, is
    added when the iteration ends)."""
    out: dict = {}
    for dseg in reader.device_segments:
        out[dseg.device.type] = out.get(dseg.device.type, 0) + 1
    return out


def run_iteration(it: int, seed: int, device: str = "cuda",
                  stats: dict | None = None) -> str | None:
    """One iteration of the campaign on ``device``: None when every check
    passed, else the repro header and the first mismatch. ``stats``, when
    given, receives the knobs, the kernels' launches and plain calls
    (``counts``) and each reader's placement with its plain calls
    (``placements``)."""
    before = kernel_counts()
    placements: list = []
    marks = [before]  # the counts as each reader took over
    rng = random.Random(seed)
    knobs = {}
    for key, choices in KNOB_SPACE.items():
        val = rng.choice(choices)
        if val == "":
            os.environ.pop(key, None)
        else:
            os.environ[key] = val
            knobs[key] = val
    on_card = device != "cpu"
    saved_tier_docs = os.environ.get("SEARCHLITE_HOST_TIER_DOCS")
    if on_card and knobs.get("SEARCHLITE_HOST_TIER") != "force":
        # no host tier unless drawn: every segment on the card
        os.environ["SEARCHLITE_HOST_TIER_DOCS"] = "0"
    try:
        return _iteration(it, seed, device, rng, knobs, placements, marks)
    finally:
        ends = marks[1:] + [kernel_counts()]
        for placement, start, end in zip(placements, marks, ends):
            placement["plain"] = sum(end[k][1] - start[k][1] for k in start)
        if on_card:
            if saved_tier_docs is None:
                os.environ.pop("SEARCHLITE_HOST_TIER_DOCS", None)
            else:
                os.environ["SEARCHLITE_HOST_TIER_DOCS"] = saved_tier_docs
        if stats is not None:
            stats.update(knobs=knobs, counts=counts_since(before),
                         placements=placements)


def _iteration(it, seed, device, rng, knobs, placements, marks):
    n_docs = rng.choice((500, 3000, 20000))
    vocab = rng.choice((50, 400, 3000))
    n_segments = rng.choice((1, 1, 2, 3))
    positions = rng.random() < 0.5
    delete_frac = rng.choice((0.0, 0.0, 0.05))
    limit = rng.choice((1, 3, 10))
    strict = held_tols(os.environ.get("SEARCHLITE_PRECISION", ""))

    index = build_corpus(rng, n_docs, vocab, positions, n_segments,
                         delete_frac, device=device)
    reader = index.reader()
    placements.append(_placement(reader))
    nq = rng.choice((7, 32, 128))
    queries = []
    for _ in range(nq):
        terms = [f"t{rng.randrange(vocab)}"
                 for _ in range(rng.randint(1, 5))]
        if rng.random() < 0.15 and terms:
            terms.append(terms[0])  # repeated term: count x idf weight
        queries.append(" ".join(terms))
    oracles = [oracle_scores(reader, q) for q in queries]

    header = (f"iter {it} seed {seed} docs={n_docs} vocab={vocab} "
              f"segs={n_segments} dels={delete_frac} nq={nq} "
              f"limit={limit} knobs={knobs} device={device} "
              f"placement={placements[0]}")
    for execution in ("bm25", "wand", "bmw"):
        rows = reader.search_batch_many([queries], limit=limit,
                                        execution=execution)[0]
        err = check_topk(queries, rows, oracles, strict,
                         f"batch/{execution}", limit)
        if err:
            return f"{header}\n{err}"
        s, i, g = reader.search_batch_many([queries], limit=limit,
                                           execution=execution,
                                           output="arrays")[0]
        arr_rows = []
        for qi in range(len(queries)):
            n = int((s[qi] != -np.inf).sum())
            arr_rows.append([
                (reader.segments[int(g[qi, j])].doc_id(int(i[qi, j])),
                 float(s[qi, j])) for j in range(n)])
        err = check_topk(queries, arr_rows, oracles, strict,
                         f"arrays/{execution}", limit)
        if err:
            return f"{header}\n{err}"
    # multi-batch stream: the same queries as 3 batches in ONE
    # search_batch_many call -- exercises the cross-batch fetch
    # bookkeeping (flat_vals cursor, fallback patch offsets
    # entry_off[bi] + li) that single-batch calls never touch
    thirds = [queries[0::3], queries[1::3], queries[2::3]]
    o_thirds = [oracles[0::3], oracles[1::3], oracles[2::3]]
    for execution in ("bm25", "wand"):
        outs = reader.search_batch_many(thirds, limit=limit,
                                        execution=execution)
        for b, (qs, rows, os_) in enumerate(zip(thirds, outs,
                                                o_thirds)):
            err = check_topk(qs, rows, os_, strict,
                             f"stream{b}/{execution}", limit)
            if err:
                return f"{header}\n{err}"

    # mesh execution: the doc-sharded batched path (per-shard candidate
    # strips + per-shard dense remainder, top-k merge) must match the
    # same oracle. The shards are logical, on the reader's device; the
    # draw is a JAX run's over 8 devices. Meshes are cached per process.
    if rng.random() < 0.5:
        n_dev = rng.choice((2, 4, MESH_DEVICES))
        mesh = _MESHES.get((n_dev, device))
        if mesh is None:
            import torch

            from searchlite_tpu_torch.parallel.mesh import make_mesh

            mesh = _MESHES[(n_dev, device)] = make_mesh(
                n_dev, devices=[torch.device(device)] * n_dev)
        for execution in ("bm25", "wand"):
            rows = reader.search_batch_many(
                [queries], limit=limit, execution=execution,
                mesh=mesh)[0]
            err = check_topk(queries, rows, oracles, strict,
                             f"mesh{n_dev}/{execution}", limit)
            if err:
                return f"{header}\n{err}"

    # structural merge mid-iteration (index/merge.py): fold all or
    # only the small segments, then re-validate the MERGED structures
    # against a fresh exact oracle (scores legitimately change when
    # tombstones expunge / df+avgdl fold corpus-wide, so the oracle is
    # recomputed from the merged reader). The remaining checks below
    # then run against the merged index -- free extra coverage.
    if rng.random() < 0.4:
        max_docs = rng.choice((None, max(1, n_docs // n_segments)))
        merged = index.merge_segments(max_docs=max_docs)
        if merged:
            header += f" MERGED({merged},max_docs={max_docs})"
            reader = index.reader()
            marks.append(kernel_counts())
            placements.append(_placement(reader))
            oracles = [oracle_scores(reader, q) for q in queries]
            for execution in ("bm25", "wand"):
                rows = reader.search_batch_many(
                    [queries], limit=limit, execution=execution)[0]
                err = check_topk(queries, rows, oracles, strict,
                                 f"merged/{execution}", limit)
                if err:
                    return f"{header}\n{err}"

    # per-query path on a subsample
    for q, oracle in list(zip(queries, oracles))[:8]:
        res = reader.search({"query": q, "limit": limit})
        row = [(h.doc_id, h.score) for h in res.hits]
        err = check_topk([q], [row], [oracle], strict, "single", limit)
        if err:
            return f"{header}\n{err}"

    # per-query FILTERS through every batched execution vs the
    # single-query path with the same filter (mask-table dedup, the
    # union pruned path's filter rows, and the dense fallbacks)
    def rand_filter():
        r = rng.random()
        if r < 0.35:
            return {"KeywordEq": {"field": "cat",
                                  "value": f"c{rng.randrange(6)}"}}
        if r < 0.6:
            lo = rng.randrange(97)
            return {"I64Range": {"field": "price", "min": lo,
                                 "max": lo + rng.randrange(1, 40)}}
        if r < 0.8:
            return {"Or": [
                {"KeywordEq": {"field": "cat",
                               "value": f"c{rng.randrange(5)}"}},
                {"KeywordEq": {"field": "cat",
                               "value": f"c{rng.randrange(5)}"}}]}
        return None
    sub_q = queries[: min(24, len(queries))]
    filters = [rand_filter() for _ in sub_q]
    # filtered oracle: the engine's own HOST-side mask evaluation
    # (query/filters.py, numpy -- deterministic, reference-semantics
    # tested) restricted over the f64 score oracle; the device paths
    # under test only ever see the mask as data
    from searchlite_tpu_torch.api.types import Filter
    from searchlite_tpu_torch.query.filters import compute_filters_mask

    def filtered_oracle(oracle, f):
        if f is None:
            return oracle
        keep: set[str] = set()
        for seg in reader.segments:
            mask = compute_filters_mask(seg.fast,
                                        [Filter.from_json(f)])
            for d in np.flatnonzero(mask):
                keep.add(seg.doc_id(int(d)))
        return {d: s for d, s in oracle.items() if d in keep}
    f_oracles = [filtered_oracle(o, f)
                 for o, f in zip(oracles[:len(sub_q)], filters)]
    for execution in ("bm25", "wand", "bmw"):
        rows = reader.search_batch_many(
            [sub_q], limit=limit, execution=execution,
            filters=[filters])[0]
        err = check_topk(sub_q, rows, f_oracles, strict,
                         f"filtered-batch/{execution}", limit)
        if err:
            return f"{header}\nfilters={filters}\n{err}"
    single_rows = []
    for q, f in zip(sub_q, filters):
        res = reader.search({"query": q, "limit": limit, "filter": f})
        single_rows.append([(h.doc_id, h.score) for h in res.hits])
    err = check_topk(sub_q, single_rows, f_oracles, strict,
                     "filtered-single", limit)
    if err:
        return f"{header}\nfilters={filters}\n{err}"

    # A/B routing check on the FULL single-query surface: the same
    # aggs + field-sort + filter request under (a) default routing and
    # (b) this iteration's knobs + a budget that forces the chunked
    # tile executor. Matched sets are exact across executors, so agg
    # counts and sort orders must agree exactly; f64 sums to small
    # tolerance (summation order).
    req = {"query": queries[0],
           "filter": filters[0],
           "limit": 10,
           "sort": [{"field": "price", "order": "desc"},
                    {"field": "_score", "order": "desc"}],
           "aggs": {"cats": {"type": "terms", "field": "cat"},
                    "ps": {"type": "stats", "field": "price"},
                    "ph": {"type": "histogram", "field": "price",
                           "interval": 25.0}}}
    saved = {k: os.environ.pop(k, None) for k in list(KNOB_SPACE)
             + ["SEARCHLITE_DEVICE_AGGS"]}
    res_a = reader.search(dict(req))
    for k, v in saved.items():
        if v is not None:
            os.environ[k] = v
    os.environ["SEARCHLITE_M_BUDGET_BYTES"] = "150000"
    os.environ["SEARCHLITE_DEVICE_AGGS"] = rng.choice(("0", "1"))
    try:
        res_b = reader.search(dict(req))
    finally:
        os.environ.pop("SEARCHLITE_DEVICE_AGGS", None)
        if saved.get("SEARCHLITE_M_BUDGET_BYTES") is not None:
            os.environ["SEARCHLITE_M_BUDGET_BYTES"] = \
                saved["SEARCHLITE_M_BUDGET_BYTES"]
        else:
            os.environ.pop("SEARCHLITE_M_BUDGET_BYTES", None)
    ids_a = [h.doc_id for h in res_a.hits]
    ids_b = [h.doc_id for h in res_b.hits]
    if ids_a != ids_b:
        return (f"{header}\nA/B sort: {req['query']!r} default "
                f"{ids_a} != knobs {ids_b}")
    ja = res_a.to_json().get("aggregations", {})
    jb = res_b.to_json().get("aggregations", {})
    e = agg_eq(ja, jb)
    if e:
        return f"{header}\nA/B aggs mismatch ({e})"
    return None


def agg_eq(a, b, path="aggs"):
    """None when two aggregation JSON trees agree: keys, lengths and
    non-float values exactly, floats to 1e-6 (f64 summation order)."""
    if isinstance(a, dict) != isinstance(b, dict):
        return f"{path}: shape"
    if isinstance(a, dict):
        if set(a) != set(b):
            return f"{path}: keys {set(a)} != {set(b)}"
        for k in a:
            e = agg_eq(a[k], b[k], f"{path}.{k}")
            if e:
                return e
        return None
    if isinstance(a, list):
        if len(a) != len(b):
            return f"{path}: len {len(a)} != {len(b)}"
        for i, (x, y) in enumerate(zip(a, b)):
            e = agg_eq(x, y, f"{path}[{i}]")
            if e:
                return e
        return None
    if isinstance(a, float) or isinstance(b, float):
        aa, bb = float(a), float(b)
        if abs(aa - bb) > 1e-6 + 1e-6 * abs(bb):
            return f"{path}: {a} != {b}"
        return None
    return None if a == b else f"{path}: {a} != {b}"


def main(argv=None) -> int:
    import argparse

    from searchlite_tpu_torch.tools._common import block_jax, require_device

    block_jax()
    ap = argparse.ArgumentParser()
    ap.add_argument("n_iters", nargs="?", type=int, default=50)
    ap.add_argument("seed", nargs="?", type=int, default=12345)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    require_device(args.device)
    t0 = time.time()
    for it in range(args.n_iters):
        seed = args.seed + it
        t1 = time.time()
        stats: dict = {}
        err = run_iteration(it, seed, args.device, stats)
        if err:
            print(f"FAIL\n{err}", flush=True)
            return 1
        print(f"iter {it} ok ({time.time()-t1:.1f}s, "
              f"total {time.time()-t0:.0f}s) seed={seed} "
              f"kernels={json.dumps(stats['counts'])} "
              f"placement={json.dumps(stats['placements'])}", flush=True)
    print("ALL OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
