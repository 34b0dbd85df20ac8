"""HTTP soak of the port's server: concurrent writers and readers, then a
check against an independent reader.

    python -m searchlite_tpu_torch.tools.soak_http [SECONDS] [--device cuda]
        [--mesh N]

The counterpart of ``tools/soak_http.py``. Starts the port's HTTP server
(``http_server.make_server``) in this process on ``127.0.0.1:0``, over a
fresh index under the checkout's ``build/`` (removed at the end), on the
card unless ``--device cpu``, doc-sharded when ``--mesh N`` is given.
Then for ``SECONDS`` (default 120):

- one writer thread posts NDJSON ``/add`` batches of 5-80 docs (ASCII
  and unicode words, a keyword ``tag``, a numeric ``price``), ``/delete``s
  a few live ids one time in five, and ``/commit``s after each batch;
- two reader threads post ``/search`` (40% with a ``tag`` filter, 30%
  with a terms aggregation) and, 15% of the time, a 4-query
  ``/search_batch``.

Then a final ``/commit``, and the server's answers (``/stats``' document
count, the per-tag terms counts over ``match_all``, the top 20 of six
words) are held to what the writer tracked and to a reader opened
independently on the same directory (the segment caches cleared first):
counts equal, hits equal with scores to 4 decimals.

Prints ONE JSON summary line (traffic counts, errors, violations, the
card's name and power limit) and exits 1 on any error or violation, 2 when
``--device cuda`` finds no card.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import shutil
import sys
import threading
import time
import urllib.error
import urllib.request

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

SCHEMA = {
    "text_fields": [{"name": "body", "analyzer": "default",
                     "stored": False, "indexed": True}],
    "keyword_fields": [{"name": "tag", "stored": False,
                        "indexed": True, "fast": True}],
    "numeric_fields": [{"name": "price", "i64": False,
                        "stored": False, "fast": True}],
}
WORDS = ["alpha", "beta", "gamma", "delta", "omega", "zürich",
         "café", "search", "engine", "tpu", "sparse", "dense"]
TAGS = ["a", "b", "c", "d"]


def post(base, route, data: bytes, ctype="application/json", timeout=120):
    req = urllib.request.Request(f"{base}{route}", data=data,
                                 headers={"content-type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read())
    except urllib.error.HTTPError as e:
        raise RuntimeError(
            f"{route} -> {e.code}: {e.read()[:300]!r}") from None


def get(base, route, timeout=120):
    with urllib.request.urlopen(f"{base}{route}", timeout=timeout) as r:
        return json.loads(r.read())


def soak(seconds: float, device: str, mesh=None) -> dict:
    """Run the soak; returns the summary (``violations`` and ``n_errors``
    say whether it passed)."""
    from searchlite_tpu_torch import http_server
    from searchlite_tpu_torch.api.types import IndexOptions
    from searchlite_tpu_torch.device.index import clear_segment_caches
    from searchlite_tpu_torch.index import Index

    idx_dir = os.path.join(REPO, "build", f"soak_http_{os.getpid()}")
    shutil.rmtree(idx_dir, ignore_errors=True)
    os.makedirs(os.path.dirname(idx_dir), exist_ok=True)
    server = http_server.make_server(idx_dir, bind="127.0.0.1:0",
                                     mesh=mesh, device=device)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.server_address
    base = f"http://{host}:{port}"
    stop = threading.Event()
    stats = {"added": 0, "deleted": 0, "commits": 0, "searches": 0,
             "batches": 0, "errors": []}
    lock = threading.Lock()
    docs_alive: dict[str, dict] = {}
    try:
        post(base, "/init", json.dumps({"schema": SCHEMA}).encode())
        next_id = [0]

        def writer():
            rng = random.Random(1)
            while not stop.is_set():
                batch = []
                for _ in range(rng.randint(5, 80)):
                    did = str(next_id[0])
                    next_id[0] += 1
                    batch.append({"_id": did,
                                  "body": " ".join(rng.choices(
                                      WORDS, k=rng.randint(1, 8))),
                                  "tag": rng.choice(TAGS),
                                  "price": round(rng.uniform(0, 99), 2)})
                lines = "\n".join(json.dumps(d, ensure_ascii=False)
                                  for d in batch)
                try:
                    post(base, "/add", lines.encode(),
                         ctype="application/x-ndjson")
                    with lock:
                        for d in batch:
                            docs_alive[d["_id"]] = d
                        stats["added"] += len(batch)
                    if rng.random() < 0.2 and docs_alive:
                        with lock:
                            victims = rng.sample(sorted(docs_alive),
                                                 k=min(5, len(docs_alive)))
                        post(base, "/delete",
                             json.dumps({"ids": victims}).encode())
                        with lock:
                            for v in victims:
                                docs_alive.pop(v, None)
                            stats["deleted"] += len(victims)
                    post(base, "/commit", b"{}")
                    with lock:
                        stats["commits"] += 1
                except Exception as e:  # noqa: BLE001
                    with lock:
                        stats["errors"].append(f"writer: {e}")
                time.sleep(0.01)

        def reader(seed):
            rng = random.Random(seed)
            while not stop.is_set():
                try:
                    req = {"query": " ".join(rng.choices(
                        WORDS, k=rng.randint(1, 3))), "limit": 10}
                    if rng.random() < 0.4:
                        req["filter"] = {"KeywordEq": {
                            "field": "tag", "value": rng.choice(TAGS)}}
                    if rng.random() < 0.3:
                        req["aggs"] = {"tags": {"type": "terms",
                                                "field": "tag"}}
                    out = post(base, "/search", json.dumps(req).encode())
                    if "hits" not in out:
                        raise RuntimeError(f"/search answered {out}")
                    with lock:
                        stats["searches"] += 1
                    if rng.random() < 0.15:
                        out = post(base, "/search_batch", json.dumps(
                            {"queries": rng.choices(WORDS, k=4),
                             "limit": 5}).encode())
                        if "results" not in out:
                            raise RuntimeError(f"/search_batch answered "
                                               f"{out}")
                        with lock:
                            stats["batches"] += 1
                except Exception as e:  # noqa: BLE001
                    with lock:
                        stats["errors"].append(f"reader: {e}")
                        if len(stats["errors"]) > 20:
                            stop.set()

        threads = [threading.Thread(target=writer, daemon=True)]
        threads += [threading.Thread(target=reader, args=(s,), daemon=True)
                    for s in (2, 3)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        deadline = time.time() + seconds
        while time.time() < deadline and not stop.is_set():
            time.sleep(1)
            with lock:
                print(f"t={time.perf_counter() - t0:.0f}s added="
                      f"{stats['added']} commits={stats['commits']} "
                      f"searches={stats['searches']} errors="
                      f"{len(stats['errors'])}", file=sys.stderr,
                      flush=True)
        stop.set()
        for t in threads:
            t.join(timeout=120)
        elapsed = time.perf_counter() - t0

        # the final state through the server
        post(base, "/commit", b"{}")
        http_stats = get(base, "/stats")
        sample = random.Random(9).sample(WORDS, k=6)
        http_answers = {w: post(base, "/search", json.dumps(
            {"query": w, "limit": 20}).encode()) for w in sample}
        http_tags = post(base, "/search", json.dumps(
            {"query": {"type": "match_all"}, "limit": 1,
             "aggs": {"tags": {"type": "terms", "field": "tag",
                               "size": 10}}}).encode())
        mesh_used = server.RequestHandlerClass.state.mesh
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)

    # an independent reader on the same directory
    clear_segment_caches()
    direct = Index.open(IndexOptions(path=idx_dir, create_if_missing=False,
                                     bm25_k1=0.9, bm25_b=0.4))
    reader_api = direct.reader(device=device)
    violations = []
    want_docs = len(docs_alive)
    got_docs = http_stats.get("documents")
    direct_docs = sum(len(s.doc_ids) - len(s.meta.deleted_docs)
                      for s in reader_api.segments)
    if not want_docs == got_docs == direct_docs:
        violations.append(f"doc counts differ: tracked={want_docs} "
                          f"http={got_docs} direct={direct_docs}")
    for w, http_out in http_answers.items():
        mine = reader_api.search({"query": w, "limit": 20})
        got = [(h["doc_id"], round(h["score"], 4))
               for h in http_out["hits"]]
        want = [(h.doc_id, round(h.score, 4)) for h in mine.hits]
        if got != want or http_out["total_hits_estimate"] \
                != mine.total_hits_estimate:
            violations.append(f"query {w!r}: http != direct")
    want_tags: dict[str, int] = {}
    for d in docs_alive.values():
        want_tags[d["tag"]] = want_tags.get(d["tag"], 0) + 1
    got_tags = {b["key"]: b["doc_count"]
                for b in http_tags["aggregations"]["tags"]["buckets"]}
    direct_tags = {b["key"]: b["doc_count"] for b in reader_api.search(
        {"query": {"type": "match_all"}, "limit": 1,
         "aggs": {"tags": {"type": "terms", "field": "tag", "size": 10}}}
    ).aggregations["tags"]["buckets"]}
    if not got_tags == want_tags == direct_tags:
        violations.append(f"tag agg: http={got_tags} tracked={want_tags} "
                          f"direct={direct_tags}")
    shutil.rmtree(idx_dir, ignore_errors=True)
    return {"bench": "soak_http", "seconds": round(elapsed, 1),
            "device": device,
            "mesh": None if mesh_used is None else mesh_used.shape,
            **{k: v for k, v in stats.items() if k != "errors"},
            "segments": http_stats.get("segments"),
            "n_errors": len(stats["errors"]),
            "errors": stats["errors"][:10], "violations": violations}


def main(argv=None) -> int:
    from searchlite_tpu_torch.tools._common import require_device

    ap = argparse.ArgumentParser()
    ap.add_argument("seconds", nargs="?", type=float, default=120.0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--mesh", default=None,
                    help="run the server doc-sharded over this many shards")
    args = ap.parse_args(argv)
    require_device(args.device)
    card = None
    if args.device == "cuda":
        from searchlite_tpu_torch.tools._common import card_line

        card = card_line()
    summary = soak(args.seconds, args.device, args.mesh)
    summary["card"] = card
    print(json.dumps(summary), flush=True)
    for v in summary["violations"]:
        print("VIOLATION:", v, file=sys.stderr)
    return 1 if summary["violations"] or summary["n_errors"] else 0


if __name__ == "__main__":
    sys.exit(main())
