"""The CLI and the HTTP server of the torch port
(``searchlite_tpu_torch/cli.py``, ``http_server.py``) against the JAX
package's: the cases of tests/test_surfaces.py, each driven through both
packages on directories of their own, the port with ``device="cpu"`` /
``--device cpu``, and the JSON that comes out compared (ids, counts and
shapes equal, scores within the f32_strict tolerance: rtol 1e-6, atol
1e-4). The mesh class: ``--mesh auto`` with one device of the reader's
type is ignored, ``--mesh 4 --device cpu`` runs four CPU shards; both give
the JSON the JAX surfaces give on their virtual devices.

``cli.py``, ``http_server.py`` and ``embed.py`` differ from the JAX
package's files by their device argument (and the port's own
``parse_mesh_spec``), so they are not in the verbatim-copy list of
tests/test_torch_host.py: this file and tests/test_torch_embed.py hold
them to the JAX surfaces instead."""

import concurrent.futures
import json
import os
import threading
import urllib.error
import urllib.request

import pytest

from searchlite_tpu import http_server as jax_http
from searchlite_tpu.cli import main as jax_cli
from searchlite_tpu_torch import http_server as port_http
from searchlite_tpu_torch.cli import main as port_cli
from searchlite_tpu_torch.parallel.mesh import parse_mesh_spec
from test_surfaces import DOCS, SCHEMA
from test_torch_search import assert_close_tree

READS = ("search", "search-batch")


@pytest.fixture(autouse=True)
def strict(monkeypatch):
    monkeypatch.setenv("SEARCHLITE_PRECISION", "f32_strict")
    monkeypatch.delenv("SEARCHLITE_TORCH_DEVICE", raising=False)


@pytest.fixture
def dirs(tmp_path):
    (tmp_path / "schema.json").write_text(json.dumps(SCHEMA))
    (tmp_path / "docs.jsonl").write_text(
        "\n".join(json.dumps(d) for d in DOCS))
    return tmp_path


class Both:
    """The same CLI command through both packages, each on its own index
    directory; returns the port's parsed stdout after holding it to the
    JAX package's."""

    def __init__(self, dirs, capsys):
        self.dirs = dirs
        self.capsys = capsys

    def run(self, command, *args, device=("--device", "cpu")):
        outs = []
        for name, main in (("jax", jax_cli), ("port", port_cli)):
            argv = [command, str(self.dirs / f"idx_{name}"),
                    *[str(a) for a in args]]
            if name == "port" and command in READS:
                argv += list(device)
            self.capsys.readouterr()
            assert main(argv) == 0, argv
            outs.append(self.capsys.readouterr().out)
        return outs

    def text(self, command, *args):
        j, p = self.run(command, *args)
        assert j.replace("idx_jax", "idx") == p.replace("idx_port", "idx")
        return p

    def json(self, command, *args, **kw):
        j, p = (json.loads(o) for o in self.run(command, *args, **kw))
        assert_close_tree(p, j, command)
        return p

    def seed(self):
        self.text("init", self.dirs / "schema.json")
        self.text("add", self.dirs / "docs.jsonl")
        self.text("commit")


@pytest.fixture
def both(dirs, capsys):
    return Both(dirs, capsys)


class TestCli:
    def test_init_add_commit_search(self, both):
        both.seed()
        out = both.json("search", "-q", "rust language", "--return-stored")
        assert out["total_hits_estimate"] >= 1
        assert out["hits"][0]["doc_id"] == "doc-1"
        assert out["hits"][0]["fields"]["body"].startswith("Rust")

    def test_search_with_filter_request_file(self, both, tmp_path):
        both.seed()
        request = {
            "query": {"type": "query_string", "query": "rust language",
                      "fields": ["body"]},
            "filter": {"And": [
                {"KeywordEq": {"field": "lang", "value": "en"}},
                {"I64Range": {"field": "year", "min": 2020, "max": 2025}},
            ]},
            "limit": 5, "return_stored": True}
        req_path = tmp_path / "request.json"
        req_path.write_text(json.dumps(request))
        out = both.json("search", "--request", req_path)
        assert out["hits"][0]["doc_id"] == "doc-1"

    def test_delete_and_inspect_and_compact(self, both, tmp_path):
        both.seed()
        ids = tmp_path / "ids.txt"
        ids.write_text("doc-2\n")
        both.text("delete", ids)
        both.text("commit")
        manifests = [json.loads(o) for o in both.run("inspect")]
        for manifest in manifests:
            assert sum(len(s["deleted_docs"])
                       for s in manifest["segments"]) == 1
        assert set(manifests[0]) == set(manifests[1])
        both.text("compact")
        out = both.json("search", "-q", "sqlite")
        assert out["total_hits_estimate"] == 0

    def test_search_batch_subcommand(self, both, tmp_path):
        both.seed()
        qfile = tmp_path / "queries.txt"
        qfile.write_text("database\n")
        out = both.json("search-batch", "-q", "rust", "--queries-file",
                        qfile, "--limit", 3)
        assert out["results"][0][0]["doc_id"] == "doc-1"
        assert out["results"][1][0]["doc_id"] == "doc-2"

    def test_sort_and_aggs_flags(self, both):
        both.seed()
        out = both.json(
            "search", "-q", "body:is", "--sort", "year:desc", "--aggs",
            json.dumps({"langs": {"type": "terms", "field": "lang"}}))
        assert [h["doc_id"] for h in out["hits"]] == ["doc-1", "doc-2"]
        assert out["aggregations"]["langs"]["buckets"][0]["key"] == "en"

    def test_merge_subcommand(self, both, tmp_path):
        both.seed()
        more = tmp_path / "more.jsonl"
        more.write_text(json.dumps({"_id": "doc-9", "body": "rust again",
                                    "lang": "en", "year": 2022}))
        both.text("update", more)
        both.text("commit")
        assert both.text("merge").strip() == "merged 2 segments"
        out = both.json("search", "-q", "rust")
        assert out["total_hits_estimate"] == 2

    def test_structured_batch(self, both, tmp_path):
        both.seed()
        qfile = tmp_path / "queries.jsonl"
        qfile.write_text("is\n" + json.dumps({
            "query": "is", "filter": {"I64Range": {
                "field": "year", "min": 2021, "max": 2025}},
            "limit": 1}) + "\n")
        out = both.json("search-batch", "--queries-file", qfile, "--limit",
                        "5", "--execution", "bmw")
        assert len(out["results"][0]) == 2
        assert [h["doc_id"] for h in out["results"][1]] == ["doc-1"]

    def test_mesh_auto_on_one_device_is_ignored(self, both):
        both.seed()
        plain = both.json("search", "-q", "is", "--limit", "5")
        for spec in ("auto", "1", "off"):
            got = both.json("search", "-q", "is", "--limit", "5",
                            device=("--device", "cpu", "--mesh", spec))
            assert got == plain
        batch = both.json("search-batch", "-q", "is", "-q", "database",
                          "--limit", "3",
                          device=("--device", "cpu", "--mesh", "auto"))
        assert [h["doc_id"] for h in batch["results"][1]] == ["doc-2"]

    def test_cli_mesh_shards_on_the_cpu(self, both, monkeypatch):
        """``--mesh 4 --device cpu`` runs four CPU shards (the JAX CLI runs
        four of its virtual devices): the same JSON as without a mesh, and
        as the JAX surfaces; ``auto`` on the one CPU device is ignored."""
        import searchlite_tpu_torch.api.reader as port_reader

        seen = []
        real_search = port_reader.IndexReader.search
        real_many = port_reader.IndexReader.search_batch_many

        def search(self, req, mesh=None):
            seen.append(mesh)
            return real_search(self, req, mesh=mesh)

        def many(self, *args, mesh=None, **kw):
            seen.append(mesh)
            return real_many(self, *args, mesh=mesh, **kw)

        monkeypatch.setattr(port_reader.IndexReader, "search", search)
        monkeypatch.setattr(port_reader.IndexReader, "search_batch_many",
                            many)
        both.seed()
        plain = both.json("search", "-q", "is", "--limit", "5")
        plain_batch = both.json("search-batch", "-q", "is", "-q",
                                "database", "--limit", "3")
        seen.clear()
        for spec in ("4", "auto"):
            got = both.json("search", "-q", "is", "--limit", "5", "--mesh",
                            spec)
            assert_close_tree(got, plain, spec)
        batch = both.json("search-batch", "-q", "is", "-q", "database",
                          "--limit", "3", "--mesh", "4")
        assert_close_tree(batch, plain_batch, "search-batch")
        assert [None if m is None else m.shape["shard"]
                for m in seen] == [4, None, 4]
        assert len(plain["hits"]) == 2

    def test_bad_mesh_spec_exits_2(self, both, dirs):
        both.seed()
        for main, name, extra in ((jax_cli, "jax", []),
                                  (port_cli, "port", ["--device", "cpu"])):
            with pytest.raises(SystemExit) as exc:
                main(["search", str(dirs / f"idx_{name}"), "-q", "is",
                      "--mesh", "many", *extra])
            assert exc.value.code == 2

    def test_default_device_is_the_card(self, both, dirs, monkeypatch,
                                        capsys):
        """No --device: the reader is asked for the card and raises where
        CUDA is absent; the environment can ask for the CPU instead."""
        import torch

        both.seed()
        argv = ["search", str(dirs / "idx_port"), "-q", "rust"]
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="needs a CUDA device"):
                port_cli(argv)
        monkeypatch.setenv("SEARCHLITE_TORCH_DEVICE", "cpu")
        capsys.readouterr()
        assert port_cli(argv) == 0
        assert json.loads(capsys.readouterr().out)["hits"][0]["doc_id"] \
            == "doc-1"


def test_parse_mesh_spec_one_device_rule(monkeypatch):
    import torch

    for spec in (None, "", "off", "none", "0", 0, "1", 1):
        assert parse_mesh_spec(spec) is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert parse_mesh_spec("auto") is None
    with pytest.raises(ValueError, match="invalid mesh spec"):
        parse_mesh_spec("many")
    # more than one device takes part: a mesh, round robin on the cards
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    for spec, n in (("auto", 4), ("4", 4), (2, 2)):
        assert parse_mesh_spec(spec).shape == {"query": 1, "shard": n}
    assert parse_mesh_spec("off") is None


# -- HTTP -------------------------------------------------------------------

def call(base, method, path, payload=None, raw=None,
         content_type="application/json"):
    data = raw if raw is not None else (
        json.dumps(payload).encode() if payload is not None else None)
    req = urllib.request.Request(
        f"{base}{path}", data=data, method=method,
        headers={"content-type": content_type} if data else {})
    try:
        with urllib.request.urlopen(req) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def strip_volatile(body):
    """Drop what two index directories can never share: uuids, commit
    times, segment ids, paths."""
    if isinstance(body, dict):
        return {k: strip_volatile(v) for k, v in body.items()
                if k not in ("uuid", "committed_at", "path", "id",
                             "checksums", "created_at")}
    if isinstance(body, list):
        return [strip_volatile(v) for v in body]
    return body


class Servers:
    def __init__(self, tmp_path, **kw):
        self.servers = [
            jax_http.make_server(str(tmp_path / "idx_jax"),
                                 bind="127.0.0.1:0", **kw),
            port_http.make_server(str(tmp_path / "idx_port"),
                                  bind="127.0.0.1:0", device="cpu", **kw)]
        self.bases = []
        for server in self.servers:
            threading.Thread(target=server.serve_forever,
                             daemon=True).start()
            host, port = server.server_address
            self.bases.append(f"http://{host}:{port}")
        self.port = self.bases[1]

    def call(self, method, path, payload=None, **kw):
        """The request to both servers; the port's (status, body), held to
        the JAX server's."""
        (js, jb), (ps, pb) = (call(base, method, path, payload, **kw)
                              for base in self.bases)
        assert ps == js, (path, ps, pb, js, jb)
        assert_close_tree(strip_volatile(pb), strip_volatile(jb), path)
        return ps, pb

    def seed(self):
        self.call("POST", "/init", {"schema": SCHEMA})
        ndjson = "\n".join(json.dumps(d) for d in DOCS).encode()
        self.call("POST", "/add", raw=ndjson,
                  content_type="application/x-ndjson")
        self.call("POST", "/commit")

    def shutdown(self):
        for server in self.servers:
            server.shutdown()
            server.server_close()


@pytest.fixture
def servers(tmp_path):
    s = Servers(tmp_path)
    yield s
    s.shutdown()


class TestHttp:
    def test_full_lifecycle(self, servers):
        status, body = servers.call("GET", "/healthz")
        assert status == 200 and body["status"] == "ok"
        status, body = servers.call("POST", "/search",
                                    {"query": "x", "limit": 1})
        assert status == 404 and body["error"]["type"] == "index_missing"
        status, body = servers.call("POST", "/init", {"schema": SCHEMA})
        assert status == 200 and body["created"]
        status, _ = servers.call("POST", "/init", {"schema": SCHEMA})
        assert status == 409
        ndjson = "\n".join(json.dumps(d) for d in DOCS).encode()
        status, body = servers.call("POST", "/add", raw=ndjson,
                                    content_type="application/x-ndjson")
        assert status == 200 and body["queued"] == 3
        status, body = servers.call("POST", "/commit")
        assert status == 200 and body["committed"]
        status, body = servers.call("POST", "/search",
                                    {"query": "rust", "limit": 5})
        assert status == 200 and body["total_hits_estimate"] == 1
        assert body["hits"][0]["doc_id"] == "doc-1"
        status, body = servers.call(
            "POST", "/search_batch",
            {"queries": ["rust", "nosuchterm"], "limit": 5})
        assert status == 200
        assert body["results"][0][0]["doc_id"] == "doc-1"
        assert body["results"][1] == []
        status, _ = servers.call("POST", "/search_batch",
                                 {"queries": "rust"})
        assert status == 400
        status, body = servers.call("GET", "/stats")
        assert status == 200 and body["documents"] == 3
        status, body = servers.call("POST", "/bulk", {"docs": [
            {"_id": "doc-4", "body": "more rust content", "lang": "en",
             "year": 2025}]})
        assert status == 200 and body["queued"] == 1
        servers.call("POST", "/commit")
        _, body = servers.call("POST", "/search",
                               {"query": "rust", "limit": 5})
        assert body["total_hits_estimate"] == 2
        status, body = servers.call("POST", "/delete", {"ids": ["doc-4"]})
        assert status == 200 and body["queued"] == 1
        servers.call("POST", "/commit")
        # an acknowledged delete is read back before any compaction
        _, body = servers.call("POST", "/search",
                               {"query": "rust", "limit": 5})
        assert body["total_hits_estimate"] == 1
        status, body = servers.call("POST", "/merge", {"max_docs": 100})
        assert status == 200 and body["merged_segments"] == 2
        status, _ = servers.call("POST", "/merge", {"max_docs": "x"})
        assert status == 400
        status, _ = servers.call("POST", "/refresh")
        assert status == 200
        status, _ = servers.call("POST", "/compact")
        assert status == 200
        status, body = servers.call("GET", "/inspect")
        assert status == 200 and len(body["segments"]) == 1
        _, body = servers.call("POST", "/search",
                               {"query": "rust", "limit": 5})
        assert body["total_hits_estimate"] == 1

    def test_body_limit_413(self, tmp_path, monkeypatch):
        monkeypatch.setenv("SEARCHLITE_MAX_BODY_BYTES", str(64 * 1024))
        servers = Servers(tmp_path)
        try:
            servers.call("POST", "/init", {"schema": SCHEMA})
            big = b'{"_id": "x", "body": "' + b"a" * (200 * 1024) + b'"}'
            status, body = servers.call(
                "POST", "/add", raw=big,
                content_type="application/x-ndjson")
            assert status == 413
            assert body["error"]["type"] == "body_too_large"
            status, _ = servers.call("POST", "/bulk", raw=big)
            assert status == 413
        finally:
            servers.shutdown()

    def test_ndjson_reader(self, servers):
        """Blank lines, a missing final newline, CRLF, and a bad line
        reported by its number."""
        servers.call("POST", "/init", {"schema": SCHEMA})
        lines = [json.dumps(d) for d in DOCS]
        raw = ("\n\n" + lines[0] + "\r\n" + lines[1] + "\n\n"
               + lines[2]).encode()
        status, body = servers.call("POST", "/add", raw=raw,
                                    content_type="application/x-ndjson")
        assert status == 200 and body["queued"] == 3
        status, body = servers.call(
            "POST", "/add", raw=(lines[0] + "\n{oops\n").encode(),
            content_type="application/x-ndjson")
        assert status == 400
        assert body["error"]["type"] == "invalid_document"
        assert "line 2" in body["error"]["reason"]
        status, body = servers.call("POST", "/add", raw=b"\n",
                                    content_type="application/x-ndjson")
        assert status == 200 and body["queued"] == 0

    def test_concurrent_searches(self, servers):
        servers.seed()

        def one(i):
            q = ["rust", "database", "algebra"][i % 3]
            status, body = servers.call("POST", "/search",
                                        {"query": q, "limit": 5})
            return status, body["total_hits_estimate"]

        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            results = list(pool.map(one, range(24)))
        assert results == [(200, 1)] * 24

    def test_error_shapes(self, servers):
        servers.call("POST", "/init", {"schema": SCHEMA})
        status, body = servers.call("POST", "/bulk", {"docs": []})
        assert status == 400
        assert body["error"]["type"] == "missing_documents"
        status, body = servers.call("POST", "/delete", {"ids": []})
        assert status == 400 and body["error"]["type"] == "missing_ids"
        status, body = servers.call("POST", "/delete", {"ids": [" "]})
        assert status == 400 and body["error"]["type"] == "invalid_id"
        status, body = servers.call("POST", "/search",
                                    {"query": "x", "limit": 0})
        assert status == 400
        assert body["error"]["type"] == "search_failed"
        status, body = servers.call("POST", "/search", raw=b"{nope")
        assert status == 400 and body["error"]["type"] == "invalid_json"
        status, body = servers.call("GET", "/nowhere")
        assert status == 404 and body["error"]["type"] == "not_found"
        assert set(body["error"]) == {"type", "reason"}

    def test_structured_batch(self, servers):
        servers.seed()
        status, body = servers.call("POST", "/search_batch", {"queries": [
            "is",
            {"query": "is", "filter": {"I64Range": {
                "field": "year", "min": 2021, "max": 2025}}, "limit": 1},
        ], "limit": 5})
        assert status == 200
        assert len(body["results"][0]) == 2
        assert [h["doc_id"] for h in body["results"][1]] == ["doc-1"]
        for bad in ({"queries": ["is"], "filters": []},
                    {"queries": ["is"], "limits": [1, 2]},
                    {"queries": [7]}):
            status, body = servers.call("POST", "/search_batch", bad)
            assert status == 400 and body["error"]["type"] == "bad_request"

    def test_commit_reopens_by_clone(self, servers):
        """A /delete + /commit that only tombstones: the port's next
        reader shares the segment's tensors with the one before."""
        servers.seed()
        state = servers.servers[1].RequestHandlerClass.state
        before = state.reader().device_segments[0]
        servers.call("POST", "/delete", {"ids": ["doc-2"]})
        servers.call("POST", "/commit")
        after = state.reader().device_segments[0]
        assert after is not before
        assert after.block_docs is before.block_docs
        assert after.block_impacts is before.block_impacts
        assert after.live_docs == before.live_docs - 1
        _, body = servers.call("POST", "/search",
                               {"query": "database", "limit": 5})
        assert body["total_hits_estimate"] == 0


def test_mesh_auto_on_one_device_is_ignored_http(tmp_path):
    servers = Servers(tmp_path, mesh="auto")
    try:
        servers.seed()
        # the JAX test process has 8 virtual devices and shards; the port
        # sees at most one device here and ignores the flag: same answers
        _, body = servers.call("POST", "/search", {"query": "is",
                                                   "limit": 5})
        assert [h["doc_id"] for h in body["hits"]] == ["doc-1", "doc-2"]
        _, body = servers.call("POST", "/search_batch",
                               {"queries": ["is", "tpus"], "limit": 3})
        assert len(body["results"][0]) == 2
        assert body["results"][1][0]["doc_id"] == "doc-3"
        state = servers.servers[1].RequestHandlerClass.state
        assert state.mesh is None and state.mesh_spec is None
    finally:
        servers.shutdown()


def test_http_mesh_four_cpu_shards(tmp_path):
    """A server with ``mesh=4`` on the CPU builds one 4-shard mesh for its
    life and answers as the JAX server on four virtual devices."""
    servers = Servers(tmp_path, mesh=4)
    try:
        servers.seed()
        _, body = servers.call("POST", "/search", {"query": "is",
                                                   "limit": 5})
        assert [h["doc_id"] for h in body["hits"]] == ["doc-1", "doc-2"]
        _, body = servers.call("POST", "/search_batch",
                               {"queries": ["is", "tpus"], "limit": 3})
        assert len(body["results"][0]) == 2
        assert body["results"][1][0]["doc_id"] == "doc-3"
        _, body = servers.call("POST", "/search", {
            "query": "is", "limit": 5,
            "aggs": {"langs": {"type": "terms", "field": "lang"}}})
        assert body["aggregations"]["langs"]["buckets"]
        state = servers.servers[1].RequestHandlerClass.state
        mesh = state.mesh
        assert mesh.shape == {"query": 1, "shard": 4}
        assert state.mesh is mesh  # one mesh a server
    finally:
        servers.shutdown()


def test_server_default_device_is_the_card(tmp_path, monkeypatch):
    """No device argument: the server's reader is asked for the card; where
    CUDA is absent a search answers with the reader's error, in the error
    shape. SEARCHLITE_TORCH_DEVICE=cpu asks for the CPU."""
    import torch

    def serve():
        server = port_http.make_server(str(tmp_path / "idx"),
                                       bind="127.0.0.1:0")
        threading.Thread(target=server.serve_forever, daemon=True).start()
        host, port = server.server_address
        return server, f"http://{host}:{port}"

    server, base = serve()
    try:
        call(base, "POST", "/init", {"schema": SCHEMA})
        call(base, "POST", "/bulk", {"docs": DOCS})
        # writes need no device
        assert call(base, "POST", "/commit",
                    )[0] == (200 if torch.cuda.is_available() else 500)
        status, body = call(base, "POST", "/search",
                            {"query": "rust", "limit": 5})
        if not torch.cuda.is_available():
            assert status == 500 and body["error"]["type"] == "internal"
            assert "needs a CUDA device" in body["error"]["reason"]
    finally:
        server.shutdown()
        server.server_close()
    monkeypatch.setenv("SEARCHLITE_TORCH_DEVICE", "cpu")
    server, base = serve()
    try:
        status, body = call(base, "POST", "/search",
                            {"query": "rust", "limit": 5})
        assert status == 200 and body["hits"][0]["doc_id"] == "doc-1"
    finally:
        server.shutdown()
        server.server_close()


def test_port_handler_covers_every_openapi_route(tmp_path):
    """Every (method, path) of openapi.yaml is a route of the port's
    handler: none answers `not_found`."""
    yaml = pytest.importorskip("yaml")
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(here, "openapi.yaml")) as fh:
        spec = yaml.safe_load(fh)
    server = port_http.make_server(str(tmp_path / "idx"),
                                   bind="127.0.0.1:0", device="cpu")
    threading.Thread(target=server.serve_forever, daemon=True).start()
    host, port = server.server_address
    base = f"http://{host}:{port}"
    seen = 0
    try:
        for path, methods in spec["paths"].items():
            for method in methods:
                if method.upper() not in ("GET", "POST"):
                    continue
                status, body = call(base, method.upper(), path,
                                    {} if method.upper() == "POST"
                                    else None)
                assert not (status == 404 and body.get("error", {}).get(
                    "type") == "not_found"), (method, path)
                seen += 1
    finally:
        server.shutdown()
        server.server_close()
    assert seen >= 13
