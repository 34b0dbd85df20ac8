"""The torch port runs without JAX and without the JAX package, and never
falls back to the CPU.

A subprocess blocks ``import jax`` and ``import searchlite_tpu``
(``sys.modules[...] = None``), imports every module of
searchlite_tpu_torch, ingests a small index through the port's own
``Index`` and writer and searches it through the port's reader: a GPU
deployment of the port needs neither. An AST scan holds every module of
the port and ``chip_smoke.py`` to no import of ``searchlite_tpu``, at any
depth. A CUDA reader must raise where there is no CUDA."""

import ast
import os
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["searchlite_tpu"] = None
sys.path.insert(0, REPO)
import searchlite_tpu_torch
for info in pkgutil.walk_packages(searchlite_tpu_torch.__path__,
                                  "searchlite_tpu_torch."):
    importlib.import_module(info.name)
from searchlite_tpu_torch.api.types import IndexOptions, StorageType
from searchlite_tpu_torch.index import Index
from searchlite_tpu_torch.index.manifest import Schema
from searchlite_tpu_torch.api.reader import IndexReader
from searchlite_tpu_torch.ops.strip_topk import COUNTS
idx = Index.create(
    IndexOptions(path="", create_if_missing=True,
                 storage=StorageType.IN_MEMORY),
    Schema.from_json({"text_fields": [{"name": "body",
                                       "analyzer": "default",
                                       "stored": False, "indexed": True}]}))
w = idx.writer()
for i in range(300):
    w.add_document({"_id": str(i), "body": f"alpha w{i % 7} w{i % 13}"})
w.commit()
reader = idx.reader(device="cpu")
assert isinstance(reader, IndexReader)
pairs = reader.search_batch(["w3 w5", "alpha", "nothing"], limit=4)
scores, ids, segs = reader.search_batch_many(
    [["w3 w5", "w1"]], limit=3, output="arrays")[0]
assert len(pairs[0]) == 4 and len(pairs[1]) == 4 and pairs[2] == []
assert scores.shape == (2, 3) and COUNTS.plain > 0
loaded = [m for m, mod in sys.modules.items()
          if mod is not None and (m == "jax" or m.startswith("jax.")
                                  or m == "searchlite_tpu"
                                  or m.startswith("searchlite_tpu."))]
assert not loaded, loaded
print("NO-JAX-OK", pairs[0][0][0])
"""


def test_port_runs_with_jax_blocked():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT.replace("REPO", repr(REPO))],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "NO-JAX-OK" in res.stdout


def test_package_source_never_imports_jax():
    jax_import = re.compile(r"^\s*(import|from)\s+jax(\.|\s|$)")
    root = os.path.join(REPO, "searchlite_tpu_torch")
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(dirpath, name)) as fh:
                    for line in fh:
                        assert not jax_import.match(line), \
                            f"{name}: {line.strip()}"


def jax_package_imports(path: str) -> list[str]:
    """Every import of ``searchlite_tpu`` or a module under it in one file,
    at any depth (functions, conditionals), as "line: module"."""
    with open(path) as fh:
        tree = ast.parse(fh.read(), filename=path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        found += [f"{node.lineno}: {n}" for n in names
                  if n == "searchlite_tpu" or n.startswith("searchlite_tpu.")]
    return found


def test_port_never_imports_the_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _dirs, names in os.walk(
            os.path.join(REPO, "searchlite_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    assert len(files) > 40
    offenders = {os.path.relpath(f, REPO): jax_package_imports(f)
                 for f in files}
    assert not {f: v for f, v in offenders.items() if v}


def test_import_scan_sees_nested_imports(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import os\n"
                     "def f():\n"
                     "    if True:\n"
                     "        from searchlite_tpu.ops import impact\n"
                     "    import searchlite_tpu_torch.ops\n"
                     "    import searchlite_tpu\n")
    assert sorted(jax_package_imports(str(probe))) == [
        "4: searchlite_tpu.ops", "6: searchlite_tpu"]


def test_cuda_reader_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the refusal is for hosts without")
    from searchlite_tpu.api.types import IndexOptions, StorageType
    from searchlite_tpu.index import Index
    from searchlite_tpu.index.manifest import Schema
    from searchlite_tpu_torch.api.reader import IndexReader

    idx = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY),
        Schema.from_json({"text_fields": [{"name": "body",
                                           "analyzer": "default"}]}))
    with pytest.raises(RuntimeError, match="CUDA"):
        IndexReader(idx, device="cuda")
