"""The torch port runs without JAX and never falls back to the CPU.

A subprocess blocks ``import jax`` (``sys.modules["jax"] = None``),
imports every module of searchlite_tpu_torch, ingests a small index
through the shared writer and searches it through the port's reader: a
GPU deployment of the port need not have JAX installed. A CUDA reader
must raise where there is no CUDA."""

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
sys.path.insert(0, REPO)
import searchlite_tpu_torch
for info in pkgutil.walk_packages(searchlite_tpu_torch.__path__,
                                  "searchlite_tpu_torch."):
    importlib.import_module(info.name)
from searchlite_tpu.api.types import IndexOptions, StorageType
from searchlite_tpu.index import Index
from searchlite_tpu.index.manifest import Schema
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
reader = IndexReader(idx, device="cpu")
pairs = reader.search_batch(["w3 w5", "alpha", "nothing"], limit=4)
scores, ids, segs = reader.search_batch_many(
    [["w3 w5", "w1"]], limit=3, output="arrays")[0]
assert len(pairs[0]) == 4 and len(pairs[1]) == 4 and pairs[2] == []
assert scores.shape == (2, 3) and COUNTS.plain > 0
loaded = [m for m, mod in sys.modules.items()
          if mod is not None and (m == "jax" or m.startswith("jax."))]
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
