"""The port's bench row (searchlite_tpu_torch/tools/bench.py) and its
same-run C++ baseline (searchlite_tpu_torch/native: ``CpuEngine``).

The engine binding must give what the JAX package's binding gives on the
same segment, and what the port's reader returns, in all three modes. The
bench script runs in a subprocess on the CPU at a tiny corpus (it blocks
``jax`` and ``searchlite_tpu`` in ``sys.modules``, so it cannot share this
process): its oracle gate must pass for bm25, wand and the arrays rows,
and the row names of ``bench.py`` must be there."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from searchlite_tpu.native import CpuEngine as JaxCpuEngine
from searchlite_tpu_torch.native import CpuEngine, build_cpu_engine_lib
from test_torch_tiles import build_corpus, open_readers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    if build_cpu_engine_lib() is None:
        pytest.skip("no C++ toolchain")
    path = tmp_path_factory.mktemp("torch_bench")
    vocab, rng = build_corpus(path, seed=77, segments=1,
                              docs_per_segment=800, delete=0)
    queries = [" ".join(rng.sample(vocab, k=rng.randint(1, 5)))
               for _ in range(40)]
    return (*open_readers(path), queries)


@pytest.mark.parametrize("mode", ["bm25", "wand", "bmw"])
def test_cpu_engine_matches_jax_binding_and_reader(corpus, mode):
    jreader, treader, queries = corpus
    eng, jeng = CpuEngine(treader.segments[0]), \
        JaxCpuEngine(jreader.segments[0])
    qtids = np.full((len(queries), 5), -1, dtype=np.int32)
    for qi, q in enumerate(queries):
        for ti, tok in enumerate(q.split()):
            qtids[qi, ti] = eng.tid(f"body:{tok}")
            assert qtids[qi, ti] == jeng.tid(f"body:{tok}")
    assert eng.tid("body:missing") == -1
    ids, scores = eng.search_batch(qtids, k=10, mode=mode)
    jids, jscores = jeng.search_batch(qtids, k=10, mode=mode)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(scores, jscores)
    expected = treader.search_batch(queries, limit=10)
    seg = treader.segments[0]
    for qi, want in enumerate(expected):
        n = int((ids[qi] >= 0).sum())
        assert [seg.doc_id(int(d)) for d in ids[qi, :n]] == \
            [d for d, _ in want]
        np.testing.assert_allclose(scores[qi, :n], [s for _, s in want],
                                   rtol=1e-5, atol=1e-4)


def test_bench_script_passes_its_gate_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-m", "searchlite_tpu_torch.tools.bench",
         "--device", "cpu", "--docs", "3000", "--repeat", "1"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    detail = out["detail"]
    assert detail["verified_vs_oracle"] is True
    assert detail["verified"] == {"bm25": True, "wand": True,
                                  "arrays": True, "arrays_b4096": True}
    assert out["unit"] == "qps" and out["value"] > 0
    for key in ("qps_protocol_b1024", "qps_bm25", "qps_wand",
                "qps_bm25_arrays_b4096", "p50_single_query_ms",
                "cpp_engine_qps"):
        assert detail[key] > 0, key
    assert detail["torch"] and detail["platform"] == "cpu"
    assert detail["p50_route_stats"]["pruning_simulated"] is True
    with open(os.path.join(REPO, "chiprun_out",
                           "bench_torch_3000.json")) as fh:
        assert json.loads(fh.read()) == out


def test_bench_script_needs_a_card_by_default():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = subprocess.run(
        [sys.executable, "-m", "searchlite_tpu_torch.tools.bench",
         "--docs", "1000"], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=300)
    assert res.returncode != 0
    assert "torch.cuda.is_available() is False" in res.stdout
