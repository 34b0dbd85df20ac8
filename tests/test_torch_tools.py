"""The port's copies of the repo's scale and correctness tools, on the
CPU: ``bench_scale`` (the MS MARCO-shaped scale bench with the C++
engine's gate), ``micro`` (the criterion-style cells), ``strategy_compare``
(bm25 / wand / bmw exactness) and ``bench_vectors``. Each runs in a
subprocess, where it blocks ``jax`` and ``searchlite_tpu``; the corpus and
query generators are held to the JAX tools' for the same seed, and every
tool asked for the card exits without one."""

import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from searchlite_tpu_torch.tools import bench_scale

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_jax_tool(rel: str):
    spec = importlib.util.spec_from_file_location(
        "jax_" + os.path.basename(rel)[:-3], os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_tool(name: str, *args, timeout=600):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-m", f"searchlite_tpu_torch.tools.{name}", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)


def json_lines(stdout: str) -> list:
    return [json.loads(ln) for ln in stdout.splitlines()
            if ln.startswith("{")]


# the summary keys of tools/bench_scale.py's run with --cpu-engine and both
# executions (its ``summary[...]`` assignments)
JAX_SCALE_KEYS = {
    "metric", "unit", "n_docs", "cpu_engine_qps_bm25", "cpu_engine_qps_wand",
    "cpu_engine_qps_bmw", "qps_bm25", "qps_bm25_arrays_b4096",
    "p50_single_ms_bm25", "qps_bmw", "p50_single_ms_bmw",
    "agg_p50_ms_device", "agg_p50_ms_host", "subagg_p50_ms",
    "bounded_agg_p50_ms", "sort_p50_ms", "value"}

# benches/micro.py's ``bench`` names, in its order
MICRO_NAMES = [
    "index_small", "search_small", "search_nested_filters",
    "search_cursor_pagination_2500",
    "search_cursor_pagination_2500_sequential",
    "aggs_terms_stats_histogram_1000", "search_pruned_bmw_5000",
    "fresh_commit_visibility_200docs", "merge_10x200doc_segments",
    "vector_only_10k", "hybrid_blend_10k"]


def test_jax_tools_name_these_keys_and_cells():
    with open(os.path.join(REPO, "tools", "bench_scale.py")) as fh:
        src = fh.read()
    literal = set(re.findall(r'summary\["(\w+)"\]', src))
    formatted = set(re.findall(r'summary\[f"(\w+)\{', src))
    assert formatted == {"cpu_engine_qps_", "qps_", "p50_single_ms_",
                         "agg_p50_ms_"}
    by_mode = {p + m for p in formatted
               for m in ("bm25", "wand", "bmw", "device", "host")}
    assert literal | {"metric", "unit", "n_docs"} == \
        JAX_SCALE_KEYS - by_mode
    with open(os.path.join(REPO, "benches", "micro.py")) as fh:
        src = fh.read()
    for name in MICRO_NAMES:
        assert f'"{name}"' in src, name


def test_scale_generators_equal_the_jax_tools():
    jax_tool = load_jax_tool("tools/bench_scale.py")
    assert (bench_scale.VOCAB, bench_scale.AVG_LEN, bench_scale.CHUNK) == \
        (jax_tool.VOCAB, jax_tool.AVG_LEN, jax_tool.CHUNK)
    ranks = np.arange(1, bench_scale.VOCAB + 1, dtype=np.float64)
    probs = (1.0 / ranks) / np.sum(1.0 / ranks)
    vocab = [f"t{i}" for i in range(bench_scale.VOCAB)]
    out = []
    for tool in (jax_tool, bench_scale):
        rng = np.random.default_rng(7)
        docs = tool.gen_chunk(rng, probs, vocab, 300, 0)
        docs += tool.gen_chunk(rng, probs, vocab, 200, 300)
        out.append((docs, tool.build_queries(rng, 256, vocab)))
    assert out[0] == out[1]


def check_scale(lines):
    summary = lines[-1]
    assert set(summary) == JAX_SCALE_KEYS | {"gate"}
    assert summary["gate"] is True
    checks = next(ln for ln in lines
                  if ln.get("phase") == "gate_summary")["checks"]
    assert set(checks) == {
        "batched_bm25", "arrays_b4096", "arrays_b4096_repeat",
        "batched_bmw", "device_aggs_ab_aggs", "device_aggs_ab_subagg",
        "device_aggs_ab_bounded", "device_aggs_ab_sort"}
    assert all(checks.values())
    assert summary["qps_bm25"] > 0 and summary["qps_bmw"] > 0


def check_micro(lines):
    assert [ln["bench"] for ln in lines] == MICRO_NAMES
    for ln in lines:
        assert "error" not in ln and ln["value"] > 0, ln
        assert ln["tier"] == "host", ln  # a CPU reader


def check_strategy(lines):
    out = lines[-1]
    assert out["identical"] is True and out["mismatches"] == []
    assert out["n_docs"] == 2000
    for strategy in ("bm25", "wand", "bmw"):
        assert out[strategy]["scored_docs"] > 0


def check_vectors(lines):
    check = next(ln for ln in lines if ln.get("phase") == "vector_exactness")
    assert check["ok"] is True and isinstance(check["ids_exact"], bool)
    assert check["max_abs_err"] <= 1e-4
    assert lines[-1]["metric"] == "vector_exact_qps_2k_16d"


@pytest.mark.parametrize("name, args, check", [
    ("bench_scale", ["3000", "--cpu-engine"], check_scale),
    ("micro", [], check_micro),
    ("strategy_compare", ["2000", "60"], check_strategy),
    ("bench_vectors", ["2000", "16"], check_vectors),
], ids=["bench_scale", "micro", "strategy_compare", "bench_vectors"])
def test_tool_passes_on_the_cpu(name, args, check):
    res = run_tool(name, *args, "--device", "cpu")
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    check(json_lines(res.stdout))


@pytest.mark.parametrize("name", ["fuzz_matrix", "bench_scale", "micro",
                                  "strategy_compare", "bench_vectors"])
def test_tool_needs_a_card_by_default(name):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = run_tool(name, timeout=300)
    assert res.returncode == 2, res.stdout + res.stderr[-2000:]
    assert "torch.cuda.is_available() is False" in res.stdout
