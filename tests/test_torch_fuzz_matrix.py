"""The port's knob-matrix fuzz (searchlite_tpu_torch/tools/fuzz_matrix.py)
against the JAX tool it copies (tools/fuzz_matrix.py).

A seed must name the same campaign in both packages: the same knobs, the
same corpus sizes and shapes, the same corpus, the same oracle. The draws
are compared by stopping each tool where it builds its corpus; the
corpora of three small seeds are built by both and held array for array;
two whole iterations of the port's tool run on the CPU with JAX blocked;
and the seed that ``chip_smoke.py`` phase j appends for the all-lanes pass
is shown to reach it."""

import ast
import importlib.util
import inspect
import os
import random
import subprocess
import sys

import numpy as np
import pytest

from searchlite_tpu.device.index import DeviceSegment as JaxSegment
from searchlite_tpu.index.segment import SegmentReader as JaxReader
from searchlite_tpu_torch.device.index import HostSegment
from searchlite_tpu_torch.index.segment import SegmentReader
from searchlite_tpu_torch.tools import fuzz_matrix as port
from test_torch_host import HOST_ARRAYS, assert_same

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = range(12345, 12385)  # the campaign the card runs in full


def load_jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_fuzz_matrix", os.path.join(REPO, "tools", "fuzz_matrix.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX = load_jax_tool()
# the corpus build functions themselves (draw() patches the modules' names)
JAX_BUILD, PORT_BUILD = JAX.build_corpus, port.build_corpus


@pytest.fixture(autouse=True)
def restore_environ():
    """An iteration sets its knobs in ``os.environ`` and leaves them set,
    as the tools do between iterations: put the environment back."""
    saved = dict(os.environ)
    yield
    os.environ.clear()
    os.environ.update(saved)


class Drawn(Exception):
    pass


def draw(tool, seed, monkeypatch, **kw):
    """Run ``tool``'s iteration for ``seed`` up to its corpus build; the
    knob environment, the build's arguments, ``limit`` and the generator's
    state there."""
    for key in tool.KNOB_SPACE:
        os.environ.pop(key, None)
    seen = {}

    def stop(rng, n_docs, vocab, positions, n_segments, delete_frac,
             **_kw):
        caller = inspect.currentframe().f_back.f_locals
        seen.update(
            knobs={k: os.environ.get(k) for k in tool.KNOB_SPACE},
            sizes=(n_docs, vocab, n_segments, positions, delete_frac,
                   caller["limit"]),
            state=rng.getstate())
        raise Drawn

    monkeypatch.setattr(tool, "build_corpus", stop)
    with pytest.raises(Drawn):
        tool.run_iteration(0, seed, **kw)
    return seen


def test_knob_space_is_the_jax_tools():
    assert port.KNOB_SPACE == JAX.KNOB_SPACE
    for precision in ("", "f32_strict", "bf16", "other"):
        assert port.mode_tols(precision) == JAX.mode_tols(precision)


def test_port_is_held_to_the_mode_it_computes():
    """Unset precision the port computes exact f32: f32_strict's bound,
    not the JAX tool's fast-f32 one; the other modes keep theirs."""
    strict = JAX.mode_tols("f32_strict")
    assert port.held_tols("") == port.held_tols("f32") == strict
    assert port.held_tols("") != JAX.mode_tols("")
    for precision in ("f32_strict", "bf16"):
        assert port.held_tols(precision) == JAX.mode_tols(precision)


@pytest.mark.parametrize("seed", SEEDS)
def test_seed_draws_the_jax_campaign(seed, monkeypatch):
    want = draw(JAX, seed, monkeypatch)
    got = draw(port, seed, monkeypatch, device="cpu")
    assert got == want


def seeds_up_to(max_docs: int, n: int):
    """The first ``n`` campaign seeds whose corpus has at most
    ``max_docs`` docs."""
    out = []
    for seed in SEEDS:
        rng = random.Random(seed)
        for choices in port.KNOB_SPACE.values():
            rng.choice(choices)
        if rng.choice((500, 3000, 20000)) <= max_docs:
            out.append(seed)
    return out[:n]


class NumpyReader:
    """What the JAX tool's oracle reads of a reader (segments and their
    numpy builds), without putting a segment on a JAX device."""

    def __init__(self, index):
        self.segments = [JaxReader(m, index.storage)
                         for m in index.manifest.segments]
        self.device_segments = [JaxSegment(s, i, jnp=np)
                                for i, s in enumerate(self.segments)]


@pytest.mark.parametrize("seed", seeds_up_to(500, 3))
def test_small_seed_builds_the_jax_corpus_and_oracle(seed, monkeypatch):
    drawn = draw(JAX, seed, monkeypatch)
    n_docs, vocab, n_segments, positions, delete_frac, _limit = \
        drawn["sizes"]
    rngs = []
    for _ in range(2):
        rng = random.Random()
        rng.setstate(drawn["state"])
        rngs.append(rng)
    jidx = JAX_BUILD(rngs[0], n_docs, vocab, positions, n_segments,
                     delete_frac)
    pidx = PORT_BUILD(rngs[1], n_docs, vocab, positions, n_segments,
                      delete_frac, device="cpu")
    assert rngs[0].getstate() == rngs[1].getstate()
    assert len(jidx.manifest.segments) == len(pidx.manifest.segments)
    for i, (jm, pm) in enumerate(zip(jidx.manifest.segments,
                                     pidx.manifest.segments)):
        jseg, pseg = JaxReader(jm, jidx.storage), SegmentReader(
            pm, pidx.storage)
        jd, hd = JaxSegment(jseg, i, jnp=np), HostSegment(pseg, i)
        for name in HOST_ARRAYS:
            assert_same(getattr(jd, name), getattr(hd, name), name)
        assert [jseg.doc_id(d) for d in range(jseg.doc_count)] == \
            [pseg.doc_id(d) for d in range(pseg.doc_count)]
    jreader, preader = NumpyReader(jidx), pidx.reader(device="cpu")
    qrng = random.Random(seed)
    for _ in range(20):
        q = " ".join(f"t{qrng.randrange(vocab)}"
                     for _ in range(qrng.randint(1, 5)))
        assert port.oracle_scores(preader, q) == \
            JAX.oracle_scores(jreader, q), q


def test_two_whole_iterations_pass_on_the_cpu_without_jax():
    """The first two seeds from 12345 with at most 3,000 docs, every check
    of the iteration, in a process where JAX cannot be imported (the
    card runs the whole campaign)."""
    seeds = seeds_up_to(3000, 2)
    assert seeds == [seeds[0], seeds[0] + 1]
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-m", "searchlite_tpu_torch.tools.fuzz_matrix",
         "2", str(seeds[0]), "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr[-3000:]
    lines = res.stdout.strip().splitlines()
    assert lines[-1] == "ALL OK"
    for it, seed in enumerate(seeds):
        line = next(ln for ln in lines if ln.startswith(f"iter {it} ok"))
        assert f"seed={seed}" in line and "kernels=" in line


def smoke_constants() -> dict:
    """LANES_SEED and LANES_ENV as chip_smoke.py sets them
    (read from its source: importing it blocks JAX in this process)."""
    with open(os.path.join(REPO, "chip_smoke.py")) as fh:
        tree = ast.parse(fh.read())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                getattr(node.targets[0], "id", None) in (
                    "LANES_SEED", "LANES_ENV"):
            out[node.targets[0].id] = ast.literal_eval(node.value)
    return out


def test_smoke_lanes_seed_reaches_the_all_lanes_pass():
    """chip_smoke.py phase j1 appends one seed run with the single-query
    term split's gates opened in the environment: on the CPU its
    iteration passes and runs the all-lanes pass's plain version (on the
    card: the kernel)."""
    const = smoke_constants()
    for key in list(port.KNOB_SPACE) + ["SEARCHLITE_HOST_TIER_DOCS",
                                        "SEARCHLITE_DEVICE_AGGS"]:
        os.environ.pop(key, None)
    os.environ.update(const["LANES_ENV"])
    stats = {}
    err = port.run_iteration(0, const["LANES_SEED"], "cpu", stats)
    assert err is None, err
    lanes = stats["counts"].get("strip_lanes", [0, 0])
    lanes_bf16 = stats["counts"].get("strip_lanes_bf16", [0, 0])
    assert lanes[1] + lanes_bf16[1] > 0, stats["counts"]
    assert stats["counts"]["strip_topk"][1] > 0
    assert stats["counts"]["fused_topk"][1] > 0
    # each reader's plain calls, which add up to the iteration's
    assert stats["placements"] and all(
        "plain" in p for p in stats["placements"])
    assert sum(p["plain"] for p in stats["placements"]) == \
        sum(plain for _launches, plain in stats["counts"].values())
