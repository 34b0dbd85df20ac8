"""IndexReader: BM25 search over torch tensors.

The port of ``searchlite_tpu/api/reader.py`` on one torch device (the
card unless the caller asks for the CPU): single-query ``search()`` /
``search_scroll()``, and the batched ``search_batch`` /
``search_batch_many`` with ``execution`` bm25, wand or bmw.

**Single queries** (``search``, JAX ``reader.py:810-1373``) run the
request surface of the JAX reader -- bool / dis_max / query_string
matchers, phrases, filters, function_score, rank_feature, script_score,
field sort, cursors, collapse, rescore, explain, highlight, suggest --
routed per segment as the JAX reader routes them:

1. plain OR-of-terms requests on segments of at least
   ``SEARCHLITE_SINGLE_SPARSE_MIN_DOCS`` docs try the sparse single route
   (``_try_sparse_single``): the query's own posting blocks through the
   strip kernel, or the single-query term split (light terms on the
   strip, head terms by point lookup, a soundness certificate; an
   unsound certificate falls through);
2. ``execution`` wand / bmw requests that are a plain score-desc top-k
   (no cursor, collapse or custom scoring) defer every segment with at
   least ``SEARCHLITE_PRUNE_MIN_POSTINGS`` postings touched, or over the
   dense-M budget, to the doc-tile pruned jobs (``_run_pruned_jobs``,
   ``ops/tiles.py``): per-tile upper bounds, a seed wave over the top
   tiles, a survivor wave, wave-pipelined across segments. The profile
   then reports ``pruning_simulated: false`` and the pruned route's own
   ``postings_advanced`` and match count (over the tiles it scored). A
   negative weight or an int32 overflow hands the segment back to 3 / 4;
3. segments whose dense M is over its budget (``s_pad * n1 * 4`` past
   ``SEARCHLITE_M_BUDGET_BYTES``, or past int32 indexing) run the
   chunked tile executor (``_run_segment_chunked``): every tile scored,
   in column chunks within the budget, stitched on the host and handed to
   the general result path;
4. everything else runs the dense compiled executor
   (``ops/score.py::CompiledQuery.execute``): M from the query's blocks,
   matmuls, the matcher and score trees, masks, cursor skip, count and a
   (score desc, doc asc) top-k;
5. one device-to-host copy for every dense segment, then the host phase
   in segment order (sort keys, cursors, collapse, rescore, hits).

**Aggregations** (``aggs``) switch the sparse single route and pruning
off (they need every match). Per segment, where the request is a plain
score-desc top-k and every aggregation of it can reduce on the device
(``ops/device_aggs.py``), the partials are computed from the executor's
match mask on the card and ride the one bulk copy last, in place of the
doc-axis mask; otherwise the mask is fetched and the host collectors
(``query/aggs.py``) run over it. ``agg_routes`` counts segments per route
(``device``, ``host``); ``SEARCHLITE_DEVICE_AGGS=0`` keeps every segment
on the host.

**Vector clauses** (``vector_query``, or ``vector`` nodes in the query
tree): a request with nothing else is answered by
``_search_vector_only`` (exact brute force per segment,
``ops/vector.py``; aggregations collect on the host over the hits); a
hybrid request runs the text query as above, fetches the matcher's text
mask with it, searches the vectors of the docs that mask and the filters
admit, and blends the two scores per candidate
(``compute_hybrid_score``).

Requests with ``mesh`` raise ``NotImplementedError`` naming their ROADMAP
item.

``single_routes`` counts segments per single-query route: ``dense``,
``sparse_plain``, ``sparse_split``, ``split_fallthrough`` (a split whose
certificate failed; the segment then ran another route too), ``pruned``
and ``chunked``. ``tile_stats`` counts the tile routes' work: UB
launches, exact-scoring wave launches, tiles scored, per-query rounds.

**Batches** (``search_batch_many``) with ``execution="bm25"`` are routed
per segment by the dense-M estimate ``(s_pad + Q) * n1 * 4`` against
``SEARCHLITE_M_BUDGET_BYTES``.

Under the budget (``_launch_batch_segment``), with per-query filters and
any k up to the doc axis:

1. native query prep (``build_impact_batch_native``);
2. unfiltered batches with k <= 1024 first try candidate strips: rows
   whose posting blocks fit 32 blocks ride packed strips in pow-4 tiers;
   rows with head terms ride the term-split scorer (light terms on the
   strip, heavy terms by point lookup, a soundness certificate per row);
3. the rest -- filtered batches, k > 1024, the strips' remainder -- take
   the dense split scorer (resident dense rows of the head terms plus a
   scattered M of the batch's other terms) or, when no slot is dense, the
   plain block scorer; both end in the fused score + mask + top-k kernel;
4. every result (and the certificates) comes back in ONE device-to-host
   copy; rows whose certificate failed are re-scored dense in a second
   round (``_apply_split_fallbacks``); the segments merge on the host.

Over the budget (the oversized-corpus route) unfiltered batches with
k <= 1024 ride the strips with the wider cap ``max(512, 2*n1/640)``,
term-split rows included, and rows the strips cannot certify take full
strips holding every term. Filtered or k > 1024 batches over the budget,
and rows full strips cannot hold, take the doc-sharded dense scan
(``_search_batch_sharded``): the doc axis cut into power-of-two shards
until one shard's M fits the budget and int32 indexing, each shard scored
by the block scorer and the fused kernel at N = ``shard_width + 1``, the
shards' lists merged on the device.

**Batches with ``execution`` wand / bmw** take the doc-tile pruned paths
(``SEARCHLITE_BATCH_PRUNE`` auto / pq / union): unfiltered batches the
per-query path (``_search_batch_pruned_pq``: light rows on the candidate
strips, head-term rows in private tile waves with the selection, the
threshold and the running merge on the device, one bulk copy a round),
filtered batches the union path (``_search_batch_pruned_many``: three
waves over the union of the batch's tiles, ending in the fused kernel).
Where every segment holds at least ``SEARCHLITE_BATCH_STRIP_MIN_DOCS``
docs, auto mode treats wand / bmw as hints and runs the bm25 routes.
``route_rows`` counts rows per route: ``strip``, ``split``, ``dense``,
``fallback``, ``tiles`` (rows scored in tile waves) and ``sharded`` (rows
through the doc-sharded scan).

Every route is exact, so results match the JAX reader whichever route it
took (scores to f32 reassociation, divergence D10). ``mesh`` is not ported
yet and raises ``NotImplementedError``.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import re
import threading
import time
from dataclasses import dataclass, replace
from typing import Any, Optional

import numpy as np
import torch

from searchlite_tpu_torch.api.types import (
    Filter,
    FuzzyOptions,
    Hit,
    QueryNode,
    SearchRequest,
    SearchResult,
    VectorQuery,
)
from searchlite_tpu_torch.errors import CursorError, QueryError, StorageError
from searchlite_tpu_torch.index.highlight import (
    HighlightOptions,
    highlight_fragments,
    make_snippet,
)
from searchlite_tpu_torch.models.bm25 import idf as bm25_idf
from searchlite_tpu_torch.ops.device_aggs import (
    build_intermediates,
    launch_device_aggs,
    plan_device_aggs,
    strict as precision_strict,
)
from searchlite_tpu_torch.ops.score import CompiledQuery
from searchlite_tpu_torch.ops.vector import vector_topk
from searchlite_tpu_torch.query.aggs import (
    AggregationPipeline,
    validate_aggregations,
)
from searchlite_tpu_torch.query.phrase import matches_phrase
from searchlite_tpu_torch.query.planner import QueryPlan, build_query_plan
from searchlite_tpu_torch.query.sort import SortKey, SortPlan
from searchlite_tpu_torch.native import get_results_mod
from searchlite_tpu_torch.ops.impact import (
    build_block_tables,
    build_impact_batch,
    build_impact_batch_native,
    csr_row_lengths,
    csr_take_rows,
    ensure_dense_tables,
    next_pow2,
    pow15_bucket,
    split_impact_batch,
    subset_impact_batch,
)
from searchlite_tpu_torch.ops.sparse import (
    STRIP_CHUNK_ELEMS,
    partition_sparse_batch,
    partition_sparse_batch_split,
    partition_sparse_batch_tiered,
)
from searchlite_tpu_torch.query.filters import (
    compute_filters_mask,
    passes_filter,
    validate_filter,
)
from searchlite_tpu_torch.query.parser import parse_query
from searchlite_tpu_torch.device.index import cached_segment
from searchlite_tpu_torch.ops.impact import (
    expand_impact_scorer,
    impact_scorer,
    split_impact_scorer,
)
from searchlite_tpu_torch.ops.tiles import (
    gather_cols,
    get_tile_index,
    pow4_bucket,
    pq_run_scorer,
    run_batch_scorer,
    seed_select,
    tile_cols,
    topk_merge,
    ub_scorer,
)
from searchlite_tpu_torch.ops.sparse import (
    group_gather,
    group_gather_sound,
    row_combine,
    sparse_candidate_scorer,
    sparse_candidate_scorer_packed,
    sparse_candidate_scorer_split,
    sparse_single_split_scorer,
)

# the strip route's own top-k cap (JAX: reader.py::_try_sparse_candidates)
MAX_STRIP_K = 1024
# int32 indexing bound of the dense M scatter (JAX: reader.py)
FLAT_INDEX_LIMIT = 2**31
MAX_CANDIDATE_SIZE = 20_000
MAX_CURSOR_ADVANCE = 50_000
MAX_SUGGEST_CANDIDATES = 256
# tile-space fills of the executor's doc-axis inputs past n1: phrase
# masks, filter masks, column values, column presence, the root mask
MASK_FILLS = (False, False, 0.0, False, False)
# the executor's weight inputs, as ``_segment_query_args`` names them
WEIGHT_KEYS = ("w_leaf", "leaf_ind", "group_ind")
CURSOR_VERSION = 3
# vector-search clamps (JAX: reader.py)
MAX_VECTOR_CLAUSES = 8
MAX_VECTOR_K = 1024
MAX_VECTOR_CANDIDATE_SIZE = 10_000
MAX_VECTOR_EF_SEARCH = 65_536
MAX_GLOBAL_CANDIDATES = MAX_CANDIDATE_SIZE
DEFAULT_VECTOR_ALPHA = 0.5
DEFAULT_EF_SEARCH = 40

# compiled plans, shared by every reader (commits reopen readers), keyed
# by plan structure + schema fingerprint (JAX ``_GLOBAL_COMPILED``)
_GLOBAL_COMPILED: dict[str, CompiledQuery] = {}
_GLOBAL_LOCK = threading.Lock()


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to searchlite_tpu_torch yet "
        f"(ROADMAP.md queue 1: {item})")


@dataclass
class QualifiedTerm:
    field: str
    term: str
    key: str
    weight: float
    leaf: int


@dataclass
class RankedHit:
    key: SortKey
    score: float
    vector_score: Optional[float] = None
    explanation: Optional[dict] = None


@dataclass
class VectorClausePlan:
    field: str
    vector: list[float]
    k: int
    alpha: float
    ef_search: int
    candidate_size: int
    boost: float
    metric: str


@dataclass
class VectorPlan:
    clauses: list[VectorClausePlan]
    candidate_size: int
    vector_only: bool


def missing_vector_score(metric: str) -> float:
    return -1.0 if metric == "cosine" else float(np.finfo(np.float32).min)


def blend_scores(bm25: float, vector_score: float, alpha: float) -> float:
    return alpha * bm25 + (1.0 - alpha) * vector_score


def compute_hybrid_score(key, bm25_score: float, plan: VectorPlan,
                         vector_scores: list[dict]):
    """(final_score, vector_score_sum_or_None, has_vector): each clause
    blends the BM25 score with its similarity (the metric's missing
    penalty where the doc has no vector hit), averaged over clauses."""
    blended_sum = 0.0
    vector_sum = 0.0
    has_vector = False
    for clause, scores in zip(plan.clauses, vector_scores):
        raw = scores.get(key)
        if raw is not None:
            vector_sum += raw
            has_vector = True
        vec_score = raw if raw is not None \
            else missing_vector_score(clause.metric)
        if clause.alpha >= 1.0:
            blended = bm25_score
        elif clause.alpha <= 0.0:
            blended = vec_score
        else:
            blended = blend_scores(bm25_score, vec_score, clause.alpha)
        blended_sum += blended
    denom = max(len(plan.clauses), 1)
    return (blended_sum / denom, vector_sum if has_vector else None,
            has_vector)


def distance_weight(distance: int) -> float:
    return 1.0 / (distance + 1.0)


def bounded_levenshtein(a: str, b: str, max_edits: int) -> Optional[int]:
    la, lb = len(a), len(b)
    if abs(la - lb) > max_edits:
        return None
    if la == 0:
        return lb if lb <= max_edits else None
    if lb == 0:
        return la if la <= max_edits else None
    prev = list(range(lb + 1))
    for i, ca in enumerate(a):
        curr = [i + 1] + [0] * lb
        row_min = curr[0]
        for j, cb in enumerate(b):
            cost = 0 if ca == cb else 1
            val = min(prev[j + 1] + 1, curr[j] + 1, prev[j] + cost)
            curr[j + 1] = val
            row_min = min(row_min, val)
        if row_min > max_edits:
            return None
        prev = curr
    return prev[lb] if prev[lb] <= max_edits else None


def build_wildcard_regex(pattern: str) -> re.Pattern:
    buf = "^"
    for ch in pattern:
        if ch == "*":
            buf += ".*"
        elif ch == "?":
            buf += "."
        else:
            buf += re.escape(ch)
    buf += "$"
    try:
        return re.compile(buf)
    except re.error as e:
        raise QueryError(f"invalid wildcard `{pattern}`: {e}") from e


def wildcard_literal_prefix(pattern: str) -> str:
    return re.split(r"[*?]", pattern, maxsplit=1)[0]


def regex_literal_prefix(pattern: str) -> str:
    prefix = []
    escaped = False
    for ch in pattern:
        if escaped:
            if ch == "\\":
                prefix.append(ch)
                escaped = False
                continue
            if ch in "dDwWsSbBpP":
                break
            prefix.append(ch)
            escaped = False
            continue
        if ch == "\\":
            escaped = True
        elif ch == "^" and not prefix:
            continue
        elif ch in ".*+?()[]{}|$":
            break
        else:
            prefix.append(ch)
    return "".join(prefix)


def ensure_keyword_fast(schema, field: str, context: str) -> None:
    meta = schema.field_meta(field)
    if meta is None or meta.kind != "keyword" or not meta.fast:
        raise QueryError(
            f"{context} field `{field}` must be a fast keyword field")


# -- cursors -----------------------------------------------------------------

def encode_cursor(generation: int, returned: int, key: SortKey,
                  sort_plan: SortPlan, fast: bool) -> str:
    payload = {
        "v": CURSOR_VERSION,
        "gen": generation,
        "ret": returned,
        "hash": sort_plan.hash,
        "fast": fast,
        "key": key.to_json(),
    }
    return json.dumps(payload, separators=(",", ":")).encode().hex()


def decode_cursor(raw: str, generation: int, sort_plan: SortPlan,
                  fast: bool) -> dict:
    try:
        payload = json.loads(bytes.fromhex(raw))
    except (ValueError, json.JSONDecodeError) as e:
        raise CursorError("invalid cursor") from e
    if not isinstance(payload, dict) or payload.get("v") != CURSOR_VERSION:
        raise CursorError("invalid cursor version")
    if payload.get("gen") != generation:
        raise CursorError("cursor is stale: index has changed")
    if payload.get("hash") != sort_plan.hash:
        raise CursorError("cursor does not match the requested sort")
    if bool(payload.get("fast")) != fast:
        raise CursorError("cursor does not match the requested sort")
    try:
        key = SortKey.from_json(payload["key"], sort_plan.orders)
    except (KeyError, TypeError, ValueError) as e:
        raise CursorError("invalid cursor") from e
    returned = int(payload.get("ret", 0))
    if returned > MAX_CURSOR_ADVANCE:
        raise CursorError("cursor advanced past the pagination limit")
    return {"key": key, "returned": returned}


class IndexReader:
    """Batched reader over ``index`` with every segment's tensors on
    ``device``: the card by default, the CPU only when the caller asks
    (``device="cpu"``). Raises where CUDA is absent; it never falls back
    to the CPU.

    ``route_rows`` counts the rows each route scored (``strip``: light
    rows on plain strips, ``split``: term-split rows with a head term,
    ``dense``: rows through the dense scorers, fallback waves included,
    ``fallback``: unsound term-split rows re-scored dense, ``tiles``: rows
    scored in doc-tile waves, ``sharded``: rows through the doc-sharded
    dense scan)."""

    def __init__(self, index, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "IndexReader(device='cuda') needs a CUDA device, and "
                "torch.cuda.is_available() is False")
        self.index = index
        self.manifest = index.manifest  # snapshot
        self.schema = self.manifest.schema
        self.options = index.options
        self.analysis = self.schema.build_analyzers()
        self.segments = []
        self.device_segments = []
        # a concurrent merge can delete a snapshot's segment files
        # before they open; re-snapshotting converges (as the JAX reader)
        for attempt in range(8):
            try:
                for i, meta in enumerate(self.manifest.segments):
                    seg, dseg = cached_segment(
                        index.storage, meta, i, self.options.bm25_k1,
                        self.options.bm25_b, self.device)
                    self.segments.append(seg)
                    self.device_segments.append(dseg)
                break
            except StorageError:
                if attempt == 7:
                    raise
                self.segments.clear()
                self.device_segments.clear()
                self.manifest = index.reload_manifest()
                self.schema = self.manifest.schema
                self.analysis = self.schema.build_analyzers()
        self.generation = max(
            (s.generation for s in self.manifest.segments), default=0)
        self._schema_fingerprint = hashlib.sha256(
            json.dumps(self.schema.to_json(),
                       sort_keys=True).encode()).hexdigest()[:16]
        self._token_cache: dict = {}
        self._split_fallback_rows = 0
        self.route_rows = {"strip": 0, "split": 0, "dense": 0,
                           "fallback": 0, "tiles": 0, "sharded": 0}
        self.single_routes = {"dense": 0, "sparse_plain": 0,
                              "sparse_split": 0, "split_fallthrough": 0,
                              "pruned": 0, "chunked": 0}
        self.tile_stats = {"ub_launches": 0, "wave_launches": 0,
                           "tiles_scored": 0, "rounds": 0}
        # segments whose aggregations reduced on the device / were
        # collected on the host over a fetched mask
        self.agg_routes = {"device": 0, "host": 0}

    # -- term expansion (host, over per-segment dictionaries) ----------------

    def _expand_term_groups(self, groups, fuzzy: Optional[FuzzyOptions]
                            ) -> tuple[list[QualifiedTerm], list[list[str]]]:
        qualified: list[QualifiedTerm] = []
        group_keys: list[list[str]] = []
        for group in groups:
            keys: list[str] = []
            seen_keys: set[str] = set()
            for fspec in group.fields:
                target_leaf = (fspec.leaf if fspec.leaf is not None
                               else group.leaf)
                weight = group.boost * fspec.boost
                kind = self.schema.field_kind(fspec.field)
                if kind == "text":
                    analyzer = self.analysis.search_analyzer(fspec.field)
                    if analyzer is None:
                        continue
                    if group.expansion == "exact":
                        tokens = [t.text for t in analyzer.analyze(group.term)]
                    else:
                        # patterns are never tokenized (analysis strips the
                        # metacharacters that make them patterns); only
                        # structure-preserving normalization applies
                        tokens = [analyzer.normalize_pattern(group.term)]
                    seen_tokens: set[str] = set()
                    for token in tokens:
                        if token in seen_tokens:
                            continue
                        seen_tokens.add(token)
                        scored, expanded = self._expand_term_for_group(
                            fspec.field, token, weight, group.score,
                            target_leaf, fuzzy, group.expansion,
                            group.max_expansions)
                        if group.score:
                            qualified.extend(scored)
                        for key in expanded:
                            if key not in seen_keys:
                                seen_keys.add(key)
                                keys.append(key)
                elif kind == "keyword":
                    term = group.term.lower()
                    scored, expanded = self._expand_term_for_group(
                        fspec.field, term, weight, group.score, target_leaf,
                        fuzzy, group.expansion, group.max_expansions)
                    if group.score:
                        qualified.extend(scored)
                    for key in expanded:
                        if key not in seen_keys:
                            seen_keys.add(key)
                            keys.append(key)
            group_keys.append(keys)
        return qualified, group_keys

    def _expand_term_for_group(self, field, term, boost, score, leaf, fuzzy,
                               expansion, max_expansions):
        key = f"{field}:{term}"
        leaf_val = leaf if leaf is not None else 0
        if expansion == "exact":
            if not score or leaf is None:
                return [], [key]
            if fuzzy is None or min(fuzzy.max_edits, 2) == 0:
                return ([QualifiedTerm(field, term, key, boost, leaf_val)],
                        [key])
            return self._expand_fuzzy(field, term, boost, leaf_val, fuzzy)
        if max_expansions == 0:
            return [], []
        if expansion == "prefix":
            matcher = None
            literal = term
        elif expansion == "wildcard":
            matcher = build_wildcard_regex(term)
            literal = wildcard_literal_prefix(term)
        else:  # regex
            try:
                matcher = re.compile(f"^(?:{term})$")
            except re.error as e:
                raise QueryError(f"invalid regex `{term}`: {e}") from e
            literal = regex_literal_prefix(term)
        prefix_key = f"{field}:{literal}"
        field_prefix_len = len(field) + 1
        qualified, keys = [], []
        seen: set[str] = set()
        for seg in self.segments:
            expanded = 0
            for seg_key, _tid in seg.terms.iter_prefix(prefix_key):
                if expanded >= max_expansions:
                    break
                if len(seg_key) <= field_prefix_len:
                    continue
                token = seg_key[field_prefix_len:]
                if matcher is not None and not matcher.match(token):
                    continue
                if seg_key in seen:
                    continue
                seen.add(seg_key)
                if score and leaf is not None:
                    qualified.append(QualifiedTerm(
                        field, token, seg_key, boost, leaf_val))
                keys.append(seg_key)
                expanded += 1
        return qualified, keys

    def _expand_fuzzy(self, field, term, boost, leaf, fuzzy: FuzzyOptions):
        exact_key = f"{field}:{term}"
        qualified = [QualifiedTerm(field, term, exact_key,
                                   boost * distance_weight(0), leaf)]
        keys = [exact_key]
        term_len = len(term)
        if term_len < fuzzy.min_length or fuzzy.max_expansions == 0:
            return qualified, keys
        max_edits = min(fuzzy.max_edits, 2)
        prefix_len = min(fuzzy.prefix_length, term_len)
        prefix_key = f"{field}:{term[:prefix_len]}"
        field_prefix_len = len(field) + 1
        seen = {exact_key}
        expansions = 0
        for seg in self.segments:
            if expansions >= fuzzy.max_expansions:
                break
            for seg_key, _tid in seg.terms.iter_prefix(prefix_key):
                if expansions >= fuzzy.max_expansions:
                    break
                if len(seg_key) <= field_prefix_len:
                    continue
                candidate = seg_key[field_prefix_len:]
                if candidate == term:
                    continue
                if abs(len(candidate) - term_len) > max_edits:
                    continue
                distance = bounded_levenshtein(term, candidate, max_edits)
                if distance is None or distance == 0:
                    continue
                if seg_key not in seen:
                    seen.add(seg_key)
                    qualified.append(QualifiedTerm(
                        field, candidate, seg_key,
                        boost * distance_weight(distance), leaf))
                    keys.append(seg_key)
                    expansions += 1
        return qualified, keys

    # -- per-segment dense inputs ---------------------------------------------

    def _segment_query_args(self, dseg, qualified: list[QualifiedTerm],
                            group_keys: list[list[str]],
                            n_leaves: int, n_groups: int):
        """The slot tables of the dense executor: one slot per distinct
        present term key, its posting block range, and the leaf-weight /
        leaf- and group-indicator matrices."""
        seg = dseg.reader
        postings = seg.postings
        live = float(max(dseg.live_docs, 0))

        slots: dict[str, int] = {}
        slot_start: list[int] = []
        slot_len: list[int] = []
        slot_idf: list[float] = []
        slot_bstart: list[int] = []
        slot_bcnt: list[int] = []
        slot_tids: list[int] = []

        def get_slot(key: str):
            s = slots.get(key)
            if s is None:
                tid = seg.terms.get(key)
                if tid is None:
                    return None
                s = len(slot_start)
                slots[key] = s
                df = int(postings.term_df[tid])
                slot_start.append(int(dseg.posting_base[tid]))
                slot_len.append(df)
                slot_idf.append(bm25_idf(float(df), live))
                slot_bstart.append(int(postings.term_block_start[tid]))
                slot_bcnt.append(int(postings.term_block_count[tid]))
                slot_tids.append(int(tid))
            return s

        merged: dict[tuple[str, int], float] = {}
        for qt in qualified:
            merged[(qt.key, qt.leaf)] = \
                merged.get((qt.key, qt.leaf), 0.0) + qt.weight

        entries = []  # (slot, leaf, idf*weight)
        postings_touched = 0
        slot_weight: dict[int, float] = {}
        for (key, leaf), weight in merged.items():
            s = get_slot(key)
            if s is None:
                continue
            entries.append((s, leaf, slot_idf[s] * weight))
            slot_weight[s] = slot_weight.get(s, 0.0) + slot_idf[s] * weight
            postings_touched += slot_len[s]
        group_entries = []  # (slot, group)
        for g, keys in enumerate(group_keys):
            for key in keys:
                s = get_slot(key)
                if s is not None:
                    group_entries.append((s, g))

        s_pad = next_pow2(max(len(slot_start), 8))
        blk_idx, slot_row, nb_pad = build_block_tables(
            slot_bstart, slot_bcnt, sentinel_row=dseg.n_block_rows)
        L = max(n_leaves, 1)
        G = max(n_groups, 1)
        out = {
            "blk_idx": blk_idx,
            "slot_row": slot_row,
            "nb_pad": nb_pad,
            "s_pad": s_pad,
            "w_leaf": np.zeros((L, s_pad), dtype=np.float32),
            "leaf_ind": np.zeros((L, s_pad), dtype=np.float32),
            "group_ind": np.zeros((G, s_pad), dtype=np.float32),
            "n_scored": len(entries),
            "postings_touched": postings_touched,
            "slot_keys": dict(slots),
            "slot_weight": slot_weight,
            "slot_tids": np.asarray(slot_tids, dtype=np.int64),
            "n_slots": len(slot_start),
        }
        for s, leaf, w in entries:
            out["w_leaf"][leaf, s] += w
            out["leaf_ind"][leaf, s] = 1.0
        for s, g in group_entries:
            out["group_ind"][g, s] = 1.0
        # a dense M past int32 indexing needs the chunked tile executor
        out["overflow"] = s_pad * dseg.n1 + nb_pad * 128 >= 2**31
        return out

    def _segment_phrase_masks(self, seg, phrase_specs,
                              n1: Optional[int] = None) -> np.ndarray:
        # n1 = the device doc-axis width (dseg.n1, which may be
        # bucket-padded past doc_count+1); host-only callers omit it
        if n1 is None:
            n1 = seg.doc_count + 1
        masks = np.zeros((max(len(phrase_specs), 1), n1), dtype=bool)
        for p_idx, spec in enumerate(phrase_specs):
            for field in spec.fields:
                if self.schema.field_kind(field) != "text":
                    continue
                analyzer = self.analysis.search_analyzer(field)
                if analyzer is None:
                    continue
                tokens = analyzer.analyze(" ".join(spec.terms))
                if not tokens:
                    continue
                # variants per position (synonyms share a position)
                by_pos: dict[int, list[str]] = {}
                for tok in tokens:
                    by_pos.setdefault(tok.position, []).append(tok.text)
                positions = [by_pos[p] for p in sorted(by_pos)]
                # per position: doc -> merged sorted position array
                per_pos_docs: list[dict[int, np.ndarray]] = []
                ok = True
                for variants in positions:
                    docs_map: dict[int, list[np.ndarray]] = {}
                    for text in variants:
                        tid = seg.terms.get(f"{field}:{text}")
                        if tid is None:
                            continue
                        docs, _tfs = seg.postings.term_postings(tid)
                        for posting_idx, doc in enumerate(docs.tolist()):
                            pos = seg.postings.positions(tid, posting_idx)
                            docs_map.setdefault(doc, []).append(pos)
                    if not docs_map:
                        ok = False
                        break
                    per_pos_docs.append({
                        doc: np.sort(np.concatenate(lists))
                        for doc, lists in docs_map.items()
                    })
                if not ok or not per_pos_docs:
                    continue
                candidates = set(per_pos_docs[0])
                for m in per_pos_docs[1:]:
                    candidates &= set(m)
                for doc in candidates:
                    plists = [m[doc] for m in per_pos_docs]
                    if matches_phrase(plists, spec.slop):
                        masks[p_idx, doc] = True
        return masks

    def _segment_filter_masks(self, seg, filter_slots,
                              n1: Optional[int] = None) -> np.ndarray:
        if n1 is None:
            n1 = seg.doc_count + 1
        masks = np.zeros((max(len(filter_slots), 1), n1), dtype=bool)
        for i, filters in enumerate(filter_slots):
            masks[i, :seg.doc_count] = compute_filters_mask(
                seg.fast, list(filters))
        return masks

    def _segment_columns(self, seg, columns: list[str],
                         n1: Optional[int] = None):
        if n1 is None:
            n1 = seg.doc_count + 1
        vals = np.zeros((max(len(columns), 1), n1), dtype=np.float32)
        has = np.zeros((max(len(columns), 1), n1), dtype=bool)
        for i, field in enumerate(columns):
            col = seg.fast.column(field)
            if col is None:
                continue
            present = np.diff(col.offsets) > 0
            first_idx = col.offsets[:-1][present]
            vals[i, :seg.doc_count][present] = \
                col.values[first_idx].astype(np.float32)
            has[i, :seg.doc_count] = present
        return vals, has

    # -- single-query entry points ------------------------------------------

    def search_scroll(self, req, max_pages: Optional[int] = None,
                      block_docs: int = 2000, mesh=None
                      ) -> list[SearchResult]:
        """Drain a paginated result stream in blocks: one pass fetches up
        to ``block_docs`` hits, sliced on the host into pages of
        ``req.limit``. The page and hit sequence is the one looping
        :meth:`search` with ``next_cursor`` gives; each page carries an
        exact ``next_cursor``. The drain ends when hits run out or at
        ``max_pages``."""
        if isinstance(req, dict):
            req = SearchRequest.from_json(req)
        if req.limit <= 0:
            raise QueryError("search request must set limit > 0")
        page_limit = req.limit
        block = max(page_limit, min(block_docs, MAX_CANDIDATE_SIZE))
        block -= block % page_limit or 0
        sort_plan = SortPlan.from_request(self.schema, req.sort)
        score_fast_path = (sort_plan.is_score_only()
                           and sort_plan.primary_order() == "desc")
        pages: list[SearchResult] = []
        cursor = req.cursor
        returned = 0
        if cursor is not None:
            returned = decode_cursor(cursor, self.generation, sort_plan,
                                     score_fast_path)["returned"]
        while max_pages is None or len(pages) < max_pages:
            block_req = replace(req, limit=block, cursor=cursor,
                                candidate_size=max(
                                    req.candidate_size or 0, block))
            res = self.search(block_req, mesh=mesh)
            n_pages = -(-len(res.hits) // page_limit) if res.hits else 0
            for p in range(n_pages):
                lo = p * page_limit
                page_hits = res.hits[lo:lo + page_limit]
                last_in_block = lo + page_limit >= len(res.hits)
                if last_in_block:
                    next_cur = res.next_cursor
                else:
                    # exact per-page cursor: the key material the page
                    # loop would encode (the page's last hit)
                    last = page_hits[-1]
                    next_cur = encode_cursor(
                        self.generation,
                        returned + lo + len(page_hits),
                        last.sort_key, sort_plan, score_fast_path) \
                        if last.sort_key is not None else None
                pages.append(SearchResult(
                    total_hits_estimate=res.total_hits_estimate,
                    total_groups=res.total_groups,
                    hits=page_hits,
                    next_cursor=next_cur,
                    aggregations=res.aggregations if p == 0 else {},
                    suggest=res.suggest if p == 0 else {},
                    profile=res.profile if p == 0 else None,
                ))
                if max_pages is not None and len(pages) >= max_pages:
                    break
            returned += len(res.hits)
            cursor = res.next_cursor
            if cursor is None or not res.hits:
                break
        return pages

    def search(self, req, mesh=None) -> SearchResult:
        """Execute one search request (a :class:`SearchRequest` or its
        JSON dict) over every segment; see the module docstring for the
        routes."""
        if isinstance(req, dict):
            req = SearchRequest.from_json(req)
        if req.limit <= 0:
            raise QueryError("search request must set limit > 0")
        if not req.return_hits and req.cursor is not None:
            raise QueryError(
                "cursor is not supported when return_hits is false")
        if req.collapse is not None:
            ensure_keyword_fast(self.schema, req.collapse.field, "collapse")
        if req.filter is not None:
            validate_filter(self.schema, req.filter)
        if mesh is not None:
            raise _not_ported("mesh execution", "multi-GPU")

        sort_plan = SortPlan.from_request(self.schema, req.sort)
        score_fast_path = (sort_plan.is_score_only()
                           and sort_plan.primary_order() == "desc")
        cursor_state = None
        if req.cursor is not None:
            cursor_state = decode_cursor(
                req.cursor, self.generation, sort_plan, score_fast_path)
        cursor_key = cursor_state["key"] if cursor_state else None
        cursor_returned = cursor_state["returned"] if cursor_state else 0

        default_fields = (req.fields if req.fields is not None
                          else [f.name for f in self.schema.text_fields])

        vector_plan = self._build_vector_plan(req)
        if vector_plan is not None and not vector_plan.vector_only \
                and all(c.alpha >= 1.0 for c in vector_plan.clauses):
            vector_plan = None
        if vector_plan is not None and vector_plan.vector_only:
            return self._search_vector_only(req, sort_plan, cursor_state,
                                            vector_plan)

        base_candidate = min(
            max(req.candidate_size or req.limit, req.limit),
            MAX_CANDIDATE_SIZE)
        effective_limit = (max(vector_plan.candidate_size, req.limit)
                           if vector_plan is not None else base_candidate)
        top_k = (effective_limit + 1) if req.return_hits else 0

        plan = build_query_plan(req.query, default_fields)
        compiled = self._compile(plan, self.options.bm25_k1,
                                 self.options.bm25_b)
        qualified, group_keys = self._expand_term_groups(
            plan.term_groups, req.fuzzy)
        highlight_terms: list[str] = []
        seen_hl: set[str] = set()
        for qt in qualified:
            if qt.term not in seen_hl:
                seen_hl.add(qt.term)
                highlight_terms.append(qt.term)
        highlight_phrases = self._phrase_term_map(plan.phrase_specs)

        need_scores = sort_plan.uses_score() or compiled.needs_hook \
            or req.explain
        has_scored = bool(qualified)

        validate_aggregations(self.schema, req.aggs)
        agg_pipeline = (AggregationPipeline(req.aggs, highlight_terms,
                                            self.schema)
                        if req.aggs else None)

        start_time = time.monotonic()
        all_hits: list[RankedHit] = []
        total_matches = 0
        saw_cursor = cursor_state is None
        agg_results = []
        text_masks: dict[int, np.ndarray] = {}
        stats = {"scored_docs": 0, "candidates_examined": 0,
                 "postings_advanced": 0}

        # phase 1 -- launch: per-segment host prep and device work; nothing
        # waits for the card until the one bulk fetch below (the sparse
        # single route, the pruned jobs and the chunked executor fetch
        # their own results)
        # Aggregations that can reduce ON THE DEVICE (ops/device_aggs.py)
        # skip the doc-axis mask fetch, per segment: a segment whose
        # columns cannot run there falls back to the host collectors over
        # a fetched mask.
        needs_mask_base = not score_fast_path or req.collapse is not None
        agg_dev_candidate = (agg_pipeline is not None
                             and not needs_mask_base
                             and vector_plan is None
                             and os.environ.get(
                                 "SEARCHLITE_DEVICE_AGGS", "1") != "0")
        needs_mask_host = needs_mask_base or agg_pipeline is not None
        use_cursor = (cursor_key is not None and score_fast_path
                      and vector_plan is None)
        # doc-tile pruning (ops/tiles.py) is sound only for a plain
        # score-desc top-k: aggregations need every match, custom scoring
        # breaks the BM25 upper bound, cursors need the cursor doc's exact
        # score present
        prune_min = int(os.environ.get(
            "SEARCHLITE_PRUNE_MIN_POSTINGS", 100_000))
        pruning_ok = (req.execution in ("wand", "bmw")
                      and score_fast_path and req.return_hits
                      and cursor_state is None and agg_pipeline is None
                      and vector_plan is None and req.collapse is None
                      and not compiled.needs_hook and has_scored)
        pruning_real = False
        pruning_simulated = False
        sparse_single_ok = (
            score_fast_path and req.return_hits
            and cursor_state is None and agg_pipeline is None
            and vector_plan is None and req.collapse is None
            and not compiled.needs_hook and has_scored
            and req.filter is None and not req.explain
            and not plan.phrase_specs and not compiled.filter_slots
            and plan.is_plain_or_sum()
            and os.environ.get("SEARCHLITE_SINGLE_SPARSE", "1") != "0")
        m_budget = int(os.environ.get("SEARCHLITE_M_BUDGET_BYTES",
                                      2 * 1024**3))
        pending = []  # (dseg, qargs, device tensors to fetch)
        pruned_jobs = []  # deferred doc-tile pruned segments

        def launch_dense(dseg, qargs, masks, cs, eq_mode, cdoc, k):
            (top_scores, top_idx, match_count, final_mask, adjusted,
             cursor_seen, text_mask) = self._run_dense(
                dseg, compiled, qargs, *masks, cs, eq_mode, cdoc, k=k,
                has_scored=has_scored, need_scores=need_scores,
                use_cursor=use_cursor)
            self.single_routes["dense"] += 1
            fetch = [top_scores, top_idx, match_count, cursor_seen]
            needs_mask = needs_mask_host
            agg_refs = []
            if agg_dev_candidate:
                plan_da = plan_device_aggs(dseg, req.aggs,
                                           precision_strict())
                if plan_da is not None:
                    meta, agg_refs = launch_device_aggs(dseg, plan_da,
                                                        final_mask)
                    qargs["_dev_aggs"] = (meta, len(agg_refs))
                    needs_mask = needs_mask_base
            if needs_mask:
                fetch.append(final_mask)
            qargs["_fetched_mask"] = needs_mask
            if vector_plan is not None:
                fetch.append(text_mask)
            if need_scores and not score_fast_path:
                fetch.append(adjusted)
            fetch.extend(agg_refs)  # the device partials come LAST
            return (dseg, qargs, fetch)

        def run_chunked(dseg, qargs, masks):
            qargs["_chunked_pre"] = self._run_segment_chunked(
                dseg, compiled, qargs, *masks, has_scored, need_scores,
                vector_plan is not None)
            self.single_routes["chunked"] += 1
            return (dseg, qargs, [])

        for dseg in self.device_segments:
            seg = dseg.reader
            if seg.doc_count == 0:
                if agg_pipeline is not None:
                    agg_results.append(agg_pipeline.empty_intermediate())
                continue
            qargs = self._segment_query_args(
                dseg, qualified, group_keys, compiled.n_leaves,
                compiled.n_groups)
            k = min(max(top_k, 1), dseg.n1)
            # the sparse single route goes first: where it applies it is
            # one dispatch and one fetch; on a certificate fall-through
            # the tile path or the dense executor still runs
            if sparse_single_ok:
                sp = self._try_sparse_single(dseg, qargs, k)
                if sp is not None:
                    qargs["_pruned_pre"] = sp
                    pending.append((dseg, qargs, []))
                    continue
            oversize = (qargs["overflow"]
                        or qargs["s_pad"] * dseg.n1 * 4 > m_budget)
            phrase_masks = self._segment_phrase_masks(
                seg, plan.phrase_specs, n1=dseg.n1)
            filter_masks = self._segment_filter_masks(
                seg, compiled.filter_slots, n1=dseg.n1)
            col_vals, col_has = self._segment_columns(
                seg, compiled.columns, n1=dseg.n1)
            root_mask = np.ones(dseg.n1, dtype=bool)
            if req.filter is not None:
                root_mask[:seg.doc_count] = compute_filters_mask(
                    seg.fast, [req.filter])
                root_mask[seg.doc_count:] = False
            masks = (phrase_masks, filter_masks, col_vals, col_has,
                     root_mask)
            if pruning_ok and qargs["n_slots"] > 0 \
                    and (oversize
                         or qargs["postings_touched"] >= prune_min):
                # deferred: pruned segments run wave-pipelined together
                # after this loop (3 bulk fetches in all, not 3 a segment)
                pruned_jobs.append((dseg, qargs, *masks, k, oversize))
                continue
            if oversize:
                # the dense M does not fit: exact chunked tile execution,
                # results flow through the general (host) branch
                pending.append(run_chunked(dseg, qargs, masks))
                continue
            if use_cursor:
                cs = float(cursor_key.parts[0])
                if dseg.ord < cursor_key.segment_ord:
                    eq_mode, cdoc = 0, 0
                elif dseg.ord == cursor_key.segment_ord:
                    eq_mode, cdoc = 1, cursor_key.doc_id
                else:
                    eq_mode, cdoc = 2, 0
            else:
                cs, eq_mode, cdoc = 0.0, 2, 0
            pending.append(launch_dense(dseg, qargs, masks, cs, eq_mode,
                                        cdoc, k))

        if pruned_jobs:
            results = self._retry_oom(
                lambda: self._run_pruned_jobs(
                    [job[:8] for job in pruned_jobs], compiled,
                    has_scored, need_scores,
                    bmw_block_size=req.bmw_block_size))
            for job, pre in zip(pruned_jobs, results):
                dseg, qargs = job[0], job[1]
                masks, k, oversize = job[2:7], job[7], job[8]
                if pre is not None:
                    qargs["_pruned_pre"] = pre
                    pruning_real = True
                    self.single_routes["pruned"] += 1
                    pending.append((dseg, qargs, []))
                elif oversize:
                    pending.append(run_chunked(dseg, qargs, masks))
                else:
                    pending.append(launch_dense(dseg, qargs, masks, 0.0, 2,
                                                0, k))

        # one device-to-host copy for everything every segment needs
        flat_vals = _fetch([t for _d, _q, fetch in pending for t in fetch])

        # phase 2 -- host processing, in segment order
        vals_cursor = 0
        for dseg, qargs, fetch in pending:
            seg = dseg.reader
            fetched = flat_vals[vals_cursor:vals_cursor + len(fetch)]
            vals_cursor += len(fetch)
            mask_np = adjusted_np = None
            if "_pruned_pre" in qargs:
                # the sparse single route or a doc-tile pruned job: done
                top_scores_np, top_idx_np, match_count, real_postings = \
                    qargs["_pruned_pre"]
                cursor_seen = False
                stats["postings_advanced"] += real_postings
            elif "_chunked_pre" in qargs:
                # chunked tile execution: host arrays, general branch
                mask_full, adjusted_np, text_c = qargs["_chunked_pre"]
                mask_np = mask_full[:seg.doc_count]
                top_scores_np = top_idx_np = None
                match_count = int(mask_np.sum())
                cursor_seen = False
                if vector_plan is not None:
                    text_masks[dseg.ord] = text_c
                stats["postings_advanced"] += qargs["postings_touched"]
            else:
                top_scores_np, top_idx_np, match_count, cursor_seen = \
                    fetched[:4]
                cursor = 4
                if qargs.get("_fetched_mask"):
                    mask_np = np.array(fetched[cursor])[:seg.doc_count]
                    cursor += 1
                if vector_plan is not None:
                    text_masks[dseg.ord] = fetched[cursor]
                    cursor += 1
                if need_scores and not score_fast_path:
                    adjusted_np = fetched[cursor]
                # postings telemetry: for wand/bmw on requests where real
                # pruning is off (aggs, cursors, hooks, small segments), the
                # COUNTERFACTUAL postings a block-max pruned traversal
                # would touch, flagged pruning_simulated in the profile
                if req.profile and req.execution in ("wand", "bmw") \
                        and score_fast_path and req.return_hits:
                    stats["postings_advanced"] += self._pruned_postings(
                        dseg, qargs, top_scores_np, req.limit,
                        req.execution)
                    pruning_simulated = True
                else:
                    stats["postings_advanced"] += \
                        qargs["postings_touched"]

            if use_cursor and bool(cursor_seen):
                saw_cursor = True

            if score_fast_path and "_chunked_pre" not in qargs:
                total_matches += int(match_count)
                stats["scored_docs"] += int(match_count)
                stats["candidates_examined"] += int(match_count)
                if req.return_hits:
                    valid = top_scores_np > -np.inf
                    for score, doc in zip(top_scores_np[valid].tolist(),
                                          top_idx_np[valid].tolist()):
                        key = SortKey([float(score)], sort_plan.orders,
                                      dseg.ord, int(doc))
                        all_hits.append(RankedHit(key=key,
                                                  score=float(score)))
            else:
                # general path: vectorized rank arrays over the matched
                # set; SortKey objects built only for the top slice
                matched = np.flatnonzero(mask_np)
                if adjusted_np is not None and len(matched):
                    matched_scores = adjusted_np[matched].astype(np.float64)
                else:
                    matched_scores = np.zeros(len(matched),
                                              dtype=np.float64)
                stats["scored_docs"] += len(matched)
                stats["candidates_examined"] += len(matched)
                ranks = sort_plan.rank_arrays(seg.fast, matched,
                                              matched_scores)
                if cursor_key is not None and vector_plan is None \
                        and len(matched):
                    cr = sort_plan.cursor_ranks(cursor_key, seg.fast)
                    gt = np.zeros(len(matched), dtype=bool)
                    eq = np.ones(len(matched), dtype=bool)
                    for rk, c in zip(ranks, cr):
                        gt |= eq & (rk > c)
                        eq &= rk == c
                    if dseg.ord > cursor_key.segment_ord:
                        tie_after = eq
                    elif dseg.ord == cursor_key.segment_ord:
                        tie_after = eq & (matched > cursor_key.doc_id)
                        if bool((eq & (matched ==
                                       cursor_key.doc_id)).any()):
                            saw_cursor = True
                    else:
                        tie_after = np.zeros(len(matched), dtype=bool)
                    keep = gt | tie_after
                    mask_np[matched[~keep]] = False
                    matched = matched[keep]
                    matched_scores = matched_scores[keep]
                    ranks = [r[keep] for r in ranks]
                total_matches += len(matched)
                if req.return_hits and len(matched):
                    order = np.lexsort(
                        tuple([matched.astype(np.float64)]
                              + list(reversed(ranks))))
                    top = order[:max(top_k, 1)]
                    top_docs = matched[top]
                    top_scores2 = matched_scores[top]
                    keys = sort_plan.build_keys_bulk(
                        seg.fast, top_docs, top_scores2, dseg.ord)
                    all_hits.extend(
                        RankedHit(key=key, score=float(s))
                        for key, s in zip(keys, top_scores2.tolist()))

            if agg_pipeline is not None:
                if "_dev_aggs" in qargs:
                    meta, n_refs = qargs["_dev_aggs"]
                    agg_results.append(build_intermediates(
                        meta, fetched[len(fetched) - n_refs:]))
                    self.agg_routes["device"] += 1
                else:
                    agg_results.append(agg_pipeline.collect_segment(
                        seg, dseg.ord, np.flatnonzero(mask_np)))
                    self.agg_routes["host"] += 1

        if vector_plan is not None:
            vector_scores = self._collect_vector_maps(vector_plan, req,
                                                      text_masks)
            saw = [saw_cursor]
            all_hits = self._merge_vector_hits(
                all_hits, vector_scores, vector_plan, sort_plan,
                cursor_key, saw)
            saw_cursor = saw[0]

        if not saw_cursor:
            raise CursorError("stale or invalid cursor for this result set")

        hits = all_hits
        if req.return_hits:
            hits.sort(key=lambda h: _KeyWrap(h.key))
        search_ms = (time.monotonic() - start_time) * 1000.0

        timings: dict[str, float] = {}
        rescore_stats = {"scored_docs": 0, "candidates_examined": 0,
                         "postings_advanced": 0}
        if req.return_hits and req.rescore is not None:
            t0 = time.monotonic()
            self._rescore_hits(hits, req.rescore, default_fields, sort_plan,
                               req, rescore_stats)
            timings["rescore_ms"] = (time.monotonic() - t0) * 1000.0

        if req.explain:
            for h in hits:
                if h.explanation is None:
                    functions = []
                    if compiled.needs_hook:
                        functions = self._explain_functions(
                            compiled, plan.score_tree,
                            h.key.segment_ord, h.key.doc_id,
                            plan=plan, group_keys=group_keys)
                    h.explanation = {
                        "base_score": h.score,
                        "functions": functions,
                        "rescore": None,
                        "final_score": h.score,
                    }
                else:
                    h.explanation["final_score"] = h.score

        total_hits_value = total_matches + cursor_returned
        total_groups = None
        group_inner: list[list[RankedHit]] = []
        if req.return_hits and req.collapse is not None:
            groups = self._collapse_hits(hits, req.collapse, sort_plan)
            total_groups = len(groups)
            group_inner = [inner for _top, inner in groups]
            hits = [top for top, _inner in groups]

        next_cursor = None
        out_hits: list[Hit] = []
        if req.return_hits:
            if len(hits) > req.limit:
                last = hits[req.limit - 1]
                returned = cursor_returned + req.limit
                next_cursor = encode_cursor(
                    self.generation, returned, last.key, sort_plan,
                    score_fast_path)
                hits = hits[:req.limit]
                group_inner = group_inner[:req.limit]
            for i, h in enumerate(hits):
                hit = self._materialize_hit(h, req, highlight_terms,
                                            highlight_phrases)
                if hit is None:
                    continue
                if group_inner and i < len(group_inner) and group_inner[i]:
                    inner_hits = [
                        ih for rh in group_inner[i]
                        if (ih := self._materialize_hit(
                            rh, req, highlight_terms,
                            highlight_phrases)) is not None
                    ]
                    if inner_hits:
                        hit.inner_hits = inner_hits
                out_hits.append(hit)

        aggregations = {}
        if agg_pipeline is not None:
            aggregations = agg_pipeline.merge_and_finalize(agg_results)

        suggest = {}
        if req.suggest:
            suggest = self._execute_suggest(req.suggest)

        profile = None
        if req.profile:
            timings["search_ms"] = search_ms
            execution_stats = dict(stats)
            if req.execution in ("wand", "bmw"):
                # postings_advanced is a measurement where the doc-tile
                # pruned path ran, a counterfactual model otherwise
                execution_stats["pruning_simulated"] = (
                    pruning_simulated or not pruning_real)
            profile = {
                "execution": execution_stats,
                "rescore": dict(rescore_stats) if req.rescore else None,
                "timings": timings,
            }

        return SearchResult(
            total_hits_estimate=total_hits_value,
            total_groups=total_groups,
            hits=out_hits,
            next_cursor=next_cursor,
            aggregations=aggregations,
            suggest=suggest,
            profile=profile,
        )

    def _build_vector_plan(self, req) -> Optional[VectorPlan]:
        """The request's vector clauses (``vector_query`` or ``vector``
        nodes of the query tree) validated and clamped; None without one.
        ``vector_only`` holds when the query tree has nothing else."""
        vector_nodes: list = []
        has_non_vector = [False]

        def collect(node):
            kind = node.kind
            if kind == "vector":
                vector_nodes.append(VectorQuery.from_json(node.params))
                return
            if kind == "bool":
                if node.params.get("filter"):
                    has_non_vector[0] = True
                for key in ("must", "should", "must_not"):
                    for child in node.params.get(key, []):
                        collect(child)
                        if child.kind != "vector":
                            has_non_vector[0] = True
                return
            if kind == "dis_max":
                for child in node.params.get("queries", []):
                    collect(child)
                    if child.kind != "vector":
                        has_non_vector[0] = True
                return
            if kind in ("function_score", "script_score"):
                collect(node.params["query"])
                has_non_vector[0] = True
                return
            has_non_vector[0] = True

        if isinstance(req.query, QueryNode):
            collect(req.query)
        else:
            has_non_vector[0] = True

        if vector_nodes and req.vector_query is not None:
            raise QueryError(
                "cannot set both `vector_query` and a `vector` query node")
        if vector_nodes:
            vectors = vector_nodes
        elif req.vector_query is not None:
            vectors = [req.vector_query]
        else:
            return None
        if len(vectors) > MAX_VECTOR_CLAUSES:
            raise QueryError(
                f"too many vector clauses: got {len(vectors)}, max "
                f"supported {MAX_VECTOR_CLAUSES}")
        vector_only = not has_non_vector[0]
        clauses: list[VectorClausePlan] = []
        max_k = 0
        total_k = 0
        base_candidate = min(
            max(req.candidate_size if req.candidate_size is not None
                else max(req.limit, 10) * 2, req.limit),
            MAX_GLOBAL_CANDIDATES)
        for vq in vectors:
            field = self.schema.vector_field(vq.field)
            if field is None:
                raise QueryError(f"unknown vector field `{vq.field}`")
            if len(vq.vector) != field.dim:
                raise QueryError(
                    f"vector field `{field.name}` expects dimension "
                    f"{field.dim}, got {len(vq.vector)}")
            query_vec = [float(v) for v in vq.vector]
            if field.metric == "cosine":
                norm = math.sqrt(sum(v * v for v in query_vec))
                if norm > 0:
                    query_vec = [v / norm for v in query_vec]
            alpha = vq.alpha if vq.alpha is not None else DEFAULT_VECTOR_ALPHA
            if not (0.0 <= alpha <= 1.0) or not math.isfinite(alpha):
                raise QueryError(
                    "vector alpha must be a finite value between 0 and 1 "
                    "inclusive")
            k = max(vq.k if vq.k is not None else req.limit, 1)
            k = min(k, MAX_VECTOR_K)
            candidate_size = (vq.candidate_size
                              if vq.candidate_size is not None
                              else max(k, req.limit, 10) * 2)
            candidate_size = min(max(candidate_size, k),
                                 MAX_VECTOR_CANDIDATE_SIZE)
            ef_search = (vq.ef_search if vq.ef_search is not None
                         else max(DEFAULT_EF_SEARCH, candidate_size))
            ef_search = min(ef_search, MAX_VECTOR_EF_SEARCH)
            boost = vq.boost if vq.boost is not None else 1.0
            if boost < 0.0 or not math.isfinite(boost):
                raise QueryError(
                    "vector boost must be finite and non-negative")
            max_k = max(max_k, k)
            total_k += k
            clauses.append(VectorClausePlan(
                field=vq.field, vector=query_vec, k=k, alpha=alpha,
                ef_search=ef_search, candidate_size=candidate_size,
                boost=boost, metric=field.metric))
        if not clauses:
            return None
        candidate_size = max(base_candidate, max_k)
        if candidate_size + total_k > MAX_GLOBAL_CANDIDATES:
            candidate_size = max(MAX_GLOBAL_CANDIDATES - total_k, req.limit)
        if candidate_size == 0:
            candidate_size = max(max_k, 1)
        return VectorPlan(clauses=clauses, candidate_size=candidate_size,
                          vector_only=vector_only)

    def _collect_vector_maps(self, plan: VectorPlan, req,
                             text_masks: Optional[dict[int, np.ndarray]]
                             ) -> list[dict]:
        """Per-clause {(segment_ord, doc): boosted similarity} maps: exact
        brute force (``ops/vector.py::vector_topk``) over each segment's
        live docs passing the request's filters (and, for a hybrid
        request, the text matcher's mask)."""
        per_clause: list[dict] = [dict() for _ in plan.clauses]
        for dseg in self.device_segments:
            seg = dseg.reader
            if seg.doc_count == 0:
                continue
            base_mask = np.ones(seg.doc_count, dtype=bool)
            for d in seg.deleted:
                if 0 <= d < seg.doc_count:
                    base_mask[d] = False
            if req.filter is not None:
                base_mask &= compute_filters_mask(seg.fast, [req.filter])
            if req.vector_filter is not None:
                base_mask &= compute_filters_mask(
                    seg.fast, [req.vector_filter])
            if text_masks is not None:
                tm = text_masks.get(dseg.ord)
                if tm is None:
                    continue
                base_mask &= tm[:seg.doc_count]
            for idx, clause in enumerate(plan.clauses):
                vdata = seg.vectors.get(clause.field)
                if vdata is None or not vdata.present.any():
                    continue
                search_k = min(max(clause.candidate_size, clause.k),
                               seg.doc_count)
                query = np.asarray([clause.vector], dtype=np.float32)
                vf = self.schema.vector_field(clause.field)
                quant = vf.quantization if vf else None
                scores, ids = vector_topk(
                    vdata, base_mask, query, search_k, clause.metric,
                    quantization=quant, device=self.device)
                for score, doc in zip(scores[0].tolist(), ids[0].tolist()):
                    if score == -np.inf:
                        continue
                    per_clause[idx][(dseg.ord, int(doc))] = \
                        float(score) * clause.boost
        # global truncation per clause to candidate_size, best-first
        out = []
        for idx, scores_map in enumerate(per_clause):
            cap = plan.clauses[idx].candidate_size
            if cap and len(scores_map) > cap:
                items = sorted(scores_map.items(),
                               key=lambda kv: (-kv[1], kv[0]))[:cap]
                scores_map = dict(items)
            out.append(scores_map)
        return out

    def _merge_vector_hits(self, hits: list[RankedHit], vector_scores,
                           plan: VectorPlan, sort_plan: SortPlan,
                           cursor_key, saw_cursor: list) -> list[RankedHit]:
        """Blend the text hits with the clauses' vector hits: every
        candidate of either side gets its hybrid score and a fresh sort
        key; the cursor skip happens here, on the blended keys."""
        bm25_map = {(h.key.segment_ord, h.key.doc_id): h for h in hits}
        candidate_keys = set(bm25_map)
        for scores_map in vector_scores:
            candidate_keys.update(scores_map)
        all_vector_only = all(c.alpha <= 0.0 for c in plan.clauses)
        merged: list[RankedHit] = []
        for key_tuple in candidate_keys:
            seg_ord, doc = key_tuple
            existing = bm25_map.get(key_tuple)
            bm25_score = existing.score if existing else 0.0
            explanation = existing.explanation if existing else None
            final_score, vector_score, has_vector = compute_hybrid_score(
                key_tuple, bm25_score, plan, vector_scores)
            if all_vector_only and not has_vector:
                continue
            if explanation is not None:
                explanation["final_score"] = final_score
            seg = self.segments[seg_ord]
            key = sort_plan.build_key(seg.fast, doc, final_score, seg_ord)
            if cursor_key is not None:
                cmp = key._cmp(cursor_key)
                if cmp == 0:
                    saw_cursor[0] = True
                if cmp <= 0:
                    continue
            merged.append(RankedHit(key=key, score=final_score,
                                    vector_score=vector_score,
                                    explanation=explanation))
        return merged

    def _search_vector_only(self, req, sort_plan: SortPlan, cursor_state,
                            plan: VectorPlan) -> SearchResult:
        """A request whose query tree holds only vector clauses: the
        clauses' hits are the match set; aggregations collect on the host
        over them."""
        score_fast_path = (sort_plan.is_score_only()
                           and sort_plan.primary_order() == "desc")
        cursor_key = cursor_state["key"] if cursor_state else None
        cursor_returned = cursor_state["returned"] if cursor_state else 0
        validate_aggregations(self.schema, req.aggs)
        agg_pipeline = (AggregationPipeline(req.aggs, [], self.schema)
                        if req.aggs else None)
        vector_scores = self._collect_vector_maps(plan, req, None)

        saw_cursor = [cursor_state is None or not req.return_hits]
        total_matches = 0
        hits: list[RankedHit] = []
        agg_results = []
        seg_docs_by_ord: dict[int, set[int]] = {}
        for scores_map in vector_scores:
            for (seg_ord, doc) in scores_map:
                seg_docs_by_ord.setdefault(seg_ord, set()).add(doc)
        for dseg in self.device_segments:
            seg = dseg.reader
            docs = sorted(seg_docs_by_ord.get(dseg.ord, ()))
            matched_for_aggs = []
            for doc in docs:
                key_tuple = (dseg.ord, doc)
                final_score, vector_score, _ = compute_hybrid_score(
                    key_tuple, 0.0, plan, vector_scores)
                if req.return_hits:
                    key = sort_plan.build_key(
                        seg.fast, doc, final_score, dseg.ord)
                    if cursor_key is not None:
                        cmp = key._cmp(cursor_key)
                        if cmp == 0:
                            saw_cursor[0] = True
                        if cmp <= 0:
                            continue
                total_matches += 1
                matched_for_aggs.append(doc)
                if req.return_hits:
                    hits.append(RankedHit(key=key, score=final_score,
                                          vector_score=vector_score))
            if agg_pipeline is not None:
                agg_results.append(agg_pipeline.collect_segment(
                    seg, dseg.ord,
                    np.asarray(matched_for_aggs, dtype=np.int64)))
                self.agg_routes["host"] += 1
        if not saw_cursor[0]:
            raise CursorError("stale or invalid cursor for this result set")

        if req.return_hits:
            hits.sort(key=lambda h: _KeyWrap(h.key))

        total_groups = None
        group_inner: list[list[RankedHit]] = []
        if req.return_hits and req.collapse is not None:
            ensure_keyword_fast(self.schema, req.collapse.field, "collapse")
            groups = self._collapse_hits(hits, req.collapse, sort_plan)
            total_groups = len(groups)
            group_inner = [inner for _top, inner in groups]
            hits = [top for top, _inner in groups]

        next_cursor = None
        out_hits: list[Hit] = []
        if req.return_hits:
            if len(hits) > req.limit:
                last = hits[req.limit - 1]
                next_cursor = encode_cursor(
                    self.generation, cursor_returned + req.limit, last.key,
                    sort_plan, score_fast_path)
                hits = hits[:req.limit]
                group_inner = group_inner[:req.limit]
            for i, h in enumerate(hits):
                hit = self._materialize_hit(h, req, [], {})
                if hit is None:
                    continue
                if group_inner and i < len(group_inner) and group_inner[i]:
                    inner_hits = [
                        ih for rh in group_inner[i]
                        if (ih := self._materialize_hit(rh, req, [], {}))
                        is not None
                    ]
                    if inner_hits:
                        hit.inner_hits = inner_hits
                out_hits.append(hit)

        aggregations = {}
        if agg_pipeline is not None:
            aggregations = agg_pipeline.merge_and_finalize(agg_results)
        suggest = self._execute_suggest(req.suggest) if req.suggest else {}
        return SearchResult(
            total_hits_estimate=total_matches + cursor_returned,
            total_groups=total_groups,
            hits=out_hits,
            next_cursor=next_cursor,
            aggregations=aggregations,
            suggest=suggest,
            profile={"execution": {"scored_docs": total_matches,
                                   "candidates_examined": total_matches,
                                   "postings_advanced": 0},
                     "rescore": None,
                     "timings": {}} if req.profile else None,
        )

    def _run_dense(self, dseg, compiled, qargs, phrase_masks, filter_masks,
                   col_vals, col_has, root_mask, cs: float, eq_mode: int,
                   cdoc: int, *, k: int, has_scored: bool,
                   need_scores: bool, use_cursor: bool):
        """Upload one segment's query inputs and run the dense executor
        (``CompiledQuery.execute``) on the segment's tensors."""
        up = self._upload
        return compiled.execute(
            dseg.block_docs, dseg.block_impacts_live, dseg.deleted,
            up(qargs["blk_idx"]), up(qargs["slot_row"]),
            up(qargs["w_leaf"]), up(qargs["leaf_ind"]),
            up(qargs["group_ind"]), up(phrase_masks), up(filter_masks),
            up(col_vals), up(col_has), up(root_mask), cs, eq_mode, cdoc,
            k=k, s_pad=qargs["s_pad"], has_scored_terms=has_scored,
            need_scores=need_scores, use_cursor=use_cursor)

    # -- doc-tile pruned single queries (ops/tiles.py) ------------------------

    def _run_pruned_jobs(self, jobs, compiled, has_scored: bool,
                         need_scores: bool, bmw_block_size=None):
        """Doc-tile pruned single-query execution (JAX
        ``_run_pruned_jobs``), wave-pipelined across segments: wave 1
        bounds every tile's best-possible score with one small matmul per
        segment, then at most two exact-scoring waves over compacted tile
        columns -- at most three bulk device-to-host copies for all
        segments together.

        Exact: the same top-k as the dense executor, sound under any
        matcher / filter / phrase because masks only shrink the match set
        and every doc of a scored tile is evaluated with ALL its postings.

        ``jobs``: (dseg, qargs, phrase_masks, filter_masks, col_vals,
        col_has, root_mask, k) each. Returns per job (scores [k], docs
        [k], match_count, postings_touched), or None (the caller falls
        back to the dense or the chunked executor for that segment)."""
        tile_width = None
        if bmw_block_size:
            tile_width = max(128, -(-int(bmw_block_size) // 128) * 128)
        seed_env = int(os.environ.get("SEARCHLITE_SEED_TILES", 0))
        up = self._upload

        # wave 1: per-tile upper bounds (one launch per segment)
        state: list[dict] = []
        for (dseg, qargs, *_masks, _k) in jobs:
            if bool((qargs["w_leaf"] < 0).any()):
                # negative boosts break the upper bound
                state.append({"fallback": True})
                continue
            tl = get_tile_index(dseg, tile_width)
            tids = qargs["slot_tids"][:qargs["n_slots"]]
            s_pad = qargs["s_pad"]
            # UB weights = column sums of w_leaf: >= any sum / dis-max
            # (tie_breaker <= 1) expression over non-negative leaves
            wsum = qargs["w_leaf"].sum(axis=0).astype(np.float32)
            nz = np.flatnonzero(wsum > 0)
            w_pad = next_pow2(max(len(nz), 8))
            w_idx = np.arange(w_pad, dtype=np.int32) + s_pad
            w_idx[:len(nz)] = nz
            w_val = np.zeros(w_pad, dtype=np.float32)
            w_val[:len(nz)] = wsum[nz]
            blk_idx, slot_row, _ = tl.ub_block_tables(tids)
            ub_ref = ub_scorer(
                tl.tile_docs, tl.tile_maxes, up(blk_idx), up(slot_row),
                up(w_idx), up(w_val), n_t1=tl.n_tiles + 1, s_pad=s_pad,
                n_queries=1)
            self.tile_stats["ub_launches"] += 1
            state.append({"tl": tl, "tids": tids, "ub_ref": ub_ref})

        ub_vals = iter(_fetch([st["ub_ref"] for st in state
                               if "ub_ref" in st]))

        def launch_wave(job, st, tiles):
            """One exact-scoring wave as budgeted chunk launches: a list
            of (tiles_chunk, refs, postings), or None on int32 overflow
            (dense / chunked fallback)."""
            dseg, qargs = job[0], job[1]
            k = job[7]
            tl = st["tl"]
            s_pad = qargs["s_pad"]
            overflow = []

            def launch_one(chunk):
                chunk = np.asarray(chunk)
                runs = tl.run_tables(st["tids"], chunk)
                n_cols = runs["n_cols"]
                # the guard of the JAX wave (its tile count padded to a
                # power of two), so both readers fall back together
                if s_pad * next_pow2(len(chunk)) * tl.T + runs["p_pad"] \
                        >= 2**31:
                    overflow.append(True)
                    return None
                flat = dseg.flat_postings()
                if "inputs" not in st:
                    # the weights and the doc-axis inputs go up once a
                    # job, as on the dense route; each wave gathers its
                    # tiles' columns on the device
                    st["inputs"] = (
                        [up(qargs[key]) for key in WEIGHT_KEYS],
                        [up(x) for x in job[2:7]])
                weights, masks = st["inputs"]
                tiles_dev = up(chunk.astype(np.int32))
                cols, oob = tile_cols(tiles_dev, tl.T, dseg.n1)
                refs = compiled.tile_execute(
                    flat["docs_flat"], flat["impacts_flat"],
                    tl.deleted_tiles, tiles_dev, up(runs["packed"]),
                    *weights,
                    *(gather_cols(x, cols, oob, fill)
                      for x, fill in zip(masks, MASK_FILLS)),
                    k=min(k, n_cols), s_pad=s_pad, n_cols=n_cols,
                    n_post=runs["postings"],
                    fmt=runs["packed_fmt"], has_scored_terms=has_scored,
                    need_scores=need_scores)
                self.tile_stats["wave_launches"] += 1
                return (chunk, refs, runs["postings"])

            out = []
            for chunk in self._plan_wave_chunks(tl, st["tids"], tiles,
                                                s_pad):
                out.extend(self._launch_chunk_retrying(chunk, launch_one))
                if overflow:
                    return None
            return out

        # wave 2: seed tiles (the top-C by bound)
        for job, st in zip(jobs, state):
            if "ub_ref" not in st:
                continue
            tl = st["tl"]
            k = job[7]
            ub = next(ub_vals)[0, :tl.n_tiles]
            st["ub"] = ub
            seed_c = min(seed_env or max(4, -(-4 * k // tl.T)),
                         tl.n_tiles)
            if seed_c < tl.n_tiles:
                part = np.argpartition(-ub, seed_c - 1)[:seed_c]
            else:
                part = np.arange(tl.n_tiles)
            tiles = np.unique(part[ub[part] > 0.0])
            if len(tiles) == 0:
                st["result"] = (np.full(k, -np.inf, dtype=np.float32),
                                np.zeros(k, dtype=np.int64), 0, 0)
                continue
            launched = launch_wave(job, st, tiles)
            if launched is None:
                st.clear()
                st["fallback"] = True
                continue
            st["wave"] = launched
            st["scored"] = np.zeros(tl.n_tiles, dtype=bool)
            st["scores"] = []
            st["docs"] = []
            st["mc"] = 0
            st["postings"] = 0

        # fetch wave 2, compute survivors, wave 3, finalize
        for wave_i in range(2):
            flat_refs = [x for st in state if "wave" in st
                         for _t, refs, _p in st["wave"] for x in refs]
            if not flat_refs:
                break
            vals = iter(_fetch(flat_refs))
            for job, st in zip(jobs, state):
                if "wave" not in st:
                    continue
                launched = st.pop("wave")
                tl = st["tl"]
                k = job[7]
                for tiles, _refs, postings in launched:
                    ts = next(vals)
                    ti = next(vals)
                    mc = next(vals)
                    st["scores"].append(ts)
                    st["docs"].append(tl.map_ids(tiles, ti))
                    st["mc"] += int(mc)
                    st["postings"] += postings
                    st["scored"][tiles] = True
                    self.tile_stats["tiles_scored"] += len(tiles)
                merged = np.concatenate(st["scores"])
                valid = merged > -np.inf
                theta = (np.partition(merged[valid], -k)[-k]
                         if int(valid.sum()) >= k else -np.inf)
                surv = (st["ub"] >= theta) & (st["ub"] > 0.0) \
                    & ~st["scored"]
                extra = np.flatnonzero(surv)
                if wave_i == 0 and len(extra):
                    launched = launch_wave(job, st, extra)
                    if launched is None:
                        st.clear()
                        st["fallback"] = True
                        continue
                    st["wave"] = launched
                    continue
                # finalize: the exact merged top-k
                scores_cat = np.concatenate(st["scores"])
                docs_cat = np.concatenate(st["docs"])
                order = np.lexsort((docs_cat, -scores_cat))[:k]
                out_s = np.full(k, -np.inf, dtype=np.float32)
                out_d = np.zeros(k, dtype=np.int64)
                out_s[:len(order)] = scores_cat[order]
                out_d[:len(order)] = docs_cat[order]
                st["result"] = (out_s, out_d, st["mc"], st["postings"])

        return [st.get("result") for st in state]

    def _run_segment_chunked(self, dseg, compiled, qargs, phrase_masks,
                             filter_masks, col_vals, col_has, root_mask,
                             has_scored: bool, need_scores: bool,
                             need_text_mask: bool = False):
        """Exact full execution in tile-column chunks (JAX
        ``_run_segment_chunked``) for segments whose dense [S, n1] impact
        matrix would pass int32 indexing or the memory budget. Every tile
        is scored (no pruning); the per-column mask and adjusted outputs
        are stitched back into doc-space host arrays and flow through the
        general result path. Returns (mask [n1] bool, adjusted [n1] f32,
        text mask [n1] bool or None: the matcher's mask before filters,
        which a hybrid request needs)."""
        tl = get_tile_index(dseg)
        s_pad = qargs["s_pad"]
        budget = int(os.environ.get(
            "SEARCHLITE_M_BUDGET_BYTES", 2 * 1024**3))
        max_cols = max(min(budget // (max(s_pad, 1) * 4),
                           (2**31 - 1) // (s_pad + 2)), tl.T)
        tiles_per_chunk = max(1, max_cols // tl.T)
        tids = qargs["slot_tids"][:qargs["n_slots"]]
        flat = dseg.flat_postings()
        up = self._upload
        # the doc-axis inputs and the weights go up once; each chunk
        # gathers its tiles' columns on the device
        masks = [up(x) for x in (phrase_masks, filter_masks, col_vals,
                                 col_has, root_mask)]
        weights = [up(qargs[key]) for key in WEIGHT_KEYS]

        launches = []  # (lo_col, n_cols, refs)
        for start in range(0, tl.n_tiles, tiles_per_chunk):
            stop = min(start + tiles_per_chunk, tl.n_tiles)
            tiles = np.arange(start, stop, dtype=np.int64)
            runs = tl.run_tables(tids, tiles)
            n_cols = runs["n_cols"]
            tiles_dev = up(tiles.astype(np.int32))
            cols, oob = tile_cols(tiles_dev, tl.T, dseg.n1)
            refs = compiled.tile_mask_execute(
                flat["docs_flat"], flat["impacts_flat"], tl.deleted_tiles,
                tiles_dev, up(runs["packed"]), *weights,
                *(gather_cols(x, cols, oob, fill)
                  for x, fill in zip(masks, MASK_FILLS)),
                s_pad=s_pad, n_cols=n_cols, n_post=runs["postings"],
                fmt=runs["packed_fmt"],
                has_scored_terms=has_scored, need_scores=need_scores)
            self.tile_stats["wave_launches"] += 1
            launches.append((start * tl.T, n_cols, refs))

        n_out = 3 if need_text_mask else 2
        vals = iter(_fetch([x for _lo, _n, refs in launches
                            for x in refs[:n_out]]))
        n1 = dseg.n1
        mask_np = np.zeros(n1, dtype=bool)
        adjusted_np = np.zeros(n1, dtype=np.float32)
        text_np = np.zeros(n1, dtype=bool) if need_text_mask else None
        for lo, n_cols, _refs in launches:
            fm = next(vals)
            adj = next(vals)
            hi = min(lo + n_cols, n1)
            mask_np[lo:hi] = fm[:hi - lo]
            adjusted_np[lo:hi] = adj[:hi - lo]
            if need_text_mask:
                text_np[lo:hi] = next(vals)[:hi - lo]
        return mask_np, adjusted_np, text_np

    def _pruned_postings(self, dseg, qargs, top_scores_np,
                         limit: int, strategy: str) -> int:
        """Counterfactual block-max pruning telemetry (the reference's
        wand/bmw counters): with the exact top-k threshold known, count
        the postings a pruned traversal would still advance. wand uses
        term-level upper bounds, bmw per-block upper bounds (block size
        128)."""
        seg = dseg.reader
        postings = seg.postings
        valid = top_scores_np[top_scores_np > -np.inf]
        if len(valid) < limit:
            return qargs["postings_touched"]
        threshold = float(valid[min(limit, len(valid)) - 1])
        slot_weight = qargs["slot_weight"]
        slot_keys = qargs["slot_keys"]
        term_ubs: dict[int, float] = {}
        slot_blocks: dict[int, tuple[int, int, int]] = {}
        for key, s in slot_keys.items():
            w = slot_weight.get(s)
            if w is None:
                continue
            tid = seg.terms.get(key)
            if tid is None:
                continue
            start = int(postings.term_block_start[tid])
            nb = int(postings.term_block_count[tid])
            df = int(postings.term_df[tid])
            slot_blocks[s] = (start, nb, df)
            bub = dseg.block_max_impact[start:start + nb]
            term_ubs[s] = float(bub.max() * w) if nb else 0.0
        total_ub = sum(term_ubs.values())
        advanced = 0
        for s, (start, nb, df) in slot_blocks.items():
            w = slot_weight[s]
            others = total_ub - term_ubs[s]
            if strategy == "wand":
                if term_ubs[s] + others >= threshold:
                    advanced += df
                continue
            bub = dseg.block_max_impact[start:start + nb] * w
            survive = (bub + others) >= threshold
            sizes = np.full(nb, 128, dtype=np.int64)
            if nb:
                sizes[-1] = df - 128 * (nb - 1)
            advanced += int(sizes[survive].sum())
        return advanced

    def _try_sparse_single(self, dseg, qargs, k: int):
        """One plain OR query through the strip kernel (JAX
        ``_try_sparse_single``): a [1, t_pad] table of the query's posting
        block ranges and summed weights, scored over its own candidate
        strip. Exact under ``QueryPlan.is_plain_or_sum`` (a match is a
        positive score; the count is the strip's). Past the strip cap, up
        to ``SEARCHLITE_HEAVY_SLOTS`` head terms leave the strip for point
        lookups (:func:`sparse_single_split_scorer`); an unsound
        certificate falls through. Fetches its own result. Returns
        (scores [k], ids [k], count, postings touched) as host values, or
        None (the caller runs the dense executor)."""
        mb_env = os.environ.get("SEARCHLITE_SINGLE_SPARSE_BLOCKS")
        if mb_env is not None:
            max_blocks = int(mb_env)
        else:
            # corpus-scaled strip cap, as the batched split route's
            max_blocks = max(512, 2 * (dseg.n1 // 640))
        if max_blocks <= 0 or k > MAX_STRIP_K:
            return None
        # corpus-size gate: at small n1 the dense executor answers as
        # fast, and its sums run in the historical order (D10)
        min_docs = int(os.environ.get(
            "SEARCHLITE_SINGLE_SPARSE_MIN_DOCS", "1000000"))
        if dseg.n1 < min_docs:
            return None
        n_slots = qargs["n_slots"]
        if n_slots == 0:
            return None
        postings = dseg.reader.postings
        tids = qargs["slot_tids"]
        bstart = postings.term_block_start[tids].astype(np.int64)
        bcnt = postings.term_block_count[tids].astype(np.int64)
        total = int(bcnt.sum())
        w = np.zeros(n_slots, dtype=np.float32)
        for s, v in qargs["slot_weight"].items():
            w[s] = v
        if total == 0 or k > total * 128 or (w <= 0).any():
            return None
        if total > max_blocks:
            return self._sparse_single_split(dseg, qargs, k, max_blocks,
                                             tids, bstart, bcnt, w, total)
        t_pad = next_pow2(max(n_slots, 2))
        tbl = np.zeros((3, 1, t_pad), dtype=np.int32)
        tbl[0, 0, :n_slots] = bstart
        tbl[1, 0, :n_slots] = bcnt
        tbl[2, 0, :n_slots] = w.view(np.int32)
        ts, td, cnt = _fetch(list(sparse_candidate_scorer(
            dseg.block_docs, dseg.block_impacts_live, self._upload(tbl),
            dseg.sparse_sentinels, k=k, t_pad=t_pad,
            nblk=pow15_bucket(total, minimum=16),
            log2_run=max((t_pad - 1).bit_length(), 1), with_counts=True)))
        self.single_routes["sparse_plain"] += 1
        return ts[0], td[0], int(cnt[0]), qargs["postings_touched"]

    def _sparse_single_split(self, dseg, qargs, k: int, max_blocks: int,
                             tids, bstart, bcnt, w, total: int):
        """The single-query term split (JAX ``_try_sparse_single``, past
        the cap): the minimal set of largest over-cap terms (at most
        ``SEARCHLITE_HEAVY_SLOTS``) leaves the strip. Counts: exact with
        one heavy term (n_strip + live_df - overlap), a lower bound with
        several (n_strip + max_h(live_df_h - overlap_h))."""
        if os.environ.get("SEARCHLITE_TERM_SPLIT", "1") == "0":
            return None
        term_cap = int(os.environ.get(
            "SEARCHLITE_HEAVY_TERM_BLOCKS",
            str(max_blocks if max_blocks <= 512
                else max(512, max_blocks // 16))))
        h_max = int(os.environ.get("SEARCHLITE_HEAVY_SLOTS", "4"))
        if int(bcnt.max()) <= term_cap:
            return None
        over = np.flatnonzero(bcnt > term_cap)
        order = over[np.argsort(-bcnt[over], kind="stable")]
        h_slots = []
        light_total = total
        for s in order:
            if len(h_slots) >= h_max:
                break
            h_slots.append(int(s))
            light_total -= int(bcnt[s])
            if light_total <= max_blocks:
                break
        h_slots = np.asarray(h_slots, dtype=np.int64)
        heavy = np.zeros(len(tids), dtype=bool)
        heavy[h_slots] = True
        if (light_total == 0 or light_total > max_blocks
                or k > light_total * 128):
            return None
        h_tids = [int(tids[s]) for s in h_slots]
        ub_ratio = float(os.environ.get("SEARCHLITE_SPLIT_UB_RATIO", "0.5"))
        maximp = dseg.heavy_lookup_host(term_cap)["maximp"]
        hub_sum = float((w[h_slots] * maximp[tids[h_slots]]).sum())
        lmax = float((w[~heavy] * maximp[tids[~heavy]]).max())
        if ub_ratio > 0 and hub_sum >= ub_ratio * lmax:
            return None  # certificate unlikely: go dense
        lt = int((~heavy).sum())
        t_pad = next_pow2(max(lt, 2))
        tbl = np.zeros((3, 1, t_pad), dtype=np.int32)
        tbl[0, 0, :lt] = bstart[~heavy]
        tbl[1, 0, :lt] = bcnt[~heavy]
        tbl[2, 0, :lt] = w[~heavy].view(np.int32)
        h_pad = next_pow2(max(len(h_slots), 1))
        hvy = np.zeros((2, h_pad), dtype=np.int32)
        hvy[0, :len(h_slots)] = h_tids
        hvy[1, :len(h_slots)] = w[h_slots].view(np.int32)
        hl = dseg.heavy_lookup(term_cap)
        out = sparse_single_split_scorer(
            dseg.block_docs, dseg.block_impacts_live, hl["tbl"], hl["base"],
            hl["log2g"], dseg.sparse_tid_tbl, hl["maximp"],
            self._upload(tbl), self._upload(hvy), dseg.sparse_sentinels,
            k=k, t_pad=t_pad, nblk=pow15_bucket(light_total, minimum=16),
            log2_run=max((t_pad - 1).bit_length(), 1))
        ts, td, n_strip, overlap, sound = _fetch(list(out))
        self.single_routes["sparse_split"] += 1
        if not bool(sound[0]):
            self.single_routes["split_fallthrough"] += 1
            return None
        ns = int(n_strip[0])
        if len(h_slots) == 1:
            cnt = ns + dseg.live_term_df(h_tids[0]) - int(overlap[0])
        else:
            cnt = ns + max(dseg.live_term_df(t) - int(overlap[i])
                           for i, t in enumerate(h_tids))
        return ts[0], td[0], cnt, qargs["postings_touched"]

    def _compile(self, plan: QueryPlan, k1: float, b: float) -> CompiledQuery:
        # cached by plan structure + schema fingerprint, process-wide
        sig = repr((_plan_sig(plan), self._schema_fingerprint, k1, b))
        with _GLOBAL_LOCK:
            cq = _GLOBAL_COMPILED.get(sig)
            if cq is None:
                cq = CompiledQuery(plan, self.schema, k1, b)
                _GLOBAL_COMPILED[sig] = cq
            return cq

    def _group_matches_doc(self, seg, keys, doc: int) -> bool:
        """Does the doc contain any of the group's terms?"""
        postings = seg.postings
        for key in keys:
            tid = seg.terms.get(key)
            if tid is None:
                continue
            docs, _tfs = postings.term_postings(tid)
            i = np.searchsorted(docs, doc)
            if i < len(docs) and docs[i] == doc:
                return True
        return False

    def _matcher_matches_host(self, matcher, seg, compiled,
                              group_keys, phrase_masks, doc: int) -> bool:
        """Host-side evaluation of the boolean matcher tree for ONE doc:
        the explain path's counterpart of ``CompiledQuery._eval_matcher``."""
        kind = matcher.kind
        if kind == "match_all":
            return True
        if kind == "term":
            return self._group_matches_doc(
                seg, group_keys[matcher.payload], doc)
        if kind == "phrase":
            return bool(phrase_masks[matcher.payload, doc])
        if kind == "query_string":
            p = matcher.payload
            if not p["term_groups"] and not p["phrase_groups"] \
                    and not p["not_term_groups"]:
                return False
            for idx in p["not_term_groups"]:
                if self._group_matches_doc(seg, group_keys[idx], doc):
                    return False
            for idx in p["phrase_groups"]:
                if not phrase_masks[idx, doc]:
                    return False
            if not p["term_groups"]:
                return True
            counts = sum(
                1 for idx in p["term_groups"]
                if self._group_matches_doc(seg, group_keys[idx], doc))
            required = p["minimum_should_match"]
            required = 1 if required is None else required
            return counts >= required
        if kind == "dis_max":
            return any(self._matcher_matches_host(
                c, seg, compiled, group_keys, phrase_masks, doc)
                for c in matcher.payload)
        if kind == "bool":
            p = matcher.payload
            for child in p["must"]:
                if not self._matcher_matches_host(
                        child, seg, compiled, group_keys, phrase_masks,
                        doc):
                    return False
            for child in p["must_not"]:
                if self._matcher_matches_host(
                        child, seg, compiled, group_keys, phrase_masks,
                        doc):
                    return False
            slot = compiled._matcher_filter_slot.get(id(matcher))
            if slot is not None:
                for f in compiled.filter_slots[slot]:
                    if not passes_filter(seg.fast, doc, f):
                        return False
            should = p["should"]
            if should:
                count = sum(
                    1 for child in should
                    if self._matcher_matches_host(
                        child, seg, compiled, group_keys, phrase_masks,
                        doc))
                min_should = p["minimum_should_match"]
                if min_should is None:
                    min_should = (1 if not p["must"] and not p["filter"]
                                  else 0)
                return count >= min_should
            if p["minimum_should_match"] not in (None, 0):
                return False
            return True
        return False

    def _explain_functions(self, compiled: CompiledQuery, score_tree,
                           segment_ord: int, doc: int, plan=None,
                           group_keys=None) -> list[dict]:
        """Per-hit custom-scoring breakdown (function contributions),
        recomputed on the host for the returned hits only. Each score
        node's matcher is evaluated for the doc: unmatched nodes
        contribute nothing (they scored 0 on the device)."""
        from searchlite_tpu_torch.query.score_functions import (
            apply_modifier_dense,
            decay_dense,
        )

        seg = self.segments[segment_ord]
        fast = seg.fast
        out: list[dict] = []
        phrase_masks = None
        if plan is not None and plan.phrase_specs:
            phrase_masks = self._segment_phrase_masks(
                seg, plan.phrase_specs)

        def node_matched(node) -> bool:
            matcher = node.params.get("matcher")
            if matcher is None or group_keys is None:
                return True
            return self._matcher_matches_host(
                matcher, seg, compiled, group_keys, phrase_masks, doc)

        def numeric_value(field: str):
            vals = fast.numeric_values(field, doc)
            return float(vals[0]) if vals else None

        def walk(node):
            if node.kind == "function_score":
                if not node_matched(node):
                    walk(node.params["base"])
                    for child in node.children:
                        walk(child)
                    return
                info = compiled._compiled_nodes.get(id(node), {})
                for func in info.get("functions", []):
                    if func.filter is not None and not passes_filter(
                            fast, doc, func.filter):
                        continue
                    if func.kind == "weight":
                        out.append({"type": "weight",
                                    "value": func.params["weight"],
                                    "field": None})
                    elif func.kind == "field_value_factor":
                        raw = numeric_value(func.params["field"])
                        if raw is None:
                            raw = func.params["missing"]
                        val = float(apply_modifier_dense(
                            np, np.asarray([raw * func.params["factor"]]),
                            func.params["modifier"])[0])
                        out.append({"type": "field_value_factor",
                                    "value": val,
                                    "field": func.params["field"]})
                    elif func.kind == "decay":
                        raw = numeric_value(func.params["field"])
                        if raw is None:
                            continue
                        dist = abs(raw - func.params["origin"]) - \
                            func.params["offset"]
                        norm = max(dist, 0.0) / func.params["scale"]
                        val = float(decay_dense(
                            np, func.params["decay"], np.asarray([norm]),
                            func.params["function"])[0])
                        out.append({
                            "type": f"decay_{func.params['function']}",
                            "value": val,
                            "field": func.params["field"]})
                walk(node.params["base"])
            elif node.kind == "rank_feature":
                if node_matched(node):
                    raw = numeric_value(node.params["field"])
                    out.append({"type": "rank_feature",
                                "value": raw if raw is not None
                                else node.params.get("missing") or 0.0,
                                "field": node.params["field"]})
            elif node.kind == "script_score":
                if node_matched(node):
                    out.append({"type": "script_score", "value": None,
                                "field": None})
                walk(node.params["base"])
            for child in node.children:
                walk(child)

        walk(score_tree)
        return out

    def _phrase_term_map(self, phrase_specs) -> dict[str, list[list[str]]]:
        out: dict[str, list[list[str]]] = {}
        for spec in phrase_specs:
            for field in spec.fields:
                out.setdefault(field, []).append(list(spec.terms))
        return out

    def _rescore_hits(self, hits: list[RankedHit], rescore_req,
                      default_fields, sort_plan, req, stats) -> None:
        if not hits or rescore_req.window_size == 0:
            return
        window = min(rescore_req.window_size, len(hits))
        plan = build_query_plan(rescore_req.query, default_fields)
        compiled = self._compile(plan, self.options.bm25_k1,
                                 self.options.bm25_b)
        qualified, group_keys = self._expand_term_groups(
            plan.term_groups, req.fuzzy)
        has_scored = bool(qualified)

        # the rescore query per involved segment: scores and masks
        seg_scores: dict[int, np.ndarray] = {}
        seg_masks: dict[int, np.ndarray] = {}
        involved = {h.key.segment_ord for h in hits[:window]}
        for dseg in self.device_segments:
            if dseg.ord not in involved or dseg.reader.doc_count == 0:
                continue
            seg = dseg.reader
            qargs = self._segment_query_args(
                dseg, qualified, group_keys, compiled.n_leaves,
                compiled.n_groups)
            phrase_masks = self._segment_phrase_masks(
                seg, plan.phrase_specs, n1=dseg.n1)
            filter_masks = self._segment_filter_masks(
                seg, compiled.filter_slots, n1=dseg.n1)
            col_vals, col_has = self._segment_columns(
                seg, compiled.columns, n1=dseg.n1)
            root_mask = np.ones(dseg.n1, dtype=bool)
            out = self._run_dense(
                dseg, compiled, qargs, phrase_masks, filter_masks,
                col_vals, col_has, root_mask, 0.0, 2, 0, k=1,
                has_scored=has_scored, need_scores=True, use_cursor=False)
            final_mask, adjusted = _fetch([out[3], out[4]])
            seg_scores[dseg.ord] = adjusted
            seg_masks[dseg.ord] = final_mask
            stats["postings_advanced"] += qargs["postings_touched"]

        mode = rescore_req.score_mode
        for h in hits[:window]:
            ord_, doc = h.key.segment_ord, h.key.doc_id
            mask = seg_masks.get(ord_)
            if mask is None or not mask[doc]:
                continue
            rescore_score = float(seg_scores[ord_][doc])
            stats["scored_docs"] += 1
            orig = h.score
            if mode in ("total", "sum"):
                combined = orig + rescore_score
            elif mode == "multiply":
                combined = orig * rescore_score
            elif mode == "max":
                combined = max(orig, rescore_score)
            else:
                combined = min(orig, rescore_score)
            h.score = combined
            if h.explanation is not None:
                h.explanation["rescore"] = {
                    "rescore_score": rescore_score,
                    "combined_score": combined,
                }
            elif req.explain:
                h.explanation = {
                    "base_score": orig,
                    "functions": [],
                    "rescore": {"rescore_score": rescore_score,
                                "combined_score": combined},
                    "final_score": combined,
                }
            # update the score part of the key so re-sorting sees it
            if sort_plan.uses_score():
                parts = list(h.key.parts)
                for i, f in enumerate(sort_plan.fields):
                    if f.kind == "score":
                        parts[i] = combined
                h.key = SortKey(parts, h.key.orders, h.key.segment_ord,
                                h.key.doc_id)
        hits[:window] = sorted(hits[:window], key=lambda h: _KeyWrap(h.key))

    def _collapse_hits(self, hits: list[RankedHit], collapse, sort_plan
                       ) -> list[tuple[RankedHit, list[RankedHit]]]:
        field = collapse.field
        groups: dict[Any, tuple[RankedHit, list[RankedHit]]] = {}
        order: list[Any] = []
        for h in hits:
            seg = self.segments[h.key.segment_ord]
            col = seg.fast.column(field)
            if col is not None and col.is_list:
                raise QueryError(
                    f"collapse field `{field}` must be single-valued")
            values = seg.fast.str_values(field, h.key.doc_id)
            group_key = values[0] if values else None
            if group_key not in groups:
                groups[group_key] = (h, [])
                order.append(group_key)
            else:
                groups[group_key][1].append(h)
        out = []
        for group_key in order:
            top, inner = groups[group_key]
            if collapse.inner_hits is not None:
                ih = collapse.inner_hits
                if ih.sort:
                    inner_plan = SortPlan.from_request(self.schema, ih.sort)
                    rekeyed = [
                        RankedHit(
                            key=inner_plan.build_key(
                                self.segments[x.key.segment_ord].fast,
                                x.key.doc_id, x.score, x.key.segment_ord),
                            score=x.score, explanation=x.explanation)
                        for x in inner
                    ]
                    rekeyed.sort(key=lambda h: _KeyWrap(h.key))
                    inner = rekeyed
                start = ih.from_
                size = ih.size if ih.size is not None else 3
                inner = inner[start:start + size]
            else:
                inner = []
            out.append((top, inner))
        return out

    def _execute_suggest(self, suggest_reqs) -> dict:
        out = {}
        for name, sreq in suggest_reqs.items():
            if self.schema.field_kind(sreq.field) not in ("text", "keyword"):
                raise QueryError(
                    f"suggest field `{sreq.field}` must be text or keyword")
            analyzer = self.analysis.search_analyzer(sreq.field)
            prefix = sreq.prefix
            if analyzer is not None:
                prefix = analyzer.normalize_pattern(prefix)
            else:
                prefix = prefix.lower()
            candidates: dict[str, float] = {}
            doc_freqs: dict[str, int] = {}
            field_prefix_len = len(sreq.field) + 1

            def consider(term: str, seg, tid):
                _docs, tfs = seg.postings.term_postings(tid)
                score = float(tfs.sum())
                candidates[term] = candidates.get(term, 0.0) + score
                doc_freqs[term] = doc_freqs.get(term, 0) + \
                    int(seg.postings.term_df[tid])

            for seg in self.segments:
                scanned = 0
                for key, tid in seg.terms.iter_prefix(
                        f"{sreq.field}:{prefix}"):
                    if scanned >= MAX_SUGGEST_CANDIDATES:
                        break
                    term = key[field_prefix_len:]
                    consider(term, seg, tid)
                    scanned += 1
            if sreq.fuzzy is not None and len(candidates) < sreq.size:
                max_edits = min(sreq.fuzzy.max_edits, 2)
                plen = min(sreq.fuzzy.prefix_length, len(prefix))
                for seg in self.segments:
                    scanned = 0
                    for key, tid in seg.terms.iter_prefix(
                            f"{sreq.field}:{prefix[:plen]}"):
                        if scanned >= MAX_SUGGEST_CANDIDATES:
                            break
                        term = key[field_prefix_len:]
                        scanned += 1
                        if term in candidates:
                            continue
                        candidate_prefix = term[:len(prefix)]
                        if bounded_levenshtein(
                                prefix, candidate_prefix,
                                max_edits) is not None:
                            consider(term, seg, tid)
            ranked = sorted(candidates.items(),
                            key=lambda kv: (-kv[1], kv[0]))[:sreq.size]
            out[name] = {
                "options": [
                    {"text": term, "score": score,
                     "doc_freq": doc_freqs.get(term, 0)}
                    for term, score in ranked
                ]
            }
        return out

    def _materialize_hit(self, ranked: RankedHit, req,
                         highlight_terms: list[str],
                         phrase_terms: dict) -> Optional[Hit]:
        seg = self.segments[ranked.key.segment_ord]
        doc = ranked.key.doc_id
        if doc >= seg.doc_count:
            return None
        doc_id_str = seg.doc_id(doc)
        need_doc = (req.return_stored or req.highlight_field is not None
                    or req.highlight is not None)
        doc_cache = None
        if need_doc:
            try:
                doc_cache = seg.get_doc(doc)
            except Exception:  # noqa: BLE001
                doc_cache = None

        snippet = None
        if req.highlight_field is not None and doc_cache is not None:
            text_val = doc_cache.get(req.highlight_field)
            if isinstance(text_val, str):
                phrases = self._normalize_phrases(
                    phrase_terms.get(req.highlight_field, []),
                    req.highlight_field)
                snippet = make_snippet(text_val, highlight_terms, phrases)

        highlights = None
        if req.highlight is not None and doc_cache is not None:
            highlights = {}
            for field, opts in req.highlight.fields.items():
                text_val = doc_cache.get(field)
                if not isinstance(text_val, str):
                    continue
                analyzer = self.analysis.search_analyzer(field)
                if analyzer is not None:
                    seen = set()
                    terms = []
                    for term in highlight_terms:
                        for tok in analyzer.analyze(term):
                            if tok.text not in seen:
                                seen.add(tok.text)
                                terms.append(tok.text)
                else:
                    terms = list(highlight_terms)
                phrases = self._normalize_phrases(
                    phrase_terms.get(field, []), field)
                frags = highlight_fragments(
                    text_val, terms, phrases,
                    HighlightOptions(opts.pre_tag, opts.post_tag,
                                     opts.fragment_size,
                                     opts.number_of_fragments))
                if frags:
                    highlights[field] = frags
            if not highlights:
                highlights = None

        return Hit(
            doc_id=doc_id_str,
            score=ranked.score,
            vector_score=ranked.vector_score,
            fields=doc_cache if req.return_stored else None,
            snippet=snippet,
            explanation=ranked.explanation,
            highlights=highlights,
            sort_key=ranked.key,
        )

    def _normalize_phrases(self, phrases: list[list[str]],
                           field: str) -> list[list[str]]:
        analyzer = self.analysis.search_analyzer(field)
        if analyzer is None:
            return phrases
        out = []
        for phrase in phrases:
            tokens = analyzer.analyze(" ".join(phrase))
            if tokens:
                out.append([t.text for t in tokens])
        return out

    def search_batch(self, queries: list[str], limit: int = 10,
                     fields: Optional[list[str]] = None,
                     execution: str = "bm25",
                     filters: Optional[list] = None,
                     limits: Optional[list[int]] = None,
                     mesh=None) -> list[list[tuple[str, float]]]:
        """Exact top-``limit`` ``(doc_id, score)`` pairs per query, in
        (score desc, doc asc) order -- one batch of
        :meth:`search_batch_many`."""
        return self.search_batch_many(
            [queries], limit=limit, fields=fields, execution=execution,
            filters=None if filters is None else [filters],
            limits=None if limits is None else [limits], mesh=mesh)[0]

    def search_batch_many(self, batches: list[list[str]], limit: int = 10,
                          fields: Optional[list[str]] = None,
                          execution: str = "bm25",
                          filters: Optional[list] = None,
                          limits: Optional[list] = None,
                          output: str = "pairs", mesh=None) -> list:
        """A stream of batches: every batch's device work is enqueued
        before any result is copied back, in one copy. ``output="pairs"``
        returns per batch a list of ``(doc_id, score)`` lists;
        ``output="arrays"`` returns per batch ``(scores [Q,k] f32,
        doc_ords [Q,k] i32, seg_ords [Q,k] i32)`` with -inf past each
        row's matches and limit (the JAX reader's contract)."""
        if limit <= 0:
            raise QueryError("limit must be > 0")
        if execution not in ("bm25", "wand", "bmw"):
            raise QueryError(f"unknown execution strategy `{execution}`")
        if output not in ("pairs", "arrays"):
            raise QueryError(f"unknown output form `{output}`")
        if mesh is not None:
            raise _not_ported("mesh execution", "multi-GPU")
        if fields is None:
            fields = [f.name for f in self.schema.text_fields]
        limits = self._check_batch_limits(batches, limit, limits)
        filter_tables = self._batch_filter_tables(batches, filters)
        coalesced = self._coalesce(batches, limit, fields, limits, output,
                                   filter_tables, execution)
        if coalesced is not None:
            return coalesced
        if execution in ("wand", "bmw"):
            # per-query pruning is the default batched pruned path (union
            # waves degrade to a dense scan on Zipf batches); filtered
            # batches keep the union path, whose run scorer applies
            # per-query filter rows. wand / bmw are execution HINTS with
            # the same exact top-k: where every segment holds at least
            # SEARCHLITE_BATCH_STRIP_MIN_DOCS docs, auto mode routes them
            # through the strip / dense scorers below; =pq pins the tile
            # path whatever the corpus size (as in the JAX reader, any
            # value but auto and union reads as pq).
            mode = os.environ.get("SEARCHLITE_BATCH_PRUNE", "auto")
            has_filters = any(f[0] is not None for f in filter_tables)
            strip_min = int(os.environ.get(
                "SEARCHLITE_BATCH_STRIP_MIN_DOCS", "2000000"))
            live = [d for d in self.device_segments
                    if d.reader.doc_count > 0]
            strip_route = (mode == "auto" and not has_filters and live
                           and all(d.n1 >= strip_min for d in live))
            if not strip_route:
                if mode != "union" and not has_filters:
                    return self._retry_oom(
                        lambda: self._search_batch_pruned_pq(
                            batches, limit, fields, limits, output=output))
                return self._retry_oom(
                    lambda: self._search_batch_pruned_many(
                        batches, limit, fields, filter_tables, limits,
                        output=output))
        # memory budget of the dense M + score matrices on one device;
        # past it a segment takes the oversized-corpus strip route
        m_budget = int(os.environ.get("SEARCHLITE_M_BUDGET_BYTES",
                                      2 * 1024**3))

        # phase 1: prep + enqueue every batch and segment
        analyzed_box = [None]  # Python analysis only if native rejects
        launches = []  # per batch: [(seg_ord, scores, ids)]
        pending_recs = []  # term-split soundness checks (+ bi/li)
        for bi, (queries, (fidx, distinct), blimits) in enumerate(
                zip(batches, filter_tables, limits)):
            k_batch = int(blimits.max()) if len(blimits) else limit
            launched = []
            for dseg in self.device_segments:
                seg = dseg.reader
                if seg.doc_count == 0:
                    continue
                qb = self._qb_lazy_native(seg, dseg, batches, bi, fields,
                                          analyzed_box)
                k = min(k_batch, dseg.n1)
                pend: list = []
                est_bytes = (qb["s_pad"] + len(queries)) * dseg.n1 * 4
                if int(qb["n_queries"]) == 0:
                    scores = torch.empty((0, k), device=self.device)
                    ids = torch.empty((0, k), dtype=torch.int32,
                                      device=self.device)
                elif (est_bytes <= m_budget
                        and qb["flat_extent"] < FLAT_INDEX_LIMIT):
                    scores, ids = self._launch_batch_segment(
                        dseg, qb, k, fidx, distinct, pending=pend)
                else:
                    scores, ids = self._oversized_launch(
                        dseg, qb, k, fidx, distinct, est_bytes, m_budget,
                        pend)
                for rec in pend:
                    rec["bi"] = bi
                    rec["li"] = len(launched)
                    pending_recs.append(rec)
                launched.append((dseg.ord, scores, ids))
            launches.append(launched)

        # phase 2: ONE device-to-host copy for every batch and segment,
        # the term-split soundness flags riding along
        flat = [t for launched in launches for _o, s, i in launched
                for t in (s, i)]
        n_main = len(flat)
        flat += [rec["sound"].to(torch.int32) for rec in pending_recs]
        host = _fetch(flat)
        if pending_recs:
            self._apply_split_fallbacks(launches, host, n_main,
                                        pending_recs)
            del host[n_main:]

        # phase 3: host merge per batch
        out = []
        cursor = 0
        for queries, launched, blimits in zip(batches, launches, limits):
            per_segment = []
            for seg_ord, _s, _i in launched:
                per_segment.append((seg_ord, host[cursor],
                                    host[cursor + 1]))
                cursor += 2
            out.append(self._merge_batch_output(
                queries, per_segment, blimits, output, limit))
        return out

    # -- batching helpers ---------------------------------------------------

    def _check_batch_limits(self, batches, limit: int, limits):
        """Per-query limits: one int64 array per batch."""
        if limits is None:
            return [np.full(len(qs), limit, dtype=np.int64)
                    for qs in batches]
        if len(limits) != len(batches):
            raise QueryError("limits must align with batches")
        out = []
        for qs, bl in zip(batches, limits):
            if bl is None:
                out.append(np.full(len(qs), limit, dtype=np.int64))
                continue
            if len(bl) != len(qs):
                raise QueryError("limits must align with queries")
            arr = np.asarray(bl, dtype=np.int64)
            if len(arr) and arr.min() <= 0:
                raise QueryError("every limit must be > 0")
            out.append(arr)
        return out

    def _batch_filter_tables(self, batches, filters):
        """Validate and deduplicate per-query filters (JAX
        ``_batch_filter_tables``): per batch (fidx [Q] int32, distinct
        [Filter, ...]), or (None, None) for a batch without filters;
        fidx 0 means no filter (row 0 of the mask table is all-true)."""
        if filters is None:
            return [(None, None)] * len(batches)
        if len(filters) != len(batches):
            raise QueryError("filters must align with batches")
        out = []
        for queries, batch_filters in zip(batches, filters):
            if batch_filters is None:
                out.append((None, None))
                continue
            if len(batch_filters) != len(queries):
                raise QueryError("filters must align with queries")
            distinct: list = []
            by_key: dict[str, int] = {}
            fidx = np.zeros(len(queries), dtype=np.int32)
            for i, f in enumerate(batch_filters):
                if f is None:
                    continue
                fobj = Filter.from_json(f)
                validate_filter(self.schema, fobj)
                key = json.dumps(fobj.to_json(), sort_keys=True)
                fid = by_key.get(key)
                if fid is None:
                    distinct.append(fobj)
                    fid = len(distinct)  # 1-based; 0 = match-all
                    by_key[key] = fid
                fidx[i] = fid
            out.append((fidx, distinct) if distinct else (None, None))
        return out

    def _segment_filter_rows(self, dseg, distinct) -> torch.Tensor:
        """[F+1, n1] bool mask table of one segment on its device: row 0
        all-true over the segment's docs, rows 1..F the distinct filters
        (JAX ``_segment_filter_rows_np`` + ``_segment_filter_rows``).
        Cached per (segment, filters)."""
        key = tuple(json.dumps(f.to_json(), sort_keys=True)
                    for f in distinct)
        cached = dseg.filter_rows_cache
        if cached is not None and cached[0] == key:
            return cached[1]
        seg = dseg.reader
        rows = np.zeros((len(distinct) + 1, dseg.n1), dtype=bool)
        rows[0, :seg.doc_count] = True
        for i, fobj in enumerate(distinct):
            rows[i + 1, :seg.doc_count] = compute_filters_mask(seg.fast,
                                                              [fobj])
        rows_dev = torch.from_numpy(rows).to(dseg.device)
        dseg.filter_rows_cache = (key, rows_dev)
        return rows_dev

    def _coalesce(self, batches, limit, fields, limits, output,
                  filter_tables, execution: str = "bm25"):
        """Micro-batch coalescing (JAX ``reader.py:2254-2308``): re-chunk
        a stream of narrow filterless batches into launches of up to
        ``SEARCHLITE_BATCH_COALESCE`` queries and split the results back
        per batch (rows are independent). Returns None when the stream
        is not coalesced."""
        coalesce = int(os.environ.get("SEARCHLITE_BATCH_COALESCE", "4096"))
        if not (coalesce > 0 and len(batches) > 1
                and all(f[0] is None for f in filter_tables)
                and max(len(b) for b in batches) <= coalesce // 2):
            return None
        groups: list[tuple[int, int]] = []
        start, total = 0, 0
        for i, b in enumerate(batches):
            if total and total + len(b) > coalesce:
                groups.append((start, i))
                start, total = i, 0
            total += len(b)
        groups.append((start, len(batches)))
        if len(groups) == len(batches):
            return None
        merged = [[q for b in batches[s:e] for q in b] for s, e in groups]
        merged_limits = [np.concatenate(limits[s:e]) for s, e in groups]
        outs = self.search_batch_many(
            merged, limit=limit, fields=fields, execution=execution,
            limits=merged_limits, output=output)
        split: list = []
        for (s, e), gout in zip(groups, outs):
            row = 0
            for bi, b in enumerate(batches[s:e], start=s):
                if output == "arrays":
                    sc, di, sg = gout
                    # this batch's own max limit, as un-coalesced
                    kb = int(limits[bi].max()) if len(limits[bi]) else limit
                    kb = min(kb, sc.shape[1])
                    split.append((sc[row:row + len(b), :kb],
                                  di[row:row + len(b), :kb],
                                  sg[row:row + len(b), :kb]))
                else:
                    split.append(gout[row:row + len(b)])
                row += len(b)
        return split

    def _analyze_batches(self, batches, fields):
        """Python query analysis for batches the native prep rejects:
        per-query (field, token) pairs, memoized per (field, raw term)."""
        cache = self._token_cache

        def term_pairs(field: str, raw_term: str):
            hit = cache.get((field, raw_term))
            if hit is None:
                if self.schema.field_kind(field) == "keyword":
                    hit = [(field, raw_term.lower())]
                else:
                    analyzer = self.analysis.search_analyzer(field)
                    hit = ([] if analyzer is None else
                           [(field, tok.text)
                            for tok in analyzer.analyze(raw_term)])
                cache[(field, raw_term)] = hit
            return hit

        out = []
        for queries in batches:
            analyzed = []
            for raw in queries:
                pairs: list[tuple[str, str]] = []
                for term in parse_query(raw).terms:
                    for field in ([term.field] if term.field is not None
                                  else fields):
                        pairs.extend(term_pairs(field, term.term))
                analyzed.append(pairs)
            out.append(analyzed)
        return out

    # -- routes ----------------------------------------------------------

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(arr), device=self.device)

    def _oversized_launch(self, dseg, qb, k: int, fidx, distinct,
                          est_bytes: int, m_budget: int, pending: list):
        """A segment over the dense-M budget (JAX ``search_batch_many``,
        ``reader.py:2407-2424``): unfiltered batches try the candidate
        strips with the oversized-corpus cap, term-split rows included;
        when no row fits the cap, or no term of the batch is in the
        segment, every row rides full strips (where the JAX reader takes
        the scan: either is exact, and full strips are the faster on this
        card). Filtered batches, k > 1024 and batches the strips cannot
        hold take the doc-sharded dense scan."""
        out = None
        if fidx is None:
            out = self._try_sparse_candidates(dseg, qb, k,
                                              shard_budget=m_budget,
                                              pending=pending)
            if out is None:
                out = self._full_strip_launch(dseg, qb, k)
                if out is not None:
                    nq = int(qb["n_queries"])
                    out = (out[0][:nq], out[1][:nq])
        if out is None:
            del pending[:]
            out = self._search_batch_sharded(dseg, qb, k, est_bytes,
                                             m_budget, fidx, distinct)
        return out

    def _search_batch_sharded(self, dseg, qb, limit: int, est_bytes: int,
                              budget: int, fidx=None, distinct=None,
                              n_rows: Optional[int] = None):
        """The doc-sharded dense scan (JAX ``_search_batch_sharded``) for a
        batch whose dense M would pass the memory budget or int32
        indexing: the doc axis is cut into ``n_shards`` ranges
        (``DeviceSegment.doc_shards``), each shard scores through the
        block scorer and the fused kernel at N = ``shard_width + 1`` with
        the shard's deleted and filter rows, and the shards' top-k lists
        merge on the device in (score desc, doc asc) order, so no launch
        waits for a copy. ``n_rows`` is the count of real rows for
        ``route_rows`` (default: every row of ``qb``). Returns (scores
        [Q, kk], ids [Q, kk] int32) device tensors, kk = min(limit, the
        shards' lists together)."""
        ensure_dense_tables(qb)
        n_shards = 1
        while est_bytes // n_shards > budget:
            n_shards *= 2
        # a shard's flat scatter must also fit int32 indexing (the byte
        # budget usually implies it; not when the budget is raised or
        # FLAT_INDEX_LIMIT is lowered)
        while (qb["s_pad"] * (-(-dseg.n1 // n_shards) + 1)
               + qb["nb_pad"] * 128 >= FLAT_INDEX_LIMIT
               and n_shards < dseg.n1):
            n_shards *= 2
        shards = dseg.doc_shards(n_shards)
        width = shards["shard_width"]
        n_terms = shards["n_terms"]
        tids = qb["slot_tids"]
        s_pad = qb["s_pad"]
        q = int(qb["n_queries"])
        self.route_rows["sharded"] += q if n_rows is None else n_rows
        # one [n_shards, 2, s_pad] upload of per-slot block ranges; the
        # O(blocks) gather tables expand on the device
        bs_stack = np.zeros((n_shards, 2, s_pad), dtype=np.int32)
        nb = np.ones(n_shards, dtype=np.int64)
        for d in range(n_shards):
            keys = d * n_terms + tids
            bcnts = shards["blocks"][keys]
            bs_stack[d, 0, :len(tids)] = shards["block_base"][keys]
            bs_stack[d, 1, :len(tids)] = bcnts
            nb[d] = max(int(bcnts.sum()), 1)
        pad_cols = n_shards * width - dseg.n1

        def shard_stack(rows, fill: bool):
            """[R, n1] bool on the device as [n_shards, R, width + 1]:
            each shard's columns, ``fill`` past n1 and in the shard's
            sentinel column."""
            r = rows.shape[0]
            full = torch.nn.functional.pad(rows, (0, pad_cols), value=fill)
            cut = full.reshape(r, n_shards, width).permute(1, 0, 2)
            return torch.nn.functional.pad(cut, (0, 1),
                                           value=fill).contiguous()

        del_stack = shards.get("deleted_stack")
        if del_stack is None:
            del_stack = shard_stack(dseg.deleted[None, :], True)[:, 0]
            shards["deleted_stack"] = del_stack = del_stack.contiguous()
        bs_dev = self._upload(bs_stack)
        w_idx_dev = self._upload(qb["w_idx"])
        w_val_dev = self._upload(qb["w_val"])
        rows_dev = fidx_dev = None
        if fidx is not None:
            rows_dev = shard_stack(
                self._segment_filter_rows(dseg, distinct), False)
            fidx_dev = self._upload(fidx)
        all_scores, all_ids = [], []
        for d in range(n_shards):
            lo = d * width
            if min(lo + width, dseg.n1) <= lo:
                continue  # trailing empty shard (n_shards rounded up)
            scores, ids = expand_impact_scorer(
                shards["block_docs"], shards["block_impacts"], del_stack[d],
                bs_dev[d, 0], bs_dev[d, 1], shards["sentinel_row"],
                w_idx_dev, w_val_dev,
                None if rows_dev is None else rows_dev[d], fidx_dev,
                k=min(limit, width), s_pad=s_pad, nb_pad=int(nb[d]),
                n_queries=q)
            all_scores.append(scores)
            all_ids.append(ids + lo)
        # the merge of np.lexsort((ids, -scores)): two stable sorts, doc
        # ascending then score descending; -inf entries end each row
        cat_scores = torch.cat(all_scores, dim=1)
        cat_ids = torch.cat(all_ids, dim=1)
        by_doc = torch.argsort(cat_ids, dim=1, stable=True)
        cat_scores = torch.gather(cat_scores, 1, by_doc)
        cat_ids = torch.gather(cat_ids, 1, by_doc)
        order = torch.argsort(cat_scores, dim=1, descending=True,
                              stable=True)[:, :limit]
        return (torch.gather(cat_scores, 1, order),
                torch.gather(cat_ids, 1, order))

    def _launch_batch_segment(self, dseg, qb, k: int, fidx=None,
                              distinct=None, allow_sparse: bool = True,
                              pending=None, n_rows: Optional[int] = None):
        """One segment's batch under the budget (JAX
        ``_launch_batch_segment_inner``): unfiltered batches try the
        candidate strips first; the rest take the dense split scorer when
        the segment has dense rows and the batch a dense slot, else the
        plain block scorer. ``(fidx, distinct)`` are the batch's filters
        (see :meth:`_batch_filter_tables`). ``n_rows`` is the count of real
        rows for ``route_rows`` (default: every row of ``qb``). Returns
        (scores [Q,k], ids [Q,k]) device tensors."""
        use_filters = fidx is not None
        if allow_sparse and not use_filters:
            out = self._try_sparse_candidates(dseg, qb, k, pending=pending)
            if out is not None:
                return out
        if qb["flat_extent"] >= FLAT_INDEX_LIMIT:
            raise QueryError(
                "impact matrix exceeds int32 indexing; route through "
                "the doc-sharded batch path")
        ensure_dense_tables(qb)
        self.route_rows["dense"] += (int(qb["n_queries"]) if n_rows is None
                                     else n_rows)
        filter_rows = fidx_dev = None
        if use_filters:
            filter_rows = self._segment_filter_rows(dseg, distinct)
            fidx_dev = self._upload(fidx)
        dense_budget = int(os.environ.get("SEARCHLITE_DENSE_M_BYTES",
                                          2 * 1024**3))
        if dense_budget > 0:
            dense = dseg.dense_rows(dense_budget)
            if dense is not None:
                split = split_impact_batch(
                    qb, dense["row_of_tid"],
                    n_rows=len(dense["row_of_tid"]), n1=dseg.n1)
                if split is not None:
                    return split_impact_scorer(
                        dseg.block_docs, dseg.block_impacts_live,
                        dense["m_dense"], dseg.deleted,
                        self._upload(split["packed"]), filter_rows,
                        fidx_dev, k=k, s_pad=split["s_pad"],
                        n_queries=qb["n_queries"], nb_pad=split["nb_pad"],
                        wd_pad=split["wd_pad"], ws_pad=split["ws_pad"])
        return impact_scorer(
            dseg.block_docs, dseg.block_impacts_live, dseg.deleted,
            self._upload(qb["blk_idx"]), self._upload(qb["slot_row"]),
            self._upload(qb["w_idx"]), self._upload(qb["w_val"]),
            filter_rows, fidx_dev, k=k, s_pad=qb["s_pad"],
            n_queries=qb["n_queries"])

    def _try_sparse_candidates(self, dseg, qb, k: int,
                               shard_budget: int = 0, pending=None):
        """Route a batch through the candidate strips (JAX
        ``_try_sparse_candidates``): rows within the block cap (32 under
        the budget, ``max(512, 2*n1/640)`` with ``shard_budget`` set) are
        scored on their own candidates; the remainder is re-packed and
        scored dense under the budget, on full strips over it; both row
        groups are scattered back into batch order. With ``pending`` (a
        list) head-term rows may take the term split, and a record of
        their soundness flags is appended: the caller must fetch it and
        re-score unsound rows (:meth:`_apply_split_fallbacks`). Returns
        None when the strips do not apply (the caller goes dense)."""
        mb_env = os.environ.get("SEARCHLITE_SPARSE_MAX_BLOCKS")
        if mb_env is not None:
            max_blocks = int(mb_env)
        elif shard_budget:
            max_blocks = max(512, 2 * (dseg.n1 // 640))
        else:
            max_blocks = 32
        if max_blocks <= 0 or k > MAX_STRIP_K:
            return None
        nq = int(qb["n_queries"])
        if nq == 0 or qb["n_slots"] == 0:
            return None
        launched = self._sparse_light_launch(
            dseg, qb, k, max_blocks, allow_split=pending is not None)
        if launched is None:
            return None
        ts, td, part = launched
        light_idx = part["light_idx"]
        heavy_idx = part["heavy_idx"]
        if part.get("sound") is not None:
            pending.append({
                "dseg": dseg, "qb": qb, "light_idx": light_idx,
                "sound": part["sound"], "k": k,
                "shard_budget": shard_budget})
        if len(heavy_idx) == 0 and len(light_idx) == nq \
                and ts.shape[0] == nq:
            return ts, td
        light_map = np.full(ts.shape[0], nq, dtype=np.int32)
        light_map[:len(light_idx)] = light_idx
        if len(heavy_idx):
            hqb = subset_impact_batch(qb, heavy_idx)
            hs, hi = self._remainder_launch(dseg, hqb, k, shard_budget,
                                            len(heavy_idx))
            heavy_map = np.full(hs.shape[0], nq, dtype=np.int32)
            heavy_map[:len(heavy_idx)] = heavy_idx
        else:
            hs = torch.full((1, k), float("-inf"), device=self.device)
            hi = torch.zeros((1, k), dtype=torch.int32, device=self.device)
            heavy_map = np.full(1, nq, dtype=np.int32)
        return row_combine(ts, td, hs, hi,
                           self._upload(np.concatenate(
                               [light_map, heavy_map])), n_rows=nq)

    def _remainder_launch(self, dseg, hqb, k: int, shard_budget: int,
                          n_rows: int):
        """Score a re-packed subset of a batch's rows (the strips'
        remainder, or rows whose certificate failed) exactly. Under the
        budget: the dense scorers. Over it (``shard_budget`` set), as the
        JAX reader: full strips; else the doc-sharded scan when the
        subset's own dense M is still over the budget or int32 indexing;
        else the dense scorers, because a subset of rows may fit where
        the batch did not. Returns (scores, ids) device tensors, at least
        ``n_rows`` rows."""
        if shard_budget:
            out = self._full_strip_launch(dseg, hqb, k)
            if out is not None:
                return out
            est = (hqb["s_pad"] + hqb["n_queries"]) * dseg.n1 * 4
            if est > shard_budget or hqb["flat_extent"] >= FLAT_INDEX_LIMIT:
                hs, hi = self._search_batch_sharded(
                    dseg, hqb, k, est, shard_budget, n_rows=n_rows)
                if hs.shape[1] < k:
                    # the shards together hold fewer than k docs
                    pad = (0, k - hs.shape[1])
                    hs = torch.nn.functional.pad(hs, pad,
                                                 value=float("-inf"))
                    hi = torch.nn.functional.pad(hi, pad, value=0)
                return hs, hi
        return self._launch_batch_segment(dseg, hqb, k, allow_sparse=False,
                                          n_rows=n_rows)

    def _full_strip_launch(self, dseg, qb, k: int):
        """Exact, certificate-free scoring on full strips: every term of
        every row rides the strip (the cap is the widest row's block
        count). Returns (scores, ids) in row order, padded rows last, or
        None when the strips cannot hold the batch."""
        nq = int(qb["n_queries"])
        if nq == 0 or k > MAX_STRIP_K:
            return None
        mb = max(int(qb["q_nblk"].max()), 1)
        launched = self._sparse_light_launch(dseg, qb, k, mb)
        if launched is None:
            return None
        ts, td, part = launched
        if len(part["heavy_idx"]) or len(part["light_idx"]) != nq:
            return None
        return ts, td

    def _sparse_light_launch(self, dseg, qb, k: int, max_blocks: int,
                             allow_split: bool = False):
        """Partition the rows within ``max_blocks`` and score them (JAX
        ``_sparse_light_launch``): packed uploads in pow-4 block-count
        tiers, gathered back into light-row order, or one explicit table
        when the packed format does not apply. With ``allow_split`` the
        term-split partition also admits head-term rows; their groups run
        the term-split scorer and ``partition["sound"]`` holds per-light-
        row soundness flags the caller must honour. Returns (scores, ids,
        partition), rows aligned to ``partition["light_idx"]``, or None
        when no row is light."""
        host = dseg.host
        part = None
        term_cap = 0
        use_packed = os.environ.get("SEARCHLITE_SPARSE_PACKED", "1") != "0"
        if (allow_split and use_packed
                and os.environ.get("SEARCHLITE_TERM_SPLIT", "1") != "0"):
            term_cap = int(os.environ.get(
                "SEARCHLITE_HEAVY_TERM_BLOCKS",
                str(max_blocks if max_blocks <= 512
                    else max(512, max_blocks // 16))))
            h_max = int(os.environ.get("SEARCHLITE_HEAVY_SLOTS", "4"))
            ub_ratio = float(os.environ.get("SEARCHLITE_SPLIT_UB_RATIO",
                                            "0.5"))
            part = partition_sparse_batch_split(
                qb, max_blocks, host.idf32, k, term_cap, h_max,
                maximp=host.heavy_lookup_host(term_cap)["maximp"],
                ub_ratio=ub_ratio)
        if part is None and use_packed:
            part = partition_sparse_batch_tiered(qb, max_blocks,
                                                 host.idf32, k)
        if part is not None:
            groups = part["groups"]
            kp = next_pow2(max(4 * k, 64))
            outs = []
            flags = []
            for g in groups:
                n_real = len(g["pos_in_light"])
                if g.get("hvy") is not None:
                    # kp must clear the candidate band (JAX: a floor of
                    # SEARCHLITE_SPLIT_KP, at most 8192)
                    kp_g = next_pow2(min(
                        max(kp, g["nblk"] * 128 // 64,
                            int(os.environ.get("SEARCHLITE_SPLIT_KP",
                                               "4096"))), 8192))
                    hl = dseg.heavy_lookup(term_cap)
                    # only rows with a head term run the lookups
                    heavy_rows = np.flatnonzero(
                        (g["hvy"][1] != 0).any(axis=1))
                    ts_g, td_g, snd = sparse_candidate_scorer_split(
                        dseg.block_docs, dseg.block_impacts_live,
                        dseg.sparse_tid_tbl, hl["tbl"], hl["base"],
                        hl["log2g"], hl["maximp"], self._upload(g["packed"]),
                        self._upload(g["ovr"]), self._upload(g["hvy"]),
                        dseg.sparse_sentinels, k=k, kp=kp_g,
                        t_pad=g["t_pad"], nblk=g["nblk"],
                        log2_run=g["log2_run"], h_pad=g["h_pad"],
                        n_ovr=g["n_ovr"],
                        heavy_rows=self._upload(heavy_rows))
                    outs.append((ts_g, td_g))
                    flags.append(snd)
                    n_split = len(heavy_rows)
                    self.route_rows["split"] += n_split
                    self.route_rows["strip"] += n_real - n_split
                else:
                    outs.append(sparse_candidate_scorer_packed(
                        dseg.block_docs, dseg.block_impacts_live,
                        dseg.sparse_tid_tbl, self._upload(g["packed"]),
                        self._upload(g["ovr"]), dseg.sparse_sentinels,
                        k=k, t_pad=g["t_pad"], nblk=g["nblk"],
                        log2_run=g["log2_run"], n_ovr=g["n_ovr"]))
                    flags.append(None)
                    self.route_rows["strip"] += n_real
            any_split = any(f is not None for f in flags)
            n_light = len(part["light_idx"])
            if (len(groups) == 1
                    and np.array_equal(groups[0]["pos_in_light"],
                                       np.arange(n_light))):
                # one tier holding every light row in order
                if any_split:
                    part["sound"] = flags[0]
                return outs[0][0], outs[0][1], part
            bl = part["bl"]
            posmaps = np.full(sum(g["packed"].shape[0] for g in groups),
                              bl, dtype=np.int32)
            off = 0
            for g in groups:
                posmaps[off:off + len(g["pos_in_light"])] = \
                    g["pos_in_light"]
                off += g["packed"].shape[0]
            if any_split:
                flags = [f if f is not None else torch.ones(
                    (o[0].shape[0],), dtype=torch.bool, device=self.device)
                    for f, o in zip(flags, outs)]
                ts, td, part["sound"] = group_gather_sound(
                    [o[0] for o in outs], [o[1] for o in outs], flags,
                    self._upload(posmaps), bl=bl)
                return ts, td, part
            ts, td = group_gather([o[0] for o in outs],
                                  [o[1] for o in outs],
                                  self._upload(posmaps), bl=bl)
            return ts, td, part
        part = partition_sparse_batch(qb, max_blocks)
        if part is None or k > part["nblk"] * 128:
            return None
        self.route_rows["strip"] += len(part["light_idx"])
        # explicit table: row chunks bound each launch's strip lanes
        tbl = part["tbl"]
        nblk = part["nblk"]
        step = max(16, STRIP_CHUNK_ELEMS // (nblk * 128))
        outs = [sparse_candidate_scorer(
            dseg.block_docs, dseg.block_impacts_live,
            self._upload(tbl[:, r0:r0 + step]), dseg.sparse_sentinels,
            k=k, t_pad=part["t_pad"], nblk=nblk,
            log2_run=part["log2_run"])
            for r0 in range(0, tbl.shape[1], step)]
        return (torch.cat([o[0] for o in outs]),
                torch.cat([o[1] for o in outs]), part)

    def _apply_split_fallbacks(self, launches, host, n_main: int,
                               pending_recs) -> None:
        """The term split's fallback wave (JAX ``_apply_split_fallbacks``):
        rows whose soundness certificate failed are re-scored (dense under
        the budget, on full strips over it) and patched into the fetched
        per-(batch, segment) arrays in place. One more dispatch and fetch
        round, only when some row failed."""
        entry_off = np.cumsum([0] + [len(launched) for launched in launches])
        patches = []
        for rec, flags in zip(pending_recs, host[n_main:]):
            li = rec["light_idx"]
            bad = li[flags[:len(li)] == 0]
            if len(bad) == 0:
                continue
            dseg = rec["dseg"]
            self._split_fallback_rows += len(bad)
            self.route_rows["fallback"] += len(bad)
            hqb = subset_impact_batch(rec["qb"], np.asarray(bad))
            out = self._remainder_launch(dseg, hqb, rec["k"],
                                         rec["shard_budget"], len(bad))
            patches.append((rec, bad, out[0], out[1]))
        if not patches:
            return
        vals = iter(_fetch([x for _r, _b, ps, pi in patches
                            for x in (ps, pi)]))
        for rec, bad, _s, _i in patches:
            ps = next(vals)
            pi = next(vals)
            pos = 2 * (int(entry_off[rec["bi"]]) + rec["li"])
            sc = np.array(host[pos], copy=True)
            ids = np.array(host[pos + 1], copy=True)
            sc[bad] = ps[:len(bad)]
            ids[bad] = pi[:len(bad)]
            host[pos] = sc
            host[pos + 1] = ids

    # -- batched doc-tile pruning (execution wand / bmw) ---------------------

    def _qb_lazy_native(self, seg, dseg, batches, bi, fields, analyzed_box,
                        lazy_tables: bool = True):
        """One (batch, segment) qb through the native prep, falling back
        to Python analysis (computed once for the whole stream, cached in
        ``analyzed_box[0]``) when the native side rejects the batch."""
        qb = build_impact_batch_native(
            seg, dseg.host, batches[bi], fields, self.analysis,
            self.schema, lazy_tables=lazy_tables)
        if qb is None:
            if analyzed_box[0] is None:
                analyzed_box[0] = self._analyze_batches(batches, fields)
            qb = build_impact_batch(seg, dseg.host, analyzed_box[0][bi],
                                    lazy_tables=lazy_tables)
        return qb

    def _search_batch_pruned_pq(self, batches, limit: int, fields, limits,
                                output: str = "pairs"):
        """PER-QUERY doc-tile pruned batch execution (JAX
        ``_search_batch_pruned_pq``). Every query keeps a PRIVATE
        candidate space: its top-C tiles by upper bound, scored in a
        compacted [Q*tpq, C*T] matrix built from per-(query, term, tile)
        posting runs (``TileIndex.run_tables_per_query``, one packed
        upload a wave), then survivor rounds until no tile with UB >= the
        query's threshold is left unprocessed. Light rows (their block
        span under ``SEARCHLITE_WAND_SPARSE_BLOCKS``) skip the tile
        machinery and ride the candidate strips.

        Seed selection, the threshold, the running top-k merge and the
        doc-id mapping stay on the device: the host only sees [Q, C] tile
        ids per wave. Waves are pipelined across all (batch, segment) work
        items: one bulk copy per wave round."""
        up = self._upload
        analyzed_box = [None]
        sparse_cap = int(os.environ.get(
            "SEARCHLITE_WAND_SPARSE_BLOCKS",
            os.environ.get("SEARCHLITE_SPARSE_MAX_BLOCKS", "512")))

        # wave 0: UB launches for every (batch, segment)
        items: list[_PqItem] = []
        for bi in range(len(batches)):
            for dseg in self.device_segments:
                seg = dseg.reader
                if seg.doc_count == 0:
                    continue
                it = _PqItem()
                it.bi = bi
                it.dseg = dseg
                it.tl = get_tile_index(dseg)
                it.qb = self._qb_lazy_native(
                    seg, dseg, batches, bi, fields, analyzed_box)
                q = it.qb["n_queries"]
                it.k = min(int(limits[bi].max()) if len(limits[bi])
                           else limit, dseg.n1)
                lims = np.minimum(limits[bi], it.k)
                items.append(it)
                if it.qb["n_slots"] == 0:
                    it.done = True
                    continue
                # light queries skip the tile machinery: the candidate
                # strips gather ONLY their own postings; only the heavy
                # (head-term) remainder runs tile waves
                launched = None
                if sparse_cap > 0 and it.k <= MAX_STRIP_K:
                    launched = self._sparse_light_launch(
                        dseg, it.qb, it.k, sparse_cap)
                if launched is not None:
                    ts, td, part = launched
                    it.sparse = (ts, td, part["light_idx"])
                    heavy_idx = part["heavy_idx"]
                    if len(heavy_idx) == 0:
                        it.done = True
                        continue
                    it.hmap = heavy_idx
                    it.qb = subset_impact_batch(it.qb, heavy_idx)
                    q = it.qb["n_queries"]
                    lims = np.full(q, it.k, dtype=np.int64)
                    lims[:len(heavy_idx)] = np.minimum(
                        limits[bi][heavy_idx], it.k)
                it.lims = up(lims.astype(np.int32))
                # per-query term / weight tables from the qb's slot CSR
                # (rows are slot-ascending)
                ensure_dense_tables(it.qb)  # qb was built lazily
                tids = it.qb["slot_tids"]
                counts = csr_row_lengths(it.qb)
                all_q = np.arange(q, dtype=np.int64)
                idx, sc, pos = csr_take_rows(it.qb["qs_start"], counts,
                                             all_q)
                tpq = int(sc.max()) if len(sc) else 1
                it.tpq_pad = next_pow2(max(tpq, 2))
                q_tids = np.full((q, it.tpq_pad), -1, dtype=np.int64)
                w_b = np.zeros((q, it.tpq_pad), dtype=np.float32)
                rows_rep = np.repeat(all_q, sc)
                q_tids[rows_rep, pos] = tids[it.qb["qs_slot"][idx]]
                w_b[rows_rep, pos] = it.qb["qs_w"][idx]
                it.q_tids = q_tids
                it.w_b = up(w_b)
                blk_idx, slot_row, _ = it.tl.ub_block_tables(
                    tids[:it.qb["n_slots"]])
                it.ub = ub_scorer(
                    it.tl.tile_docs, it.tl.tile_maxes, up(blk_idx),
                    up(slot_row), up(it.qb["w_idx"]), up(it.qb["w_val"]),
                    n_t1=it.tl.n_tiles + 1, s_pad=it.qb["s_pad"],
                    n_queries=q)[:, :it.tl.n_tiles]
                self.tile_stats["ub_launches"] += 1
                self.route_rows["tiles"] += (
                    len(it.hmap) if it.hmap is not None else len(lims))
                it.processed = torch.zeros((q, it.tl.n_tiles),
                                           dtype=torch.bool,
                                           device=self.device)
                it.theta = torch.full((q,), float("-inf"),
                                      device=self.device)

        seed_c = int(os.environ.get("SEARCHLITE_SEED_TILES_PER_QUERY", 0))
        m_budget = int(os.environ.get("SEARCHLITE_M_BUDGET_BYTES",
                                      2 * 1024**3))

        def launch_select(it):
            c = seed_c or max(2, -(-it.k // it.tl.T) + 1)
            # survivor rounds widen geometrically (capped) so a
            # loose-bound query cannot force thousands of tiny rounds
            c = min(c << min(it.rounds, 6), max(64, c))
            # M_b is [Q*tpq, C*T]: cap C by the device memory budget
            q = it.qb["n_queries"]
            c_mem = max(1, m_budget // (8 * q * it.tpq_pad * it.tl.T))
            c = min(c, next_pow2(c_mem) // 2 or 1)
            c = next_pow2(min(max(c, -(-it.k // it.tl.T)),
                              it.tl.n_tiles))
            it.rounds += 1
            self.tile_stats["rounds"] += 1
            ids, remaining, it.processed = seed_select(
                it.ub, it.processed, it.theta, c=c)
            return ids, remaining

        # the seed round and the survivor rounds share one loop: select,
        # fetch the ids, score and merge (pipelined per round)
        live = [it for it in items if not it.done]
        while live:
            sel_refs = [launch_select(it) for it in live]
            fetched = _fetch([x for pair in sel_refs for x in pair])
            for i, it in enumerate(live):
                ids_np = fetched[2 * i]
                remaining = int(fetched[2 * i + 1].sum())
                n_real = int((ids_np < it.tl.n_tiles).sum())
                if n_real == 0:
                    it.done = True
                    continue
                self.tile_stats["tiles_scored"] += n_real
                q_tiles = np.sort(ids_np.astype(np.int64), axis=1)
                runs = it.tl.run_tables_per_query(
                    it.q_tids, q_tiles, it.tpq_pad)
                n_cols = runs["n_cols"]
                flat = it.dseg.flat_postings()
                top, docs = pq_run_scorer(
                    flat["docs_flat"], flat["impacts_flat"],
                    it.tl.deleted_tiles, up(q_tiles.astype(np.int32)),
                    it.w_b, up(runs["packed"]), k=it.k, n_cols=n_cols,
                    n_post=runs["postings"], tpq_pad=it.tpq_pad,
                    t=it.tl.T, fmt=runs["packed_fmt"])
                self.tile_stats["wave_launches"] += 1
                if top.shape[1] < it.k:  # n_cols < k: pad to k wide
                    pad = (0, it.k - top.shape[1])
                    top = torch.nn.functional.pad(top, pad,
                                                  value=float("-inf"))
                    docs = torch.nn.functional.pad(docs, pad)
                if it.run_s is None:
                    it.run_s, it.run_d, it.theta = topk_merge(
                        top, docs, top[:, :0], docs[:, :0], it.lims)
                else:
                    it.run_s, it.run_d, it.theta = topk_merge(
                        it.run_s, it.run_d, top, docs, it.lims)
                if remaining == 0:
                    it.done = True
            live = [it for it in items if not it.done]

        # fetch the final per-item results (bulk)
        final_refs = []
        for it in items:
            if it.run_s is not None:
                final_refs.extend((it.run_s, it.run_d))
            if it.sparse is not None:
                final_refs.extend(it.sparse[:2])
        final_vals = iter(_fetch(final_refs))
        per_batch_segments: list[list] = [[] for _ in batches]
        for it in items:
            if it.run_s is None and it.sparse is None:
                continue
            nq = len(batches[it.bi])
            s_np = d_np = None
            if it.run_s is not None:
                s_np = next(final_vals)
                d_np = next(final_vals).astype(np.int64)
                d_np = np.where(s_np > -np.inf, d_np, 0)
            if it.sparse is not None:
                ts = next(final_vals)
                td = next(final_vals).astype(np.int64)
                light_idx = it.sparse[2]
                k = ts.shape[1]
                s_full = np.full((nq, k), -np.inf, dtype=np.float32)
                d_full = np.zeros((nq, k), dtype=np.int64)
                s_full[light_idx] = ts[:len(light_idx)]
                d_full[light_idx] = np.where(
                    ts[:len(light_idx)] > -np.inf, td[:len(light_idx)], 0)
                if s_np is not None and it.hmap is not None:
                    s_full[it.hmap] = s_np[:len(it.hmap), :k]
                    d_full[it.hmap] = d_np[:len(it.hmap), :k]
                s_np, d_np = s_full, d_full
            per_batch_segments[it.bi].append((it.dseg.ord, s_np, d_np))
        return [self._merge_batch_output(queries, per_segment, limits[bi],
                                         output, limit)
                for bi, (queries, per_segment) in enumerate(
                    zip(batches, per_batch_segments))]

    def _search_batch_pruned_many(self, batches, limit: int, fields,
                                  filter_tables, limits,
                                  output: str = "pairs"):
        """Three-wave doc-tile pruned execution over the UNION of the
        batch's tiles (JAX ``_search_batch_pruned_many``): wave 1 computes
        per-tile score upper bounds, wave 2 exactly scores each query's
        top tiles by bound, wave 3 the remaining tiles whose bound reaches
        the observed top-k threshold of some query (usually none). Exact
        per query. Waves are pipelined across all batches and segments:
        three bulk copies in all. Per-query filters shrink the match set
        only, so the bound stays sound; thresholds use filtered exact
        scores."""
        up = self._upload
        seed_c = int(os.environ.get("SEARCHLITE_SEED_TILES", 0))
        analyzed_box = [None]

        # wave 1: per (batch, segment) the UB matrix
        work = []  # (batch_i, dseg, tl, qb, ub_ref)
        for bi in range(len(batches)):
            for dseg in self.device_segments:
                seg = dseg.reader
                if seg.doc_count == 0:
                    continue
                qb = self._qb_lazy_native(
                    seg, dseg, batches, bi, fields, analyzed_box,
                    lazy_tables=False)
                tl = get_tile_index(dseg)
                n_slots = qb["n_slots"]
                if n_slots == 0:
                    work.append((bi, dseg, tl, qb, None))
                    continue
                blk_idx, slot_row, _ = tl.ub_block_tables(
                    qb["slot_tids"][:n_slots])
                ub_ref = ub_scorer(
                    tl.tile_docs, tl.tile_maxes, up(blk_idx), up(slot_row),
                    up(qb["w_idx"]), up(qb["w_val"]),
                    n_t1=tl.n_tiles + 1, s_pad=qb["s_pad"],
                    n_queries=qb["n_queries"])
                self.tile_stats["ub_launches"] += 1
                self.route_rows["tiles"] += len(batches[bi])
                work.append((bi, dseg, tl, qb, ub_ref))

        ub_iter = iter(_fetch([ref for *_x, ref in work
                               if ref is not None]))

        def k_of(bi):
            return int(limits[bi].max()) if len(limits[bi]) else limit

        def gather_wave(tl, refs, vals, s_parts, d_parts):
            for _s, _i, chunk_tiles, _p in refs:
                s_parts.append(next(vals))
                d_parts.append(tl.map_ids(chunk_tiles, next(vals)))
                self.tile_stats["tiles_scored"] += len(chunk_tiles)
            return (np.concatenate(s_parts, axis=1),
                    np.concatenate(d_parts, axis=1))

        # wave 2: seed tiles, per query the top-C tiles by UB
        wave2 = []  # (ub, seed_tiles, refs or None)
        for bi, dseg, tl, qb, ub_ref in work:
            if ub_ref is None:
                wave2.append((None, None, None))
                continue
            ub = next(ub_iter)[:, :tl.n_tiles]
            c = min(seed_c or max(4, -(-4 * k_of(bi) // tl.T)), tl.n_tiles)
            if c < tl.n_tiles:
                part = np.argpartition(-ub, c - 1, axis=1)[:, :c]
            else:
                part = np.broadcast_to(
                    np.arange(tl.n_tiles), ub.shape).copy()
            pos = ub[np.arange(ub.shape[0])[:, None], part] > 0.0
            seed = np.unique(part[pos])
            if len(seed) == 0:
                wave2.append((ub, seed, None))
                continue
            refs = self._launch_tile_runs(dseg, tl, qb, seed, k_of(bi),
                                          filter_tables[bi])
            wave2.append((ub, seed, refs))

        vals2 = iter(_fetch([x for _ub, _seed, refs in wave2
                             if refs is not None
                             for chunk in refs for x in chunk[:2]]))

        # wave 3: survivors, the tiles with UB >= theta for any query
        wave3 = []  # (seed result or None, refs or None)
        for (bi, dseg, tl, qb, _r), (ub, seed, refs) in zip(work, wave2):
            if refs is None:
                wave3.append((None, None))
                continue
            scores2, docs2 = gather_wave(tl, refs, vals2, [], [])
            # rows must be (score desc, doc asc)-sorted for the per-query
            # threshold pick below; single-chunk rows already are
            if len(refs) > 1:
                order = np.lexsort((docs2, -scores2), axis=-1)
                scores2 = np.take_along_axis(scores2, order, axis=1)
                docs2 = np.take_along_axis(docs2, order, axis=1)
            nvalid = (scores2 > -np.inf).sum(axis=1)
            # per-query threshold at that query's OWN limit (tighter
            # than the batch max, still exact)
            theta = np.full(scores2.shape[0], -np.inf, dtype=np.float64)
            lims = np.minimum(limits[bi], scores2.shape[1]).astype(int)
            qs = np.flatnonzero(nvalid[:len(lims)] >= lims)
            if len(qs):
                theta[qs] = scores2[qs, lims[qs] - 1]
            surv = ((ub >= theta[:, None]) & (ub > 0.0)).any(axis=0)
            surv[seed] = False
            extra = np.flatnonzero(surv).astype(seed.dtype)
            refs3 = None
            if len(extra):
                refs3 = self._launch_tile_runs(dseg, tl, qb, extra,
                                               k_of(bi), filter_tables[bi])
            wave3.append(((scores2, docs2), refs3))

        vals3 = iter(_fetch([x for _res, refs in wave3 if refs is not None
                             for chunk in refs for x in chunk[:2]]))

        # merge per (batch, segment), then across segments per batch
        per_batch_segments: list[list] = [[] for _ in batches]
        for (bi, dseg, tl, qb, _r), (res, refs3) in zip(work, wave3):
            if res is None:
                continue
            scores2, docs2 = res
            if refs3 is not None:
                scores2, docs2 = gather_wave(tl, refs3, vals3, [scores2],
                                             [docs2])
            # exact per-query top-limit: sort by (-score, doc)
            order = np.lexsort((docs2, -scores2), axis=-1)[:, :k_of(bi)]
            top_s = np.take_along_axis(scores2, order, axis=1)
            top_d = np.take_along_axis(docs2, order, axis=1)
            top_d = np.where(top_s > -np.inf, top_d, 0)
            nq = len(batches[bi])
            per_batch_segments[bi].append(
                (dseg.ord, top_s[:nq].astype(np.float32), top_d[:nq]))
        return [self._merge_batch_output(queries, per_segment, limits[bi],
                                         output, limit)
                for bi, (queries, per_segment) in enumerate(
                    zip(batches, per_batch_segments))]

    @staticmethod
    def _plan_wave_chunks(tl, slot_tids, tiles, s_pad: int) -> list:
        """Split a wave's tile set into launch chunks bounded by the
        memory budget, counting BOTH the M matrix (4*s_pad*T per tile)
        and the posting-proportional device intermediates of
        build_m_from_runs (32 bytes per posting slot). The arithmetic is
        the JAX reader's (its pow-2 tile pad and pow-4 posting bucket
        included), so waves split at the same budgets. Returns a list of
        tile-subset arrays."""
        budget = int(os.environ.get(
            "SEARCHLITE_M_BUDGET_BYTES", 2 * 1024**3)) // 2
        per_tile_m = 4 * max(s_pad, 1) * tl.T
        tile_posts = tl.tile_postings(slot_tids, tiles)
        csum = np.concatenate([[0], np.cumsum(tile_posts)])

        def fits(lo, hi):
            m_bytes = per_tile_m * next_pow2(hi - lo)
            p_pad = pow4_bucket(max(int(csum[hi] - csum[lo]), 1),
                                minimum=1024)
            return m_bytes + 32 * p_pad <= budget

        max_tiles_m = max(1, budget // per_tile_m)
        chunks = []
        lo, n_sel = 0, len(tiles)
        while lo < n_sel:
            hi = min(lo + max_tiles_m, n_sel)
            # largest prefix that fits (binary search over hi)
            good, bad = lo + 1, hi + 1
            while bad - good > 1:
                mid = (good + bad) // 2
                if fits(lo, mid):
                    good = mid
                else:
                    bad = mid
            hi = good
            chunks.append(tiles[lo:hi])
            lo = hi
        return chunks

    def _launch_tile_runs(self, dseg, tl, qb, tiles, limit: int,
                          filter_table=(None, None)):
        """One exact-scoring wave over the selected tiles, split into
        budgeted launches (:meth:`_plan_wave_chunks`; the wave-3 survivor
        set is unbounded). Returns a list of (scores, ids, tiles_chunk,
        postings); the caller merges the per-chunk top-k on the host. A
        launch that still runs out of device memory evicts the rebuildable
        device caches and retries on progressively smaller chunks."""
        chunks = self._plan_wave_chunks(
            tl, qb["slot_tids"][:qb["n_slots"]], tiles, qb["s_pad"])
        out = []
        for chunk in chunks:
            out.extend(self._launch_chunk_retrying(
                chunk, lambda c: self._launch_tile_runs_one(
                    dseg, tl, qb, c, limit, filter_table)))
        return out

    def _evict_and_collect(self):
        import gc

        for ds in self.device_segments:
            ds.evict_device_caches()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _retry_oom(self, run):
        """Coarse outer retry: an out-of-memory error past the per-launch
        retry (in a fetch, a merge) evicts the rebuildable device caches
        and re-runs the whole pruned pass once (the pass is pure). The
        retry happens AFTER the except block exits: the exception's
        traceback pins the failed pass's frames, and their tensors, for
        the handler's lifetime, which would defeat the eviction."""
        try:
            return run()
        except torch.OutOfMemoryError:
            pass
        self._evict_and_collect()
        return run()

    def _launch_chunk_retrying(self, chunk, launch_one) -> list:
        # retries run outside the except blocks, see _retry_oom
        try:
            return [launch_one(chunk)]
        except torch.OutOfMemoryError:
            pass
        self._evict_and_collect()
        try:
            return [launch_one(chunk)]
        except torch.OutOfMemoryError:
            if len(chunk) <= 1:
                raise
        mid = len(chunk) // 2
        return (self._launch_chunk_retrying(chunk[:mid], launch_one)
                + self._launch_chunk_retrying(chunk[mid:], launch_one))

    def _launch_tile_runs_one(self, dseg, tl, qb, tiles, limit: int,
                              filter_table=(None, None)):
        tiles = np.asarray(tiles)
        n_slots = qb["n_slots"]
        runs = tl.run_tables(qb["slot_tids"][:n_slots], tiles)
        n_cols = runs["n_cols"]
        s_pad = qb["s_pad"]
        # the JAX wave's guard (its tile count padded to a power of two)
        if s_pad * next_pow2(len(tiles)) * tl.T + runs["p_pad"] >= 2**31:
            raise QueryError(
                "tile wave exceeds int32 device indexing; lower "
                "SEARCHLITE_SEED_TILES or shard the corpus")
        fidx, distinct = filter_table
        tiles_dev = self._upload(tiles.astype(np.int32))
        filter_rows = fidx_dev = None
        if fidx is not None:
            # the segment's resident filter rows, gathered to tile space
            # on the device (no per-launch upload of the mask columns)
            filter_rows = gather_cols(
                self._segment_filter_rows(dseg, distinct),
                *tile_cols(tiles_dev, tl.T, dseg.n1), False)
            fidx_dev = self._upload(fidx)
        flat = dseg.flat_postings()
        scores, ids = run_batch_scorer(
            flat["docs_flat"], flat["impacts_flat"], tl.deleted_tiles,
            tiles_dev,
            self._upload(runs["packed"]), self._upload(qb["w_idx"]),
            self._upload(qb["w_val"]), filter_rows, fidx_dev,
            k=min(limit, n_cols), n_cols=n_cols,
            n_post=runs["postings"], s_pad=s_pad,
            n_queries=qb["n_queries"], fmt=runs["packed_fmt"])
        self.tile_stats["wave_launches"] += 1
        return (scores, ids, tiles, runs["postings"])

    # -- host merge -----------------------------------------------------------

    def _merge_batch_output(self, queries, per_segment, blimits,
                            output: str, limit: int):
        """One batch's per-segment (seg_ord, scores, ids) as the requested
        result surface, the empty index included."""
        if output == "arrays":
            if not per_segment:
                k = int(blimits.max()) if len(blimits) else limit
                q = len(queries)
                return (np.full((q, k), -np.inf, dtype=np.float32),
                        np.zeros((q, k), dtype=np.int32),
                        np.zeros((q, k), dtype=np.int32))
            return self._merge_batch_arrays(per_segment, blimits)
        if not per_segment:
            return [[] for _ in queries]
        return self._merge_batch_results(per_segment, blimits)

    def _merge_batch_arrays(self, per_segment, limits):
        """Per-segment top-k merged into (scores, doc_ords, seg_ords),
        (score desc, (seg, doc) asc), -inf past each row's matches and
        limit; one lexsort."""
        if len(per_segment) == 1:
            seg_ord, scores, ids = per_segment[0]
            scores = scores.astype(np.float32, copy=True)
            ids = ids.astype(np.int32, copy=False)
            seg_arr = np.full(ids.shape, seg_ord, dtype=np.int32)
        else:
            scores = np.concatenate(
                [s for _o, s, _i in per_segment], axis=1).astype(np.float32)
            ids = np.concatenate(
                [i for _o, _s, i in per_segment], axis=1).astype(np.int32)
            seg_arr = np.concatenate(
                [np.full(i.shape, o, dtype=np.int32)
                 for o, _s, i in per_segment], axis=1)
            order = np.lexsort((ids, seg_arr, -scores), axis=-1)
            k = min(scores.shape[1],
                    int(limits.max()) if len(limits) else scores.shape[1])
            order = order[:, :k]
            scores = np.take_along_axis(scores, order, axis=1)
            ids = np.take_along_axis(ids, order, axis=1)
            seg_arr = np.take_along_axis(seg_arr, order, axis=1)
        col = np.arange(scores.shape[1])
        scores[col[None, :] >= np.asarray(limits)[:, None]] = -np.inf
        return scores, ids, seg_arr

    def _merge_batch_results(self, per_segment, limits):
        scores, ids, seg_arr = self._merge_batch_arrays(per_segment, limits)
        docstrs = np.empty(ids.shape, dtype=object)
        for seg_ord, _s, _i in per_segment:
            seg = self.segments[seg_ord]
            dids = getattr(seg, "_doc_ids_obj_arr", None)
            if dids is None or len(dids) != len(seg.doc_ids):
                dids = np.asarray(seg.doc_ids, dtype=object)
                seg._doc_ids_obj_arr = dids
            mask = seg_arr == seg_ord
            # -inf cells may hold the dead slot: clip, they are never read
            docstrs[mask] = dids[np.minimum(ids[mask], len(dids) - 1)]
        take = (scores != -np.inf).sum(axis=1).astype(np.int64)
        mod = get_results_mod()
        if mod is not None:
            return mod.build(np.ascontiguousarray(docstrs),
                             np.ascontiguousarray(scores, dtype=np.float32),
                             np.ascontiguousarray(take, dtype=np.int64))
        return [list(zip(drow[:n].tolist(), srow[:n]))
                for n, drow, srow in zip(take.tolist(), docstrs,
                                         scores.tolist())]


class _PqItem:
    """One (batch, segment) work item of the per-query pruned path."""

    __slots__ = ("bi", "dseg", "tl", "qb", "ub", "q_tids", "w_b",
                 "tpq_pad", "k", "lims", "processed", "theta", "run_s",
                 "run_d", "rounds", "done", "sparse", "hmap")

    def __init__(self):
        self.ub = self.sparse = self.hmap = None
        self.run_s = self.run_d = None
        self.rounds = 0
        self.done = False


class _KeyWrap:
    """Comparison wrapper around SortKey for ``list.sort``."""

    __slots__ = ("key",)

    def __init__(self, key: SortKey):
        self.key = key

    def __lt__(self, other):
        return self.key._cmp(other.key) < 0


def _plan_sig(plan: QueryPlan) -> str:
    def matcher_sig(m) -> str:
        if m.kind in ("term", "phrase"):
            return f"{m.kind}{m.payload}"
        if m.kind == "match_all":
            return "all"
        if m.kind == "query_string":
            p = m.payload
            return (f"qs({p['term_groups']},{p['phrase_groups']},"
                    f"{p['not_term_groups']},{p['minimum_should_match']})")
        if m.kind == "dis_max":
            return "dm(" + ",".join(matcher_sig(c) for c in m.payload) + ")"
        p = m.payload
        return ("bool(" + ",".join(matcher_sig(c) for c in p["must"]) + ";"
                + ",".join(matcher_sig(c) for c in p["should"]) + ";"
                + ",".join(matcher_sig(c) for c in p["must_not"]) + ";"
                + json.dumps([f.to_json() for f in p["filter"]],
                             sort_keys=True)
                + f";{p['minimum_should_match']})")

    def node_sig(n) -> str:
        base = f"{n.kind}[{n.expr.signature() if n.expr else ''}]"
        if n.params:
            safe = {k: v for k, v in n.params.items()
                    if k not in ("matcher", "base")}
            try:
                base += json.dumps(safe, sort_keys=True, default=repr)
            except TypeError:
                base += repr(sorted(safe))
            if "matcher" in n.params:
                base += matcher_sig(n.params["matcher"])
            if "base" in n.params:
                base += node_sig(n.params["base"])
        return base + "(" + ",".join(node_sig(c) for c in n.children) + ")"

    scorer_sig = plan.scorer.signature() if plan.scorer else "-"
    return (f"{matcher_sig(plan.matcher)}|{scorer_sig}|"
            f"{node_sig(plan.score_tree)}|{plan.leaf_count}|"
            f"{len(plan.term_groups)}|{len(plan.phrase_specs)}")


_NUMPY_OF = {torch.float32: np.float32, torch.float64: np.float64,
             torch.int32: np.int32, torch.int64: np.int64,
             torch.bool: np.bool_}


def _fetch(tensors: list[torch.Tensor]) -> list[np.ndarray]:
    """One device-to-host copy of many tensors (f32, f64, int32, int64,
    bool):
    their bytes are concatenated, each padded to 8 bytes, and split back
    into numpy arrays of their own dtypes and shapes."""
    if not tensors:
        return []
    parts = []
    for t in tensors:
        b = t.contiguous().reshape(-1).view(torch.uint8)
        pad = -b.numel() % 8
        if pad:
            b = torch.cat([b, b.new_zeros(pad)])
        parts.append(b)
    flat = torch.cat(parts).cpu().numpy()
    out = []
    off = 0
    for t, part in zip(tensors, parts):
        n = t.numel() * t.element_size()
        out.append(flat[off:off + n].view(_NUMPY_OF[t.dtype])
                   .reshape(t.shape))
        off += part.numel()
    return out
