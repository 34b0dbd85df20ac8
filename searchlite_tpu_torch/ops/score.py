"""Compiled dense query execution in PyTorch: the single-query executor.

The port of ``searchlite_tpu/ops/score.py``. One :class:`CompiledQuery`
is built per query plan; :meth:`CompiledQuery.execute` scores one segment:

1. M [s_pad, n1] from the query's posting blocks
   (:func:`~searchlite_tpu_torch.ops.impact.build_m_from_blocks`, one row
   gather and one unique-index scatter);
2. ``w_leaf @ M`` (leaf scores) and ``leaf_ind @ (M>0)`` / ``group_ind @
   (M>0)`` (leaf and group matches) as f32 matmuls with TF32 off;
3. the boolean matcher, score-expression and custom-scoring trees as
   elementwise tensor ops, the root filter, tombstones, the cursor skip;
4. the match count and a top-k by (score desc, doc asc): ``torch.topk``
   over unique int64 keys (orderable f32 bits high, ``n1-1-doc`` low), so
   ties resolve to the lowest doc ordinal as ``lax.top_k`` does.

M reads the segment's ``block_impacts_live`` (tombstoned docs zeroed),
where the JAX executor reads the raw impacts: a deleted doc then matches
no term, but ``final_mask`` and ``text_mask`` exclude deleted docs in
both, so every output is the same. Zero-score matches (filter-only,
match_all) keep their place: the top-k masks by ``final_mask``, never by
``score > 0``.

The tile executors (:meth:`CompiledQuery.tile_execute`,
:meth:`CompiledQuery.tile_mask_execute`) run the same matcher and score
trees over compacted tile columns (the doc-tile pruned and chunked
routes, ``ops/tiles.py``): M comes from posting runs of the raw flat
impacts, and tombstones from ``deleted_tiles[tiles]``, as in JAX.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from searchlite_tpu_torch.errors import QueryError
from searchlite_tpu_torch.ops.impact import build_m_from_blocks
from searchlite_tpu_torch.query.planner import (
    Matcher,
    QueryPlan,
    ScoreExpr,
    ScoreNode,
)
from searchlite_tpu_torch.query.score_functions import (
    apply_boost_mode_dense,
    combine_functions_dense,
    compile_functions,
    evaluate_function_dense,
)
from searchlite_tpu_torch.query.script import compile_script

class TorchNamespace:
    """The slice of numpy's namespace the dense evaluators of
    ``query/score_functions.py`` and ``query/script.py`` call, over torch
    tensors on one device. Python scalars stay weakly typed, so f32 stays
    f32 (``torch.maximum``/``minimum`` refuse scalars: clamp instead)."""

    float32 = torch.float32
    inf = math.inf

    def __init__(self, device) -> None:
        self.device = torch.device(device)

    @staticmethod
    def maximum(a, b):
        if not isinstance(b, torch.Tensor):
            return torch.clamp(a, min=b)
        if not isinstance(a, torch.Tensor):
            return torch.clamp(b, min=a)
        return torch.maximum(a, b)

    @staticmethod
    def minimum(a, b):
        if not isinstance(b, torch.Tensor):
            return torch.clamp(a, max=b)
        if not isinstance(a, torch.Tensor):
            return torch.clamp(b, max=a)
        return torch.minimum(a, b)

    where = staticmethod(torch.where)
    log = staticmethod(torch.log)
    log1p = staticmethod(torch.log1p)
    log2 = staticmethod(torch.log2)
    sqrt = staticmethod(torch.sqrt)
    abs = staticmethod(torch.abs)
    isfinite = staticmethod(torch.isfinite)
    power = staticmethod(torch.pow)
    ones_like = staticmethod(torch.ones_like)
    full_like = staticmethod(torch.full_like)

    @staticmethod
    def astype(x, dtype):
        return x.to(dtype)

    def ones(self, n, dtype=torch.float32):
        return torch.ones(n, dtype=dtype, device=self.device)

    def zeros(self, n, dtype=torch.float32):
        return torch.zeros(n, dtype=dtype, device=self.device)

    def full(self, n, value, dtype=torch.float32):
        return torch.full((n,), value, dtype=dtype, device=self.device)


def _matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in full f32 (TF32 off for the call)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def topk_by_doc(masked: torch.Tensor, k: int):
    """Top-k along the last axis of an f32 tensor ([n] or [Q, n]) by
    (value desc, index asc), as ``lax.top_k``: ``torch.topk`` promises no
    tie order, so it runs over unique int64 keys -- the value's orderable
    bits high, ``n-1-index`` low. Returns (values [..., k] f32, indices
    [..., k] int32)."""
    n = masked.shape[-1]
    x = masked + 0.0  # -0.0 -> +0.0: equal floats, equal keys
    bits = x.view(torch.int32).to(torch.int64)
    ordered = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)
    doc = torch.arange(n, dtype=torch.int64, device=masked.device)
    keys = ordered * (1 << 32) + (n - 1 - doc)
    top = torch.topk(keys, k, dim=-1, sorted=True).values
    idx = (n - 1) - (top & 0xFFFFFFFF)
    return torch.gather(masked, -1, idx), idx.to(torch.int32)


class CompiledQuery:
    """Plan -> dense executor. Host-side slots are assigned at compile
    time; per-segment filter masks / phrase masks / columns are computed
    by the reader and passed as dense inputs."""

    def __init__(self, plan: QueryPlan, schema, k1: float, b: float):
        self.plan = plan
        self.schema = schema
        self.k1 = float(k1)
        self.b = float(b)
        self.n_groups = len(plan.term_groups)
        self.n_phrases = len(plan.phrase_specs)
        self.n_leaves = max(plan.leaf_count, 1)

        # Filter slots: each matcher bool-node's filter list gets one mask
        # slot; per-function filters get one slot each.
        self.filter_slots: list[Any] = []   # list of Filter-lists or Filter
        self._matcher_filter_slot: dict[int, int] = {}
        self._collect_matcher_slots(plan.matcher)

        self.needs_hook = plan.needs_score_hook()
        self._compiled_nodes: dict[int, dict] = {}
        self.columns: list[str] = []
        if self.needs_hook:
            self._compile_score_node(plan.score_tree)

    # -- compile-time walks ---------------------------------------------------

    def _collect_matcher_slots(self, node: Matcher) -> None:
        if node.kind == "bool":
            filters = node.payload.get("filter", [])
            if filters:
                self._matcher_filter_slot[id(node)] = len(self.filter_slots)
                self.filter_slots.append(list(filters))
            for key in ("must", "should", "must_not"):
                for child in node.payload.get(key, []):
                    self._collect_matcher_slots(child)
        elif node.kind == "dis_max":
            for child in node.payload:
                self._collect_matcher_slots(child)

    def _need_column(self, field: str) -> int:
        if field not in self.columns:
            self.columns.append(field)
        return self.columns.index(field)

    def _compile_score_node(self, node: ScoreNode) -> None:
        info: dict[str, Any] = {}
        if node.kind == "constant":
            self._collect_matcher_slots(node.params["matcher"])
        elif node.kind == "function_score":
            self._collect_matcher_slots(node.params["matcher"])
            compiled = compile_functions(node.params["functions"], self.schema)
            fn_slots = []
            for func in compiled:
                if func.filter is not None:
                    fn_slots.append(len(self.filter_slots))
                    self.filter_slots.append([func.filter])
                else:
                    fn_slots.append(None)
                if func.kind in ("field_value_factor", "decay"):
                    self._need_column(func.params["field"])
            info["functions"] = compiled
            info["fn_slots"] = fn_slots
            self._compile_score_node(node.params["base"])
        elif node.kind == "rank_feature":
            self._collect_matcher_slots(node.params["matcher"])
            field = node.params["field"]
            missing = node.params.get("missing")
            if missing is not None and not math.isfinite(float(missing)):
                raise QueryError("rank_feature `missing` must be finite")
            meta = self.schema.field_meta(field)
            if meta is None or meta.kind != "numeric" or not meta.fast:
                raise QueryError(
                    f"rank_feature field `{field}` must be a numeric fast "
                    "field")
            self._need_column(field)
        elif node.kind == "script_score":
            self._collect_matcher_slots(node.params["matcher"])
            script = compile_script(node.params["script"],
                                    node.params.get("params"), self.schema)
            for field in script.fields:
                self._need_column(field)
            info["script"] = script
            self._compile_score_node(node.params["base"])
        for child in node.children:
            self._compile_score_node(child)
        if info:
            self._compiled_nodes[id(node)] = info

    # -- tensor evaluation ----------------------------------------------------

    def _eval_matcher(self, node: Matcher, ctx: dict):
        if node.kind == "match_all":
            return ctx["ones"]
        if node.kind == "term":
            return ctx["group_match"][node.payload]
        if node.kind == "phrase":
            return ctx["phrase_masks"][node.payload]
        if node.kind == "query_string":
            p = node.payload
            if not p["term_groups"] and not p["phrase_groups"] \
                    and not p["not_term_groups"]:
                return ~ctx["ones"]
            mask = ctx["ones"]
            for idx in p["not_term_groups"]:
                mask = mask & ~ctx["group_match"][idx]
            for idx in p["phrase_groups"]:
                mask = mask & ctx["phrase_masks"][idx]
            if not p["term_groups"]:
                return mask
            counts = None
            for idx in p["term_groups"]:
                row = ctx["group_match"][idx].to(torch.int32)
                counts = row if counts is None else counts + row
            required = p["minimum_should_match"]
            required = 1 if required is None else required
            return mask & (counts >= required)
        if node.kind == "dis_max":
            children = node.payload
            if not children:
                return ~ctx["ones"]
            mask = self._eval_matcher(children[0], ctx)
            for child in children[1:]:
                mask = mask | self._eval_matcher(child, ctx)
            return mask
        if node.kind == "bool":
            p = node.payload
            mask = ctx["ones"]
            for child in p["must"]:
                mask = mask & self._eval_matcher(child, ctx)
            for child in p["must_not"]:
                mask = mask & ~self._eval_matcher(child, ctx)
            slot = self._matcher_filter_slot.get(id(node))
            if slot is not None:
                mask = mask & ctx["filter_masks"][slot]
            should = p["should"]
            if should:
                counts = None
                for child in should:
                    row = self._eval_matcher(child, ctx).to(torch.int32)
                    counts = row if counts is None else counts + row
                min_should = p["minimum_should_match"]
                if min_should is None:
                    min_should = (1 if not p["must"] and not p["filter"]
                                  else 0)
                mask = mask & (counts >= min_should)
            elif p["minimum_should_match"] not in (None, 0):
                # explicit minimum_should_match with no should clauses can
                # never be satisfied (reference: 0 >= min_should)
                mask = mask & ~ctx["ones"]
            return mask
        raise QueryError(f"unknown matcher kind `{node.kind}`")

    def _eval_score_expr(self, expr: ScoreExpr, leaf_scores):
        if expr.kind == "leaf":
            return leaf_scores[expr.leaf]
        child_vals = [self._eval_score_expr(c, leaf_scores)
                      for c in expr.children]
        if expr.kind == "sum":
            acc = child_vals[0]
            for v in child_vals[1:]:
                acc = acc + v
            return acc
        # dis_max
        if not child_vals:
            return torch.zeros_like(leaf_scores[0])
        mx = child_vals[0]
        sm = child_vals[0]
        for v in child_vals[1:]:
            mx = torch.maximum(mx, v)
            sm = sm + v
        return mx + expr.tie_breaker * (sm - mx)

    def _eval_score_node(self, node: ScoreNode, ctx: dict):
        """Returns (score [N1], present [N1]) -- present=False means the
        doc's score is dropped (reference `None`)."""
        ones_f = ctx["zeros"] + 1.0
        true_mask = ctx["ones"]
        if node.kind == "empty":
            return ones_f, true_mask
        if node.kind == "expr":
            return (self._eval_score_expr(node.expr, ctx["leaf_scores"]),
                    true_mask)
        if node.kind == "sum":
            total = ctx["zeros"]
            any_present = ~true_mask if node.children else true_mask
            for child in node.children:
                v, p = self._eval_score_node(child, ctx)
                total = total + torch.where(p, v, 0.0)
                any_present = any_present | p
            return total, any_present
        if node.kind == "dis_max":
            if not node.children:
                return ctx["zeros"], true_mask
            mx = torch.full_like(ctx["zeros"], -math.inf)
            sm = ctx["zeros"]
            any_present = ~true_mask
            for child in node.children:
                v, p = self._eval_score_node(child, ctx)
                mx = torch.maximum(mx, torch.where(p, v, -math.inf))
                sm = sm + torch.where(p, v, 0.0)
                any_present = any_present | p
            score = mx + node.tie_breaker * (sm - mx)
            return torch.where(any_present, score, 0.0), any_present
        if node.kind == "constant":
            matched = self._eval_matcher(node.params["matcher"], ctx)
            return (torch.where(matched, float(node.params["score"]), 0.0)
                    .to(torch.float32), true_mask)
        if node.kind == "function_score":
            return self._eval_function_score(node, ctx)
        if node.kind == "rank_feature":
            return self._eval_rank_feature(node, ctx)
        if node.kind == "script_score":
            return self._eval_script_score(node, ctx)
        raise QueryError(f"unknown score node `{node.kind}`")

    def _column_ctx(self, ctx: dict, field: str):
        idx = self.columns.index(field)
        return ctx["col_vals"][idx], ctx["col_has"][idx]

    def _eval_function_score(self, node: ScoreNode, ctx: dict):
        xp = ctx["xp"]
        p = node.params
        info = self._compiled_nodes[id(node)]
        matched = self._eval_matcher(p["matcher"], ctx)
        base, base_present = self._eval_score_node(p["base"], ctx)
        n = base.shape[0]
        columns = {f: self._column_ctx(ctx, f) for f in self.columns}
        values, presents = [], []
        for func, slot in zip(info["functions"], info["fn_slots"]):
            fmask = (ctx["filter_masks"][slot] if slot is not None
                     else ctx["ones"])
            v, pr = evaluate_function_dense(xp, func, columns, fmask, n)
            values.append(v)
            presents.append(pr)
        combined_fn, any_fn = combine_functions_dense(
            xp, values, presents, p["score_mode"], n)
        eps = float(np.finfo(np.float32).eps)
        effective_base = torch.where(
            (torch.abs(base) <= eps) & any_fn, 1.0, base)
        combined = torch.where(
            any_fn,
            apply_boost_mode_dense(xp, effective_base, combined_fn,
                                   p["boost_mode"]),
            effective_base)
        if p.get("max_boost") is not None:
            combined = torch.clamp(combined, max=float(p["max_boost"]))
        present = base_present
        if p.get("min_score") is not None:
            present = present & (combined >= float(p["min_score"]))
        combined = combined * float(p["boost"])
        # unmatched docs score 0.0 (still present)
        score = torch.where(matched, combined, 0.0)
        present = present | ~matched
        return score, present

    def _eval_rank_feature(self, node: ScoreNode, ctx: dict):
        p = node.params
        matched = self._eval_matcher(p["matcher"], ctx)
        vals, has = self._column_ctx(ctx, p["field"])
        missing = float(p.get("missing") or 0.0)
        raw = torch.where(has, vals, missing)
        modifier = p.get("modifier") or "none"
        if modifier == "none":
            modified = raw
        elif modifier == "log":
            modified = torch.where(raw <= 0.0, 0.0,
                                   torch.log(torch.clamp(raw, min=1e-30)))
        elif modifier == "log1p":
            modified = torch.where(
                raw <= -1.0, 0.0,
                torch.log1p(torch.clamp(raw, min=-1.0 + 1e-30)))
        elif modifier == "sqrt":
            modified = torch.where(raw < 0.0, 0.0,
                                   torch.sqrt(torch.clamp(raw, min=0.0)))
        elif modifier == "reciprocal":
            modified = torch.where(raw == 0.0, 0.0,
                                   1.0 / torch.where(raw == 0.0, 1.0, raw))
        else:
            raise QueryError(f"unknown rank_feature modifier `{modifier}`")
        score = modified * float(p["boost"])
        present = torch.isfinite(score) | ~matched
        return torch.where(matched, score, 0.0), present

    def _eval_script_score(self, node: ScoreNode, ctx: dict):
        p = node.params
        info = self._compiled_nodes[id(node)]
        matched = self._eval_matcher(p["matcher"], ctx)
        base, base_present = self._eval_score_node(p["base"], ctx)
        columns = {f: self._column_ctx(ctx, f) for f in self.columns}
        value, present = info["script"].evaluate_dense(ctx["xp"], base,
                                                       columns)
        score = value * float(p["boost"])
        present = (present & base_present & torch.isfinite(score)) \
            | ~matched
        return torch.where(matched, score, 0.0), present

    # -- the executor -------------------------------------------------------------

    def _core(self, m, deleted, w_leaf, leaf_ind, group_ind,
              phrase_masks, filter_masks, col_vals, col_has, root_mask,
              has_scored_terms: bool, need_scores: bool):
        """Leaf scoring off a densified M, matcher/score tree evaluation,
        final mask. Returns (final_mask, adjusted, matcher_mask)."""
        n1 = deleted.shape[0]
        dev = deleted.device
        ones = torch.ones(n1, dtype=torch.bool, device=dev)
        zeros = torch.zeros(n1, dtype=torch.float32, device=dev)

        m_pos = (m > 0).to(torch.float32)
        leaf_scores = _matmul_f32(w_leaf, m)
        leaf_match = _matmul_f32(leaf_ind, m_pos) > 0
        group_match = _matmul_f32(group_ind, m_pos) > 0

        ctx = {
            "xp": TorchNamespace(dev),
            "ones": ones,
            "zeros": zeros,
            "leaf_scores": leaf_scores,
            "group_match": group_match,
            "phrase_masks": phrase_masks,
            "filter_masks": filter_masks,
            "col_vals": col_vals,
            "col_has": col_has,
        }

        matcher_mask = self._eval_matcher(self.plan.matcher, ctx)
        if has_scored_terms:
            candidates = leaf_match.any(dim=0)
        else:
            candidates = ones
        if need_scores and self.plan.scorer is not None:
            base_score = self._eval_score_expr(self.plan.scorer,
                                               leaf_scores)
        else:
            base_score = zeros
        if need_scores and self.needs_hook:
            adjusted, present = self._eval_score_node(self.plan.score_tree,
                                                      ctx)
        else:
            adjusted, present = base_score, ones

        final_mask = candidates & matcher_mask & root_mask \
            & ~deleted & present
        return final_mask, adjusted, matcher_mask

    def execute(self, block_docs, block_impacts, deleted, blk_idx, slot_row,
                w_leaf, leaf_ind, group_ind, phrase_masks, filter_masks,
                col_vals, col_has, root_mask, cursor_score: float,
                cursor_eq_mode: int, cursor_doc: int, *, k: int, s_pad: int,
                has_scored_terms: bool, need_scores: bool,
                use_cursor: bool):
        """One segment through the dense executor (the JAX ``executor()``
        run). Every tensor is on the segment's device. ``cursor_eq_mode``:
        0 = exclude every equal-score doc (a segment before the cursor's),
        1 = exclude docs <= ``cursor_doc`` (the cursor's segment), 2 = keep
        them (a later segment). Returns (top_scores [k] f32, top_idx [k]
        int32, match_count [] int64, final_mask [n1] bool, adjusted [n1]
        f32, cursor_seen [] bool, text_mask [n1] bool)."""
        n1 = deleted.shape[0]
        dev = deleted.device
        m = build_m_from_blocks(block_docs, block_impacts, blk_idx,
                                slot_row, n1, s_pad)
        final_mask, adjusted, matcher_mask = self._core(
            m, deleted, w_leaf, leaf_ind, group_ind, phrase_masks,
            filter_masks, col_vals, col_has, root_mask, has_scored_terms,
            need_scores)
        adjusted = adjusted.to(torch.float32)

        cursor_seen = torch.zeros((), dtype=torch.bool, device=dev)
        if use_cursor:
            doc_iota = torch.arange(n1, dtype=torch.int32, device=dev)
            if cursor_eq_mode == 0:
                eq_keep = torch.zeros(n1, dtype=torch.bool, device=dev)
            elif cursor_eq_mode == 1:
                eq_keep = doc_iota > cursor_doc
            else:
                eq_keep = torch.ones(n1, dtype=torch.bool, device=dev)
            if cursor_eq_mode == 1:
                cursor_seen = (final_mask[cursor_doc]
                               & (adjusted[cursor_doc] == cursor_score))
            # score-desc order: "after cursor" = lower score, or equal
            # score with later (segment, doc)
            after = (adjusted < cursor_score) | (
                (adjusted == cursor_score) & eq_keep)
            final_mask = final_mask & after

        match_count = final_mask.sum()
        masked = torch.where(final_mask, adjusted, -math.inf)
        top_scores, top_idx = topk_by_doc(masked, k)
        # matcher-only mask (for vector-candidate text matching)
        text_mask = matcher_mask & ~deleted
        return (top_scores, top_idx, match_count, final_mask, adjusted,
                cursor_seen, text_mask)

    # -- the tile executors (ops/tiles.py) --------------------------------------

    def _tile_core(self, docs_flat, impacts_flat, deleted_tiles, tiles, runs,
                   w_leaf, leaf_ind, group_ind, phrase_masks, filter_masks,
                   col_vals, col_has, root_mask, *, s_pad: int, n_cols: int,
                   n_post: int, has_scored_terms: bool, need_scores: bool,
                   fmt: int):
        """M from posting runs restricted to the selected tiles, the
        tile-space deleted mask from the resident padded copy, then
        :meth:`_core`. Every doc-axis input is already gathered to tile
        space by the host. Returns (final_mask, adjusted, matcher_mask,
        deleted_cols)."""
        # ops/tiles.py imports this module's matmul and top-k
        from searchlite_tpu_torch.ops.tiles import (
            build_m_from_runs,
            unpack_runs,
        )

        run_start, run_len, run_slot, run_off = unpack_runs(runs, fmt)
        m = build_m_from_runs(docs_flat, impacts_flat, run_start, run_len,
                              run_slot, run_off, n_cols, s_pad, n_post)
        deleted_cols = deleted_tiles[tiles.long()].reshape(-1)
        final_mask, adjusted, matcher_mask = self._core(
            m, deleted_cols, w_leaf, leaf_ind, group_ind, phrase_masks,
            filter_masks, col_vals, col_has, root_mask, has_scored_terms,
            need_scores)
        return (final_mask, adjusted.to(torch.float32), matcher_mask,
                deleted_cols)

    def tile_execute(self, *args, k: int, **kw):
        """The executor over compacted tile columns (the doc-tile pruned
        path; the JAX ``tile_executor()`` run). Returns (top_scores [k]
        f32, top_idx [k] int32 compacted columns, match_count [] int64)."""
        final_mask, adjusted, _matcher, _deleted = self._tile_core(*args,
                                                                   **kw)
        match_count = final_mask.sum()
        masked = torch.where(final_mask, adjusted, -math.inf)
        top_scores, top_idx = topk_by_doc(masked, k)
        return top_scores, top_idx, match_count

    def tile_mask_execute(self, *args, **kw):
        """Chunked full-width execution (the JAX ``tile_mask_executor()``
        run): the tile-column core, returning the dense per-column outputs
        (final_mask, adjusted, text_mask) for the host to stitch back into
        doc space."""
        final_mask, adjusted, matcher_mask, deleted_cols = self._tile_core(
            *args, **kw)
        return final_mask, adjusted, matcher_mask & ~deleted_cols
