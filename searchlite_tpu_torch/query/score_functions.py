"""function_score compilation + dense evaluation.

Semantics parity with searchlite-core `query/score_functions.rs`:
weight / field_value_factor (modifiers none, log, log1p, log2p, sqrt,
reciprocal) / decay (exp, gauss, linear) with optional per-function
filters; combine modes sum/multiply/max/min/avg; boost modes
multiply/sum/replace/max/min.

Evaluation is dense over ``[n_docs]`` arrays with a presence mask per
function (filter misses and missing decay values exclude a function
from the combine, mirroring `Option::None` in the reference).

``xp`` is numpy (the explain path) or the torch namespace of
``searchlite_tpu_torch/ops/score.py`` (the dense executor).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional

from searchlite_tpu_torch.api.types import Filter, FunctionSpec
from searchlite_tpu_torch.errors import QueryError


def _astype(xp, x, dtype):
    """``x.astype(dtype)`` in either namespace (torch tensors have no
    ``astype``; the torch namespace supplies one)."""
    fn = getattr(xp, "astype", None)
    return fn(x, dtype) if fn is not None else x.astype(dtype)


def ensure_numeric_fast(schema, field: str, context: str) -> None:
    meta = schema.field_meta(field)
    if meta is None or meta.kind != "numeric" or not meta.fast:
        raise QueryError(
            f"{context} field `{field}` must be a numeric fast field")


@dataclass
class CompiledFunction:
    kind: str  # "weight" | "field_value_factor" | "decay"
    params: dict[str, Any]
    filter: Optional[Filter]


def compile_functions(functions: list[FunctionSpec], schema
                      ) -> list[CompiledFunction]:
    compiled = []
    for func in functions:
        p = func.params
        filt = p.get("filter")
        if func.kind == "weight":
            weight = float(p["weight"])
            if not math.isfinite(weight):
                raise QueryError("weight must be finite")
            compiled.append(CompiledFunction(
                "weight", {"weight": weight}, filt))
        elif func.kind == "field_value_factor":
            factor = float(p.get("factor", 1.0))
            if not math.isfinite(factor):
                raise QueryError("field_value_factor `factor` must be finite")
            ensure_numeric_fast(schema, p["field"], "function_score")
            compiled.append(CompiledFunction("field_value_factor", {
                "field": p["field"],
                "factor": factor,
                "modifier": p.get("modifier") or "none",
                "missing": float(p.get("missing", 0.0)
                                 if p.get("missing") is not None else 0.0),
            }, filt))
        elif func.kind == "decay":
            scale = float(p["scale"])
            if not math.isfinite(scale):
                raise QueryError("decay scale must be finite")
            if scale <= 0.0:
                raise QueryError("decay scale must be > 0")
            decay = float(p.get("decay", 0.5) if p.get("decay") is not None
                          else 0.5)
            if decay <= 0.0 or decay > 1.0:
                raise QueryError("decay factor must be in the range (0, 1]")
            ensure_numeric_fast(schema, p["field"], "function_score")
            compiled.append(CompiledFunction("decay", {
                "field": p["field"],
                "origin": float(p["origin"]),
                "scale": scale,
                "offset": float(p.get("offset", 0.0)
                                if p.get("offset") is not None else 0.0),
                "decay": decay,
                "function": p.get("function") or "exp",
            }, filt))
        else:
            raise QueryError(f"unknown function spec `{func.kind}`")
    return compiled


def apply_modifier_dense(xp, value, modifier: str):
    if modifier == "none":
        return value
    if modifier == "log":
        return xp.where(value <= 0.0, 0.0, xp.log(xp.maximum(value, 1e-30)))
    if modifier == "log1p":
        return xp.where(value <= -1.0, 0.0, xp.log1p(xp.maximum(value, -1.0 + 1e-30)))
    if modifier == "log2p":
        return xp.where(
            value <= -1.0, 0.0,
            xp.log2(xp.maximum(value + 1.0, 1e-30)))
    if modifier == "sqrt":
        return xp.where(value < 0.0, 0.0, xp.sqrt(xp.maximum(value, 0.0)))
    if modifier == "reciprocal":
        return xp.where(value == 0.0, 0.0,
                        1.0 / xp.where(value == 0.0, 1.0, value))
    raise QueryError(f"unknown field_value_factor modifier `{modifier}`")


def decay_dense(xp, decay: float, norm, function: str):
    if function == "exp":
        return xp.power(decay, norm)
    if function == "gauss":
        return xp.power(decay, norm * norm)
    if function == "linear":
        return xp.maximum((1.0 - norm) * (1.0 - decay) + decay, 0.0)
    raise QueryError(f"unknown decay function `{function}`")


def evaluate_function_dense(xp, func: CompiledFunction, columns: dict,
                            filter_mask, n):
    """Returns (value [n], present [n]).

    columns: field -> (values [n] float, present [n] bool); filter_mask is
    the dense mask of the function's filter (all-True when no filter).
    """
    ones = xp.ones(n, dtype=xp.float32)
    if func.kind == "weight":
        value = ones * func.params["weight"]
        return value, filter_mask
    if func.kind == "field_value_factor":
        vals, has = columns[func.params["field"]]
        raw = xp.where(has, vals, func.params["missing"])
        scaled = raw * func.params["factor"]
        modified = apply_modifier_dense(xp, scaled, func.params["modifier"])
        present = filter_mask & xp.isfinite(scaled) & xp.isfinite(modified)
        return _astype(xp, modified, xp.float32), present
    if func.kind == "decay":
        vals, has = columns[func.params["field"]]
        distance = xp.abs(vals - func.params["origin"]) - func.params["offset"]
        norm = xp.maximum(distance, 0.0) / func.params["scale"]
        score = decay_dense(xp, func.params["decay"], norm,
                            func.params["function"])
        present = filter_mask & has & xp.isfinite(score)
        return _astype(xp, score, xp.float32), present
    raise QueryError(f"unknown function kind `{func.kind}`")


def combine_functions_dense(xp, values: list, presents: list, mode: str, n):
    """Returns (combined [n], any_present [n])."""
    if not values:
        zeros = xp.zeros(n, dtype=xp.float32)
        return zeros, xp.zeros(n, dtype=bool)
    any_present = presents[0]
    for p in presents[1:]:
        any_present = any_present | p
    if mode == "sum":
        acc = xp.zeros(n, dtype=xp.float32)
        for v, p in zip(values, presents):
            acc = acc + xp.where(p, v, 0.0)
        return acc, any_present
    if mode == "multiply":
        acc = xp.ones(n, dtype=xp.float32)
        for v, p in zip(values, presents):
            acc = acc * xp.where(p, v, 1.0)
        return acc, any_present
    if mode == "max":
        acc = xp.full(n, -xp.inf, dtype=xp.float32)
        for v, p in zip(values, presents):
            acc = xp.maximum(acc, xp.where(p, v, -xp.inf))
        return acc, any_present
    if mode == "min":
        acc = xp.full(n, xp.inf, dtype=xp.float32)
        for v, p in zip(values, presents):
            acc = xp.minimum(acc, xp.where(p, v, xp.inf))
        return acc, any_present
    if mode == "avg":
        acc = xp.zeros(n, dtype=xp.float32)
        count = xp.zeros(n, dtype=xp.float32)
        for v, p in zip(values, presents):
            acc = acc + xp.where(p, v, 0.0)
            count = count + _astype(xp, p, xp.float32)
        return acc / xp.maximum(count, 1.0), any_present
    raise QueryError(f"unknown function score_mode `{mode}`")


def apply_boost_mode_dense(xp, base, func_score, mode: str):
    if mode == "multiply":
        return base * func_score
    if mode == "sum":
        return base + func_score
    if mode == "replace":
        return func_score
    if mode == "max":
        return xp.maximum(base, func_score)
    if mode == "min":
        return xp.minimum(base, func_score)
    raise QueryError(f"unknown function boost_mode `{mode}`")
