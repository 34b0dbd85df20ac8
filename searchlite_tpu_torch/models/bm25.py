"""BM25 scoring model.

Formula parity with searchlite-core `query/bm25.rs:1-6`:

    idf   = ln((N - df + 0.5) / (df + 0.5)).max(0) + 1
    norm  = doc_len / avgdl   (1 when avgdl == 0)
    score = idf * tf * (k1 + 1) / max(tf + k1 * (1 - b + b * norm), 1e-6)

Defaults k1=0.9, b=0.4 set by the surfaces (`searchlite-cli/src/main.rs:
196-197`). The scalar form is the reference/oracle; the batched form in
``ops/score.py`` runs the same arithmetic in f32 over whole blocks.
"""

from __future__ import annotations

import math

import numpy as np

DEFAULT_K1 = 0.9
DEFAULT_B = 0.4


def idf(df: float, docs: float) -> float:
    ratio = (docs - df + 0.5) / (df + 0.5)
    if ratio <= 0.0:
        # degenerate segment (e.g. every doc tombstoned): the reference
        # computes ln(<=0) = NaN and Rust's f64::max(NaN, 0.0) -> 0.0,
        # so idf collapses to 1.0 (`query/bm25.rs:1-6`)
        return 1.0
    return max(math.log(ratio), 0.0) + 1.0


def bm25(tf: float, df: float, doc_len: float, avgdl: float, docs: float,
         k1: float, b: float) -> float:
    idf_val = idf(df, docs)
    norm_dl = doc_len / avgdl if avgdl > 0.0 else 1.0
    denom = tf + k1 * (1.0 - b + b * norm_dl)
    return idf_val * (tf * (k1 + 1.0)) / max(denom, 1e-6)


def bm25_np(tfs: np.ndarray, idf_weight: float, doc_lens: np.ndarray,
            avgdl: float, k1: float, b: float) -> np.ndarray:
    """Vectorized BM25 with the idf (and any boost) folded into a single
    multiplicative weight, matching the device kernel's factoring."""
    tfs = tfs.astype(np.float32)
    norm = (doc_lens.astype(np.float32) / np.float32(avgdl)
            if avgdl > 0 else np.ones_like(tfs))
    denom = np.maximum(tfs + np.float32(k1) * (1.0 - b + b * norm),
                       np.float32(1e-6))
    return np.float32(idf_weight) * tfs * np.float32(k1 + 1.0) / denom
