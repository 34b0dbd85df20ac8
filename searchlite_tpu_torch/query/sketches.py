"""Bounded-memory aggregation sketches (host, numpy-vectorized).

Parity targets the reference's bounded collectors:

- percentiles / percentile_ranks keep an exact value window and spill
  into a t-digest beyond it (``query/aggs/mod.rs:466-596``,
  ``QuantileState``: PERCENTILE_EXACT_LIMIT=256 exact values,
  TDIGEST_MAX_SIZE=200 centroids). Our exact window is larger (4096,
  ``SEARCHLITE_PCTL_EXACT``) — still O(1) per bucket, strictly more
  accurate; divergence D12 in COMPONENTS.md.
- cardinality hashes every value to u64 (``query/aggs/mod.rs:3370-
  3374``) and keeps a set with a ``precision_threshold`` knob
  (``:1478-1561``, ``:2278-2285``). The reference never actually
  bounds the set; we do: above the threshold the exact hash set folds
  into a HyperLogLog register sketch, so memory is O(threshold + 2^p)
  per bucket no matter how many distinct values stream in.

Both sketches are built for BATCH ingestion: values arrive as numpy
arrays straight out of the columnar fast fields (one vectorized ragged
gather per segment — ``aggs.py::_matched_value_selection``), never one
Python object at a time.
"""

from __future__ import annotations

import hashlib
import math
import os

import numpy as np

# exact window before a percentiles state folds into the digest
PCTL_EXACT_LIMIT = int(os.environ.get("SEARCHLITE_PCTL_EXACT", "4096"))
# t-digest compression (max centroids) — matches the reference's
# TDIGEST_MAX_SIZE (aggs/mod.rs:44)
TDIGEST_COMPRESSION = 200
# cardinality: default/max precision_threshold (ES-compatible choices;
# the reference leaves the default unbounded — we bound it)
CARDINALITY_DEFAULT_THRESHOLD = 3000
CARDINALITY_MAX_THRESHOLD = 40_000
_HLL_P = 14  # 16384 registers, ~0.8% standard error


# ---------------------------------------------------------------------------
# t-digest (merging variant, vectorized)
# ---------------------------------------------------------------------------

class TDigest:
    """Merging t-digest over numpy centroid arrays.

    Compression assigns each sorted centroid to a k-scale cluster index
    (k1 scale, Dunning & Ertl) and segment-sums means/weights — one
    vectorized pass, no per-centroid Python loop, bounded at roughly
    ``compression`` centroids.
    """

    __slots__ = ("means", "weights", "vmin", "vmax", "compression")

    def __init__(self, compression: int = TDIGEST_COMPRESSION):
        self.means = np.zeros(0, dtype=np.float64)
        self.weights = np.zeros(0, dtype=np.float64)
        self.vmin = math.inf
        self.vmax = -math.inf
        self.compression = int(compression)

    @property
    def count(self) -> float:
        return float(self.weights.sum())

    def add_values(self, values: np.ndarray) -> None:
        values = np.asarray(values, dtype=np.float64)
        if values.size == 0:
            return
        self.vmin = min(self.vmin, float(values.min()))
        self.vmax = max(self.vmax, float(values.max()))
        self._compress(np.concatenate([self.means, values]),
                       np.concatenate([self.weights,
                                       np.ones(values.size)]))

    def merge(self, other: "TDigest") -> None:
        if other.weights.size == 0:
            return
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)
        self._compress(np.concatenate([self.means, other.means]),
                       np.concatenate([self.weights, other.weights]))

    def _compress(self, means: np.ndarray, weights: np.ndarray) -> None:
        order = np.argsort(means, kind="stable")
        means = means[order]
        weights = weights[order]
        total = weights.sum()
        if total <= 0:
            self.means = means[:0]
            self.weights = weights[:0]
            return
        # mid-point quantile of each centroid
        cum = np.cumsum(weights)
        q = (cum - 0.5 * weights) / total
        # k1 scale: k(q) = (delta / 2pi) * asin(2q - 1); centroids
        # sharing a k-cell merge. Cell count <= delta + 1.
        delta = float(self.compression)
        k = (delta / (2.0 * math.pi)) * np.arcsin(
            np.clip(2.0 * q - 1.0, -1.0, 1.0))
        cell = np.floor(k).astype(np.int64)
        # segment boundaries where the cell index changes
        new_seg = np.empty(len(cell), dtype=bool)
        new_seg[0] = True
        np.not_equal(cell[1:], cell[:-1], out=new_seg[1:])
        seg_id = np.cumsum(new_seg) - 1
        n_seg = int(seg_id[-1]) + 1
        w = np.bincount(seg_id, weights=weights, minlength=n_seg)
        m = np.bincount(seg_id, weights=weights * means,
                        minlength=n_seg) / w
        self.means = m
        self.weights = w

    def quantile(self, q: float) -> float:
        if self.weights.size == 0:
            return 0.0
        q = min(max(q, 0.0), 1.0)
        total = self.weights.sum()
        target = q * total
        cum = np.cumsum(self.weights)
        # centroid mid-point positions
        mids = cum - 0.5 * self.weights
        if target <= mids[0]:
            # interpolate from the exact minimum
            if mids[0] <= 0:
                return float(self.means[0])
            t = target / mids[0]
            return float(self.vmin + t * (self.means[0] - self.vmin))
        if target >= mids[-1]:
            span = total - mids[-1]
            if span <= 0:
                return float(self.means[-1])
            t = (target - mids[-1]) / span
            return float(self.means[-1] + t * (self.vmax - self.means[-1]))
        hi = int(np.searchsorted(mids, target, side="left"))
        lo = hi - 1
        span = mids[hi] - mids[lo]
        t = (target - mids[lo]) / span if span > 0 else 0.0
        return float(self.means[lo] + t * (self.means[hi] - self.means[lo]))

    def cdf(self, x: float) -> float:
        """Fraction of mass <= x (the percentile_ranks primitive)."""
        if self.weights.size == 0:
            return 0.0
        if x < self.vmin:
            return 0.0
        if x >= self.vmax:
            return 1.0
        total = self.weights.sum()
        cum = np.cumsum(self.weights)
        mids = cum - 0.5 * self.weights
        if x < self.means[0]:
            span = self.means[0] - self.vmin
            t = (x - self.vmin) / span if span > 0 else 1.0
            return float(t * mids[0] / total)
        if x >= self.means[-1]:
            span = self.vmax - self.means[-1]
            t = (x - self.means[-1]) / span if span > 0 else 1.0
            return float((mids[-1] + t * (total - mids[-1])) / total)
        hi = int(np.searchsorted(self.means, x, side="right"))
        hi = min(hi, len(self.means) - 1)
        lo = hi - 1
        span = self.means[hi] - self.means[lo]
        t = (x - self.means[lo]) / span if span > 0 else 0.0
        return float((mids[lo] + t * (mids[hi] - mids[lo])) / total)


# ---------------------------------------------------------------------------
# Quantile state: exact window -> t-digest (QuantileState parity)
# ---------------------------------------------------------------------------

class QuantileState:
    """Exact value buffer up to ``PCTL_EXACT_LIMIT``, then a t-digest.

    Mirrors the reference's ``QuantileState`` push/merge/percentile
    contract (``aggs/mod.rs:466-596``): exact linear-interpolated
    percentiles while small, digest estimates beyond.
    """

    __slots__ = ("chunks", "n_exact", "digest", "count")

    def __init__(self):
        self.chunks: list[np.ndarray] = []
        self.n_exact = 0
        self.digest: TDigest | None = None
        self.count = 0

    def push_values(self, values: np.ndarray) -> None:
        values = np.asarray(values, dtype=np.float64)
        if values.size == 0:
            return
        self.count += int(values.size)
        if self.digest is None and \
                self.n_exact + values.size <= PCTL_EXACT_LIMIT:
            self.chunks.append(values)
            self.n_exact += int(values.size)
            return
        self._ensure_digest()
        self.digest.add_values(values)

    def _ensure_digest(self) -> None:
        if self.digest is None:
            self.digest = TDigest()
        if self.chunks:
            self.digest.add_values(np.concatenate(self.chunks))
            self.chunks = []
            self.n_exact = 0

    def merge(self, other: "QuantileState") -> None:
        self.count += other.count
        if self.digest is None and other.digest is None and \
                self.n_exact + other.n_exact <= PCTL_EXACT_LIMIT:
            self.chunks.extend(other.chunks)
            self.n_exact += other.n_exact
            return
        self._ensure_digest()
        if other.chunks:
            self.digest.add_values(np.concatenate(other.chunks))
        if other.digest is not None:
            self.digest.merge(other.digest)

    def _exact_sorted(self) -> np.ndarray:
        if not self.chunks:
            return np.zeros(0, dtype=np.float64)
        return np.sort(np.concatenate(self.chunks))

    def percentile(self, pct: float) -> float:
        if self.count == 0:
            return 0.0
        if self.digest is None:
            vals = self._exact_sorted()
            n = len(vals)
            if n == 1:
                return float(vals[0])
            rank = max((min(max(pct, 0.0), 100.0) / 100.0) * (n - 1), 0.0)
            lo = int(math.floor(rank))
            hi = int(math.ceil(rank))
            if lo == hi:
                return float(vals[lo])
            w = rank - lo
            return float(vals[lo] * (1 - w) + vals[hi] * w)
        return self.digest.quantile(min(max(pct, 0.0), 100.0) / 100.0)

    def percentile_rank(self, target: float) -> float:
        if self.count == 0:
            return 0.0
        if self.digest is None:
            vals = self._exact_sorted()
            return float((vals <= target).sum()) / max(len(vals), 1) * 100.0
        return self.digest.cdf(target) * 100.0

    @property
    def is_exact(self) -> bool:
        return self.digest is None


# ---------------------------------------------------------------------------
# Vectorized 64-bit value hashing (cardinality)
# ---------------------------------------------------------------------------

_SPLITMIX_GAMMA = np.uint64(0x9E3779B97F4A7C15)


def mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer over a uint64 array (vectorized)."""
    x = np.asarray(x).astype(np.uint64, copy=True)
    with np.errstate(over="ignore"):
        x += _SPLITMIX_GAMMA
        x ^= x >> np.uint64(30)
        x *= np.uint64(0xBF58476D1CE4E5B9)
        x ^= x >> np.uint64(27)
        x *= np.uint64(0x94D049BB133111EB)
        x ^= x >> np.uint64(31)
    return x


def hash_i64(values: np.ndarray) -> np.ndarray:
    return mix64(np.asarray(values, dtype=np.int64).view(np.uint64))


def hash_f64(values: np.ndarray) -> np.ndarray:
    # hash the bit pattern, like the reference's v.to_bits()
    # (aggs/mod.rs:1549); normalize -0.0 so it hashes like +0.0
    v = np.asarray(values, dtype=np.float64)
    v = np.where(v == 0.0, 0.0, v)
    return mix64(v.view(np.uint64))


def hash_str(value: str) -> int:
    """Stable 64-bit hash of one string (dictionary entries are hashed
    once per segment and gathered by code, never per doc)."""
    return int.from_bytes(
        hashlib.blake2b(value.encode("utf-8"), digest_size=8).digest(),
        "little")


def hash_str_dict(dictionary: list[str]) -> np.ndarray:
    return np.asarray([hash_str(s) for s in dictionary], dtype=np.uint64)


# ---------------------------------------------------------------------------
# HyperLogLog (dense registers)
# ---------------------------------------------------------------------------

class HllSketch:
    """Dense HLL over 2^p uint8 registers with vectorized batch adds."""

    __slots__ = ("p", "registers")

    def __init__(self, p: int = _HLL_P):
        self.p = int(p)
        self.registers = np.zeros(1 << self.p, dtype=np.uint8)

    def add_hashes(self, hashes: np.ndarray) -> None:
        if len(hashes) == 0:
            return
        h = np.asarray(hashes, dtype=np.uint64)
        idx = (h >> np.uint64(64 - self.p)).astype(np.int64)
        rest = h & np.uint64((1 << (64 - self.p)) - 1)
        # rho = leading zeros of the (64-p)-bit suffix + 1. The suffix
        # is < 2^50 for p=14, so its MSB position is exact in float64.
        width = 64 - self.p
        msb = np.full(len(h), -1, dtype=np.int64)
        nz = rest > 0
        if nz.any():
            msb[nz] = np.floor(np.log2(rest[nz].astype(np.float64))
                               ).astype(np.int64)
            # guard float rounding at power-of-two boundaries (either
            # direction: log2(2^k) may land a hair above or below k)
            pow_msb = np.uint64(1) << np.clip(msb, 0, 63).astype(np.uint64)
            too_big = nz & (pow_msb > rest)
            msb[too_big] -= 1
            too_small = nz & ~too_big & ((pow_msb << np.uint64(1)) <= rest)
            msb[too_small] += 1
        rho = (width - msb).astype(np.int64)  # rest==0 -> width + 1
        np.maximum.at(self.registers, idx, np.clip(rho, 0, 255)
                      .astype(np.uint8))

    def merge(self, other: "HllSketch") -> None:
        np.maximum(self.registers, other.registers, out=self.registers)

    def estimate(self) -> int:
        m = float(len(self.registers))
        alpha = 0.7213 / (1.0 + 1.079 / m)
        inv = np.ldexp(1.0, -self.registers.astype(np.int64))
        raw = alpha * m * m / inv.sum()
        zeros = int((self.registers == 0).sum())
        if raw <= 2.5 * m and zeros:
            return int(round(m * math.log(m / zeros)))
        return int(round(raw))


# ---------------------------------------------------------------------------
# Cardinality state: exact hash set -> HLL above precision_threshold
# ---------------------------------------------------------------------------

class CardinalityState:
    """Exact distinct-hash set below the precision threshold, HLL
    beyond — counts up to the threshold are exact (modulo 64-bit hash
    collisions), larger counts are ~0.8% estimates in O(16KB)."""

    __slots__ = ("hashes", "sketch", "threshold")

    def __init__(self, precision_threshold=None):
        if precision_threshold is None:
            t = CARDINALITY_DEFAULT_THRESHOLD
        else:
            t = min(max(int(precision_threshold), 1),
                    CARDINALITY_MAX_THRESHOLD)
        self.threshold = t
        self.hashes: np.ndarray | None = np.zeros(0, dtype=np.uint64)
        self.sketch: HllSketch | None = None

    def add_hashes(self, hashes: np.ndarray) -> None:
        hashes = np.asarray(hashes, dtype=np.uint64)
        if hashes.size == 0:
            return
        if self.sketch is not None:
            self.sketch.add_hashes(hashes)
            return
        self.hashes = np.union1d(self.hashes, hashes)
        if len(self.hashes) > self.threshold:
            self._to_sketch()

    def _to_sketch(self) -> None:
        self.sketch = HllSketch()
        self.sketch.add_hashes(self.hashes)
        self.hashes = None

    def merge(self, other: "CardinalityState") -> None:
        self.threshold = max(self.threshold, other.threshold)
        if self.sketch is None and other.sketch is None:
            self.hashes = np.union1d(self.hashes, other.hashes)
            if len(self.hashes) > self.threshold:
                self._to_sketch()
            return
        if self.sketch is None:
            self._to_sketch()
        if other.sketch is not None:
            self.sketch.merge(other.sketch)
        else:
            self.sketch.add_hashes(other.hashes)

    def value(self) -> int:
        if self.sketch is None:
            return int(len(self.hashes))
        return self.sketch.estimate()
