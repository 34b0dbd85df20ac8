"""The precision modes: the storage dtypes of the device tables.

The port's copy of the policy of ``searchlite_tpu/ops/precision.py``,
for torch devices. Two environment variables decide:

- ``SEARCHLITE_PRECISION``: unset or ``f32`` (the default), ``f32_strict``
  or ``bf16``;
- ``SEARCHLITE_DEVICE_IMPACTS``: ``f32`` or ``bf16`` forces the storage
  of posting impacts (ignored under ``f32_strict``).

| Setting | On the card | On the CPU |
|---|---|---|
| unset / ``f32`` | exact f32 | f32 |
| ``f32_strict`` | f32 | f32 |
| ``bf16`` | bf16 impacts, bf16 dense rows | f32 impacts, bf16 dense rows |
| ``SEARCHLITE_DEVICE_IMPACTS`` | forces impact storage | the same |

The CPU column equals the JAX package's on its CPU backend, row for row.
On an accelerator the JAX default stores bf16 and rounds its dot inputs
(XLA's default matmul precision); the port's default stays exact f32 on
the card: an approximate answer where it gave an exact one would be
another result, not a faster one. XLA's matmul-precision switch has no
counterpart here: every f32 dot of the port is exact (TF32 off), in
every mode, and nothing here touches ``torch.backends``.

Scores under bf16 storage: each table is rounded to bf16 once on the
host, before upload; every scorer widens what it gathers to f32 before
any product, and the dense-row scorer rounds its weights to bf16 (JAX
``make_split_impact_scorer``), so each product of a bf16 weight and a
bf16 impact is exact in f32 and the sums are f32.
"""

from __future__ import annotations

import os

import torch

# > 2^-7: covers bf16 rounding of impacts or dot inputs (2^-8) with
# headroom for the f32 accumulation of non-negative terms; the pruned
# execution inflates its tile bounds by it so a bound never falls under
# a true score of its tile (returned scores are unaffected)
UB_SAFETY = 1.02


def precision() -> str:
    """``SEARCHLITE_PRECISION`` (default ``f32``)."""
    return os.environ.get("SEARCHLITE_PRECISION", "f32")


def strict() -> bool:
    """``SEARCHLITE_PRECISION=f32_strict``."""
    return precision() == "f32_strict"


def m_store_dtype() -> torch.dtype:
    """Storage of the matrices scattered per batch (M from blocks, runs or
    flat postings): f32 in every mode, as in JAX (a sub-word scatter
    store buys nothing)."""
    return torch.float32


def impacts_store_dtype(device) -> torch.dtype:
    """Device storage of posting impacts (``block_impacts``, the flat
    postings' impacts, the doc-shard and mesh tables) on ``device``. f32
    under ``f32_strict`` or ``SEARCHLITE_DEVICE_IMPACTS=f32``, bf16 under
    ``SEARCHLITE_DEVICE_IMPACTS=bf16``; else bf16 on the card under
    ``SEARCHLITE_PRECISION=bf16`` and f32 otherwise, the CPU (the JAX CPU
    backend, the host tier) included."""
    forced = os.environ.get("SEARCHLITE_DEVICE_IMPACTS")
    if strict() or forced == "f32":
        return torch.float32
    if forced == "bf16":
        return torch.bfloat16
    if torch.device(device).type == "cpu":
        return torch.float32
    return torch.bfloat16 if precision() == "bf16" else torch.float32


def dense_store_dtype() -> torch.dtype:
    """Storage of the resident dense impact rows (``m_dense``): bf16 under
    ``bf16`` on every device (as JAX), f32 otherwise."""
    return torch.bfloat16 if precision() == "bf16" else torch.float32

