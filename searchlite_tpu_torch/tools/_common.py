"""What the port's tools and ``chip_smoke.py`` share: the import block
that keeps them off JAX and the JAX package, the device check, the
card's line, and a snapshot of every kernel wrapper's launch and
plain-call counts."""

from __future__ import annotations

import subprocess
import sys


def block_jax() -> None:
    """Make any import of ``jax`` or ``searchlite_tpu`` fail loudly: the
    card's machine has neither, and the port must not need them."""
    sys.modules["jax"] = None
    sys.modules["searchlite_tpu"] = None


def require_device(device: str) -> None:
    """Exit 2 where ``device`` is a card and torch sees none: a tool asked
    for the card never runs on the CPU instead. On the card, TF32 is
    turned off (every f32 product of the port is exact)."""
    import torch

    if torch.device(device).type != "cuda":
        return
    if not torch.cuda.is_available():
        print("FAILED: torch.cuda.is_available() is False (pass --device "
              "cpu to run on the CPU)", flush=True)
        raise SystemExit(2)
    torch.backends.cuda.matmul.allow_tf32 = False


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return res.stdout.strip().splitlines()[0] if res.stdout.strip() \
            else f"nvidia-smi failed: {res.stderr.strip()}"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def counters() -> dict:
    """Every kernel wrapper's ``LaunchCounts``, by kernel name (f32
    operands, then the bf16 variants)."""
    from searchlite_tpu_torch.ops import fused_topk, strip_topk

    return {"strip_topk": strip_topk.COUNTS,
            "strip_lanes": strip_topk.LANES_COUNTS,
            "fused_topk": fused_topk.COUNTS,
            "strip_topk_bf16": strip_topk.COUNTS_BF16,
            "strip_lanes_bf16": strip_topk.LANES_COUNTS_BF16,
            "fused_topk_bf16": fused_topk.COUNTS_BF16}


def kernel_counts() -> dict:
    """{kernel: (launches, plain calls)} as the wrappers count them now."""
    return {name: (c.launches, c.plain) for name, c in counters().items()}


def counts_since(before: dict) -> dict:
    """{kernel: [launches, plain calls]} since the ``before`` snapshot,
    the kernels that ran only."""
    out = {}
    for name, (launches, plain) in kernel_counts().items():
        d = [launches - before[name][0], plain - before[name][1]]
        if d[0] or d[1]:
            out[name] = d
    return out
