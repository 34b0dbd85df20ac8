"""Phrase matching over position lists.

Semantics parity with searchlite-core `query/phrase.rs:4-48`: positions
must appear in order with a total gap budget of ``slop``; position lists
are sorted so the search breaks early. Phrases are filter-only (they
gate matching but don't contribute score), matching the reference
planner (`query/planner.rs:622-635`).
"""

from __future__ import annotations

import numpy as np


def matches_phrase(positions_per_term: list[np.ndarray], slop: int) -> bool:
    """True if there is an in-order assignment of positions (one per
    term) whose accumulated gap is <= slop."""
    if not positions_per_term:
        return True
    if any(len(p) == 0 for p in positions_per_term):
        return False
    if len(positions_per_term) == 1:
        return True

    def search(idx: int, prev: int, remaining: int) -> bool:
        if idx >= len(positions_per_term):
            return True
        for pos in positions_per_term[idx]:
            pos = int(pos)
            if pos <= prev:
                continue
            gap = max(pos - (prev + 1), 0)
            if gap > remaining:
                break  # sorted: later entries only increase the gap
            if search(idx + 1, pos, remaining - gap):
                return True
        return False

    for start in positions_per_term[0]:
        if search(1, int(start), int(slop)):
            return True
    return False
