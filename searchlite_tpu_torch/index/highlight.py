"""Phrase-aware regex highlighter.

Parity with searchlite-core `index/highlight.rs`: escaped terms/phrases
joined with word boundaries, case-insensitive; fragments centered on the
match; ``make_snippet`` = one 120-char fragment with ``**`` tags.
"""

from __future__ import annotations

import re
from dataclasses import dataclass


@dataclass
class HighlightOptions:
    pre_tag: str = "**"
    post_tag: str = "**"
    fragment_size: int = 120
    number_of_fragments: int = 1


def highlight_fragments(text: str, terms: list[str],
                        phrases: list[list[str]],
                        opts: HighlightOptions) -> list[str]:
    if not text or (not terms and not phrases):
        return []
    patterns: list[str] = []
    for phrase in phrases:
        if not phrase:
            continue
        joined = r"\W+".join(re.escape(p) for p in phrase)
        patterns.append(rf"\b{joined}\b")
    for term in terms:
        if not term:
            continue
        patterns.append(rf"\b{re.escape(term)}\b")
    if not patterns:
        return []
    try:
        regex = re.compile("|".join(patterns), re.IGNORECASE)
    except re.error:
        return []
    out: list[str] = []
    offset = 0
    for _ in range(opts.number_of_fragments):
        m = regex.search(text, offset)
        if m is None:
            break
        start = max(m.start() - opts.fragment_size // 2, 0)
        end = min(len(text), start + opts.fragment_size)
        fragment = text[start:end]
        highlighted = regex.sub(
            lambda c: f"{opts.pre_tag}{c.group(0)}{opts.post_tag}", fragment)
        out.append(highlighted)
        offset = m.end()
    return out


def make_snippet(text: str, terms: list[str],
                 phrases: list[list[str]]) -> str | None:
    frags = highlight_fragments(
        text, terms, phrases,
        HighlightOptions("**", "**", 120, 1))
    return frags[-1] if frags else None
