"""Query-string parser.

Parity with searchlite-core `api/query.rs:20-98`: splits ``field:term``
pairs, quoted phrases (with optional ``field:`` prefix inside quotes),
and ``-negated`` terms.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Optional


@dataclass
class QueryTerm:
    field: Optional[str]
    term: str


@dataclass
class PhraseQuery:
    field: Optional[str]
    terms: list[str]


@dataclass
class ParsedQuery:
    terms: list[QueryTerm] = dc_field(default_factory=list)
    phrases: list[PhraseQuery] = dc_field(default_factory=list)
    not_terms: list[QueryTerm] = dc_field(default_factory=list)


def _parse_terms(segment: str) -> tuple[list[QueryTerm], list[QueryTerm]]:
    out: list[QueryTerm] = []
    not_out: list[QueryTerm] = []
    for raw in segment.split():
        if not raw:
            continue
        is_not = raw.startswith("-")
        token = raw.lstrip("-")
        if ":" in token:
            field, term = token.split(":", 1)
        else:
            field, term = None, token
        qt = QueryTerm(field, term)
        (not_out if is_not else out).append(qt)
    return out, not_out


def parse_query(input_str: str) -> ParsedQuery:
    parsed = ParsedQuery()
    rest = input_str.strip()
    while '"' in rest:
        start = rest.find('"')
        before = rest[:start].strip()
        if before:
            terms, not_terms = _parse_terms(before)
            parsed.terms.extend(terms)
            parsed.not_terms.extend(not_terms)
        after = rest[start + 1:]
        end_idx = after.find('"')
        if end_idx == -1:
            rest = ""
            break
        phrase_body = after[:end_idx]
        field = None
        body = phrase_body
        colon_idx = phrase_body.find(":")
        if colon_idx != -1:
            prefix = phrase_body[:colon_idx]
            if prefix and all(c.isalnum() or c == "_" for c in prefix):
                field = prefix
                body = phrase_body[colon_idx + 1:]
        terms_vec = [t for t in body.split() if t]
        if terms_vec:
            parsed.phrases.append(PhraseQuery(field, terms_vec))
        rest = after[end_idx + 1:]
    if rest.strip():
        terms, not_terms = _parse_terms(rest)
        parsed.terms.extend(terms)
        parsed.not_terms.extend(not_terms)
    return parsed
