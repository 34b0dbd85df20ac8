"""UAX#29 word segmentation (exact), matching unicode-segmentation's
``unicode_words()`` used by the reference's `unicode` tokenizer
(`searchlite-core/src/analysis/tokenizer.rs:31-41`).

Implements the full Word_Break rule set (WB1–WB999, Unicode revision
bundled with the environment's UCD — see the header of
``_uax29_tables.py``) over generated property-interval tables, so the
runtime needs no third-party Unicode library and no per-character
property probing. ``unicode_words`` filters segments to those
containing an alphanumeric character, with Rust's
``char::is_alphanumeric`` semantics (Alphabetic | Nd | Nl | No).
"""

from __future__ import annotations

from bisect import bisect_right

from searchlite_tpu_torch.analysis import _uax29_tables as T

# class ids
(OTHER, CR, LF, NEWLINE, EXTEND, ZWJ, RI, FORMAT, KATAKANA, HEBREW,
 ALETTER, SQ, DQ, MIDNUMLET, MIDLETTER, MIDNUM, NUMERIC, EXTENDNUMLET,
 WSEGSPACE) = range(19)

_CLASS_TABLES = [
    (CR, T.CR), (LF, T.LF), (NEWLINE, T.NEWLINE), (EXTEND, T.EXTEND),
    (ZWJ, T.ZWJ), (RI, T.REGIONAL_INDICATOR), (FORMAT, T.FORMAT),
    (KATAKANA, T.KATAKANA), (HEBREW, T.HEBREW_LETTER),
    (ALETTER, T.ALETTER), (SQ, T.SINGLE_QUOTE), (DQ, T.DOUBLE_QUOTE),
    (MIDNUMLET, T.MIDNUMLET), (MIDLETTER, T.MIDLETTER),
    (MIDNUM, T.MIDNUM), (NUMERIC, T.NUMERIC),
    (EXTENDNUMLET, T.EXTENDNUMLET), (WSEGSPACE, T.WSEGSPACE),
]


def _build(table_pairs):
    entries = []
    for cid, ivs in table_pairs:
        for lo, hi in ivs:
            entries.append((lo, hi, cid))
    entries.sort()
    starts = [e[0] for e in entries]
    ends = [e[1] for e in entries]
    cids = [e[2] for e in entries]
    return starts, ends, cids


_STARTS, _ENDS, _CIDS = _build(_CLASS_TABLES)
_EP_STARTS, _EP_ENDS, _ = _build([(0, T.EXTENDED_PICTOGRAPHIC)])
_AN_STARTS, _AN_ENDS, _ = _build([(0, T.ALPHANUMERIC)])

_IGNORE = (EXTEND, FORMAT, ZWJ)
_AH = (ALETTER, HEBREW)
_MIDNUMLETQ = (MIDNUMLET, SQ)

_cls_cache: dict[str, int] = {}
_ep_cache: dict[str, bool] = {}


def _classify(ch: str) -> int:
    c = _cls_cache.get(ch)
    if c is None:
        o = ord(ch)
        i = bisect_right(_STARTS, o) - 1
        c = _CIDS[i] if i >= 0 and o <= _ENDS[i] else OTHER
        _cls_cache[ch] = c
    return c


def _is_ext_pict(ch: str) -> bool:
    v = _ep_cache.get(ch)
    if v is None:
        o = ord(ch)
        i = bisect_right(_EP_STARTS, o) - 1
        v = i >= 0 and o <= _EP_ENDS[i]
        _ep_cache[ch] = v
    return v


def is_alphanumeric(ch: str) -> bool:
    o = ord(ch)
    i = bisect_right(_AN_STARTS, o) - 1
    return i >= 0 and o <= _AN_ENDS[i]


def word_bounds(text: str) -> list[int]:
    """All word boundary offsets, including 0 and len(text)."""
    n = len(text)
    if n == 0:
        return [0]
    cls = [_classify(c) for c in text]
    bounds = [0]

    # left / left2: the last two word-break classes with Extend/Format/
    # ZWJ collapsed per WB4 (an ignorable attaches to what precedes it)
    left = cls[0]
    left2 = OTHER
    # count of consecutive Regional_Indicators ending at `left`
    ri_run = 1 if left == RI else 0

    for i in range(1, n):
        right = cls[i]
        prev = cls[i - 1]

        if prev == CR and right == LF:                       # WB3
            brk = False
        elif prev in (NEWLINE, CR, LF):                      # WB3a
            brk = True
        elif right in (NEWLINE, CR, LF):                     # WB3b
            brk = True
        elif prev == ZWJ and _is_ext_pict(text[i]):          # WB3c
            brk = False
        elif prev == WSEGSPACE and right == WSEGSPACE:       # WB3d
            brk = False
        elif right in _IGNORE:                               # WB4
            brk = False
        else:
            # look ahead to the next non-ignorable class (WB6/7b/12)
            right2 = OTHER
            for j in range(i + 1, n):
                if cls[j] not in _IGNORE:
                    right2 = cls[j]
                    break
            if left in _AH and right in _AH:                 # WB5
                brk = False
            elif left in _AH and right2 in _AH and \
                    (right == MIDLETTER or right in _MIDNUMLETQ):  # WB6
                brk = False
            elif (left == MIDLETTER or left in _MIDNUMLETQ) \
                    and left2 in _AH and right in _AH:       # WB7
                brk = False
            elif left == HEBREW and right == SQ:             # WB7a
                brk = False
            elif left == HEBREW and right == DQ \
                    and right2 == HEBREW:                    # WB7b
                brk = False
            elif left == DQ and left2 == HEBREW \
                    and right == HEBREW:                     # WB7c
                brk = False
            elif left == NUMERIC and right == NUMERIC:       # WB8
                brk = False
            elif left in _AH and right == NUMERIC:           # WB9
                brk = False
            elif left == NUMERIC and right in _AH:           # WB10
                brk = False
            elif (left == MIDNUM or left in _MIDNUMLETQ) \
                    and left2 == NUMERIC and right == NUMERIC:  # WB11
                brk = False
            elif left == NUMERIC and right2 == NUMERIC and \
                    (right == MIDNUM or right in _MIDNUMLETQ):  # WB12
                brk = False
            elif left == KATAKANA and right == KATAKANA:     # WB13
                brk = False
            elif right == EXTENDNUMLET and \
                    (left in _AH or left in (NUMERIC, KATAKANA,
                                             EXTENDNUMLET)):  # WB13a
                brk = False
            elif left == EXTENDNUMLET and \
                    (right in _AH or right in (NUMERIC,
                                               KATAKANA)):   # WB13b
                brk = False
            elif left == RI and right == RI and ri_run % 2 == 1:
                brk = False                                  # WB15/16
            else:
                brk = True                                   # WB999

        if brk:
            bounds.append(i)

        # advance the collapsed left/left2 state
        if right in _IGNORE and prev not in (NEWLINE, CR, LF):
            pass  # WB4: ignorable extends the previous char
        else:
            # WB15/16 count RAW consecutive RIs (breaks don't reset)
            if right == RI:
                ri_run = ri_run + 1 if left == RI else 1
            else:
                ri_run = 0
            left2 = left
            left = right

    bounds.append(n)
    return bounds


def words(text: str) -> list[str]:
    """All UAX#29 word segments (including punctuation/space runs)."""
    b = word_bounds(text)
    return [text[b[i]:b[i + 1]] for i in range(len(b) - 1)]


def unicode_words(text: str) -> list[str]:
    """Word segments containing at least one alphanumeric char —
    unicode-segmentation ``unicode_words()`` parity."""
    return [w for w in words(text)
            if any(is_alphanumeric(c) for c in w)]
