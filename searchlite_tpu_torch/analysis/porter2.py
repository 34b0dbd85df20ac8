"""Porter2 (Snowball "english") stemmer, pure Python.

Implements the published Snowball english algorithm so token streams
match the reference's stemmer filter (rust-stemmers ``Algorithm::English``;
used via searchlite-core `analysis/analyzer.rs:370-376`).
"""

from __future__ import annotations

_VOWELS = frozenset("aeiouy")
_DOUBLES = ("bb", "dd", "ff", "gg", "mm", "nn", "pp", "rr", "tt")
_VALID_LI = frozenset("cdeghkmnrt")

_EXCEPTIONS1 = {
    "skis": "ski",
    "skies": "sky",
    "dying": "die",
    "lying": "lie",
    "tying": "tie",
    "idly": "idl",
    "gently": "gentl",
    "ugly": "ugli",
    "early": "earli",
    "only": "onli",
    "singly": "singl",
    "sky": "sky",
    "news": "news",
    "howe": "howe",
    "atlas": "atlas",
    "cosmos": "cosmos",
    "bias": "bias",
    "andes": "andes",
}

_EXCEPTIONS2 = frozenset(
    ("inning", "outing", "canning", "herring", "earring",
     "proceed", "exceed", "succeed")
)

_STEP2_SUFFIXES = (
    ("ization", "ize"),
    ("ational", "ate"),
    ("ousness", "ous"),
    ("iveness", "ive"),
    ("fulness", "ful"),
    ("tional", "tion"),
    ("biliti", "ble"),
    ("lessli", "less"),
    ("entli", "ent"),
    ("ation", "ate"),
    ("alism", "al"),
    ("aliti", "al"),
    ("ousli", "ous"),
    ("iviti", "ive"),
    ("fulli", "ful"),
    ("enci", "ence"),
    ("anci", "ance"),
    ("abli", "able"),
    ("izer", "ize"),
    ("ator", "ate"),
    ("alli", "al"),
    ("bli", "ble"),
)

_STEP3_SUFFIXES = (
    ("ational", "ate"),
    ("tional", "tion"),
    ("alize", "al"),
    ("icate", "ic"),
    ("iciti", "ic"),
    ("ical", "ic"),
    ("ful", ""),
    ("ness", ""),
)

_STEP4_SUFFIXES = (
    "ement", "ance", "ence", "able", "ible", "ment",
    "ant", "ent", "ism", "ate", "iti", "ous", "ive", "ize",
    "al", "er", "ic",
)


def _is_vowel(word: str, i: int) -> bool:
    return word[i] in _VOWELS


def _contains_vowel(word: str, start: int, end: int) -> bool:
    return any(word[i] in _VOWELS for i in range(start, end))


def _compute_r1(word: str) -> int:
    for prefix in ("gener", "commun", "arsen"):
        if word.startswith(prefix):
            return len(prefix)
    for i in range(1, len(word)):
        if not _is_vowel(word, i) and _is_vowel(word, i - 1):
            return i + 1
    return len(word)


def _compute_r2(word: str, r1: int) -> int:
    for i in range(r1 + 1, len(word)):
        if not _is_vowel(word, i) and _is_vowel(word, i - 1):
            return i + 1
    return len(word)


def _is_short_syllable(word: str, i: int) -> bool:
    """Short syllable ending at index i (the position of the vowel)."""
    if i == 0:
        return (
            len(word) >= 2
            and _is_vowel(word, 0)
            and not _is_vowel(word, 1)
        )
    return (
        0 < i < len(word) - 1
        and _is_vowel(word, i)
        and not _is_vowel(word, i + 1)
        and word[i + 1] not in "wxY"
        and not _is_vowel(word, i - 1)
    )


def _is_short_word(word: str, r1: int) -> bool:
    return r1 >= len(word) and _ends_in_short_syllable(word)


def _ends_in_short_syllable(word: str) -> bool:
    if len(word) < 2:
        return False
    if len(word) == 2:
        return _is_vowel(word, 0) and not _is_vowel(word, 1)
    return _is_short_syllable(word, len(word) - 2)


def stem(word: str) -> str:
    word = word.lower()
    if len(word) <= 2:
        return word
    if word.startswith("'"):
        word = word[1:]
    if word in _EXCEPTIONS1:
        return _EXCEPTIONS1[word]
    if len(word) <= 2:
        return word

    # Mark consonant-y as Y.
    chars = list(word)
    if chars[0] == "y":
        chars[0] = "Y"
    for i in range(1, len(chars)):
        if chars[i] == "y" and chars[i - 1] in _VOWELS:
            chars[i] = "Y"
    word = "".join(chars)

    r1 = _compute_r1(word)
    r2 = _compute_r2(word, r1)

    # Step 0: strip 's / ' / 's'
    for suf in ("'s'", "'s", "'"):
        if word.endswith(suf):
            word = word[: -len(suf)]
            break

    # Step 1a
    if word.endswith("sses"):
        word = word[:-2]
    elif word.endswith(("ied", "ies")):
        word = word[:-2] if len(word) > 4 else word[:-1]
    elif word.endswith(("us", "ss")):
        pass
    elif word.endswith("s"):
        if _contains_vowel(word, 0, len(word) - 2):
            word = word[:-1]

    if word in _EXCEPTIONS2:
        return word

    # Step 1b
    step1b_done = False
    for suf, repl in (("eedly", "ee"), ("eed", "ee")):
        if word.endswith(suf):
            if len(word) - len(suf) >= r1:
                word = word[: -len(suf)] + repl
            step1b_done = True
            break
    if not step1b_done:
        for suf in ("ingly", "edly", "ing", "ed"):
            if word.endswith(suf):
                stem_part = word[: -len(suf)]
                if _contains_vowel(stem_part, 0, len(stem_part)):
                    word = stem_part
                    if word.endswith(("at", "bl", "iz")):
                        word += "e"
                    elif word.endswith(_DOUBLES):
                        word = word[:-1]
                    elif _is_short_word(word, r1):
                        word += "e"
                break

    # Step 1c
    if (
        len(word) > 2
        and word[-1] in "yY"
        and word[-2] not in _VOWELS
    ):
        word = word[:-1] + "i"

    # Step 2
    for suf, repl in _STEP2_SUFFIXES:
        if word.endswith(suf):
            if len(word) - len(suf) >= r1:
                word = word[: -len(suf)] + repl
            break
    else:
        if word.endswith("ogi"):
            if len(word) - 3 >= r1 and len(word) >= 4 and word[-4] == "l":
                word = word[:-1]
        elif word.endswith("li"):
            if len(word) - 2 >= r1 and len(word) >= 3 and word[-3] in _VALID_LI:
                word = word[:-2]

    # Step 3
    for suf, repl in _STEP3_SUFFIXES:
        if word.endswith(suf):
            if len(word) - len(suf) >= r1:
                word = word[: -len(suf)] + repl
            break
    else:
        if word.endswith("ative"):
            if len(word) - 5 >= r1 and len(word) - 5 >= r2:
                word = word[:-5]

    # Step 4
    for suf in _STEP4_SUFFIXES:
        if word.endswith(suf):
            if len(word) - len(suf) >= r2:
                word = word[: -len(suf)]
            break
    else:
        if word.endswith("ion"):
            if len(word) - 3 >= r2 and len(word) >= 4 and word[-4] in "st":
                word = word[:-3]

    # Step 5
    if word.endswith("e"):
        if len(word) - 1 >= r2:
            word = word[:-1]
        elif len(word) - 1 >= r1 and not _ends_in_short_syllable(word[:-1]):
            word = word[:-1]
    elif word.endswith("l"):
        if len(word) - 1 >= r2 and len(word) >= 2 and word[-2] == "l":
            word = word[:-1]

    return word.replace("Y", "y")
