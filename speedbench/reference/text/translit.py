"""Minimal ASCII transliteration (replaces the unidecode dependency for the
'english_cleaners'/'transliteration_cleaners' pipelines; the default
'radtts_cleaners' pipeline never transliterates). Covers Latin-1/Latin
Extended letters and common Unicode punctuation; unmapped non-ASCII
characters are dropped, like unidecode does for unknown codepoints."""

import unicodedata

_PUNCT = {
    "‘": "'", "’": "'", "“": '"', "”": '"',
    "–": "-", "—": "--", "…": "...", " ": " ",
    "«": '"', "»": '"', "′": "'", "″": '"',
    "½": " 1/2", "¼": " 1/4", "¾": " 3/4",
    "ß": "ss", "æ": "ae", "Æ": "AE", "œ": "oe",
    "Œ": "OE", "ø": "o", "Ø": "O", "ð": "d",
    "þ": "th", "đ": "d", "ł": "l", "Ł": "L",
}


def transliterate(text):
    out = []
    for ch in text:
        if ord(ch) < 128:
            out.append(ch)
            continue
        if ch in _PUNCT:
            out.append(_PUNCT[ch])
            continue
        # strip combining marks: é -> e
        decomp = unicodedata.normalize("NFKD", ch)
        ascii_part = "".join(c for c in decomp if ord(c) < 128)
        out.append(ascii_part)
    return "".join(out)
