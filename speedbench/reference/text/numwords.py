"""Number -> English words (replaces the inflect dependency, which is not
available in this environment). Output conventions follow inflect.engine()
.number_to_words as used by the reference text normalizer
(reference: tts_text_processing/numerical.py): British 'and', hyphenated
tens-units, comma-separated scale groups, optional group=2 digit-pair mode
with a custom zero word, and ordinal-suffix inputs like '21st'."""

import re

_ONES = ["zero", "one", "two", "three", "four", "five", "six", "seven",
         "eight", "nine", "ten", "eleven", "twelve", "thirteen", "fourteen",
         "fifteen", "sixteen", "seventeen", "eighteen", "nineteen"]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]
_SCALES = [(10 ** 12, "trillion"), (10 ** 9, "billion"), (10 ** 6, "million"),
           (10 ** 3, "thousand")]

_ORDINAL_MAP = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _two_digits(n, zero="zero"):
    if n == 0:
        return zero
    if n < 20:
        return _ONES[n]
    tens, units = divmod(n, 10)
    if units == 0:
        return _TENS[tens]
    return _TENS[tens] + "-" + _ONES[units]


def _three_digits(n, andword):
    """0-999 within one scale group."""
    if n < 100:
        return _two_digits(n)
    hundreds, rest = divmod(n, 100)
    out = _ONES[hundreds] + " hundred"
    if rest:
        sep = f" {andword} " if andword else " "
        out += sep + _two_digits(rest)
    return out


def cardinal(n, andword="and"):
    """Integer -> words with comma-separated scale groups, inflect-style:
    1234567 -> 'one million, two hundred and thirty-four thousand, five
    hundred and sixty-seven'."""
    n = int(n)
    if n == 0:
        return "zero"
    if n < 0:
        return "minus " + cardinal(-n, andword)
    parts = []
    for value, name in _SCALES:
        if n >= value:
            count, n = divmod(n, value)
            parts.append(cardinal(count, andword) + " " + name)
    if n:
        parts.append(_three_digits(n, andword))
    return ", ".join(parts)


def _group2(digits, zero="zero"):
    """inflect group=2 mode over a digit string: pairs from the left, joined
    with ', '; a pair with a leading zero reads as '<zero> <digit>'."""
    pairs = [digits[i:i + 2] for i in range(0, len(digits), 2)]
    words = []
    for p in pairs:
        if len(p) == 2 and p[0] == "0":
            words.append(zero + " " + (_ONES[int(p[1])] if p[1] != "0"
                                       else zero))
        else:
            words.append(_two_digits(int(p), zero=zero))
    return ", ".join(words)


def number_to_words(num, andword="and", zero="zero", group=0):
    """String/int number -> words. Handles decimals ('1.2' -> 'one point
    two'), ordinal-suffix strings ('21st' -> 'twenty-first'), and inflect's
    group=2 digit pairing."""
    s = str(num).strip()

    m = re.fullmatch(r"(\d+)(st|nd|rd|th)", s, re.IGNORECASE)
    if m:
        return ordinal_words(int(m.group(1)))

    if group == 2:
        return _group2(re.sub(r"\D", "", s), zero=zero)

    if "." in s:
        int_part, frac = s.split(".", 1)
        left = cardinal(int_part or 0, andword)
        digits = " ".join(_ONES[int(d)] if d != "0" else zero for d in frac)
        return left + " point " + digits

    return cardinal(s, andword)


def ordinal_words(n):
    words = cardinal(n)
    head, _, last = words.rpartition(" ")
    hy_head, hy_sep, hy_last = last.rpartition("-")
    if hy_last in _ORDINAL_MAP:
        ord_last = _ORDINAL_MAP[hy_last]
    elif hy_last.endswith("y"):
        ord_last = hy_last[:-1] + "ieth"
    else:
        ord_last = hy_last + "th"
    last = (hy_head + hy_sep + ord_last) if hy_sep else ord_last
    return (head + " " + last) if head else last
