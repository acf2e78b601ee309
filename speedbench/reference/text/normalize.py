"""Text normalization rules: numbers, currency, dates/times, abbreviations,
letters+numbers, hardware units, dimensions.

Behavior parity with the reference normalizers (tts_text_processing/
numerical.py, abbreviations.py, datestime.py, letters_and_numbers.py),
including their quirks (e.g. the `number > 1000 < 10000` chained-comparison
condition that effectively tests only > 1000). Number verbalization uses our
numwords module instead of inflect.
"""

import re

from speedbench.reference.text.numwords import number_to_words

# --- numbers / currency (reference: numerical.py) --------------------------

_MAGNITUDES = ["trillion", "billion", "million", "thousand", "hundred",
               "m", "b", "t"]
_MAGNITUDES_KEY = {"m": "million", "b": "billion", "t": "trillion"}
_CURRENCY_KEY = {"$": "dollar", "£": "pound", "€": "euro", "₩": "won"}

_comma_number_re = re.compile(r"([0-9][0-9\,]+[0-9])")
_decimal_number_re = re.compile(r"([0-9]+\.[0-9]+)")
_currency_re = re.compile(
    r"([\$€£₩])([0-9\.\,]*[0-9]+)(?:[ ]?({})(?=[^a-zA-Z]))?".format(
        "|".join(_MAGNITUDES)), re.IGNORECASE)
_ordinal_re = re.compile(r"[0-9]+(st|nd|rd|th)")
_roman_re = re.compile(
    r"\b(?=[MDCLXVI]+\b)M{0,4}(CM|CD|D?C{0,3})(XC|XL|L?X{0,3})"
    r"(IX|IV|V?I{2,3})\b")
_multiply_re = re.compile(r"(\b[0-9]+)(x)([0-9]+)")
_number_re = re.compile(r"[0-9]+'s|[0-9]+s|[0-9]+")


def _expand_hundreds_text(text):
    number = float(text)
    if number > 1000 and number % 100 == 0 and number % 1000 != 0:
        return number_to_words(int(number / 100)) + " hundred"
    return number_to_words(text)


def _expand_currency(m):
    currency = _CURRENCY_KEY[m.group(1)]
    quantity = m.group(2).replace(",", "")
    magnitude = m.group(3)

    if magnitude is not None and magnitude.lower() in _MAGNITUDES:
        if len(magnitude) == 1:
            magnitude = _MAGNITUDES_KEY[magnitude.lower()]
        return "{} {} {}".format(_expand_hundreds_text(quantity), magnitude,
                                 currency + "s")

    parts = quantity.split(".")
    if len(parts) > 2:
        return quantity + " " + currency + "s"
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    if dollars and cents:
        dollar_unit = currency if dollars == 1 else currency + "s"
        cent_unit = "cent" if cents == 1 else "cents"
        return "{} {}, {} {}".format(_expand_hundreds_text(dollars),
                                     dollar_unit, number_to_words(cents),
                                     cent_unit)
    if dollars:
        dollar_unit = currency if dollars == 1 else currency + "s"
        return "{} {}".format(_expand_hundreds_text(dollars), dollar_unit)
    if cents:
        cent_unit = "cent" if cents == 1 else "cents"
        return "{} {}".format(number_to_words(cents), cent_unit)
    return "zero " + currency + "s"


def _expand_roman(m):
    values = {"I": 1, "V": 5, "X": 10, "L": 50, "C": 100, "D": 500,
              "M": 1000}
    num = m.group(0)
    result = 0
    for i, c in enumerate(num):
        if i + 1 == len(num) or values[c] >= values[num[i + 1]]:
            result += values[c]
        else:
            result -= values[c]
    return str(result)


def _expand_number(m):
    _, number, suffix = re.split(r"(\d+(?:'?\d+)?)", m.group(0))
    number = int(number)
    if 1000 < number < 10000 and number % 100 == 0 and number % 1000 != 0:
        text = number_to_words(number // 100) + " hundred"
    elif 1000 < number < 3000:
        if number == 2000:
            text = "two thousand"
        elif 2000 < number < 2010:
            text = "two thousand " + number_to_words(number % 100)
        elif number % 100 == 0:
            text = number_to_words(number // 100) + " hundred"
        else:
            text = number_to_words(number, andword="", zero="oh",
                                   group=2).replace(", ", " ")
            text = re.sub(r"-", " ", text)
    else:
        text = number_to_words(number, andword="and")
        text = re.sub(r"-", " ", text)
        text = re.sub(r",", "", text)

    if suffix in ("'s", "s"):
        if text[-1] == "y":
            text = text[:-1] + "ies"
        else:
            text = text + suffix
    return text


def normalize_currency(text):
    return re.sub(_currency_re, _expand_currency, text)


def normalize_numbers(text):
    text = re.sub(_comma_number_re, lambda m: m.group(1).replace(",", ""),
                  text)
    text = re.sub(_currency_re, _expand_currency, text)
    text = re.sub(_decimal_number_re,
                  lambda m: m.group(1).replace(".", " point "), text)
    text = re.sub(_ordinal_re, lambda m: number_to_words(m.group(0)), text)
    text = re.sub(_roman_re, _expand_roman, text)
    text = re.sub(_multiply_re,
                  lambda m: "{} by {}".format(m.group(1), m.group(3)), text)
    text = re.sub(_number_re, _expand_number, text)
    return text


# --- abbreviations (reference: abbreviations.py) ---------------------------

_no_period_re = re.compile(r"(No[.])(?=[ ]?[0-9])")
_percent_re = re.compile(r"([ ]?[%])")
_half_re = re.compile("([0-9]½)|(½)")

def normalize_abbreviations(text):
    """Nb: the reference defines an honorifics table (mrs->misess, ...) but
    never applies it (abbreviations.py:50-54 only expands No./percent/half);
    we match that behavior."""
    text = re.sub(_no_period_re,
                  lambda m: "Number" if m.group(0)[0] == "N" else "number",
                  text)
    text = re.sub(_percent_re, " percent", text)

    def _half(m):
        word = m.group(1)
        if word is None:
            return "half"
        return word[0] + " and a half"

    return re.sub(_half_re, _half, text)


# --- date/time (reference: datestime.py) -----------------------------------

_ampm_re = re.compile(
    r"([0-9]|0[0-9]|1[0-9]|2[0-3]):?([0-5][0-9])?\s*([AaPp][Mm]\b)")


def normalize_datestime(text):
    def _ampm(m):
        groups = list(m.groups(0))
        txt = groups[0]
        if int(groups[1]) != 0:
            txt = txt + " " + groups[1]
        if groups[2][0].lower() == "a":
            txt += " a.m."
        elif groups[2][0].lower() == "p":
            txt += " p.m."
        return txt

    return re.sub(_ampm_re, _ampm, text)


# --- letters and numbers (reference: letters_and_numbers.py) ---------------

_letters_and_numbers_re = re.compile(
    r"((?:[a-zA-Z]+[0-9]|[0-9]+[a-zA-Z])[a-zA-Z0-9']*)", re.IGNORECASE)
_hardware_re = re.compile(
    r"([0-9]+(?:[.,][0-9]+)?)(?:\s?)(tb|gb|mb|kb|ghz|mhz|khz|hz|mm)",
    re.IGNORECASE)
_HARDWARE_KEY = {"tb": "terabyte", "gb": "gigabyte", "mb": "megabyte",
                 "kb": "kilobyte", "ghz": "gigahertz", "mhz": "megahertz",
                 "khz": "kilohertz", "hz": "hertz", "mm": "millimeter",
                 "cm": "centimeter", "km": "kilometer"}
_dimension_re = re.compile(
    r"\b(\d+(?:[,.]\d+)?\s*[xX]\s*\d+(?:[,.]\d+)?\s*[xX]\s*\d+(?:[,.]\d+)?"
    r"(?:in|inch|m)?)\b|\b(\d+(?:[,.]\d+)?\s*[xX]\s*\d+(?:[,.]\d+)?"
    r"(?:in|inch|m)?)\b")
_DIMENSION_KEY = {"m": "meter", "in": "inch", "inch": "inch"}


def _expand_letters_and_numbers(m):
    text = re.split(r"(\d+)", m.group(0))
    if text[-1] == "":
        text = text[:-1]
    elif text[0] == "":
        text = text[1:]

    if text[-1] in ("'s", "s", "th", "nd", "st", "rd") and text[-2].isdigit():
        text[-2] = text[-2] + text[-1]
        text = text[:-1]

    new_text = []
    for chunk in text:
        if chunk.isdigit() and len(chunk) < 5:
            if len(chunk) > 2 and chunk[-2] == "0":
                if chunk[-1] == "0":
                    parts = [chunk]
                else:
                    parts = [chunk[:-3], chunk[-2], chunk[-1]]
            elif len(chunk) % 2 == 0:
                parts = [chunk[i:i + 2] for i in range(0, len(chunk), 2)]
            elif len(chunk) > 2:
                parts = [chunk[0]] + [chunk[i:i + 2]
                                      for i in range(1, len(chunk), 2)]
            else:
                parts = [chunk]
            new_text.extend(parts)
        else:
            new_text.append(chunk)
    return " ".join(new_text)


def _expand_hardware(m):
    quantity, measure = m.groups(0)
    measure = _HARDWARE_KEY[measure.lower()]
    if measure[-1] != "z" and float(quantity.replace(",", "")) > 1:
        return "{} {}s".format(quantity, measure)
    return "{} {}".format(quantity, measure)


def _expand_dimension(m):
    text = "".join([x for x in m.groups(0) if x != 0])
    text = text.replace(" x ", " by ")
    text = text.replace("x", " by ")
    if text.endswith(tuple(_DIMENSION_KEY.keys())):
        if text[-2].isdigit():
            text = "{} {}".format(text[:-1], _DIMENSION_KEY[text[-1:]])
        elif text[-3].isdigit():
            text = "{} {}".format(text[:-2], _DIMENSION_KEY[text[-2:]])
    return text


def normalize_letters_and_numbers(text):
    text = re.sub(_hardware_re, _expand_hardware, text)
    text = re.sub(_dimension_re, _expand_dimension, text)
    text = re.sub(_letters_and_numbers_re, _expand_letters_and_numbers, text)
    return text
