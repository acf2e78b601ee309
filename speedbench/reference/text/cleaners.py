"""Cleaner pipelines (behavior parity with reference
tts_text_processing/cleaners.py:78-115): sequence-level functions followed by
per-token word functions, skipping {arpabet} literals, then a final
space-before-punctuation cleanup."""

import re
from functools import reduce
from string import punctuation

from speedbench.reference.text.normalize import (normalize_abbreviations,
                                       normalize_currency,
                                       normalize_datestime,
                                       normalize_letters_and_numbers,
                                       normalize_numbers)
from speedbench.reference.text.translit import transliterate

_whitespace_re = re.compile(r"\s+")
_arpa_re = re.compile(r"{[^}]+}|\S+")


def lowercase(text):
    return text.lower()


def collapse_whitespace(text):
    return re.sub(_whitespace_re, " ", text)


def remove_space_before_punctuation(text):
    return re.sub(r"\s([{}](?:\s|$))".format(punctuation), r"\1", text)


class Cleaner:
    def __init__(self, cleaner_names, phonemedict):
        self.cleaner_names = cleaner_names
        self.phonemedict = phonemedict

    def __call__(self, text):
        for cleaner_name in self.cleaner_names:
            sequence_fns, word_fns = self._get_fns(cleaner_name)
            for fn in sequence_fns:
                text = fn(text)
            tokens = [reduce(lambda x, f: f(x), word_fns, tok)
                      if tok[0] != "{" else tok
                      for tok in _arpa_re.findall(text)]
            text = " ".join(tokens)
        return remove_space_before_punctuation(text)

    def _get_fns(self, cleaner_name):
        if cleaner_name == "basic_cleaners":
            return [lowercase, collapse_whitespace], []
        if cleaner_name == "english_cleaners":
            return ([collapse_whitespace, transliterate, lowercase],
                    [normalize_numbers, normalize_abbreviations])
        if cleaner_name == "radtts_cleaners":
            return ([collapse_whitespace, normalize_currency,
                     normalize_datestime, normalize_letters_and_numbers],
                    [normalize_numbers, normalize_abbreviations])
        if cleaner_name == "transliteration_cleaners":
            return [transliterate, lowercase, collapse_whitespace], []
        raise ValueError(f"{cleaner_name} cleaner not supported")
