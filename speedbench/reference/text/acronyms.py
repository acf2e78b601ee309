"""Acronym -> spelled-letter ARPAbet expansion (parity with reference
tts_text_processing/acronyms.py:4-68)."""

import re

LETTER_TO_ARPABET = {
    "A": "EY1", "B": "B IY1", "C": "S IY1", "D": "D IY1", "E": "IY1",
    "F": "EH1 F", "G": "JH IY1", "H": "EY1 CH", "I": "AY1", "J": "JH EY1",
    "K": "K EY1", "L": "EH1 L", "M": "EH1 M", "N": "EH1 N", "O": "OW1",
    "P": "P IY1", "Q": "K Y UW1", "R": "AA1 R", "S": "EH1 S", "T": "T IY1",
    "U": "Y UW1", "V": "V IY1", "X": "EH1 K S", "Y": "W AY1",
    "W": "D AH1 B AH0 L Y UW0", "Z": "Z IY1", "s": "Z",
}

_acronym_re = re.compile(r"([A-Z][A-Z]+)s?")


class AcronymNormalizer:
    def __init__(self, phoneme_dict):
        self.phoneme_dict = phoneme_dict

    def __call__(self, text):
        def _expand(m):
            acronym = re.sub(r"\.", "", m.group(0))
            acronym = "".join(acronym.split())
            arpabet = self.phoneme_dict.lookup(acronym)
            if arpabet is None:
                letters = list(acronym)
                spelled = ["{" + LETTER_TO_ARPABET[c] + "}" for c in letters]
                if spelled[-1] == "{Z}" and len(spelled) > 1:
                    spelled[-2] = (spelled[-2][:-1] + " " + spelled[-1][1:])
                    del spelled[-1]
                return " ".join(spelled)
            if len(arpabet) == 1:
                return "{" + arpabet[0] + "}"
            return acronym

        return re.sub(_acronym_re, _expand, text)
