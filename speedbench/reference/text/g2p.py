"""Grapheme-to-phoneme dictionary over CMUdict-format files (parity with
reference tts_text_processing/grapheme_dictionary.py:7-36)."""

import re

_alt_re = re.compile(r"\([0-9]+\)")


class G2PDictionary:
    def __init__(self, file_or_path, keep_ambiguous=True, encoding="latin-1"):
        entries = {}
        with open(file_or_path, encoding=encoding) as f:
            for line in f:
                if len(line) and ("A" <= line[0] <= "Z" or line[0] == "'"):
                    parts = line.split("  ")
                    word = re.sub(_alt_re, "", parts[0])
                    pron = parts[1].strip()
                    entries.setdefault(word, []).append(pron)
        if not keep_ambiguous:
            entries = {w: p for w, p in entries.items() if len(p) == 1}
        self._entries = entries

    def __len__(self):
        return len(self._entries)

    def lookup(self, word):
        return self._entries.get(word.upper())
