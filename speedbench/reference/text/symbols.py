"""Symbol inventories for text encoding (parity with reference
tts_text_processing/symbols.py:11-58; the 'radtts' set has 185 symbols,
matching model_config n_text=185)."""

ARPABET = [
    'AA', 'AA0', 'AA1', 'AA2', 'AE', 'AE0', 'AE1', 'AE2', 'AH', 'AH0', 'AH1',
    'AH2', 'AO', 'AO0', 'AO1', 'AO2', 'AW', 'AW0', 'AW1', 'AW2', 'AY', 'AY0',
    'AY1', 'AY2', 'B', 'CH', 'D', 'DH', 'EH', 'EH0', 'EH1', 'EH2', 'ER',
    'ER0', 'ER1', 'ER2', 'EY', 'EY0', 'EY1', 'EY2', 'F', 'G', 'HH', 'IH',
    'IH0', 'IH1', 'IH2', 'IY', 'IY0', 'IY1', 'IY2', 'JH', 'K', 'L', 'M', 'N',
    'NG', 'OW', 'OW0', 'OW1', 'OW2', 'OY', 'OY0', 'OY1', 'OY2', 'P', 'R',
    'S', 'SH', 'T', 'TH', 'UH', 'UH0', 'UH1', 'UH2', 'UW', 'UW0', 'UW1',
    'UW2', 'V', 'W', 'Y', 'Z', 'ZH',
]


def get_symbols(symbol_set):
    arpabet = ["@" + s for s in ARPABET]
    if symbol_set == "english_basic":
        pad = "_"
        punctuation = "!'\"(),.:;? "
        special = "-"
        letters = ("ABCDEFGHIJKLMNOPQRSTUVWXYZ"
                   "abcdefghijklmnopqrstuvwxyz")
        return list(pad + special + punctuation + letters) + arpabet
    if symbol_set == "english_basic_lowercase":
        pad = "_"
        punctuation = "!'\"(),.:;? "
        special = "-"
        letters = "abcdefghijklmnopqrstuvwxyz"
        return list(pad + special + punctuation + letters) + arpabet
    if symbol_set == "english_expanded":
        punctuation = "!'\",.:;? "
        math = "#%&*+-/[]()"
        special = "_@©°½—₩€$"
        accented = "áçéêëñöøćž"
        letters = ("ABCDEFGHIJKLMNOPQRSTUVWXYZ"
                   "abcdefghijklmnopqrstuvwxyz")
        return (list(punctuation + math + special + accented + letters)
                + arpabet)
    if symbol_set == "radtts":
        punctuation = "!'\",.:;? "
        math = "#%&*+-/[]()"
        special = "_@©°½—₩€$"
        accented = "áçéêëñöøćž"
        numbers = "0123456789"
        letters = ("ABCDEFGHIJKLMNOPQRSTUVWXYZ"
                   "abcdefghijklmnopqrstuvwxyz")
        return (list(punctuation + math + special + accented + numbers
                     + letters) + arpabet)
    raise ValueError(f"{symbol_set} symbol set does not exist")
