"""Long-text chunking for synthesis.

The reference synthesizes each input line as ONE utterance
(inference.py:115-156), so paragraph-length lines grow the mel/attention
tensors without bound. Here a long line is split at sentence boundaries
into chunks of at most `max_tokens` encoded symbols; the chunks ride the
batched inference path and their waveforms are concatenated with a short
silence. Splitting is text-level, so each chunk gets the normal
space/BOS/EOS wrapping and synthesizes exactly like a short line.
"""

import re

# sentence boundary = enders followed by whitespace (or end of text);
# '12:30', '3.14', 'example.com' are NOT boundaries
_BOUNDARY_RE = re.compile(r"[.!?;:]+(?=\s|$)")


def split_sentences(text):
    """Split into sentence-ish pieces, each keeping its trailing
    punctuation; whitespace between pieces is dropped. Implemented by
    slicing BETWEEN boundary matches so every character of `text` lands in
    exactly one piece — a match-the-pieces regex can silently drop spans
    around mid-token punctuation ('12:30', '3.14')."""
    pieces, start = [], 0
    for m in _BOUNDARY_RE.finditer(text):
        pieces.append(text[start:m.end()].strip())
        start = m.end()
    pieces.append(text[start:].strip())
    return [p for p in pieces if p]


def _split_word(word, encode_len, max_tokens):
    """Last resort for a single word whose encoding exceeds max_tokens
    (URL, run-on string): greedy character-level split so the documented
    <= max_tokens contract holds for any input."""
    parts, cur = [], ""
    for ch in word:
        if cur and encode_len(cur + ch) > max_tokens:
            parts.append(cur)
            cur = ch
        else:
            cur += ch
    if cur:
        parts.append(cur)
    return parts


def _split_words(piece, encode_len, max_tokens):
    """Fallback for a single sentence longer than max_tokens: greedy-pack
    words (character-splitting any single word that alone exceeds the
    budget)."""
    words = []
    for w in piece.split():
        if encode_len(w) > max_tokens:
            words.extend(_split_word(w, encode_len, max_tokens))
        else:
            words.append(w)
    chunks, cur = [], []
    for w in words:
        cand = " ".join(cur + [w])
        if cur and encode_len(cand) > max_tokens:
            chunks.append(" ".join(cur))
            cur = [w]
        else:
            cur.append(w)
    if cur:
        chunks.append(" ".join(cur))
    return chunks


def split_text_to_chunks(text, encode_len, max_tokens):
    """Split `text` into chunks whose encoded length (per `encode_len`,
    a callable str -> int) is <= max_tokens, preferring sentence
    boundaries, falling back to word boundaries inside oversized
    sentences. Returns [text] unchanged when it already fits."""
    if max_tokens <= 0 or encode_len(text) <= max_tokens:
        return [text]
    pieces = []
    for s in split_sentences(text):
        if encode_len(s) > max_tokens:
            pieces.extend(_split_words(s, encode_len, max_tokens))
        else:
            pieces.append(s)
    chunks, cur = [], ""
    for p in pieces:
        cand = (cur + " " + p).strip() if cur else p
        if cur and encode_len(cand) > max_tokens:
            chunks.append(cur)
            cur = p
        else:
            cur = cand
    if cur:
        chunks.append(cur)
    return chunks or [text]
