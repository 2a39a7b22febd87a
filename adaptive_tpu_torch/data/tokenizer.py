"""Caption tokenization for vocabulary building and training data.

Reference parity: the reference tokenizes captions with
``nltk.tokenize.word_tokenize(caption.lower())`` and drops single-character
punctuation tokens (reference code_src/data/build_vocab.py:37,
code_src/data/data_loader.py:51). NLTK's word_tokenize is the Treebank word
tokenizer applied per sentence; captions are single sentences, so the
data-free ``TreebankWordTokenizer`` reproduces it. A clean-room regex
fallback with the same core rules is used if NLTK is unavailable.

The PyTorch port's own copy of adaptive_tpu/data/tokenizer.py: the same
code, so the port scores captions without importing the JAX package.
"""

from __future__ import annotations

import re
import string
from typing import List

_PUNCT = set(string.punctuation)

try:  # pure-regex tokenizer, needs no downloaded data
    from nltk.tokenize import TreebankWordTokenizer

    _TREEBANK = TreebankWordTokenizer()
except Exception:  # pragma: no cover - nltk is normally present
    _TREEBANK = None


# Clean-room Treebank-style rules (subset sufficient for lowercased captions):
# split off punctuation, keep contractions as separate 's / n't / 're etc.
_CONTRACTIONS = re.compile(r"(?i)\b(\w+)(n't)\b")
_POSSESSIVE = re.compile(r"(?i)(\w)('s|'re|'ve|'ll|'d|'m|')(?=\s|$)")
_WORD_RE = re.compile(r"\w+|[^\w\s]")


def _fallback_tokenize(text: str) -> List[str]:
    text = _CONTRACTIONS.sub(r"\1 \2", text)
    text = _POSSESSIVE.sub(r"\1 \2", text)
    return _WORD_RE.findall(text)


# Sentence splitting before Treebank tokenization. NLTK's word_tokenize (the
# reference's tokenizer, build_vocab.py:37) is sent_tokenize + Treebank per
# sentence; the Treebank rules split only the LAST period of their input, so
# without a splitter the internal sentence-final periods of multi-sentence
# captions stay glued to words ("a man. a dog") — CoreNLP's PTBTokenizer
# splits them. punkt data is unavailable; this clean-room splitter covers
# caption-style text: split after ". " unless the preceding word is a known
# abbreviation, a single initial, or contains an internal dot (acronym).
_ABBREVS = {
    "mr", "mrs", "ms", "dr", "st", "no", "vs", "jr", "sr", "etc", "inc",
    "prof", "gen", "rep", "sen", "ft", "mt", "capt", "col", "lt", "sgt",
    "ave", "blvd", "dept", "est", "fig", "hon", "misc", "sq",
}


def split_sentences(text: str) -> List[str]:
    out, start = [], 0
    for m in re.finditer(r"\.(?=\s|$)", text):
        i = m.start()
        j = i
        while j > 0 and (text[j - 1].isalnum() or text[j - 1] in ".'"):
            j -= 1
        prev = text[j:i].lower()
        if prev in _ABBREVS or (len(prev) == 1 and prev.isalpha()) or "." in prev:
            continue
        out.append(text[start:m.end()])
        start = m.end()
    out.append(text[start:])
    return [s for s in (x.strip() for x in out) if s]


def sentence_word_tokens(sent: str) -> List[str]:
    """Treebank tokenization of ONE sentence (no sentence splitting)."""
    return _TREEBANK.tokenize(sent) if _TREEBANK is not None else _fallback_tokenize(sent)


def word_tokenize(text: str) -> List[str]:
    """Treebank-style word tokenization over clean-room sentence splits."""
    toks: List[str] = []
    for sent in split_sentences(text):
        toks.extend(sentence_word_tokens(sent))
    return toks


def caption_tokenize(caption: str) -> List[str]:
    """Lowercase, tokenize, drop punctuation tokens (build_vocab.py:37)."""
    return [w for w in word_tokenize(str(caption).lower()) if w not in _PUNCT]
