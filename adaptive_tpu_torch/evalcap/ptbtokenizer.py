"""PTB-style tokenizer for caption scoring — clean-room, no Java.

Reference parity: coco/pycocoevalcap/tokenizer/ptbtokenizer.py:24-69 shells
out to the Stanford CoreNLP PTBTokenizer jar (a missing large blob,
.MISSING_LARGE_BLOBS:4) with -preserveLines -lowerCase, then removes a fixed
punctuation list. Here: lowercase + Treebank-rule tokenization (NLTK's
data-free TreebankWordTokenizer, or a regex fallback) + PTB bracket escaping
+ the same punctuation-drop list. Caption text is simple enough that this
matches CoreNLP's output for MS-COCO-style sentences.

The PyTorch port's own copy of adaptive_tpu/evalcap/ptbtokenizer.py: the
same code, so the port scores captions without importing the JAX package.
"""

from __future__ import annotations

from typing import Dict, List

from adaptive_tpu_torch.data.tokenizer import sentence_word_tokens, split_sentences

# ptbtokenizer.py:21-22
PUNCTUATIONS = [
    "''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
    ".", "?", "!", ",", ":", "-", "--", "...", ";",
]
_PUNCT_SET = set(PUNCTUATIONS)

# CoreNLP ptb3Escaping maps brackets to PTB symbols; the round (-LRB-/-RRB-)
# and curly (-LCB-/-RCB-) escapes are in the drop list above, the square ones
# (-LSB-/-RSB-) are NOT — they survive in the reference pipeline and here.
_BRACKETS = {"(": "-LRB-", ")": "-RRB-", "{": "-LCB-", "}": "-RCB-", "[": "-LSB-", "]": "-RSB-"}

# CoreNLP emits an opening single quote as its own ` token (dropped by the
# list); NLTK's Treebank rules leave it glued to the next word ("'red").
# Split it off here — except before clitic words PTB treats as contractions.
import re

_OPEN_SQUOTE = re.compile(r"(?<!\w)'(?=[A-Za-z])(?!(?:tis|twas|em|til|till|cause|n)\b)")


class PTBTokenizer:
    """Drop-in replacement for the jar-backed tokenizer (same dict protocol)."""

    def tokenize(self, captions_for_image: Dict) -> Dict:
        """{img_id: [{'caption': str}, ...]} -> {img_id: [tokenized_str, ...]}."""
        out: Dict = {}
        for k, caps in captions_for_image.items():
            out[k] = [tokenize_caption(c["caption"]) for c in caps]
        return out


def tokenize_caption(caption: str) -> str:
    text = str(caption).replace("\n", " ").lower()
    text = _OPEN_SQUOTE.sub("' ", text)
    toks = []
    for sent in split_sentences(text):
        st = sentence_word_tokens(sent)
        # CoreNLP keeps a sentence-final acronym's period ON the token and
        # emits the terminator separately ("the u.s." -> "u.s." + "."), so
        # after the drop list the token is "u.s." whether it ends a sentence
        # or not; Treebank's final-period rule strips it ("u.s" + "."), which
        # made the SAME word tokenize differently by position — not score-
        # neutral across gts/res (tests/test_ptb_differential.py::
        # test_acronym_cross_position_*). Reattach for dotted LETTER
        # acronyms only: CoreNLP's abbreviation class covers "u.s." but NOT
        # decimals — "1.30." tokenizes as "1.30" + "." in every position, so
        # reattaching digits would reintroduce the cross-position mismatch
        # for numbers. Plain words ("a man .") are unaffected. Vocab building
        # (data/tokenizer.py) keeps NLTK word_tokenize semantics — this is
        # scoring-path only.
        if (len(st) >= 2 and st[-1] == "." and "." in st[-2]
                and any(c.isalpha() for c in st[-2])
                and all(c.isalpha() or c == "." for c in st[-2])):
            st[-2] += "."
        toks.extend(st)
    toks = [_BRACKETS.get(t, t) for t in toks]
    return " ".join(t for t in toks if t not in _PUNCT_SET)
