"""Vocabulary: word <-> id mapping with special tokens.

Reference parity: code_src/data/build_vocab.py:9-65 — a pickled Vocabulary
with insertion-ordered ids, specials ``<pad>=0, <start>=1, <end>=2, <unk>=3``
(build_vocab.py:47-51), min-count threshold 5 (cfg_wzn.py:94), producing
10,123 words on the Karpathy train split (statics:1). This rebuild stores the
vocab as JSON (portable, no pickle) but can also read the reference's
vocab.pkl for checkpoint-fidelity runs.

The PyTorch port's own copy of adaptive_tpu/data/vocab.py: the same code, so
the port scores captions without importing the JAX package. Its pipeline
stage ``main_build_vocab`` reads the captions through the COCO API only (the
JAX package's native JSON scanner is not ported; both read the same captions
in the same order).
"""

from __future__ import annotations

import json
import os
from collections import Counter
from typing import Dict, Iterable, List, Optional

from adaptive_tpu_torch.data.tokenizer import caption_tokenize

PAD, START, END, UNK = "<pad>", "<start>", "<end>", "<unk>"
PAD_ID, START_ID, END_ID, UNK_ID = 0, 1, 2, 3
SPECIALS = [PAD, START, END, UNK]


class Vocabulary:
    """Insertion-ordered word<->id map (build_vocab.py:9-28)."""

    def __init__(self, words: Optional[Iterable[str]] = None):
        self.word2idx: Dict[str, int] = {}
        self.idx2word: Dict[int, str] = {}
        if words is not None:
            for w in words:
                self.add_word(w)

    def add_word(self, word: str) -> int:
        if word not in self.word2idx:
            idx = len(self.word2idx)
            self.word2idx[word] = idx
            self.idx2word[idx] = word
        return self.word2idx[word]

    def __call__(self, word: str) -> int:
        return self.word2idx.get(word, self.word2idx[UNK])

    def __contains__(self, word: str) -> bool:
        return word in self.word2idx

    def __len__(self) -> int:
        return len(self.word2idx)

    # -------------------------------------------------------------- encoding
    def encode_caption(self, caption: str) -> List[int]:
        """<start> + token ids + <end> (data_loader.py:51-56)."""
        ids = [self(START)]
        ids.extend(self(t) for t in caption_tokenize(caption))
        ids.append(self(END))
        return ids

    def decode_ids(self, ids: Iterable[int], stop_at_end: bool = True) -> str:
        """Join words, cutting at <end> (tools/utils.py:185-192)."""
        words = []
        for i in ids:
            w = self.idx2word[int(i)]
            if stop_at_end and w == END:
                break
            words.append(w)
        return " ".join(words)

    # ------------------------------------------------------------------- io
    def save(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump({"words": [self.idx2word[i] for i in range(len(self))]}, f)

    @classmethod
    def load(cls, path: str) -> "Vocabulary":
        if path.endswith(".pkl"):
            return cls._load_reference_pickle(path)
        with open(path) as f:
            data = json.load(f)
        return cls(data["words"])

    @classmethod
    def _load_reference_pickle(cls, path: str) -> "Vocabulary":
        """Read the reference's pickled Vocabulary (code_src/data/vocab.pkl)."""
        import pickle

        class _Shim:
            # The reference pickle references code_src.data.build_vocab.Vocabulary;
            # map it onto a plain namespace and copy the dicts out.
            def __setstate__(self, state):
                self.__dict__.update(state)

        class _Unpickler(pickle.Unpickler):
            def find_class(self, module, name):
                if name == "Vocabulary":
                    return _Shim
                return super().find_class(module, name)

        with open(path, "rb") as f:
            obj = _Unpickler(f).load()
        v = cls()
        idx2word = {int(k): w for k, w in obj.idx2word.items()}
        for i in range(len(idx2word)):
            v.add_word(idx2word[i])
        return v


def build_vocab(annotations: Iterable[str], threshold: int) -> Vocabulary:
    """Count tokens over captions, keep count >= threshold (build_vocab.py:30-56).

    Word order matches the reference: specials first, then words in first-seen
    (Counter insertion) order filtered by threshold.
    """
    counter: Counter = Counter()
    for caption in annotations:
        counter.update(caption_tokenize(caption))
    words = [w for w, c in counter.items() if c >= threshold]
    v = Vocabulary(SPECIALS)
    for w in words:
        v.add_word(w)
    return v


def main_build_vocab(cf) -> Vocabulary:
    """Pipeline stage: build the vocab from the train split and save it
    (build_vocab.py:58-65). The captions come through the COCO API in the
    annotations' order, the order the JAX package's native scanner reads
    them in too (adaptive_tpu/data/vocab.py:125-144)."""
    from adaptive_tpu_torch.data.coco_api import COCO

    coco = COCO(cf.train_anno_path)
    vocab = build_vocab((coco.anns[a]["caption"] for a in coco.anns), cf.vocab_threshold)
    vocab.save(cf.vocab_path)
    print("Total vocabulary size: %d" % len(vocab))
    print("Saved the vocabulary wrapper to '%s'" % cf.vocab_path)
    return vocab
