#!/usr/bin/env python
"""Build METEOR synonym/paraphrase tables from real lexical data, for the
PyTorch port (counterpart of tools/meteor_tables.py).

The reference's meteor-1.5.jar reads WordNet and paraphrase-en.gz, both
missing large blobs in its checkout, so the shipped starter tables in
adaptive_tpu_torch/evalcap/data/ are curated caption-domain stand-ins. This
tool converts the two formats such data actually arrives in into the
plain-text tables adaptive_tpu_torch.evalcap.meteor.MatchTables loads. It
runs on the host only and imports neither JAX nor the JAX package; its
tables are byte for byte the JAX tool's (tests/test_torch_repo_tools.py).

Subcommands:

  wordnet      Parse a WordNet 3.x `dict/` directory (data.noun, data.verb,
               data.adj, data.adv — the standard Princeton distribution
               layout) into a synset-per-line synonym table. Multi-word
               lemmas and adjective syntactic markers (`(p)`, `(a)`, `(ip)`)
               are handled; synsets with fewer than two distinct single-word
               members are dropped (they can never produce a match).

  paraphrase   Parse a `|||`-separated paraphrase file — PPDB releases
               (`[POS] ||| phrase ||| paraphrase ||| features ||| align`),
               meteor-style (`prob ||| phrase ||| paraphrase`), or the plain
               `phrase ||| paraphrase` format — into the symmetric
               paraphrase table. Field layout is auto-detected per line;
               `--min-score` filters on PPDB2.0Score / the leading
               probability when one is present.

Usage:
  python tools/torch_meteor_tables.py wordnet --dict-dir /path/to/WordNet-3.0/dict \
      -o synonyms.txt
  python tools/torch_meteor_tables.py paraphrase --input ppdb-2.0-s-all.gz \
      --min-score 3.0 -o paraphrases.txt
  ADAPTIVE_TPU_METEOR_SYNONYMS=synonyms.txt \
  ADAPTIVE_TPU_METEOR_PARAPHRASES=paraphrases.txt python -m adaptive_tpu_torch.main -c ...

Both inputs may be .gz. Output format is documented in
adaptive_tpu_torch/evalcap/meteor.py (MatchTables docstring). The tables'
header names tools/meteor_tables.py, as the JAX tool writes it, so that both
tools give the same bytes.
"""

from __future__ import annotations

import argparse
import os
import re
import sys
from typing import Iterable, List, Optional, Sequence, Set, Tuple

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from adaptive_tpu_torch.evalcap.meteor import _open_maybe_gz  # shared .gz handling

# WordNet lemma sanity: lowercase letters, digits, internal hyphen/apostrophe
# (PTB-tokenized captions never contain underscores or uppercase).
_WORD_RE = re.compile(r"^[a-z][a-z0-9'\-.]*$")
# Adjective syntactic position markers: lemma(p) / lemma(a) / lemma(ip).
_ADJ_MARKER_RE = re.compile(r"\((p|a|ip)\)$")

WORDNET_DATA_FILES = ("data.noun", "data.verb", "data.adj", "data.adv")


def parse_wordnet_data(lines: Iterable[str], pos_tag: str = "") -> List[List[str]]:
    """Parse one WordNet `data.*` file into a list of synsets (word lists).

    Line format (WordNet 3.x docs, wndb(5)):
      synset_offset lex_filenum ss_type w_cnt word lex_id [word lex_id...] ...
    w_cnt is two hex digits; words alternate with one-hex-digit lex ids.
    License-header lines begin with whitespace and are skipped. Multi-word
    collocations (underscored lemmas) are skipped — METEOR's synonymy stage
    matches single words only (phrases belong in the paraphrase table).
    """
    synsets: List[List[str]] = []
    for line in lines:
        if not line or line[0].isspace():
            continue  # copyright header block
        toks = line.split()
        if len(toks) < 6:
            continue
        try:
            w_cnt = int(toks[3], 16)
        except ValueError:
            continue
        words = []
        for k in range(w_cnt):
            idx = 4 + 2 * k
            if idx >= len(toks):
                break
            w = _ADJ_MARKER_RE.sub("", toks[idx]).lower()
            if "_" in w or not _WORD_RE.match(w):
                continue
            if w not in words:
                words.append(w)
        if len(words) >= 2:
            synsets.append(words)
    return synsets


def convert_wordnet(dict_dir: str, out_path: str) -> int:
    """Convert a WordNet dict/ directory to a synonym table. Returns the
    number of synsets written."""
    found = [f for f in WORDNET_DATA_FILES if os.path.exists(os.path.join(dict_dir, f))]
    if not found:
        raise FileNotFoundError(
            f"no WordNet data files ({'/'.join(WORDNET_DATA_FILES)}) in {dict_dir!r}"
        )
    synsets: List[List[str]] = []
    for fname in found:
        with open(os.path.join(dict_dir, fname), encoding="utf-8", errors="replace") as f:
            synsets.extend(parse_wordnet_data(f, fname.split(".")[-1]))
    with open(out_path, "w", encoding="utf-8") as out:
        out.write(
            "# METEOR synonym table generated by tools/meteor_tables.py\n"
            f"# Source: WordNet dict dir {dict_dir} ({', '.join(found)})\n"
            "# Format: one synset per line, space-separated members.\n"
        )
        for words in synsets:
            out.write(" ".join(words) + "\n")
    return len(synsets)


_PPDB_SCORE_RE = re.compile(r"\bPPDB(?:2\.0)?Score=([-0-9.eE+]+)")


def _parse_paraphrase_line(line: str) -> Optional[Tuple[str, str, Optional[float]]]:
    """Auto-detect one `|||` line's layout → (phrase, paraphrase, score|None)."""
    parts = [p.strip() for p in line.split("|||")]
    if len(parts) < 2:
        return None
    score: Optional[float] = None
    if parts[0].startswith("[") and len(parts) >= 3:
        # PPDB: [POS] ||| phrase ||| paraphrase ||| features ||| alignment
        a, b = parts[1], parts[2]
        for field in parts[3:]:
            m = _PPDB_SCORE_RE.search(field)
            if m:
                score = float(m.group(1))
                break
    elif len(parts) >= 3:
        try:
            # meteor-style: prob ||| phrase ||| paraphrase
            score = float(parts[0])
            a, b = parts[1], parts[2]
        except ValueError:
            # plain: phrase ||| paraphrase [||| score]
            a, b = parts[0], parts[1]
            try:
                score = float(parts[2])
            except ValueError:
                pass
    else:
        # exactly two fields is always plain layout — a numeric left-hand
        # phrase ("12 ||| dozen") must not be mistaken for a meteor-style
        # probability column and dropped
        a, b = parts[0], parts[1]
    return a, b, score


def _clean_phrase(p: str, lowercase: bool) -> Optional[str]:
    if lowercase:
        p = p.lower()
    words = p.split()
    if not words or not all(_WORD_RE.match(w) for w in words):
        return None
    return " ".join(words)


def parse_paraphrase_lines(
    lines: Iterable[str],
    min_score: Optional[float] = None,
    max_words: int = 4,
    lowercase: bool = True,
) -> List[Tuple[str, str]]:
    """Parse a paraphrase file into unique (phrase, paraphrase) pairs.

    Pairs are canonicalized (sorted) for dedup; MatchTables.load applies
    them symmetrically anyway. Scoreless lines pass any --min-score filter
    (the plain format carries no score to filter on)."""
    seen: Set[Tuple[str, str]] = set()
    out: List[Tuple[str, str]] = []
    for line in lines:
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parsed = _parse_paraphrase_line(line)
        if parsed is None:
            continue
        a, b, score = parsed
        if min_score is not None and score is not None and score < min_score:
            continue
        a = _clean_phrase(a, lowercase)
        b = _clean_phrase(b, lowercase)
        if not a or not b or a == b:
            continue
        if len(a.split()) > max_words or len(b.split()) > max_words:
            continue
        key = (a, b) if a <= b else (b, a)
        if key in seen:
            continue
        seen.add(key)
        out.append((a, b))
    return out


def convert_paraphrases(
    in_path: str,
    out_path: str,
    min_score: Optional[float] = None,
    max_words: int = 4,
    lowercase: bool = True,
) -> int:
    """Convert a PPDB/meteor/plain paraphrase file. Returns pairs written."""
    with _open_maybe_gz(in_path) as f:
        pairs = parse_paraphrase_lines(f, min_score, max_words, lowercase)
    with open(out_path, "w", encoding="utf-8") as out:
        out.write(
            "# METEOR paraphrase table generated by tools/meteor_tables.py\n"
            f"# Source: {in_path} (min_score={min_score}, max_words={max_words})\n"
            "# Format: `phrase ||| phrase` per line, applied symmetrically.\n"
        )
        for a, b in pairs:
            out.write(f"{a} ||| {b}\n")
    return len(pairs)


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    pw = sub.add_parser("wordnet", help="WordNet dict/ -> synonym table")
    pw.add_argument("--dict-dir", required=True,
                    help="WordNet dict directory containing data.noun etc.")
    pw.add_argument("-o", "--output", required=True)

    pp = sub.add_parser("paraphrase", help="PPDB/meteor file -> paraphrase table")
    pp.add_argument("--input", required=True, help="paraphrase source (.gz ok)")
    pp.add_argument("-o", "--output", required=True)
    pp.add_argument("--min-score", type=float, default=None,
                    help="drop pairs whose PPDB2.0Score / leading prob is below this "
                         "(scoreless lines always pass)")
    pp.add_argument("--max-words", type=int, default=4,
                    help="drop phrases longer than this many words (aligner span cap)")
    pp.add_argument("--keep-case", action="store_true",
                    help="do not lowercase (captions are lowercased; default lowers)")

    args = p.parse_args(argv)
    if args.cmd == "wordnet":
        n = convert_wordnet(args.dict_dir, args.output)
        print(f"wrote {n} synsets -> {args.output}")
    else:
        n = convert_paraphrases(args.input, args.output, args.min_score,
                                args.max_words, not args.keep_case)
        print(f"wrote {n} paraphrase pairs -> {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
