"""METEOR 1.5 — clean-room Python implementation (no Java), all 4 stages.

Reference parity note: the reference drives ``meteor-1.5.jar`` over a stdio
protocol (coco/pycocoevalcap/meteor/meteor.py:15-82), but the jar and its
paraphrase-en.gz table are missing large blobs (.MISSING_LARGE_BLOBS:2-3), so
the reference as-shipped cannot run METEOR either. This implements the
published Meteor 1.5 algorithm (Denkowski & Lavie 2014) with the English
defaults alpha=0.85, beta=0.2, gamma=0.6, delta=0.75 and the full 4-stage
matcher:

* exact (weight 1.0) and Porter stem (0.6) — always on;
* synonymy (0.8) and paraphrase (0.6) — activated by pluggable table files
  (`MatchTables`): the jar reads WordNet and paraphrase-en.gz, which are
  missing blobs here, so the stages run on whatever tables are installed.
  Synonym table: one synset per line (space-separated members; two words
  match if they share a synset; `#` comments allowed). Paraphrase table:
  `phrase ||| phrase [||| ignored]` per line, applied symmetrically; phrases
  match multi-word spans in the aligner. Table resolution
  (`default_tables()`, used by the COCOEvalCap production path):
  `ADAPTIVE_TPU_METEOR_SYNONYMS` / `ADAPTIVE_TPU_METEOR_PARAPHRASES` env
  paths if set (point these at real WordNet-derived data when available);
  otherwise the packaged curated starter tables in `evalcap/data/`
  (caption-domain, provenance documented in the files themselves);
  `ADAPTIVE_TPU_METEOR_TABLES=off` disables stages 3-4 entirely, leaving
  the deterministic exact+stem scorer.
* alignment resolution by beam search over match permutations with Meteor's
  comparator — maximize matched words, then minimize chunks, then maximize
  match weight, then minimize total position distance (the jar's Aligner
  semantics; NOT leftmost-greedy); phrase matches cover spans on both sides,
  one-to-one at word granularity.
* function-word discounting: content words weigh delta, function words
  (1-delta) in weighted precision/recall (the jar derives its list from
  corpus frequency > 1e-3; the closed-class list below is the derivable
  approximation);
* fragmentation penalty gamma * (chunks/m)^beta with m the mean covered
  word count over the two sides (equal to the matched-unigram count when all
  matches are word-to-word, i.e. identical to the 2-stage scorer on
  table-less input).

score = (1 - gamma * frag^beta) * P*R / (alpha*P + (1-alpha)*R),
max over references per image (the jar scores each ref and keeps the best).

The PyTorch port's own copy of adaptive_tpu/evalcap/meteor.py: the same
code, so the port scores captions without importing the JAX package.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple


def _fallback_stem(w: str) -> str:
    """Suffix stripper used where nltk's Porter stemmer cannot be imported."""
    for suf in ("ing", "ed", "es", "s"):
        if w.endswith(suf) and len(w) > len(suf) + 2:
            return w[: -len(suf)]
    return w


try:
    from nltk.stem.porter import PorterStemmer

    _STEM = PorterStemmer().stem
except Exception:  # pragma: no cover - nltk is optional, as in the JAX package
    _STEM = _fallback_stem

ALPHA, BETA, GAMMA, DELTA = 0.85, 0.2, 0.6, 0.75
WEIGHT_EXACT, WEIGHT_STEM, WEIGHT_SYN, WEIGHT_PARA = 1.0, 0.6, 0.8, 0.6
BEAM = 40  # the jar's default beam width

# Closed-class English words (approximates meteor-1.5's frequency-derived
# function.words list: articles, conjunctions, prepositions, pronouns,
# auxiliaries, common adverbial particles, clitics).
FUNCTION_WORDS = frozenset("""
a an the and or but nor if then than so because while although though
of in on at by for with from to into onto over under up down out off
about above across after against along among around before behind below
beneath beside between beyond during except inside near outside through
toward towards upon within without
is are was were be been being am do does did done doing have has had having
will would can could shall should may might must
it its he she his her hers him they them their theirs we us our ours you
your yours i me my mine this that these those there here who whom whose
which what when where why how
not no yes all any both each few more most other some such only own same
as too very just also
's 't 're 've 'll 'd 'm n't '
""".split())


class MatchTables:
    """Pluggable synonym/paraphrase data for stages 3-4.

    synonyms: {word: frozenset of synset ids} — two words are synonymous iff
    their synset-id sets intersect (WordNet semantics).
    paraphrases: {phrase: set of phrases} (symmetric), plus the max phrase
    length in words for the aligner's span enumeration.
    """

    def __init__(self, synonyms: Optional[Dict[str, frozenset]] = None,
                 paraphrases: Optional[Dict[str, set]] = None):
        self.synonyms = synonyms or {}
        self.paraphrases = paraphrases or {}
        self.max_phrase = max(
            (len(p.split()) for p in self.paraphrases), default=1
        )

    @classmethod
    def load(cls, synonyms_path: Optional[str] = None,
             paraphrases_path: Optional[str] = None) -> "MatchTables":
        syn: Dict[str, set] = {}
        if synonyms_path:
            with _open_maybe_gz(synonyms_path) as f:
                for sid, line in enumerate(f):
                    if line.lstrip().startswith("#"):
                        continue
                    members = line.split()
                    for w in members:
                        syn.setdefault(w, set()).add(sid)
        para: Dict[str, set] = {}
        if paraphrases_path:
            with _open_maybe_gz(paraphrases_path) as f:
                for line in f:
                    if line.lstrip().startswith("#"):
                        continue
                    parts = [p.strip() for p in line.split("|||")]
                    if len(parts) < 2 or not parts[0] or not parts[1]:
                        continue
                    a, b = parts[0], parts[1]
                    if a == b:
                        continue
                    para.setdefault(a, set()).add(b)
                    para.setdefault(b, set()).add(a)
        return cls({w: frozenset(s) for w, s in syn.items()}, para)

    def synonymous(self, a: str, b: str) -> bool:
        sa = self.synonyms.get(a)
        return bool(sa) and not sa.isdisjoint(self.synonyms.get(b, frozenset()))


def _open_maybe_gz(path: str):
    if path.endswith(".gz"):
        import gzip

        return gzip.open(path, "rt", encoding="utf-8")
    return open(path, encoding="utf-8")


_DEFAULT_TABLES_CACHE: List = []  # [Optional[MatchTables]] once resolved


def default_tables(refresh: bool = False) -> Optional["MatchTables"]:
    """Resolve the production synonym/paraphrase tables (cached).

    Priority: `ADAPTIVE_TPU_METEOR_TABLES=off|0|none` -> None (2-stage
    scorer); `ADAPTIVE_TPU_METEOR_SYNONYMS` / `ADAPTIVE_TPU_METEOR_PARAPHRASES`
    env paths -> load those (either alone is fine); otherwise the packaged
    curated starter tables under `evalcap/data/` (see the files' headers for
    provenance — they are caption-domain curations, not WordNet).
    """
    import os

    if _DEFAULT_TABLES_CACHE and not refresh:
        return _DEFAULT_TABLES_CACHE[0]
    _DEFAULT_TABLES_CACHE.clear()
    if os.environ.get("ADAPTIVE_TPU_METEOR_TABLES", "").lower() in ("off", "0", "none"):
        _DEFAULT_TABLES_CACHE.append(None)
        return None
    data_dir = os.path.join(os.path.dirname(__file__), "data")
    syn = os.environ.get("ADAPTIVE_TPU_METEOR_SYNONYMS")
    para = os.environ.get("ADAPTIVE_TPU_METEOR_PARAPHRASES")
    if not syn and not para:
        syn = os.path.join(data_dir, "meteor_synonyms.txt")
        para = os.path.join(data_dir, "meteor_paraphrases.txt")
        if not os.path.exists(syn):
            syn = None
        if not os.path.exists(para):
            para = None
    tables = MatchTables.load(syn, para) if (syn or para) else None
    _DEFAULT_TABLES_CACHE.append(tables)
    return tables


# (hyp_start, hyp_len, ref_start, ref_len, stage weight)
Match = Tuple[int, int, int, int, float]


def _candidates(
    hyp: Sequence[str], ref: Sequence[str], tables: Optional[MatchTables]
) -> List[List[Match]]:
    """Per hyp start position: possible span matches, tagged by the
    highest-priority stage that produces them (exact > stem > synonym >
    paraphrase, the jar's stage order)."""
    sh = [_STEM(w) for w in hyp]
    sr = [_STEM(w) for w in ref]
    out: List[List[Match]] = []
    for i, w in enumerate(hyp):
        row: List[Match] = []
        for j, r in enumerate(ref):
            if w == r:
                row.append((i, 1, j, 1, WEIGHT_EXACT))
            elif sh[i] == sr[j]:
                row.append((i, 1, j, 1, WEIGHT_STEM))
            elif tables is not None and tables.synonymous(w, r):
                row.append((i, 1, j, 1, WEIGHT_SYN))
        out.append(row)
    if tables is not None and tables.paraphrases:
        taken = [{(m[2], m[3]) for m in row} for row in out]
        for i in range(len(hyp)):
            for hl in range(1, min(tables.max_phrase, len(hyp) - i) + 1):
                phrase = " ".join(hyp[i : i + hl])
                for other in tables.paraphrases.get(phrase, ()):
                    ow = other.split()
                    for j in _find_spans(ref, ow):
                        if hl == 1 and len(ow) == 1 and (j, 1) in taken[i]:
                            continue  # a higher stage already covers this pair
                        out[i].append((i, hl, j, len(ow), WEIGHT_PARA))
    return out


def _find_spans(ref: Sequence[str], words: List[str]) -> Iterable[int]:
    n = len(words)
    for j in range(len(ref) - n + 1):
        if list(ref[j : j + n]) == words:
            yield j


class _State:
    __slots__ = ("rmask", "hmask", "prev", "chunks", "mh", "mr", "wsum", "dist", "matches")

    def __init__(self, rmask, hmask, prev, chunks, mh, mr, wsum, dist, matches):
        self.rmask = rmask      # bitmask of used ref positions
        self.hmask = hmask      # bitmask of used hyp positions
        self.prev = prev        # last match (hyp_end, ref_end) or None
        self.chunks = chunks
        self.mh = mh            # covered hyp words
        self.mr = mr            # covered ref words
        self.wsum = wsum        # sum of (stage weight x covered words)
        self.dist = dist        # sum |hyp_start - ref_start| over matches
        self.matches = matches  # tuple of Match

    def key(self):
        # Meteor's alignment comparator: most matched words, fewest chunks,
        # highest stage weight, smallest distance.
        return (-(self.mh + self.mr), self.chunks, -self.wsum, self.dist)


def _align(
    hyp: Sequence[str], ref: Sequence[str], tables: Optional[MatchTables] = None
) -> List[Match]:
    """One-to-one span alignment via beam search (the jar's Aligner
    semantics). Word-granular coverage: every hyp/ref word is covered by at
    most one match; phrase matches cover whole spans on both sides."""
    cands = _candidates(hyp, ref, tables)
    beam = [_State(0, 0, None, 0, 0, 0, 0.0, 0, ())]
    for i in range(len(hyp)):
        nxt = list(beam)  # leaving hyp[i] unmatched keeps the state as-is
        for st in beam:
            if st.hmask >> i & 1:
                continue  # already covered by an earlier phrase match
            for (hs, hl, rs, rl, w) in cands[i]:
                rbits = ((1 << rl) - 1) << rs
                hbits = ((1 << hl) - 1) << hs
                if st.rmask & rbits or st.hmask & hbits:
                    continue
                contiguous = st.prev == (hs, rs)
                nxt.append(
                    _State(
                        st.rmask | rbits,
                        st.hmask | hbits,
                        (hs + hl, rs + rl),
                        st.chunks + (0 if contiguous else 1),
                        st.mh + hl,
                        st.mr + rl,
                        st.wsum + w * (hl + rl) / 2.0,
                        st.dist + abs(hs - rs),
                        st.matches + ((hs, hl, rs, rl, w),),
                    )
                )
        nxt.sort(key=_State.key)
        beam = nxt[:BEAM]
    return list(beam[0].matches)


def _chunks(matches: List[Match]) -> int:
    """Number of maximal runs contiguous in both hyp and ref order."""
    if not matches:
        return 0
    ms = sorted(matches)
    ch = 1
    for (h0, hl0, r0, rl0, _), (h1, _, r1, _, _) in zip(ms, ms[1:]):
        if h1 != h0 + hl0 or r1 != r0 + rl0:
            ch += 1
    return ch


def _coverage(matches: List[Match], side: int) -> Dict[int, float]:
    """{word index: stage weight} for one side (0 = hyp, 1 = ref)."""
    cov: Dict[int, float] = {}
    for (hs, hl, rs, rl, w) in matches:
        start, length = (hs, hl) if side == 0 else (rs, rl)
        for k in range(start, start + length):
            cov[k] = w
    return cov


def _weighted_side(words: Sequence[str], idx_weights: Dict[int, float]) -> Tuple[float, float]:
    """(weighted matched mass, weighted total mass) with delta-discounted
    function words, for one side (hyp or ref)."""
    content_total = sum(1 for w in words if w not in FUNCTION_WORDS)
    function_total = len(words) - content_total
    mc = sum(w for i, w in idx_weights.items() if words[i] not in FUNCTION_WORDS)
    mf = sum(w for i, w in idx_weights.items() if words[i] in FUNCTION_WORDS)
    matched = DELTA * mc + (1 - DELTA) * mf
    total = DELTA * content_total + (1 - DELTA) * function_total
    return matched, total


def sentence_meteor(
    hyp_str: str, ref_str: str, tables: Optional[MatchTables] = None
) -> float:
    hyp, ref = hyp_str.split(), ref_str.split()
    if not hyp or not ref:
        return 0.0
    matches = _align(hyp, ref, tables)
    if not matches:
        return 0.0
    cov_h = _coverage(matches, 0)
    cov_r = _coverage(matches, 1)
    mh, th = _weighted_side(hyp, cov_h)
    mr, tr = _weighted_side(ref, cov_r)
    if th == 0 or tr == 0 or mh == 0 or mr == 0:
        return 0.0
    P, R = mh / th, mr / tr
    fmean = P * R / (ALPHA * P + (1 - ALPHA) * R)
    m = (len(cov_h) + len(cov_r)) / 2.0  # == match count when all 1-to-1
    frag = _chunks(matches) / m
    return (1 - GAMMA * frag**BETA) * fmean


class Meteor:
    """Scorer-stack adapter (eval.py:38-50 contract). Pass table paths to
    enable the synonymy/paraphrase stages once their data exists."""

    def __init__(self, synonyms_path: Optional[str] = None,
                 paraphrases_path: Optional[str] = None,
                 tables: Optional[MatchTables] = None):
        if tables is None and (synonyms_path or paraphrases_path):
            tables = MatchTables.load(synonyms_path, paraphrases_path)
        self.tables = tables

    def method(self) -> str:
        return "METEOR"

    def compute_score(self, gts: Dict, res: Dict):
        assert gts.keys() == res.keys()
        scores = [
            max(sentence_meteor(res[iid][0], ref, self.tables) for ref in gts[iid])
            for iid in gts.keys()
        ]
        mean = sum(scores) / len(scores) if scores else 0.0
        return mean, scores
