"""The PyTorch port's caption scoring stack and data modules against the JAX
package's, on the CPU: the scorers (BLEU, METEOR, ROUGE-L, CIDEr), the PTB
tokenizer and COCOEvalCap on random corpora, the caption tokenizer, the
vocabulary, the synthetic dataset, the eval loader and the COCO caption API.
The port's modules are copies of the JAX package's, so every score is
required equal (==), with nltk and with its fallbacks."""

import json
import os
import pickle
import random

import numpy as np
import pytest

from adaptive_tpu.data import coco_api as jcoco
from adaptive_tpu.data import loader as jloader
from adaptive_tpu.data import synthetic as jsyn
from adaptive_tpu.data import tokenizer as jtok
from adaptive_tpu.data import vocab as jvocab
from adaptive_tpu.evalcap import bleu as jbleu
from adaptive_tpu.evalcap import cider as jcider
from adaptive_tpu.evalcap import eval as jeval
from adaptive_tpu.evalcap import meteor as jmet
from adaptive_tpu.evalcap import ptbtokenizer as jptb
from adaptive_tpu.evalcap import rouge as jrouge
from adaptive_tpu_torch.data import coco_api as tcoco
from adaptive_tpu_torch.data import loader as tloader
from adaptive_tpu_torch.data import synthetic as tsyn
from adaptive_tpu_torch.data import tokenizer as ttok
from adaptive_tpu_torch.data import vocab as tvocab
from adaptive_tpu_torch.evalcap import bleu as tbleu
from adaptive_tpu_torch.evalcap import cider as tcider
from adaptive_tpu_torch.evalcap import eval as teval
from adaptive_tpu_torch.evalcap import meteor as tmet
from adaptive_tpu_torch.evalcap import ptbtokenizer as tptb
from adaptive_tpu_torch.evalcap import rouge as trouge
from tests.test_ptb_differential import CURATED
from tests.torch_port_util import port_threads  # noqa: F401

# tests/test_scorers.py's word list; raw captions add case and punctuation
WORDS = "a the dog cat man woman rides sits runs beach park red blue small big on in with near".split()
PUNCT = [",", ".", "!", "'s", " (", ")", "n't", "...", " -", ";"]


def jax_fallback_stem(w: str) -> str:
    """The JAX package's stemmer where nltk is absent (evalcap/meteor.py,
    its except branch, which an installed nltk leaves undefined)."""
    for suf in ("ing", "ed", "es", "s"):
        if w.endswith(suf) and len(w) > len(suf) + 2:
            return w[: -len(suf)]
    return w


def corpus(n_imgs, seed, raw=False, max_len=12):
    """{img: [refs]}, {img: [hyp]} as tests/test_scorers.py draws them; raw
    captions get capitals and punctuation for the tokenizers."""
    rng = random.Random(seed)

    def sentence(k):
        words = rng.choices(WORDS, k=k)
        if raw:
            words = [w.capitalize() if rng.random() < 0.1 else w for w in words]
            words = [w + rng.choice(PUNCT) if rng.random() < 0.15 else w for w in words]
        return " ".join(words)

    gts = {i: [sentence(rng.randint(3, max_len)) for _ in range(rng.randint(1, 5))]
           for i in range(n_imgs)}
    res = {i: [sentence(rng.randint(1, max_len))] for i in range(n_imgs)}
    return gts, res


def _coco(mod, gts, res):
    """(ground-truth COCO, results COCO) of a corpus, built by one package."""
    gt = mod.COCO()
    gt.dataset = {
        "images": [{"id": i} for i in gts],
        "annotations": [{"id": 1 + 10 * i + j, "image_id": i, "caption": c}
                        for i, caps in gts.items() for j, c in enumerate(caps)],
    }
    gt.createIndex()
    return gt, gt.loadRes([{"image_id": i, "caption": r[0]} for i, r in res.items()])


def _cocoevalcap(mod, coco_mod, gts, res):
    gt, rs = _coco(coco_mod, gts, res)
    ev = mod.COCOEvalCap(gt, rs)
    ev.params["image_id"] = rs.getImgIds()
    ev.evaluate()
    return ev.eval, ev.imgToEval


def _refs_and_hyps(gts, res):
    """Both sides of a corpus in one dict (hypotheses under negative keys)."""
    return {**gts, **{-1 - k: v for k, v in res.items()}}


SCORERS = {
    "bleu": lambda j, g, r: (jbleu.Bleu(4) if j else tbleu.Bleu(4)).compute_score(g, r),
    "cider": lambda j, g, r: (jcider.Cider() if j else tcider.Cider()).compute_score(g, r),
    "rouge": lambda j, g, r: (jrouge.Rouge() if j else trouge.Rouge()).compute_score(g, r),
    "meteor_tables": lambda j, g, r: (
        jmet.Meteor(tables=jmet.default_tables(refresh=True)) if j
        else tmet.Meteor(tables=tmet.default_tables(refresh=True))).compute_score(g, r),
    "meteor_none": lambda j, g, r: (
        jmet.Meteor(tables=None) if j else tmet.Meteor(tables=None)).compute_score(g, r),
    "ptb": lambda j, g, r: (jptb.PTBTokenizer() if j else tptb.PTBTokenizer()).tokenize(
        {i: [{"caption": c} for c in caps] for i, caps in _refs_and_hyps(g, r).items()}),
    "cocoevalcap": lambda j, g, r: (
        _cocoevalcap(jeval, jcoco, g, r) if j else _cocoevalcap(teval, tcoco, g, r)),
}
RAW = {"ptb", "cocoevalcap"}  # these tokenize: give them raw captions


@pytest.mark.parametrize("n_imgs,seed", [(1, 0), (25, 2), (100, 3)])
@pytest.mark.parametrize("scorer", list(SCORERS))
def test_scorer_matches_jax(scorer, n_imgs, seed):
    """Corpus and per-image scores (or tokens) equal to the JAX package's."""
    gts, res = corpus(n_imgs, seed, raw=scorer in RAW)
    want = SCORERS[scorer](True, gts, res)
    got = SCORERS[scorer](False, gts, res)
    assert got == want


@pytest.fixture
def no_nltk(monkeypatch):
    """Both packages on their nltk fallbacks: the regex Treebank tokenizer
    and the suffix stemmer (what runs where nltk is not installed)."""
    for mod in (jtok, ttok):
        monkeypatch.setattr(mod, "_TREEBANK", None)
    monkeypatch.setattr(jmet, "_STEM", jax_fallback_stem)
    monkeypatch.setattr(tmet, "_STEM", tmet._fallback_stem)


@pytest.mark.parametrize("scorer", ["meteor_tables", "meteor_none", "ptb", "cocoevalcap"])
def test_scorer_matches_jax_without_nltk(no_nltk, scorer):
    gts, res = corpus(25, 5, raw=scorer in RAW)
    if scorer.startswith("meteor"):  # give the stemmer inflections to strip
        res = {i: [r[0] + " running dogs walked"] for i, r in res.items()}
    assert SCORERS[scorer](False, gts, res) == SCORERS[scorer](True, gts, res)


TOKENIZER_FNS = ("caption_tokenize", "word_tokenize", "split_sentences", "sentence_word_tokens")


@pytest.mark.parametrize("nltk", [True, False], ids=["nltk", "fallback"])
def test_tokenizers_match_jax(monkeypatch, nltk):
    """The caption tokenizer's functions and the PTB tokenizer's
    tokenize_caption on tests/test_ptb_differential.py's curated strings."""
    if not nltk:
        for mod in (jtok, ttok):
            monkeypatch.setattr(mod, "_TREEBANK", None)
    assert (ttok._TREEBANK is None) == (not nltk)
    texts = [t for t, _ in CURATED] + [r[0] for r in corpus(40, 9, raw=True)[1].values()]
    for text in texts:
        for fn in TOKENIZER_FNS:
            assert getattr(ttok, fn)(text) == getattr(jtok, fn)(text), (fn, text)
        assert tptb.tokenize_caption(text) == jptb.tokenize_caption(text), text


class Vocabulary:
    """Stands in for the reference's pickled class (code_src.data.build_vocab),
    which both packages' loaders map by its name."""


def test_vocabulary_matches_jax(tmp_path):
    """build_vocab's word order at two thresholds; encode, decode, unknown
    words; save and load in both directions (JSON) and the reference .pkl."""
    caps = [jsyn.synthetic_caption(np.random.default_rng(s)) for s in range(30)]
    caps += [t for t, _ in CURATED]
    for threshold in (1, 2):
        jv, tv = jvocab.build_vocab(caps, threshold), tvocab.build_vocab(caps, threshold)
        assert tv.word2idx == jv.word2idx and tv.idx2word == jv.idx2word
    for cap in caps + ["an unseen zebra"]:
        assert tv.encode_caption(cap) == jv.encode_caption(cap)
    ids = [1, 5, 6, tvocab.END_ID, 7, 3]
    for stop in (True, False):
        assert tv.decode_ids(ids, stop_at_end=stop) == jv.decode_ids(ids, stop_at_end=stop)
    assert tv("zebra") == jv("zebra") == tvocab.UNK_ID
    assert (tvocab.SPECIALS, tvocab.PAD_ID, tvocab.START_ID, tvocab.END_ID) == (
        jvocab.SPECIALS, jvocab.PAD_ID, jvocab.START_ID, jvocab.END_ID)

    jv.save(str(tmp_path / "j.json"))
    tv.save(str(tmp_path / "t.json"))
    assert (tmp_path / "j.json").read_text() == (tmp_path / "t.json").read_text()
    assert tvocab.Vocabulary.load(str(tmp_path / "j.json")).word2idx == jv.word2idx

    ref = Vocabulary()
    ref.word2idx = dict(jv.word2idx)
    ref.idx2word = {i: w for w, i in jv.word2idx.items()}
    with open(tmp_path / "vocab.pkl", "wb") as f:
        pickle.dump(ref, f)
    got = tvocab.Vocabulary.load(str(tmp_path / "vocab.pkl"))
    assert got.word2idx == jvocab.Vocabulary.load(str(tmp_path / "vocab.pkl")).word2idx


def test_synthetic_split_and_loader_match_jax(tmp_path):
    """make_synthetic_dataset: the same annotation JSON and the same decoded
    pixels; EvalImageDataset and EvalBatches (the padded last batch, the
    valid mask) equal the JAX loader's."""
    ja, jr = jsyn.make_synthetic_dataset(str(tmp_path / "j"), num_images=5, image_size=40,
                                         captions_per_image=2, seed=4)
    ta, tr = tsyn.make_synthetic_dataset(str(tmp_path / "t"), num_images=5, image_size=40,
                                         captions_per_image=2, seed=4)
    assert open(ja).read() == open(ta).read()
    np.testing.assert_array_equal(tsyn.synthetic_image(3, 40), jsyn.synthetic_image(3, 40))
    jd, td = jloader.EvalImageDataset(jr, ja), tloader.EvalImageDataset(tr, ta)
    assert len(td) == len(jd) == 5
    for i in range(5):
        (ji, jid), (ti, tid) = jd[i], td[i]
        assert tid == jid and ti.dtype == np.uint8 and ti.shape == (40, 40, 3)
        np.testing.assert_array_equal(ti, ji)
    assert tloader._image_subdir("COCO_val2014_1.jpg") == jloader._image_subdir("COCO_val2014_1.jpg")
    jb = list(jloader.EvalBatches(jd, 4, num_workers=2))
    tb = list(tloader.EvalBatches(td, 4, num_workers=2))
    assert len(tb) == len(jb) == len(tloader.EvalBatches(td, 4)) == 2
    for b1, b2 in zip(tb, jb):
        assert set(b1) == set(b2)
        for k in b1:
            np.testing.assert_array_equal(b1[k], b2[k])
    assert tb[1]["valid"].tolist() == [True, False, False, False]


def test_coco_api_matches_jax(tmp_path):
    """The caption API's indexes and getters, and loadRes's caption, bbox,
    keypoints and segmentation branches, and the mask methods, equal to
    JAX's (tests/test_torch_detection.py holds the rest of the detection
    API)."""
    ann, _ = jsyn.make_synthetic_dataset(str(tmp_path), num_images=6, captions_per_image=3,
                                         seed=2, write_images=False)
    j, t = jcoco.COCO(ann), tcoco.COCO(ann)
    for attr in ("dataset", "anns", "imgs", "cats", "imgToAnns", "catToImgs"):
        assert getattr(t, attr) == getattr(j, attr), attr
    for call in (lambda c: c.getImgIds(), lambda c: c.getImgIds(imgIds=[2, 3]),
                 lambda c: c.getAnnIds(), lambda c: c.getAnnIds(imgIds=4),
                 lambda c: c.getAnnIds(imgIds=[1, 2], iscrowd=0), lambda c: c.getCatIds(),
                 lambda c: c.loadImgs([1, 5]), lambda c: c.loadAnns(3)):
        assert call(t) == call(j)
    caps = [{"image_id": i, "caption": f"caption {i}"} for i in (2, 4, 5)]
    a, b = t.loadRes(caps), j.loadRes(caps)
    assert (a.dataset, a.anns, a.imgs, a.imgToAnns) == (b.dataset, b.anns, b.imgs, b.imgToAnns)
    path = tmp_path / "res.json"
    path.write_text(json.dumps(caps))
    assert t.loadRes(str(path)).anns == j.loadRes(str(path)).anns

    dets = {"images": [{"id": 1, "height": 20, "width": 20}],
            "annotations": [{"id": 1, "image_id": 1, "category_id": 1, "bbox": [1, 2, 3, 4],
                             "area": 12, "iscrowd": 0,
                             "segmentation": [[1, 2, 1, 6, 4, 6, 4, 2]]}],
            "categories": [{"id": 1, "name": "x", "supercategory": "y"}]}
    j, t = jcoco.COCO(), tcoco.COCO()
    for c in (j, t):
        c.dataset = dets
        c.createIndex()
    assert t.getCatIds(catNms="x", supNms=["y"]) == j.getCatIds(catNms="x", supNms=["y"]) == [1]
    assert t.loadCats(1) == j.loadCats(1)
    assert t.getAnnIds(catIds=1, areaRng=[10, 20]) == j.getAnnIds(catIds=1, areaRng=[10, 20])
    boxes = [{"image_id": 1, "category_id": 1, "bbox": [1.0, 2.0, 3.0, 4.0], "score": 0.5}]
    kps = [{"image_id": 1, "category_id": 1, "keypoints": [1, 2, 2, 5, 9, 2], "score": 0.5}]
    for res in (boxes, kps):
        a, b = t.loadRes(res), j.loadRes(res)
        assert (a.dataset, a.anns) == (b.dataset, b.anns)
    rle = t.annToRLE(t.anns[1])
    assert rle == j.annToRLE(j.anns[1])
    np.testing.assert_array_equal(t.annToMask(t.anns[1]), j.annToMask(j.anns[1]))
    segs = [{"image_id": 1, "category_id": 1, "segmentation": rle, "score": 0.5}]
    a, b = t.loadRes(segs), j.loadRes(segs)
    assert (a.dataset, a.anns) == (b.dataset, b.anns) and a.anns[1]["area"] > 0
    assert t.showAnns([]) == j.showAnns([]) == 0
    assert tcoco._as_list(5) == jcoco._as_list(5) == [5]
    assert tcoco._as_list(np.arange(2)) == jcoco._as_list(np.arange(2))


def test_meteor_tables_are_the_ports_own(monkeypatch):
    """default_tables() resolves the tables packaged beside the port's
    meteor.py (not adaptive_tpu/'s), which hold the JAX package's data; the
    package data in pyproject.toml ships them."""
    import tomllib

    for var in ("ADAPTIVE_TPU_METEOR_TABLES", "ADAPTIVE_TPU_METEOR_SYNONYMS",
                "ADAPTIVE_TPU_METEOR_PARAPHRASES"):
        monkeypatch.delenv(var, raising=False)
    seen = []
    load = tmet.MatchTables.load.__func__

    def spy(cls, syn=None, para=None):
        seen.append((syn, para))
        return load(cls, syn, para)

    monkeypatch.setattr(tmet.MatchTables, "load", classmethod(spy))
    got = tmet.default_tables(refresh=True)
    here = os.path.join(os.path.dirname(os.path.abspath(tmet.__file__)), "data")
    (syn, para), = seen
    assert os.path.dirname(os.path.abspath(syn)) == os.path.dirname(os.path.abspath(para)) == here
    assert os.path.basename(os.path.dirname(os.path.dirname(here))) == "adaptive_tpu_torch"
    want = jmet.default_tables(refresh=True)
    assert got.synonyms == want.synonyms and got.paraphrases == want.paraphrases
    assert got.synonyms and got.paraphrases
    monkeypatch.setenv("ADAPTIVE_TPU_METEOR_TABLES", "off")
    assert tmet.default_tables(refresh=True) is None
    monkeypatch.undo()
    tmet.default_tables(refresh=True)

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "pyproject.toml"), "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    assert data["adaptive_tpu_torch.evalcap"] == ["data/*.txt"]
    assert sorted(os.listdir(here)) == ["meteor_paraphrases.txt", "meteor_synonyms.txt"]
