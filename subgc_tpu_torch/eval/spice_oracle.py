"""Independent SPICE tuple extractor — the validation oracle.

`eval/spice.py`'s chunker decides word roles by morphology and stop-lists
("-ing" pivots a relation unless catalogued, anything before a pivot is a
noun chunk) and segments linearly.  This oracle is ALGORITHMICALLY
DIFFERENT on both axes, the way nltk's METEOR is an independent
implementation of the same definition (docs/METRICS.md):

* word roles come from an explicit closed POS LEXICON (exact word lists +
  plural/inflection lookup — no morphological guessing).  Out-of-lexicon
  tokens are UNKNOWN and contribute nothing (a dependency parser would
  similarly fail to attach garbage tokens);
* structure comes from a small caption grammar derived over the tagged
  sequence — NP := ADJ* NOUN+ (head = last noun), clause := NP [VERB NP]
  [PREP NP]*, prepositional phrases attach to the nearest preceding head —
  rather than from pivot-splitting.

Both extractors emit the same tuple space (lemmatized objects,
(object, attribute), (subject, relation-phrase, object)), so tuple-level
F1 and pair-level SPICE-score agreement measure extraction fidelity
directly.  The lexicon covers the validation corpus's closed vocabulary
(tools/gen_metric_validation.py) plus common COCO caption words; outside
that vocabulary the oracle abstains (UNKNOWN), which is the documented
scope of the bound.

Reference being stood in for: the SPICE jar's dependency-parse pipeline,
`misc/coco-caption/pycocoevalcap/spice/spice.py:18,72` (external download,
not runnable here).

The port's own copy of ``subgc_tpu/eval/spice_oracle.py``, held equal to it
by ``tests/test_torch_port_scorers.py``.
"""
from __future__ import annotations

from typing import List, Set, Tuple

# ---------------------------------------------------------------- lexicon
# the validation corpus's closed vocabulary (tools/gen_metric_validation.py)
# plus frequent COCO-caption words; base forms only — inflections resolve
# through _lookup
NOUN_BASES = set(
    "man woman dog cat horse car bus bike boat plane child girl boy bench "
    "table chair pizza sandwich cake umbrella kite surfboard skateboard "
    "laptop phone cup plate bowl bottle clock vase street road beach ocean "
    "mountain field park kitchen bathroom bedroom train truck elephant "
    "giraffe zebra bear sheep cow bird person people group crowd building "
    "tree grass sky water snow food fruit banana apple orange broccoli "
    "carrot hydrant sign light toilet sink bed couch television remote "
    "keyboard mouse book scissors teddy drier brush game ball bat glove "
    "racket net court player hand head hair face eye mouth wall floor "
    "window door room house station airport runway track rail platform "
    "puppy kitten notebook painting railing ceiling".split())
ADJ_BASES = set(
    "young old big small red blue green white black brown tall short happy "
    "pretty wooden plastic shiny dirty clean wet large little fast slow "
    "beautiful attractive joyful grey gray yellow pink purple orange dark "
    "bright empty full open closed busy quiet warm cold hot new modern "
    "vintage striped furry fluffy".split())
VERB_BASES = {
    # base: -ing and -s/-ed inflections map back here
    "ride": ["riding", "rides", "rode", "ridden"],
    "hold": ["holding", "holds", "held"],
    "eat": ["eating", "eats", "ate", "eaten"],
    "watch": ["watching", "watches", "watched"],
    "stand": ["standing", "stands", "stood"],
    "sit": ["sitting", "sits", "sat"],
    "walk": ["walking", "walks", "walked"],
    "run": ["running", "runs", "ran"],
    "jump": ["jumping", "jumps", "jumped"],
    "play": ["playing", "plays", "played"],
    "carry": ["carrying", "carries", "carried"],
    "wear": ["wearing", "wears", "wore", "worn"],
    "throw": ["throwing", "throws", "threw", "thrown"],
    "catch": ["catching", "catches", "caught"],
    "fly": ["flying", "flies", "flew", "flown"],
    "cross": ["crossing", "crosses", "crossed"],
    "look": ["looking", "looks", "looked"],
    "lie": ["lying", "lies", "lay"],
    "sleep": ["sleeping", "sleeps", "slept"],
    "drive": ["driving", "drives", "drove", "driven"],
    "park": ["parked"],           # "parked car"; bare "park" stays a noun
    "surf": ["surfing", "surfs", "surfed"],
    "ski": ["skiing", "skis", "skied"],
    "swim": ["swimming", "swims", "swam"],
    "graze": ["grazing", "grazes", "grazed"],
    "talk": ["talking", "talks", "talked"],
    "smile": ["smiling", "smiles", "smiled"],
}
PREPS = set("on in near under behind beside above at with by over of to "
            "from between through across against along around into onto "
            "inside outside next as up down".split())
DETS = set("a an the this that these those his her its their some any "
           "every each no".split())
COUNTS = {"one": "1", "two": "2", "three": "3", "four": "4", "five": "5",
          "several": "several", "many": "many"}
COPULAS = set("is are was were be been being".split())
CONJS = set("and or".split())

_VERB_FORM = {}
for base, forms in VERB_BASES.items():
    for f in forms:
        _VERB_FORM[f] = base

_NOUN_FORM = {}
for n in NOUN_BASES:
    _NOUN_FORM[n] = n
    _NOUN_FORM[n + "s"] = n
    if n.endswith(("s", "sh", "ch", "x")):
        _NOUN_FORM[n + "es"] = n
    if n.endswith("y") and n[-2:-1] not in "aeiou":
        _NOUN_FORM[n[:-1] + "ies"] = n
_NOUN_FORM["people"] = "person"
_NOUN_FORM["children"] = "child"
_NOUN_FORM["men"] = "man"
_NOUN_FORM["women"] = "woman"
_NOUN_FORM["sheep"] = "sheep"


def _tag(word: str) -> Tuple[str, str]:
    """word -> (tag, lemma); tag in NOUN/ADJ/VERB/PREP/DET/COUNT/COP/CONJ/
    UNK.  Nouns win ties with verbs for bare base forms ("park", "train")
    — caption NPs dominate; inflected verb forms are unambiguous."""
    if word in DETS:
        return "DET", word
    if word in COUNTS:
        return "COUNT", COUNTS[word]
    if word in COPULAS:
        return "COP", word
    if word in CONJS:
        return "CONJ", word
    if word in _NOUN_FORM:
        return "NOUN", _NOUN_FORM[word]
    if word in _VERB_FORM:
        return "VERB", _VERB_FORM[word]
    if word in ADJ_BASES:
        return "ADJ", word
    if word in PREPS:
        return "PREP", word
    return "UNK", word


def oracle_tuples(caption: str) -> Set[Tuple[str, ...]]:
    """Caption -> lemmatized semantic tuples via lexicon POS + grammar."""
    tagged = [_tag(w) for w in caption.split() if w]
    tagged = [(t, l) for t, l in tagged if t not in ("DET", "UNK")]

    tuples: Set[Tuple[str, ...]] = set()

    # scan: build NPs (ADJ/COUNT* NOUN+, head = last noun; conjoined nouns
    # each become objects sharing the modifiers), track pending relations
    i, n = 0, len(tagged)
    last_heads: List[str] = []  # heads of the preceding NP (conjoined nouns
    #                             all subject the following relation)
    pending = None            # (subject_heads, relation_words) awaiting NP
    pending_cop = None        # subject awaiting a copular predicate

    def emit_np(mods: List[str], nouns: List[str]):
        heads = nouns[-1:]        # head = last noun; earlier nouns modify
        for h in heads:
            tuples.add((h,))
            for m in mods + nouns[:-1]:
                tuples.add((h, m))
        return heads[-1] if heads else None

    while i < n:
        tag, lem = tagged[i]
        if tag in ("ADJ", "COUNT", "NOUN"):
            mods: List[str] = []
            nouns: List[str] = []
            conj_heads: List[str] = []
            while i < n and tagged[i][0] in ("ADJ", "COUNT", "NOUN", "CONJ"):
                t2, l2 = tagged[i]
                if t2 == "CONJ":
                    # clause conjunction: in object position ("riding a
                    # horse and a woman holding a dog") a VERB/COP right
                    # after the conjoined noun run marks a new clause —
                    # close this NP instead of conjoining
                    if pending is not None:
                        j = i + 1
                        while j < n and tagged[j][0] in ("ADJ", "COUNT",
                                                         "NOUN"):
                            j += 1
                        if j < n and tagged[j][0] in ("VERB", "COP"):
                            break
                    if nouns:
                        # "man and woman": close the current NP, both heads
                        h = emit_np(mods, nouns)
                        if h:
                            conj_heads.append(h)
                        mods, nouns = [], []
                    elif mods and pending_cop is not None:
                        # "the car is red and blue": conjoined copular
                        # predicates each attach to the subject
                        for m in mods:
                            tuples.add((pending_cop, m))
                        mods = []
                    i += 1
                    continue
                (mods if t2 in ("ADJ", "COUNT") else nouns).append(l2)
                i += 1
            heads = list(conj_heads)
            if nouns:
                h = emit_np(mods, nouns)
                if h:
                    heads.append(h)
            elif mods and pending_cop:
                # copular predicate: "the car is red"
                for m in mods:
                    tuples.add((pending_cop, m))
                pending_cop = None
                continue
            if not heads:
                continue
            if pending is not None:
                subjs, rel = pending
                for s in subjs:
                    for h in heads:
                        tuples.add((s, " ".join(rel), h))
                pending = None
            last_heads = heads
            pending_cop = None
            continue
        if tag == "VERB" or tag == "PREP":
            # collect the relation phrase ("sitting on", "looking at")
            rel = [lem]
            i += 1
            while i < n and tagged[i][0] in ("VERB", "PREP"):
                rel.append(tagged[i][1])
                i += 1
            subjs = [pending_cop] if pending_cop else list(last_heads)
            if subjs:
                pending = (subjs, rel)
            pending_cop = None
            continue
        if tag == "COP":
            pending_cop = last_heads[-1] if last_heads else None
            i += 1
            continue
        i += 1                    # CONJ outside an NP, stray tokens

    if pending is not None:
        # dangling relation ("a man standing") acts attribute-ish, matching
        # the chunker's and the jar's unattached-relation behavior
        subjs, rel = pending
        for s in subjs:
            tuples.add((s, " ".join(rel)))
    return tuples


def spice_sentence_oracle(candidate: str, refs: List[str]) -> dict:
    """SPICE F1 computed from oracle tuples (same scoring as spice.py)."""
    cand = oracle_tuples(candidate)
    ref: Set[Tuple[str, ...]] = set()
    for r in refs:
        ref |= oracle_tuples(r)
    tp = len(cand & ref)
    p = tp / len(cand) if cand else 0.0
    r = tp / len(ref) if ref else 0.0
    f = 2 * p * r / (p + r) if (p + r) > 0 else 0.0
    return {"All": {"f": f, "pr": p, "re": r}}
