"""SPICE replacement: semantic-proposition F1 without CoreNLP.

The reference's SPICE shells out to Java jars with a Stanford dependency
parser (`misc/coco-caption/pycocoevalcap/spice/spice.py:18,72`); those jars
are external downloads.  This is a from-scratch, dependency-free semantic
tuple scorer over the same definition SPICE uses: parse each caption into a
set of propositions — objects, (object, attribute) pairs, (subject,
relation, object) triples — and F1 the candidate set against the union of
the reference sets.

The parser is a rule-based chunker tuned to caption English ("a man riding a
horse on the beach"): determiners drop, prepositions/gerunds pivot
relations, copulas predicate attributes onto the preceding head ("the car
is red" -> (car, red)), pre-nominal non-relation words attach as
attributes, and all tuple words are lemma-normalized (the jar lemmatizes
its scene-graph tuples, so "two cars" matches "a car").  DIVERGENCE from
SPICE-the-jar: no dependency parse and no WordNet synset matching — scores
correlate with SPICE but are not identical (documented; the reference as
shipped cannot run SPICE either without external downloads).

The port's own copy of ``subgc_tpu/eval/spice.py``, held equal to it
by ``tests/test_torch_port_scorers.py``.
"""
from __future__ import annotations

from typing import Dict, List, Set, Tuple

import numpy as np

from ..utils.lemma import _KEEP_ING, _strip_verb_suffix, lemmatize

DETERMINERS = set("a an the this that these those his her its their some any "
                  "every each no".split())
# the jar's scene graphs carry count attributes ("two dogs" -> (dog, 2));
# numerals normalize so "two cars" matches "2 cars"
COUNT_WORDS = {"one": "1", "two": "2", "three": "3", "four": "4",
               "five": "5", "six": "6", "seven": "7", "eight": "8",
               "nine": "9", "ten": "10", "several": "several",
               "many": "many", "few": "few"}
# expletive/pronoun subjects carry no scene content ("there is a dog...")
EXPLETIVES = set("there it they he she we you i".split())
COPULAS = set("is are was were be been being".split())
PREPOSITIONS = set("in on at by with of to from near under over behind above "
                   "beside between through across against along around into "
                   "onto up down inside outside next as".split())
CONJ = set("and or while".split())
_BE = "__be__"
_NONE = "__none__"
_CONJ = "__conj__"


def _is_relation_word(w: str, nxt: str = None) -> bool:
    # -ing nouns that are scene objects (building, painting, railing...)
    # must not pivot relations — reuse the lemmatizer's catalog.  The
    # catalog words are noun/gerund AMBIGUOUS ("a pedestrian crossing" vs
    # "a man crossing the street"); transitive position — followed by a
    # determiner — marks verbal use, the same cue a POS tagger leans on.
    if w in PREPOSITIONS:
        return True
    if not w.endswith("ing"):
        return False
    return w not in _KEEP_ING or (nxt is not None and nxt in DETERMINERS)


def _rel_lemma(w: str) -> str:
    # relation phrases ("looking at") lemmatize word-wise; a catalog word
    # pivoting as a relation is in verbal use, so force verb morphology
    # (lemmatize() would keep "crossing" nominal)
    return " ".join(
        (_strip_verb_suffix(p, 3) if p in _KEEP_ING else lemmatize(p))
        if p.endswith("ing") else p
        for p in w.split())


def parse_tuples(caption: str) -> Set[Tuple[str, ...]]:
    """Caption -> set of lemmatized semantic tuples."""
    raw = [w for w in caption.split() if w]
    # the noun/gerund lookahead needs the RAW successor (determiners are
    # the cue and are filtered from the processed stream)
    words = [(w, raw[i + 1] if i + 1 < len(raw) else None)
             for i, w in enumerate(raw)
             if w not in DETERMINERS and w not in EXPLETIVES
             # inflection-garbled function words ("thes") must not surface
             # as attributes: drop by lemma too
             and lemmatize(w) not in DETERMINERS]
    # segment into noun-phrase chunks separated by relation/copula pivots
    chunks: List[List[str]] = [[]]
    pivots: List[str] = []
    for k, (w, nxt) in enumerate(words):
        if w in CONJ:
            if not chunks[-1]:
                continue
            if w == "while":
                # always clausal ("a man eating while a woman watches")
                pivots.append(_NONE)
                chunks.append([])
                continue
            if pivots and pivots[-1] == _BE:
                # after a copular predicate: "is red and blue" continues the
                # predicate; "is red and the bus is blue" starts a new
                # clause — a copula ahead of the next relation word marks it
                cop_ahead = False
                for t, t_nxt in words[k + 1:]:
                    if t in COPULAS:
                        cop_ahead = True
                        break
                    if _is_relation_word(t, t_nxt):
                        break
                if cop_ahead:
                    pivots.append(_NONE)
                    chunks.append([])
                continue
            split = False
            if pivots and pivots[-1] not in (_NONE, _CONJ):
                # the left chunk is already a relation object.  "riding a
                # horse and a bike" conjoins objects, but "riding a horse
                # and a woman holding a dog" starts a new clause — the cue
                # is the conjoined NP carrying its own verb (non-preposition
                # relation word or copula before any preposition)
                for t, t_nxt in words[k + 1:]:
                    if t in COPULAS or (_is_relation_word(t, t_nxt)
                                        and t not in PREPOSITIONS):
                        split = True
                        break
                    if _is_relation_word(t, t_nxt):
                        break
            pivots.append(_NONE if split else _CONJ)
            chunks.append([])
            continue
        if w in COPULAS:
            if chunks[-1]:
                pivots.append(_BE)
                chunks.append([])
            continue
        if _is_relation_word(w, nxt):
            if chunks[-1]:
                pivots.append(w)
                chunks.append([])
                continue
            if pivots and pivots[-1] == _BE:
                # "man is wearing hat": the copula introduces a relation,
                # not a predicate chunk — the relation takes the pivot slot
                pivots[-1] = w
                continue
            if pivots and pivots[-1] not in (_NONE, _CONJ):
                # consecutive relation words form one phrase ("looking at")
                pivots[-1] = pivots[-1] + " " + w
                continue
        chunks[-1].append(w)

    # predicate chunks ("is red") fold into the preceding chunk's head
    n = len(chunks)
    owner = list(range(n))
    is_pred = [False] * n
    for i, piv in enumerate(pivots):
        if piv == _BE and i + 1 < n:
            owner[i + 1] = owner[i]
            is_pred[i + 1] = True

    tuples: Set[Tuple[str, ...]] = set()
    heads: List[str] = []
    for idx, chunk in enumerate(chunks):
        if not chunk or is_pred[idx]:
            heads.append(None)
            continue
        lemmas = [COUNT_WORDS[w] if w in COUNT_WORDS else lemmatize(w)
                  for w in chunk]
        # head = last non-count word ("two dogs" heads "dog", counts are
        # attributes like the jar's scene-graph numerals)
        hi = len(lemmas) - 1
        for j in range(len(lemmas) - 1, -1, -1):
            if chunk[j] not in COUNT_WORDS:
                hi = j
                break
        head = lemmas[hi]
        heads.append(head)
        tuples.add((head,))
        for j, attr in enumerate(lemmas):
            if j != hi:
                tuples.add((head, attr))

    def eff_head(i):
        return heads[owner[i]]

    # conjunction groups: chunks joined by "and"/"or" share relation slots
    # ("a man and a woman riding a horse" -> both subject the relation)
    group = list(range(n))
    for i, piv in enumerate(pivots):
        if piv == _CONJ and i + 1 < n:
            group[i + 1] = group[i]

    def grp_heads(i):
        g = group[owner[i]]
        return [heads[j] for j in range(n) if group[j] == g and heads[j]]

    for idx, chunk in enumerate(chunks):
        if is_pred[idx] and chunk and eff_head(idx):
            for w in chunk:
                tuples.add((eff_head(idx),
                            COUNT_WORDS.get(w) or lemmatize(w)))

    for i, rel in enumerate(pivots):
        if rel in (_BE, _NONE, _CONJ):
            continue
        subs = grp_heads(i)
        objs = grp_heads(i + 1) if i < n - 1 else []
        if subs and objs:
            for s in subs:
                for o in objs:
                    tuples.add((s, _rel_lemma(rel), o))
        else:                   # dangling relation acts as attribute-ish
            for s in subs:
                tuples.add((s, _rel_lemma(rel)))
    return tuples


def spice_sentence(candidate: str, refs: List[str]) -> dict:
    cand = parse_tuples(candidate)
    ref: Set[Tuple[str, ...]] = set()
    for r in refs:
        ref |= parse_tuples(r)
    tp = len(cand & ref)
    p = tp / len(cand) if cand else 0.0
    r = tp / len(ref) if ref else 0.0
    f = 2 * p * r / (p + r) if (p + r) > 0 else 0.0
    return {"All": {"f": f, "pr": p, "re": r, "tp": tp,
                    "fp": len(cand) - tp, "fn": len(ref) - tp}}


def compute_spice(gts: Dict, res: Dict):
    """(mean F, per-image F array, per-image detail dicts) — the triple
    COCOEvalCap expects from Spice.compute_score (eval.py:86-90)."""
    assert list(gts.keys()) == list(res.keys())
    details = [spice_sentence(res[k][0], gts[k]) for k in gts]
    fs = np.asarray([d["All"]["f"] for d in details])
    return float(np.mean(fs)), fs, details
