"""METEOR reimplementation (exact + stem stages).

The reference shells out to the METEOR 1.5 Java jar
(`misc/coco-caption/pycocoevalcap/meteor/meteor.py:15,23-25`); the jar and
its paraphrase tables are NOT shipped in the repo (downloaded separately), so
this is a from-scratch Python implementation of the METEOR 1.5 algorithm:

* stage-wise word alignment — exact match, Porter-stem match, then a
  synonym stage over a built-in caption-domain synonym table — chosen to
  (1) maximize matches and (2) minimize crossing/chunks (greedy approximation
  of the jar's beam search)
* a phrase-level PARAPHRASE stage over a built-in caption-domain phrase
  table (the jar's 4th stage; its paraphrase-db is an external download):
  multi-word spans left unmatched by the word stages pair when both sides
  name the same table group ("next to" ~ "beside"), contributing
  weight x span-length to each side's match mass (so precision and recall
  masses differ, as in the jar)
* recall-weighted harmonic mean + cubic fragmentation penalty; multi-
  reference = max over references

Parameters are the METEOR 1.5 English settings: alpha=0.9
(Fmean = 10PR/(R+9P)), penalty = 0.5*(chunks/matches)^3, stage weights
(exact 1.0, stem 0.6, synonym 0.8, paraphrase 0.6).  DIVERGENCE from the
1.5 jar: the synonym/paraphrase stages use curated caption-domain tables
instead of WordNet synsets and the 8MB paraphrase-db (both data files are
external downloads the reference doesn't ship either); scores correlate
but are not bit-identical.
Fidelity is quantified against an independent oracle implementation (nltk's
meteor_score) on a pinned corpus — see tests/test_metric_fidelity.py and
docs/METRICS.md for the measured deltas.

The port's own copy of ``subgc_tpu/eval/meteor.py``, held equal to it
by ``tests/test_torch_port_scorers.py``.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .stemmer import porter_stem

ALPHA = 0.9       # recall weight in the harmonic mean
BETA = 3.0        # fragmentation exponent
GAMMA = 0.5       # max penalty
# exact, stem, synonym, paraphrase (METEOR 1.5 English)
STAGE_WEIGHTS = [1.0, 0.6, 0.8, 0.6]

# Caption-domain synonym groups (WordNet-free stand-in for the jar's synset
# stage; curated for COCO/Flickr caption vocabulary).
SYNONYM_GROUPS = [
    "man guy gentleman male", "woman lady female", "kid child youngster",
    "person human individual", "photo photograph picture image",
    "bike bicycle cycle", "motorbike motorcycle",
    "car automobile vehicle", "bus coach", "taxi cab",
    "plane airplane aeroplane aircraft jet", "boat ship vessel",
    "train locomotive", "truck lorry",
    "dog puppy canine pup", "cat kitten feline kitty",
    "bird fowl", "horse pony", "cow cattle", "sheep lamb",
    "big large huge enormous giant", "small little tiny",
    "quick fast rapid speedy swift", "slow sluggish",
    "happy glad joyful cheerful", "sad unhappy",
    "pretty beautiful lovely gorgeous attractive",
    "street road roadway", "sidewalk pavement", "highway freeway motorway",
    "sea ocean", "stream creek brook", "woods forest",
    "hill slope", "rock stone", "grass lawn", "yard garden",
    "house home residence", "store shop", "restaurant diner eatery cafe",
    "couch sofa settee", "tv television", "fridge refrigerator",
    "phone telephone cellphone smartphone", "laptop notebook",
    "cup mug", "plate dish", "bag sack purse handbag",
    "hat cap", "coat jacket", "shirt top", "pants trousers",
    "shoe sneaker boot", "glasses spectacles eyeglasses sunglasses",
    "trash garbage rubbish", "gift present",
    "begin start commence", "end finish conclude",
    "speak talk converse", "look watch observe view",
    "walk stroll", "run sprint jog", "jump leap hop",
    "hold grasp grip clutch", "throw toss hurl",
    "eat consume devour", "drink sip",
    "smile grin", "laugh chuckle giggle",
    "near close nearby", "far distant",
    "beneath underneath below", "atop upon",
    "couple pair duo", "group crowd bunch",
    "field meadow pasture", "mountain peak",
    "snow snowfall", "rain rainfall", "fog mist",
    "baby infant toddler", "boy lad", "girl lass",
    "food meal cuisine", "pizza pie", "sandwich sub",
]
_SYN_ID = {}
for _gi, _grp in enumerate(SYNONYM_GROUPS):
    for _w in _grp.split():
        _SYN_ID[_w] = _gi


def _syn_key(w: str):
    """Synonym-stage key: the group id if the word is in the table, else the
    word itself (identical leftovers may still pair at this stage)."""
    return _SYN_ID.get(w, w)


# Caption-domain paraphrase groups (stand-in for the jar's paraphrase-db,
# which is an 8MB external download).  Mostly multi-word <-> word/phrase
# pairs the word stages cannot align.
PARAPHRASE_GROUPS = [
    ["next to", "beside", "alongside", "adjacent to"],
    ["on top of", "atop", "upon"],
    ["in front of", "before"],
    ["a lot of", "lots of", "many", "plenty of"],
    ["a couple of", "a pair of", "two"],
    ["a group of", "a bunch of", "a crowd of", "a herd of", "several",
     "more than one", "multiple"],
    ["cell phone", "cellphone", "mobile phone"],
    ["hot dog", "hotdog"],
    ["fire hydrant", "hydrant"],
    ["teddy bear", "stuffed bear", "stuffed animal"],
    ["traffic light", "stop light", "stoplight", "traffic signal"],
    ["train station", "railway station", "railroad station"],
    ["parking lot", "car park"],
    ["street light", "streetlight", "lamp post", "lamppost"],
    ["tennis racket", "tennis racquet"],
    ["skate board", "skateboard"],
    ["snow board", "snowboard"],
    ["surf board", "surfboard"],
    ["base ball", "baseball"],
    ["basket ball", "basketball"],
    ["side by side", "next to each other"],
    ["in the middle of", "in the center of"],
    ["getting ready to", "preparing to", "about to"],
    ["black and white", "monochrome"],
    ["talking on", "speaking on"],
    ["little girl", "young girl"],
    ["little boy", "young boy"],
]
_PARA_ID: Dict[str, int] = {}
_MAX_PHRASE = 1
for _gi, _grp2 in enumerate(PARAPHRASE_GROUPS):
    for _ph in _grp2:
        _PARA_ID[_ph] = _gi
        _MAX_PHRASE = max(_MAX_PHRASE, len(_ph.split()))


def _phrase_matches(hyp: List[str], ref: List[str], used_h: List[bool],
                    used_r: List[bool]) -> List[Tuple[int, int, int, int]]:
    """Greedy longest-first paraphrase spans over UNMATCHED words only.
    Returns [(i_start, i_end, j_start, j_end)] (inclusive)."""
    out = []
    for i in range(len(hyp)):
        for li in range(_MAX_PHRASE, 0, -1):
            if i + li > len(hyp) or any(used_h[i:i + li]):
                continue
            htext = " ".join(hyp[i:i + li])
            gid = _PARA_ID.get(htext)
            if gid is None:
                continue
            hit = None
            for j in range(len(ref)):
                for lj in range(_MAX_PHRASE, 0, -1):
                    if j + lj > len(ref) or any(used_r[j:j + lj]):
                        continue
                    rtext = " ".join(ref[j:j + lj])
                    # identical spans never survive the exact stage; the
                    # guard keeps the stage strictly paraphrastic anyway
                    if rtext != htext and _PARA_ID.get(rtext) == gid:
                        hit = (j, lj)
                        break
                if hit:
                    break
            if hit is None:
                continue
            j, lj = hit
            for k in range(i, i + li):
                used_h[k] = True
            for k in range(j, j + lj):
                used_r[k] = True
            out.append((i, i + li - 1, j, j + lj - 1))
            break
    return out


def _align_greedy(keys, rkeys, n_hyp: int, n_ref: int,
                  policy: int) -> List[Tuple[int, int, int]]:
    """One greedy stage-wise alignment pass.

    policy 0: walk hyp left-to-right, match the nearest unused ref occurrence
    after the previous match (monotone bias).  policy 1: first unused ref
    occurrence (the nltk heuristic).  Both are maximal per stage (every
    matchable hyp word gets matched); they differ only in WHICH occurrence,
    i.e. in the resulting chunk count.
    """
    matches = []
    used_h = [False] * n_hyp
    used_r = [False] * n_ref
    for stage in range(len(keys)):
        hk, rk = keys[stage], rkeys[stage]
        last_j = -1
        for i in range(n_hyp):
            if used_h[i]:
                continue
            best = None
            for j in range(n_ref):
                if used_r[j] or rk[j] != hk[i]:
                    continue
                if policy == 1:
                    best = (None, j)
                    break
                d = (0 if j > last_j else 1, abs(j - (last_j + 1)))
                if best is None or d < best[0]:
                    best = (d, j)
            if best is not None:
                j = best[1]
                used_h[i] = True
                used_r[j] = True
                matches.append((i, j, stage))
                last_j = j
    return sorted(matches)


_BEAM_WIDTH = 16


def _align_beam(keys, rkeys, n_hyp: int,
                n_ref: int) -> List[Tuple[int, int, int]]:
    """Beam search over match assignments: maximize matches, then minimize
    chunks, then prefer earlier (exact) stages — the jar's criterion.

    State per partial alignment after hyp position i: (last matched (i, j),
    used-ref bitmask) -> (matches, chunks, stage_sum, match tuple).  Beam
    width 16 is exhaustive in practice for <=20-word captions.
    """
    stage_of = {}
    for i in range(n_hyp):
        for j in range(n_ref):
            for s in range(len(keys)):
                if keys[s][i] == rkeys[s][j]:
                    stage_of[(i, j)] = s
                    break
    if not stage_of:
        return []

    beams = {(-2, -2, 0): (0, 0, 0, ())}
    for i in range(n_hyp):
        nxt = {}

        def push(key, val):
            old = nxt.get(key)
            # better = more matches, then fewer chunks, then lower stage sum
            if old is None or (-val[0], val[1], val[2]) < \
                    (-old[0], old[1], old[2]):
                nxt[key] = val

        for (li, lj, used), (m, ch, ss, ms) in beams.items():
            push((li, lj, used), (m, ch, ss, ms))      # leave hyp[i] unmatched
            for j in range(n_ref):
                if used >> j & 1:
                    continue
                s = stage_of.get((i, j))
                if s is None:
                    continue
                ch2 = ch if (li == i - 1 and lj == j - 1) else ch + 1
                push((i, j, used | 1 << j),
                     (m + 1, ch2, ss + s, ms + ((i, j, s),)))
        beams = dict(sorted(nxt.items(),
                            key=lambda kv: (-kv[1][0], kv[1][1], kv[1][2])
                            )[:_BEAM_WIDTH])
    best = min(beams.values(), key=lambda v: (-v[0], v[1], v[2]))
    return list(best[3])


def _align(hyp: List[str], ref: List[str],
           n_stages: int = 3) -> List[Tuple[int, int, int]]:
    """Stage-wise alignment.  Returns [(hyp_i, ref_j, stage)].

    The METEOR jar resolves alignment ties by (most matches, fewest chunks)
    via beam search; this mirrors that with a beam over match assignments,
    with the two greedy passes kept as additional candidates (the beam's
    prune is heuristic; the portfolio winner is picked by the same
    criterion)."""
    keys = [hyp, [porter_stem(w) for w in hyp], [_syn_key(w) for w in hyp]]
    rkeys = [ref, [porter_stem(w) for w in ref], [_syn_key(w) for w in ref]]
    keys, rkeys = keys[:n_stages], rkeys[:n_stages]
    cands = [_align_greedy(keys, rkeys, len(hyp), len(ref), policy)
             for policy in (0, 1)]
    cands.append(_align_beam(keys, rkeys, len(hyp), len(ref)))
    return min(cands, key=lambda m: (-len(m), _chunks(m)))


def _chunks(matches: List[Tuple[int, int, int]]) -> int:
    if not matches:
        return 0
    ch = 1
    for (i1, j1, _), (i2, j2, _) in zip(matches, matches[1:]):
        if i2 != i1 + 1 or j2 != j1 + 1:
            ch += 1
    return ch


def _chunks_spans(spans: List[Tuple[int, int, int, int]]) -> int:
    """Chunk count over (i1, i2, j1, j2) spans (word matches are 1-word
    spans; a phrase match is internally one chunk)."""
    if not spans:
        return 0
    ch = 1
    for (_, pi2, _, pj2), (i1, _, j1, _) in zip(spans, spans[1:]):
        if i1 != pi2 + 1 or j1 != pj2 + 1:
            ch += 1
    return ch


def meteor_sentence(hypothesis: str, references: List[str],
                    stage_weights: List[float] = None) -> float:
    """METEOR score of one hypothesis vs references (max over refs).

    stage_weights: per-stage match weights; also controls how many stages
    run.  Default = the shipped METEOR-1.5 weights.  Pass [1.0, 1.0] for the
    classic Banerjee/Lavie configuration (exact+stem, unweighted) — used by
    the fidelity tests to compare against the nltk oracle implementation on
    identical terms.
    """
    weights = STAGE_WEIGHTS if stage_weights is None else stage_weights
    hyp = hypothesis.split()
    if not hyp:
        return 0.0
    best = 0.0
    for reference in references:
        ref = reference.split()
        if not ref:
            continue
        matches = _align(hyp, ref, n_stages=min(len(weights), 3))
        # per-side match mass; identical for word matches, split for phrase
        # matches (the jar weighs each side by its own covered span)
        m_h = m_r = sum(weights[s] for _, _, s in matches)
        n_h = n_r = len(matches)
        spans = [(i, i, j, j) for i, j, _ in matches]
        if len(weights) >= 4:
            used_h = [False] * len(hyp)
            used_r = [False] * len(ref)
            for i, j, _ in matches:
                used_h[i] = used_r[j] = True
            for i1, i2, j1, j2 in _phrase_matches(hyp, ref, used_h, used_r):
                lh, lr = i2 - i1 + 1, j2 - j1 + 1
                m_h += weights[3] * lh
                m_r += weights[3] * lr
                n_h += lh
                n_r += lr
                spans.append((i1, i2, j1, j2))
        if m_h == 0 or m_r == 0:
            continue
        P = m_h / len(hyp)
        R = m_r / len(ref)
        # Fmean = 10PR/(R+9P): recall-dominant harmonic mean
        f_mean = P * R / (ALPHA * P + (1 - ALPHA) * R)
        spans.sort()
        frag = _chunks_spans(spans) / ((n_h + n_r) / 2)
        penalty = GAMMA * (frag ** BETA)
        score = (1.0 - penalty) * f_mean
        best = max(best, score)
    return best


def compute_meteor(gts: Dict, res: Dict) -> Tuple[float, np.ndarray]:
    assert list(gts.keys()) == list(res.keys())
    scores = [meteor_sentence(res[k][0], gts[k]) for k in gts]
    return float(np.mean(scores)), np.asarray(scores)
