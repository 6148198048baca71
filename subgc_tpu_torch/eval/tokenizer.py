"""PTB-style tokenizer in pure Python.

The reference shells out to the Stanford CoreNLP PTBTokenizer jar
(`misc/coco-caption/pycocoevalcap/tokenizer/ptbtokenizer.py:21,31-33`) with
``-preserveLines -lowerCase`` and strips a fixed punctuation list.  This is a
dependency-free reimplementation of the same pipeline modeled on the
classical PTB ``tokenizer.sed`` rules (the subset that can fire on caption
text): punctuation splitting, contraction splitting (n't, 's, 'll, ...),
bracket normalization, ellipsis/dash handling, and lowercasing.

On model-generated captions (vocab words joined by single spaces, no
punctuation) the output is byte-identical to the jar; on arbitrary GT text,
divergence vs a sed-rules oracle is fuzzed and enumerated in
tests/test_tokenizer_fuzz.py (see docs/METRICS.md).

Jar-pipeline subtlety reproduced here: the jar is invoked with ``-lowerCase``
so its bracket tokens arrive LOWERCASED (``-lrb-``), while the wrapper's
punctuation strip matches the uppercase strings ``-LRB-``... case-sensitively
(ptbtokenizer.py:24-25,69-70) — so bracket tokens SURVIVE tokenization in the
reference pipeline.  We emit them lowercased and the strip leaves them alone,
matching the jar end-to-end (including ``-LSB-``/``-RSB-`` for square
brackets, which the wrapper's list never contained in any case).

The port's own copy of ``subgc_tpu/eval/tokenizer.py``, held equal to it
by ``tests/test_torch_port_scorers.py``.
"""
from __future__ import annotations

import re
from typing import Dict, List

# tokens the coco-caption wrapper removes after tokenization
PUNCTUATIONS = ["''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
                ".", "?", "!", ",", ":", "-", "--", "...", ";"]
_PUNCT_SET = set(PUNCTUATIONS)

_CONTRACTIONS2 = re.compile(r"\b(can)(not)\b", re.I)
_RULES = [
    # ellipsis
    (re.compile(r"\.\.\."), r" ... "),
    # brackets -> PTB symbols (lowercase: see module docstring)
    (re.compile(r"\("), " -lrb- "),
    (re.compile(r"\)"), " -rrb- "),
    (re.compile(r"\{"), " -lcb- "),
    (re.compile(r"\}"), " -rcb- "),
    (re.compile(r"\["), " -lsb- "),
    (re.compile(r"\]"), " -rsb- "),
    # most punctuation splits off
    (re.compile(r"([;@#$%&?!])"), r" \1 "),
    (re.compile(r"([^\.])(\.)([\]\)}>\"']*)\s*$"), r"\1 \2\3 "),
    (re.compile(r"[,](?=[^\d])|(?<=[^\d])[,]"), " , "),
    (re.compile(r":"), " : "),
    # double dash
    (re.compile(r"--"), " -- "),
    # quotes
    (re.compile(r'^"'), "`` "),
    (re.compile(r'(?<=[ (\[{<])"'), " `` "),
    (re.compile(r'"'), " '' "),
    # closing single quote: apostrophe at word end splits off (covers
    # possessives "dogs'" and quote closes; contraction suffixes like 's
    # are never word-final-apostrophe so they are untouched)
    (re.compile(r"([^' ])' "), r"\1 ' "),
    # contractions (after quote handling so apostrophes survive)
    (re.compile(r"([^' ])('[sSmMdD]|'ll|'LL|'re|'RE|'ve|'VE|n't|N'T) "),
     r"\1 \2 "),
    (re.compile(r"([^' ])('[sSmMdD]|'ll|'LL|'re|'RE|'ve|'VE|n't|N'T)$"),
     r"\1 \2"),
]


def ptb_tokenize_sentence(s: str, lowercase: bool = True) -> List[str]:
    s = " " + s.replace("\n", " ").strip() + " "
    s = _CONTRACTIONS2.sub(r" \1 \2 ", s)
    for pat, rep in _RULES:
        s = pat.sub(rep, s)
    toks = s.split()
    if lowercase:
        toks = [t.lower() for t in toks]
    return toks


def tokenize(captions_for_image: Dict) -> Dict[object, List[str]]:
    """Drop-in for PTBTokenizer.tokenize: {id: [{'caption': str}]} ->
    {id: [tokenized_str]}, with the wrapper's punctuation removal."""
    out = {}
    for k, caps in captions_for_image.items():
        out[k] = []
        for c in caps:
            text = c["caption"] if isinstance(c, dict) else c
            toks = [w for w in ptb_tokenize_sentence(text)
                    if w not in _PUNCT_SET]
            out[k].append(" ".join(toks))
    return out
