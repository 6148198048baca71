"""Small rule-based English lemmatizer: the port's own copy of
``subgc_tpu/utils/lemma.py`` (pure Python, kept equal to it by
``tests/test_torch_port_greedy.py``).

Replaces the Stanford CoreNLP lemma server the reference's grounding eval
shells into (`misc/grounding/eval_grd_flickr30k_entities.py:124-126,164` —
only ever called on single tokens: detection class names and caption words).
Coverage target: the Flickr30k-Entities / Visual-Genome style class
vocabulary (visual object nouns, frequently plural) plus the caption-token
vocabulary the exclude-list path lemmatizes (nouns AND verbs).  Breadth is
pinned by tests/test_lemma_breadth.py against hand-expected lemmas for ~200
words of that vocabulary.

Rules: irregular table -> noun plural suffix rules -> verb -ing/-ed rules
(doubled-consonant undo + e-restore table).
"""
from __future__ import annotations

IRREGULAR = {
    # irregular noun plurals
    "men": "man", "women": "woman", "children": "child", "people": "person",
    "feet": "foot", "teeth": "tooth", "geese": "goose", "mice": "mouse",
    "oxen": "ox", "cacti": "cactus",
    # -f/-fe plurals
    "wolves": "wolf", "knives": "knife", "leaves": "leaf", "lives": "life",
    "shelves": "shelf", "loaves": "loaf", "scarves": "scarf",
    "calves": "calf", "halves": "half", "thieves": "thief",
    "wives": "wife", "hooves": "hoof", "elves": "elf",
    # -oes plurals (vs shoes/toes/canoes which keep the e)
    "potatoes": "potato", "tomatoes": "tomato", "mosquitoes": "mosquito",
    "heroes": "hero", "echoes": "echo", "volcanoes": "volcano",
    # be/have and common irregular verbs (caption exclude-list path)
    "was": "be", "were": "be", "is": "be", "are": "be", "am": "be",
    "been": "be", "being": "be", "has": "have", "had": "have",
    "ran": "run", "running": "run", "sat": "sit", "sitting": "sit",
    "stood": "stand", "standing": "stand", "held": "hold", "ate": "eat",
    "went": "go", "did": "do", "done": "do", "said": "say", "made": "make",
    "rode": "ride", "drove": "drive", "threw": "throw", "caught": "catch",
    "flew": "fly", "swam": "swim", "sang": "sing", "slept": "sleep",
    "wore": "wear", "took": "take", "gave": "give", "got": "get",
    "lying": "lie", "tying": "tie",
    # -es plurals the suffix rules cannot decide
    "buses": "bus", "glasses": "glass", "dresses": "dress",
    "dishes": "dish", "benches": "bench", "beaches": "beach",
    "watches": "watch", "sandwiches": "sandwich", "churches": "church",
    "boxes": "box", "foxes": "fox",
    # -is endings the plural guard would otherwise keep
    "taxis": "taxi", "skis": "ski",
    # found by the VG-1600 class-vocabulary coverage eval
    # (tools/lemma_coverage.py): -ies that keep the e, and the "skiis"
    # typo class VG ships (object_names_1600-0-20.npy)
    "veggies": "veggie", "skiis": "ski", "cookies": "cookie",
    "hoodies": "hoodie", "selfies": "selfie", "movies": "movie",
    "smoothies": "smoothie", "ties": "tie", "pies": "pie",
    # found by the caption-corpus coverage eval (CoreNLP-style lemmas the
    # suffix rules miss: short -ing stems below the length guard, article
    # and pronoun forms)
    "an": "a", "its": "its", "them": "they", "going": "go",
    "using": "use", "doing": "do",
}

# invariant words ending in s
_KEEP_S = {"gas", "bus", "grass", "glass", "dress", "class", "chess",
           "tennis", "jeans", "pants", "shorts", "scissors", "sunglasses",
           "clothes", "pliers", "series", "species", "news", "lens"}

# verbs whose -ing/-ed form restores a trailing e (riding -> ride)
_E_RESTORE = {
    "rid": "ride", "driv": "drive", "skat": "skate", "smil": "smile",
    "wav": "wave", "danc": "dance", "pos": "pose", "serv": "serve",
    "div": "dive", "rac": "race", "glid": "glide", "bik": "bike",
    "hik": "hike", "bak": "bake", "slic": "slice", "writ": "write",
    "tak": "take", "mak": "make", "com": "come", "giv": "give",
    "leav": "leave", "shak": "shake", "star": "stare", "prepar": "prepare",
    "saut": "saute", "juggl": "juggle", "paddl": "paddle",
    "cradl": "cradle", "smok": "smoke", "gaz": "gaze", "shar": "share",
    "tast": "taste", "wad": "wade", "chas": "chase", "plac": "place",
    "graz": "graze", "hid": "hide", "mov": "move",
}

_VOWELS = set("aeiou")

# -ing words that are nouns in caption/class vocabulary, not verb forms
_KEEP_ING = {"ceiling", "building", "painting", "railing", "awning",
             "clothing", "icing", "siding", "landing", "morning", "evening",
             "wedding", "living", "dining", "earring", "lightning",
             "frosting", "topping", "dressing", "crossing", "bedding",
             "duckling", "seasoning", "carving", "drawing"}


def _strip_verb_suffix(w: str, n: int) -> str:
    """Undo -ing/-ed morphology on the stem w[:-n]."""
    base = w[:-n]
    if base in _E_RESTORE:
        return _E_RESTORE[base]
    # doubled final consonant: sitting -> sitt -> sit (keep ll/ss: pulling)
    if (len(base) > 2 and base[-1] == base[-2]
            and base[-1] not in _VOWELS and base[-1] not in "lsz"):
        return base[:-1]
    return base


def lemmatize(word: str) -> str:
    w = word.lower()
    if w in IRREGULAR:
        return IRREGULAR[w]
    if w in _KEEP_S:
        return w
    # noun plurals
    if len(w) > 3 and w.endswith("ies"):
        return w[:-3] + "y"
    if len(w) > 3 and w.endswith(("ches", "shes", "xes", "sses", "zes")):
        return w[:-2]
    if len(w) > 2 and w.endswith("s") and not w.endswith(("ss", "us", "is")):
        return w[:-1]
    # verb inflections (single caption tokens; CoreNLP lemmatizes these too)
    if (len(w) > 5 and w.endswith("ing") and w not in _KEEP_ING
            and any(c in _VOWELS or c == "y" for c in w[:-3])):
        return _strip_verb_suffix(w, 3)
    if len(w) > 4 and w.endswith("ied"):
        return w[:-3] + "y"
    if len(w) > 4 and w.endswith("ed") and any(c in _VOWELS for c in w[:-2]):
        return _strip_verb_suffix(w, 2)
    return w
