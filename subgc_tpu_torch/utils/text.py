"""Token-sequence -> string decoding (misc/utils.py:16-17,59-81)."""
from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

BAD_ENDINGS = ['with', 'in', 'on', 'of', 'a', 'at', 'to', 'for', 'an', 'this',
               'his', 'her', 'that', 'the']


def decode_sequence(ix_to_word: Dict[str, str], seq,
                    remove_bad_endings: bool = None) -> List[str]:
    """Decode [N, T] token ids to strings; 0 terminates (misc/utils.py:59-81).

    remove_bad_endings=None reads the REMOVE_BAD_ENDINGS env var like the
    reference; pass a bool to override.
    """
    if remove_bad_endings is None:
        remove_bad_endings = bool(int(os.getenv("REMOVE_BAD_ENDINGS", "0")))
    seq = np.asarray(seq)
    out = []
    for row in seq:
        words = []
        for ix in row:
            ix = int(ix)
            if ix <= 0:
                break
            words.append(ix_to_word[str(ix)])
        if remove_bad_endings and words:
            # strip the longest bad-ending suffix (misc/utils.py:72-79)
            flag = 0
            for j in range(len(words)):
                if words[-j - 1] not in BAD_ENDINGS:
                    flag = -j
                    break
            words = words[:len(words) + flag]
        out.append(' '.join(words))
    return out
