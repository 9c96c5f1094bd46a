"""Question tokenization and encoding, as the model was trained on them.

The port's own copy of ``dl_vqa_tpu/data/text.py::normalize_question`` and
``dl_vqa_tpu/data/dataset.py::encode_question`` (the port imports nothing
of that package); ``tests/test_torch_copies.py`` holds each to its
original.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

__all__ = ["normalize_question", "encode_question"]


def normalize_question(question: str) -> List[str]:
    """Tokenize one raw question: it must end with '?'; lowercase, strip
    the '?', split on single spaces (so a double space gives an empty
    token, as in the VQA preprocessing the vocabulary was built with)."""
    if question[-1] != "?":
        raise ValueError(f"Question does not end with '?': {question!r}")
    return question.lower()[:-1].split(" ")


def encode_question(tokens: List[str], vocab: Dict[str, int], max_len: int
                    ) -> Tuple[np.ndarray, int]:
    """One tokenized question -> (zero-padded int32 ids ``[max_len]``,
    token count); a word outside the vocabulary gets id 0."""
    vec = np.zeros(max_len, dtype=np.int32)
    for i, tok in enumerate(tokens):
        vec[i] = vocab.get(tok, 0)
    return vec, len(tokens)
