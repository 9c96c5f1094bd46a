"""Vocabulary construction for questions and answers.

The port's copy of ``dl_vqa_tpu/data/vocab.py`` (held to it by
``tests/test_torch_copies.py``): the question vocab holds every token of the
training questions; the answer vocab the ``max_answers`` most frequent
normalized answers (``Counter.most_common``), re-sorted by ``(count,
token)`` descending; ids start at 1 (0 is unknown / padding); the JSON
file is ``{"question": {...}, "answer": {...}}``.
"""

from __future__ import annotations

import json
import os
from collections import Counter
from typing import Dict, Iterable, List, Optional

from dl_vqa_tpu_torch.data import text as vqa_text

__all__ = ["build_vocab", "create_vocab", "load_vocab", "UNKNOWN_TOKEN_ID"]

UNKNOWN_TOKEN_ID = 0


def build_vocab(
    token_lists: Iterable[List[str]],
    top_k: Optional[int] = None,
    start: int = 0,
) -> Dict[str, int]:
    """A token -> id mapping from an iterable of token lists: with
    ``top_k``, the candidates are ``Counter.most_common(top_k)``; ids go by
    ``(count, token)`` descending, counting up from ``start``."""
    counts: Counter = Counter()
    for tokens in token_lists:
        counts.update(tokens)

    if top_k is not None:
        candidates = [tok for tok, _ in counts.most_common(top_k)]
    else:
        candidates = list(counts.keys())

    ordered = sorted(candidates, key=lambda t: (counts[t], t), reverse=True)
    return {tok: i for i, tok in enumerate(ordered, start=start)}


def create_vocab(
    data_base_path: str,
    data_paths: dict,
    vocab_path: str,
    max_answers: int = 3000,
) -> Dict[str, Dict[str, int]]:
    """Build the question and answer vocabs from VQA-format JSONs and
    write ``vocab_path``."""
    with open(os.path.join(data_base_path, data_paths["questions"])) as fd:
        questions_json = json.load(fd)
    with open(os.path.join(data_base_path, data_paths["answers"])) as fd:
        answers_json = json.load(fd)

    question_vocab = build_vocab(
        vqa_text.prepare_questions(questions_json), start=1
    )
    answer_vocab = build_vocab(
        vqa_text.prepare_answers(answers_json), top_k=max_answers, start=1
    )

    vocabs = {"question": question_vocab, "answer": answer_vocab}
    with open(vocab_path, "w") as fd:
        json.dump(vocabs, fd)
    return vocabs


def load_vocab(vocab_path: str) -> Dict[str, Dict[str, int]]:
    with open(vocab_path) as fd:
        return json.load(fd)
