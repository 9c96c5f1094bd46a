"""Question tokenization and encoding, and answer normalization, as the
model was trained on them.

The port's own copy of ``dl_vqa_tpu/data/text.py`` (question tokenizer,
the official VQA answer normalization with its tables and regexes, the
JSON walkers) and of ``dl_vqa_tpu/data/dataset.py::encode_question`` and
``::encode_answers`` (the port imports nothing of that package);
``tests/test_torch_copies.py`` holds each to its original. The tables and
the two regexes are part of the VQA-accuracy contract, quirks included (a
malformed lookbehind in the period regex, a ``count`` of 32 where the
reference passed ``re.UNICODE``).
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, List, Tuple

import numpy as np

__all__ = ["normalize_question", "encode_question", "normalize_answer",
           "encode_answers", "prepare_questions", "prepare_answers",
           "CONTRACTIONS", "NUMBER_WORDS", "ARTICLES", "PUNCT_CHARS"]


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


def encode_answers(answers: List[str], vocab: Dict[str, int]
                   ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Normalized answers -> (unique 1-based ids, counts, n_unique); an
    answer outside the vocabulary is dropped."""
    in_vocab = [vocab[a] for a in answers if a in vocab]
    if not in_vocab:
        return (np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64), 0)
    unique, counts = np.unique(in_vocab, return_counts=True)
    return unique.astype(np.int64), counts.astype(np.int64), len(unique)


# Regexes of the official VQA eval script (including the malformed
# lookbehind in the first, see the module docstring).
_PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
_COMMA_IN_NUMBER = re.compile(r"(\d)(\,)(\d)")

# Punctuation handled by the answer normalizer (official VQA set).
PUNCT_CHARS: List[str] = [
    ";", "/", "[", "]", '"', "{", "}",
    "(", ")", "=", "+", "\\", "_", "-",
    ">", "<", "@", "`", ",", "?", "!",
]

# Number words mapped to digits (official VQA map; 'none' -> '0' included).
NUMBER_WORDS = {
    "none": "0", "zero": "0", "one": "1", "two": "2", "three": "3",
    "four": "4", "five": "5", "six": "6", "seven": "7", "eight": "8",
    "nine": "9", "ten": "10",
}

ARTICLES = frozenset({"a", "an", "the"})

# Official VQA contraction canonicalization table (apostrophe-less and
# half-contracted spellings -> canonical contraction).
CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't",
    "couldve": "could've", "couldnt": "couldn't",
    "couldn'tve": "couldn't've", "couldnt've": "couldn't've",
    "didnt": "didn't", "doesnt": "doesn't", "dont": "don't",
    "hadnt": "hadn't", "hadnt've": "hadn't've", "hadn'tve": "hadn't've",
    "hasnt": "hasn't", "havent": "haven't", "hed": "he'd",
    "hed've": "he'd've", "he'dve": "he'd've", "hes": "he's",
    "howd": "how'd", "howll": "how'll", "hows": "how's",
    "Id've": "I'd've", "I'dve": "I'd've", "Im": "I'm", "Ive": "I've",
    "isnt": "isn't", "itd": "it'd", "itd've": "it'd've",
    "it'dve": "it'd've", "itll": "it'll", "let's": "let's",
    "maam": "ma'am", "mightnt": "mightn't", "mightnt've": "mightn't've",
    "mightn'tve": "mightn't've", "mightve": "might've",
    "mustnt": "mustn't", "mustve": "must've", "neednt": "needn't",
    "notve": "not've", "oclock": "o'clock", "oughtnt": "oughtn't",
    "ow's'at": "'ow's'at", "'ows'at": "'ow's'at", "'ow'sat": "'ow's'at",
    "shant": "shan't", "shed've": "she'd've", "she'dve": "she'd've",
    "she's": "she's", "shouldve": "should've", "shouldnt": "shouldn't",
    "shouldnt've": "shouldn't've", "shouldn'tve": "shouldn't've",
    "somebody'd": "somebodyd", "somebodyd've": "somebody'd've",
    "somebody'dve": "somebody'd've", "somebodyll": "somebody'll",
    "somebodys": "somebody's", "someoned": "someone'd",
    "someoned've": "someone'd've", "someone'dve": "someone'd've",
    "someonell": "someone'll", "someones": "someone's",
    "somethingd": "something'd", "somethingd've": "something'd've",
    "something'dve": "something'd've", "somethingll": "something'll",
    "thats": "that's", "thered": "there'd", "thered've": "there'd've",
    "there'dve": "there'd've", "therere": "there're", "theres": "there's",
    "theyd": "they'd", "theyd've": "they'd've", "they'dve": "they'd've",
    "theyll": "they'll", "theyre": "they're", "theyve": "they've",
    "twas": "'twas", "wasnt": "wasn't", "wed've": "we'd've",
    "we'dve": "we'd've", "weve": "we've", "werent": "weren't",
    "whatll": "what'll", "whatre": "what're", "whats": "what's",
    "whatve": "what've", "whens": "when's", "whered": "where'd",
    "wheres": "where's", "whereve": "where've", "whod": "who'd",
    "whod've": "who'd've", "who'dve": "who'd've", "wholl": "who'll",
    "whos": "who's", "whove": "who've", "whyll": "why'll",
    "whyre": "why're", "whys": "why's", "wont": "won't",
    "wouldve": "would've", "wouldnt": "wouldn't",
    "wouldnt've": "wouldn't've", "wouldn'tve": "wouldn't've",
    "yall": "y'all", "yall'll": "y'all'll", "y'allll": "y'all'll",
    "yall'd've": "y'all'd've", "y'alld've": "y'all'd've",
    "y'all'dve": "y'all'd've", "youd": "you'd", "youd've": "you'd've",
    "you'dve": "you'd've", "youll": "you'll", "youre": "you're",
    "youve": "you've",
}


def _strip_punctuation(text: str) -> str:
    """Official VQA punctuation handling (ref ``data_preprocessing.py:271-280``)."""
    out = text
    has_comma_number = _COMMA_IN_NUMBER.search(text) is not None
    for ch in PUNCT_CHARS:
        # Deletion-vs-space decision is made against the ORIGINAL text.
        if (ch + " " in text) or (" " + ch in text) or has_comma_number:
            out = out.replace(ch, "")
        else:
            out = out.replace(ch, " ")
    # The reference calls period_strip.sub("", text, re.UNICODE)
    # (ref data_preprocessing.py:279) — but Pattern.sub's third
    # positional parameter is COUNT, and re.UNICODE == 32, so only the
    # first 32 period matches are stripped. Reproduced for byte parity
    # (same class of load-bearing quirk as the malformed lookbehind).
    return _PERIOD_STRIP.sub("", out, 32)


def _canonicalize_words(text: str) -> str:
    """Number-word mapping, article removal, contraction canonicalization
    (ref ``data_preprocessing.py:282-295``; the reference's
    ``setdefault(word, word)`` inserts identity entries, which is
    observationally identical to a plain ``get`` — we use ``get``).
    """
    kept = [
        NUMBER_WORDS.get(word, word)
        for word in text.lower().split()
        if word not in ARTICLES
    ]
    return " ".join(CONTRACTIONS.get(word, word) for word in kept)


def normalize_answer(answer: str) -> str:
    """Full answer normalization pipeline (ref ``data_preprocessing.py:266-269``)."""
    return _canonicalize_words(_strip_punctuation(answer)).replace(",", "")


def prepare_questions(questions_json: dict) -> Iterator[List[str]]:
    """Yield tokenized questions from a VQA-format questions JSON."""
    for entry in questions_json["questions"]:
        yield normalize_question(entry["question"])


def prepare_answers(answers_json: dict) -> Iterator[List[str]]:
    """Yield per-annotation lists of normalized answers from a VQA-format
    annotations JSON (10 human answers per question)."""
    for annotation in answers_json["annotations"]:
        yield [normalize_answer(a["answer"]) for a in annotation["answers"]]
