"""Synthetic VQA 2.0-format corpus, rendered with numpy alone.

The port's copy of ``dl_vqa_tpu/data/synthetic.py::generate_vqa_split``
and its attribute helpers (pure ``random``; held to the original by
``tests/test_torch_copies.py``), and a renderer of its own: where the JAX
package writes COCO-named JPEGs through PIL and then builds the h5 cache
from them (resize, centre crop, normalize), :func:`render_images` draws
the same attributes straight at ``image_size`` and
:func:`write_image_store` writes the normalized fp16 ``features [N, 3, H,
W]`` and ``ids [N]`` as an ``.npy`` pair in a directory, the image store
:class:`dl_vqa_tpu_torch.data.dataset.VQADataset` memory-maps. No JPEG,
no resize, no PIL, no h5py: this is how a corpus is made on the card.

    python -m dl_vqa_tpu_torch.data.synthetic ROOT [--n-train 4096]
        [--n-val 1024] [--n-images 512] [--n-val-images 128]
        [--image-size 224] [--learnable] [--question-tokens 15193
        --question-length 23]

``--question-tokens`` and ``--question-length`` widen the questions to a
real vocabulary and length (:func:`widen_questions`), so a model built on
the corpus has the reference's embedding and sequence length.
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, List, Tuple

import numpy as np

from dl_vqa_tpu_torch.data.images import normalize_uint8_chw

__all__ = ["generate_vqa_split", "widen_questions", "render_images",
           "write_image_store", "make_synthetic_corpus"]

_QUESTION_WORDS = [
    "what", "is", "the", "color", "of", "cat", "dog", "how", "many",
    "people", "are", "in", "picture", "on", "table", "wearing", "man",
    "woman", "doing", "this", "a", "red", "ball", "there",
]

_ANSWERS = [
    "yes", "no", "2", "red", "blue", "cat", "dog", "1", "3", "white",
    "green", "frisbee", "skateboard", "0", "black", "brown", "tennis",
    "pizza", "kitchen", "baseball",
]

# ---- learnable mode (opt-in): answers are a deterministic function of
# rendered image attributes + the question's type word, so training can
# actually CONVERGE on the corpus (the default mode's answers are random
# — any model sits at the answer prior, which is the right property for
# byte-stable fixtures but useless for accuracy-sensitive measurements
# like the f8-stem quantization delta, experiments/probe_f8_accuracy.py).

_COLOR_RGB = {
    "red": (200, 40, 40), "blue": (40, 60, 200), "green": (40, 180, 60),
    "white": (230, 230, 230), "black": (25, 25, 25), "brown": (140, 90, 40),
}
_COLOR_NAMES = sorted(_COLOR_RGB)
_FILLER = ["the", "in", "this", "picture", "a", "of", "there"]


def _image_attrs(image_id: int, seed: int) -> Dict[str, object]:
    """Deterministic render attributes for an image id — shared by the
    question/answer generator and the image renderer so they agree."""
    rng = random.Random((seed << 20) ^ image_id)
    return {
        "color": rng.choice(_COLOR_NAMES),
        "count": rng.randint(0, 3),
        "bright": rng.random() < 0.5,
    }


# ---- hard mode (learnable="hard"): a LOWER-ceiling task for accuracy-
# sensitivity measurements (the 99.6%-ceiling easy task cannot surface
# quantization damage). Three properties matter:
#   * fine-grained classes whose pixel evidence is small relative to the
#     render noise (12 hue bins ~30 degrees apart under sigma~0.55-bin
#     hue jitter; 3 size bins with continuous sizes near the edges), so
#     the Bayes ceiling is well below 100% and activation precision in
#     the stem carries real information;
#   * more classes overall (12 hues + 9 counts + 3 sizes = 24 targets
#     vs the easy task's 12);
#   * lower annotator agreement (0.75 vs 0.9), softening the targets.

_HUE_BINS = 12
_HUE_NAMES = [f"hue{i}" for i in range(_HUE_BINS)]
_SIZE_EDGES = (0.055, 0.085)            # fractions of image height
_SIZE_NAMES = ("small", "medium", "large")
_HUE_NOISE = 0.75 / _HUE_BINS           # sigma of the rendered-hue jitter
_SIZE_NOISE = 0.008                     # sigma of the rendered-size jitter
_MAX_COUNT = 8


def _hard_image_attrs(image_id: int, seed: int) -> Dict[str, object]:
    rng = random.Random((seed << 21) ^ (image_id * 2654435761))
    hue_bin = rng.randrange(_HUE_BINS)
    # The RENDERED hue is jittered around the bin center; adjacent bins
    # genuinely overlap, capping attainable hue accuracy.
    hue = ((hue_bin + 0.5) / _HUE_BINS + rng.gauss(0.0, _HUE_NOISE)) % 1.0
    size_frac = rng.uniform(0.03, 0.115)
    size_bin = sum(size_frac > e for e in _SIZE_EDGES)
    return {
        "hue_bin": hue_bin,
        "hue": hue,
        "count": rng.randint(0, _MAX_COUNT),
        "size_frac": size_frac,
        # The RENDERED size is jittered too, so sizes near a bin edge
        # are genuinely ambiguous from pixels.
        "render_size_frac": max(0.015, size_frac + rng.gauss(0.0, _SIZE_NOISE)),
        "size_bin": size_bin,
        "layout_seed": rng.randrange(1 << 30),
    }


def _hard_qa(attrs: Dict[str, object], rng: random.Random):
    kind = rng.choice(("hue", "count", "size"))
    pre = " ".join(rng.choice(_FILLER) for _ in range(rng.randint(0, 2)))
    if kind == "hue":
        text, ans, atype = (
            "what shade is the background", _HUE_NAMES[attrs["hue_bin"]],
            "other",
        )
    elif kind == "count":
        text, ans, atype = (
            "how many squares", str(attrs["count"]), "number"
        )
    else:
        text, ans, atype = (
            "what size are the squares", _SIZE_NAMES[attrs["size_bin"]],
            "other",
        )
    full = (pre + " " + text).strip() + "?"
    return full, ans, atype


def _hard_neighbor(answer: str, rng: random.Random) -> str:
    """A plausible annotator confusion for a hard-task answer: the
    adjacent hue bin / count / size class (disagreeing annotators pick
    neighbors, not arbitrary words — this is what spreads the soft
    targets onto the confusable classes). At class-range boundaries the
    step REFLECTS (0 -> 1, 8 -> 7, small -> medium) so edge classes get
    the same effective disagreement rate as interior ones — a clamp
    would silently return the main answer and raise edge-class
    agreement above the documented 0.75."""
    step = rng.choice((-1, 1))
    if answer.startswith("hue"):
        return _HUE_NAMES[(int(answer[3:]) + step) % _HUE_BINS]
    if answer.isdigit():
        n = int(answer) + step
        if n < 0 or n > _MAX_COUNT:
            n = int(answer) - step
        return str(n)
    if answer in _SIZE_NAMES:
        i = _SIZE_NAMES.index(answer) + step
        if i < 0 or i >= len(_SIZE_NAMES):
            i = _SIZE_NAMES.index(answer) - step
        return _SIZE_NAMES[i]
    return answer


def _learnable_qa(attrs: Dict[str, object], rng: random.Random):
    """One (question_text, answer, answer_type) for an image."""
    kind = rng.choice(("color", "count", "bright"))
    pre = " ".join(rng.choice(_FILLER) for _ in range(rng.randint(0, 2)))
    if kind == "color":
        text, ans, atype = "what color is it", attrs["color"], "other"
    elif kind == "count":
        text, ans, atype = "how many squares", str(attrs["count"]), "number"
    else:
        text, ans = "is it bright", ("yes" if attrs["bright"] else "no")
        atype = "yes/no"
    full = (pre + " " + text).strip() + "?"
    return full, ans, atype


def generate_vqa_split(
    n_questions: int,
    n_images: int,
    seed: int = 0,
    data_subtype: str = "train2014",
    learnable: "bool | str" = False,
    attr_seed: int = 0,
) -> Tuple[dict, dict, List[int]]:
    """Return (questions_json, annotations_json, image_ids).

    ``learnable=True`` ties each answer to the image's rendered
    attributes (see :func:`_image_attrs`; ``attr_seed`` must match the
    renderer's seed) so a model can actually learn the corpus; the
    default keeps answers random (byte-stable fixtures, prior-level
    accuracy by construction)."""
    rng = random.Random(seed)
    image_ids = [1000 + i for i in range(n_images)]
    questions, annotations = [], []
    for qid in range(n_questions):
        image_id = rng.choice(image_ids)
        if learnable == "hard":
            attrs = _hard_image_attrs(image_id, attr_seed)
            text, main_answer, _ = _hard_qa(attrs, rng)
            if text.endswith("size are the squares?") and attrs["count"] == 0:
                # no squares rendered: a size question has no evidence;
                # ask the (answerable) count question instead
                text, main_answer = "how many squares?", "0"
            conc = 0.75  # lower agreement: softer targets, lower ceiling
        elif learnable:
            # answer_type is re-derived from the answer below, same as
            # the random branch (colors -> other, digits -> number).
            text, main_answer, _ = _learnable_qa(
                _image_attrs(image_id, attr_seed), rng
            )
            conc = 0.9  # annotator agreement; the 0.3-coeff metric's soft
        else:           # targets stay non-degenerate either way
            n_words = rng.randint(3, 9)
            text = " ".join(
                rng.choice(_QUESTION_WORDS) for _ in range(n_words)
            ) + "?"
            main_answer, conc = rng.choice(_ANSWERS), 0.6
        questions.append(
            {"question_id": qid, "image_id": image_id, "question": text}
        )
        def _disagreement():
            if learnable == "hard":
                return _hard_neighbor(main_answer, rng)
            return rng.choice(_ANSWERS)

        answers = [
            {
                "answer": main_answer if rng.random() < conc
                else _disagreement(),
                "answer_confidence": "yes",
                "answer_id": k + 1,
            }
            for k in range(10)
        ]
        if main_answer in ("yes", "no"):
            answer_type = "yes/no"
        elif main_answer.isdigit():
            answer_type = "number"
        else:
            answer_type = "other"
        annotations.append(
            {
                "question_id": qid,
                "image_id": image_id,
                "multiple_choice_answer": main_answer,
                "answers": answers,
                "question_type": "none of the above",
                "answer_type": answer_type,
            }
        )
    questions_json = {
        "info": {}, "task_type": "Open-Ended", "data_type": "mscoco",
        "data_subtype": data_subtype, "license": {}, "questions": questions,
    }
    annotations_json = {
        "info": {}, "data_type": "mscoco", "data_subtype": data_subtype,
        "license": {}, "annotations": annotations,
    }
    return questions_json, annotations_json, image_ids


def widen_questions(splits: List[dict], num_tokens: int, max_length: int,
                    seed: int = 0) -> None:
    """Prefix filler words (``zq00000``, ...) to the questions of
    ``splits`` (question JSONs, the train split first), in place, so that a
    vocab built from the train split holds ``num_tokens - 1`` words (a
    model's ``num_tokens`` counts the unknown id too) and the first
    question of each split has ``max_length`` tokens, the others at most
    that. The train split spreads every filler word over its questions in
    order, each question taking at least its share of the words left and
    0 to 4 at random; the other splits draw theirs from the same words.
    Raises ``ValueError`` where the train split has too few questions, or
    its own words leave no room, for that."""
    from dl_vqa_tpu_torch.data import text as vqa_text

    def lengths(questions_json):
        return [len(t) for t in vqa_text.prepare_questions(questions_json)]

    train = splits[0]
    natural = set()
    for tokens in vqa_text.prepare_questions(train):
        natural.update(tokens)
    n_fill = num_tokens - 1 - len(natural)
    if n_fill < 0:
        raise ValueError(f"the train questions already hold {len(natural)} "
                         f"words, more than num_tokens - 1 = "
                         f"{num_tokens - 1}")
    words = [f"zq{i:05d}" for i in range(n_fill)]
    rng = random.Random(seed)
    for n_split, questions_json in enumerate(splits):
        questions = questions_json["questions"]
        cursor = 0
        for i, (q, length) in enumerate(zip(questions,
                                            lengths(questions_json))):
            room = max_length - length
            if room < 0:
                raise ValueError(f"question {q['question_id']} has {length} "
                                 f"tokens, more than {max_length}")
            extra = room if i == 0 else min(room, rng.randint(0, 4))
            if n_split == 0:
                share = -(-(n_fill - cursor) // (len(questions) - i))
                extra = max(extra, min(room, share))
                fill = words[cursor:cursor + extra]
                cursor += len(fill)
                fill += [rng.choice(words) for _ in range(extra - len(fill))]
            else:
                fill = [rng.choice(words) for _ in range(extra)]
            if fill:
                q["question"] = " ".join(fill) + " " + q["question"]
        if n_split == 0 and cursor < n_fill:
            raise ValueError(f"{len(questions)} train questions of at most "
                             f"{max_length} tokens cannot hold {n_fill} "
                             f"filler words")


def render_images(image_ids: List[int], image_size: int, seed: int = 0,
                  learnable: "bool | str" = False,
                  rng: "np.random.Generator | None" = None) -> np.ndarray:
    """uint8 ``[N, S, S, 3]`` images for ``image_ids``, drawn from the
    attributes :func:`generate_vqa_split` asks about (``seed`` must be its
    ``attr_seed``): random pixels by default; with ``learnable=True`` a
    color-tinted noisy background whose brightness encodes the yes/no
    answer, with ``count`` mid-gray squares; with ``"hard"`` a hue-binned
    background with ``count`` squares of the size class. The noise comes
    from ``rng`` (``np.random.default_rng(seed)`` when omitted) in the
    order of the ids, so rendering in slices with one ``rng`` gives the
    same images as one call."""
    rng = np.random.default_rng(seed) if rng is None else rng
    h = w = image_size
    out = np.empty((len(image_ids), h, w, 3), dtype=np.uint8)
    for n, img_id in enumerate(image_ids):
        if learnable == "hard":
            import colorsys

            attrs = _hard_image_attrs(img_id, seed)
            base = np.array(colorsys.hsv_to_rgb(attrs["hue"], 0.65, 0.75),
                            dtype=np.float32) * 255.0
            arr = base[None, None, :] + 26.0 * rng.standard_normal(
                (h, w, 3), dtype=np.float32)
            sq = max(4, int(round(attrs["render_size_frac"] * h)))
            lay = np.random.default_rng(attrs["layout_seed"])
            for _ in range(attrs["count"]):
                y0 = int(lay.integers(1, max(2, h - 1 - sq)))
                x0 = int(lay.integers(1, max(2, w - 1 - sq)))
                arr[y0:y0 + sq, x0:x0 + sq] = float(lay.integers(110, 146))
            out[n] = np.clip(arr, 0, 255).astype(np.uint8)
        elif learnable:
            attrs = _image_attrs(img_id, seed)
            base = np.array(_COLOR_RGB[attrs["color"]], dtype=np.float32)
            scale = 1.0 if attrs["bright"] else 0.45
            arr = base * scale + 18.0 * rng.standard_normal(
                (h, w, 3), dtype=np.float32)
            arr = np.clip(arr, 0, 255).astype(np.uint8)
            sq = max(8, h // 6)
            for k in range(attrs["count"]):
                y0 = (h // 5) * (1 + (k % 2)) + (k // 2) * sq // 2
                x0 = (w // 5) * (1 + k)
                arr[y0:y0 + sq, x0:x0 + sq] = 128
            out[n] = arr
        else:
            out[n] = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    return out


def write_image_store(path: str, image_ids: List[int], image_size: int,
                      seed: int = 0, learnable: "bool | str" = False,
                      chunk: int = 64) -> int:
    """Render ``image_ids`` and write the store at ``path``, a directory
    holding ``features.npy`` (fp16 ``[N, 3, S, S]``, ImageNet-normalized,
    the h5 cache's layout) and ``ids.npy`` (int32 ``[N]``), ``chunk``
    images at a time. Returns the number of images written."""
    os.makedirs(path, exist_ok=True)
    n = len(image_ids)
    features = np.lib.format.open_memmap(
        os.path.join(path, "features.npy"), mode="w+", dtype=np.float16,
        shape=(n, 3, image_size, image_size))
    rng = np.random.default_rng(seed)
    for start in range(0, n, chunk):
        ids = image_ids[start:start + chunk]
        u8 = render_images(ids, image_size, seed, learnable, rng)
        features[start:start + len(ids)] = normalize_uint8_chw(
            u8).astype(np.float16)
    features.flush()
    del features
    np.save(os.path.join(path, "ids.npy"),
            np.asarray(image_ids, dtype=np.int32))
    return n


def make_synthetic_corpus(
    root: str,
    n_train: int = 64,
    n_val: int = 32,
    n_images: int = 12,
    image_size: int = 224,
    max_answers: int = 20,
    seed: int = 0,
    learnable: "bool | str" = False,
    n_val_images: "int | None" = None,
    question_tokens: "int | None" = None,
    question_length: "int | None" = None,
) -> Dict[str, Dict[str, str]]:
    """A complete miniature VQA corpus under ``root``: question and
    annotation JSONs of both splits (as ``dl_vqa_tpu``'s
    ``make_synthetic_corpus`` writes them), an ``.npy`` image store per
    split (``processed_train_images/``, ``processed_val_images/``) and
    ``vocab.json``. The val split asks about its first ``n_val_images``
    images (``n_images`` when omitted). With ``question_tokens`` and
    ``question_length``, :func:`widen_questions` pads the questions to a
    vocab of that many ids and that length. Returns the paths as a config
    profile group (``paths``, ``train_paths``, ``val_paths``)."""
    from dl_vqa_tpu_torch.data import vocab as vocab_mod

    os.makedirs(root, exist_ok=True)
    profile: Dict[str, Dict[str, str]] = {
        "paths": {
            "pretrained_model_path": os.path.join(root, "model.ckpt"),
            "base_path": root,
            "logs": os.path.join(root, "logs/"),
            "vocab_path": os.path.join(root, "vocab.json"),
        },
    }
    n_val_images = n_images if n_val_images is None else n_val_images
    made = {
        split: generate_vqa_split(
            n_q, n_img, seed=seed + (0 if split == "train" else 1),
            data_subtype=subtype, learnable=learnable, attr_seed=seed)
        for split, n_q, n_img, subtype in (
            ("train", n_train, n_images, "train2014"),
            ("val", n_val, n_val_images, "val2014"))}
    if (question_tokens is None) != (question_length is None):
        raise ValueError("question_tokens and question_length go together")
    if question_tokens is not None:
        widen_questions([made["train"][0], made["val"][0]], question_tokens,
                        question_length, seed=seed)
    for split, (qs, anns, image_ids) in made.items():
        subtype = qs["data_subtype"]
        # dumps, not dump: dump streams through the pure-Python encoder.
        with open(os.path.join(root, f"{split}_questions.json"), "w") as fd:
            fd.write(json.dumps(qs))
        with open(os.path.join(root, f"{split}_annotations.json"), "w") as fd:
            fd.write(json.dumps(anns))
        store = os.path.join(root, f"processed_{split}_images")
        write_image_store(store, image_ids, image_size, seed=seed,
                          learnable=learnable)
        profile[f"{split}_paths"] = {
            "vqaDataset": os.path.join(root, f"vqaDataset_{split}.npz"),
            "questions": f"{split}_questions.json",
            "answers": f"{split}_annotations.json",
            "imgs": subtype,
            "processed_imgs": store,
        }
    vocab_mod.create_vocab(
        data_base_path=root, data_paths=profile["train_paths"],
        vocab_path=profile["paths"]["vocab_path"], max_answers=max_answers)
    return profile


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(
        description="Render a VQA-format corpus with an .npy image store.")
    parser.add_argument("root")
    parser.add_argument("--n-train", type=int, default=64)
    parser.add_argument("--n-val", type=int, default=32)
    parser.add_argument("--n-images", type=int, default=12)
    parser.add_argument("--n-val-images", type=int, default=None)
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument("--max-answers", type=int, default=20)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--learnable", nargs="?", const=True, default=False,
                        choices=[True, False, "hard"])
    parser.add_argument("--question-tokens", type=int, default=None)
    parser.add_argument("--question-length", type=int, default=None)
    args = parser.parse_args()
    made = make_synthetic_corpus(
        args.root, n_train=args.n_train, n_val=args.n_val,
        n_images=args.n_images, image_size=args.image_size,
        max_answers=args.max_answers, seed=args.seed,
        learnable=args.learnable, n_val_images=args.n_val_images,
        question_tokens=args.question_tokens,
        question_length=args.question_length)
    print(json.dumps(made, indent=1))
