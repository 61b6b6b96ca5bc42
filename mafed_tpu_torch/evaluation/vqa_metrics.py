"""VQA-v2 answer normalization and soft accuracy (the port's copy of
mafed_tpu/evaluation/vqa_metrics.py, which is pure Python).

Semantics match the official GT-Vision-Lab VQA evaluation code and the
reference's soft score (0.3 per matching annotator answer, capped at 1).
Host-side only: it runs on decoded strings, never on the device.
"""

from __future__ import annotations

import re
from collections import Counter
from typing import Sequence

_CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't", "couldve": "could've",
    "couldnt": "couldn't", "couldn'tve": "couldn't've", "couldnt've": "couldn't've",
    "didnt": "didn't", "doesnt": "doesn't", "dont": "don't", "hadnt": "hadn't",
    "hadnt've": "hadn't've", "hadn'tve": "hadn't've", "hasnt": "hasn't",
    "havent": "haven't", "hed": "he'd", "hed've": "he'd've", "he'dve": "he'd've",
    "hes": "he's", "howd": "how'd", "howll": "how'll", "hows": "how's",
    "Id've": "I'd've", "I'dve": "I'd've", "Im": "I'm", "Ive": "I've",
    "isnt": "isn't", "itd": "it'd", "itd've": "it'd've", "it'dve": "it'd've",
    "itll": "it'll", "let's": "let's", "maam": "ma'am", "mightnt": "mightn't",
    "mightnt've": "mightn't've", "mightn'tve": "mightn't've", "mightve": "might've",
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
    "someonell": "someone'll", "someones": "someone's", "somethingd": "something'd",
    "somethingd've": "something'd've", "something'dve": "something'd've",
    "somethingll": "something'll", "thats": "that's", "thered": "there'd",
    "thered've": "there'd've", "there'dve": "there'd've", "therere": "there're",
    "theres": "there's", "theyd": "they'd", "theyd've": "they'd've",
    "they'dve": "they'd've", "theyll": "they'll", "theyre": "they're",
    "theyve": "they've", "twas": "'twas", "wasnt": "wasn't",
    "wed've": "we'd've", "we'dve": "we'd've", "weve": "we've",
    "werent": "weren't", "whatll": "what'll", "whatre": "what're",
    "whats": "what's", "whatve": "what've", "whens": "when's",
    "whered": "where'd", "wheres": "where's", "whereve": "where've",
    "whod": "who'd", "whod've": "who'd've", "who'dve": "who'd've",
    "wholl": "who'll", "whos": "who's", "whove": "who've", "whyll": "why'll",
    "whyre": "why're", "whys": "why's", "wont": "won't", "wouldve": "would've",
    "wouldnt": "wouldn't", "wouldnt've": "wouldn't've", "wouldn'tve": "wouldn't've",
    "yall": "y'all", "yall'll": "y'all'll", "y'allll": "y'all'll",
    "yall'd've": "y'all'd've", "y'alld've": "y'all'd've", "y'all'dve": "y'all'd've",
    "youd": "you'd", "youd've": "you'd've", "you'dve": "you'd've",
    "youll": "you'll", "youre": "you're", "youve": "you've",
}

_DIGIT_MAP = {
    "none": "0", "zero": "0", "one": "1", "two": "2", "three": "3", "four": "4",
    "five": "5", "six": "6", "seven": "7", "eight": "8", "nine": "9", "ten": "10",
}

_ARTICLES = {"a", "an", "the"}

_PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
_COMMA_STRIP = re.compile(r"(\d)(\,)(\d)")

_PUNCT = [
    ";", "/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\", "_", "-",
    ">", "<", "@", "`", ",", "?", "!",
]


def process_punctuation(in_text: str) -> str:
    out_text = in_text
    for punct in _PUNCT:
        surrounded = f"{punct} " in in_text or f" {punct}" in in_text
        has_number_comma = _COMMA_STRIP.search(in_text) is not None
        if surrounded or has_number_comma:
            out_text = out_text.replace(punct, "")
        else:
            out_text = out_text.replace(punct, " ")
    return _PERIOD_STRIP.sub("", out_text, re.UNICODE)


def process_digit_article(in_text: str) -> str:
    words = []
    for word in in_text.lower().split():
        word = _DIGIT_MAP.get(word, word)
        if word not in _ARTICLES:
            words.append(word)
    return " ".join(_CONTRACTIONS.get(w, w) for w in words)


def normalize_answer(answer: str) -> str:
    """Official VQA-v2 answer normalization."""
    answer = answer.replace("\n", " ").replace("\t", " ").strip()
    answer = process_digit_article(process_punctuation(answer))
    return answer.lower()


def vqa_v2_score(count: int) -> float:
    """Soft VQA-v2 score: 0.3 per matching annotator answer, capped at 1.

    (eval_utils.py:71-80 — note the round(0.3*count, 1) so 3 matches give
    exactly 0.9, not 0.8999...)
    """
    return min(1.0, round(0.3 * count, 1))


class VQAGenerativeAccuracy:
    """Streaming generative VQA accuracy (eval_utils.py:83-104).

    Ground-truth answers are expected pre-normalized (the dataset normalizes
    them at load time, vl_pythia_vqa_dataset.py:90); predictions are
    normalized here.
    """

    def __init__(self) -> None:
        self.accuracy = 0.0
        self.total = 0

    def update(self, predicted_answers: Sequence[str], ground_truth_batch: Sequence[Sequence[str]]) -> None:
        for pred, gts in zip(predicted_answers, ground_truth_batch):
            pred = normalize_answer(pred)
            counts = Counter(gts)
            self.accuracy += vqa_v2_score(counts.get(pred, 0))
        self.total += len(ground_truth_batch)

    __call__ = update

    def compute(self) -> float:
        return self.accuracy / max(self.total, 1)

    def reset(self) -> None:
        self.accuracy = 0.0
        self.total = 0
