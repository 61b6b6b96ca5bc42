"""Answer vocabulary + soft classification targets (legacy classifier path;
copy of mafed_tpu/data/answer_vocab.py).

Capability parity with mafed/data/vqa_utils.py:4-66 (get_vqa_target,
VQAMasking) and the answer-preprocessing used to build classifier answer
vocabularies (mafed/utils/mcan_ans_prepro.py — the reference keeps a
duplicate normalizer there; this build reuses the single canonical one).
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from mafed_tpu_torch.evaluation.vqa_metrics import normalize_answer, vqa_v2_score


def build_answer_vocab(annotations: Iterable[Dict], min_count: int = 9) -> Tuple[Dict[str, int], List[str]]:
    """Most-frequent normalized answers -> (ans2label, label2ans)."""
    counts: Counter = Counter()
    for ann in annotations:
        counts[normalize_answer(ann["multiple_choice_answer"])] += 1
    label2ans = [a for a, c in counts.most_common() if c >= min_count]
    ans2label = {a: i for i, a in enumerate(label2ans)}
    return ans2label, label2ans


def soft_target_scores(answers: Sequence[str]) -> Dict[str, float]:
    """Per-answer VQA-v2 soft scores from the 10 annotator answers."""
    counts = Counter(normalize_answer(a) for a in answers)
    return {a: vqa_v2_score(c) for a, c in counts.items()}


def get_vqa_target(example: Dict, num_answers: int, keep_max: bool = False) -> np.ndarray:
    """Soft target vector from {target: {labels, scores}} (vqa_utils.py:4-17)."""
    target = np.zeros((num_answers,), np.float32)
    labels = example["target"]["labels"]
    scores = example["target"]["scores"]
    if labels and scores:
        labels = np.asarray(labels)
        scores = np.asarray(scores, np.float32)
        if keep_max:
            target[labels[int(np.argmax(scores))]] = 1.0
        else:
            target[labels] = scores
    return target


class VQAMasking:
    """Language/vision token masks for arbitrary concat orders
    (vqa_utils.py:20-65)."""

    def __init__(self, text_first: bool = True, ignore_cls_tokens: bool = False, ignore_eos_tokens: bool = True) -> None:
        self._text_first = text_first
        self._ignore_cls_tokens = ignore_cls_tokens
        self._ignore_eos_tokens = ignore_eos_tokens

    def get_lang_mask(self, num_lang_tokens: int, num_vision_tokens: int) -> np.ndarray:
        mask = np.zeros((num_lang_tokens + num_vision_tokens,), np.int64)
        start = 0 if self._text_first else num_vision_tokens
        end = start + num_lang_tokens
        if self._ignore_cls_tokens:
            start += 1
        if self._ignore_eos_tokens:
            end -= 1
        mask[start:end] = 1
        return mask

    def get_image_mask(self, num_lang_tokens: int, num_vision_tokens: int) -> np.ndarray:
        mask = np.zeros((num_lang_tokens + num_vision_tokens,), np.int64)
        start = num_lang_tokens if self._text_first else 0
        mask[start : start + num_vision_tokens] = 1
        return mask

    def get_language_and_image_masks(self, num_lang_tokens: int, num_vision_tokens: int):
        return (
            self.get_lang_mask(num_lang_tokens, num_vision_tokens),
            self.get_image_mask(num_lang_tokens, num_vision_tokens),
        )
