"""Batch collation with one fixed text length (copy of mafed_tpu/data/collate.py).

Every batch is left-padded to the same text length: padding ids 0,
attention 0, labels -100. Cached vision features ("patches") arrive as
bfloat16 tensors (numpy has no bfloat16) and are stacked with torch; every
other field is numpy.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from mafed_tpu_torch.constants import IGNORE_INDEX


def _left_pad(rows: Sequence[np.ndarray], length: int, pad_value: int) -> np.ndarray:
    out = np.full((len(rows), length), pad_value, dtype=np.int32)
    for i, row in enumerate(rows):
        row = row[-length:] if len(row) > length else row
        if len(row):
            out[i, length - len(row):] = row
    return out


def _attention_mask(items: List[Dict], text_len: int) -> np.ndarray:
    mask = np.zeros((len(items), text_len), np.int32)
    for i, it in enumerate(items):
        mask[i, text_len - min(len(it["input_ids"]), text_len):] = 1
    return mask


def collate_train(items: List[Dict], text_len: int, label_tail: Optional[int] = None) -> Dict:
    input_ids = _left_pad([it["input_ids"] for it in items], text_len, 0)
    labels = _left_pad([it["labels"] for it in items], text_len, IGNORE_INDEX)
    if label_tail and label_tail < text_len:
        # the train step restricts lm_head + CE to the last label_tail
        # positions, which leaves the loss unchanged only if every supervised
        # label lies in the last label_tail - 1 positions
        head = labels[:, : text_len - (label_tail - 1)]
        if (head != IGNORE_INDEX).any():
            raise ValueError(
                f"supervised labels outside the last {label_tail - 1} positions; "
                f"raise --label_tail (or set it to 0 to disable)"
            )
    out = {"input_ids": input_ids, "attention_mask": _attention_mask(items, text_len), "labels": labels}
    out.update(_collate_vision(items))
    return out


def _collate_vision(items: List[Dict]) -> Dict:
    """Cached features when every item has them, else uint8 pixels; a batch
    that mixes the two means a partly primed cache and raises."""
    has_patches = ["patches" in it for it in items]
    if all(has_patches):
        return {"patches": torch.stack([it["patches"] for it in items])}
    if any(has_patches):
        raise ValueError(
            "batch mixes cached vision features and raw pixels; prime the "
            "vision cache over the full dataset before training"
        )
    return {"pixels": np.stack([it["pixels"] for it in items])}


def collate_val(items: List[Dict], text_len: int) -> Dict:
    out = {
        "input_ids": _left_pad([it["input_ids"] for it in items], text_len, 0),
        "attention_mask": _attention_mask(items, text_len),
        "answers": [it["answers"] for it in items],
        "qids": [it["question_id"] for it in items],
    }
    out.update(_collate_vision(items))
    return out
