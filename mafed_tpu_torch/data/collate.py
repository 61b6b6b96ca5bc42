"""Batch collation with one fixed text length (copy of mafed_tpu/data/collate.py).

Every batch is left-padded to the same text length: padding ids 0,
attention 0, labels -100. Cached vision features ("patches") and cached
teacher states ("t_hs") arrive as bfloat16 tensors (numpy has no bfloat16)
and are stacked with torch; every other field is numpy, the device tables'
rows ("patch_idx", "t_idx") int32.
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
    # the teacher-state cache (data/teacher_cache.py): streamed states
    # [B, n_states, seq, hidden], or the rows of the device teacher table
    if _all_or_none(items, "t_hs", "cached teacher states and misses; prime the teacher cache over the memory set"):
        out["t_hs"] = torch.stack([it["t_hs"] for it in items])
    if _all_or_none(items, "t_idx", "teacher-table rows and misses; the table must cover the memory set"):
        out["t_idx"] = np.asarray([it["t_idx"] for it in items], np.int32)
    return out


def _all_or_none(items: List[Dict], key: str, mixed: str) -> bool:
    """Whether every item has `key`; raises if only some have it."""
    has = [key in it for it in items]
    if any(has) and not all(has):
        raise ValueError(f"batch mixes {mixed}")
    return all(has)


def _collate_vision(items: List[Dict]) -> Dict:
    """Vision-table rows when the items carry them, else cached features
    when every item has them, else uint8 pixels. A batch that mixes them
    means a table that misses images or a partly primed cache, and raises."""
    if _all_or_none(items, "patch_idx", "vision-table indices and streamed vision input; "
                    "the vision table must cover every dataset the task draws from"):
        return {"patch_idx": np.asarray([it["patch_idx"] for it in items], np.int32)}
    if _all_or_none(items, "patches", "cached vision features and raw pixels; "
                    "prime the vision cache over the full dataset before training"):
        return {"patches": torch.stack([it["patches"] for it in items])}
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
