"""Annotation and task-split loading (copy of mafed_tpu/data/annotations.py).

A split file maps task name -> question ids; ``{split}_annotations.json``
maps qid -> annotation record (question, img_fname, answers,
multiple_choice_answer, question_id). The "joint" pseudo-task concatenates
every task's ids.
"""

from __future__ import annotations

import itertools
import json
import os
from typing import Dict, List, Optional


def load_task_ids(split_file: str, task: Optional[str]) -> List[str]:
    if not (task and split_file):
        raise ValueError(f"No question ids for task: {task} and task ids file: {split_file}")
    if not os.path.exists(split_file):
        raise ValueError(f"Incorrect splits file {split_file}")
    with open(split_file) as fp:
        splits_ids = json.load(fp)
    if task == "joint":
        return list(itertools.chain.from_iterable(splits_ids[t] for t in splits_ids))
    if task in splits_ids:
        return splits_ids[task]
    raise ValueError(f"Invalid task: {task}")


class AnnotationStore:
    """Task-filtered view over a split's annotation file."""

    def __init__(self, data_path: str, split: str, split_file: str, task: str) -> None:
        ids = load_task_ids(split_file, task)
        with open(os.path.join(data_path, f"{split}_annotations.json")) as f:
            qid_to_annotations = json.load(f)
        self.annotations = [qid_to_annotations[qid] for qid in ids]

    def __len__(self) -> int:
        return len(self.annotations)

    def __getitem__(self, i: int) -> Dict:
        return self.annotations[i]
