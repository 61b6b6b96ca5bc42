"""Offline VQA-v2 -> framework annotation preprocessing (copy of
mafed_tpu/data/preprocess.py; its output files are byte-identical).

    python -m mafed_tpu_torch.data.preprocess --data_dir storage/data/VQA

Converts the official VQA-v2 question/annotation JSONs plus ContVQA task
qid lists into per-split ``{split}_annotations.json`` keyed by question id —
the exact on-disk format consumed by AnnotationStore. Output-format parity
with the reference preprocessor (mafed/data/preprocess.py:39-117): records
carry image_id, id, question_id, question, img_fname (``coco_<split>_<12-digit
image id>``), multiple_choice_answer, answers, answer_type, question_type.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
from collections import defaultdict
from typing import Dict, List

CONTVQA_TASK_DIRS = [
    "contvqa/data/diverse_domains",
    "contvqa/data/question_types",
    "contvqa/data/taxonomy_domains",
]


def build_annotation_index(questions_file: str, answers_file: str) -> Dict[str, Dict]:
    """Join questions with annotations into qid-keyed records."""
    with open(questions_file) as fp:
        questions = {q["question_id"]: q["question"] for q in json.load(fp)["questions"]}
    with open(answers_file) as fp:
        annotations = json.load(fp)["annotations"]

    split_name = os.path.basename(answers_file).split(".")[0].split("_")[-2]
    out: Dict[str, Dict] = {}
    for ann in annotations:
        qid = str(ann["question_id"])
        out[qid] = {
            "image_id": ann["image_id"],
            "id": qid,
            "question_id": ann["question_id"],
            "question": questions[ann["question_id"]],
            "img_fname": f"coco_{split_name}_{str(ann['image_id']).zfill(12)}",
            "multiple_choice_answer": ann["multiple_choice_answer"],
            "answers": ann["answers"],
            "answer_type": ann["answer_type"],
            "question_type": ann.get("question_type"),
        }
    return out


def collect_split_ids(data_dir: str, task_dirs: List[str] = CONTVQA_TASK_DIRS) -> Dict[str, List[str]]:
    """Union of qids over every ContVQA task order, per split."""
    ids: Dict[str, List[str]] = defaultdict(list)
    for split in ("train", "val", "test"):
        fname = "valid_question_ids.json" if split == "val" else f"{split}_question_ids.json"
        for root in task_dirs:
            path = os.path.join(data_dir, root, fname)
            if not os.path.exists(path):
                continue
            with open(path) as fp:
                split_ids = json.load(fp)
            ids[split].extend(itertools.chain.from_iterable(split_ids[t] for t in split_ids))
    return {k: sorted(set(v)) for k, v in ids.items()}


def run(data_dir: str) -> None:
    annotations: Dict[str, Dict] = {}
    for split in ("train", "val"):
        annotations.update(
            build_annotation_index(
                os.path.join(data_dir, f"v2_OpenEnded_mscoco_{split}2014_questions.json"),
                os.path.join(data_dir, f"v2_mscoco_{split}2014_annotations.json"),
            )
        )
    ids_per_split = collect_split_ids(data_dir)
    for split, qids in ids_per_split.items():
        subset = {qid: annotations[qid] for qid in qids if qid in annotations}
        out_path = os.path.join(data_dir, f"{split}_annotations.json")
        with open(out_path, "w") as fp:
            json.dump(subset, fp, indent=4)
        print(f"wrote {len(subset)} annotations -> {out_path}")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="VQA-v2 + ContVQA qid lists -> {split}_annotations.json")
    parser.add_argument("--data_dir", default="storage/data/VQA", help="Data root dir")
    run(parser.parse_args().data_dir)
