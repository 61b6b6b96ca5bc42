"""The port's VQA-v2 -> annotation preprocessor against the JAX package's:
the same files, byte for byte, from tiny VQA-v2 question and annotation
JSONs and ContVQA qid lists."""

import json
import os
import subprocess
import sys

from mafed_tpu.data import preprocess as jpre

from mafed_tpu_torch.data import preprocess as tpre

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_vqa_v2(root: str) -> None:
    """Two splits of VQA-v2 (questions + annotations) and two ContVQA task
    orders naming qids of both, some repeated and one unknown."""
    qid = 100
    for split in ("train", "val"):
        questions, anns = [], []
        for i in range(6):
            qid += 1
            questions.append({"question_id": qid, "image_id": 9000 + i, "question": f"what is {split} {i}?"})
            ans = ["red", "blue", "red"][i % 3]
            anns.append({
                "question_id": qid, "image_id": 9000 + i, "multiple_choice_answer": ans,
                "answers": [{"answer": ans, "answer_confidence": "yes", "answer_id": j + 1} for j in range(10)],
                "answer_type": "other", **({"question_type": "what is"} if i % 2 else {}),
            })
        with open(os.path.join(root, f"v2_OpenEnded_mscoco_{split}2014_questions.json"), "w") as f:
            json.dump({"questions": questions}, f)
        with open(os.path.join(root, f"v2_mscoco_{split}2014_annotations.json"), "w") as f:
            json.dump({"annotations": anns}, f)
    for k, task_dir in enumerate(jpre.CONTVQA_TASK_DIRS[:2]):
        os.makedirs(os.path.join(root, task_dir), exist_ok=True)
        for fname, ids in (("train_question_ids.json", {"a": ["101", "102"], "b": ["103", "107"]}),
                           ("valid_question_ids.json", {"a": ["108", "109"], "b": ["110", "9999"]}),
                           ("test_question_ids.json", {"a": ["111", "112", "104"][k:]})):
            with open(os.path.join(root, task_dir, fname), "w") as f:
                json.dump(ids, f)


def _outputs(root):
    return {name: open(os.path.join(root, name), "rb").read()
            for name in sorted(os.listdir(root)) if name.endswith("_annotations.json") and not name.startswith("v2_")}


def test_annotation_files_byte_identical(tmp_path):
    for side in ("jax", "port"):
        os.makedirs(tmp_path / side)
        write_vqa_v2(str(tmp_path / side))
    jpre.run(str(tmp_path / "jax"))
    tpre.run(str(tmp_path / "port"))
    want, got = _outputs(str(tmp_path / "jax")), _outputs(str(tmp_path / "port"))
    assert sorted(got) == ["test_annotations.json", "train_annotations.json", "val_annotations.json"]
    assert got == want
    assert b'\n    "101": {' in got["train_annotations.json"]  # indent=4, as the JAX preprocessor writes
    train = json.loads(got["train_annotations.json"])
    assert sorted(train) == ["101", "102", "103", "107"]
    assert train["107"]["img_fname"] == "coco_val2014_000000009000" and train["101"]["question_type"] is None


def test_index_and_split_ids_match_jax(tmp_path):
    write_vqa_v2(str(tmp_path))
    args = (str(tmp_path / "v2_OpenEnded_mscoco_val2014_questions.json"),
            str(tmp_path / "v2_mscoco_val2014_annotations.json"))
    assert tpre.build_annotation_index(*args) == jpre.build_annotation_index(*args)
    assert tpre.collect_split_ids(str(tmp_path)) == jpre.collect_split_ids(str(tmp_path))
    assert tpre.CONTVQA_TASK_DIRS == jpre.CONTVQA_TASK_DIRS


def test_cli_writes_the_files(tmp_path):
    write_vqa_v2(str(tmp_path))
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-m", "mafed_tpu_torch.data.preprocess", "--data_dir", str(tmp_path)],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "wrote 4 annotations" in proc.stdout
    assert sorted(_outputs(str(tmp_path))) == ["test_annotations.json", "train_annotations.json", "val_annotations.json"]
