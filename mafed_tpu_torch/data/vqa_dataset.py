"""VQA dataset (counterpart of mafed_tpu/data/vqa_dataset.py): question and
answer formatting, tokenization, image loading.

  * the question is stripped, capitalised and given a full stop
    (reference vl_pythia_vqa_dataset.py:107-125);
  * the answer is the normalised multiple_choice_answer, formatted without
    capitalisation;
  * train: input_ids = tok(question) ++ tok(answer) ++ [eos], labels -100
    over the question and the answer + eos supervised (:73-83);
  * every item carries the 10 normalised ground-truth answers.

Items are numpy, but for cached vision features, which are a bfloat16
tensor; batching and padding happen in collate. With a device vision table
attached (data/vision_table.py), an item carries its table row
("patch_idx", np.int32) instead of features or pixels.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

from mafed_tpu_torch.constants import IGNORE_INDEX
from mafed_tpu_torch.core.config import VisionConfig
from mafed_tpu_torch.data.annotations import AnnotationStore
from mafed_tpu_torch.data.images import get_image_path, load_and_resize, synthetic_image
from mafed_tpu_torch.evaluation.vqa_metrics import normalize_answer


def format_text(text: str, strip: bool = True, capitalize: bool = True, punctuate: bool = True) -> str:
    if strip:
        text = text.strip()
    if capitalize:
        text = text.capitalize()
    if punctuate and not text.endswith((".", "?", "!")):
        text = f"{text}."
    return text


class VQADataset:
    """Map-style VQA dataset over one task's annotations. With a
    `vision_cache` (data/vision_cache.py), an item whose image is cached
    carries its "patches" instead of "pixels"; with a `vision_table`, its
    "patch_idx"."""

    def __init__(
        self,
        tokenizer,
        vision_cfg: VisionConfig,
        image_dirs: Sequence[str],
        data_path: str,
        split_file: str,
        task: str,
        split: str,
        max_txt_len: int = 60,
        synthetic_images: bool = False,
        vision_cache=None,
    ) -> None:
        self.tokenizer = tokenizer
        self.vision_cfg = vision_cfg
        self.image_dirs = list(image_dirs)
        self.split = split
        self.max_txt_len = max_txt_len
        self.synthetic_images = synthetic_images
        self.vision_cache = vision_cache
        self.vision_table = None  # set per task by the trainer (vision_table.attach)
        self._resolved: Dict[str, str] = {}  # img_fname -> absolute path
        self.store = AnnotationStore(data_path=data_path, split=split, split_file=split_file, task=task)

    def __len__(self) -> int:
        return len(self.store)

    def image_key(self, index: int) -> str:
        """The vision-cache key of an example's image: the index for
        synthetic images (made from it), else the resolved path (several
        questions share an image; same-named files in different directories
        do not)."""
        if self.synthetic_images:
            return f"synthetic:{index}"
        fname = self.store[index]["img_fname"]
        path = self._resolved.get(fname)
        if path is None:
            path = fname  # unresolvable now; the load will raise
            for d in self.image_dirs:
                p = get_image_path(d, fname)
                if os.path.exists(p):
                    path = os.path.abspath(p)
                    break
            self._resolved[fname] = path
        return f"img:{path}"

    def question_id(self, index: int):
        """An example's id from its annotation alone: no image or feature load."""
        return self.store[index].get("question_id")

    def load_pixels(self, index: int) -> np.ndarray:
        """uint8 HWC pixels of an example's image, bypassing the cache."""
        if self.synthetic_images:
            return synthetic_image(index, self.vision_cfg)
        img_fname = self.store[index]["img_fname"]
        for d in self.image_dirs:
            path = get_image_path(d, img_fname)
            if os.path.exists(path):
                return load_and_resize(path, self.vision_cfg)
        raise FileNotFoundError(f"image {img_fname} not found under {self.image_dirs}")

    def __getitem__(self, index: int) -> Dict:
        ex = self.store[index]
        patch_idx = patches = None
        if self.vision_table is not None:
            patch_idx = self.vision_table.index(self.image_key(index))
            if patch_idx is None:
                # the table covers every image the task draws (all or nothing):
                # streamed features here would make a batch collate refuses
                raise KeyError(f"image {self.image_key(index)!r} missing from the attached vision table")
        elif self.vision_cache is not None:
            patches = self.vision_cache.load(self.image_key(index))
        question = format_text(ex["question"])
        answers = [normalize_answer(a["answer"]) for a in ex.get("answers", [])]
        answer = format_text(normalize_answer(ex.get("multiple_choice_answer", "")), capitalize=False)

        q_ids = list(self.tokenizer(question).input_ids)[: self.max_txt_len]
        item: Dict = {
            "answers": answers,
            "question_id": ex.get("question_id"),
            "raw": {"question": question, "answer": answer},
        }
        if patch_idx is not None:
            item["patch_idx"] = np.int32(patch_idx)
        elif patches is not None:
            item["patches"] = patches
        else:
            item["pixels"] = self.load_pixels(index)
        if self.split == "train":
            a_ids = list(self.tokenizer(answer).input_ids)
            a_ids.append(self.tokenizer.eos_token_id)
            item["input_ids"] = np.asarray(q_ids + a_ids, np.int32)
            item["labels"] = np.asarray([IGNORE_INDEX] * len(q_ids) + a_ids, np.int32)
        else:
            item["input_ids"] = np.asarray(q_ids, np.int32)
            item["labels"] = None
        return item


class ConcatDataset:
    """Concatenation of map-style datasets (memory buffers across tasks)."""

    def __init__(self, datasets: Sequence) -> None:
        self.datasets = list(datasets)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def __getitem__(self, index: int):
        ds_idx = int(np.searchsorted(self._offsets, index, side="right") - 1)
        return self.datasets[ds_idx][index - int(self._offsets[ds_idx])]

    def question_id(self, index: int):
        ds_idx = int(np.searchsorted(self._offsets, index, side="right") - 1)
        return question_id_of(self.datasets[ds_idx], index - int(self._offsets[ds_idx]))


class Subset:
    def __init__(self, dataset, indices: Sequence[int]) -> None:
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, i: int):
        return self.dataset[self.indices[i]]

    def question_id(self, i: int):
        return question_id_of(self.dataset, self.indices[i])


def question_id_of(dataset, index: int):
    """An example's id: the metadata-only accessor where the dataset has one,
    else a full item."""
    fn = getattr(dataset, "question_id", None)
    if fn is not None:
        return fn(index)
    return dataset[index].get("question_id")
