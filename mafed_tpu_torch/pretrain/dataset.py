"""Captioning pretrain dataset (counterpart of mafed_tpu/pretrain/dataset.py).

Image-caption pairs from cc3m / coco-captions / visual-genome / sbu (the
reference's mafed/data/vl_pythia_pretrain_dataset.py): Visual-Genome
regions are object-centre-cropped before the resize; captions are formatted
(strip, capitalise, full stop); labels = input_ids (every caption token is
supervised, the model shifts); right padding. Sources:

  * a JSONL manifest: {"image": path, "caption": str, "source": str,
    "metadata": {...}} per line (pretrain/sources.py writes them);
  * a list of CaptionRecords;
  * any map-style dataset whose items are dicts with those fields (an HF
    dataset, a list of dicts); the `datasets` package is not needed.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from mafed_tpu_torch.constants import IGNORE_INDEX
from mafed_tpu_torch.core.config import VisionConfig
from mafed_tpu_torch.data.images import load_and_resize, synthetic_image
from mafed_tpu_torch.data.vqa_dataset import format_text
from mafed_tpu_torch.utils.boxes import ObjectCenterCrop


@dataclass
class CaptionRecord:
    image: str  # path (manifest mode) or source-specific key
    caption: str
    source: str = "coco"
    metadata: Dict = field(default_factory=dict)


class PretrainDataset:
    """Map-style caption dataset over a JSONL manifest, records, or a
    map-style dataset of dicts."""

    def __init__(
        self,
        tokenizer,
        vision_cfg: VisionConfig,
        manifest_path: Optional[str] = None,
        records: Optional[Sequence[CaptionRecord]] = None,
        hf_dataset=None,
        model_max_length: int = 100,
        synthetic_images: bool = False,
    ) -> None:
        self.tokenizer = tokenizer
        self.vision_cfg = vision_cfg
        self.model_max_length = model_max_length
        self.synthetic_images = synthetic_images
        self._hf_dataset = hf_dataset
        self._center_crop = ObjectCenterCrop((vision_cfg.img_size, vision_cfg.img_size))
        if records is not None:
            self.records = list(records)
        elif manifest_path is not None:
            with open(manifest_path) as f:
                self.records = [CaptionRecord(**json.loads(line)) for line in f if line.strip()]
        elif hf_dataset is not None:
            self.records = None  # read item by item from hf_dataset
        else:
            raise ValueError("need records, manifest_path, or hf_dataset")

    def __len__(self) -> int:
        return len(self._hf_dataset) if self.records is None else len(self.records)

    def _pixels(self, rec: CaptionRecord, index: int) -> np.ndarray:
        if self.synthetic_images:
            return synthetic_image(index, self.vision_cfg)
        if rec.source == "visual_genome" and "bbox" in rec.metadata:
            from PIL import Image

            img = self._center_crop(Image.open(rec.image).convert("RGB"), rec.metadata["bbox"])
            img = img.resize((self.vision_cfg.img_size, self.vision_cfg.img_size))
            return np.asarray(img, np.uint8)
        return load_and_resize(rec.image, self.vision_cfg)

    def _record(self, index: int) -> CaptionRecord:
        if self.records is not None:
            return self.records[index]
        raw = self._hf_dataset[index]
        metadata = raw.get("metadata", {})
        return CaptionRecord(
            image=raw.get("image", ""), caption=raw["caption"], source=raw.get("source", "coco"),
            metadata=json.loads(metadata) if isinstance(metadata, str) else metadata,
        )

    def __getitem__(self, index: int) -> Dict:
        rec = self._record(index)
        caption = format_text(rec.caption)
        ids = np.asarray(list(self.tokenizer(caption).input_ids)[: self.model_max_length], np.int32)
        return {
            "pixels": self._pixels(rec, index),
            "input_ids": ids,
            "labels": ids.copy(),  # the model shifts; the whole caption is supervised
            "raw": {"caption": caption, "metadata": rec.metadata},
        }


def collate_pretrain(items: List[Dict], text_len: int, pad_token_id: int = 0, padding_side: str = "right") -> Dict[str, np.ndarray]:
    """Collate with the reference's padding policy (utils/vl_pythia.py:195-254):
    input_ids padded with pad_token_id, labels with -100, attention 0;
    right padding by default for pretraining."""
    n = len(items)
    input_ids = np.full((n, text_len), pad_token_id, np.int32)
    labels = np.full((n, text_len), IGNORE_INDEX, np.int32)
    attention = np.zeros((n, text_len), np.int32)
    for i, it in enumerate(items):
        ids, lbl = it["input_ids"][:text_len], it["labels"][:text_len]
        if padding_side == "right":
            input_ids[i, : len(ids)] = ids
            labels[i, : len(lbl)] = lbl
            attention[i, : len(ids)] = 1
        else:
            input_ids[i, text_len - len(ids):] = ids
            labels[i, text_len - len(lbl):] = lbl
            attention[i, text_len - len(ids):] = 1
    return {
        "input_ids": input_ids,
        "labels": labels,
        "attention_mask": attention,
        "pixels": np.stack([it["pixels"] for it in items]),
    }
