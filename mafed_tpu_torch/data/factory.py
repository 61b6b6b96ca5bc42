"""Task dataset and loader factories (copy of mafed_tpu/data/factory.py):
per-task train datasets concatenated over image dirs, all-task validation
loaders built once, split files at
``{question_task_ids}/{exp}/{split}_question_ids.json`` ("valid" for val)."""

from __future__ import annotations

import os
from functools import partial
from typing import Dict, List

from mafed_tpu_torch.core.config import TrainConfig, VisionConfig
from mafed_tpu_torch.core.dist import process_count, process_index
from mafed_tpu_torch.data.collate import collate_val
from mafed_tpu_torch.data.loader import BatchLoader
from mafed_tpu_torch.data.vqa_dataset import ConcatDataset, VQADataset


def task_split_file(question_task_ids_dir: str, exp_name: str, split: str) -> str:
    split = "valid" if split == "val" else split
    return os.path.join(question_task_ids_dir, exp_name, f"{split}_question_ids.json")


def _img_dirs_for(task: str, dirs) -> List[str]:
    return dirs[task] if isinstance(dirs, dict) else dirs


def _task_dataset(config: TrainConfig, task: str, split: str, tokenizer, vision_cfg: VisionConfig,
                  synthetic_images: bool, vision_cache) -> ConcatDataset:
    dirs = config.train_img_dirs if split == "train" else config.val_img_dirs
    return ConcatDataset([
        VQADataset(
            tokenizer=tokenizer,
            vision_cfg=vision_cfg,
            image_dirs=[img_dir],
            data_path=config.data_dir,
            split_file=task_split_file(config.question_task_ids, config.exp, split),
            task=task,
            split=split,
            max_txt_len=config.max_txt_len,
            synthetic_images=synthetic_images,
            vision_cache=vision_cache,
        )
        for img_dir in _img_dirs_for(task, dirs)
    ])


def prepare_train_dataset(config: TrainConfig, task: str, tokenizer, vision_cfg: VisionConfig,
                          synthetic_images: bool = False, vision_cache=None) -> ConcatDataset:
    return _task_dataset(config, task, "train", tokenizer, vision_cfg, synthetic_images, vision_cache)


def prepare_val_dataset(config: TrainConfig, task: str, tokenizer, vision_cfg: VisionConfig,
                        synthetic_images: bool = False, vision_cache=None) -> ConcatDataset:
    return _task_dataset(config, task, "val", tokenizer, vision_cfg, synthetic_images, vision_cache)


def make_val_loader(config: TrainConfig, dataset, text_len: int) -> BatchLoader:
    """Over several ranks, each scores its slice of the examples and
    validate_vqa sums the metric states; decode is not collective, so the
    slices may differ in size."""
    return BatchLoader(
        dataset,
        batch_size=config.val_batch_size,
        collate=partial(collate_val, text_len=text_len),
        shuffle=False,
        num_workers=config.val_num_workers,
        drop_last=False,
        shard_id=process_index(),
        num_shards=process_count(),
    )


def get_val_loaders(config: TrainConfig, tokenizer, vision_cfg: VisionConfig, text_len: int,
                    synthetic_images: bool = False, vision_cache=None) -> Dict[str, BatchLoader]:
    """All-task validation loaders, built once."""
    return {
        task: make_val_loader(
            config, prepare_val_dataset(config, task, tokenizer, vision_cfg, synthetic_images, vision_cache), text_len,
        )
        for task in config.tasks
    }
