"""`{task}_best` checkpoints and the initial checkpoint (counterpart of
mafed_tpu/utils/checkpoint.py).

Weights only, top-1 on a task's generative VQA accuracy, at
``<output_dir>/ckpt/{task}_best<ext>``: a safetensors file whose keys are
the reference's torch names (a VLPythia state_dict) and whose values are
float32, as the JAX package writes them, so each package reads the other's.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch

from mafed_tpu_torch.core.config import TrainConfig
from mafed_tpu_torch.core.logging import LOGGER
from mafed_tpu_torch.models.weights import load_safetensors, save_safetensors


def task_checkpoint_path(output_dir: str, task: str, extension: str = ".safetensors") -> str:
    return os.path.join(output_dir, "ckpt", f"{task}_best{extension}")


def save_task_checkpoint(state_dict: Dict[str, torch.Tensor], path: str) -> None:
    """Write a state_dict in safetensors format (whatever the extension),
    every floating tensor as float32."""
    LOGGER.info("saving checkpoint %s", path)
    save_safetensors({k: v.float() if v.is_floating_point() else v for k, v in state_dict.items()}, path)


def load_task_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A {task}_best checkpoint as a state_dict on the CPU."""
    if not path.endswith(".safetensors"):
        raise NotImplementedError(
            f"{path}: the port reads safetensors checkpoints only; torch pickles "
            "(.ckpt, .bin) come with load_pretrained (ROADMAP queue 1 item 5)"
        )
    LOGGER.info("loading checkpoint %s", path)
    return load_safetensors(path)


def get_initialization_checkpoint(config: TrainConfig, task_id: int = 0) -> Optional[str]:
    """The checkpoint that initialises the first task (reference utils/checkpoint.py:32-41)."""
    if task_id != 0:
        return None
    if config.checkpoint is not None:
        return config.checkpoint
    if config.checkpoint_dir is not None:
        return os.path.join(config.checkpoint_dir, f"{config.tasks[0]}_best{config.init_ckpt_extension}")
    return None
