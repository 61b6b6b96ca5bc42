"""Training state: the trainable/frozen split, the teacher copy, the optimizer state.

The vision encoder is frozen in every reference config, so it is kept out of
the trainable set: no gradients, no Adam moments. The training window runs
on cached patch features and never calls it; the teacher shares it.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Dict

import torch

from mafed_tpu_torch.models.vl_pythia import VLPythia

FROZEN_PREFIX = "vision_encoder."


@dataclass
class TrainState:
    step: int
    model: VLPythia  # trainable parameters (decoder + projector)
    opt_state: Any


def trainable_parameters(model: VLPythia) -> Dict[str, torch.nn.Parameter]:
    return {n: p for n, p in model.named_parameters() if not n.startswith(FROZEN_PREFIX)}


def make_teacher(model: VLPythia) -> VLPythia:
    """The distillation teacher: a bfloat16 copy of the decoder and projector
    with no gradients, sharing the student's frozen tower (not copied)."""
    tower = model.vision_encoder
    teacher = copy.deepcopy(model, memo={id(tower): tower})
    for name, child in teacher.named_children():
        if child is not tower:
            child.to(torch.bfloat16)
    teacher.requires_grad_(False)
    return teacher
