"""Device selection for the port's entry points."""

from __future__ import annotations

import os
from typing import Sequence, Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The device an entry point runs on, with its index. CUDA is the default;
    asking for it on a machine without a GPU raises instead of running on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA was requested but no GPU is available; pass device='cpu' to run on the CPU"
            )
        if device.index is None:  # "cuda" means the current card, as tensors report it
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def asks_for_several_devices(mesh_shape: Sequence[int], distributed_init: bool) -> bool:
    """Whether the settings (the JAX package's mesh shape, where -1 infers
    an axis, and distributed_init) or WORLD_SIZE ask for more than one
    process or device; the port runs on one."""
    devices = 1
    for d in mesh_shape or ():
        devices *= d if d > 0 else 1
    return bool(distributed_init) or devices > 1 or int(os.environ.get("WORLD_SIZE", "1")) > 1
