"""Device selection for the port's entry points, and the layouts they run."""

from __future__ import annotations

import math
from typing import Sequence, Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The device an entry point runs on, with its index. CUDA is the default;
    asking for it on a machine without a GPU raises instead of running on the
    CPU. A bare "cuda" is the current card, which joining a process group
    (core/dist.py) made the rank's; a named device is used as named."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA was requested but no GPU is available; pass device='cpu' to run on the CPU"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def check_data_parallel(mesh_shape: Sequence[int], world: int) -> None:
    """Raise NotImplementedError for a layout the port does not run: it is
    data parallel, one device per rank, so the JAX package's (data, model)
    mesh must have a model axis of 1 and a data axis of -1 (inferred) or the
    number of ranks."""
    dims = list(mesh_shape or (-1, 1))
    data, model = dims[0], math.prod(dims[1:])
    if model != 1 or data not in (-1, world):
        raise NotImplementedError(
            f"mesh_shape {tuple(dims)} over {world} rank(s): the port runs data parallel with one device per "
            f"rank (mesh_shape [-1, 1] or [{world}, 1]); a model axis, or more than one device a rank, is not "
            "ported to mafed_tpu_torch yet (ROADMAP queue 1 item 1: tensor parallel)")
