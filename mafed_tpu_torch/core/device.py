"""Device selection for the port's entry points, and the layouts they run."""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

from mafed_tpu_torch.core.mesh import check_divides, resolve_mesh_shape


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


def check_layout(mesh_shape: Sequence[int], world: int, model_cfg=None) -> Tuple[int, int]:
    """(D, M) of a (data, model) mesh over `world` ranks, one device a rank
    (core/mesh.py). Raises ValueError for a grid that does not multiply to
    `world`, or whose model axis does not divide `model_cfg`'s heads,
    intermediate size, hidden size or vocabulary."""
    data, model = resolve_mesh_shape(mesh_shape, world)
    if model_cfg is not None:
        check_divides(model, model_cfg)
    return data, model
