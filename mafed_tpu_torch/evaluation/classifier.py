"""Legacy classifier-VQA evaluation path (counterpart of
mafed_tpu/evaluation/classifier.py).

The reference's classifier-head metrics (mafed/utils/eval_utils.py:29-68,
107-158): the soft score of the argmax answer and a streaming accuracy, on
torch tensors on their own device. `all_reduce_metrics` sums the metric
states over the ranks that hold different rows (core/dist.py): the data
group of a (data, model) mesh, whose model peers see the same rows.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mafed_tpu_torch.core.dist import data_group, data_size, model_size, process_count, process_reduce_sum
from mafed_tpu_torch.core.mesh import resolve_mesh_shape


def compute_score_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-sample soft score of the argmax answer (eval_utils.py:29-42):
    logits [B, A], targets [B, A] -> [B]."""
    pred = torch.argmax(logits, dim=-1)
    return torch.gather(targets, -1, pred[:, None])[:, 0]


class VQAAccuracy:
    """Streaming argmax-vs-soft-target accuracy (eval_utils.py:45-68)."""

    def __init__(self) -> None:
        self.total_score = 0.0
        self.total = 0

    def update(self, logits: torch.Tensor, targets: torch.Tensor) -> None:
        if logits.shape[0] == 0:
            return
        self.total_score += float(torch.sum(compute_score_with_logits(logits, targets)))
        self.total += int(logits.shape[0])

    __call__ = update

    def compute(self) -> float:
        return self.total_score / max(self.total, 1)


def all_reduce_metrics(n_ex: float, loss_sum: float, score_sum: float,
                       mesh_shape=None) -> Tuple[float, float, float]:
    """Sum each rank's metric states over the ranks (eval_utils.py:135-138)
    of its data group in the run's layout, so that model peers, which score
    the same rows, count them once: the identity on one rank. A
    `mesh_shape` is only checked against that layout: a grid that does not
    multiply to the number of ranks, or is not the one the run built
    (core/mesh.make_mesh), raises ValueError."""
    if mesh_shape is not None:
        grid = resolve_mesh_shape(mesh_shape, process_count())
        if grid != (data_size(), model_size()):
            raise ValueError(f"mesh_shape {tuple(mesh_shape)} is a {grid[0]} x {grid[1]} grid, but the run's layout "
                             f"is {data_size()} x {model_size()}")
    return process_reduce_sum(n_ex, loss_sum, score_sum, group=data_group())
