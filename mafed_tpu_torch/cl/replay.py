"""Experience replay (counterpart of mafed_tpu/cl/replay.py): after each
task, memory_size / (T - 1) examples chosen by a seeded numpy Generator
join the memory; every replay_interval-th training batch is a memory batch
with the plain CE loss, from an infinite shuffled stream. Every rank draws
the same memory (the same seeded draws), and its stream is sharded like the
train loader."""

from __future__ import annotations

from typing import List

import numpy as np

from mafed_tpu_torch.cl.base import CLStrategy
from mafed_tpu_torch.core.dist import same_on_every_rank
from mafed_tpu_torch.core.logging import LOGGER
from mafed_tpu_torch.data.vqa_dataset import ConcatDataset, Subset


def choose_memory(rng: np.random.Generator, dataset, per_task: int) -> Subset:
    """`per_task` distinct examples of `dataset`, drawn by `rng`: the same on
    every rank, which is checked."""
    indices = rng.choice(np.arange(len(dataset)), per_task, replace=False).tolist()
    if not same_on_every_rank(indices):
        raise RuntimeError("the ranks drew different memory sets")
    return Subset(dataset, indices)


class ER(CLStrategy):
    name = "replay"
    needs_replay = True

    def __init__(self, config, model_cfg, **kwargs) -> None:
        super().__init__(config, model_cfg)
        self.memory_per_task = int(config.cl_memory / max(1, len(config.tasks or []) - 1))
        self.rng = np.random.default_rng(config.seed)
        self.datasets: List = []

    def replay_step(self, runner, state):
        return runner.ce_step(state, self.next_memory_batch())

    def update(self, runner, state, dataset, loader) -> None:
        self.task_id += 1
        self.datasets.append(choose_memory(self.rng, dataset, self.memory_per_task))
        mem_dataset = ConcatDataset(self.datasets)
        self.set_memory(runner, mem_dataset)
        LOGGER.info("replay memory: %d samples over %d tasks", len(mem_dataset), len(self.datasets))
