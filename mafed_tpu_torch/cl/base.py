"""CL strategy protocol (counterpart of mafed_tpu/cl/base.py).

Between tasks the trainer calls `update`; during a task it asks the strategy
whether a batch is a replay batch (every replay_interval-th batch on tasks
after the first, reference vqa_cont_learner.py:216-218) and dispatches to the
strategy's step, or hands it a whole accumulation window.
"""

from __future__ import annotations

from typing import List


class CLStrategy:
    """Base strategy: hooks are no-ops; the loss is the task CE loss."""

    name = "naive"
    needs_replay = False
    # the infinite memory stream of replay strategies, its loader, and the
    # batches drawn from it since it was set (a resume bundle fast-forwards
    # the seeded stream by this count)
    _mem_iter = None
    _mem_loader = None
    mem_draws = 0

    def __init__(self, config, model_cfg, **kwargs) -> None:
        self.config = config
        self.model_cfg = model_cfg
        self.task_id = 0

    # -- step-level -----------------------------------------------------------
    def is_replay_batch(self, batch_idx: int) -> bool:
        """Every replay_interval-th batch replaces the task batch."""
        if not self.needs_replay or self.task_id == 0:
            return False
        return (batch_idx + 1) % self.config.replay_interval == 0

    def replay_step(self, runner, state):
        raise NotImplementedError

    def train_step(self, runner, state, batch):
        return runner.ce_step(state, batch)

    # -- fused accumulation windows ----------------------------------------------
    def supports_fused_window(self, window: int) -> bool:
        """Whether the replay cadence folds into windows of `window`
        microbatches; strategies whose replay step is not plain CE override."""
        return True

    def window_batches(self, runner, idx_batches) -> List:
        """One window's (batch_idx, batch) list as CE batches, memory batches
        in place of the replay positions."""
        return [self.next_memory_batch() if self.is_replay_batch(i) else b for i, b in idx_batches]

    def window_step(self, runner, state, idx_batches):
        """One optimizer update over a full accumulation window."""
        return runner.ce_window_step(state, runner.stack_window(self.window_batches(runner, idx_batches)))

    def next_memory_batch(self):
        if self._mem_iter is None:
            raise NotImplementedError(f"{self.name} has no memory stream")
        self.mem_draws += 1
        return next(self._mem_iter)

    def set_memory(self, runner, mem_dataset) -> None:
        """Replace the memory stream with an infinite shuffled one over
        `mem_dataset` (seed 1), stopping the previous stream's loader."""
        self.close()
        self._mem_loader = runner.make_train_loader(mem_dataset, infinite=True, seed=1)
        self._mem_iter = iter(runner.memory_batches(self._mem_loader))
        self.mem_draws = 0

    def fast_forward_memory(self, runner, n_draws: int) -> None:
        """Mid-task resume: restart the memory stream past its first n_draws
        batches (skipped by index: nothing is loaded for them), so the
        batches after the resume are the uninterrupted run's."""
        if n_draws <= 0 or self._mem_loader is None:
            return
        self.close()
        self._mem_loader.set_draws(n_draws)
        self._mem_iter = iter(runner.memory_batches(self._mem_loader))
        self.mem_draws = n_draws

    def close(self) -> None:
        """Stop the memory stream's loader thread."""
        if self._mem_iter is not None:
            self._mem_iter.close()
            self._mem_iter = None

    # -- task-level -------------------------------------------------------------
    def update(self, runner, state, dataset, loader) -> None:
        """After a task, before its evaluation."""
        self.task_id += 1

    def update_after_new_task(self, runner, state, dataset) -> None:
        pass


class Naive(CLStrategy):
    """Plain sequential finetuning."""

    name = "naive"
