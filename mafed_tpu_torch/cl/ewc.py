"""Online EWC (counterpart of mafed_tpu/cl/ewc.py): after each task the
diagonal Fisher is the mean of squared gradients of batch_size x loss over
the task's loader, accumulated online F <- new + 0.95 F_old; the penalty
0.5 lambda sum F (theta - theta*)^2 is added to the loss inside the step.
Over several ranks the loader is sharded over the data group, the squared
gradients are those of each global batch (training/step.py), and the count
is global; under tensor parallelism the Fisher and theta* are this rank's
shards, like the parameters."""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from mafed_tpu_torch.cl.base import CLStrategy
from mafed_tpu_torch.core.dist import data_size
from mafed_tpu_torch.core.logging import LOGGER
from mafed_tpu_torch.training.train_state import trainable_parameters


class EWC(CLStrategy):
    name = "ewc"

    def __init__(self, config, model_cfg, online: bool = True, online_factor: float = 0.95, **kwargs) -> None:
        super().__init__(config, model_cfg)
        self.online = online
        self.online_factor = online_factor
        self.fisher: Optional[Any] = None
        self.old_params: Optional[Any] = None

    @property
    def ewc_state(self) -> Optional[Tuple[Any, Any]]:
        if self.task_id == 0 or self.fisher is None:
            return None
        return (self.fisher, self.old_params)

    def train_step(self, runner, state, batch):
        if self.ewc_state is not None:
            return runner.ewc_step(state, batch, self.ewc_state)
        return runner.ce_step(state, batch)

    def window_step(self, runner, state, idx_batches):
        stacked = runner.stack_window(self.window_batches(runner, idx_batches))
        if self.ewc_state is not None:
            return runner.ewc_window_step(state, stacked, self.ewc_state)
        return runner.ce_window_step(state, stacked)

    def update(self, runner, state, dataset, loader) -> None:
        """The Fisher over the finished task's loader; theta* = its parameters."""
        LOGGER.info("EWC: computing importances over %d batches", len(loader))
        params = trainable_parameters(state.model)
        importances = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for k, p in params.items()}
        total = 0
        for batch in runner.device_batches(loader):
            runner.fisher_step(state.model, batch, importances)
            total += int(batch["input_ids"].shape[0]) * data_size()  # the data group's batches are equal
        importances = {k: v / max(total, 1) for k, v in importances.items()}
        # stored as float32 or bfloat16; the penalty upcasts to float32
        store = torch.bfloat16 if self.config.ewc_state_dtype == "bfloat16" else torch.float32
        if self.online and self.fisher is not None and self.task_id >= 1:
            self.fisher = {k: (v + self.online_factor * self.fisher[k].float()).to(store) for k, v in importances.items()}
        else:
            self.fisher = {k: v.to(store) for k, v in importances.items()}
        self.old_params = {k: p.detach().to(store, copy=True) for k, p in params.items()}
        self.task_id += 1
