"""Captioning pretraining with full resume (counterpart of
mafed_tpu/pretrain/trainer.py; the reference runs an HF Trainer,
mafed/trainer/hf.py:131-615).

  * epochs, gradient accumulation (`MultiSteps`), clipping, AdamW and a
    linear warmup (warmup_ratio) then linear decay;
  * steps from training/step.py's `make_train_step` on uint8 pixels (the
    frozen tower runs with no graph), every caption token supervised
    (label_tail 0);
  * periodic eval loss (a forward-only bf16 CE) and periodic checkpoints
    `checkpoint-<step>`, rotated to `save_total_limit`, plus
    `checkpoint-final` at the end (hf.py:554-561);
  * full resume: parameters, optimizer state, step / epoch / batch and the
    numpy RNG state, with batches skipped to the saved position
    (hf.py:330-349, 414-423, 439-450);
  * best-model tracking on the eval loss (load_best_model_at_end).

A checkpoint directory holds model.safetensors (the reference's names,
float32, which the JAX package's load_task_checkpoint reads),
opt_state.safetensors (`utils/checkpoint.save_opt_state`) and, written last,
trainer_state.json. Its "step" counts optimizer updates, so that a resumed
run keeps the cadence of saves and evals with any accumulation.

Rotation follows the HF Trainer: while load_best_model_at_end may load the
best checkpoint, rotation spares it (and the newest). The JAX package's
rotation keeps only the newest `save_total_limit`, so it can delete the
best checkpoint and then fail to load it at the end.

One device, CUDA unless the caller passes device="cpu", or data parallel
over the ranks of a torchrun launch (core/dist.py): the global batch is
per_device_train_batch_size x ranks, each rank loads its slice of it, the
steps average the gradients over the ranks, the eval loss is summed over
them, and rank 0 writes the checkpoints, rotates them and logs, while the
others wait. Under mesh_shape [D, M] (core/mesh.py) the global batch is
still per_device_train_batch_size x ranks (the JAX package's x mesh size),
split over the D ranks of a data group; each rank holds its shard of the
model, and checkpoints are gathered to the whole model before rank 0 writes
them (every rank joins) and sharded again when read.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from dataclasses import dataclass
from functools import partial
from typing import Dict, Optional

import numpy as np
import torch

from mafed_tpu_torch.core.config import ModelConfig, TrainConfig
from mafed_tpu_torch.core.device import check_layout, resolve_device
from mafed_tpu_torch.core.dist import (
    barrier, broadcast_model_, data_group, data_index, data_size, is_main_process, maybe_initialize_distributed,
    process_count, process_reduce_sum,
)
from mafed_tpu_torch.core.mesh import gather_state_dict, make_mesh, shard_state_dict
from mafed_tpu_torch.core.logging import LOGGER, MetricsLogger
from mafed_tpu_torch.data.images import make_normalizer
from mafed_tpu_torch.data.loader import BatchLoader
from mafed_tpu_torch.data.prefetch import DevicePrefetcher
from mafed_tpu_torch.models.tensor_parallel import shard_model_
from mafed_tpu_torch.models.vl_pythia import VLPythia, init_model
from mafed_tpu_torch.optim.optimizer import MultiSteps, build_optimizer
from mafed_tpu_torch.optim.sched import linear_warmup_schedule
from mafed_tpu_torch.pretrain.dataset import collate_pretrain
from mafed_tpu_torch.training.step import _ce_loss, _vision_features, make_train_step
from mafed_tpu_torch.training.train_state import TrainState, trainable_parameters
from mafed_tpu_torch.utils.checkpoint import (
    atomic_json_commit, gather_opt_state, load_opt_state, load_task_checkpoint, save_opt_state,
    save_task_checkpoint,
)


@dataclass
class PretrainConfig:
    """Pretraining arguments (parity: pretrain_vlpythia.py:16-81)."""

    output_dir: str = "storage/pretrain-pythia"
    per_device_train_batch_size: int = 128
    per_device_eval_batch_size: int = 128
    gradient_accumulation_steps: int = 1
    num_train_epochs: int = 2
    learning_rate: float = 2e-5
    weight_decay: float = 0.0
    warmup_ratio: float = 0.03
    max_grad_norm: float = 1.0
    save_steps: float = 0.1  # fraction of total steps
    eval_steps: float = 0.1
    save_total_limit: int = 2
    load_best_model_at_end: bool = True
    logging_steps: int = 1
    seed: int = 12345
    model_max_length: int = 100
    betas: tuple = (0.9, 0.999)
    run_name: str = "pretrain-vl-pythia"
    project_name: str = "cl-pretrain-vl-pythia"
    # the (data, model) mesh of the ranks, one device each (core/mesh.py)
    mesh_shape: tuple = (-1, 1)
    distributed_init: bool = False


def check_supported(args: PretrainConfig, model_cfg: Optional[ModelConfig] = None) -> None:
    """A mesh that is not a grid of the ranks, or whose model axis does not
    divide the model, raises ValueError."""
    check_layout(args.mesh_shape, process_count(), model_cfg)


class PretrainTrainer:
    def __init__(
        self,
        model_cfg: ModelConfig,
        args: PretrainConfig,
        train_dataset,
        eval_dataset=None,
        tokenizer=None,
        init_params: Optional[Dict[str, torch.Tensor]] = None,
        device="cuda",
    ) -> None:
        """init_params: a full state_dict (reference names) to start from;
        otherwise a random model from args.seed. Joins the process group of a
        multi-process launch first; every rank starts from rank 0's model."""
        maybe_initialize_distributed(args, device=device)
        check_supported(args, model_cfg)
        mesh = make_mesh(args.mesh_shape)
        self.tp = mesh.model if mesh.shape[1] > 1 else None  # the model group under tensor parallelism
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.args = args
        self.train_dataset = train_dataset
        self.eval_dataset = eval_dataset
        self.tokenizer = tokenizer
        os.makedirs(args.output_dir, exist_ok=True)
        self.is_main = is_main_process()
        self.metrics = MetricsLogger(project=args.project_name, name=args.run_name,
                                     output_dir=args.output_dir) if self.is_main else None
        self.model = self._build_model(init_params)
        broadcast_model_(self.model)

        self.world = process_count()
        self.global_batch = args.per_device_train_batch_size * self.world
        self.accum = max(1, args.gradient_accumulation_steps)
        batches_per_epoch = len(train_dataset) // self.global_batch
        self.steps_per_epoch = max(1, batches_per_epoch // self.accum)
        self.total_steps = self.steps_per_epoch * args.num_train_epochs
        warmup = int(args.warmup_ratio * self.total_steps)
        schedule = linear_warmup_schedule(args.learning_rate, warmup, self.total_steps)
        self._train_cfg = TrainConfig(
            batch_size=self.global_batch,
            accumulate_grad_batches=self.accum,
            learning_rate=args.learning_rate,
            weight_decay=args.weight_decay,
            grad_norm=args.max_grad_norm,
            optim="adamw",
            betas=list(args.betas),
            seed=args.seed,
            label_tail=0,  # captions supervise every position
        )
        tx = build_optimizer(self._train_cfg, trainable_parameters(self.model), schedule, tp=self.tp)
        self.tx = MultiSteps(tx, self.accum) if self.accum > 1 else tx
        self.step_fn = make_train_step(model_cfg, self._train_cfg, self.tx, device=self.device)
        self._normalize = make_normalizer(model_cfg.vision)
        self.best_path: Optional[str] = None
        self.checkpoint_seconds: list = []  # wall seconds of each checkpoint saved

    # -- model -------------------------------------------------------------------
    def _build_model(self, init_params: Optional[Dict[str, torch.Tensor]]) -> VLPythia:
        """The starting model on the device (this rank's shard of it under
        tensor parallelism): trainable decoder and projector in float32, the
        frozen tower in bfloat16."""
        if init_params is None:
            return shard_model_(init_model(self.model_cfg, seed=self.args.seed, device=self.device), self.tp)
        model = VLPythia(self.model_cfg, device=self.device)
        model.vision_encoder.to(torch.bfloat16)
        model.load_state_dict(init_params, strict=True)
        return shard_model_(model, self.tp)

    # -- checkpointing -------------------------------------------------------------
    def _ckpt_dir(self, tag) -> str:
        return os.path.join(self.args.output_dir, f"checkpoint-{tag}" if isinstance(tag, int) else tag)

    def save_checkpoint(self, state: TrainState, tag, rng: np.random.Generator, epoch: int, batch_idx: int,
                        opt_steps: int, best: bool = False) -> str:
        """Rank 0 writes the checkpoint and rotates; every rank waits for it
        (and under tensor parallelism first joins the gather of the model
        and the optimizer state)."""
        start = time.perf_counter()
        path = self._ckpt_dir(tag)
        if best:
            self.best_path = path
        model_sd = gather_state_dict(self.model.state_dict(), self.tp)
        opt_state = gather_opt_state(state.opt_state, self.tp)
        if self.is_main:
            os.makedirs(path, exist_ok=True)
            save_task_checkpoint(model_sd, os.path.join(path, "model.safetensors"))
            counters = save_opt_state(opt_state, os.path.join(path, "opt_state.safetensors"))
            meta = {"step": opt_steps, "epoch": epoch, "batch_idx": batch_idx,
                    "rng_state": rng.bit_generator.state, "opt_state": counters}
            atomic_json_commit(os.path.join(path, "trainer_state.json"), meta, default=str)
            self._prune_checkpoints()
        barrier("pretrain_checkpoint_saved")
        self.checkpoint_seconds.append(time.perf_counter() - start)
        return path

    def _prune_checkpoints(self) -> None:
        """Keep the newest `save_total_limit` numbered checkpoints; while
        load_best_model_at_end may load it, the best is moved next to the
        newest first and so kept (with limit 1, the newest is kept too), as
        the HF Trainer rotates (`_sorted_checkpoints`, `_rotate_checkpoints`);
        a limit below 1 keeps every checkpoint, as there."""
        limit = self.args.save_total_limit
        if limit < 1:
            return
        out = self.args.output_dir
        ckpts = sorted(
            (d for d in os.listdir(out) if d.startswith("checkpoint-") and d.split("-")[-1].isdigit()),
            key=lambda d: int(d.split("-")[-1]),
        )
        best = os.path.basename(self.best_path) if self.best_path and self.args.load_best_model_at_end else None
        if best in ckpts and best != ckpts[-1]:
            ckpts.remove(best)
            ckpts.insert(len(ckpts) - 1, best)
            if limit == 1:
                limit = 2
        for victim in ckpts[: max(0, len(ckpts) - limit)]:
            shutil.rmtree(os.path.join(out, victim))

    def load_checkpoint(self, path: str, state: TrainState):
        """The model's parameters, the optimizer state (into `state`'s
        structure) and trainer_state.json of a checkpoint."""
        with open(os.path.join(path, "trainer_state.json")) as f:
            meta = json.load(f)
        self.model.load_state_dict(shard_state_dict(load_task_checkpoint(os.path.join(path, "model.safetensors")),
                                                    self.tp), strict=True)
        broadcast_model_(self.model)
        opt_state = load_opt_state(state.opt_state, os.path.join(path, "opt_state.safetensors"), meta["opt_state"],
                                   self.tp)
        return TrainState(meta["step"] * self.accum, self.model, opt_state), meta

    # -- loaders ---------------------------------------------------------------------
    def _loader(self, dataset, global_batch: int, text_len: int, shuffle: bool, seed: int = 0) -> BatchLoader:
        """This rank's slice of the global batches of `dataset`: the rows
        split over the data group, the same for model peers."""
        return BatchLoader(dataset, batch_size=global_batch // data_size(),
                           collate=partial(collate_pretrain, text_len=text_len), shuffle=shuffle, seed=seed,
                           drop_last=True, shard_id=data_index(), num_shards=data_size())

    def _batches(self, loader):
        return DevicePrefetcher(loader, self.device)

    # -- eval --------------------------------------------------------------------------
    @torch.no_grad()
    def evaluate(self, text_len: int) -> float:
        """Mean over the global eval batches of the bf16 CE loss, forward
        only; each rank's losses of its slices are summed over the data group
        (the slices are equal, so this is the mean of the global batches'
        losses; model peers compute the same ones)."""
        if self.eval_dataset is None:
            return float("nan")
        loader = self._loader(self.eval_dataset, self.args.per_device_eval_batch_size * self.world, text_len,
                              shuffle=False)
        dtype = torch.bfloat16
        losses = []
        for batch in self._batches(loader):
            patches = _vision_features(self.model, batch, self._normalize, dtype)
            losses.append(float(_ce_loss(self.model, batch, patches, dtype, None, remat=False)))
        total, n = process_reduce_sum(float(np.sum(losses)) if losses else 0.0, float(len(losses)),
                                      group=data_group())
        return total / n if n else float("nan")

    # -- train ---------------------------------------------------------------------------
    def train(self, resume_from_checkpoint: Optional[str] = None) -> TrainState:
        args = self.args
        text_len = args.model_max_length
        state = TrainState(0, self.model, self.tx.init(trainable_parameters(self.model)))
        rng = np.random.default_rng(args.seed)
        start_epoch, skip_batches = 0, 0
        if resume_from_checkpoint:
            state, meta = self.load_checkpoint(resume_from_checkpoint, state)
            rng.bit_generator.state = meta["rng_state"]
            start_epoch = meta["epoch"]
            skip_batches = meta["batch_idx"] + 1
            LOGGER.info("resumed from %s (epoch %d, batch %d)", resume_from_checkpoint, start_epoch, skip_batches)

        save_every = max(1, int(args.save_steps * self.total_steps))
        eval_every = max(1, int(args.eval_steps * self.total_steps))
        best_loss = float("inf")
        self.best_path = None
        opt_steps = state.step // self.accum

        for epoch in range(start_epoch, args.num_train_epochs):
            # the epoch order is a pure function of (seed, epoch), so a
            # mid-epoch resume skips batches of the same permutation
            seed = int(np.random.default_rng([args.seed, epoch]).integers(0, 2**31 - 1))
            loader = self._loader(self.train_dataset, self.global_batch, text_len, shuffle=True, seed=seed)
            if epoch == start_epoch:
                loader.set_epoch(0, start_batch=skip_batches)  # HF-style resume batch skipping
            for batch_idx, batch in enumerate(self._batches(loader), start=skip_batches if epoch == start_epoch else 0):
                state, m = self.step_fn(state, batch)
                if (batch_idx + 1) % self.accum:
                    continue
                opt_steps += 1
                if self.metrics is not None and opt_steps % args.logging_steps == 0:
                    self.metrics.log_metrics({"train/loss": float(m["loss"])}, step=opt_steps)
                if opt_steps % eval_every == 0:
                    eval_loss = self.evaluate(text_len)
                    if self.metrics is not None:
                        self.metrics.log_metrics({"eval/loss": eval_loss}, step=opt_steps)
                    LOGGER.info("step %d eval loss %.4f", opt_steps, eval_loss)
                    if eval_loss < best_loss:
                        best_loss = eval_loss
                        self.save_checkpoint(state, opt_steps, rng, epoch, batch_idx, opt_steps, best=True)
                        continue
                if opt_steps % save_every == 0:
                    self.save_checkpoint(state, opt_steps, rng, epoch, batch_idx, opt_steps)

        # always save checkpoint-final (hf.py:554-561)
        self.save_checkpoint(state, "checkpoint-final", rng, args.num_train_epochs - 1, -1, opt_steps)
        if args.load_best_model_at_end and self.best_path is not None:
            self.model.load_state_dict(shard_state_dict(
                load_task_checkpoint(os.path.join(self.best_path, "model.safetensors")), self.tp))
        return state
