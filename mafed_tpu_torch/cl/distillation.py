"""Feature distillation, MAFED (counterpart of mafed_tpu/cl/distillation.py).

On every replay_interval-th batch: the replay CE (x replay_coeff) plus the
per-layer hidden-state distillation of the student against the previous
task's best model (the teacher), with gamma-discounted layer weights and
equal / balanced / adaptive modality weights. The adaptive weights are
gradient-based modality importances averaged over the task's loader and
running-averaged across tasks (reference dl_weights.py:62-69). Teacher and
student run in one step (training/step.py), unless the teacher-state cache
(data/teacher_cache.py) primed the teacher's states at the transition.
"""

from __future__ import annotations

import os
import time
from functools import partial
from typing import List

import numpy as np
import torch

from mafed_tpu_torch.cl.base import CLStrategy
from mafed_tpu_torch.cl.replay import choose_memory
from mafed_tpu_torch.core.dist import data_group, process_reduce_sum
from mafed_tpu_torch.core.logging import LOGGER
from mafed_tpu_torch.data.collate import collate_train
from mafed_tpu_torch.data.teacher_cache import (
    TeacherIndexView, TeacherStateCache, TeacherStateView, build_teacher_table, prime_teacher_cache,
    resolve_teacher_cache_mode, teacher_seq_len, teacher_table_nbytes,
)
from mafed_tpu_torch.data.vqa_dataset import ConcatDataset, question_id_of
from mafed_tpu_torch.training.step import distillation_layers
from mafed_tpu_torch.training.train_state import make_teacher


class FeatureDistillation(CLStrategy):
    name = "featdistill"
    needs_replay = True

    def __init__(self, config, model_cfg, **kwargs) -> None:
        super().__init__(config, model_cfg)
        self.memory_per_task = int(config.cl_memory / max(1, len(config.tasks or []) - 1))
        self.rng = np.random.default_rng(config.seed)
        self.datasets: List = []
        self.teacher = None
        self.strategy = config.distillation_modality_weighing_strategy
        self.layers = distillation_layers(
            config.distillation_layer_weighing_strategy, model_cfg.num_hidden_layers - 1, config.distillation_layer
        )
        # balanced: a fixed 0.5 / 0.5 (dl_weights.py:30-31); adaptive: set at each update
        fill = 0.5 if self.strategy == "balanced" else 1.0
        self.lang_coeff = np.full((len(self.layers),), fill, np.float32)
        self._lang_dev = None  # lang_coeff on the runner's device
        # the teacher-state cache of each transition where it is on: its tier
        # ("in-step", "table" or "stream"), examples primed, seconds, table MB
        self.teacher_cache_log: List[dict] = []

    def _lang_coeffs(self, runner) -> torch.Tensor:
        if self._lang_dev is None:
            self._lang_dev = torch.from_numpy(self.lang_coeff).to(runner.device)
        return self._lang_dev

    # -- steps -------------------------------------------------------------------
    def replay_step(self, runner, state):
        return runner.distill_step(state, self.teacher, self.next_memory_batch(), self._lang_coeffs(runner))

    def supports_fused_window(self, window: int) -> bool:
        """The fused MAFED window holds window - 1 CE microbatches and one
        distill microbatch, so a window may hold one replay position at most."""
        return self.config.replay_interval >= window

    def window_step(self, runner, state, idx_batches):
        replay_positions = [j for j, (i, _) in enumerate(idx_batches) if self.is_replay_batch(i)]
        if not replay_positions:  # the first task, or an off-cadence window
            return runner.ce_window_step(state, runner.stack_window([b for _, b in idx_batches]))
        ce_batches = [b for j, (_, b) in enumerate(idx_batches) if j not in replay_positions]
        return runner.mafed_window_step(
            state, self.teacher, runner.stack_window(ce_batches), self.next_memory_batch(), self._lang_coeffs(runner)
        )

    # -- task transitions ----------------------------------------------------------
    def update(self, runner, state, dataset, loader) -> None:
        """Teacher <- a bfloat16 copy of the finished task's best model;
        memory += a seeded subset of its data; the adaptive weights."""
        self.teacher = make_teacher(state.model)
        self.datasets.append(choose_memory(self.rng, dataset, self.memory_per_task))
        mem_dataset = self._maybe_prime_teacher_cache(runner, ConcatDataset(self.datasets))
        self.set_memory(runner, mem_dataset)
        LOGGER.info("featdistill memory: %d samples", len(mem_dataset))

        if self.strategy == "adaptive":
            importances = self._compute_adaptive_weights(runner, state, loader)
            if self.task_id < 1:
                self.lang_coeff = importances
            else:  # running average across tasks (dl_weights.py:62-69)
                self.lang_coeff = (importances + self.task_id * self.lang_coeff) / (self.task_id + 1)
            self._lang_dev = None
            LOGGER.info("adaptive lang coefficients: %s", np.round(self.lang_coeff, 4))
        self.task_id += 1

    def _maybe_prime_teacher_cache(self, runner, mem_dataset):
        """The teacher-state cache of this transition: the memory set is
        fixed and the teacher frozen for the next task, so each memory
        example's teacher states are computed once here. The tier is decided
        from sizes before any priming: states that fit device_teacher_table_mb
        go to a table on the card; over that budget "auto" keeps the in-step
        teacher and "on" streams them from disk. Returns the dataset the
        memory stream reads."""
        cfg = self.config
        runner.teacher_table = None  # its rows belong to the previous teacher
        mode = resolve_teacher_cache_mode(cfg.teacher_state_cache)
        if mode == "off" or cfg.distillation_coeff == 0 or not self.layers:
            return mem_dataset  # off, or a pure-replay ablation that never reads the teacher
        deepest_tap = max(self.layers)
        seq_len = teacher_seq_len(self.model_cfg, runner.train_text_len)
        n_mem = len(mem_dataset)
        budget = cfg.device_teacher_table_mb * (1 << 20)
        need = teacher_table_nbytes(n_mem, deepest_tap + 1, seq_len, self.model_cfg.hidden_size)
        fits = 0 < need <= budget
        if mode == "auto" and not fits:
            LOGGER.info("teacher cache auto: %.1f MB of states exceeds device_teacher_table_mb=%d; "
                        "keeping the in-step teacher", need / (1 << 20), cfg.device_teacher_table_mb)
            self.teacher_cache_log.append({"tier": "in-step", "examples": n_mem, "need_mb": need / (1 << 20)})
            return mem_dataset
        cache = TeacherStateCache(cfg.teacher_cache_dir or os.path.join(cfg.output_dir, "teacher_cache"),
                                  generation=self.task_id, n_states=deepest_tap + 1, seq_len=seq_len,
                                  hidden=self.model_cfg.hidden_size)
        cache.drop_older_generations()
        start = time.time()
        n = prime_teacher_cache(
            cache, mem_dataset, self.teacher,
            collate=partial(collate_train, text_len=runner.train_text_len, label_tail=cfg.label_tail or None),
            deepest_tap=deepest_tap, batch_size=cfg.batch_size, vision_table=runner.vision_table,
        )
        runner.synchronize()
        log = {"examples": n_mem, "primed": n, "prime_s": time.time() - start, "need_mb": need / (1 << 20)}
        if n:
            LOGGER.info("teacher cache gen%d: %d example states in %.1fs", self.task_id, n, log["prime_s"])
        if fits:
            qids = [question_id_of(mem_dataset, i) for i in range(n_mem)]
            table = runner.teacher_table = build_teacher_table(cache, qids, device=runner.device)
            LOGGER.info("teacher table gen%d: %d examples, %.1f MB on the device",
                        self.task_id, n_mem, table.nbytes / (1 << 20))
            self.teacher_cache_log.append({"tier": "table", **log, "table_mb": table.nbytes / (1 << 20)})
            return ConcatDataset([TeacherIndexView(d, table) for d in self.datasets])
        LOGGER.info("teacher table gen%d: %.1f MB exceeds device_teacher_table_mb=%d; streaming cached states",
                    self.task_id, need / (1 << 20), cfg.device_teacher_table_mb)
        self.teacher_cache_log.append({"tier": "stream", **log})
        return ConcatDataset([TeacherStateView(d, cache) for d in self.datasets])

    def _compute_adaptive_weights(self, runner, state, loader) -> np.ndarray:
        """Dataset-level modality importances (dl_weights.py:91-146), the
        sums taken over the data group's slices (model peers hold the same rows). A rank's gradients are those of
        its own mean loss, ranks times the whole batch's; the factor is
        common to both modalities and cancels in the ratio."""
        lang_sums = np.zeros((len(self.layers),), np.float64)
        image_sums = np.zeros((len(self.layers),), np.float64)
        n_lang = n_image = 0.0
        for batch in runner.device_batches(loader):
            ls, ims, nl, ni = runner.adaptive_weights_step(state.model, batch)
            lang_sums += ls.cpu().double().numpy()
            image_sums += ims.cpu().double().numpy()
            n_lang += float(nl)
            n_image += float(ni)
        k = len(self.layers)
        sums = process_reduce_sum(*lang_sums, *image_sums, n_lang, n_image, group=data_group())
        lang_sums, image_sums = np.asarray(sums[:k]), np.asarray(sums[k : 2 * k])
        n_lang, n_image = sums[2 * k :]
        lang_imp = lang_sums / max(n_lang, 1e-9)
        image_imp = image_sums / max(n_image, 1e-9)
        return (lang_imp / (lang_imp + image_imp)).astype(np.float32)
