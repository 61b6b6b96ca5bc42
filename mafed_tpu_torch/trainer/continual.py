"""The continual-learning task loop (counterpart of
mafed_tpu/trainer/continual.py; reference mafed/train.py:33-301).

For each task: build its data, train it from the previous task's best
parameters with the CL strategy, keep its best checkpoint, update the
strategy from the best model (memory, Fisher, teacher, adaptive weights),
then evaluate every task to fill column task_id of the accuracy matrix.
At the end: the average accuracy and BWT = mean(A[i, T-1] - A[i, i]) over
the earlier tasks (train.py:61-67), written to log/results.json.

The port's defaults are the JAX package's: the vision cache with its
features in a table on the device (`_refresh_vision_table`), the teacher's
states primed per transition when they fit their table (cl/distillation.py),
a resume bundle every epoch; a run restarted with resume_from_checkpoint
loads the tasks finished before the bundle's task and resumes that one.

Runs on one CUDA device unless given device="cpu", or data parallel over
the ranks of a torchrun launch (core/dist.py), one device each: every rank
runs this loop in step, rank 0 writes the files (provenance, metrics,
checkpoints, results) and the others wait where they read them. Every
branch that decides what runs next reads a value equal on every rank (the
summed validation score, sizes). Under mesh_shape [D, M] the D x M ranks
form a (data, model) grid (core/mesh.py): the runner holds this rank's
shard of the model, and the parameters this loop passes around stay full.
A grid that does not match the ranks or the model raises ValueError
(`check_supported`, the runner).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from mafed_tpu_torch.cl import CLMethod
from mafed_tpu_torch.core.config import ModelConfig, TrainConfig
from mafed_tpu_torch.core.device import check_layout, resolve_device
from mafed_tpu_torch.core.dist import barrier, is_main_process, maybe_initialize_distributed, process_count
from mafed_tpu_torch.core.logging import LOGGER, MetricsLogger, add_log_to_file
from mafed_tpu_torch.core.prng import seed_everything
from mafed_tpu_torch.data import vision_table as vt
from mafed_tpu_torch.data.factory import get_val_loaders, prepare_train_dataset
from mafed_tpu_torch.data.tokenizer import build_tokenizer
from mafed_tpu_torch.data.vision_cache import VisionFeatureCache, prime_vision_cache
from mafed_tpu_torch.evaluation.validate import gather_to_replicated
from mafed_tpu_torch.models.vl_pythia import init_model, n_vision_tokens
from mafed_tpu_torch.models.weights import load_pretrained, normalize_state_dict
from mafed_tpu_torch.trainer.runner import TaskRunner
from mafed_tpu_torch.training.train_state import TrainState
from mafed_tpu_torch.utils.checkpoint import (
    get_initialization_checkpoint,
    load_task_checkpoint,
    save_task_checkpoint,
    task_checkpoint_path,
)
from mafed_tpu_torch.utils.cl_utils import random_task_order
from mafed_tpu_torch.utils.save import save_configs


def check_supported(config: TrainConfig) -> None:
    """Raise on settings the run cannot take, instead of running something
    else: a (data, model) mesh that is not a grid of the ranks."""
    check_layout(config.mesh_shape, process_count())


class ContinualLearningTrainer:
    def __init__(
        self,
        config: TrainConfig,
        model_cfg: Optional[ModelConfig] = None,
        synthetic_images: bool = False,
        init_params: Optional[Dict[str, torch.Tensor]] = None,
        device="cuda",
    ) -> None:
        """init_params: a full state_dict (reference names) to start from;
        otherwise the initial checkpoint, or a random model from config.seed.
        Joins the process group of a multi-process launch first."""
        maybe_initialize_distributed(config, device=device)
        check_supported(config)
        self.config = config
        self.device = resolve_device(device)
        seed_everything(config.seed)
        self._initialize_tasks()
        self.is_main = is_main_process()
        if self.is_main:
            save_configs(config)
            add_log_to_file(os.path.join(config.output_dir, "log", "log.txt"))
        self.metrics = MetricsLogger(
            project=config.run_project, entity=config.run_entity, group=config.run_group,
            name=config.run_name, output_dir=os.path.join(config.output_dir, "log"),
        ) if self.is_main else None
        self.synthetic_images = synthetic_images
        self._init_params = init_params
        if model_cfg is None:
            if config.model_config and os.path.exists(config.model_config):
                model_cfg = ModelConfig.from_json(config.model_config)
            elif os.path.exists(os.path.join(config.model_name, "config.json")):
                model_cfg = ModelConfig.from_json(os.path.join(config.model_name, "config.json"))
            else:
                model_cfg = ModelConfig()
        self.model_cfg = model_cfg
        if self.is_main:
            with open(os.path.join(config.output_dir, "log", "model_config.json"), "w") as f:
                json.dump(model_cfg.to_dict(), f, indent=2)

        self.tokenizer = build_tokenizer(
            config.tokenizer_name, model_max_length=100, padding_side="left",
            allow_fallback=config.allow_tokenizer_fallback,
        )
        self.runner = TaskRunner(model_cfg, config, self.tokenizer, metrics=self.metrics, device=self.device)
        self.vision_cache = None
        if config.vision_cache:
            self.vision_cache = VisionFeatureCache(
                config.vision_cache_dir or os.path.join(config.output_dir, "vision_cache"),
                n_vision_tokens(model_cfg), model_cfg.vision.embed_dim,
            )
        self.val_loaders = {}  # built once in main()
        self.strategy = None
        self._vt_attached: List = []  # the leaf datasets holding the current vision table
        # seconds by stage, a list per stage: "prime", "fit", "save", "eval"
        self.timings: Dict[str, List[float]] = {"prime": [], "fit": [], "save": [], "eval": []}
        self.primed: List[int] = []  # images computed by each priming pass
        self.vision_tables: List[Dict[str, Any]] = []  # each task's table: tier, rows, MB (tier None: streaming)
        self.fit_logs: List[Dict[str, Any]] = []

    # ------------------------------------------------------------------
    def _initialize_tasks(self) -> None:
        cfg = self.config
        if not cfg.tasks:
            split_file = os.path.join(cfg.question_task_ids, cfg.exp, "train_question_ids.json")
            cfg.tasks = random_task_order(cfg.exp, split_file, seed=cfg.seed)
        if cfg.start_task_idx < 0 or cfg.start_task_idx >= len(cfg.tasks):
            raise ValueError(f"Invalid start_task_idx: {cfg.start_task_idx}")
        LOGGER.info("Task order: %s", cfg.tasks)
        if cfg.checkpoint and cfg.checkpoint_dir:
            raise ValueError("set either checkpoint or checkpoint_dir, not both")

    def _initial_params(self) -> Dict[str, torch.Tensor]:
        if self._init_params is not None:
            return self._init_params
        init_ckpt = get_initialization_checkpoint(self.config)
        if init_ckpt and os.path.exists(init_ckpt):
            return normalize_state_dict(load_task_checkpoint(init_ckpt), self.model_cfg)
        if os.path.isdir(self.config.model_name):
            return load_pretrained(self.config.model_name, self.model_cfg)[0]
        LOGGER.warning("no pretrained weights found; random init (%s)", self.config.model_name)
        return init_model(self.model_cfg, seed=self.config.seed, device=self.device).state_dict()

    def _prev_best_path(self, task_id: int, task: str) -> str:
        if task_id == 0 and self.config.start_task_idx > 0 and self.config.checkpoint_dir:
            return os.path.join(self.config.checkpoint_dir, f"{task}_best{self.config.checkpoint_extension}")
        return task_checkpoint_path(self.config.output_dir, task, self.config.checkpoint_extension)

    def _epochs_for(self, task_id: int) -> int:
        return self.config.epochs[0] if task_id == 0 else self.config.epochs[1]

    def _prime_vision_cache(self, params, datasets) -> None:
        if self.vision_cache is None:
            return
        start = time.time()
        self.runner.load_params(params)  # the tower that computes the features
        n = prime_vision_cache(self.vision_cache, datasets, self.runner.model)
        self.runner.synchronize()
        self.primed.append(n)
        self.timings["prime"].append(time.time() - start)
        if n:
            LOGGER.info("vision cache: computed %d image features in %.1fs", n, self.timings["prime"][-1])

    def _refresh_vision_table(self, strategy, train_dataset, task=None) -> None:
        """The task's device vision table (data/vision_table.py): every image
        its batches can draw, the train set and the replay memory (drawn
        from earlier train sets, primed into the same cache), and the
        validation sets as the budget allows, in tiers: all tasks' val sets,
        then the current task's, then none. The previous task's leaves are
        detached first (memory leaves recur across tasks). Over budget, the
        task streams its features."""
        cfg = self.config
        if self.vision_cache is None or cfg.device_vision_table_mb <= 0:
            return
        base = [train_dataset] + list(getattr(strategy, "datasets", []))
        all_val = [loader.dataset for loader in self.val_loaders.values()]
        cur_val = [self.val_loaders[task].dataset] if task in self.val_loaders else []
        tiers = [("train+memory+val", base + all_val)]
        if cur_val and len(all_val) > 1:
            tiers.append(("train+memory+current-val", base + cur_val))
        tiers.append(("train+memory", base))

        vt.attach(self._vt_attached, None)
        self._vt_attached = []
        self.runner.vision_table = None
        dtype = cfg.vision_table_dtype
        row_bytes = vt.table_nbytes(1, n_vision_tokens(self.model_cfg), self.model_cfg.vision.embed_dim, dtype=dtype)
        budget = cfg.device_vision_table_mb * (1 << 20)
        for tier, datasets in tiers:
            keys = list(dict.fromkeys(vt.iter_image_keys(datasets)))
            if len(keys) * row_bytes > budget:
                continue
            table = vt.build_table(self.vision_cache, keys, dtype=dtype, device=self.device)
            self._vt_attached = vt.attach(datasets, table)
            self.runner.vision_table = table
            self.vision_tables.append({"tier": tier, "rows": len(keys), "mb": table.nbytes / (1 << 20)})
            LOGGER.info("vision table [%s, %s]: %d unique images (%.0f MB) on the device",
                        tier, dtype, len(keys), len(keys) * row_bytes / (1 << 20))
            return
        self.vision_tables.append({"tier": None, "rows": 0, "mb": 0.0})
        LOGGER.info("vision table: train+memory image set over the %d MB budget; streaming patches this task",
                    cfg.device_vision_table_mb)

    # ------------------------------------------------------------------
    def validate_all_tasks(self, params, task_id: int, accuracy: np.ndarray) -> np.ndarray:
        start = time.time()
        self.runner.load_params(params)
        model = gather_to_replicated(self.runner.model)  # one gather for every task's val set
        metrics = {}
        for val_task_id, val_task in enumerate(self.config.tasks):
            LOGGER.info(val_task)
            val_log, _ = self.runner.validate(self.val_loaders[val_task], model)
            accuracy[val_task_id, task_id] = val_log["valid/acc"]
            for k, v in val_log.items():
                metrics[f"validation/{val_task}/{k.split('/', 1)[1]}"] = float(v)
        metrics["validation/average_accuracy"] = float(np.mean(accuracy[:, task_id]))
        LOGGER.info("Average score: %.2f", metrics["validation/average_accuracy"] * 100)
        if task_id > 0:
            bwt = float(np.mean(np.diag(accuracy[:task_id, task_id] - accuracy[:task_id, :task_id])))
            metrics["validation/BWT"] = bwt
            LOGGER.info("Average forgetting: %.2f", bwt * 100)
        if self.metrics is not None:
            self.metrics.log_metrics(metrics, step=task_id, is_valid_step=True)
        self.timings["eval"].append(time.time() - start)
        return accuracy

    def main(self) -> Dict[str, Any]:
        cfg = self.config
        params = self._initial_params()
        self.val_loaders = get_val_loaders(
            cfg, self.tokenizer, self.model_cfg.vision, self.runner.val_text_len,
            synthetic_images=self.synthetic_images, vision_cache=self.vision_cache,
        )
        self._prime_vision_cache(params, [loader.dataset for loader in self.val_loaders.values()])
        strategy = self.strategy = CLMethod[cfg.cl_method](cfg, self.model_cfg)
        self.runner.ensure_window_policy(strategy)
        n_tasks = len(cfg.tasks)
        accuracy = np.zeros((n_tasks, n_tasks))
        resume_dir = os.path.join(cfg.output_dir, "resume")
        # a restart with the same command: the bundle names the task it
        # belongs to, and the tasks before it finished in the run that saved it
        resume_task = -1
        if cfg.resume_from_checkpoint and os.path.exists(os.path.join(resume_dir, "fit_state.json")):
            with open(os.path.join(resume_dir, "fit_state.json")) as f:
                resume_task = int(json.load(f).get("task_id", -1))

        for task_id, task in enumerate(cfg.tasks):
            LOGGER.info("Task %d: %s", task_id, task)
            train_dataset = prepare_train_dataset(
                cfg, task, self.tokenizer, self.model_cfg.vision,
                synthetic_images=self.synthetic_images, vision_cache=self.vision_cache,
            )
            self._prime_vision_cache(params, [train_dataset])
            self._refresh_vision_table(strategy, train_dataset, task)
            best_path = self._prev_best_path(task_id, task)

            train_this = task_id >= cfg.start_task_idx
            if train_this and task_id < resume_task and os.path.exists(best_path):
                LOGGER.info("task %d finished before the resume bundle (task %d): loading %s instead of retraining",
                            task_id, resume_task, best_path)
                train_this = False
            if train_this:
                start = time.time()
                self.runner.setup_task_optimizer(len(train_dataset), strategy=strategy)
                state = self.runner.init_state(params)
                strategy.update_after_new_task(self.runner, state, train_dataset)
                state, best_trainable, fit_log = self.runner.fit(
                    state, strategy, train_dataset, self.val_loaders[task], task_id, self._epochs_for(task_id),
                    resume_dir=resume_dir, resume=bool(cfg.resume_from_checkpoint),
                )
                self.timings["fit"].append(time.time() - start)
                self.fit_logs.append(fit_log)
                if self.metrics is not None:
                    self.metrics.set_global_step_offset(self.metrics.global_step_offset + fit_log["global_step"])
                params = {**best_trainable, **self.runner.frozen_params()}
                start = time.time()
                if self.is_main:
                    save_task_checkpoint(params, best_path)
                barrier("task_checkpoint_saved")
                self.timings["save"].append(time.time() - start)
                del state
            elif os.path.exists(best_path):
                params = load_task_checkpoint(best_path)

            # the strategy transition reads the best model
            if task_id < n_tasks - 1:
                self.runner.load_params(params)
                eval_state = TrainState(0, self.runner.model, None)
                update_loader = self.runner.make_train_loader(train_dataset, shuffle=False)
                strategy.update(self.runner, eval_state, train_dataset, update_loader)

            accuracy = self.validate_all_tasks(params, task_id, accuracy)

        result = {
            "accuracy_matrix": accuracy.tolist(),
            "average_accuracy": float(np.mean(accuracy[:, n_tasks - 1])),
            "bwt": float(np.mean(np.diag(accuracy[: n_tasks - 1, n_tasks - 1] - accuracy[: n_tasks - 1, : n_tasks - 1])))
            if n_tasks > 1 else 0.0,
        }
        if self.is_main:
            with open(os.path.join(cfg.output_dir, "log", "results.json"), "w") as f:
                json.dump(result, f, indent=2)
            self.metrics.finish()
        LOGGER.info("final average accuracy: %.4f", result["average_accuracy"])
        strategy.close()
        return result
