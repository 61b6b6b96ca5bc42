"""TaskRunner: the step registry and the per-task fit loop (counterpart of
mafed_tpu/trainer/runner.py).

The reference trains each task with a PyTorch Lightning Trainer
(mafed/train.py:284-301): epochs, gradient accumulation with the replay
cadence kept inside accumulation windows, gradient clipping, generative
validation after each epoch driving EarlyStopping(patience, min_delta 5e-5)
and top-1 best-checkpoint selection (train.py:243-263).

The runner owns the one VLPythia of the run on its device: trainable
decoder and projector in float32, the frozen tower in bfloat16. A parameter
state_dict (reference names) goes in with `load_params`; the steps are the
factories of training/step.py. With fused windows (the default), each
accumulation window is one step: its microbatches stay on the host until
the window is full, then go over as one stacked, pinned, non-blocking copy.

Device tables: with a vision table (data/vision_table.py) or a teacher table
(data/teacher_cache.py) attached, batches carry int32 rows and the runner
gathers their features or teacher states on the card, on the stream that
runs the step, after the batch's copy.

Data parallelism (core/dist.py): each rank runs one runner on its device.
config.batch_size is the global batch; each rank's loaders take its
interleaved slice, batch_size / ranks rows a batch, of the same seeded
order. The steps average the gradients over the ranks before the clip
(training/step.py), so every rank applies the update one process would
apply to the union of the slices; rank 0's parameters are broadcast after
init and after a bundle loads; rank 0 writes the bundles, and every rank
waits for them.

Tensor parallelism (core/mesh.py): under mesh_shape [D, M] the model is
this rank's shard (models/tensor_parallel.py); the loaders split the rows
over the data group, so model peers see the same batches (checked once a
task); parameters go in full (`load_params` shards them) and come out full
(`host_trainable` and the bundles gather them, every rank joining); each
shard is broadcast within its data group.

Profiling: with `profile_dir`, a torch.profiler trace (core/profiling.py)
covers batches 10-20 of task 0, epoch 0, as in the JAX package.

Resume bundles: at the end of every `resume_bundle_every`-th epoch, and at
the update boundary where a preemption was requested (core/preempt.py), fit
saves <output_dir>/resume: model.safetensors, best.safetensors,
opt_state.safetensors and, last, fit_state.json; a run with
resume_from_checkpoint continues from it exactly.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import math
import os
import time
from collections import Counter
from functools import partial
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from mafed_tpu_torch.constants import PATIENCE_THRESHOLD
from mafed_tpu_torch.core import preempt
from mafed_tpu_torch.core.config import ModelConfig, TrainConfig
from mafed_tpu_torch.core.device import resolve_device
from mafed_tpu_torch.core.dist import (
    barrier, broadcast_model_, data_index, data_size, is_main_process, same_on_every_rank,
)
from mafed_tpu_torch.core.mesh import check_divides, gather_state_dict, make_mesh, shard_state_dict
from mafed_tpu_torch.core.logging import LOGGER, MetricsLogger
from mafed_tpu_torch.core.profiling import Trace
from mafed_tpu_torch.data.collate import collate_train
from mafed_tpu_torch.data.loader import BatchLoader
from mafed_tpu_torch.data.prefetch import DevicePrefetcher, as_tensor, to_device
from mafed_tpu_torch.evaluation.decode import make_greedy_decoder
from mafed_tpu_torch.evaluation.validate import validate_vqa
from mafed_tpu_torch.models.tensor_parallel import shard_model_
from mafed_tpu_torch.models.vl_pythia import VLPythia
from mafed_tpu_torch.optim.optimizer import MultiSteps, build_optimizer, set_schedule
from mafed_tpu_torch.training.step import (
    distillation_layers,
    make_adaptive_weights_fn,
    make_ce_window_step,
    make_distill_step,
    make_ewc_fisher_fn,
    make_mafed_window_step,
    make_train_step,
)
from mafed_tpu_torch.training.train_state import FROZEN_PREFIX, TrainState, trainable_parameters
from mafed_tpu_torch.utils.checkpoint import (
    atomic_json_commit, gather_opt_state, load_opt_state, load_task_checkpoint, save_opt_state,
    save_task_checkpoint,
)

# the reference's schedule horizon: ceil(batches / accum) * 60, whatever the
# real number of epochs (vqa_cont_learner.py:62-63)
SCHEDULE_EPOCHS = 60
# with profile_dir: the trace starts at batch 10 of task 0, epoch 0, and stops
# at the first update boundary at or after batch 20 (or at the epoch's end)
PROFILE_BATCHES = (10, 20)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class TaskRunner:
    def __init__(
        self,
        model_cfg: ModelConfig,
        config: TrainConfig,
        tokenizer,
        metrics: Optional[MetricsLogger] = None,
        device="cuda",
    ) -> None:
        self.model_cfg = model_cfg
        self.config = config
        self.tokenizer = tokenizer
        self.metrics = metrics
        self.device = resolve_device(device)
        pad_m = max(1, config.text_pad_multiple)
        # question + answer + eos; one length for the whole run
        self.train_text_len = _round_up(config.max_txt_len + 20, pad_m)
        self.val_text_len = _round_up(config.max_txt_len + 4, pad_m)
        mesh = make_mesh(config.mesh_shape)
        check_divides(mesh.shape[1], model_cfg)
        self.tp = mesh.model if mesh.shape[1] > 1 else None  # the model group under tensor parallelism
        self.model = shard_model_(VLPythia(model_cfg, device=self.device), self.tp)
        self.model.vision_encoder.to(torch.bfloat16)
        self.decoder = make_greedy_decoder(
            model_cfg, eos_token_id=getattr(tokenizer, "eos_token_id", 0), device=self.device
        )
        self.fisher_step = make_ewc_fisher_fn(model_cfg, config, device=self.device)
        try:  # tap ids for the per-layer distill-loss keys (distillation configs only)
            self._distill_layer_ids = tuple(distillation_layers(
                config.distillation_layer_weighing_strategy, model_cfg.num_hidden_layers - 1, config.distillation_layer
            ))
        except ValueError:
            self._distill_layer_ids = ()
        self._steps: Dict[str, Callable] = {}
        self.step_counts: Counter = Counter()  # optimizer steps taken, by kind
        self.window = 1  # microbatches per step (1 = the per-microbatch MultiSteps path)
        self.tx = None
        self.ce_step: Optional[Callable] = None
        # the device tables, swapped between tasks (None: batches carry features / the in-step teacher)
        self.vision_table = None
        self.teacher_table = None
        # a host copy of the frozen tower for this task's bundles, and the
        # (task, best_acc) whose best.safetensors the bundle holds
        self._bundle_frozen: Optional[Tuple[int, Dict[str, torch.Tensor]]] = None
        self._bundle_best_key = None
        self.bundle_save_s: list = []  # seconds of each bundle saved

    # -- parameters --------------------------------------------------------------
    def load_params(self, params: Dict[str, torch.Tensor]) -> None:
        """Copy a full state_dict (reference names, any device and float
        dtype) into the model, in the model's dtypes: this rank's shards of
        it under tensor parallelism."""
        self.model.load_state_dict(shard_state_dict(params, self.tp), strict=True)

    def full_trainable(self) -> Dict[str, torch.Tensor]:
        """The trainable parameters of the whole model: the live tensors, or
        under tensor parallelism their gather (every rank calls it)."""
        return gather_state_dict({k: p.detach() for k, p in trainable_parameters(self.model).items()}, self.tp)

    def host_trainable(self) -> Dict[str, torch.Tensor]:
        """A CPU copy of the trainable parameters of the whole model (a
        collective under tensor parallelism)."""
        return {k: p.to("cpu", copy=True) for k, p in self.full_trainable().items()}

    def frozen_params(self) -> Dict[str, torch.Tensor]:
        """The frozen tower's entries of the state_dict (the live tensors)."""
        return {k: v for k, v in self.model.state_dict().items() if k.startswith(FROZEN_PREFIX)}

    # -- loaders -------------------------------------------------------------------
    def make_train_loader(self, dataset, shuffle: bool = True, seed: Optional[int] = None,
                          infinite: bool = False) -> BatchLoader:
        """This rank's slice of the global batches of `dataset`: the rows
        split over the data group, the same for model peers."""
        world = data_size()
        if self.config.batch_size % world:
            raise ValueError(f"the global batch_size {self.config.batch_size} does not divide over {world} ranks")
        return BatchLoader(
            dataset,
            batch_size=self.config.batch_size // world,
            collate=partial(collate_train, text_len=self.train_text_len, label_tail=self.config.label_tail or None),
            shuffle=shuffle or infinite,
            seed=self.config.seed if seed is None else seed,
            num_workers=self.config.n_workers,
            drop_last=True,
            infinite=infinite,
            shard_id=data_index(),
            num_shards=world,
        )

    def device_batches(self, loader):
        return self._resolving_iter(DevicePrefetcher(loader, self.device, depth=self.config.prefetch_depth))

    def _resolving_iter(self, iterable):
        """The batches with their table rows gathered; closing it closes the
        producer. DevicePrefetcher hands a batch over after the current
        stream waits on its copy, so the gathers are ordered after it."""
        it = iter(iterable)
        try:
            for batch in it:
                yield self.resolve_tables(batch)
        finally:
            it.close()

    def resolve_tables(self, batch):
        """patch_idx -> patches through the vision table and t_idx -> t_hs
        through the teacher table, gathered on the card (no-ops without them).
        Validation's decode batches go through it too: the JAX package's
        separate `eval_resolve` differs from it only on multi-process pods."""
        if self.vision_table is not None and "patch_idx" in batch:
            batch = self.vision_table.resolve(batch)
        if self.teacher_table is not None and "t_idx" in batch:
            batch = self.teacher_table.resolve(batch)
        return batch

    @property
    def host_window(self) -> bool:
        """Fused windows keep microbatches on the host; stack_window ships
        each window as one copy."""
        return self.window > 1

    def fit_batches(self, loader):
        return iter(loader) if self.host_window else iter(self.device_batches(loader))

    def memory_batches(self, loader):
        """The memory stream takes the layout of fit_batches, so a window
        never mixes host and device batches."""
        return self.fit_batches(loader)

    # -- optimizer and state ---------------------------------------------------------
    def ensure_window_policy(self, strategy) -> None:
        """Fix the fused-window size before any memory stream exists."""
        if self.tx is not None:
            return
        accum = max(1, self.config.accumulate_grad_batches)
        fused = self.config.fused_window and accum > 1 and strategy is not None and strategy.supports_fused_window(accum)
        self.window = accum if fused else 1

    def setup_task_optimizer(self, dataset_size: int, strategy=None) -> None:
        """Set the task's schedule horizon; build the optimizer once for the run.

        The horizon is ceil(batches / accum) * 60 with warmup_perc of it
        (the reference's quirk). Fused windows run the optimizer directly;
        otherwise microbatch steps run under MultiSteps(accum). Either way
        the optimizer applies once per window."""
        batches_per_epoch = dataset_size // self.config.batch_size
        accum = max(1, self.config.accumulate_grad_batches)
        total_steps = math.ceil(batches_per_epoch / accum) * SCHEDULE_EPOCHS
        warmup_steps = int(self.config.warmup_perc * total_steps)
        LOGGER.info("schedule: total=%d warmup=%d", total_steps, warmup_steps)
        self._sched = (warmup_steps, total_steps)
        if self.tx is None:
            self.ensure_window_policy(strategy)
            tx = build_optimizer(self.config, trainable_parameters(self.model), tp=self.tp)
            if accum > 1 and self.window == 1:
                tx = MultiSteps(tx, accum)
            self.tx = tx
            self.ce_step = self._counted("ce_step", make_train_step(
                self.model_cfg, self.config, tx, device=self.device))
            if self.window > 1:
                LOGGER.info("fused accumulation windows: %d microbatches/step", accum)
        if self.window > 1 and batches_per_epoch < self.window:
            LOGGER.warning(
                "epoch has %d batches < window %d: accumulation windows span "
                "epochs (an optimizer step fires once a window fills)", batches_per_epoch, self.window,
            )

    def init_state(self, params: Dict[str, torch.Tensor]) -> TrainState:
        """Load `params` into the model (rank 0's, over several ranks); a fresh
        optimizer state on this task's schedule."""
        if self.tx is None:
            raise RuntimeError("call setup_task_optimizer first")
        self.load_params(params)
        broadcast_model_(self.model)
        opt_state = set_schedule(self.tx.init(trainable_parameters(self.model)), *self._sched)
        return TrainState(0, self.model, opt_state)

    # -- steps -----------------------------------------------------------------------
    def _counted(self, kind: str, step: Callable) -> Callable:
        def run(*args):
            self.step_counts[kind] += 1
            return step(*args)
        return run

    def _step(self, kind: str, make: Callable) -> Callable:
        if kind not in self._steps:
            self._steps[kind] = self._counted(kind, make())
        return self._steps[kind]

    def ewc_step(self, state, batch, ewc_state):
        step = self._step("ewc_step", lambda: make_train_step(
            self.model_cfg, self.config, self.tx, with_ewc=True, device=self.device))
        return step(state, batch, ewc_state)

    def distill_step(self, state, teacher, batch, lang_coeffs):
        step = self._step("distill_step", lambda: make_distill_step(
            self.model_cfg, self.config, self.tx, device=self.device))
        return step(state, teacher, batch, lang_coeffs)

    def stack_window(self, batches) -> Dict[str, torch.Tensor]:
        """[n_mb, B, ...] tensors on the device of a window's microbatches.
        Host batches are stacked straight into pinned memory and go over as
        one non-blocking copy per field (table rows as [n_mb, B] int32, then
        gathered on the card, on the stream of the copy); device batches
        stack on the device."""
        keys = [k for k in batches[0] if isinstance(batches[0][k], (np.ndarray, torch.Tensor))]
        if isinstance(batches[0]["input_ids"], torch.Tensor) and batches[0]["input_ids"].device == self.device:
            return {k: torch.stack([b[k] for b in batches]) for k in keys}
        out = {}
        for k in keys:
            parts = [as_tensor(b[k]) for b in batches]
            pin = self.device.type == "cuda"
            buf = torch.empty((len(parts),) + tuple(parts[0].shape), dtype=parts[0].dtype, pin_memory=pin)
            torch.stack(parts, out=buf)
            out[k] = buf.to(self.device, non_blocking=pin)
        return self.resolve_tables(out)

    def ce_window_step(self, state, stacked):
        step = self._step("ce_window", lambda: make_ce_window_step(
            self.model_cfg, self.config, self.tx, device=self.device))
        return step(state, stacked)

    def ewc_window_step(self, state, stacked, ewc_state):
        step = self._step("ewc_window", lambda: make_ce_window_step(
            self.model_cfg, self.config, self.tx, with_ewc=True, device=self.device))
        return step(state, stacked, ewc_state)

    def mafed_window_step(self, state, teacher, ce_stacked, distill_batch, lang_coeffs):
        step = self._step("mafed_window", lambda: make_mafed_window_step(
            self.model_cfg, self.config, self.tx, n_ce=self.window - 1, device=self.device))
        if not isinstance(distill_batch["input_ids"], torch.Tensor):  # a host memory batch
            distill_batch = self.resolve_tables(to_device(distill_batch, self.device))
        return step(state, teacher, ce_stacked, distill_batch, lang_coeffs)

    def adaptive_weights_step(self, model, batch):
        fn = self._steps.get("adaptive")
        if fn is None:
            fn = self._steps["adaptive"] = make_adaptive_weights_fn(
                self.model_cfg, self.config, self._distill_layer_ids, device=self.device)
        return fn(model, batch)

    def validate(self, val_loader, model=None) -> Tuple[Dict, Dict]:
        """validate_vqa on `model`, by default the runner's (gathered first
        under tensor parallelism, every rank joining)."""
        return validate_vqa(self.model if model is None else model, self.decoder, val_loader, self.tokenizer,
                            self.config.val_batch_size, max_batches=self.config.val_max_batches,
                            resolve=self.resolve_tables)

    def synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- resume bundles ------------------------------------------------------------------
    def _save_resume_bundle(self, resume_dir: str, state: TrainState, meta: Dict, best_trainable) -> None:
        """The parameters (model.safetensors), the best ones so far
        (best.safetensors, written when they change), the optimizer state,
        then the commit marker fit_state.json with `meta` and the optimizer's
        counters. Rank 0 writes (the ranks hold equal copies, or under tensor
        parallelism gather them first); every rank waits until it has."""
        trainable = self.full_trainable()
        opt_state = gather_opt_state(state.opt_state, self.tp)
        if not is_main_process():
            barrier("resume_bundle_saved")
            return
        start = time.time()
        os.makedirs(resume_dir, exist_ok=True)
        task_id = meta["task_id"]
        if self._bundle_frozen is None or self._bundle_frozen[0] != task_id:
            # the frozen tower never changes within a task: one host copy serves its bundles
            self._bundle_frozen = (task_id, {k: v.to("cpu", copy=True) for k, v in self.frozen_params().items()})
        frozen = self._bundle_frozen[1]
        save_task_checkpoint({**trainable, **frozen}, os.path.join(resume_dir, "model.safetensors"))
        best_key, best_path = (task_id, meta["best_acc"]), os.path.join(resume_dir, "best.safetensors")
        if best_trainable is not None and not (self._bundle_best_key == best_key and os.path.exists(best_path)):
            save_task_checkpoint({**best_trainable, **frozen}, best_path)
            self._bundle_best_key = best_key
        meta = {**meta, "opt_counters": save_opt_state(opt_state, os.path.join(resume_dir, "opt_state.safetensors"))}
        atomic_json_commit(os.path.join(resume_dir, "fit_state.json"), meta)
        seconds = time.time() - start
        self.bundle_save_s.append(seconds)
        LOGGER.info("resume bundle (task %s epoch %s) saved in %.1fs", task_id, meta["epoch"], seconds)
        if self.metrics is not None:
            self.metrics.log_metrics({f"task_{task_id}/bundle_save_s": round(seconds, 2)}, step=meta["global_step"])
        barrier("resume_bundle_saved")

    def _load_resume_bundle(self, resume_dir: str, state: TrainState):
        """(state, meta, best trainable parameters or None) of a bundle."""
        with open(os.path.join(resume_dir, "fit_state.json")) as f:
            meta = json.load(f)
        self.load_params(load_task_checkpoint(os.path.join(resume_dir, "model.safetensors")))
        broadcast_model_(self.model)
        opt_state = load_opt_state(state.opt_state, os.path.join(resume_dir, "opt_state.safetensors"),
                                   meta["opt_counters"], self.tp)
        best_trainable = None
        best_path = os.path.join(resume_dir, "best.safetensors")
        if os.path.exists(best_path):
            names = trainable_parameters(self.model)
            best_trainable = {k: v for k, v in load_task_checkpoint(best_path).items() if k in names}
        return TrainState(meta["global_step"], self.model, opt_state), meta, best_trainable

    # -- fit -----------------------------------------------------------------------------
    def _check_model_peers_batch(self, batch) -> None:
        """Model peers split the weights of one computation: they must hold
        the same rows (a task's first batch is compared)."""
        ids = batch["input_ids"]
        ids = ids.cpu().numpy() if isinstance(ids, torch.Tensor) else np.asarray(ids)
        if not same_on_every_rank(hashlib.sha1(ids.tobytes()).hexdigest(), self.tp):
            raise RuntimeError("tensor parallel: the ranks of a model group drew different batches")

    def fit(self, state: TrainState, strategy, train_dataset, val_loader, task_id: int, epochs: int,
            resume_dir: Optional[str] = None, resume: bool = False) -> Tuple[TrainState, Dict[str, torch.Tensor], Dict]:
        """Train one task with early stopping: (state, a CPU copy of the best
        trainable parameters, the fit log). With `resume_dir`, bundles are
        saved there; with `resume` too, a bundle of this task is loaded first."""
        loader = self.make_train_loader(train_dataset, shuffle=True, seed=self.config.seed + task_id)
        counts_before = Counter(self.step_counts)
        self._bundle_frozen = self._bundle_best_key = None
        best_acc = -float("inf")
        best_trainable = None
        wait = 0
        global_step = 0
        history = []
        start_epoch = start_batch = 0
        carry = None
        fit_state = os.path.join(resume_dir, "fit_state.json") if resume_dir else None
        if resume and fit_state and os.path.exists(fit_state):
            with open(fit_state) as f:  # a bundle belongs to one task: peek before loading
                peek = json.load(f)
            if peek.get("task_id") == task_id:
                state, meta, best_trainable = self._load_resume_bundle(resume_dir, state)
                if meta.get("batches_done", 0) > 0:  # a preemption bundle: resume inside its epoch
                    start_epoch, start_batch = meta["epoch"], int(meta["batches_done"])
                else:
                    start_epoch = meta["epoch"] + 1
                best_acc, wait, global_step = meta["best_acc"], meta["wait"], meta["global_step"]
                history = meta.get("history", [])
                if self.metrics is not None and "metrics_offset" in meta:
                    self.metrics.set_global_step_offset(int(meta["metrics_offset"]))
                strategy.fast_forward_memory(self, int(meta.get("mem_draws", 0)))
                carry = meta.get("window_carry")
                LOGGER.info("resuming task %d at epoch %d batch %d", task_id, start_epoch, start_batch)
                if start_batch == 0 and wait >= self.config.patience:
                    # the epoch-end bundle is saved before the early-stop check:
                    # the run it came from trained no further epoch, nor does this one
                    LOGGER.info("resume: patience already exhausted (wait=%d >= %d); skipping training",
                                wait, self.config.patience)
                    start_epoch, carry = epochs, None

        # a partial window carries into the next epoch, as gradient
        # accumulation (and MultiSteps) does
        window_buf, window_meta = [], []  # (batch_idx, batch) and (epoch, batch_idx) per microbatch
        for ep, group in itertools.groupby(carry or [], key=lambda p: p[0]):
            # an epoch-end bundle's carried microbatches, replayed from their epoch's seeded order
            idxs = [int(p[1]) for p in group]
            loader.set_epoch(int(ep), start_batch=idxs[0])
            refill = self.fit_batches(loader)
            for i, b in zip(idxs, itertools.islice(refill, len(idxs))):
                window_buf.append((i, b))
                window_meta.append((int(ep), i))
            refill.close()
        for epoch in range(start_epoch, epochs):
            epoch_start = time.time()
            n_seen = 0
            skip = start_batch if epoch == start_epoch else 0
            loader.set_epoch(epoch, start_batch=skip)
            last_logged = global_step
            trace = None
            for batch_idx, batch in enumerate(self.fit_batches(loader), start=skip):
                if self.tp is not None and epoch == start_epoch and batch_idx == skip:
                    self._check_model_peers_batch(batch)
                if self.config.profile_dir and task_id == 0 and epoch == 0 and batch_idx == PROFILE_BATCHES[0]:
                    trace = Trace(self.config.profile_dir).start()
                if self.window > 1:
                    window_buf.append((batch_idx, batch))
                    window_meta.append((epoch, batch_idx))
                    if len(window_buf) < self.window:
                        continue
                    state, m = strategy.window_step(self, state, window_buf)
                    window_buf, window_meta = [], []
                    n_seen += self.config.batch_size * self.window
                    global_step += self.window
                elif strategy.is_replay_batch(batch_idx):
                    state, m = strategy.replay_step(self, state)
                    n_seen += self.config.batch_size
                    global_step += 1
                else:
                    state, m = strategy.train_step(self, state, batch)
                    n_seen += self.config.batch_size
                    global_step += 1
                # an update boundary (no window is part-filled here): on a
                # preemption request any rank saw, a mid-epoch bundle and exit 143
                preempt.tick_update()
                if resume_dir and preempt.sync_preemption_requested(global_step):
                    self._save_resume_bundle(resume_dir, state, {
                        "task_id": task_id, "epoch": epoch, "batches_done": batch_idx + 1, "best_acc": best_acc,
                        "wait": wait, "global_step": global_step, "history": history,
                        "mem_draws": strategy.mem_draws,
                        "metrics_offset": self.metrics.global_step_offset if self.metrics else 0,
                    }, best_trainable)
                    LOGGER.warning("preempted: resume bundle saved at task %d epoch %d batch %d; exiting 143",
                                   task_id, epoch, batch_idx + 1)
                    raise preempt.Preempted(f"preempted at task {task_id} epoch {epoch}")
                # in window mode this runs after a full window only (the continue above skips it)
                if trace is not None and batch_idx >= PROFILE_BATCHES[1]:
                    trace.stop()
                    trace = None
                if self.metrics is not None and global_step - last_logged >= self.config.log_every:
                    last_logged = global_step
                    payload = {
                        f"task_{task_id}/train_loss": float(m["loss"]),
                        f"task_{task_id}/grad_norm": float(m["grad_norm"]),
                    }
                    dl = m.get("distill_layer_losses")
                    if dl is not None:
                        for layer, v in zip(self._distill_layer_ids, dl.tolist()):
                            payload[f"task_{task_id}/distill_loss_{layer}"] = float(v)
                    self.metrics.log_metrics(payload, step=global_step)
            if trace is not None:  # the epoch ended inside the trace's batches
                trace.stop()
            # the steps run asynchronously: without this the epoch time would
            # measure their dispatch, and validation would absorb their work
            self.synchronize()
            ex_per_s = n_seen / max(time.time() - epoch_start, 1e-9)

            val_log, _ = self.validate(val_loader)
            acc = float(val_log["valid/acc"])
            history.append({"epoch": epoch, "acc": acc, "train_ex_per_s": ex_per_s})
            LOGGER.info("task %d epoch %d: acc=%.4f train_ex/s=%.1f", task_id, epoch, acc, ex_per_s)
            if self.metrics is not None:
                self.metrics.log_metrics(
                    {f"task_{task_id}/valid_acc": acc, f"task_{task_id}/train_ex_per_s": ex_per_s}, step=global_step
                )
            # EarlyStopping + ModelCheckpoint(top-1)
            if acc > best_acc + PATIENCE_THRESHOLD:
                wait = 0
            elif math.isfinite(best_acc):
                wait += 1
            if acc > best_acc:
                best_acc = acc
                best_trainable = self.host_trainable()
            every = max(0, self.config.resume_bundle_every)
            if resume_dir and every > 0 and ((epoch + 1) % every == 0 or epoch == epochs - 1):
                self._save_resume_bundle(resume_dir, state, {
                    "task_id": task_id, "epoch": epoch, "best_acc": best_acc, "wait": wait,
                    "global_step": global_step, "history": history, "mem_draws": strategy.mem_draws,
                    "metrics_offset": self.metrics.global_step_offset if self.metrics else 0,
                    # a partial window carried into the next epoch, as (epoch, batch_idx) pairs
                    "window_carry": [[e, i] for e, i in window_meta] or None,
                }, best_trainable)
            if wait >= self.config.patience:
                LOGGER.info("early stopping at epoch %d (patience %d)", epoch, self.config.patience)
                break

        if window_buf:
            LOGGER.info(
                "fit end: %d trailing microbatches did not fill an accumulation window (window=%d) "
                "and were not applied", len(window_buf), self.window,
            )
        if best_trainable is None:
            best_trainable = self.host_trainable()
        fit_log = {"best_acc": best_acc, "epochs_run": len(history), "history": history, "global_step": global_step,
                   "steps": dict(self.step_counts - counts_before)}
        return state, best_trainable, fit_log
