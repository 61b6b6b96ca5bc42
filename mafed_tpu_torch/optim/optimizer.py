"""Optimizer with the reference's parameter groups (counterpart of
mafed_tpu/optim/optimizer.py, which chains optax transforms).

One update applies, in order:
  * global-norm clipping (grad_norm, 2.0 by default), keeping the pre-clip
    norm in the state (`clip_by_global_norm_recorded`);
  * weight decay added to the gradient (L2) for Adam and Adamax, masked by
    the no-decay markers;
  * the moments: Adam's (bias-corrected; eps 1e-6 for AdamW, 1e-8 for Adam,
    an optional bfloat16 first moment, `adam_mu_dtype`) or Adamax's
    (optax.scale_by_adamax: nu = max(b2 * nu, |g| + 1e-8), the first moment
    bias-corrected, no mu_dtype);
  * for AdamW, decoupled weight decay: theta -= lr_group * (adam_dir + wd * theta);
  * the learning rate, from the triangular `ScheduleState` (or a schedule
    callable), times `lr_mul` for "vqa_output" parameters.

`MultiSteps` wraps an `Optimizer` as optax.MultiSteps does: gradients
accumulate for k mini-steps and the k-th applies one update.

Plain tensor code; parameters and moments are updated in place. Under
tensor parallelism every rank updates its shards (the update is
element-wise), and the global norm sums the squares of the split tensors
over the model group the optimizer was built with (`build_optimizer(...,
tp=model.tp)`), counting the replicated ones once.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from mafed_tpu_torch.core.config import TrainConfig
from mafed_tpu_torch.core.dist import Group, all_reduce_sum_
from mafed_tpu_torch.core.mesh import param_partition_spec

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class ClipState(NamedTuple):
    grad_norm: torch.Tensor  # the last pre-clip global gradient norm


class AdamState(NamedTuple):
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


class ScheduleState(NamedTuple):
    """LR-schedule state carried inside the optimizer state, so every task
    can set its own horizon (`set_schedule`)."""

    count: int
    warmup_steps: int
    total_steps: int


class OptState(NamedTuple):
    clip: Optional[ClipState]
    adam: AdamState
    schedule: object  # ScheduleState, or the step count of a schedule callable


def global_norm(tensors: Dict[str, torch.Tensor], tp: Optional[Group] = None) -> torch.Tensor:
    """The L2 norm of name-keyed `tensors` together. Under tensor
    parallelism (`tp`, the model group that splits them), the squares of
    the split tensors are summed over the group and the replicated ones,
    equal on every rank, counted once."""
    if tp is None or tp.size == 1:
        return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tensors.values()))
    device = next(iter(tensors.values())).device
    sharded, replicated = torch.zeros((), device=device), torch.zeros((), device=device)
    for k, t in tensors.items():
        if param_partition_spec(k) is None:
            replicated = replicated + torch.sum(t.float() ** 2)
        else:
            sharded = sharded + torch.sum(t.float() ** 2)
    all_reduce_sum_([sharded], tp)
    return torch.sqrt(sharded + replicated)


def clip_by_global_norm_recorded(
    grads: Dict[str, torch.Tensor], max_norm: float, tp: Optional[Group] = None
) -> Tuple[Dict[str, torch.Tensor], ClipState]:
    """optax.clip_by_global_norm semantics, with the pre-clip norm kept."""
    gnorm = global_norm(grads, tp)
    scale = torch.where(gnorm > max_norm, max_norm / gnorm, torch.ones_like(gnorm))
    return {k: g * scale.to(g.dtype) for k, g in grads.items()}, ClipState(gnorm)


def last_grad_norm(opt_state) -> torch.Tensor:
    """The pre-clip global norm of the last update; under `MultiSteps`, that
    of the last accumulation boundary."""
    if isinstance(opt_state, MultiStepsState):
        opt_state = opt_state.inner
    if opt_state.clip is None:
        raise ValueError("optimizer state holds no ClipState (grad clipping disabled?)")
    return opt_state.clip.grad_norm


def triangular_factor(state: ScheduleState) -> torch.Tensor:
    """Linear warmup then linear decay to 0, as a float32 scalar."""
    f32 = torch.float32
    if state.count < state.warmup_steps:
        return torch.tensor(state.count, dtype=f32) / max(float(state.warmup_steps), 1.0)
    remaining = torch.tensor(state.total_steps - state.count, dtype=f32)
    return torch.clamp(remaining / max(float(state.total_steps - state.warmup_steps), 1.0), min=0.0)


def set_schedule(opt_state, warmup_steps: int, total_steps: int, reset_count: bool = True):
    """Replace the schedule horizon inside an optimizer state (or the inner
    state of a `MultiSteps` one)."""
    if isinstance(opt_state, MultiStepsState):
        return opt_state._replace(inner=set_schedule(opt_state.inner, warmup_steps, total_steps, reset_count))
    sched = opt_state.schedule
    if not isinstance(sched, ScheduleState):
        raise ValueError("this optimizer runs a schedule callable, not a ScheduleState")
    count = 0 if reset_count else sched.count
    return opt_state._replace(schedule=ScheduleState(count, int(warmup_steps), int(total_steps)))


def param_group_masks(names) -> Tuple[Dict[str, bool], Dict[str, bool]]:
    """(lr_mul_mask, weight_decay_mask) by parameter name: lr_mul applies to
    names containing "vqa_output"; biases and LayerNorm parameters do not decay."""
    no_decay_markers = ("layernorm", "layer_norm", "norm", "bias", "distill_loss")
    top = {n: "vqa_output" in n for n in names}
    decay = {n: not any(m in n.lower() for m in no_decay_markers) for n in names}
    return top, decay


class Optimizer:
    def __init__(self, config: TrainConfig, names, schedule: Optional[Callable] = None, tp: Optional[Group] = None):
        if config.optim == "adamw":
            self.eps, self.decoupled_wd = 1e-6, True
        elif config.optim in ("adam", "adamax"):
            self.eps, self.decoupled_wd = 1e-8, False
        else:
            raise ValueError(f"invalid optimizer {config.optim}")
        self.adamax = config.optim == "adamax"
        self.b1, self.b2 = (float(b) for b in config.betas)
        self.lr_mul = config.lr_mul
        self.wd = config.weight_decay
        self.max_norm = config.grad_norm if config.grad_norm and config.grad_norm > 0 else None
        # optax.scale_by_adamax has no mu_dtype
        self.mu_dtype = _DTYPES[config.adam_mu_dtype] if config.adam_mu_dtype and not self.adamax else None
        self.lr0 = config.learning_rate
        self.schedule = schedule
        self.top, self.decay = param_group_masks(list(names))
        self.tp = tp

    def init(self, params: Dict[str, torch.Tensor]) -> OptState:
        mu = {k: torch.zeros_like(p, dtype=self.mu_dtype or p.dtype) for k, p in params.items()}
        nu = {k: torch.zeros_like(p) for k, p in params.items()}
        sched = 0 if self.schedule is not None else ScheduleState(0, 1, 1)
        clip = ClipState(torch.zeros((), dtype=torch.float32)) if self.max_norm is not None else None
        return OptState(clip, AdamState(0, mu, nu), sched)

    def _lr(self, sched) -> Tuple[torch.Tensor, object]:
        if self.schedule is not None:
            return self.schedule(sched), sched + 1
        lr = self.lr0 * triangular_factor(sched)
        return lr, ScheduleState(sched.count + 1, sched.warmup_steps, sched.total_steps)

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], state: OptState) -> OptState:
        """Apply one update to `params` in place; returns the new state."""
        clip = state.clip
        if self.max_norm is not None:
            grads, clip = clip_by_global_norm_recorded(grads, self.max_norm, self.tp)
        if self.wd > 0 and not self.decoupled_wd:
            grads = {k: g + self.wd * params[k] if self.decay[k] else g for k, g in grads.items()}
        count = state.adam.count + 1
        f32 = torch.float32
        bc1 = 1 - torch.tensor(self.b1, dtype=f32) ** count
        bc2 = 1 - torch.tensor(self.b2, dtype=f32) ** count
        lr, sched = self._lr(state.schedule)
        # the decay is rounded to the first moment's dtype before the product,
        # as JAX does with a Python scalar times a bfloat16 array
        b1 = {dt: torch.tensor(self.b1, dtype=dt) for dt in {m.dtype for m in state.adam.mu.values()}}
        for k, p in params.items():
            g = grads[k]
            mu_prev = state.adam.mu[k]
            mu = (1 - self.b1) * g + b1[mu_prev.dtype] * mu_prev
            if self.adamax:  # infinity-norm second moment, no bias correction
                nu = torch.maximum(torch.abs(g) + self.eps, self.b2 * state.adam.nu[k])
                u = (mu / bc1) / nu
            else:
                nu = (1 - self.b2) * (g * g) + self.b2 * state.adam.nu[k]
                u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if self.wd > 0 and self.decoupled_wd and self.decay[k]:
                u = u + self.wd * p
            p.add_((-(lr * (self.lr_mul if self.top[k] else 1.0)) * u).to(p.dtype))
            state.adam.mu[k].copy_(mu)
            state.adam.nu[k].copy_(nu)
        return OptState(clip, AdamState(count, state.adam.mu, state.adam.nu), sched)


class MultiStepsState(NamedTuple):
    mini_step: int  # gradients accumulated since the last update
    gradient_step: int  # updates applied
    inner: OptState
    acc_grads: Dict[str, torch.Tensor]  # running mean of this window's gradients


class MultiSteps:
    """Gradient accumulation over `every_k` mini-steps (optax.MultiSteps with
    use_grad_mean): each call folds its gradients into a running mean,
    acc + (g - acc) / (n + 1); the k-th applies the inner update to that mean
    and keeps the inner state (clip norm, moments, schedule count). On the
    other calls the parameters do not move and the inner state stays as it
    was, so `last_grad_norm` reads the previous boundary's norm."""

    def __init__(self, inner: Optimizer, every_k: int):
        if every_k < 1:
            raise ValueError(f"every_k must be >= 1, got {every_k}")
        self.inner = inner
        self.every_k = int(every_k)

    def init(self, params: Dict[str, torch.Tensor]) -> MultiStepsState:
        acc = {k: torch.zeros_like(p) for k, p in params.items()}
        return MultiStepsState(0, 0, self.inner.init(params), acc)

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], state: MultiStepsState) -> MultiStepsState:
        n = state.mini_step
        for k, acc in state.acc_grads.items():
            acc.add_((grads[k] - acc) / (n + 1))
        if n + 1 < self.every_k:
            return state._replace(mini_step=n + 1)
        inner = self.inner.update(params, state.acc_grads, state.inner)
        for acc in state.acc_grads.values():
            acc.zero_()
        return MultiStepsState(0, state.gradient_step + 1, inner, state.acc_grads)


def build_optimizer(config: TrainConfig, params: Dict[str, torch.Tensor], schedule: Optional[Callable] = None,
                    tp: Optional[Group] = None) -> Optimizer:
    """The optimizer for `params` (a name -> tensor dict). `schedule`, a
    step -> lr callable such as `sched.linear_warmup_schedule`, replaces the
    triangular schedule that otherwise runs off the ScheduleState in the
    optimizer state (see set_schedule); that one starts at count 0, warmup 1,
    so the first update has learning rate 0 until a horizon is set. `tp` is
    the model group of a tensor-parallel model (its `tp`), None otherwise."""
    return Optimizer(config, params.keys(), schedule, tp)
