"""Training steps (counterpart of mafed_tpu/training/step.py).

Every step takes one loss through ONE optimizer update (or, under
`optim.MultiSteps`, one accumulation mini-step):

  * `make_train_step`: one CE microbatch (naive / ER / EWC), the EWC penalty
    optionally added; the per-microbatch cadence runs it under `MultiSteps`;
  * `make_ce_window_step`: a whole accumulation window of CE microbatches
    merged into one pass;
  * `make_distill_step`: one memory microbatch of the fused student+teacher
    MAFED loss;
  * `make_mafed_window_step`: n_ce CE microbatches + 1 memory microbatch,
    fused into one combined loss, or one backward per microbatch
    (`fuse_ce_batch=False`);
  * `make_ewc_fisher_fn` and `make_adaptive_weights_fn` compute, without an
    update, the EWC importances and the adaptive modality weights' gradient
    norms.

Batches carry cached "patches" or uint8 "pixels"; pixels go through the
frozen tower with no graph, once per window where the window is fused. Every
attention call goes through the CUDA flash kernels on the card.

Data parallelism (core/dist.py): each rank runs the step on its slice of
the global batch. After the last backward of the step, before the clip,
one coalesced all-reduce averages the gradients and the loss metrics over
the ranks (`_update`), so every rank applies the update of the whole
batch; the per-sample means of the CE losses make the average of the
ranks' losses the loss of the union. The distill loss averages over
tokens, so its token counts are summed over the ranks first. The Fisher
sums the ranks' gradients before squaring them.

Tensor parallelism (core/mesh.py): the ranks of a model group hold the
same rows and their shards of the weights; the averages and sums above run
over the data group only (averaging over every rank would mix shards), and
the EWC penalty's value sums the split tensors' terms over the model group.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mafed_tpu_torch.constants import NUM_VISION_TOKENS
from mafed_tpu_torch.core.config import ModelConfig, TrainConfig
from mafed_tpu_torch.core.device import resolve_device
from mafed_tpu_torch.core.dist import Group, all_reduce_mean_, all_reduce_sum_, data_group
from mafed_tpu_torch.core.mesh import param_partition_spec
from mafed_tpu_torch.data.images import make_normalizer, prep_pixels
from mafed_tpu_torch.models import vl_pythia
from mafed_tpu_torch.models.gpt_neox import RematPolicy
from mafed_tpu_torch.optim.optimizer import global_norm, last_grad_norm
from mafed_tpu_torch.training.train_state import TrainState, trainable_parameters

# what each of the JAX package's named policies keeps (gpt_neox.RematPolicy):
# the tagged products of gpt_neox.dense, and the flash forward's (o, lse)
_NAMED_REMAT_POLICIES = {
    "attn": ("attn_out", "flash"),
    "attn_qkv": ("attn_out", "qkv", "flash"),
    "attn_mlp": ("attn_out", "mlp_up", "flash"),
    "attn_qkv_mlp": ("attn_out", "qkv", "mlp_up", "flash"),
    # every matmul product without batch dimensions: the layer's four projections
    "dots": ("qkv", "attn_out", "mlp_up", "mlp_down"),
}


def compute_dtype(train_cfg: TrainConfig) -> torch.dtype:
    return torch.bfloat16 if train_cfg.compute_dtype == "bfloat16" else torch.float32


def resolve_remat_policy(name: str) -> Optional[RematPolicy]:
    """Map TrainConfig.remat_policy to what per-layer remat keeps.

    '' / 'full': None, plain per-layer remat (keep only the layer inputs;
    recompute everything in backward). The named policies keep chosen layer
    tensors too (gpt_neox.RematPolicy), trading device memory for recompute:
      'attn'         - the attention output projection, and the flash
                       forward's (o, lse): backward reruns no flash forward
      'attn_qkv'     - + the QKV projection
      'attn_mlp'     - + the MLP up-projection
      'attn_qkv_mlp' - all three
      'dots'         - every matmul product without batch dimensions
    Whatever a policy keeps, the numbers are those of full recompute.
    """
    if not name or name == "full":
        return None
    if name in _NAMED_REMAT_POLICIES:
        return RematPolicy(keep=frozenset(_NAMED_REMAT_POLICIES[name]))
    raise ValueError(f"unknown remat_policy '{name}'")


def _check_device(device: torch.device, *batches: Dict[str, torch.Tensor]) -> None:
    if any(b["input_ids"].device != device for b in batches):
        raise ValueError(f"batches must be on {device}")


def _vision_features(model, batch, normalize, dtype) -> torch.Tensor:
    """The batch's vision features in the compute dtype: its cached "patches",
    or the frozen tower's output on its "pixels" (no graph)."""
    if "patches" in batch:
        return batch["patches"].to(dtype)
    with torch.no_grad():
        return vl_pythia.get_patch_embeddings(model, prep_pixels(batch, normalize, dtype), dtype=dtype)


def _ce_loss(model, batch, patches, dtype, label_tail, *, remat: bool, policy: Optional[RematPolicy] = None) -> torch.Tensor:
    """Length-normalised CE of one (merged) batch over its vision features;
    remat recomputes each decoder layer in backward, keeping what `policy` names."""
    return vl_pythia.forward(
        model, batch["input_ids"], batch["attention_mask"], batch["labels"],
        patch_embeddings=patches, dtype=dtype, loss_only=True,
        remat_layers=remat, remat_policy=policy, label_tail=label_tail,
    ).loss


def ewc_penalty(params: Dict[str, torch.Tensor], ewc_state, reg_lambda: float, tp: Optional[Group] = None) -> torch.Tensor:
    """0.5 * lambda * sum(F * (theta - theta*)^2) over name-keyed dicts;
    ewc_state = (fisher, theta*), either stored in bfloat16 or float32, and
    both upcast to float32 with theta before the difference. Under tensor
    parallelism (`tp`, the model group that splits `params`) the split
    tensors' terms are summed over the group (the replicated ones counted
    once); the gradient stays this rank's."""
    fisher, old = ewc_state
    terms = {k: torch.sum(fisher[k].float() * torch.square(p.float() - old[k].float())) for k, p in params.items()}
    if tp is None or tp.size == 1:
        return 0.5 * reg_lambda * sum(terms.values())
    sharded = sum(t for k, t in terms.items() if param_partition_spec(k) is not None)
    replicated = sum(t for k, t in terms.items() if param_partition_spec(k) is None)
    total = sharded.detach().clone()
    all_reduce_sum_([total], tp)  # the group's terms; the gradient flows through this rank's alone
    return 0.5 * reg_lambda * (sharded + (total - sharded.detach()) + replicated)


def _merge_window(x: torch.Tensor) -> torch.Tensor:
    """Merge a [n_mb, B, ...] microbatch stack to [n_mb*B, ...] batch-major,
    as the JAX package does (row order differs from a plain reshape, which
    no per-sample mean sees)."""
    return x.transpose(0, 1).reshape((-1,) + tuple(x.shape[2:]))


def _cleared(model) -> Dict[str, torch.nn.Parameter]:
    """The trainable parameters, with no gradient left on them."""
    params = trainable_parameters(model)
    for p in params.values():
        p.grad = None
    return params


def _update(state: TrainState, optimizer, params, metrics: Dict[str, torch.Tensor]) -> Tuple[TrainState, Dict]:
    """Apply the optimizer to the gradients the backward left on `params`
    (zeros where none reached), clear them; (new state, `metrics` detached
    and the grad norm). Over several ranks of a data group the gradients and
    `metrics` are first averaged in one coalesced all-reduce."""
    grads = {k: p.grad if p.grad is not None else torch.zeros_like(p) for k, p in params.items()}
    metrics = {k: v.detach() for k, v in metrics.items()}
    group = data_group()
    if group.size > 1:  # averaged in place, so copies
        metrics = {k: v.float().clone() for k, v in metrics.items()}
        all_reduce_mean_(list(grads.values()) + list(metrics.values()), group)
    opt_state = optimizer.update(params, grads, state.opt_state)
    for p in params.values():
        p.grad = None
    try:  # the pre-clip norm the clip recorded (the last boundary's under MultiSteps)
        gnorm = last_grad_norm(opt_state)
    except ValueError:
        gnorm = global_norm(grads, state.model.tp)
    return TrainState(state.step + 1, state.model, opt_state), {**metrics, "grad_norm": gnorm}


# ---------------------------------------------------------------------------
# CE steps (naive / EWC / ER)
# ---------------------------------------------------------------------------

def make_train_step(
    model_cfg: ModelConfig,
    train_cfg: TrainConfig,
    optimizer,
    *,
    with_ewc: bool = False,
    device="cuda",
) -> Callable:
    """Standard CE step on ONE microbatch (naive / ER current-task and memory
    batches / EWC): step(state, batch, ewc_state=None) -> (state, {"loss",
    "grad_norm"}). Accumulation lives outside, in `MultiSteps`, which
    reproduces the reference's per-microbatch replay cadence. Layers are
    recomputed in backward only with `train_cfg.remat`; otherwise each flash
    call's saved (o, lse) go straight to the backward kernels."""
    device = resolve_device(device)
    dtype = compute_dtype(train_cfg)
    tail = train_cfg.label_tail or None
    policy = resolve_remat_policy(train_cfg.remat_policy)
    normalize = make_normalizer(model_cfg.vision)

    def step(state: TrainState, batch: Dict[str, torch.Tensor], ewc_state=None):
        _check_device(device, batch)
        model = state.model
        params = _cleared(model)
        loss = _ce_loss(model, batch, _vision_features(model, batch, normalize, dtype), dtype, tail,
                        remat=train_cfg.remat, policy=policy)
        if with_ewc and ewc_state is not None:
            loss = loss + ewc_penalty(params, ewc_state, train_cfg.reg_lambda, model.tp)
        loss.backward()
        return _update(state, optimizer, params, {"loss": loss})

    return step


def make_ce_window_step(
    model_cfg: ModelConfig,
    train_cfg: TrainConfig,
    optimizer,
    *,
    with_ewc: bool = False,
    device="cuda",
) -> Callable:
    """A FULL accumulation window of CE microbatches (naive / EWC / ER
    windows): step(state, batches, ewc_state=None) with [n_mb, B, ...]
    stacks. The microbatches merge batch-major into ONE pass over n_mb*B rows
    with per-layer remat (per-sample losses are length-normalised and the
    microbatches share a size, so this is the mean of the per-microbatch
    means); the EWC penalty is added once, which equals adding it to every
    microbatch and averaging. One backward, one update."""
    device = resolve_device(device)
    dtype = compute_dtype(train_cfg)
    tail = train_cfg.label_tail or None
    policy = resolve_remat_policy(train_cfg.remat_policy)
    normalize = make_normalizer(model_cfg.vision)

    def step(state: TrainState, batches: Dict[str, torch.Tensor], ewc_state=None):
        _check_device(device, batches)
        model = state.model
        params = _cleared(model)
        merged = {k: _merge_window(v) for k, v in batches.items()}
        loss = _ce_loss(model, merged, _vision_features(model, merged, normalize, dtype), dtype, tail, remat=True,
                        policy=policy)
        if with_ewc and ewc_state is not None:
            loss = loss + ewc_penalty(params, ewc_state, train_cfg.reg_lambda, model.tp)
        loss.backward()
        return _update(state, optimizer, params, {"loss": loss})

    return step


# ---------------------------------------------------------------------------
# Feature distillation (MAFED)
# ---------------------------------------------------------------------------

def distillation_layers(strategy: str, num_hidden_layers: int, distillation_layer: Optional[int]) -> List[int]:
    """Which hidden_states indices to distill: a valid `distillation_layer`
    forces 'single'; otherwise every tap below the decoder's last layer."""
    if strategy == "cumulative":
        if distillation_layer is None:
            raise ValueError("cumulative layer weighting needs distillation_layer")
        return list(range(distillation_layer))
    if distillation_layer is not None and 0 <= distillation_layer < num_hidden_layers:
        return [distillation_layer]
    if strategy == "single":
        raise ValueError("'single' layer weighting needs a valid distillation_layer")
    return list(range(num_hidden_layers))


def layer_coefficients(strategy: str, gamma: float, num_layers: int) -> np.ndarray:
    """Per-layer loss weights."""
    if strategy == "single":
        return np.ones((1,), np.float32)
    if strategy == "equal":
        return np.full((num_layers,), 1.0 / num_layers, np.float32)
    # discounted / cumulative: gamma^distance, nearest-to-top weighted highest
    distances = np.arange(num_layers, 0, -1, dtype=np.float32)
    coeffs = gamma ** distances
    return (coeffs / coeffs.sum()).astype(np.float32)


def modality_masks(attention_mask: torch.Tensor, num_vision_tokens: int = NUM_VISION_TOKENS) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lang_mask, image_mask) over [vision ++ text]."""
    bsz = attention_mask.shape[0]
    zeros = attention_mask.new_zeros((bsz, num_vision_tokens))
    ones = attention_mask.new_ones((bsz, num_vision_tokens))
    lang = torch.cat([zeros, attention_mask], dim=1)
    image = torch.cat([ones, torch.zeros_like(attention_mask)], dim=1)
    return lang, image


def _masked_token_loss(h, h_past, mask, kind: str, count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked per-token distance averaged over unmasked tokens. h, h_past:
    [..., T, D]; mask: [..., T]. MSE: ||h-h'||^2/D per token; cosine: 1 - cos.
    `count` divides the masked sum in place of the mask's own count."""
    h32, p32 = h.float(), h_past.float()
    if kind == "mse":
        tok = torch.mean(torch.square(h32 - p32), dim=-1)
    elif kind == "cosine":
        hn = h32 / torch.clamp(torch.linalg.norm(h32, dim=-1, keepdim=True), min=1e-8)
        pn = p32 / torch.clamp(torch.linalg.norm(p32, dim=-1, keepdim=True), min=1e-8)
        tok = 1.0 - torch.sum(hn * pn, dim=-1)
    else:
        raise ValueError(kind)
    m = mask.float()
    denom = torch.clamp(torch.sum(m, dim=(-2, -1)), min=1.0) if count is None else count
    return torch.sum(tok * m, dim=(-2, -1)) / denom


def make_distill_loss_fn(model_cfg: ModelConfig, train_cfg: TrainConfig, *, remat_student: bool = False) -> Callable:
    """Build the fused student+teacher MAFED replay loss.

    Returns loss_fn(model, teacher, batch, lang_coeffs, patches) ->
    (loss, per_layer): patches are the batch's vision features in the
    compute dtype; a batch with cached teacher states ("t_hs") skips the
    teacher forward; lang_coeffs holds the language-modality weight per
    distilled layer (ignored by the 'equal' strategy, which weights by token
    counts); per_layer is the modality-weighted distill loss per tap before
    the layer coefficients. remat_student recomputes each of the student's
    decoder layers in backward.
    """
    dtype = compute_dtype(train_cfg)
    policy = resolve_remat_policy(train_cfg.remat_policy)
    num_hl = model_cfg.num_hidden_layers - 1
    layers = tuple(distillation_layers(
        train_cfg.distillation_layer_weighing_strategy, num_hl, train_cfg.distillation_layer,
    ))
    layer_coeffs = torch.from_numpy(layer_coefficients(
        "single" if len(layers) == 1 and train_cfg.distillation_layer is not None
        else train_cfg.distillation_layer_weighing_strategy,
        train_cfg.distillation_layer_discount,
        len(layers),
    ))
    if train_cfg.distillation_coeff != 0 and not layers:
        raise ValueError("distillation_coeff != 0 but the distillation layer list is empty")
    deepest_tap = max(layers) if layers else 0
    strategy = train_cfg.distillation_modality_weighing_strategy
    loss_kind = train_cfg.distillation_loss
    replay_coeff = train_cfg.replay_coeff
    distill_coeff = train_cfg.distillation_coeff
    cls_distill = train_cfg.cls_distillation
    n_vis = vl_pythia.n_vision_tokens(model_cfg)
    tail = train_cfg.label_tail or None

    def loss_fn(model, teacher, batch, lang_coeffs, patches):
        lang_mask, image_mask = modality_masks(batch["attention_mask"], n_vis)
        # without replay CE the student's logits and last blocks are never read
        student = vl_pythia.forward(
            model, batch["input_ids"], batch["attention_mask"],
            batch.get("labels") if replay_coeff > 0 else None,
            patch_embeddings=patches, output_hidden_states=True,
            dtype=dtype, loss_only=True, need_logits=replay_coeff > 0,
            num_layers=None if replay_coeff > 0 else deepest_tap,
            remat_layers=remat_student, remat_policy=policy, label_tail=tail,
        )
        if "t_hs" in batch:
            # the teacher-state cache (data/teacher_cache.py): the states of
            # the frozen teacher come with the batch, [B, L, T, H] -> [L, B, T, H],
            # and the teacher forward leaves the step
            t_hs = batch["t_hs"].transpose(0, 1).to(dtype)
        else:
            # the frozen teacher, early-exited after the deepest distilled tap
            with torch.no_grad():
                t_hs = vl_pythia.forward(
                    teacher, batch["input_ids"], batch["attention_mask"], None,
                    patch_embeddings=patches, output_hidden_states=True,
                    dtype=dtype, need_logits=False, num_layers=deepest_tap,
                ).hidden_states

        device = patches.device
        loss = torch.zeros((), dtype=torch.float32, device=device)
        per_layer = torch.zeros((len(layers),), dtype=torch.float32, device=device)
        if replay_coeff > 0 and student.loss is not None:
            loss = loss + replay_coeff * student.loss
        if distill_coeff != 0:
            coeffs = layer_coeffs.to(device)
            if layers == tuple(range(len(layers))):
                s_sel, t_sel = student.hidden_states[: len(layers)], t_hs[: len(layers)]
            else:
                s_sel = torch.stack([student.hidden_states[l] for l in layers])
                t_sel = torch.stack([t_hs[l] for l in layers])
            if cls_distill:
                # distill position 0 only
                s0, t0 = s_sel[..., 0, :].float(), t_sel[..., 0, :].float()
                if loss_kind == "cosine":
                    sn = s0 / torch.clamp(torch.linalg.norm(s0, dim=-1, keepdim=True), min=1e-8)
                    tn = t0 / torch.clamp(torch.linalg.norm(t0, dim=-1, keepdim=True), min=1e-8)
                    per_layer = torch.mean(1.0 - torch.sum(sn * tn, dim=-1), dim=-1)
                else:
                    per_layer = torch.mean(torch.mean(torch.square(s0 - t0), dim=-1), dim=-1)
            else:
                # token counts of the whole batch: over a data group, summed
                # and divided by its ranks, so the ranks' mean is the batch's loss
                counts = torch.stack([lang_mask.sum(), image_mask.sum()]).float()
                group = data_group()
                world = group.size
                all_reduce_sum_([counts], group)
                n_lang, n_img = counts[0], counts[1]
                lang_l = _masked_token_loss(s_sel, t_sel, lang_mask[None], loss_kind,
                                            torch.clamp(n_lang, min=1.0) / world)
                img_l = _masked_token_loss(s_sel, t_sel, image_mask[None], loss_kind,
                                           torch.clamp(n_img, min=1.0) / world)
                if strategy == "equal":
                    # token-count-proportional weights
                    lw = (n_lang / (n_lang + n_img)).expand(len(layers))
                    vw = (n_img / (n_lang + n_img)).expand(len(layers))
                else:  # balanced / adaptive: externally supplied coefficients
                    lw = lang_coeffs.float()
                    vw = 1.0 - lw
                per_layer = lw * lang_l + vw * img_l
            loss = loss + torch.sum(coeffs * distill_coeff * per_layer)
        return loss, per_layer

    return loss_fn


def make_distill_step(
    model_cfg: ModelConfig,
    train_cfg: TrainConfig,
    optimizer,
    *,
    device="cuda",
) -> Callable:
    """Fused student+teacher replay step on ONE memory microbatch:
    step(state, teacher, batch, lang_coeffs) -> (state, {"loss",
    "grad_norm", "distill_layer_losses"}). The student is not recomputed in
    backward; pixels go through the tower once, shared by both passes."""
    device = resolve_device(device)
    dtype = compute_dtype(train_cfg)
    loss_fn = make_distill_loss_fn(model_cfg, train_cfg, remat_student=False)
    normalize = make_normalizer(model_cfg.vision)

    def step(state: TrainState, teacher, batch: Dict[str, torch.Tensor], lang_coeffs: torch.Tensor):
        _check_device(device, batch)
        model = state.model
        params = _cleared(model)
        loss, per_layer = loss_fn(model, teacher, batch, lang_coeffs, _vision_features(model, batch, normalize, dtype))
        loss.backward()
        return _update(state, optimizer, params, {"loss": loss, "distill_layer_losses": per_layer})

    return step


def make_mafed_window_step(
    model_cfg: ModelConfig,
    train_cfg: TrainConfig,
    optimizer,
    *,
    n_ce: int,
    fuse_ce_batch: bool = True,
    device="cuda",
) -> Callable:
    """One call = a FULL accumulation window of the MAFED workload: n_ce
    current-task CE microbatches + 1 distill (memory) microbatch, the
    combined loss (n_ce * ce + distill) / (n_ce + 1), one optimizer update.

    step(state, teacher, ce_batches, distill_batch, lang_coeffs) -> (state, metrics)
    where ce_batches holds [n_ce, B, ...] stacks. Both differentiated passes
    recompute each decoder layer in backward, so only the layer inputs stay
    alive between forward and backward.

    fuse_ce_batch=True runs the n_ce CE microbatches as ONE pass over n_ce*B
    rows (mean of the per-microbatch means, since they share a size and
    per-sample losses are length-normalised) and takes ONE backward of the
    combined loss. False runs each microbatch alone and takes one backward
    per microbatch, its loss scaled by 1 / (n_ce + 1): the same gradient, with
    one microbatch's layer inputs alive at a time.

    Batches carry cached "patches" [.., B, 256, d_vis], or uint8 "pixels".
    With pixels and fuse_ce_batch, the frozen tower runs ONCE over the
    window's n_ce*B + B images (merged batch-major) with no graph, and its
    features are split between the CE and the distill pass; unfused, each
    microbatch runs the tower on its own images.
    """
    device = resolve_device(device)
    dtype = compute_dtype(train_cfg)
    distill_loss_fn = make_distill_loss_fn(model_cfg, train_cfg, remat_student=True)
    policy = resolve_remat_policy(train_cfg.remat_policy)
    denom = float(n_ce + 1)
    tail = train_cfg.label_tail or None
    normalize = make_normalizer(model_cfg.vision)
    vision_keys = ("patches", "pixels")

    def step(state: TrainState, teacher, ce_batches: Dict[str, torch.Tensor], distill_batch: Dict[str, torch.Tensor], lang_coeffs: torch.Tensor):
        _check_device(device, ce_batches, distill_batch)
        if ce_batches["input_ids"].shape[0] != n_ce:
            raise ValueError(f"expected {n_ce} CE microbatches, got {ce_batches['input_ids'].shape[0]}")
        model = state.model
        params = _cleared(model)
        if fuse_ce_batch:
            merged = {k: _merge_window(v) for k, v in ce_batches.items() if k not in vision_keys}
            if "patches" in ce_batches:
                ce_patches = _merge_window(ce_batches["patches"]).to(dtype)
                d_patches = distill_batch["patches"].to(dtype)
            else:  # share_vision: one tower pass over every image of the window
                n_merged = merged["input_ids"].shape[0]
                pixels = torch.cat([_merge_window(ce_batches["pixels"]), distill_batch["pixels"]])
                all_patches = _vision_features(model, {"pixels": pixels}, normalize, dtype)
                ce_patches, d_patches = all_patches[:n_merged], all_patches[n_merged:]
            ce_loss = _ce_loss(model, merged, ce_patches, dtype, tail, remat=True, policy=policy)
            d_loss, per_layer = distill_loss_fn(model, teacher, distill_batch, lang_coeffs, d_patches)
            # ONE loss, ONE backward into a single set of gradients
            total = (n_ce * ce_loss + d_loss) / denom
            total.backward()
        else:
            ce_sum = torch.zeros((), dtype=torch.float32, device=device)
            for i in range(n_ce):
                mb = {k: v[i] for k, v in ce_batches.items()}
                ce_i = _ce_loss(model, mb, _vision_features(model, mb, normalize, dtype), dtype, tail, remat=True,
                                policy=policy)
                (ce_i / denom).backward()
                ce_sum = ce_sum + ce_i.detach()
            ce_loss = ce_sum / n_ce
            d_loss, per_layer = distill_loss_fn(
                model, teacher, distill_batch, lang_coeffs, _vision_features(model, distill_batch, normalize, dtype))
            (d_loss / denom).backward()
            total = (n_ce * ce_loss + d_loss.detach()) / denom
        # per_layer: the modality-weighted per-tap distill losses
        return _update(state, optimizer, params, {"loss": total, "ce_loss": ce_loss, "distill_loss": d_loss,
                                                  "distill_layer_losses": per_layer})

    return step


# ---------------------------------------------------------------------------
# EWC Fisher estimation
# ---------------------------------------------------------------------------

def make_ewc_fisher_fn(model_cfg: ModelConfig, train_cfg: TrainConfig, device="cuda") -> Callable:
    """The squared-gradient accumulator: fisher_step(model, batch,
    importances) adds (d(batch_size * loss)/d theta)^2, in float32, to the
    name-keyed `importances` in place and returns them. No remat; the
    gradients come from torch.autograd.grad, so no .grad is left on the
    model and no optimizer state is touched. The caller divides by the
    number of samples. Over several ranks, the data group's gradients of
    their rows are summed before squaring, which gives the gradient of the
    whole batch (squares summed over the ranks would be another Fisher);
    under tensor parallelism each rank squares its shards."""
    device = resolve_device(device)
    dtype = compute_dtype(train_cfg)
    tail = train_cfg.label_tail or None
    normalize = make_normalizer(model_cfg.vision)

    def fisher_step(model, batch: Dict[str, torch.Tensor], importances: Dict[str, torch.Tensor]):
        _check_device(device, batch)
        params = trainable_parameters(model)
        bsz = batch["input_ids"].shape[0]
        loss = bsz * _ce_loss(model, batch, _vision_features(model, batch, normalize, dtype), dtype, tail, remat=False)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        all_reduce_sum_([g for g in grads if g is not None], data_group())
        with torch.no_grad():
            for name, g in zip(params, grads):
                if g is not None:
                    importances[name].add_(torch.square(g.float()))
        return importances

    return fisher_step


# ---------------------------------------------------------------------------
# Adaptive modality weights
# ---------------------------------------------------------------------------

def make_adaptive_weights_fn(
    model_cfg: ModelConfig,
    train_cfg: TrainConfig,
    layers: Sequence[int],
    device="cuda",
) -> Callable:
    """Per-batch modality importances from d(loss)/d(hidden_states[layer]):
    fn(model, batch) -> (lang_sums[Ld], image_sums[Ld], n_lang_tokens,
    n_image_tokens), the per-token L2 norms of those gradients summed over
    each modality's mask. The gradient is taken with respect to a zero
    perturbation in the compute dtype added to the input embeddings and to
    every layer's output but the last (no remat)."""
    device = resolve_device(device)
    dtype = compute_dtype(train_cfg)
    layers = list(layers)
    n_vis = vl_pythia.n_vision_tokens(model_cfg)
    normalize = make_normalizer(model_cfg.vision)

    def fn(model, batch: Dict[str, torch.Tensor]):
        _check_device(device, batch)
        patches = _vision_features(model, batch, normalize, dtype)
        b, t = batch["input_ids"].shape
        pert = torch.zeros((model_cfg.num_hidden_layers, b, n_vis + t, model_cfg.hidden_size),
                           dtype=dtype, device=device, requires_grad=True)
        loss = vl_pythia.forward(
            model, batch["input_ids"], batch["attention_mask"], batch["labels"],
            patch_embeddings=patches, hidden_perturbation=pert, dtype=dtype, loss_only=True,
        ).loss
        (grads,) = torch.autograd.grad(loss, pert)  # [L, B, T, H] = dL/d hs[0..L-1]
        with torch.no_grad():
            gnorm = torch.linalg.norm(grads[layers].float(), dim=-1)  # [Ld, B, T]
            lang_mask, image_mask = modality_masks(batch["attention_mask"], n_vis)
            lm, im = lang_mask.float()[None], image_mask.float()[None]
            return (torch.sum(gnorm * lm, dim=(1, 2)), torch.sum(gnorm * im, dim=(1, 2)),
                    torch.sum(lm[0]), torch.sum(im[0]))

    return fn
