"""VL-Pythia in PyTorch: frozen vision tower + MLP projector + GPT-NeoX
decoder (counterpart of mafed_tpu/models/vl_pythia.py).

  * vision features = the tower's output with CLS dropped ("patch" feature
    select) or kept ("cls_patch"), or cached features of the same shape:
    EVA-02's forward_features, or CLIP's hidden_states[select_layer]
    (`cfg.vision.backbone`);
  * they go through the 2-layer projector Linear-GELU-Linear
    (`vision_embed_tokens`);
  * inputs_embeds = [projected vision, embed_in(input_ids)], vision first;
    the attention mask gets leading ones for the vision tokens;
  * loss = length-normalised CE: logits sliced to the labels' length,
    shifted, per-sample mean over valid (non -100) positions, batch mean.

The tower is frozen in every reference config: `init_model` holds it in
bfloat16 (the JAX package's `vision_dtype`) with requires_grad off, and the
trainer keeps it out of the trainable set.

Under tensor parallelism (`models/tensor_parallel.shard_model_`) the
projector runs column -> row over the model group, the embeddings and
`embed_out` split the vocabulary, and the loss is the vocab-parallel CE;
`forward` then returns this rank's slice of the logits.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from mafed_tpu_torch.constants import IGNORE_INDEX
from mafed_tpu_torch.core.config import ModelConfig
from mafed_tpu_torch.core.device import resolve_device
from mafed_tpu_torch.core.dist import Group
from mafed_tpu_torch.models import clip_vit, eva02, gpt_neox
from mafed_tpu_torch.models.tensor_parallel import copy_to_model_group, vocab_parallel_cross_entropy

TOWERS = {"eva02": (eva02.EVA02, eva02.init_weights), "clip": (clip_vit.CLIPVisionModel, clip_vit.init_weights)}


class VLPythia(nn.Module):
    """Parameters under the reference's torch names: `gpt_neox.*`,
    `embed_out.weight`, `vision_embed_tokens.{0,2}.*`, `vision_encoder.*`
    (timm's names for EVA-02, HF's `vision_model.*` for CLIP)."""

    tp: Optional[Group] = None  # the model group under tensor parallelism

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.vision.backbone not in TOWERS:
            raise ValueError(f"vision backbone {cfg.vision.backbone!r}: expected one of {sorted(TOWERS)}")
        self.cfg = cfg
        h = cfg.hidden_size
        self.gpt_neox = gpt_neox.GPTNeoXModel(cfg, device=device)
        self.embed_out = nn.Linear(h, cfg.vocab_size, bias=False, device=device)
        self.vision_embed_tokens = nn.Sequential(
            nn.Linear(cfg.vision.embed_dim, h, device=device), nn.GELU(), nn.Linear(h, h, device=device)
        )
        self.vision_encoder = TOWERS[cfg.vision.backbone][0](cfg.vision, device=device)
        self.vision_encoder.requires_grad_(False)


@torch.no_grad()
def init_weights(model: VLPythia, generator: torch.Generator) -> None:
    """HF-style init of the decoder and projector: normal(0,
    initializer_range) weights, zero biases, unit layernorm scales; then the
    tower's own init, from the same generator."""
    std = model.cfg.initializer_range
    for name, module in model.named_modules():
        if name.startswith("vision_encoder"):
            continue
        if isinstance(module, (nn.Linear, nn.Embedding)):
            module.weight.normal_(0.0, std, generator=generator)
            if getattr(module, "bias", None) is not None:
                module.bias.zero_()
        elif isinstance(module, nn.LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
    TOWERS[model.cfg.vision.backbone][1](model.vision_encoder, generator)


def init_model(cfg: ModelConfig, seed: int = 0, *, device="cuda", dtype=torch.float32) -> VLPythia:
    """A randomly initialised VL-Pythia on `device` (CUDA unless the caller
    asks for the CPU): decoder and projector in `dtype`, the frozen tower in
    bfloat16."""
    device = resolve_device(device)
    model = VLPythia(cfg, device=device)
    init_weights(model, torch.Generator(device=device).manual_seed(seed))
    model.to(dtype)
    model.vision_encoder.to(torch.bfloat16)
    return model


def masked_mean(vector: torch.Tensor, mask: torch.Tensor, dim: int) -> torch.Tensor:
    """AllenNLP-style masked mean: sum / clamped count."""
    value_sum = torch.where(mask, vector, 0.0).sum(dim=dim)
    value_count = mask.sum(dim=dim).float()
    return value_sum / torch.clamp(value_count, min=1e-13)


def average_task_loss(labels: torch.Tensor, logits: torch.Tensor, tp: Optional[Group] = None) -> torch.Tensor:
    """Per-sample length-normalised CE, then batch mean; under tensor
    parallelism (`tp`), over logits whose vocabulary is split."""
    mask = labels != IGNORE_INDEX
    safe_labels = torch.where(mask, labels, 0).long()
    if tp is not None:
        tok_loss = vocab_parallel_cross_entropy(logits, safe_labels, tp)
    else:
        logprobs = F.log_softmax(logits.float(), dim=-1)
        tok_loss = -torch.gather(logprobs, -1, safe_labels[..., None])[..., 0]
    return masked_mean(tok_loss, mask, dim=-1).mean()


def compute_loss(labels: torch.Tensor, logits: torch.Tensor, tp: Optional[Group] = None) -> torch.Tensor:
    """Slice logits to the label length, shift, average."""
    label_len = labels.shape[1]
    logits = logits[:, -label_len:, :]
    return average_task_loss(labels[:, 1:], logits[:, :-1, :], tp)


class VLPythiaOutput(NamedTuple):
    loss: Optional[torch.Tensor]
    logits: Optional[torch.Tensor]
    # [L+1, B, 256+T, H] when asked (last entry post-final-LN); [num_layers+1, ...]
    # raw residual taps when forward() truncated the stack
    hidden_states: Optional[torch.Tensor]


def get_patch_embeddings(model: VLPythia, pixel_values: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Frozen vision features [B, n_vision_tokens, d_vis]: EVA-02's
    forward_features or CLIP's hidden_states[select_layer], CLS dropped for
    select_feature == "patch"."""
    if model.cfg.vision.backbone == "clip":
        feats = model.vision_encoder.hidden_states(pixel_values, dtype=dtype)[model.cfg.select_layer]
    else:
        feats = model.vision_encoder.forward_features(pixel_values, dtype=dtype)
    if model.cfg.select_feature == "patch":
        feats = feats[:, 1:]
    elif model.cfg.select_feature != "cls_patch":
        raise ValueError(f"Unexpected select feature: {model.cfg.select_feature}")
    return feats.detach()


def n_vision_tokens(cfg: ModelConfig) -> int:
    """Length of the vision prefix: num_patches, plus CLS unless select_feature == "patch" drops it."""
    return cfg.vision.num_patches + (0 if cfg.select_feature == "patch" else 1)


def project_vision(model: VLPythia, patch_embeddings: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    fc1, fc2 = model.vision_embed_tokens[0], model.vision_embed_tokens[2]
    x = gpt_neox.dense(copy_to_model_group(patch_embeddings.to(dtype), model.tp), fc1, dtype)
    return gpt_neox.dense(F.gelu(x), fc2, dtype, reduce=model.tp)


def build_inputs(model: VLPythia, input_ids, attention_mask, patch_embeddings=None, *, pixel_values=None, dtype=torch.bfloat16):
    """Vision-first concat of the embeddings, and the extended mask. The
    vision features are `patch_embeddings` (cached) or the tower's output on
    `pixel_values` (NCHW)."""
    if patch_embeddings is None:
        if pixel_values is None:
            raise ValueError("build_inputs needs patch_embeddings or pixel_values")
        patch_embeddings = get_patch_embeddings(model, pixel_values, dtype=dtype)
    vis_embeds = project_vision(model, patch_embeddings, dtype=dtype)
    batch, n_vis = vis_embeds.shape[:2]
    txt_embeds = gpt_neox.embed(model.gpt_neox, input_ids, dtype=dtype)
    inputs_embeds = torch.cat([vis_embeds, txt_embeds], dim=1)
    if attention_mask is None:
        attention_mask = torch.ones_like(input_ids)
    ones = torch.ones((batch, n_vis), dtype=attention_mask.dtype, device=attention_mask.device)
    return inputs_embeds, torch.cat([ones, attention_mask], dim=1)


def forward(
    model: VLPythia,
    input_ids: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    labels: Optional[torch.Tensor] = None,
    *,
    patch_embeddings: Optional[torch.Tensor] = None,
    pixel_values: Optional[torch.Tensor] = None,
    output_hidden_states: bool = False,
    hidden_perturbation: Optional[torch.Tensor] = None,
    dtype=torch.bfloat16,
    loss_only: bool = False,
    need_logits: bool = True,
    num_layers: Optional[int] = None,
    remat_layers: bool = False,
    remat_policy: Optional[gpt_neox.RematPolicy] = None,
    label_tail: Optional[int] = None,
) -> VLPythiaOutput:
    """Training/eval forward (no KV cache) over cached vision features
    (`patch_embeddings`) or pixels through the frozen tower (`pixel_values`).

    loss_only: project embed_out only over the last label_len positions (the
    loss slices logits there anyway); returned logits cover only those.
    label_tail (with loss_only + labels): restrict the lm_head and CE to the
    last `label_tail` positions, where the answer suffix lives.
    num_layers: early-exit the decoder after this many blocks (teacher path);
    needs need_logits=False and labels=None.
    remat_layers: recompute each decoder layer in backward, keeping what
    `remat_policy` (training/step.py resolve_remat_policy) names.
    hidden_perturbation ([L, B, n_vis + T, H]): entry 0 is added to the input
    embeddings, entries 1.. to the decoder layers' outputs (see
    GPTNeoXModel.forward's layer_perturbation).
    """
    if num_layers is not None and (need_logits or labels is not None):
        raise ValueError("num_layers truncation skips the final LN: logits/loss unavailable")
    inputs_embeds, full_mask = build_inputs(
        model, input_ids, attention_mask, patch_embeddings, pixel_values=pixel_values, dtype=dtype
    )
    layer_pert = None
    if hidden_perturbation is not None:
        inputs_embeds = inputs_embeds + hidden_perturbation[0].to(inputs_embeds.dtype)
        layer_pert = hidden_perturbation[1:]
    dec = model.gpt_neox(
        inputs_embeds,
        attention_mask=full_mask,
        output_hidden_states=output_hidden_states,
        dtype=dtype,
        num_layers=num_layers,
        remat=remat_layers,
        remat_policy=remat_policy,
        layer_perturbation=layer_pert,
    )
    hidden = dec["last_hidden_state"]
    if not need_logits and labels is None:
        return VLPythiaOutput(loss=None, logits=None, hidden_states=dec.get("hidden_states"))
    if loss_only and labels is not None:
        if label_tail is not None and 0 < label_tail < labels.shape[1]:
            labels = labels[:, -label_tail:]
        hidden = hidden[:, -labels.shape[1]:]
    lm_logits = gpt_neox.logits(model.embed_out, hidden, dtype=dtype, tp=model.tp)
    loss = compute_loss(labels, lm_logits, model.tp) if labels is not None else None
    return VLPythiaOutput(loss=loss, logits=lm_logits, hidden_states=dec.get("hidden_states"))
