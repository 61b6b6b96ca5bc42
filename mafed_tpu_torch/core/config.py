"""Typed configuration (the port's copy of mafed_tpu/core/config.py).

This slice carries the model configuration, the presets, and the
`TrainConfig` fields that the training steps read. Field names and
defaults are the reference's, so a config written for one package reads the
same in the other. The CLI/JSON merge comes with the trainer.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass
class VisionConfig:
    """EVA-02 ViT encoder configuration (timm's eva02_large_patch14_clip_224)."""

    name: str = "timm/eva02_large_patch14_clip_224"
    backbone: str = "eva02"
    img_size: int = 224
    patch_size: int = 14
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4 * 2 / 3
    use_rot_pos_emb: bool = True
    use_abs_pos_emb: bool = True
    class_token: bool = True
    qkv_fused: bool = False
    swiglu_mlp: bool = True
    scale_mlp: bool = True
    scale_attn_inner: bool = True
    rope_temperature: float = 10000.0
    rope_ref_feat_side: Optional[int] = None
    layer_norm_eps: float = 1e-6
    crop_pct: float = 0.9
    mean: tuple = (0.48145466, 0.4578275, 0.40821073)
    std: tuple = (0.26862954, 0.26130258, 0.27577711)

    @property
    def num_patches(self) -> int:
        side = self.img_size // self.patch_size
        return side * side

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads


@dataclass
class ModelConfig:
    """VL-Pythia model configuration; field names follow the HF GPT-NeoX config."""

    vocab_size: int = 50304
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    hidden_act: str = "gelu"
    rotary_pct: float = 0.25
    rotary_emb_base: float = 10000.0
    max_position_embeddings: int = 2048
    layer_norm_eps: float = 1e-5
    use_parallel_residual: bool = True
    attention_bias: bool = True
    tie_word_embeddings: bool = False
    initializer_range: float = 0.02
    eos_token_id: int = 0
    vision_encoder_name: str = "timm/eva02_large_patch14_clip_224"
    select_layer: int = -2
    select_feature: str = "patch"
    vision: VisionConfig = field(default_factory=VisionConfig)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def rotary_ndims(self) -> int:
        return int(self.head_dim * self.rotary_pct)


# VL-Pythia-EVA 160M / 410M / 1B (Pythia scales)
MODEL_PRESETS = {
    "160m": dict(hidden_size=768, num_hidden_layers=12, num_attention_heads=12, intermediate_size=3072),
    "410m": dict(hidden_size=1024, num_hidden_layers=24, num_attention_heads=16, intermediate_size=4096),
    "1b": dict(hidden_size=2048, num_hidden_layers=16, num_attention_heads=8, intermediate_size=8192),
}


def model_config_for_preset(preset: str, **overrides: Any) -> ModelConfig:
    kwargs = dict(MODEL_PRESETS[preset])
    kwargs.update(overrides)
    return ModelConfig(**kwargs)


@dataclass
class TrainConfig:
    """The training fields the training steps read (names and defaults of
    mafed_tpu's TrainConfig). `remat_policy` takes "" or "full" only: the
    named policies are not ported (training/step.resolve_remat_policy)."""

    learning_rate: float = 5e-5
    lr_mul: float = 10.0
    optim: str = "adam"
    betas: list = field(default_factory=lambda: [0.9, 0.98])
    weight_decay: float = 0.0
    grad_norm: float = 2.0
    replay_coeff: float = 1.0
    distillation_modality_weighing_strategy: str = "equal"
    distillation_layer_weighing_strategy: str = "single"
    distillation_coeff: float = 1.0
    distillation_layer_discount: float = 0.9
    distillation_layer: Optional[int] = None
    distillation_loss: str = "mse"
    cls_distillation: bool = False
    compute_dtype: str = "bfloat16"
    adam_mu_dtype: Optional[str] = None
    label_tail: int = 32
    accumulate_grad_batches: int = 1
    reg_lambda: float = 1.0  # EWC penalty weight
    ewc_state_dtype: str = "float32"  # storage of the Fisher and theta*: float32 or bfloat16
    remat: bool = False  # recompute each decoder layer in backward (make_train_step)
    remat_policy: str = ""
