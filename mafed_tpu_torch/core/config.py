"""Typed configuration (the port's copy of mafed_tpu/core/config.py).

The model configuration (read from the reference's JSON files with
`ModelConfig.from_json`), the presets, the full `TrainConfig`, and the
command line: one flag per field, merged with a JSON config where the
command line wins per key. Field names and defaults are the reference's.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
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

    @classmethod
    def from_json(cls, path: str) -> "ModelConfig":
        """A model config JSON (HF GPT-NeoX names, e.g. config/vlpythia-base.json)."""
        with open(path) as f:
            return cls.from_dict(json.load(f))

    @classmethod
    def from_dict(cls, data: dict) -> "ModelConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in data.items() if k in names and k != "vision"}
        if "rotary_emb_base" in kwargs:
            kwargs["rotary_emb_base"] = float(kwargs["rotary_emb_base"])
        cfg = cls(**kwargs)
        if isinstance(data.get("vision"), dict):
            cfg.vision = VisionConfig(**data["vision"])
        return cfg

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


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
    """Full training/CL configuration: the field names, defaults and CLI
    flags of mafed_tpu's TrainConfig (reference mafed/train.py:304-478), so a
    config written for one package reads the same in the other.

    `mesh_shape` [D, M] is a (data, model) grid of D x M ranks, one device
    each (core/mesh.py); one that does not multiply to the number of ranks,
    or whose M does not divide the model, raises ValueError
    (trainer/continual.check_supported, the runner).
    """

    # Required-ish paths
    output_dir: str = "output"
    model_config: str = ""
    # Checkpointing
    checkpoint: Optional[str] = None
    resume_from_checkpoint: Optional[str] = None
    checkpoint_dir: Optional[str] = None
    checkpoint_extension: str = ".safetensors"
    init_ckpt_extension: str = ".safetensors"
    # Preprocessing
    max_txt_len: int = 60
    # Training
    batch_size: int = 32
    val_batch_size: int = 32
    accumulate_grad_batches: int = 1
    learning_rate: float = 5e-5
    lr_mul: float = 10.0
    lr_schedule: str = "triangular"
    epochs: list = field(default_factory=lambda: [15, 15])
    optim: str = "adam"
    betas: list = field(default_factory=lambda: [0.9, 0.98])
    dropout: float = 0.1
    weight_decay: float = 0.0
    grad_norm: float = 2.0
    warmup_perc: float = 0.1
    patience: int = 5
    n_workers: int = 4
    pin_mem: bool = False
    gpus: int = 1
    start_task_idx: int = 0
    exp: str = "question_types"
    # CL
    seed: int = 42
    tasks: Optional[list] = None
    cl_method: str = "naive"
    reg_lambda: float = 1.0  # EWC penalty weight
    ewc_state_dtype: str = "float32"  # storage of the Fisher and theta*: float32 or bfloat16
    cl_memory: int = 4000
    replay_coeff: float = 1.0
    replay_interval: int = 4
    # Feature distillation
    distillation_modality_weighing_strategy: str = "equal"
    distillation_layer_weighing_strategy: str = "single"
    distillation_coeff: float = 1.0
    distillation_layer_discount: float = 0.9
    distillation_layer: Optional[int] = None
    distillation_loss: str = "mse"
    cls_distillation: bool = False
    # Logging
    run_entity: Optional[str] = None
    run_project: str = "continual-vl-pythia-finetune"
    run_group: Optional[str] = None
    run_name: Optional[str] = None
    # Model
    model_type: str = "vlpythia"
    model_name: str = "storage/models/vl-pythia-eva-1b"
    tokenizer_name: str = "EleutherAI/pythia-410m"
    # opt-in only: the byte-level tokenizer when the real one is unavailable
    # (it changes the vocabulary: synthetic and test runs, never real training)
    allow_tokenizer_fallback: bool = False
    vision_encoder_name: str = "timm/eva02_large_patch14_clip_224"
    # Data locations
    data_dir: str = "storage/data/VQA"
    train_img_dirs: list = field(default_factory=list)
    val_img_dirs: list = field(default_factory=list)
    test_img_dirs: list = field(default_factory=list)
    question_task_ids: str = ""
    val_num_workers: int = 4
    valid_steps: int = 75
    # Device layout: the (data, model) mesh of the ranks, one device each (core/mesh.py)
    mesh_shape: list = field(default_factory=lambda: [-1, 1])
    mesh_axis_names: list = field(default_factory=lambda: ["data", "model"])
    distributed_init: bool = False
    resume_bundle_every: int = 1
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    adam_mu_dtype: Optional[str] = None  # "bfloat16" halves first-moment memory
    text_pad_multiple: int = 16  # text lengths rounded up to a multiple
    val_max_batches: Optional[int] = None
    remat: bool = False  # recompute each decoder layer in backward (make_train_step)
    remat_policy: str = ""
    # restrict the training lm_head + CE to the last label_tail text
    # positions (collate_train checks that every label lies there); 0 disables
    label_tail: int = 32
    # each accumulation window as one step (training/step.py window steps);
    # otherwise per-microbatch steps under MultiSteps
    fused_window: bool = True
    # disk cache of the frozen tower's features (data/vision_cache.py)
    vision_cache: bool = True
    vision_cache_dir: Optional[str] = None  # default: {output_dir}/vision_cache
    device_vision_table_mb: int = 1024
    vision_table_dtype: str = "bfloat16"
    teacher_state_cache: str = "auto"
    teacher_cache_dir: Optional[str] = None
    device_teacher_table_mb: int = 4096
    prefetch_depth: int = 2  # batches in flight to the device (data/prefetch.py)
    log_every: int = 50
    profile_dir: Optional[str] = None

    def replace(self, **kwargs: Any) -> "TrainConfig":
        return dataclasses.replace(self, **kwargs)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, data: dict) -> "TrainConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in names})


_LIST_FLAGS = {
    "epochs": int, "mesh_shape": int, "betas": float,
    "tasks": str, "mesh_axis_names": str, "train_img_dirs": str, "val_img_dirs": str, "test_img_dirs": str,
}


def _add_bool_flag(parser: argparse.ArgumentParser, name: str, default: bool) -> None:
    # default-True flags (e.g. fused_window) need a --no_<name> off switch
    parser.add_argument(f"--{name}", dest=name, action="store_true", default=default)
    parser.add_argument(f"--no_{name}", dest=name, action="store_false")


def build_arg_parser() -> argparse.ArgumentParser:
    """One flag per TrainConfig field, named after it, plus --config."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default=None, help="JSON config file")
    defaults = TrainConfig()
    for f in dataclasses.fields(TrainConfig):
        flag = f"--{f.name}"
        default = getattr(defaults, f.name)
        if f.name in _LIST_FLAGS:
            parser.add_argument(flag, nargs="+", type=_LIST_FLAGS[f.name], default=default)
        elif isinstance(default, bool):
            _add_bool_flag(parser, f.name, default)
        elif isinstance(default, int):
            parser.add_argument(flag, type=int, default=default)
        elif isinstance(default, float):
            parser.add_argument(flag, type=float, default=default)
        else:
            parser.add_argument(flag, type=str, default=default)
    return parser


def parse_with_config(parser: argparse.ArgumentParser, argv: Optional[list] = None) -> TrainConfig:
    """argparse + JSON merge: every key of the --config JSON that was not
    given on the command line is taken from the JSON (reference
    mafed/utils/misc.py:26-35); --no_<flag> counts as giving <flag>."""
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    args = parser.parse_args(argv)
    if args.config is not None:
        with open(args.config) as f:
            config_args = json.load(f)
        override_keys = {arg[2:].split("=")[0] for arg in argv if arg.startswith("--")}
        override_keys |= {k[3:] for k in override_keys if k.startswith("no_")}
        for k, v in config_args.items():
            if k not in override_keys:
                setattr(args, k, v)
    data = vars(args)
    data.pop("config", None)
    return TrainConfig.from_dict(data)
