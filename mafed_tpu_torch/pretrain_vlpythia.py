"""Captioning pretraining entry point (counterpart of
mafed_tpu/pretrain_vlpythia.py; the reference's mafed/pretrain_vlpythia.py):
the ModelArguments / DataArguments / PretrainConfig flags, a frozen vision
tower, the Pythia tokenizer (pad = eos), then PretrainTrainer.

    python -m mafed_tpu_torch.pretrain_vlpythia --manifest train.jsonl \
        --eval_manifest val.jsonl --output_dir storage/pretrain [--device cpu]

A directory as --model_name starts from its weights (load_pretrained);
otherwise the model is random from --seed. Runs on the CUDA device unless
--device cpu; under `torchrun --nproc_per_node N -m
mafed_tpu_torch.pretrain_vlpythia ...` each of the N ranks runs on its own
card (cuda:LOCAL_RANK, or the CPU with --device cpu) at a global batch of
per_device_train_batch_size x N; with --mesh_shape D M (D x M = N) the
ranks form a (data, model) grid and split the model over each M
(core/mesh.py). Each flag is added once: --model_max_length, a field of both
ModelArguments and PretrainConfig, sets both (the JAX package's parser adds
it twice and so raises before parsing).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from dataclasses import dataclass

from mafed_tpu_torch.core.config import ModelConfig
from mafed_tpu_torch.core.dist import maybe_initialize_distributed
from mafed_tpu_torch.core.logging import LOGGER
from mafed_tpu_torch.data.tokenizer import build_tokenizer
from mafed_tpu_torch.models.weights import load_pretrained
from mafed_tpu_torch.pretrain.dataset import PretrainDataset
from mafed_tpu_torch.pretrain.trainer import PretrainConfig, PretrainTrainer
from mafed_tpu_torch.training.train_state import FROZEN_PREFIX


@dataclass
class ModelArguments:
    """Parity: pretrain_vlpythia.py:16-37."""

    model_name: str = "EleutherAI/pythia-410m"
    vision_encoder_name: str = "timm/eva02_large_patch14_clip_224"
    select_layer: int = -2
    select_feature: str = "patch"
    tokenizer_name: str = "EleutherAI/pythia-410m"
    tokenizer_truncation_side: str = "right"
    tokenizer_padding_side: str = "right"
    tokenizer_add_special_tokens: bool = True
    allow_tokenizer_fallback: bool = False
    model_max_length: int = 100


@dataclass
class DataArguments:
    """Parity: pretrain_vlpythia.py:39-48."""

    dataset_path: str = ""
    dataset_cache_dir: str = ""
    root_dataset_path: str = ""
    train_dataset_subset: str = "pretrain"
    eval_dataset_subset: str = "pretrain"
    manifest: str = ""
    eval_manifest: str = ""


def build_parser() -> argparse.ArgumentParser:
    """One flag per field of the three dataclasses (a field two of them share
    once), typed as the JAX package types them, and --device."""
    parser = argparse.ArgumentParser()
    seen = set()
    for dc in (ModelArguments, DataArguments, PretrainConfig):
        for f in dataclasses.fields(dc):
            if f.name in seen:
                continue
            seen.add(f.name)
            default = f.default if f.default is not dataclasses.MISSING else None
            if isinstance(default, bool):
                parser.add_argument(f"--{f.name}", action="store_true", default=default)
            elif isinstance(default, tuple):
                elem = int if all(isinstance(x, int) for x in default) else float
                parser.add_argument(f"--{f.name}", nargs="+", type=elem, default=list(default))
            else:
                parser.add_argument(f"--{f.name}", type=type(default) if default is not None else str, default=default)
    parser.add_argument("--device", default="cuda")
    return parser


def parse_args(argv=None):
    """(ModelArguments, DataArguments, PretrainConfig, device) of a command line."""
    ns = vars(build_parser().parse_args(argv))

    def pick(dc):
        kwargs = {f.name: ns[f.name] for f in dataclasses.fields(dc)}
        return dc(**{k: tuple(v) if isinstance(v, list) else v for k, v in kwargs.items()})

    return pick(ModelArguments), pick(DataArguments), pick(PretrainConfig), ns["device"]


def compute_trainable_params(state_dict) -> int:
    """Log the trainable (decoder and projector) and frozen (tower) parameter
    counts; returns the trainable one."""
    n_train = sum(v.numel() for k, v in state_dict.items() if not k.startswith(FROZEN_PREFIX))
    n_frozen = sum(v.numel() for k, v in state_dict.items() if k.startswith(FROZEN_PREFIX))
    LOGGER.info("trainable params: %.1fM, frozen (vision): %.1fM", n_train / 1e6, n_frozen / 1e6)
    return n_train


def train(argv=None):
    """Parse `argv`, build the model, tokenizer and datasets, and pretrain;
    returns the final TrainState."""
    model_args, data_args, train_args, device = parse_args(argv)
    maybe_initialize_distributed(train_args, device=device)  # before anything touches CUDA
    init_params = None
    if os.path.isdir(model_args.model_name):
        init_params, model_cfg = load_pretrained(model_args.model_name)
    else:
        model_cfg = ModelConfig(vision_encoder_name=model_args.vision_encoder_name,
                                select_layer=model_args.select_layer,
                                select_feature=model_args.select_feature)
        LOGGER.warning("model dir %s not found; random init", model_args.model_name)

    tokenizer = build_tokenizer(
        model_args.tokenizer_name,
        model_max_length=model_args.model_max_length,
        padding_side=model_args.tokenizer_padding_side,
        truncation_side=model_args.tokenizer_truncation_side,
        allow_fallback=model_args.allow_tokenizer_fallback,
    )
    train_ds = PretrainDataset(tokenizer, model_cfg.vision, manifest_path=data_args.manifest or None,
                               model_max_length=model_args.model_max_length)
    eval_ds = (
        PretrainDataset(tokenizer, model_cfg.vision, manifest_path=data_args.eval_manifest,
                        model_max_length=model_args.model_max_length)
        if data_args.eval_manifest else None
    )
    trainer = PretrainTrainer(model_cfg, train_args, train_ds, eval_ds, tokenizer,
                              init_params=init_params, device=device)
    compute_trainable_params(trainer.model.state_dict())
    return trainer.train()


if __name__ == "__main__":
    train()
