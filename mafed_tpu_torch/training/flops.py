"""Analytic FLOPs of the fused MAFED window and of the greedy decode, and MFU
on an H100 (counterpart of mafed_tpu/training/flops.py)."""

from __future__ import annotations

from mafed_tpu_torch.core.config import ModelConfig

# NVIDIA H100 SXM, dense bf16 tensor-core peak (data sheet, 700 W)
H100_BF16_PEAK = 989e12


def decoder_flops_per_token(cfg: ModelConfig) -> float:
    """Forward matmul FLOPs per token (2*MACs), attention excluded."""
    h, inter = cfg.hidden_size, cfg.intermediate_size
    return cfg.num_hidden_layers * 2 * (4 * h * h + 2 * h * inter)


def attention_flops(cfg: ModelConfig, seq_len: int) -> float:
    """Forward attention FLOPs for one sequence (full square, causality not discounted)."""
    return cfg.num_hidden_layers * 4 * seq_len * seq_len * cfg.hidden_size


def vision_flops_per_image(cfg: ModelConfig) -> float:
    """Forward FLOPs of the EVA-02 tower on one image (attention included)."""
    v = cfg.vision
    tokens = v.num_patches + (1 if v.class_token else 0)
    hidden = int(v.embed_dim * v.mlp_ratio)
    mlps = 3 if v.swiglu_mlp else 2
    per_layer = 2 * (4 * v.embed_dim ** 2 + mlps * v.embed_dim * hidden)
    blocks = v.depth * (per_layer * tokens + 4 * tokens * tokens * v.embed_dim)
    patch_embed = 2 * tokens * (v.patch_size ** 2 * 3) * v.embed_dim
    return blocks + patch_embed


def lm_head_flops(cfg: ModelConfig, positions: int) -> float:
    return 2 * positions * cfg.hidden_size * cfg.vocab_size


def framework_window_flops(
    cfg: ModelConfig,
    text_len: int,
    n_ce: int,
    batch: int,
) -> float:
    """Model FLOPs of one fused MAFED window on cached vision features
    (PaLM-MFU convention: fwd + bwd = 3x fwd for trainable paths, layer
    recompute excluded): lm_head over the last label_len (= text_len)
    positions, the teacher early-exited after num_hidden_layers - 2 blocks
    with no lm_head, the projector on every pass."""
    seq = cfg.vision.num_patches + text_len
    dec_fwd = decoder_flops_per_token(cfg) * seq + attention_flops(cfg, seq)
    head = lm_head_flops(cfg, text_len)
    proj = 2 * cfg.vision.num_patches * (cfg.vision.embed_dim * cfg.hidden_size + cfg.hidden_size ** 2)
    student_ex = 3 * (dec_fwd + head + proj)
    deepest = cfg.num_hidden_layers - 2
    teacher_ex = dec_fwd * deepest / cfg.num_hidden_layers + proj
    return batch * (n_ce * student_ex + student_ex + teacher_ex)


def framework_decode_flops_per_example(cfg: ModelConfig, text_len: int, max_new: int, *, vision_cached: bool = True) -> float:
    """FLOPs of one example's greedy decode (evaluation/decode.py): the
    projector, the tower unless the features are cached, one prefill over
    vision + text with logits at the last position, then max_new - 1 cached
    single-token steps against the growing prefix."""
    seq0 = cfg.vision.num_patches + text_len
    proj = 2 * cfg.vision.num_patches * (cfg.vision.embed_dim * cfg.hidden_size + cfg.hidden_size ** 2)
    total = proj + (0.0 if vision_cached else vision_flops_per_image(cfg))
    total += decoder_flops_per_token(cfg) * seq0 + attention_flops(cfg, seq0) + lm_head_flops(cfg, 1)
    for k in range(1, max_new):
        seq = seq0 + k
        total += decoder_flops_per_token(cfg) + attention_flops(cfg, seq) / seq + lm_head_flops(cfg, 1)
    return total


def mfu(examples_per_sec: float, flops_per_example: float, peak: float = H100_BF16_PEAK) -> float:
    return examples_per_sec * flops_per_example / peak
