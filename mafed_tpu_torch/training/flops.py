"""Analytic FLOPs of the training steps and of the greedy decode, and MFU on
an H100 (counterpart of mafed_tpu/training/flops.py). Model FLOPs in the
PaLM-MFU convention: fwd + bwd = 3x fwd for trainable paths, layer
recompute excluded."""

from __future__ import annotations

from mafed_tpu_torch.core.config import ModelConfig
from mafed_tpu_torch.models.vl_pythia import n_vision_tokens

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


def projector_flops(cfg: ModelConfig) -> float:
    """Forward FLOPs of the two-layer projector over one example's patches."""
    return 2 * n_vision_tokens(cfg) * (cfg.vision.embed_dim * cfg.hidden_size + cfg.hidden_size ** 2)


def ce_example_flops(cfg: ModelConfig, text_len: int, *, vision_cached: bool = True) -> float:
    """One example of a differentiated CE pass: decoder, lm_head over the last
    label_len (= text_len) positions and projector, fwd + bwd, plus one tower
    forward unless the features are cached. A CE window of n_mb microbatches
    of B is n_mb * B of these; a train step, B."""
    seq = n_vision_tokens(cfg) + text_len
    dec_fwd = decoder_flops_per_token(cfg) * seq + attention_flops(cfg, seq)
    student = 3 * (dec_fwd + lm_head_flops(cfg, text_len) + projector_flops(cfg))
    return student + (0.0 if vision_cached else vision_flops_per_image(cfg))


def distill_step_flops_per_example(cfg: ModelConfig, text_len: int) -> float:
    """The JAX package's count for one example of the fused student+teacher
    step: student fwd+bwd (3x fwd), a whole teacher fwd, ONE shared tower
    fwd and the projector fwd (an upper bound of the early-exited,
    cached-feature step; `framework_window_flops(cfg, t, 0, 1)` is the exact
    count of that one)."""
    seq = n_vision_tokens(cfg) + text_len
    dec_fwd = decoder_flops_per_token(cfg) * seq + attention_flops(cfg, seq)
    head = lm_head_flops(cfg, text_len)
    return 3 * (dec_fwd + head) + dec_fwd + vision_flops_per_image(cfg) + projector_flops(cfg)


def framework_window_flops(
    cfg: ModelConfig,
    text_len: int,
    n_ce: int,
    batch: int,
    *,
    vision_cached: bool = True,
    teacher_cached: bool = False,
) -> float:
    """Model FLOPs of one MAFED window (n_ce CE microbatches + 1 memory
    microbatch of `batch` rows): every example a CE example (`ce_example_flops`),
    plus, for the memory microbatch, the teacher early-exited after
    num_hidden_layers - 2 blocks with no lm_head and its projector forward,
    unless its states come from the teacher-state cache (`teacher_cached`).
    Uncached, one tower forward per image, shared by student and teacher."""
    seq = n_vision_tokens(cfg) + text_len
    dec_fwd = decoder_flops_per_token(cfg) * seq + attention_flops(cfg, seq)
    deepest = cfg.num_hidden_layers - 2
    teacher_ex = 0.0 if teacher_cached else dec_fwd * deepest / cfg.num_hidden_layers + projector_flops(cfg)
    return batch * ((n_ce + 1) * ce_example_flops(cfg, text_len, vision_cached=vision_cached) + teacher_ex)


def framework_decode_flops_per_example(cfg: ModelConfig, text_len: int, max_new: int, *, vision_cached: bool = True) -> float:
    """FLOPs of one example's greedy decode (evaluation/decode.py): the
    projector, the tower unless the features are cached, one prefill over
    vision + text with logits at the last position, then max_new - 1 cached
    single-token steps against the growing prefix."""
    seq0 = n_vision_tokens(cfg) + text_len
    total = projector_flops(cfg) + (0.0 if vision_cached else vision_flops_per_image(cfg))
    total += decoder_flops_per_token(cfg) * seq0 + attention_flops(cfg, seq0) + lm_head_flops(cfg, 1)
    for k in range(1, max_new):
        seq = seq0 + k
        total += decoder_flops_per_token(cfg) + attention_flops(cfg, seq) / seq + lm_head_flops(cfg, 1)
    return total


def mfu(examples_per_sec: float, flops_per_example: float, peak: float = H100_BF16_PEAK) -> float:
    return examples_per_sec * flops_per_example / peak
