"""Shared fixtures of the port's parity tests: tiny VL-Pythia configs built
in both packages (head_dim 64, and with `WIDE_DECODERS` the wider heads the
flash kernels take: 256 as the 1B decoder's, 128 as Pythia-1.4B's, 96 as
GPT-NeoX-20B's, 384 and 512 as the regrouped decoders' that the wide kernels
take), JAX parameters carried into the port, and seeded numpy batches."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mafed_tpu.core.config import ModelConfig, VisionConfig
from mafed_tpu.models import vl_pythia as jvl

from mafed_tpu_torch.core import config as tcfg
from mafed_tpu_torch.models import vl_pythia as tvl
from mafed_tpu_torch.models.weights import params_from_jax

TINY = dict(vocab_size=512, hidden_size=128, num_hidden_layers=3, num_attention_heads=2, intermediate_size=256, rotary_pct=0.25)
# the 1B preset's head shape (heads of 256, rotary over 64 of them) at a tiny width and depth
TINY_256 = dict(vocab_size=512, hidden_size=512, num_hidden_layers=2, num_attention_heads=2, intermediate_size=1024, rotary_pct=0.25)
# Pythia-1.4B's head shape (heads of 128, rotary over 32) and GPT-NeoX-20B's (heads of 96, rotary over 24)
TINY_128 = dict(vocab_size=512, hidden_size=256, num_hidden_layers=2, num_attention_heads=2, intermediate_size=512, rotary_pct=0.25)
TINY_96 = dict(vocab_size=512, hidden_size=192, num_hidden_layers=2, num_attention_heads=2, intermediate_size=384, rotary_pct=0.25)
# the regrouped decoders' head shapes (heads of 384 and 512, rotary over 96 and 128), which the wide kernels take
TINY_384 = dict(vocab_size=512, hidden_size=768, num_hidden_layers=2, num_attention_heads=2, intermediate_size=1536, rotary_pct=0.25)
TINY_512 = dict(vocab_size=512, hidden_size=1024, num_hidden_layers=2, num_attention_heads=2, intermediate_size=2048, rotary_pct=0.25)
# the tiny decoders of the `*_wide_heads` tests, by head_dim; their test ids are "head_dim_<d>"
WIDE_DECODERS = {256: TINY_256, 128: TINY_128, 96: TINY_96, 384: TINY_384, 512: TINY_512}
WIDE_IDS = [f"head_dim_{d}" for d in WIDE_DECODERS]
TINY_VISION = dict(img_size=28, patch_size=14, embed_dim=32, depth=2, num_heads=2, mlp_ratio=2.0)
# a tower whose attention the flash dispatch takes: 16 patches + CLS, 2 heads of 64
TINY_VISION_64 = dict(img_size=56, patch_size=14, embed_dim=128, depth=2, num_heads=2)


def tiny_cfgs(vision=TINY_VISION, decoder=TINY):
    """(JAX ModelConfig, port ModelConfig) of the same tiny model: by default
    hidden 128, 2 heads of 64, 3 layers (`decoder=TINY_256`: hidden 512, 2
    heads of 256, 2 layers; TINY_128, TINY_96, TINY_384, TINY_512 likewise), and a tower of 4
    patches of width 32."""
    jcfg = ModelConfig(**decoder, vision=VisionConfig(**vision), vision_encoder_name="tiny-eva")
    tc = tcfg.ModelConfig(**decoder, vision=tcfg.VisionConfig(**vision), vision_encoder_name="tiny-eva")
    return jcfg, tc


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Imported by a test module: its tests run torch on one CPU thread. The
    tiny models are no slower so, and the suite's parallel workers do not
    oversubscribe the cores; the previous count comes back after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def jax_params(jcfg, seed: int = 0, vision_dtype=jnp.bfloat16):
    return jvl.init_params(jcfg, jax.random.PRNGKey(seed), dtype=jnp.float32, vision_dtype=vision_dtype)


def torch_model(params, tc, dtype=torch.float32) -> tvl.VLPythia:
    params_np = jax.tree.map(np.asarray, params)
    model = tvl.VLPythia(tc, device="cpu")
    model.load_state_dict(params_from_jax(params_np, tc), strict=True)
    return model.to(dtype)


def batch(cfg, b: int, text_len: int, seed: int = 0, pad: int = 3, tail: int = 4, pixels: bool = False):
    """Left-padded text with an answer suffix, and cached patch features (or,
    with `pixels`, uint8 NHWC images for the tower)."""
    rng = np.random.default_rng(seed)
    input_ids = rng.integers(1, cfg.vocab_size - 1, size=(b, text_len)).astype(np.int32)
    attention_mask = np.ones((b, text_len), np.int32)
    attention_mask[:, :pad] = 0
    labels = input_ids.copy()
    labels[:, :-tail] = -100
    out = {"input_ids": input_ids, "attention_mask": attention_mask, "labels": labels}
    if pixels:
        side = cfg.vision.img_size
        out["pixels"] = rng.integers(0, 256, size=(b, side, side, 3)).astype(np.uint8)
    else:
        out["patches"] = rng.normal(size=(b, cfg.vision.num_patches, cfg.vision.embed_dim)).astype(np.float32)
    return out


def stack(batches):
    """[n_mb, B, ...] stacks of a list of microbatches."""
    return {k: np.stack([mb[k] for mb in batches]) for k in batches[0]}


def to_torch(batch_np, device="cpu"):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch_np.items()}


def to_jax(batch_np):
    return {k: jnp.asarray(v) for k, v in batch_np.items()}


QUESTIONS = [
    ("what color is the ball", "red"),
    ("how many dogs are there", "two"),
    ("what is the person doing", "running"),
    ("is it raining", "yes"),
    ("what animal is shown", "cat"),
    ("what room is this", "kitchen"),
]


def write_synthetic_vqa(root: str, tasks=("taskA", "taskB"), n_train: int = 24, n_val: int = 8) -> "tcfg.TrainConfig":
    """The port's writer of the synthetic ContVQA layout of
    tests/helpers.py::write_synthetic_vqa ({split}_annotations.json and the
    split files under contvqa/tiny), and the port's TrainConfig over it
    (that of tests/helpers.py::synthetic_config: the trainer's defaults for
    the device tables, the teacher-state cache and the resume bundles)."""
    import json
    import os

    os.makedirs(os.path.join(root, "contvqa", "tiny"), exist_ok=True)
    records, splits = {"train": {}, "val": {}}, {"train": {}, "valid": {}}
    for task in tasks:
        for split, key, n, suffix in (("train", "train", n_train, "tr"), ("val", "valid", n_val, "va")):
            ids = []
            for i in range(n):
                q, a = QUESTIONS[i % len(QUESTIONS)]
                qid = f"{task}_{suffix}{i}"
                records[split][qid] = {
                    "image_id": i, "id": qid, "question_id": qid, "question": q, "img_fname": f"synthetic_{i}",
                    "multiple_choice_answer": a,
                    "answers": [{"answer": a, "answer_confidence": "yes", "answer_id": j} for j in range(10)],
                    "answer_type": "other",
                }
                ids.append(qid)
            splits[key][task] = ids
    for split in ("train", "val"):
        with open(os.path.join(root, f"{split}_annotations.json"), "w") as f:
            json.dump(records[split], f)
    for key in ("train", "valid"):
        with open(os.path.join(root, "contvqa", "tiny", f"{key}_question_ids.json"), "w") as f:
            json.dump(splits[key], f)
    return tcfg.TrainConfig(
        output_dir=os.path.join(root, "out"), data_dir=root, question_task_ids=os.path.join(root, "contvqa"),
        exp="tiny", tasks=list(tasks), train_img_dirs=["unused"], val_img_dirs=["unused"],
        batch_size=4, val_batch_size=4, accumulate_grad_batches=1, epochs=[1, 1], max_txt_len=24,
        n_workers=2, val_num_workers=2, learning_rate=1e-3, optim="adamw", weight_decay=0.01,
        text_pad_multiple=8, mesh_shape=[1, 1], log_every=1, seed=42, allow_tokenizer_fallback=True,
    )


# ---------------------------------------------------------------------------
# 3xTF32 on the CPU: a plain emulation of the float32 kernels' tensor-core
# products (csrc/flash_attn_f32.cu), for tests only
# ---------------------------------------------------------------------------

def round_to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 `x` rounded to TF32 as `cvt.rna.tf32.f32` rounds it: 10
    mantissa bits, to nearest, ties away from zero (for finite x; the 13 low
    bits of the result are 0). Adding half of the dropped unit to the
    magnitude bits carries on a tie, away from zero whatever the sign."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def truncate_to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 `x` with its 13 low mantissa bits cleared: the TF32 value the
    tensor core reads from a float32 register (truncation toward zero)."""
    return (x.to(torch.float32).contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """(big, small) as the kernels split x: big = x rounded to TF32 as
    cvt.rna rounds it, small = x - big (exact in float32) as the tensor core
    reads it, truncated to TF32."""
    big = round_to_tf32(x)
    return big, truncate_to_tf32(x - big)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b from the kernels' split operands: a_small b_big + a_big b_small +
    a_big b_big, each a float32 matmul of TF32-valued tensors (whose products
    are exact in float32), summed in that order; small x small is dropped.
    The sums are torch's float32 sums, rounded to nearest: the tensor core's
    truncating accumulation is not modelled."""
    a_big, a_small = split_tf32(a)
    b_big, b_small = split_tf32(b)
    return torch.matmul(a_small, b_big) + torch.matmul(a_big, b_small) + torch.matmul(a_big, b_big)


def flash_backward_3xtf32(q, k, v, mask, o, lse, do, causal: bool, scale: float):
    """(dq, dk, dv) of float32 inputs with every product from the float32
    backward kernels' 3xTF32 split: S = Q K^T and dP = dO V^T, P = exp(S scale
    - lse) where kept, dS = P (dP - delta), dV = P^T dO, dK = dS^T Q scale, dQ
    = dS K scale (the port's flash_backward_plain with matmul_3xtf32 for each
    of its five matmuls). It models the operands' rounding, not the kernels'
    accumulation (matmul_3xtf32), so it cannot show the drift of a truncating
    accumulation chain: tests/test_torch_cuda.py bounds that on the card."""
    from mafed_tpu_torch.kernels.attention import _keep

    keep = _keep(mask, causal, q.shape[2], k.shape[2], q.device)
    p = torch.where(keep, torch.exp(matmul_3xtf32(q, k.transpose(-1, -2)) * scale - lse[..., None]), 0.0)
    dv = matmul_3xtf32(p.transpose(-1, -2), do)
    dp = matmul_3xtf32(do, v.transpose(-1, -2))
    delta = (do * o).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    return matmul_3xtf32(ds, k) * scale, matmul_3xtf32(ds.transpose(-1, -2), q) * scale, dv


def flash_forward_3xtf32(q, k, v, mask, causal: bool, scale: float):
    """(o, lse) of float32 inputs with both products from the float32
    forward kernel's 3xTF32 split: S = Q K^T and O = P V / l (the port's
    flash_forward_plain with matmul_3xtf32 for each of its two matmuls, its
    finfo(float32).min fill, keep zeroing and empty rows). The softmax is the
    dense one, not the kernel's online one over 64-key tiles, and the
    accumulation is rounded (matmul_3xtf32)."""
    from mafed_tpu_torch.kernels.attention import _NEG, _keep

    keep = _keep(mask, causal, q.shape[2], k.shape[2], q.device)
    s = torch.where(keep, matmul_3xtf32(q, k.transpose(-1, -2)) * scale, _NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * keep
    l = p.sum(dim=-1)
    empty = l == 0.0
    l_safe = torch.where(empty, torch.ones_like(l), l)
    o = matmul_3xtf32(p, v) / l_safe[..., None]
    lse = torch.where(empty, torch.full_like(l, float("inf")), m[..., 0] + torch.log(l_safe))
    return o, lse
