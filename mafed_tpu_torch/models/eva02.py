"""EVA-02 ViT encoder in PyTorch (counterpart of mafed_tpu/models/eva02.py).

The frozen vision tower of every reference experiment, timm's
`eva02_large_patch14_clip_224`:

  * conv patch embed (14x14, stride 14) -> 256 tokens, a prepended CLS, a
    learned absolute pos-embed added to all 257 tokens;
  * 2-D axial rotary embedding (timm's RotaryEmbeddingCat: per-axis bands,
    interleaved rotate, CLS excluded);
  * pre-norm blocks with unfused q/k/v (k has no bias), a sub-LN on the
    attention output before `proj`, a SwiGLU MLP (silu(fc1_g) * fc1_x) with a
    LayerNorm before `fc2`; LN eps 1e-6;
  * a final LayerNorm.

Module and parameter names are timm's, so the reference checkpoint's
`vision_encoder.*` entries load without a mapping. Parameters stay in their
own dtype (bfloat16 for the frozen tower) and each product casts them to the
compute dtype. Attention goes through `kernels.attention.dot_product_attention`
(non-causal, unmasked), i.e. the CUDA flash forward kernel on the card.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mafed_tpu_torch.core.config import VisionConfig
from mafed_tpu_torch.kernels.attention import dot_product_attention
from mafed_tpu_torch.models.gpt_neox import dense, layer_norm


def rope_embed_2d(cfg: VisionConfig) -> np.ndarray:
    """The concatenated [sin | cos] rope table [num_patches, 2 * head_dim].

    timm's build_rotary_pos_embed(in_pixels=False): per spatial axis
    head_dim // 4 bands 1 / temperature^(i / bands) on the integer grid,
    rescaled by rope_ref_feat_side / side when set; sin and cos
    repeat-interleaved by 2. Computed in float64, returned in float32.
    """
    num_bands = cfg.head_dim // 4
    side = cfg.img_size // cfg.patch_size
    bands = 1.0 / (cfg.rope_temperature ** (np.arange(num_bands, dtype=np.float64) / num_bands))
    t = np.arange(side, dtype=np.float64)
    if cfg.rope_ref_feat_side is not None:
        t = t / side * cfg.rope_ref_feat_side
    grid_h, grid_w = np.meshgrid(t, t, indexing="ij")
    pos = np.stack([grid_h, grid_w], axis=-1)[..., None] * bands  # [s, s, 2, bands]
    pos = pos.reshape(side * side, 2 * num_bands)
    sin = np.repeat(np.sin(pos), 2, axis=-1)
    cos = np.repeat(np.cos(pos), 2, axis=-1)
    return np.concatenate([sin, cos], axis=-1).astype(np.float32)


def rot_interleaved(x: torch.Tensor) -> torch.Tensor:
    """timm's rot(): (-x_odd, x_even) stacked and interleaved (not rotate-half)."""
    return torch.stack([-x[..., 1::2], x[..., 0::2]], dim=-1).reshape(x.shape)


def apply_rot_embed_cat(x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """x: [..., N, head_dim]; emb: [N, 2 * head_dim] = [sin | cos] in float32."""
    half = emb.shape[-1] // 2
    sin, cos = emb[..., :half].to(x.dtype), emb[..., half:].to(x.dtype)
    return x * cos + rot_interleaved(x) * sin


class EvaAttention(nn.Module):
    def __init__(self, d: int, eps: float, device=None):
        super().__init__()
        self.q_proj = nn.Linear(d, d, device=device)
        self.k_proj = nn.Linear(d, d, bias=False, device=device)
        self.v_proj = nn.Linear(d, d, device=device)
        self.norm = nn.LayerNorm(d, eps=eps, device=device)  # the inner sub-LN
        self.proj = nn.Linear(d, d, device=device)


class EvaMlp(nn.Module):
    def __init__(self, d: int, hidden: int, eps: float, device=None):
        super().__init__()
        self.fc1_g = nn.Linear(d, hidden, device=device)
        self.fc1_x = nn.Linear(d, hidden, device=device)
        self.norm = nn.LayerNorm(hidden, eps=eps, device=device)
        self.fc2 = nn.Linear(hidden, d, device=device)


class EvaBlock(nn.Module):
    def __init__(self, cfg: VisionConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, eps = cfg.embed_dim, cfg.layer_norm_eps
        self.norm1 = nn.LayerNorm(d, eps=eps, device=device)
        self.attn = EvaAttention(d, eps, device=device)
        self.norm2 = nn.LayerNorm(d, eps=eps, device=device)
        self.mlp = EvaMlp(d, int(d * cfg.mlp_ratio), eps, device=device)

    def forward(self, h: torch.Tensor, rope, n_prefix: int, dtype: torch.dtype) -> torch.Tensor:
        cfg = self.cfg
        b, t, d = h.shape
        ln1 = layer_norm(h, self.norm1)
        q, k, v = (
            dense(ln1, proj, dtype).view(b, t, cfg.num_heads, cfg.head_dim).transpose(1, 2)
            for proj in (self.attn.q_proj, self.attn.k_proj, self.attn.v_proj)
        )
        if rope is not None:
            q = torch.cat([q[:, :, :n_prefix], apply_rot_embed_cat(q[:, :, n_prefix:], rope)], dim=2)
            k = torch.cat([k[:, :, :n_prefix], apply_rot_embed_cat(k[:, :, n_prefix:], rope)], dim=2)
        attn = dot_product_attention(q, k, v, causal=False)
        attn = attn.transpose(1, 2).reshape(b, t, d)
        if cfg.scale_attn_inner:
            attn = layer_norm(attn, self.attn.norm)
        h = h + dense(attn, self.attn.proj, dtype)

        ln2 = layer_norm(h, self.norm2)
        if cfg.swiglu_mlp:
            act = F.silu(dense(ln2, self.mlp.fc1_g, dtype)) * dense(ln2, self.mlp.fc1_x, dtype)
        else:
            act = F.gelu(dense(ln2, self.mlp.fc1_g, dtype))
        if cfg.scale_mlp:
            act = layer_norm(act, self.mlp.norm)
        return h + dense(act, self.mlp.fc2, dtype)


class EVA02(nn.Module):
    """timm names: `patch_embed.proj`, `cls_token`, `pos_embed`, `blocks.{i}.*`, `norm`."""

    def __init__(self, cfg: VisionConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, p = cfg.embed_dim, cfg.patch_size
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, d, p, stride=p, device=device)
        n_tokens = cfg.num_patches + (1 if cfg.class_token else 0)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d, device=device))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_tokens, d, device=device))
        self.blocks = nn.ModuleList(EvaBlock(cfg, device=device) for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps, device=device)
        self._rope: Dict[torch.device, torch.Tensor] = {}  # the rope table, once per device

    def rope(self, device) -> torch.Tensor:
        if device not in self._rope:
            self._rope[device] = torch.from_numpy(rope_embed_2d(self.cfg)).to(device)
        return self._rope[device]

    def patch_embed_tokens(self, pixel_values: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """pixel_values [B, 3, H, W] -> [B, N, D]: the conv, then its bias."""
        proj = self.patch_embed.proj
        out = F.conv2d(pixel_values.to(dtype), proj.weight.to(dtype), stride=proj.stride)
        out = out.flatten(2).transpose(1, 2)
        return out + proj.bias.to(dtype)

    def forward_features(self, pixel_values: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        """[B, 3, H, W] -> [B, 1 + N, D] (CLS first), after the final LayerNorm."""
        cfg = self.cfg
        x = self.patch_embed_tokens(pixel_values, dtype)
        if cfg.class_token:
            cls = self.cls_token.to(dtype).expand(x.shape[0], 1, cfg.embed_dim)
            x = torch.cat([cls, x], dim=1)
        if cfg.use_abs_pos_emb:
            x = x + self.pos_embed.to(dtype)
        rope = self.rope(x.device) if cfg.use_rot_pos_emb else None
        n_prefix = 1 if cfg.class_token else 0
        for block in self.blocks:
            x = block(x, rope, n_prefix, dtype)
        return layer_norm(x, self.norm)


@torch.no_grad()
def init_weights(tower: EVA02, generator: torch.Generator, std: float = 0.02) -> None:
    """timm-style init as in the JAX package: truncated normal(0, 0.02) in
    [-2 std, 2 std] for the projections, the conv, CLS and pos-embed; zero
    biases; unit LayerNorm scales."""
    for module in tower.modules():
        if isinstance(module, (nn.Linear, nn.Conv2d)):
            nn.init.trunc_normal_(module.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, nn.LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
    for t in (tower.cls_token, tower.pos_embed):
        nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=generator)
