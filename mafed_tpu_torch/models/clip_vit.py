"""CLIP ViT vision tower in PyTorch (counterpart of mafed_tpu/models/clip_vit.py).

The reference takes CLIP backbones besides EVA-02 (build_vision_encoder,
vl_pythia.py:177-201) and selects hidden_states[select_layer] (:463-475).
Semantics are HF's `CLIPVisionModel`:

  * a class embedding, a conv patch embedding with no bias, learned
    absolute position embeddings over 1 + N tokens;
  * `pre_layrnorm`, then pre-LN blocks (q/k/v/out projections with biases,
    a quick_gelu MLP), LayerNorm eps 1e-5 computed in float32;
  * `hidden_states` in HF's order: the embeddings after `pre_layrnorm`,
    then each layer's output, with no post-LN (`post_layernorm` is held for
    the checkpoint but, as in the reference's feature path, not applied).

Module and parameter names are HF's, so under VL-Pythia a CLIP checkpoint's
`vision_encoder.vision_model.*` entries load without a mapping (the names
that mafed_tpu/models/clip_vit.py::convert_hf_state_dict reads). Attention
goes through `kernels.attention.dot_product_attention(causal=False)`, i.e.
the CUDA flash forward kernel on the card (CLIP-L/14-336: 577 tokens, heads
of 64).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from mafed_tpu_torch.core.config import VisionConfig
from mafed_tpu_torch.kernels.attention import dot_product_attention
from mafed_tpu_torch.models.gpt_neox import dense, layer_norm

LAYER_NORM_EPS = 1e-5  # HF CLIPVisionConfig's, whatever VisionConfig.layer_norm_eps says (EVA-02's 1e-6)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: VisionConfig, device=None):
        super().__init__()
        d, p = cfg.embed_dim, cfg.patch_size
        self.class_embedding = nn.Parameter(torch.zeros(d, device=device))
        self.patch_embedding = nn.Conv2d(3, d, p, stride=p, bias=False, device=device)
        self.position_embedding = nn.Embedding(cfg.num_patches + 1, d, device=device)


class CLIPAttention(nn.Module):
    def __init__(self, d: int, device=None):
        super().__init__()
        self.k_proj = nn.Linear(d, d, device=device)
        self.v_proj = nn.Linear(d, d, device=device)
        self.q_proj = nn.Linear(d, d, device=device)
        self.out_proj = nn.Linear(d, d, device=device)


class CLIPMLP(nn.Module):
    def __init__(self, d: int, hidden: int, device=None):
        super().__init__()
        self.fc1 = nn.Linear(d, hidden, device=device)
        self.fc2 = nn.Linear(hidden, d, device=device)


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: VisionConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        self.self_attn = CLIPAttention(d, device=device)
        self.layer_norm1 = nn.LayerNorm(d, eps=LAYER_NORM_EPS, device=device)
        self.mlp = CLIPMLP(d, int(d * cfg.mlp_ratio), device=device)
        self.layer_norm2 = nn.LayerNorm(d, eps=LAYER_NORM_EPS, device=device)

    def forward(self, h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        cfg = self.cfg
        b, t, d = h.shape
        ln1 = layer_norm(h, self.layer_norm1)
        q, k, v = (
            dense(ln1, proj, dtype).view(b, t, cfg.num_heads, cfg.head_dim).transpose(1, 2)
            for proj in (self.self_attn.q_proj, self.self_attn.k_proj, self.self_attn.v_proj)
        )
        attn = dot_product_attention(q, k, v, causal=False, scale=cfg.head_dim ** -0.5)
        h = h + dense(attn.transpose(1, 2).reshape(b, t, d), self.self_attn.out_proj, dtype)
        act = quick_gelu(dense(layer_norm(h, self.layer_norm2), self.mlp.fc1, dtype))
        return h + dense(act, self.mlp.fc2, dtype)


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: VisionConfig, device=None):
        super().__init__()
        self.layers = nn.ModuleList(CLIPEncoderLayer(cfg, device=device) for _ in range(cfg.depth))


class CLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: VisionConfig, device=None):
        super().__init__()
        d = cfg.embed_dim
        self.embeddings = CLIPVisionEmbeddings(cfg, device=device)
        self.pre_layrnorm = nn.LayerNorm(d, eps=LAYER_NORM_EPS, device=device)
        self.encoder = CLIPEncoder(cfg, device=device)
        self.post_layernorm = nn.LayerNorm(d, eps=LAYER_NORM_EPS, device=device)


class CLIPVisionModel(nn.Module):
    """HF names: `vision_model.embeddings.*`, `vision_model.pre_layrnorm`,
    `vision_model.encoder.layers.{i}.*`, `vision_model.post_layernorm`."""

    def __init__(self, cfg: VisionConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.vision_model = CLIPVisionTransformer(cfg, device=device)

    def hidden_states(self, pixel_values: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> List[torch.Tensor]:
        """[B, 3, H, W] -> L + 1 tensors [B, 1 + N, D] in HF's order."""
        vm = self.vision_model
        emb = vm.embeddings
        patches = F.conv2d(pixel_values.to(dtype), emb.patch_embedding.weight.to(dtype),
                           stride=emb.patch_embedding.stride)
        patches = patches.flatten(2).transpose(1, 2)
        b, _, d = patches.shape
        cls = emb.class_embedding.to(dtype).expand(b, 1, d)
        h = torch.cat([cls, patches], dim=1) + emb.position_embedding.weight.to(dtype)
        h = layer_norm(h, vm.pre_layrnorm)
        out = [h]
        for layer in vm.encoder.layers:
            h = layer(h, dtype)
            out.append(h)
        return out

    def forward_hidden_states(self, pixel_values: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        """hidden_states stacked: [L + 1, B, 1 + N, D] (mafed_tpu clip_vit.forward_hidden_states)."""
        return torch.stack(self.hidden_states(pixel_values, dtype))


@torch.no_grad()
def init_weights(tower: CLIPVisionModel, generator: torch.Generator, std: float = 0.02) -> None:
    """As the JAX package's clip_vit.init_params: normal(0, 0.02) for the class
    and position embeddings, the conv and every projection; zero biases; unit
    LayerNorm scales."""
    emb = tower.vision_model.embeddings
    for t in (emb.class_embedding, emb.patch_embedding.weight, emb.position_embedding.weight):
        t.normal_(0.0, std, generator=generator)
    for module in tower.modules():
        if isinstance(module, nn.Linear):
            module.weight.normal_(0.0, std, generator=generator)
            module.bias.zero_()
        elif isinstance(module, nn.LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
