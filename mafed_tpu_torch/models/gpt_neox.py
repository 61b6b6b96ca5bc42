"""GPT-NeoX (Pythia) decoder in PyTorch (counterpart of mafed_tpu/models/gpt_neox.py).

Numerics follow the JAX decoder, which follows HF's GPTNeoXModel: layernorm
in float32, partial rotary with the rotate-half convention, biased QKV in
HF's per-head fused layout, parallel residual, exact GELU, untied
`embed_out`. Parameters stay in their own dtype (float32 for training) and
each product casts them to the compute dtype, as the JAX package does.
Attention goes through `kernels.attention.dot_product_attention`, i.e. the
CUDA flash kernels on the card.

Module and parameter names are HF's (`layers.{i}.attention.query_key_value`,
...), so a reference checkpoint's state_dict loads without a mapping.

With a `KVCache` (greedy decode) the prefill (empty cache) attends over its
own positions through the flash kernel, causal and key-padded; later calls
(single-token steps) attend over the whole buffer on the plain masked path,
the counterpart of the JAX package's `xla_attention`.

Under tensor parallelism (models/tensor_parallel.py) a layer holds its
rank's heads and its slice of the MLP (`tp`, the model group): the LN
outputs enter the column-parallel products through
`copy_to_model_group`; the parallel residual adds the rank's two
row-parallel partial products (attention out, MLP down) and sums them over
the group once, then adds both biases (one reduction a layer in the
forward, as EleutherAI's GPT-NeoX does; without the parallel residual each
product is summed before its bias, two). The flash kernels run on the
rank's heads. The KV-cache decode runs on a
gathered full copy (evaluation/validate.gather_to_replicated).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from mafed_tpu_torch.core.config import ModelConfig
from mafed_tpu_torch.core.dist import Group
from mafed_tpu_torch.kernels.attention import REMAT_STASH, dot_product_attention
from mafed_tpu_torch.models.tensor_parallel import (
    copy_to_model_group, reduce_from_model_group, vocab_parallel_embedding,
)


@dataclass
class KVCache:
    """Preallocated per-layer k/v buffers [B, H, Tmax, D] and the number of
    positions written so far (a host int: eager PyTorch needs no traced offset)."""

    k: List[torch.Tensor]
    v: List[torch.Tensor]
    length: int = 0

    @classmethod
    def create(cls, cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16, device=None) -> "KVCache":
        shape = (batch, cfg.num_attention_heads, max_len, cfg.head_dim)
        layers = range(cfg.num_hidden_layers)
        return cls(
            [torch.zeros(shape, dtype=dtype, device=device) for _ in layers],
            [torch.zeros(shape, dtype=dtype, device=device) for _ in layers],
        )


class _Stash:
    """What a RematPolicy keeps of one checkpointed layer call: the tagged
    products and the flash forward's (o, lse), in call order. The forward
    records them; the recompute in backward takes them back in the same
    order instead of computing them."""

    def __init__(self, keep: FrozenSet[str]) -> None:
        self.keep = keep
        self.kept: List = []
        self.replay = False

    def value(self, name: str, compute):
        if self.replay:
            kept_name, out = self.kept.pop(0)
            if kept_name != name:
                raise RuntimeError(f"remat recompute asked for {name!r} where the forward kept {kept_name!r}")
            return out
        out = compute()
        # detached: the autograd history the caller gives `out` stays off the kept copy
        self.kept.append((name, tuple(t.detach() for t in out) if isinstance(out, tuple) else out.detach()))
        return out

    def flash(self, compute):
        return self.value("flash", compute) if "flash" in self.keep else compute()


@contextlib.contextmanager
def _stashing(stash: _Stash, replay: bool):
    stash.replay = replay
    token = REMAT_STASH.set(stash)
    try:
        yield
    finally:
        REMAT_STASH.reset(token)


class _KeptProduct(torch.autograd.Function):
    """x @ w_t whose output a stash keeps (a tagged product under a
    RematPolicy). The backward is autograd's own for the matmul of a
    row-major x by a column-major w_t (mm_mat1_backward, mm_mat2_backward),
    so the gradients are those of plain recompute bit for bit."""

    @staticmethod
    def forward(ctx, x, w_t, stash, name):
        ctx.save_for_backward(x, w_t)
        return stash.value(name, lambda: x @ w_t)

    @staticmethod
    def backward(ctx, grad):
        x, w_t = ctx.saved_tensors
        g2 = grad.reshape(-1, grad.shape[-1])
        dx = g2.mm(w_t.t()).view(x.shape)
        dw_t = g2.t().mm(x.reshape(-1, x.shape[-1])).t()
        return dx, dw_t, None, None


@dataclass(frozen=True)
class RematPolicy:
    """A named remat policy (training/step.py resolve_remat_policy): under
    per-layer remat, what a decoder layer keeps between forward and
    backward besides its input; the rest is recomputed in backward.

    `keep` names the products of the layer's projections (the tags of
    `dense`: "qkv", "attn_out", "mlp_up", "mlp_down"), each kept before its
    bias add, which the recompute redoes while it skips the matmul, and
    "flash": the flash forward's (o, lse), so that the backward launches no
    flash forward. Each layer call under torch.utils.checkpoint gets its own
    stash, recorded in the forward and taken back, in order, by the
    recompute (`context_fn`)."""

    keep: FrozenSet[str] = frozenset()

    def context_fn(self):
        stash = _Stash(self.keep)
        return _stashing(stash, replay=False), _stashing(stash, replay=True)


def dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype, name: Optional[str] = None,
          reduce: Optional[Group] = None, bias: bool = True) -> torch.Tensor:
    """x @ W^T + b with the parameters cast to the compute dtype; `name`
    tags the product for a RematPolicy. With `reduce` (a row-parallel
    product's model group), the partial products are summed over it before
    the bias is added; a RematPolicy keeps the rank's partial product.
    bias=False leaves the bias to the caller."""
    w_t = layer.weight.to(dtype).t()
    stash = REMAT_STASH.get() if name is not None else None
    if stash is not None and name in stash.keep:
        out = _KeptProduct.apply(x, w_t, stash, name)
    else:
        out = x @ w_t
    out = reduce_from_model_group(out, reduce)
    if bias and layer.bias is not None:
        out = out + layer.bias.to(dtype)
    return out


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm computed in float32, returned in x's dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    out = (x32 - mean) * torch.rsqrt(var + norm.eps)
    return (out * norm.weight.float() + norm.bias.float()).to(x.dtype)


def rotary_tables(cfg: ModelConfig, positions: torch.Tensor):
    """cos/sin tables for partial rotary. positions: [B, T] -> [B, T, rot]."""
    rot = cfg.rotary_ndims
    exponent = torch.arange(0, rot, 2, dtype=torch.float32, device=positions.device) / rot
    inv_freq = 1.0 / (cfg.rotary_emb_base ** exponent)
    freqs = positions.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rotary(q, k, cos, sin, rot: int):
    """Partial rotary on the first `rot` dims. q/k: [B, H, T, D]; cos/sin [B, T, rot]."""
    cos = cos[:, None].to(q.dtype)
    sin = sin[:, None].to(q.dtype)
    q_rot, q_pass = q[..., :rot], q[..., rot:]
    k_rot, k_pass = k[..., :rot], k[..., rot:]
    q_rot = q_rot * cos + _rotate_half(q_rot) * sin
    k_rot = k_rot * cos + _rotate_half(k_rot) * sin
    return torch.cat([q_rot, q_pass], dim=-1), torch.cat([k_rot, k_pass], dim=-1)


class GPTNeoXAttention(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        h = cfg.hidden_size
        self.query_key_value = nn.Linear(h, 3 * h, device=device)
        self.dense = nn.Linear(h, h, device=device)


class GPTNeoXMLP(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.dense_h_to_4h = nn.Linear(cfg.hidden_size, cfg.intermediate_size, device=device)
        self.dense_4h_to_h = nn.Linear(cfg.intermediate_size, cfg.hidden_size, device=device)


class GPTNeoXLayer(nn.Module):
    tp: Optional[Group] = None  # the model group under tensor parallelism

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.input_layernorm = nn.LayerNorm(h, eps=cfg.layer_norm_eps, device=device)
        self.post_attention_layernorm = nn.LayerNorm(h, eps=cfg.layer_norm_eps, device=device)
        self.attention = GPTNeoXAttention(cfg, device=device)
        self.mlp = GPTNeoXMLP(cfg, device=device)

    def forward(self, h, cos, sin, key_mask: Optional[torch.Tensor], dtype: torch.dtype, kv=None, past: int = 0):
        """kv: this layer's (k, v) cache buffers; the new positions are written
        at `past`. key_mask then spans the whole buffer."""
        cfg, tp = self.cfg, self.tp
        batch, t, _ = h.shape
        head_dim = cfg.head_dim
        x = copy_to_model_group(layer_norm(h, self.input_layernorm), tp)
        qkv = dense(x, self.attention.query_key_value, dtype, "qkv")
        # HF fused layout: [..., heads, 3 * head_dim]; the rank's heads under tensor parallelism
        n_heads = qkv.shape[-1] // (3 * head_dim)
        qkv = qkv.view(batch, t, n_heads, 3 * head_dim)
        q = qkv[..., :head_dim].transpose(1, 2)
        k = qkv[..., head_dim : 2 * head_dim].transpose(1, 2)
        v = qkv[..., 2 * head_dim :].transpose(1, 2)
        q, k = apply_rotary(q, k, cos, sin, cfg.rotary_ndims)
        if kv is None:
            attn = dot_product_attention(q, k, v, key_padding_mask=key_mask, causal=True)
        else:
            ck, cv = kv
            ck[:, :, past : past + t] = k
            cv[:, :, past : past + t] = v
            if past == 0:  # prefill: its own positions, the keys past them are all masked
                attn = dot_product_attention(q, k, v, key_padding_mask=key_mask[:, :t], causal=True)
            else:
                attn = dot_product_attention(q, ck, cv, key_padding_mask=key_mask, causal=True, causal_offset=past)
        attn = attn.transpose(1, 2).reshape(batch, t, n_heads * head_dim)
        # the parallel residual under tensor parallelism sums its two row-parallel
        # partial products first and reduces them once, then adds both biases
        once = tp is not None and cfg.use_parallel_residual
        attn = dense(attn, self.attention.dense, dtype, "attn_out", reduce=None if once else tp, bias=not once)
        if not cfg.use_parallel_residual:
            h = h + attn
        x = copy_to_model_group(layer_norm(h, self.post_attention_layernorm), tp)
        up = dense(x, self.mlp.dense_h_to_4h, dtype, "mlp_up")
        down = dense(F.gelu(up), self.mlp.dense_4h_to_h, dtype, "mlp_down", reduce=None if once else tp,
                     bias=not once)
        if once:
            out = reduce_from_model_group(attn + down, tp)
            return h + (out + self.attention.dense.bias.to(dtype) + self.mlp.dense_4h_to_h.bias.to(dtype))
        if cfg.use_parallel_residual:
            return h + attn + down
        return h + down


class GPTNeoXModel(nn.Module):
    tp: Optional[Group] = None  # the model group under tensor parallelism

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed_in = nn.Embedding(cfg.vocab_size, cfg.hidden_size, device=device)
        self.layers = nn.ModuleList(GPTNeoXLayer(cfg, device=device) for _ in range(cfg.num_hidden_layers))
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, device=device)

    def forward(
        self,
        inputs_embeds: torch.Tensor,
        *,
        attention_mask: Optional[torch.Tensor] = None,
        output_hidden_states: bool = False,
        dtype: torch.dtype = torch.bfloat16,
        num_layers: Optional[int] = None,
        remat: bool = False,
        remat_policy: Optional[RematPolicy] = None,
        cache: Optional[KVCache] = None,
        layer_perturbation: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        """Run the decoder stack over precomputed input embeddings.

        Returns {"last_hidden_state", "hidden_states" (when asked: [L+1, B, T, H],
        the embeddings, the layer outputs, and final_layer_norm(out_L) last)}.

        cache: inputs_embeds holds only the new positions. They sit at
        absolute positions cache.length + arange(T), their k/v are written
        there, attention_mask spans the whole buffer [B, Tmax], and
        cache.length advances by T.

        num_layers: run only the first num_layers blocks; the final layer norm
        is then skipped, so hidden_states are the raw taps hs[0..num_layers]
        and last_hidden_state is the un-normalised carry.

        remat: recompute each layer in backward (torch.utils.checkpoint), so
        only the layer inputs are kept between forward and backward;
        `remat_policy` (a RematPolicy) keeps some of each layer's tensors too.

        layer_perturbation ([L-1, B, T, H], no-cache path only): entry i is
        added to layer i's output, i.e. to hidden_states[i+1]; the last
        layer's output gets none. The gradient of a loss with respect to a
        zero perturbation is its gradient with respect to those hidden
        states (adaptive modality weights).
        """
        cfg = self.cfg
        batch, t, _ = inputs_embeds.shape
        device = inputs_embeds.device
        past = 0 if cache is None else cache.length
        # HF GPTNeoX positions: absolute arange, left padding included
        positions = (past + torch.arange(t, device=device))[None, :].expand(batch, t)
        cos, sin = rotary_tables(cfg, positions)
        key_mask = attention_mask.to(torch.int32) if attention_mask is not None else None
        if cache is not None:
            max_len = cache.k[0].shape[2]
            if past + t > max_len:
                raise ValueError(f"KV cache of {max_len} positions cannot take {t} more after {past}")
            valid = (torch.arange(max_len, device=device) < past + t).to(torch.int32).expand(batch, max_len)
            key_mask = valid if key_mask is None else valid * (key_mask > 0)

        layers: List[GPTNeoXLayer] = list(self.layers)
        truncated = num_layers is not None and num_layers < cfg.num_hidden_layers
        if cache is not None and layer_perturbation is not None:
            raise ValueError("layer_perturbation is for the no-cache path")
        if cache is not None and self.tp is not None:
            raise ValueError("the KV-cache decode runs on a gathered copy, not on a tensor-parallel shard")
        if truncated:
            if num_layers < 0:
                raise ValueError(f"num_layers must be >= 0, got {num_layers}")
            if cache is not None or layer_perturbation is not None:
                raise ValueError("num_layers truncation is for the plain forward path")
            layers = layers[:num_layers]

        h = inputs_embeds.to(dtype)
        hs = [h]
        for i, layer in enumerate(layers):
            if cache is not None:
                h = layer(h, cos, sin, key_mask, dtype, (cache.k[i], cache.v[i]), past)
            elif remat and torch.is_grad_enabled():
                kw = {} if remat_policy is None else {"context_fn": remat_policy.context_fn}
                h = checkpoint(layer, h, cos, sin, key_mask, dtype, use_reentrant=False, preserve_rng_state=False, **kw)
            else:
                h = layer(h, cos, sin, key_mask, dtype)
            if layer_perturbation is not None and i < len(layers) - 1:
                h = h + layer_perturbation[i].to(h.dtype)
            hs.append(h)
        if cache is not None:
            cache.length = past + t

        if truncated:
            out = {"last_hidden_state": h}
            if output_hidden_states:
                out["hidden_states"] = torch.stack(hs)
            return out
        last = layer_norm(h, self.final_layer_norm)
        out = {"last_hidden_state": last}
        if output_hidden_states:
            out["hidden_states"] = torch.stack(hs[:-1] + [last])
        return out


def logits(embed_out: nn.Linear, hidden: torch.Tensor, dtype: torch.dtype = torch.bfloat16,
           tp: Optional[Group] = None) -> torch.Tensor:
    """embed_out projection (untied); under tensor parallelism (`tp`), the
    logits of this rank's rows of the vocabulary."""
    return copy_to_model_group(hidden.to(dtype), tp) @ embed_out.weight.to(dtype).t()


def embed(model: GPTNeoXModel, input_ids: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    # gather, then cast: the same values as casting the table first
    if model.tp is not None:
        return vocab_parallel_embedding(input_ids, model.embed_in.weight, model.tp).to(dtype)
    return F.embedding(input_ids.long(), model.embed_in.weight).to(dtype)
