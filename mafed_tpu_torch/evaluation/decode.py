"""Greedy decoding with a KV cache (counterpart of mafed_tpu/evaluation/decode.py).

The reference generates VQA answers with HF greedy search, max_new_tokens=10
and use_cache=False, recomputing the whole 256+T prefix for every token.
Greedy decoding is cache-invariant, so the port, as the JAX package, runs
one prefill over the prefix (the flash forward kernel, causal and
key-padded) that writes the KV cache, then max_new_tokens - 1 single-token
steps against it (the plain masked path).

EOS semantics are HF's: once a row emits EOS, every later position is EOS
(the pad of Pythia), so the decoded text is the same.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from mafed_tpu_torch.constants import MAX_NEW_TOKENS
from mafed_tpu_torch.core.config import ModelConfig
from mafed_tpu_torch.core.device import resolve_device
from mafed_tpu_torch.data.images import make_normalizer, prep_pixels
from mafed_tpu_torch.models import gpt_neox, vl_pythia


def make_greedy_decoder(
    model_cfg: ModelConfig,
    *,
    max_new_tokens: int = MAX_NEW_TOKENS,
    eos_token_id: int = 0,
    dtype=torch.bfloat16,
    device="cuda",
) -> Callable:
    """Returns decode(model, batch) -> [B, max_new_tokens] int32 token ids on `device`.

    batch: "input_ids" and "attention_mask" [B, T] (left-padded), and either
    "patches" [B, N, d_vis] (cached features: the tower is skipped) or
    "pixels" (uint8 NHWC, or float NCHW). Host tensors are copied over from
    pinned memory without a stream sync: decode only enqueues work on the
    card, never waits for it, so a caller can dispatch the next batch before
    reading this one.
    """
    device = resolve_device(device)
    normalize = make_normalizer(model_cfg.vision)

    def to_device(x: torch.Tensor) -> torch.Tensor:
        if device.type == "cuda" and x.device.type == "cpu":
            return x.pin_memory().to(device, non_blocking=True)
        return x.to(device)

    def decode(model: vl_pythia.VLPythia, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        with torch.inference_mode():
            input_ids = to_device(batch["input_ids"])
            attention_mask = to_device(batch["attention_mask"])
            b = input_ids.shape[0]
            patches = batch.get("patches")
            if patches is not None:
                patches, pixel_values = to_device(patches).to(dtype), None
            else:
                pixel_values = prep_pixels({"pixels": to_device(batch["pixels"])}, normalize, dtype)
            inputs_embeds, full_mask = vl_pythia.build_inputs(
                model, input_ids, attention_mask, patches, pixel_values=pixel_values, dtype=dtype
            )
            prefix_len = inputs_embeds.shape[1]  # n_vision_tokens + text
            # key mask over the whole cache buffer: generated positions are always valid
            buf_mask = torch.cat([full_mask, full_mask.new_ones((b, max_new_tokens))], dim=1)
            cache = gpt_neox.KVCache.create(model_cfg, b, prefix_len + max_new_tokens, dtype=dtype, device=device)

            def next_token(embeds):
                out = model.gpt_neox(embeds, attention_mask=buf_mask, cache=cache, dtype=dtype)
                logits = gpt_neox.logits(model.embed_out, out["last_hidden_state"][:, -1], dtype=dtype)
                return torch.argmax(logits.float(), dim=-1).to(torch.int32)

            tok = next_token(inputs_embeds)  # the prefill
            eos = torch.full_like(tok, eos_token_id)
            finished = torch.zeros(b, dtype=torch.bool, device=device)
            emitted = []
            for _ in range(max_new_tokens - 1):
                emit = torch.where(finished, eos, tok)
                tok = next_token(gpt_neox.embed(model.gpt_neox, emit[:, None], dtype=dtype))
                finished = finished | (emit == eos_token_id)
                emitted.append(emit)
            emitted.append(torch.where(finished, eos, tok))
            return torch.stack(emitted, dim=1)

    return decode
