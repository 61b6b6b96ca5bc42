"""Per-layer text/image representation similarity across task checkpoints
(counterpart of mafed_tpu/analysis/representation_similarity.py).

For each pair of task checkpoints, a shared batch stream runs through both
models with hidden states on; tokens split by modality (the vision prefix
against the attended text) and each layer gets a linear CKA and the
text/image CKA ratio. The features stay on the model's device, and CKA runs
there (analysis/cka.py).

The vision prefix is n_vision_tokens(cfg) long: the JAX package slices it
at vision.num_patches (:36), so with select_feature="cls_patch" its text
slice is one token longer than the text mask, and the boolean index raises.
"""

from __future__ import annotations

import json
from typing import Callable, Dict, Iterable, List

import torch

from mafed_tpu_torch.analysis.cka import feature_space_linear_cka
from mafed_tpu_torch.core.config import ModelConfig
from mafed_tpu_torch.core.logging import LOGGER
from mafed_tpu_torch.data.images import make_normalizer, prep_pixels
from mafed_tpu_torch.data.prefetch import to_device
from mafed_tpu_torch.models import vl_pythia


@torch.no_grad()
def collect_hidden_states(model: vl_pythia.VLPythia, model_cfg: ModelConfig, batches: Iterable[Dict],
                          max_batches: int = 8, dtype: torch.dtype = torch.bfloat16) -> Dict[int, Dict[str, torch.Tensor]]:
    """Run up to `max_batches` batches (uint8 "pixels", "input_ids",
    "attention_mask") through `model` on its device; per layer
    {"text": [n_text_tokens, H], "image": [n_image_tokens, H]} in float32 on
    that device. The batch stream is closed after."""
    device = next(model.parameters()).device
    normalize = make_normalizer(model_cfg.vision)
    n_vis = vl_pythia.n_vision_tokens(model_cfg)
    text: Dict[int, List[torch.Tensor]] = {}
    image: Dict[int, List[torch.Tensor]] = {}
    it = iter(batches)
    try:
        for i, batch in enumerate(it):
            if i >= max_batches:
                break
            batch = to_device({k: batch[k] for k in ("input_ids", "attention_mask", "pixels")}, device)
            out = vl_pythia.forward(
                model, batch["input_ids"], batch["attention_mask"],
                pixel_values=prep_pixels(batch, normalize, dtype),
                output_hidden_states=True, dtype=dtype, need_logits=False,
            )
            hs = out.hidden_states.float()  # [L+1, B, n_vis + T, H]
            text_mask = batch["attention_mask"] > 0
            for layer in range(hs.shape[0]):
                image.setdefault(layer, []).append(hs[layer][:, :n_vis].reshape(-1, hs.shape[-1]))
                text.setdefault(layer, []).append(hs[layer][:, n_vis:][text_mask])
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()
    return {layer: {"text": torch.cat(text[layer]), "image": torch.cat(image[layer])} for layer in text}


def cka_between_checkpoints(model: vl_pythia.VLPythia, state_a: Dict[str, torch.Tensor],
                            state_b: Dict[str, torch.Tensor], model_cfg: ModelConfig,
                            batches_factory: Callable[[], Iterable[Dict]], max_batches: int = 8,
                            dtype: torch.dtype = torch.bfloat16) -> Dict[str, List]:
    """Per-layer linear CKA between two checkpoints (state_dicts loaded in
    turn into `model`) on the same data stream."""
    feats = []
    for state in (state_a, state_b):
        model.load_state_dict(state, strict=True)
        feats.append(collect_hidden_states(model, model_cfg, batches_factory(), max_batches, dtype))
    feats_a, feats_b = feats
    layers = sorted(feats_a)
    text_cka, image_cka, ratio = [], [], []
    for layer in layers:
        t = feature_space_linear_cka(feats_a[layer]["text"], feats_b[layer]["text"])
        i = feature_space_linear_cka(feats_a[layer]["image"], feats_b[layer]["image"])
        text_cka.append(t)
        image_cka.append(i)
        ratio.append(t / (i + 1e-12))
        LOGGER.info("layer %d: text CKA %.4f image CKA %.4f ratio %.3f", layer, t, i, ratio[-1])
    return {"layers": layers, "text_cka": text_cka, "image_cka": image_cka, "ti_ratio": ratio}


def save_cka_report(report: Dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(report, f, indent=2)
