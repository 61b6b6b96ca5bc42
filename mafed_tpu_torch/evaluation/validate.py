"""Generative VQA validation loop (counterpart of
mafed_tpu/evaluation/validate.py).

Greedy generation of up to 10 tokens, the decoded answers scored with the
VQA-v2 soft metric; returns valid/acc, valid/ex_per_s, valid/n_ex and the
per-question results. A short last batch is padded to the batch size by
repeating its last row, and the padding rows are dropped before scoring.
Batches are a loader's: numpy arrays, and cached features as a bfloat16
tensor; a batch of device vision-table rows ("patch_idx") goes through the
`resolve` hook (the runner's `resolve_tables`), which gathers its features on
the card. Over several ranks each scores its slice of the examples (the
loader's shard) and the metric states are summed, so every rank returns the
score of the whole set; the per-question results stay the rank's own.

A tensor-parallel model (core/mesh.py) is gathered first
(`gather_to_replicated`, every rank joins), and each rank decodes its rows
on the full copy: the val loaders split the rows over every rank, so the
sum over the ranks counts each row once. The JAX package's
`localize_params`, which re-places a global tree on one process's devices,
has no counterpart: a rank drives one device, and the gathered copy is
already on it.
"""

from __future__ import annotations

import logging
import time
from collections import Counter
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from mafed_tpu_torch.core.dist import process_reduce_sum
from mafed_tpu_torch.core.mesh import gather_state_dict
from mafed_tpu_torch.data.prefetch import as_tensor
from mafed_tpu_torch.evaluation.vqa_metrics import VQAGenerativeAccuracy, normalize_answer, vqa_v2_score

LOGGER = logging.getLogger(__name__)

_DECODE_KEYS = ("input_ids", "attention_mask", "pixels", "patches", "patch_idx")


def gather_to_replicated(model):
    """A full copy of a tensor-parallel VLPythia, or `model` itself when it
    is not split. Collective: every rank of the model group calls it
    together. The copy is a new module of the full shapes and no gradient;
    its replicated tensors and its frozen tower are `model`'s own (shared,
    not copied), its split ones gathered."""
    tp = getattr(model, "tp", None)
    if tp is None:
        return model
    own = {k: v for k, v in model.state_dict().items() if not k.startswith("vision_encoder.")}
    full = type(model)(model.cfg, device="meta")
    full.vision_encoder = model.vision_encoder
    missing, unexpected = full.load_state_dict(gather_state_dict(own, tp), strict=False, assign=True)
    if unexpected or any(not k.startswith("vision_encoder.") for k in missing):
        raise RuntimeError(f"gathered state_dict: missing {missing}, unexpected {unexpected}")
    return full.requires_grad_(False)


def _pad_batch(batch: Dict, batch_size: int) -> Tuple[Dict, int]:
    n = batch["input_ids"].shape[0]
    if n == batch_size:
        return batch, n
    out = dict(batch)
    for k in _DECODE_KEYS:
        if k in batch:
            v = batch[k]
            if isinstance(v, torch.Tensor):
                out[k] = torch.cat([v, v[-1:].expand((batch_size - n,) + tuple(v.shape[1:]))])
            else:
                out[k] = np.concatenate([v, np.repeat(v[-1:], batch_size - n, axis=0)], axis=0)
    return out, n


def validate_vqa(
    model,
    decoder: Callable,
    val_loader,
    tokenizer,
    batch_size: int,
    max_batches: Optional[int] = None,
    resolve: Optional[Callable] = None,
) -> Tuple[Dict, Dict]:
    """Generative VQA eval of `model` with `decoder` (make_greedy_decoder)
    over a loader of numpy batches ("input_ids", "attention_mask", "pixels",
    "patches" or "patch_idx", "answers", "qids"); `resolve` maps a decode
    batch's table rows to features.

    The decode of batch i+1 is enqueued on the device before batch i's tokens
    are copied to the host and scored, so the tokenizer and the metric run
    while the card decodes. A tensor-parallel `model` is gathered first
    (every rank calls this together)."""
    model = gather_to_replicated(model)
    start = time.time()
    results: Dict = {}
    metric = VQAGenerativeAccuracy()

    def score(toks_dev, batch, n_valid):
        toks = toks_dev.cpu().numpy()[:n_valid]  # the host waits here, for this batch only
        predictions = tokenizer.batch_decode(toks, skip_special_tokens=True)
        answers = batch["answers"][:n_valid]
        metric(predictions, answers)
        for qid, pred, gts in zip(batch["qids"][:n_valid], predictions, answers):
            pred_norm = normalize_answer(pred)
            results[qid] = {"answer": pred_norm, "acc": vqa_v2_score(Counter(gts).get(pred_norm, 0))}

    pending = None
    for i, batch in enumerate(val_loader):
        if max_batches is not None and i >= max_batches:
            break
        padded, n_valid = _pad_batch(batch, batch_size)
        dec_batch = {k: as_tensor(padded[k]) for k in _DECODE_KEYS if k in padded}
        if resolve is not None:
            dec_batch = resolve(dec_batch)
        toks_dev = decoder(model, dec_batch)
        if pending is not None:
            score(*pending)
        pending = (toks_dev, batch, n_valid)
    if pending is not None:
        score(*pending)

    tot_time = max(time.time() - start, 1e-9)
    # ex_per_s is the system's rate: the ranks score their slices over about the same wall time
    score_sum, total = process_reduce_sum(metric.accuracy, float(metric.total))
    n_ex = int(total)
    val_acc = score_sum / max(total, 1.0)
    LOGGER.info("Tested %d samples", n_ex)
    LOGGER.info("validation finished in %d seconds, score: %.2f", int(tot_time), val_acc * 100)
    return {"valid/acc": val_acc, "valid/ex_per_s": n_ex / tot_time, "valid/n_ex": n_ex}, results
