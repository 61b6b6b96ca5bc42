"""Disk cache of the frozen vision tower's features (counterpart of
mafed_tpu/data/vision_cache.py).

The EVA-02 tower is frozen and the image transform deterministic, so an
image's patch features (`get_patch_embeddings`: CLS dropped, before the
projector, bf16 [n_patches, d_vis]) never change during a run. They are
computed once per unique image by `prime_vision_cache`, through the port's
tower (its attention through the flash forward kernel on the card), and
training and eval batches then carry them instead of pixels: the tower
leaves every step. The cache directory is stamped with a digest of the
tower's weights in bfloat16 (data/diskcache.py). Several ranks prime one
shared directory together: each miss is computed by its owner rank
(`shard_owner`), and no rank reads the cache before every rank is done.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

from mafed_tpu_torch.core.dist import barrier, process_count, process_index
from mafed_tpu_torch.data.diskcache import ArrayDiskCache, params_fingerprint, set_fingerprint_coordinated, shard_owner
from mafed_tpu_torch.data.images import make_normalizer, prep_pixels
from mafed_tpu_torch.data.prefetch import to_device
from mafed_tpu_torch.models.vl_pythia import get_patch_embeddings


class VisionFeatureCache(ArrayDiskCache):
    def __init__(self, cache_dir: str, n_patches: int, dim: int) -> None:
        super().__init__(cache_dir, (n_patches, dim))
        self.n_patches = n_patches
        self.dim = dim


def leaf_datasets(dataset) -> List:
    """Unwrap ConcatDataset/Subset nesting to the VQADataset leaves."""
    if hasattr(dataset, "datasets"):
        out: List = []
        for d in dataset.datasets:
            out.extend(leaf_datasets(d))
        return out
    if hasattr(dataset, "dataset"):
        return leaf_datasets(dataset.dataset)
    return [dataset]


def vision_fingerprint(model) -> str:
    """The cache stamp of a VLPythia's tower: its floating tensors cast to
    bfloat16 first, so a float32 and a bfloat16 copy of the same weights
    stamp alike."""
    tower = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
             for k, v in model.vision_encoder.state_dict().items()}
    return "vision:" + params_fingerprint(tower)


def prime_vision_cache(cache: VisionFeatureCache, datasets: Iterable, model, batch_size: int = 32,
                       dtype=torch.bfloat16) -> int:
    """Compute and store the features of every uncached unique image of
    `datasets` with `model`'s tower, `batch_size` images a forward (images
    decoded on a thread pool). Over several ranks, each computes the misses
    it owns, then waits for the others. Returns the number of images this
    rank computed; 0 on a warm cache."""
    set_fingerprint_coordinated(cache, vision_fingerprint(model))
    jobs: Dict[str, Tuple] = {}
    for ds in datasets:
        for leaf in leaf_datasets(ds):
            for i in range(len(leaf)):
                key = leaf.image_key(i)
                if key not in jobs and not cache.has(key):
                    jobs[key] = (leaf, i)
    items = [kv for kv in jobs.items() if shard_owner(kv[0], process_count()) == process_index()]
    if items:
        _compute_features(cache, items, model, batch_size, dtype)
    barrier("vision_cache_primed")  # also where this rank owned nothing: no rank reads a half-primed cache
    return len(items)


def _compute_features(cache: VisionFeatureCache, items: List[Tuple[str, Tuple]], model, batch_size: int,
                      dtype) -> None:
    device = next(model.vision_encoder.parameters()).device
    normalize = make_normalizer(model.cfg.vision)
    with ThreadPoolExecutor(max_workers=8) as pool:
        for start in range(0, len(items), batch_size):
            chunk = items[start : start + batch_size]
            pixels = np.stack(list(pool.map(lambda kv: kv[1][0].load_pixels(kv[1][1]), chunk)))
            with torch.inference_mode():
                px = prep_pixels(to_device({"pixels": pixels}, device), normalize, dtype)
                feats = get_patch_embeddings(model, px, dtype=dtype).cpu()
            for (key, _), f in zip(chunk, feats):
                cache.save(key, f)
