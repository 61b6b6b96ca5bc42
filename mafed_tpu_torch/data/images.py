"""Device-side image normalisation (counterpart of mafed_tpu/data/images.py).

Images travel as uint8 NHWC [B, 224, 224, 3] (a quarter of the bytes of
float32) and are normalised on the device, as the first op of the eval
step: float32 arithmetic ((x - 255 * mean) / (255 * std)), NHWC -> NCHW,
then the compute dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from mafed_tpu_torch.core.config import VisionConfig


def make_normalizer(cfg: VisionConfig):
    """uint8 NHWC -> CLIP-normalised NCHW in `dtype`, on the pixels' device.
    The statistics are copied to a device once, on its first call there."""
    stats = {"cpu": tuple(torch.from_numpy(np.asarray(s, np.float32) * 255.0) for s in (cfg.mean, cfg.std))}

    def normalize(pixels_uint8: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
        x = pixels_uint8.float()
        key = str(x.device)
        if key not in stats:
            stats[key] = tuple(s.to(x.device) for s in stats["cpu"])
        mean, std = stats[key]
        return ((x - mean) / std).permute(0, 3, 1, 2).to(dtype)

    return normalize


def prep_pixels(batch, normalize, dtype) -> torch.Tensor:
    """batch["pixels"], uint8 NHWC (wire format) or float NCHW (preprocessed),
    -> NCHW in `dtype`; `normalize` is a `make_normalizer` of the tower's config."""
    pixels = batch["pixels"]
    if pixels.dtype == torch.uint8:
        return normalize(pixels, dtype=dtype)
    return pixels.to(dtype)


def synthetic_image(seed: int, cfg: VisionConfig) -> np.ndarray:
    """Deterministic fake uint8 image [img_size, img_size, 3] for tests and smoke runs."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(cfg.img_size, cfg.img_size, 3), dtype=np.uint8)
