"""Image pipeline (counterpart of mafed_tpu/data/images.py).

  host:   decode + bicubic short-side resize + center crop -> uint8 [224, 224, 3]
          (`load_and_resize`: the C++ engine of native/, else PIL)
  device: uint8 -> float32, (x - 255 * mean) / (255 * std), NHWC -> NCHW,
          then the compute dtype (`make_normalizer`), as the first op of a step

Images travel as uint8, a quarter of the bytes of float32.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from mafed_tpu_torch.core.config import VisionConfig


def get_image_path(image_dir: str, image_name: str) -> str:
    """Image-db fname -> on-disk path (reference vl_pythia_vqa_dataset.py:15-27)."""
    if image_name.startswith("coco"):
        fields = os.path.splitext(image_name)[0].split("_")
        image_path = f"COCO_{fields[1]}_{fields[2]}.jpg"
    elif "abstract" in image_name:
        image_path = f"{image_name.split('.npz')[0]}.png"
    elif "VizWiz" in image_name:
        image_path = f"{image_name.split('.npz')[0]}.jpg"
    else:
        image_path = image_name
    return os.path.join(image_dir, image_path)


def load_and_resize(path: str, cfg: VisionConfig, use_native: bool = True) -> np.ndarray:
    """Decode + bicubic resize of the short side to floor(img_size / crop_pct)
    + center crop -> uint8 HWC.

    As in the JAX package: the C++ image engine (native/engine.py) unless
    `use_native` is False or MAFED_NATIVE_IMAGES is "0"; PIL where the
    engine cannot be built (the reason is logged once, at WARNING) or
    cannot decode the file."""
    if use_native and os.environ.get("MAFED_NATIVE_IMAGES", "1") != "0":
        from mafed_tpu_torch.native.engine import get_engine

        engine = get_engine()
        if engine is not None:
            try:
                return engine.decode(path, cfg.img_size, cfg.crop_pct)
            except OSError:
                pass  # a file the engine cannot read: PIL's turn, as in the JAX package
    try:
        from PIL import Image
    except ImportError as exc:
        raise RuntimeError("load_and_resize needs PIL (pillow) to decode images") from exc
    img = Image.open(path).convert("RGB")
    target = cfg.img_size
    scale_size = int(math.floor(target / cfg.crop_pct))
    w, h = img.size
    short, long = (w, h) if w <= h else (h, w)
    new_long = int(round(long * scale_size / short))
    size = (scale_size, new_long) if w <= h else (new_long, scale_size)
    img = img.resize(size, Image.BICUBIC)
    w, h = img.size
    left, top = (w - target) // 2, (h - target) // 2
    img = img.crop((left, top, left + target, top + target))
    return np.asarray(img, dtype=np.uint8)


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
