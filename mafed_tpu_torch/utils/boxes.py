"""Box and image-geometry utilities (counterpart of mafed_tpu/utils/boxes.py;
numpy and PIL, no torchvision).

BoxMode conversions (XYXY / XYWH, absolute / relative), a Boxes array
wrapper with area / clip / IoU, bbox quantization into integer bins, image
patchification, and ObjectCenterCrop: the Visual-Genome object-centred
crop of the pretraining dataset (pretrain/dataset.py).
"""

from __future__ import annotations

from enum import IntEnum
from typing import Dict, Sequence, Tuple

import numpy as np


class BoxMode(IntEnum):
    """Box coordinate conventions."""

    XYXY_ABS = 0  # (x0, y0, x1, y1) in absolute pixels
    XYWH_ABS = 1  # (x0, y0, w, h) in absolute pixels
    XYXY_REL = 2  # (x0, y0, x1, y1) in [0, 1] relative coords
    XYWH_REL = 3

    @staticmethod
    def convert(box, from_mode: "BoxMode", to_mode: "BoxMode", image_size: Tuple[int, int] = None):
        """Convert between modes. image_size=(h, w) needed for ABS<->REL."""
        arr = np.asarray(box, np.float64).copy()
        single = arr.ndim == 1
        arr = np.atleast_2d(arr)
        if from_mode == to_mode:
            return arr[0] if single else arr

        def to_xyxy_abs(a, mode):
            a = a.copy()
            if mode in (BoxMode.XYWH_ABS, BoxMode.XYWH_REL):
                a[:, 2] = a[:, 0] + a[:, 2]
                a[:, 3] = a[:, 1] + a[:, 3]
            if mode in (BoxMode.XYXY_REL, BoxMode.XYWH_REL):
                h, w = image_size
                a[:, [0, 2]] *= w
                a[:, [1, 3]] *= h
            return a

        def from_xyxy_abs(a, mode):
            a = a.copy()
            if mode in (BoxMode.XYXY_REL, BoxMode.XYWH_REL):
                h, w = image_size
                a[:, [0, 2]] /= w
                a[:, [1, 3]] /= h
            if mode in (BoxMode.XYWH_ABS, BoxMode.XYWH_REL):
                a[:, 2] = a[:, 2] - a[:, 0]
                a[:, 3] = a[:, 3] - a[:, 1]
            return a

        out = from_xyxy_abs(to_xyxy_abs(arr, from_mode), to_mode)
        return out[0] if single else out


class Boxes:
    """N x 4 XYXY_ABS boxes."""

    def __init__(self, tensor) -> None:
        self.tensor = np.atleast_2d(np.asarray(tensor, np.float64))
        assert self.tensor.shape[-1] == 4

    def __len__(self) -> int:
        return self.tensor.shape[0]

    def area(self) -> np.ndarray:
        b = self.tensor
        return (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])

    def clip(self, image_size: Tuple[int, int]) -> "Boxes":
        h, w = image_size
        b = self.tensor.copy()
        b[:, [0, 2]] = b[:, [0, 2]].clip(0, w)
        b[:, [1, 3]] = b[:, [1, 3]].clip(0, h)
        return Boxes(b)

    def nonempty(self, threshold: float = 0.0) -> np.ndarray:
        b = self.tensor
        return ((b[:, 2] - b[:, 0]) > threshold) & ((b[:, 3] - b[:, 1]) > threshold)


def pairwise_iou(boxes1: Boxes, boxes2: Boxes) -> np.ndarray:
    """IoU matrix [N, M]."""
    a, b = boxes1.tensor, boxes2.tensor
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clip(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = boxes1.area()[:, None] + boxes2.area()[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def quantize_bbox(bbox, image_size: Tuple[int, int], num_bins: int = 1000) -> np.ndarray:
    """Quantize XYXY_ABS boxes into [0, num_bins) integer bins per axis."""
    h, w = image_size
    arr = np.atleast_2d(np.asarray(bbox, np.float64))
    scale = np.array([w, h, w, h], np.float64)
    rel = (arr / scale).clip(0.0, 1.0)
    return np.minimum((rel * num_bins).astype(np.int64), num_bins - 1)


def patchify_image(image: np.ndarray, patch_size: Dict[str, int]) -> np.ndarray:
    """[B, C, H, W] -> [B, n_patches, C*ph*pw], row-major patch order."""
    ph, pw = patch_size["height"], patch_size["width"]
    b, c, h, w = image.shape
    gh, gw = h // ph, w // pw
    x = image[:, :, : gh * ph, : gw * pw]
    x = x.reshape(b, c, gh, ph, gw, pw)
    x = x.transpose(0, 2, 4, 3, 5, 1)  # b, gh, gw, ph, pw, c
    return x.reshape(b, gh * gw, c * ph * pw)


class ObjectCenterCrop:
    """Crop centered on an object bbox, shifted to stay inside the image.

    Same geometry as the reference (boxes.py:477-495): the crop window is
    centered on the bbox center, nudged toward the interior when the center
    is too close to the right/bottom edge, clamped at the top-left.
    """

    def __init__(self, size: Tuple[int, int]) -> None:
        self.size = size  # (height, width)

    def crop_window(self, image_size: Tuple[int, int], bbox: Sequence[float]) -> Tuple[int, int, int, int]:
        image_width, image_height = image_size
        crop_height, crop_width = self.size
        x0, y0, x1, y1 = (float(v) for v in bbox)
        cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
        left = max(cx - crop_width / 2 + min(image_width - cx - crop_width / 2, 0), 0)
        top = max(cy - crop_height / 2 + min(image_height - cy - crop_height / 2, 0), 0)
        return int(round(top)), int(round(left)), crop_height, crop_width

    def __call__(self, img, bbox):
        """img: PIL.Image; returns the cropped (and zero-padded if needed) image."""
        top, left, ch, cw = self.crop_window(img.size, bbox)
        return img.crop((left, top, left + cw, top + ch))
