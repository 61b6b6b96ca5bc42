"""Device-resident vision-feature table (counterpart of
mafed_tpu/data/vision_table.py): the cached patch features of a task held on
the card, gathered by row.

The vision cache takes the frozen tower out of the step, but its features
still go host -> device on every batch, ~0.5 MB an example, for each of the
questions on an image in each epoch. Within a task the image set is fixed,
so the unique features go to the card once per task, the loader ships int32
row indices ("patch_idx", 4 bytes) and the runner gathers the rows on the
card before the step.

Policy (trainer/continual.py `_refresh_vision_table`):
  * per task, all or nothing: the table covers the task's train images and
    every replay-memory image, so every batch a window stacks has one
    structure (a batch of rows and features mixed raises in collate);
  * under a budget (config.device_vision_table_mb): a task whose unique
    images do not fit streams its features instead;
  * swapped only between tasks: memory streams are lazy, so no batch in
    flight can carry rows of a replaced table.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

from mafed_tpu_torch.data.vision_cache import leaf_datasets


def image_key_of(dataset, index: int) -> Optional[str]:
    """The image key of example `index`, through Subset / Concat / view nesting."""
    fn = getattr(dataset, "image_key", None)
    if fn is not None:
        return fn(index)
    if hasattr(dataset, "datasets"):  # ConcatDataset
        offsets = np.cumsum([0] + [len(d) for d in dataset.datasets])
        ds_idx = int(np.searchsorted(offsets, index, side="right") - 1)
        return image_key_of(dataset.datasets[ds_idx], index - int(offsets[ds_idx]))
    if hasattr(dataset, "indices"):  # Subset
        return image_key_of(dataset.dataset, dataset.indices[index])
    if hasattr(dataset, "dataset"):  # a TeacherStateView-style wrapper
        return image_key_of(dataset.dataset, index)
    return None


def iter_image_keys(datasets: Iterable) -> Iterator[str]:
    """Every example's image key across `datasets`, with repeats."""
    for ds in datasets:
        for i in range(len(ds)):
            key = image_key_of(ds, i)
            if key is not None:
                yield key


def _quantize_rows(feats: np.ndarray):
    """Symmetric int8 quantization per (image, patch): q = rint(x / s) with
    s = absmax / 127 over the feature dim (1 where a patch is all zeros)."""
    f32 = feats.astype(np.float32)
    scale = np.abs(f32).max(axis=-1, keepdims=True) / 127.0  # [n, p, 1]
    scale = np.where(scale == 0, 1.0, scale).astype(np.float32)
    q = np.clip(np.rint(f32 / scale), -127, 127).astype(np.int8)
    return q, scale


def gather_rows(table: torch.Tensor, idx) -> torch.Tensor:
    """table[idx] for an index array of any shape, by one index_select on
    the table's device (a host index is copied over first)."""
    if not isinstance(idx, torch.Tensor):
        idx = torch.from_numpy(np.asarray(idx))
    idx = idx.to(table.device, non_blocking=True)
    rows = torch.index_select(table, 0, idx.reshape(-1))
    return rows.view(tuple(idx.shape) + tuple(table.shape[1:]))


class DeviceVisionTable:
    """[n_images, n_patches, dim] features on `device` and their key -> row map.

    Rows are bfloat16 (the default: the same values collate would have
    stacked) or int8 with a float32 scale per (image, patch)
    (vision_table_dtype "int8": about twice the rows per MB of budget, at a
    bounded error). `resolve` turns a batch's "patch_idx" into "patches"
    with one gather on the card; the int8 rows dequantize in the JAX
    package's order: rows to bfloat16, scale to bfloat16, one bfloat16
    multiply. `resolve_host` gathers on the host (teacher-cache priming).
    The JAX package's `resolve_local` and `mesh` serve pods: on one device
    they are `resolve` and no placement."""

    def __init__(self, feats: torch.Tensor, key_to_idx: Dict[str, int], dtype: str = "bfloat16",
                 device="cpu") -> None:
        self.key_to_idx = key_to_idx
        self.dtype = dtype
        self.device = torch.device(device)
        if dtype == "int8":
            q, scale = _quantize_rows(feats.float().numpy())
            self.host = (q, scale)
            self.nbytes = int(q.nbytes + scale.nbytes)
            self.table = (torch.from_numpy(q).to(self.device), torch.from_numpy(scale).to(self.device))
        elif dtype == "bfloat16":
            self.host = feats.to(torch.bfloat16)
            self.nbytes = self.host.numel() * 2
            self.table = self.host.to(self.device)
        else:
            raise ValueError(f"vision_table_dtype must be bfloat16 or int8, got {dtype!r}")

    def __len__(self) -> int:
        return len(self.key_to_idx)

    def index(self, key: str) -> Optional[int]:
        return self.key_to_idx.get(key)

    def resolve(self, batch: Dict) -> Dict:
        if "patch_idx" not in batch:
            return batch
        out = dict(batch)
        idx = out.pop("patch_idx")
        if self.dtype == "int8":
            q, scale = self.table
            out["patches"] = gather_rows(q, idx).to(torch.bfloat16) * gather_rows(scale, idx).to(torch.bfloat16)
        else:
            out["patches"] = gather_rows(self.table, idx)
        return out

    def resolve_host(self, batch: Dict) -> Dict:
        if "patch_idx" not in batch:
            return batch
        out = dict(batch)
        idx = np.asarray(out.pop("patch_idx"))
        if self.dtype == "int8":
            q, scale = self.host
            out["patches"] = torch.from_numpy(q[idx].astype(np.float32) * scale[idx]).to(torch.bfloat16)
        else:
            out["patches"] = self.host[torch.from_numpy(idx.astype(np.int64))]
        return out


def table_nbytes(n_keys: int, n_patches: int, dim: int, dtype: str = "bfloat16") -> int:
    if dtype == "int8":
        return n_keys * n_patches * (dim + 4)  # int8 rows + an f32 scale a patch
    return n_keys * n_patches * dim * 2  # bf16


def build_table(cache, keys: List[str], dtype: str = "bfloat16", device="cpu") -> DeviceVisionTable:
    """The table of `keys` from a primed disk cache (priming comes first, so
    a miss is an error, not a fallback)."""
    if not keys:
        raise ValueError("empty vision table")
    feats = torch.empty((len(keys),) + tuple(cache.expected_shape), dtype=torch.bfloat16)
    for i, k in enumerate(keys):
        arr = cache.load(k)
        if arr is None:
            raise RuntimeError(f"vision table: cache miss for {k!r} (prime first)")
        feats[i] = arr
    return DeviceVisionTable(feats, {k: i for i, k in enumerate(keys)}, dtype=dtype, device=device)


def attach(datasets: Iterable, table: Optional[DeviceVisionTable]) -> List:
    """Set (or clear, with None) the `vision_table` of every leaf dataset;
    returns the leaves touched, so the trainer can detach them later."""
    leaves = []
    for ds in datasets:
        for leaf in leaf_datasets(ds):
            if hasattr(leaf, "image_key"):
                leaf.vision_table = table
                leaves.append(leaf)
    return leaves
