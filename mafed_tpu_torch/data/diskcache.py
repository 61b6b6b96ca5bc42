"""Disk cache of fixed-shape bfloat16 arrays (counterpart of
mafed_tpu/data/diskcache.py), with its on-disk format:

  * one .npy per key at {dir}/{sha1(key)[:2]}/{sha1(key)}.npy, holding the
    bfloat16 bit pattern as uint16; written atomically (tmp + os.replace);
  * {dir}/fingerprint.json: a digest of the parameters the entries are a
    function of, and their shape. `set_fingerprint` wipes a directory
    stamped with another digest, so entries computed from other weights are
    never served.

Several ranks share one directory: every file is written to a temporary
name and moved into place with os.replace, `set_fingerprint_coordinated`
lets rank 0 alone wipe a stale directory, and `shard_owner` gives each key
the one rank that computes it.

The bits go through torch.bfloat16 viewed as int16, so no numpy bfloat16
type is needed. An entry of another dtype or shape reads as a miss.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Dict, Optional

import numpy as np
import torch

from mafed_tpu_torch.core.dist import barrier, process_count, process_index

_FINGERPRINT_FILE = "fingerprint.json"


def bf16_to_bits(t: torch.Tensor) -> np.ndarray:
    """A tensor as bfloat16, its bits as a uint16 numpy array (on the host)."""
    return t.detach().to("cpu", torch.bfloat16).contiguous().view(torch.int16).numpy().view(np.uint16)


def bits_to_bf16(bits: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(bits).view(np.int16)).view(torch.bfloat16)


class ArrayDiskCache:
    def __init__(self, cache_dir: str, expected_shape) -> None:
        self.cache_dir = cache_dir
        self.expected_shape = tuple(expected_shape)
        os.makedirs(cache_dir, exist_ok=True)

    def _path(self, key: str) -> str:
        h = hashlib.sha1(key.encode()).hexdigest()
        return os.path.join(self.cache_dir, h[:2], f"{h}.npy")

    def has(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    def load(self, key: str) -> Optional[torch.Tensor]:
        """The entry as a bfloat16 tensor of expected_shape, or None on a
        miss (absent, or another dtype or shape)."""
        try:
            arr = np.load(self._path(key))
        except FileNotFoundError:
            return None
        if arr.dtype != np.uint16 or tuple(arr.shape) != self.expected_shape:
            return None
        return bits_to_bf16(arr)

    def save(self, key: str, t: torch.Tensor) -> None:
        if tuple(t.shape) != self.expected_shape:
            raise ValueError(f"cached array shape {tuple(t.shape)} != {self.expected_shape}")
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp.npy"
        with open(tmp, "wb") as f:
            np.save(f, bf16_to_bits(t))
        os.replace(tmp, path)

    def set_fingerprint(self, fingerprint: str) -> bool:
        """Bind the directory to the parameters its entries come from:
        stamp `fingerprint` (with the entries' shape); a directory with
        another stamp, or entries and no stamp, is wiped first. Returns
        whether it was wiped."""
        fingerprint = f"{fingerprint}|shape={self.expected_shape}"
        stamp_path = os.path.join(self.cache_dir, _FINGERPRINT_FILE)
        current = None
        try:
            with open(stamp_path) as f:
                current = json.load(f).get("fingerprint")
        except (FileNotFoundError, ValueError):
            pass
        wiped = False
        if current != fingerprint:
            has_entries = any(name != _FINGERPRINT_FILE for name in os.listdir(self.cache_dir))
            if current is not None or has_entries:
                shutil.rmtree(self.cache_dir, ignore_errors=True)
                wiped = True
            os.makedirs(self.cache_dir, exist_ok=True)
            tmp = f"{stamp_path}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                json.dump({"fingerprint": fingerprint}, f)
            os.replace(tmp, stamp_path)
        return wiped


def set_fingerprint_coordinated(cache: ArrayDiskCache, fingerprint: str) -> bool:
    """`set_fingerprint` on a directory the ranks share: rank 0 stamps it
    (wiping it if stale), every rank waits, then the others stamp the same
    fingerprint, which wipes nothing. Concurrent wipes could delete a peer's
    new entry between its makedirs and its os.replace."""
    if process_count() == 1:
        return cache.set_fingerprint(fingerprint)
    wiped = cache.set_fingerprint(fingerprint) if process_index() == 0 else False
    barrier(f"diskcache_stamp:{os.path.basename(cache.cache_dir)}")
    if process_index() != 0:
        cache.set_fingerprint(fingerprint)
    return wiped


def shard_owner(key, n_shards: int) -> int:
    """The rank that computes the entry of `key` when the ranks prime a cache
    together: a function of the key alone (the ranks may list different
    misses while a peer's writes land), through sha1, since Python's hash()
    is salted per process; the JAX package's owner of the same key."""
    return int(hashlib.sha1(str(key).encode()).hexdigest()[:8], 16) % n_shards


def params_fingerprint(tensors: Dict[str, torch.Tensor]) -> str:
    """Digest of named tensors: each one's name, shape, dtype, and f32 sum
    and sum of squares (reduced on their device, read back in one copy)."""
    names = list(tensors)
    if not names:
        return hashlib.sha1().hexdigest()
    sums = torch.stack([torch.stack([tensors[n].float().sum(), tensors[n].float().square().sum()])
                        for n in names]).cpu().double().numpy()
    h = hashlib.sha1()
    for n, (s, sq) in zip(names, sums):
        t = tensors[n]
        h.update(f"{n}|{tuple(t.shape)}|{t.dtype}|{s:.6e}|{sq:.6e};".encode())
    return h.hexdigest()
