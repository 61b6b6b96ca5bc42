"""ctypes binding and on-demand build of the C++ image engine (counterpart of
mafed_tpu/native/engine.py).

`get_engine()` compiles `image_engine.cpp` with g++ against libjpeg and
libpng, with the JAX package's flags, into `mafed_tpu_torch/_build/`, keyed
by a hash of the source (as kernels/build.py keys the flash library), and
loads it once per process. Nothing is built when this module is imported.
Where g++ or the libraries are missing, `get_engine()` returns None and
`failure()` says why; data/images.py then decodes with PIL, as the JAX
package does. `-march=native` lets the compiler contract the bicubic
doubles into FMAs where the host has them, so hold the two packages'
engines against each other on one machine.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from mafed_tpu_torch.core.logging import LOGGER

_PKG = Path(__file__).resolve().parent.parent
SOURCE = Path(__file__).resolve().parent / "image_engine.cpp"
BUILD_DIR = _PKG / "_build"
ENGINE_VERSION = 1

_lock = threading.Lock()
_engine: Optional["NativeImageEngine"] = None
_failure: Optional[str] = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libmafed_data_{digest}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    # the JAX package's flags
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", str(SOURCE), "-o", str(tmp),
           "-ljpeg", "-lpng", "-lpthread"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=240)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}): {proc.stderr.strip()[-2000:]}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees the whole library or none


class NativeImageEngine:
    def __init__(self, lib_path: Path) -> None:
        self._lib = ctypes.CDLL(str(lib_path))
        self._lib.mafed_engine_version.restype = ctypes.c_int
        self._lib.mafed_engine_version.argtypes = []
        self._lib.mafed_decode_file.restype = ctypes.c_int
        self._lib.mafed_decode_file.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
        ]
        version = self._lib.mafed_engine_version()
        if version != ENGINE_VERSION:
            raise RuntimeError(f"image engine version {version}, expected {ENGINE_VERSION}")
        self.path = lib_path

    def decode(self, path: str, target: int, crop_pct: float = 0.9) -> np.ndarray:
        """Decode + bicubic resize of the short side to floor(target / crop_pct)
        + center crop -> uint8 [target, target, 3]; IOError on a file it cannot read."""
        scale_size = int(math.floor(target / crop_pct))
        out = np.empty((target, target, 3), np.uint8)
        rc = self._lib.mafed_decode_file(
            os.fsencode(path), target, scale_size, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        if rc != 0:
            raise IOError(f"native decode failed ({rc}) for {path}")
        return out


def get_engine() -> Optional[NativeImageEngine]:
    """Build (once per source) and load the engine; None, with `failure()`
    set, where it cannot be built or loaded."""
    global _engine, _failure
    if _engine is not None or _failure is not None:
        return _engine
    with _lock:
        if _engine is not None or _failure is not None:
            return _engine
        lib = library_path()
        try:
            if not lib.exists():
                _build(lib)
            _engine = NativeImageEngine(lib)
        except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
            _failure = f"{type(exc).__name__}: {exc}"
            LOGGER.warning("native image engine unavailable, decoding with PIL: %s", _failure)
        else:
            LOGGER.info("native image engine loaded (%s)", lib)
    return _engine


def failure() -> Optional[str]:
    """Why the engine could not be built or loaded (None before a try, or when it loaded)."""
    return _failure


def native_available() -> bool:
    return get_engine() is not None
