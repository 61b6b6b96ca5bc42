"""Build and load the CUDA kernels of the port.

`load_library()` compiles `csrc/flash_attn.cu` (which includes
`csrc/sm90.cuh`) with nvcc for sm_90a into a shared library with a plain C
interface under `mafed_tpu_torch/_build/`, keyed by a hash of every file under
`csrc/`, and binds it with ctypes. Nothing is built when this module is
imported: the first launch builds. The library does not link `libcuda`: the
one libcuda call it needs (`cuTensorMapEncodeTiled`) is looked up through the
CUDA runtime.

`kernel_resources()` reads the build's `-Xptxas -v` output (registers and
spill bytes) and `sass_counts()` counts instructions in the built library's
SASS (`cuobjdump -sass`). Both key their results by instantiation, kernel
and head_dim (`flash_fwd_kernel<256>`), read from the first template
argument of the mangled name (`...flash_fwd_kernelILi256E...`), so every
head_dim of a kernel is reported, and checked, on its own. The wide kernels,
which take every multiple of 128 from 384 on as a runtime argument, are
keyed by their template argument, the width of the output slice of one CTA
(`flash_fwd_wide_kernel<128>`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCE = CSRC / "flash_attn.cu"
BUILD_DIR = _PKG / "_build"
KERNELS = ("flash_fwd_kernel", "flash_bwd_dkv_kernel", "flash_bwd_dq_kernel")
HEAD_DIMS = (64, 96, 128, 256)  # the head_dims the library instantiates a kernel for
# the kernels of every multiple of 128 from 384 on, built at one output slice width (flash_attn.cu
# WIDE_SLICE)
WIDE_KERNELS = ("flash_fwd_wide_kernel", "flash_bwd_dkv_wide_kernel", "flash_bwd_dq_wide_kernel")
WIDE_SLICE = 128


def wide_head_dim(head_dim: int) -> bool:
    """Whether the wide kernels take `head_dim` (384, 512, 640, ...)."""
    return head_dim >= 384 and head_dim % 128 == 0


def takes_head_dim(head_dim: int) -> bool:
    """Whether the launchers take `head_dim`; they refuse any other."""
    return head_dim in HEAD_DIMS or wide_head_dim(head_dim)


def instantiation(kernel: str, head_dim: int) -> str:
    return f"{kernel}<{head_dim}>"


INSTANTIATIONS = (tuple(instantiation(k, d) for k in KERNELS for d in HEAD_DIMS)
                  + tuple(instantiation(k, WIDE_SLICE) for k in WIDE_KERNELS))

_lib: Optional[ctypes.CDLL] = None


def _cuda_tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    default = f"/usr/local/cuda/bin/{name}"
    if os.path.exists(default):
        return default
    raise RuntimeError(f"{name} not found: the CUDA kernels need the CUDA toolkit to build")


def library_path() -> Path:
    digest = hashlib.sha256()
    for path in sorted(CSRC.iterdir()):
        if path.is_file():
            digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"libflash_attn_{digest.hexdigest()[:16]}.so"


def build_log() -> str:
    """nvcc's output (with `-Xptxas -v`) of the build of the current sources; empty before it."""
    path = library_path().with_suffix(".log")
    return path.read_text() if path.exists() else ""


def nvcc_command(source: Path, out: Path) -> list:
    """nvcc's command line that builds `source` into the shared library `out`."""
    return [
        _cuda_tool("nvcc"), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(out), str(source),
    ]


def _compile(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(nvcc_command(SOURCE, tmp), capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)  # atomic: a concurrent loader sees the whole library or none


def _bind(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attn_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, f, p]
    lib.flash_attn_bwd_dkv.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, f, p]
    lib.flash_attn_bwd_dq.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, f, p]
    for fn in (lib.flash_attn_fwd, lib.flash_attn_bwd_dkv, lib.flash_attn_bwd_dq):
        fn.restype = ctypes.c_int


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib
    if _lib is None:
        path = library_path()
        if not path.exists():
            _compile(path)
        lib = ctypes.CDLL(str(path))
        _bind(lib)
        _lib = lib
    return _lib


def _kernel_of(mangled: str) -> Optional[str]:
    """The instantiation (`flash_fwd_kernel<256>`) that a mangled name is of, or None."""
    for kernel in KERNELS + WIDE_KERNELS:
        found = re.search(rf"{kernel}ILi(\d+)E", mangled)
        if found:
            return instantiation(kernel, int(found.group(1)))
    return None


def kernel_resources(log: str) -> Dict[str, Dict[str, int]]:
    """{instantiation: {"registers", "spill_store_bytes", "spill_load_bytes"}} from `-Xptxas -v` output."""
    out: Dict[str, Dict[str, int]] = {}
    current = None
    for line in log.splitlines():
        entry = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if entry:
            current = _kernel_of(entry.group(1))
            continue
        if current is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            out.setdefault(current, {})["spill_store_bytes"] = int(spill.group(1))
            out[current]["spill_load_bytes"] = int(spill.group(2))
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            out.setdefault(current, {})["registers"] = int(regs.group(1))
    return out


def sass_counts() -> Optional[Dict[str, Dict[str, int]]]:
    """{instantiation: {"HGMMA": n, "UTMALDG": n}} (wgmma and TMA-load
    instructions) in the built library's SASS, or None without cuobjdump."""
    try:
        tool = _cuda_tool("cuobjdump")
    except RuntimeError:
        return None
    sass = subprocess.run([tool, "-sass", str(library_path())], capture_output=True, text=True, check=True).stdout
    return parse_sass(sass)


def parse_sass(sass: str) -> Dict[str, Dict[str, int]]:
    """{instantiation: {"HGMMA": n, "UTMALDG": n}} from `cuobjdump -sass` output."""
    opcodes = ("HGMMA", "UTMALDG")
    out: Dict[str, Dict[str, int]] = {}
    current = None
    for line in sass.splitlines():
        func = re.search(r"Function : (\S+)", line)
        if func:
            current = _kernel_of(func.group(1))
            if current is not None:
                out[current] = {op: 0 for op in opcodes}
            continue
        if current is not None:
            for op in opcodes:
                if re.search(rf"\b{op}\b", line):
                    out[current][op] += 1
    return out
