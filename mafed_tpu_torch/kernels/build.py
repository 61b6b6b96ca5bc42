"""Build and load the CUDA kernels of the port.

`load_library()` compiles `csrc/flash_attn.cu` (the bfloat16 kernels, which
include `csrc/sm90.cuh`) and `csrc/flash_attn_f32.cu` (the float32 kernels)
with nvcc for sm_90a, one nvcc a source started together, and links them
into one shared library with a plain C interface under
`mafed_tpu_torch/_build/`, keyed by a hash of every file under `csrc/`, and
binds it with ctypes. Nothing is built when this module is
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
keyed by their template argument, the most output columns of one CTA (the
forward's piece of up to 512 columns, `flash_fwd_wide_kernel<512>`; the
dK/dV and dQ kernels' slice of 128, `flash_bwd_dq_wide_kernel<128>`), and
so are the float32 kernels, which take
every head_dim at run time (`flash_bwd_dq_f32_kernel<128>`; the float32
forward one slice of all of head_dim, `flash_fwd_f32_kernel<64>`, `<96>`
and `<128>` at those head_dims and `<512>` above). `route()` names the
entry point, the kernel and the grid's slices of a call; `sass_faults()`
says what an instantiation's SASS lacks: TMA loads and wgmma (HGMMA) for
the bfloat16 kernels; TF32 mma.sync (HMMA ... TF32, the 3xTF32 products),
no other HMMA and no wgmma for the float32 kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCES = (CSRC / "flash_attn.cu", CSRC / "flash_attn_f32.cu")
BUILD_DIR = _PKG / "_build"
KERNELS = ("flash_fwd_kernel", "flash_bwd_dkv_kernel", "flash_bwd_dq_kernel")
HEAD_DIMS = (64, 96, 128, 256)  # the head_dims the library instantiates a kernel for
# the kernels of every multiple of 128 from 384 on: the forward built at its piece of up to
# WIDE_FWD_PIECE output columns a CTA, one warpgroup a 128-column slice of it (flash_attn.cu
# WIDE_FWD_PIECE); dK/dV and dQ at one output slice width a CTA (WIDE_SLICE)
WIDE_KERNELS = ("flash_fwd_wide_kernel", "flash_bwd_dkv_wide_kernel", "flash_bwd_dq_wide_kernel")
WIDE_SLICE = 128
WIDE_FWD_PIECE = 512


def wide_width(kernel: str) -> int:
    """The template argument of a wide kernel: the most output columns of one of its CTAs."""
    return WIDE_FWD_PIECE if kernel == WIDE_KERNELS[0] else WIDE_SLICE
# the float32 kernels, all three in 3xTF32 mma.sync, no wgmma: head_dim at run time, a grid axis over
# output slices of at most F32_SLICE columns (flash_attn_f32.cu SLICE); the forward's slice is all of
# head_dim up to F32_FWD_SLICE (FWD_SLICE): an instantiation at each of F32_FWD_HEAD_DIMS (its slice
# width), and one at F32_FWD_SLICE for every head_dim above
F32_KERNELS = ("flash_fwd_f32_kernel", "flash_bwd_dkv_f32_kernel", "flash_bwd_dq_f32_kernel")
F32_SLICE = 128
F32_FWD_SLICE = 512
F32_FWD_HEAD_DIMS = (64, 96, 128)
# the C entry point of each kernel at bfloat16; the float32 one adds "_f32"
ENTRY_POINTS = {"flash_fwd": "flash_attn_fwd", "flash_bwd_dkv": "flash_attn_bwd_dkv",
                "flash_bwd_dq": "flash_attn_bwd_dq"}
DTYPES = ("bfloat16", "float32")  # the input dtypes the kernels take


def wide_head_dim(head_dim: int) -> bool:
    """Whether the wide kernels take `head_dim` (384, 512, 640, ...)."""
    return head_dim >= 384 and head_dim % 128 == 0


def takes_head_dim(head_dim: int) -> bool:
    """Whether the launchers take `head_dim`; they refuse any other."""
    return head_dim in HEAD_DIMS or wide_head_dim(head_dim)


def instantiation(kernel: str, head_dim: int) -> str:
    return f"{kernel}<{head_dim}>"


BF16_INSTANTIATIONS = (tuple(instantiation(k, d) for k in KERNELS for d in HEAD_DIMS)
                       + tuple(instantiation(k, wide_width(k)) for k in WIDE_KERNELS))
F32_INSTANTIATIONS = (tuple(instantiation(F32_KERNELS[0], w) for w in (*F32_FWD_HEAD_DIMS, F32_FWD_SLICE))
                      + tuple(instantiation(k, F32_SLICE) for k in F32_KERNELS[1:]))
INSTANTIATIONS = BF16_INSTANTIATIONS + F32_INSTANTIATIONS


@dataclass(frozen=True)
class Route:
    """Where a launch goes: the C entry point, the kernel instantiation it
    launches, and the CTAs a tile takes on the grid axis over output columns
    (slices, or the wide forward's pieces)."""
    entry: str
    instantiation: str
    slices: int


def route(name: str, dtype: str, head_dim: int) -> Route:
    """The route of kernel `name` ("flash_fwd", "flash_bwd_dkv",
    "flash_bwd_dq") at input dtype `dtype` ("bfloat16" or "float32") and
    `head_dim`, as the C launchers choose it: at bfloat16 the kernel of that
    head_dim (one CTA a tile) or, from 384 on, the wide kernel: the forward's
    <512> in ceil(head_dim / 512) pieces (one CTA a query tile up to 512
    columns), dK/dV's and dQ's <128> in head_dim / 128 slices; at float32 the
    float32 kernel (ceil(head_dim / 128) slices; the forward all of head_dim
    in one slice up to 512 columns, at its instantiation of head_dim 64, 96
    or 128, else its <512> with ceil(head_dim / 512) slices)."""
    if dtype not in DTYPES:
        raise TypeError(f"the CUDA kernels take {' or '.join(DTYPES)}, not {dtype}")
    if not takes_head_dim(head_dim):
        raise ValueError(f"head_dim {head_dim}: the CUDA kernels take head_dim "
                         f"{', '.join(str(x) for x in HEAD_DIMS)} and every multiple of 128 from 384 on")
    if dtype == "float32":
        width = F32_SLICE
        if name == "flash_fwd":
            width = head_dim if head_dim in F32_FWD_HEAD_DIMS else F32_FWD_SLICE
        return Route(ENTRY_POINTS[name] + "_f32", instantiation(f"{name}_f32_kernel", width), -(-head_dim // width))
    if wide_head_dim(head_dim):
        width = wide_width(f"{name}_wide_kernel")
        return Route(ENTRY_POINTS[name], instantiation(f"{name}_wide_kernel", width), -(-head_dim // width))
    return Route(ENTRY_POINTS[name], instantiation(f"{name}_kernel", head_dim), 1)


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


def nvcc_command(sources, out: Path) -> list:
    """nvcc's command line that builds `sources` into the shared library `out`."""
    return [
        _cuda_tool("nvcc"), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(out), *map(str, sources),
    ]


def object_command(source: Path, out: Path) -> list:
    """nvcc's command line that compiles one source into the object `out` of the shared library."""
    return [
        _cuda_tool("nvcc"), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-c", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(out), str(source),
    ]


def _compile(out: Path) -> None:
    """One nvcc a source, all started together, then one link into `out`."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    objects = [tmp.with_name(f"{tmp.name}.{source.stem}.o") for source in SOURCES]
    try:
        procs = [subprocess.Popen(object_command(source, obj), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for source, obj in zip(SOURCES, objects)]
        log = "".join(proc.communicate()[0] for proc in procs)
        if any(proc.returncode != 0 for proc in procs):
            raise RuntimeError(f"nvcc failed ({[proc.returncode for proc in procs]}):\n{log}")
        link = subprocess.run([_cuda_tool("nvcc"), "-shared", "-o", str(tmp), *map(str, objects)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed to link ({link.returncode}):\n{link.stdout}{link.stderr}")
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)  # atomic: a concurrent loader sees the whole library or none


def _bind(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attn_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, f, p]
    lib.flash_attn_bwd_dkv.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, f, p]
    lib.flash_attn_bwd_dq.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, f, p]
    lib.flash_attn_fwd_f32.argtypes = lib.flash_attn_fwd.argtypes
    lib.flash_attn_bwd_dkv_f32.argtypes = lib.flash_attn_bwd_dkv.argtypes
    lib.flash_attn_bwd_dq_f32.argtypes = lib.flash_attn_bwd_dq.argtypes
    for entry in ENTRY_POINTS.values():
        for fn in (getattr(lib, entry), getattr(lib, entry + "_f32")):
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
    for kernel in KERNELS + WIDE_KERNELS + F32_KERNELS:
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


# wgmma, TMA loads, float32 FMAs, mma.sync of any kind, and mma.sync on TF32 operands (HMMA.1688.F32.TF32)
SASS_OPCODES = ("HGMMA", "UTMALDG", "FFMA", "HMMA", "HMMA.TF32")
_SASS_PATTERNS = {op: rf"\b{op}\b" for op in SASS_OPCODES[:4]}
_SASS_PATTERNS["HMMA.TF32"] = r"\bHMMA\.\S*\bTF32\b"


def sass_counts() -> Optional[Dict[str, Dict[str, int]]]:
    """{instantiation: {opcode: n}} for SASS_OPCODES in the built library's
    SASS, or None without cuobjdump."""
    try:
        tool = _cuda_tool("cuobjdump")
    except RuntimeError:
        return None
    sass = subprocess.run([tool, "-sass", str(library_path())], capture_output=True, text=True, check=True).stdout
    return parse_sass(sass)


def parse_sass(sass: str) -> Dict[str, Dict[str, int]]:
    """{instantiation: {opcode: n}} for SASS_OPCODES from `cuobjdump -sass` output."""
    out: Dict[str, Dict[str, int]] = {}
    current = None
    for line in sass.splitlines():
        func = re.search(r"Function : (\S+)", line)
        if func:
            current = _kernel_of(func.group(1))
            if current is not None:
                out[current] = {op: 0 for op in SASS_OPCODES}
            continue
        if current is not None:
            for op, pattern in _SASS_PATTERNS.items():
                if re.search(pattern, line):
                    out[current][op] += 1
    return out


def sass_fault(kernel: str, counts: Dict[str, int]) -> Optional[str]:
    """What one instantiation's SASS lacks, or None: a bfloat16 kernel needs
    HGMMA and UTMALDG; a float32 kernel HMMA of the TF32 kind only (the
    3xTF32 products) and no HGMMA."""
    if kernel in F32_INSTANTIATIONS:
        ok = counts["HMMA.TF32"] and counts["HMMA"] == counts["HMMA.TF32"] and not counts["HGMMA"]
        need = "HMMA of the TF32 kind only and no HGMMA"
    else:
        ok = counts["HGMMA"] and counts["UTMALDG"]
        need = "HGMMA and UTMALDG"
    return None if ok else f"{kernel}: needs {need}, has {counts}"


def sass_faults(sass: Dict[str, Dict[str, int]]) -> List[str]:
    """What the SASS of each instantiation lacks, as `parse_sass` counts it
    and `sass_fault` judges it, and each instantiation missing from the dump."""
    faults = []
    for kernel in INSTANTIATIONS:
        counts = sass.get(kernel)
        fault = f"{kernel}: not in the SASS" if counts is None else sass_fault(kernel, counts)
        if fault:
            faults.append(fault)
    return faults
