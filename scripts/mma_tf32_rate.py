"""Measure the card's rate for the instruction the float32 flash kernels multiply with, and its float32 FMA rate.

    python3 scripts/mma_tf32_rate.py [--out PATH]

Builds a small CUDA library with nvcc (sm_90a) that holds two loops with no
memory traffic inside them: `mma.sync.aligned.m16n8k8` on TF32 operands
with float32 accumulators (the instruction of the 3xTF32 kernels of
csrc/flash_attn_f32.cu) and float32 FMA on the CUDA cores (the CUDA-core
bound beside theirs). Each warp keeps CHAINS independent accumulators so that
the instruction's latency is hidden; the grid is the card's SMs times 1, 2,
4 and 8 CTAs of 256 threads. Every configuration is timed with CUDA events
over one launch after a warm-up launch; the rate is the operations done
(2 x 16 x 8 x 8 an HMMA, 2 an FMA) over that time. `cuobjdump -sass`
counts the loop's HMMA.1688.F32.TF32 instructions, so that the kernel is
known to issue what it is named for.

Prints the card's name and power limit, then one JSON object: the TFLOP/s
of each configuration and the best of each instruction; with --out, the
object also goes to that file.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHAINS = 8
THREADS = 256
SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>

constexpr int CHAINS = %(chains)d;

__global__ void __launch_bounds__(%(threads)d) hmma_tf32_loop(const uint32_t* in, float* out, int iters) {
  const int lane = threadIdx.x & 31;
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = in[(lane + 7 * i) & 63];
  for (int i = 0; i < 2; ++i) b[i] = in[(lane + 11 * i + 3) & 63];
  float d[CHAINS][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c)
      asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%%0, %%1, %%2, %%3}, {%%4, %%5, %%6, %%7}, "
          "{%%8, %%9}, {%%0, %%1, %%2, %%3};\n"
          : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void __launch_bounds__(%(threads)d) ffma_loop(const uint32_t* in, float* out, int iters) {
  // a in [0.25, 0.75): every chain converges to b / (1 - a)
  const float a = 0.5f * __uint_as_float(in[threadIdx.x & 63]), b = __uint_as_float(in[(threadIdx.x + 5) & 63]);
  float x[CHAINS];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) x[c] = c * b;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) x[c] = fmaf(x[c], a, b);
  }
  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) s += x[c];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int run_loop(int which, const uint32_t* in, float* out, int blocks, int iters) {
  if (which == 0) {
    hmma_tf32_loop<<<blocks, %(threads)d>>>(in, out, iters);
  } else {
    ffma_loop<<<blocks, %(threads)d>>>(in, out, iters);
  }
  return (int)cudaGetLastError();
}
""" % {"chains": CHAINS, "threads": THREADS}


def _build(workdir: str) -> tuple:
    sys.path.insert(0, ROOT)
    from mafed_tpu_torch.kernels import build

    cu, lib = os.path.join(workdir, "rate.cu"), os.path.join(workdir, "rate.so")
    with open(cu, "w") as f:
        f.write(SOURCE)
    proc = subprocess.run(build.nvcc_command([cu], lib), capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    sass = subprocess.run([build._cuda_tool("cuobjdump"), "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    return lib, sass


def _sass_counts(sass: str) -> dict:
    """{kernel: {"HMMA.1688.F32.TF32": n, "FFMA": n}} from `cuobjdump -sass` output."""
    counts, current = {}, None
    for line in sass.splitlines():
        func = re.search(r"Function : (\S+)", line)
        if func:
            current = "hmma_tf32_loop" if "hmma" in func.group(1) else "ffma_loop"
            counts[current] = {"HMMA.1688.F32.TF32": 0, "FFMA": 0}
        elif current is not None:
            counts[current]["HMMA.1688.F32.TF32"] += "HMMA.1688.F32.TF32" in line
            counts[current]["FFMA"] += bool(re.search(r"\bFFMA\b", line))
    return counts


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", help="also write the results to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    results = {"card": smi, "sms": sms, "chains": CHAINS, "threads": THREADS, "tflops": {}}
    with tempfile.TemporaryDirectory() as workdir:
        path, sass = _build(workdir)
        results["sass"] = _sass_counts(sass)
        lib = ctypes.CDLL(path)
        lib.run_loop.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
        gen = torch.Generator().manual_seed(0)
        inputs = torch.rand(64, generator=gen).add_(0.5).view(torch.int32).cuda()
        # (name, which, operations an instruction a warp issues, iterations)
        for name, which, ops, iters in (("hmma_tf32", 0, 2 * 16 * 8 * 8, 20000), ("ffma", 1, 2 * 32, 200000)):
            for per_sm in (1, 2, 4, 8):
                blocks = sms * per_sm
                out = torch.empty(blocks * THREADS, device="cuda")
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                for _ in range(2):  # a warm-up launch, then the timed one
                    start.record()
                    rc = lib.run_loop(which, inputs.data_ptr(), out.data_ptr(), blocks, iters)
                    end.record()
                    if rc != 0:
                        raise RuntimeError(f"{name}: launch failed with CUDA error {rc}")
                torch.cuda.synchronize()
                if not torch.isfinite(out).all():
                    raise RuntimeError(f"{name}: the loop's sums are not finite")
                ms = start.elapsed_time(end)
                warps = blocks * THREADS // 32
                tflops = warps * iters * CHAINS * ops / (ms * 1e-3) / 1e12
                results["tflops"].setdefault(name, {})[f"{per_sm}_ctas_a_sm"] = {"ms": ms, "tflops": tflops}
        for name, by_grid in results["tflops"].items():
            results[f"{name}_best_tflops"] = max(r["tflops"] for r in by_grid.values())
    print(json.dumps(results), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
