"""Time source variants of the port's flash kernels side by side on one NVIDIA GPU.

    python3 scripts/flash_variants.py VARIANTS.json [--dtype float32] [--out PATH]

VARIANTS.json maps a variant's name to a list of [old, new] text
substitutions applied to mafed_tpu_torch/csrc/flash_attn.cu (the bfloat16
kernels; each variant's library also holds csrc/flash_attn_f32.cu as it
stands, which the script does not time) or, with `--dtype float32`, to
csrc/flash_attn_f32.cu (the float32 kernels, checked and timed at float32
inputs, beside flash_attn.cu as it stands); a first pair ["FILE", path]
starts from another source file instead (for example the parent commit's,
unpacked with `git archive`). `{"base": []}` is the source as it stands.
Every variant is built with nvcc in parallel into its own library and held
against the plain versions (o, dk, dv and dq at chip_smoke's tolerances of
the dtype, lse's empty rows exactly) at every head_dim of CE_SHAPES: those
the kernels are built for (kernels/build.py HEAD_DIMS) and the two wide
head_dims the models run (384 and 512, the wide kernels), each in a small
unaligned case with empty rows, a non-causal 100 x 257 case and its model's
CE shape (410M [48, 16, 336, 64], a decoder at
GPT-NeoX-20B's width [48, 64, 336, 96], 1.4B [48, 16, 336, 128], 1B [48, 8,
336, 256], that width as 16 heads of 384 [48, 16, 336, 384], 1B as 4 heads
of 512 [48, 4, 336, 512]).
A variant that does not build is reported (its nvcc output under
"build_error") and left out of the rest.
A variant whose name starts with "probe" is a deliberately wrong copy
that takes some work out of a kernel, to see what that work costs: its
errors are recorded and it is timed, but it does not stop the run.
Then the forward, dK/dV and dQ kernels are timed at those CE shapes in
turns, three rounds of 50 launches each, so every variant sees the same
card, and in each round SDPA's forward at each CE shape after the variants
(a yardstick: torch's scaled_dot_product_attention with the same boolean
keep mask, as chip_smoke.py times it). Prints one JSON line per variant
(ptxas report, largest errors and times by head_dim) and one for SDPA; with
--out, all of them also go to that file.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (batch, heads) of each head_dim's CE pass: 3 x 16 rows of its model's heads
CE_SHAPES = {64: (48, 16), 96: (48, 64), 128: (48, 16), 256: (48, 8), 384: (48, 16), 512: (48, 4)}


def _build(variants, workdir, varied):
    """Build each variant of build.SOURCES[varied] beside the other source as it stands."""
    from mafed_tpu_torch.kernels import build

    src, fixed = build.SOURCES[varied].read_text(), build.SOURCES[1 - varied]
    for header in build.CSRC.glob("*.cuh"):
        shutil.copy(header, workdir)
    procs = {}
    for name, subs in variants.items():
        text = src
        if subs and subs[0][0] == "FILE":
            text, subs = open(subs[0][1]).read(), subs[1:]
        for old, new in subs:
            if old not in text:
                raise ValueError(f"variant {name}: text not found: {old[:60]!r}")
            text = text.replace(old, new)
        cu = os.path.join(workdir, f"{name}.cu")
        open(cu, "w").write(text)
        sources = [cu, fixed] if varied == 0 else [fixed, cu]
        procs[name] = subprocess.Popen(build.nvcc_command(sources, cu[:-3] + ".so"), stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    return {name: (p.communicate()[0], p.returncode, os.path.join(workdir, f"{name}.so")) for name, p in procs.items()}


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("variants", help="JSON file: {name: [[old, new], ...]}")
    parser.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16",
                        help="vary and time the kernels of this input dtype")
    parser.add_argument("--out", help="also write the results to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    from mafed_tpu_torch.kernels import attention as A
    from mafed_tpu_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    variants = json.load(open(args.variants))
    results = {}
    with tempfile.TemporaryDirectory() as workdir:
        libs = {}
        f32 = args.dtype == "float32"
        torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' float32 products in float32
        dtype = torch.float32 if f32 else torch.bfloat16
        atol, rtol = (chip_smoke.F32_ATOL, chip_smoke.F32_RTOL) if f32 else (chip_smoke.ATOL, chip_smoke.RTOL)
        for name, (log, rc, path) in _build(variants, workdir, int(f32)).items():
            if rc != 0:  # reported, and left out of the checks and the timing
                results[name] = {"card": smi, "dtype": args.dtype, "build_error": log[-3000:]}
                print(f"flash_variants: variant {name} failed to build:\n{log[-3000:]}", file=sys.stderr)
                continue
            lib = ctypes.CDLL(path)
            build._bind(lib)
            libs[name] = lib
            results[name] = {"card": smi, "dtype": args.dtype, "ptxas": build.kernel_resources(log), "max_abs_err": {},
                             "fwd_ms": {}, "dkv_ms": {}, "dq_ms": {}}

        gen = torch.Generator(device="cuda").manual_seed(0)
        # (batch, heads, q_len, kv_len, head_dim, causal, padded keys, all-masked last sample); the last
        # case of each head_dim is its model's CE shape, where the kernels are timed
        cases = []
        for d, (batch, heads) in CE_SHAPES.items():
            cases += [(3, 2, 77, 77, d, True, (0, 3), True), (2, 4, 100, 257, d, False, None, False),
                      (batch, heads, 336, 336, d, True, (256, 276), False)]
        data = []
        for b, h, tq, tk, d, causal, pad, empty in cases:
            q = torch.randn(b, h, tq, d, generator=gen, device="cuda").to(dtype)
            k, v = (torch.randn(b, h, tk, d, generator=gen, device="cuda").to(dtype) for _ in range(2))
            do = torch.randn(b, h, tq, d, generator=gen, device="cuda").to(dtype)
            mask = torch.ones(b, tk, dtype=torch.int32, device="cuda")
            if pad:
                mask[:, pad[0]:pad[1]] = 0
            if empty:
                mask[-1] = 0
            scale = d ** -0.5
            o_p, lse_p = A.flash_forward_plain(q, k, v, mask, causal, scale)
            delta = (do.float() * o_p.float()).sum(-1)
            dq_p, dk_p, dv_p = A.flash_backward_plain(q, k, v, mask, o_p, lse_p, do, causal, scale)
            data.append((q, k, v, do, mask, causal, scale, o_p, lse_p, delta, dq_p, dk_p, dv_p))

        try:
            for name, lib in libs.items():
                A.load_library = lambda lib=lib: lib
                for q, k, v, do, mask, causal, scale, o_p, lse_p, delta, dq_p, dk_p, dv_p in data:
                    o, lse = A.flash_forward(q, k, v, mask, causal, scale)
                    dk, dv = A.flash_bwd_dkv(q, k, v, mask, do, lse_p, delta, causal, scale)
                    dq = A.flash_bwd_dq(q, k, v, mask, do, lse_p, delta, causal, scale)
                    fin = torch.isfinite(lse_p)
                    if not name.startswith("probe"):
                        if not torch.equal(torch.isinf(lse), ~fin):
                            raise AssertionError(f"variant {name}: empty rows differ from the plain version")
                        for label, got, want in (("o", o, o_p), ("dk", dk, dk_p), ("dv", dv, dv_p),
                                                 ("dq", dq, dq_p)):
                            torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol,
                                                       msg=lambda m: f"variant {name}, {label}: {m}")
                    errs = [chip_smoke._err(o, o_p), (lse[fin] - lse_p[fin]).abs().max().item(),
                            chip_smoke._err(dk, dk_p), chip_smoke._err(dv, dv_p), chip_smoke._err(dq, dq_p)]
                    results[name]["max_abs_err"].setdefault(q.shape[-1], []).append(errs)
            sdpa = {"card": smi, "dtype": args.dtype, "fwd_ms": {}}
            for _ in range(3):
                for name, lib in libs.items():
                    A.load_library = lambda lib=lib: lib
                    for q, k, v, do, mask, _, scale, _, lse_p, delta, _, _, _ in data[2::3]:
                        d = q.shape[-1]
                        results[name]["fwd_ms"].setdefault(d, []).append(
                            chip_smoke.time_ms(lambda: A.flash_forward(q, k, v, mask, True, scale), iters=50))
                        results[name]["dkv_ms"].setdefault(d, []).append(chip_smoke.time_ms(
                            lambda: A.flash_bwd_dkv(q, k, v, mask, do, lse_p, delta, True, scale), iters=50))
                        results[name]["dq_ms"].setdefault(d, []).append(chip_smoke.time_ms(
                            lambda: A.flash_bwd_dq(q, k, v, mask, do, lse_p, delta, True, scale), iters=50))
                for q, k, v, _, mask, _, scale, _, _, _, _, _, _ in data[2::3]:
                    t = q.shape[2]
                    keep = torch.ones(t, t, dtype=torch.bool, device="cuda").tril()[None, None] & (
                        mask > 0)[:, None, None, :]
                    sdpa["fwd_ms"].setdefault(q.shape[-1], []).append(chip_smoke.time_ms(
                        lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=keep,
                                                                                 scale=scale), iters=50))
        finally:
            A.load_library = build.load_library
    results["sdpa"] = sdpa
    for name, res in results.items():
        print(json.dumps({"variant": name, **res}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
