"""Compare the SASS of the port's kernels with another tree's, instantiation by instantiation.

    python3 scripts/compare_sass.py OTHER_ROOT [--out PATH]

Builds the kernel library of this tree and of OTHER_ROOT (for example the
parent commit, unpacked with `git archive` into a git-ignored folder) with
the same nvcc command (kernels/build.py `nvcc_command`, each tree's
`mafed_tpu_torch/csrc` sources and headers), dumps both libraries' SASS with
cuobjdump, and says for each instantiation (kernels/build.py INSTANTIATIONS;
`_kernel_of` reads it from the mangled name) whether its SASS is the same
text in both. Two things in the dump follow the whole library rather than
the function: branch labels (`.L_x_12`) are numbered across the library, so
one kernel more or fewer, or another order of the kernels, renames every
later kernel's labels, and the columns are padded to the library's longest
line. So each function's labels are renumbered in the order they first
appear, runs of blanks made one and empty lines dropped, before the texts
are compared. Prints one
JSON line: {"same": [...], "differ": {instantiation: the first differing
lines, here and there}, "only_here": [...], "only_there": [...]}. Needs
the CUDA toolkit (nvcc, cuobjdump), no GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def functions(sass: str) -> dict:
    """{instantiation: its SASS text} of a `cuobjdump -sass` dump."""
    from mafed_tpu_torch.kernels import build

    out, current = {}, None
    for line in sass.splitlines():
        func = re.search(r"Function : (\S+)", line)
        if func:
            current = build._kernel_of(func.group(1))
            if current is not None:
                out[current] = []
            continue
        if line.startswith("Fatbin"):  # the header of the next ELF image: the function has ended
            current = None
        if current is not None:
            out[current].append(line)
    return {k: _normalized(v) for k, v in out.items()}


def _normalized(lines: list) -> list:
    names: dict = {}
    lines = [" ".join(re.sub(r"\.L_x_\d+", lambda m: names.setdefault(m.group(0), f".L_{len(names)}"), line).split())
             for line in lines]
    return [line for line in lines if line]


def first_difference(here: list, there: list, context: int = 3) -> dict:
    """The first line at which two functions' SASS differ, with a few lines after it."""
    i = next((i for i, (a, b) in enumerate(zip(here, there)) if a != b), min(len(here), len(there)))
    return {"line": i, "here": here[i:i + context], "there": there[i:i + context],
            "lines": [len(here), len(there)]}


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("other", help="root of the other tree (its mafed_tpu_torch/csrc is built)")
    parser.add_argument("--out", help="also write the result to this file")
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    from mafed_tpu_torch.kernels import build

    with tempfile.TemporaryDirectory() as workdir:
        procs = {}
        for label, root in (("here", ROOT), ("there", os.path.abspath(args.other))):
            csrc = os.path.join(root, "mafed_tpu_torch", "csrc")
            sources = [os.path.join(csrc, s.name) for s in build.SOURCES]
            lib = os.path.join(workdir, f"{label}.so")
            procs[label] = (subprocess.Popen(build.nvcc_command(sources, lib), stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True), lib)
        dumps = {}
        for label, (proc, lib) in procs.items():
            log = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"{label}: nvcc failed:\n{log[-3000:]}")
            dumps[label] = functions(subprocess.run([build._cuda_tool("cuobjdump"), "-sass", lib],
                                                    capture_output=True, text=True, check=True).stdout)
    here, there = dumps["here"], dumps["there"]
    result = {"same": sorted(k for k in here if k in there and here[k] == there[k]),
              "differ": {k: first_difference(here[k], there[k]) for k in sorted(here)
                         if k in there and here[k] != there[k]},
              "only_here": sorted(set(here) - set(there)), "only_there": sorted(set(there) - set(here))}
    print(json.dumps(result), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
