"""The port stands alone: mafed_tpu_torch, chip_smoke.py and the ranks of
the port's multi-process tests (tests/torch_mp_worker.py,
tests/torch_tp_worker.py) import nothing of
JAX and nothing of the JAX package, and its entry points run on CUDA unless
the caller asks for the CPU."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "mafed_tpu_torch"
WORKERS = [ROOT / "tests" / "torch_mp_worker.py", ROOT / "tests" / "torch_tp_worker.py"]
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", *WORKERS]


def _forbidden(name: str) -> bool:
    # exact package match: "mafed_tpu_torch" starts with "mafed_tpu" too
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "mafed_tpu")


def test_forbidden_is_exact():
    assert _forbidden("mafed_tpu.models") and _forbidden("jax.numpy") and _forbidden("mafed_tpu")
    assert not _forbidden("mafed_tpu_torch.models") and not _forbidden("jaxtyping_like")


def test_importing_every_module_loads_no_jax():
    modules = [
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in sorted(PORT.rglob("*.py"))
    ]
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'mafed_tpu'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_multiprocess_modules_load_no_jax():
    """core/dist.py, core/mesh.py and the test ranks' modules with what
    they import (the modules a rank's modes import lazily are the port's,
    held above)."""
    code = (
        "import importlib, sys\n"
        "sys.path.insert(0, 'tests')\n"
        "importlib.import_module('mafed_tpu_torch.core.dist')\n"
        "importlib.import_module('mafed_tpu_torch.core.mesh')\n"
        "importlib.import_module('torch_mp_worker')\n"
        "importlib.import_module('torch_tp_worker')\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'mafed_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_source_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_resolve_device_refuses_missing_gpu():
    from mafed_tpu_torch.core.device import resolve_device

    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="no GPU"):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"
