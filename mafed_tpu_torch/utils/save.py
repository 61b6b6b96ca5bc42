"""Experiment provenance (copy of mafed_tpu/utils/save.py): log/hps.json (the
resolved config), log/task_order.json and log/git_info.json under the output
directory, and the ckpt/ directory, before training starts."""

from __future__ import annotations

import json
import os
import subprocess
from typing import Optional

from mafed_tpu_torch.core.config import TrainConfig
from mafed_tpu_torch.core.logging import LOGGER


def _git_info(repo_dir: str = ".") -> dict:
    def run(*args):
        try:
            return subprocess.check_output(["git", *args], cwd=repo_dir, stderr=subprocess.DEVNULL).decode().strip()
        except (OSError, subprocess.CalledProcessError):
            return None

    return {
        "commit": run("rev-parse", "HEAD"),
        "branch": run("rev-parse", "--abbrev-ref", "HEAD"),
        "dirty": bool(run("status", "--porcelain")),
    }


def save_configs(config: TrainConfig, output_dir: Optional[str] = None) -> None:
    out = output_dir or config.output_dir
    os.makedirs(os.path.join(out, "ckpt"), exist_ok=True)
    os.makedirs(os.path.join(out, "log"), exist_ok=True)
    with open(os.path.join(out, "log", "hps.json"), "w") as f:
        json.dump(config.to_dict(), f, indent=2, default=str)
    with open(os.path.join(out, "log", "task_order.json"), "w") as f:
        json.dump({"tasks": config.tasks}, f, indent=2)
    with open(os.path.join(out, "log", "git_info.json"), "w") as f:
        json.dump(_git_info(), f, indent=2)
    LOGGER.info("saved experiment configs under %s/log", out)
