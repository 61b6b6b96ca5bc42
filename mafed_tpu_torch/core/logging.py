"""Logging and experiment metrics (counterpart of mafed_tpu/core/logging.py).

A global LOGGER with an optional file handler, and MetricsLogger: a JSONL
stream of metric records whose train steps carry a cumulative offset across
tasks (the reference's CLWandbLogger.set_global_step_offset), so curves
concatenate over the task sequence. wandb is used only when asked for and
importable.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, Optional

_LOG_FMT = "%(asctime)s - %(levelname)s - %(name)s -   %(message)s"
_DATE_FMT = "%m/%d/%Y %H:%M:%S"

logging.basicConfig(format=_LOG_FMT, datefmt=_DATE_FMT, level=logging.INFO)
LOGGER = logging.getLogger("mafed_tpu_torch")


def add_log_to_file(log_path: str) -> None:
    """Attach a file handler to the global logger."""
    os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)
    fh = logging.FileHandler(log_path)
    fh.setFormatter(logging.Formatter(_LOG_FMT, datefmt=_DATE_FMT))
    LOGGER.addHandler(fh)


class MetricsLogger:
    """Appends one JSON record per log_metrics call to
    {output_dir}/metrics.jsonl: the metrics, "_step" (the step plus the
    offset, or the bare step for validation records) and "_time"."""

    def __init__(
        self,
        project: str = "mafed-tpu",
        entity: Optional[str] = None,
        group: Optional[str] = None,
        name: Optional[str] = None,
        output_dir: str = ".",
        use_wandb: bool = False,
    ) -> None:
        self._offset = 0
        self._jsonl_path = os.path.join(output_dir, "metrics.jsonl")
        os.makedirs(output_dir, exist_ok=True)
        self._wandb = None
        if use_wandb:
            try:
                import wandb  # type: ignore

                run = wandb.init(project=project, entity=entity, group=group, name=name)
            except Exception as exc:  # no package, no network, no login: the JSONL stream goes on alone
                LOGGER.warning("wandb unavailable (%s); logging to %s", exc, self._jsonl_path)
            else:
                # train metrics plot against the offset global step; the CL
                # summary metrics (validation/*) against the task index
                run.define_metric("trainer/global_step")
                run.define_metric("*", step_metric="trainer/global_step", step_sync=True)
                run.define_metric("validation/*", step_metric="trainer/valid_step", step_sync=True)
                self._wandb = run

    def set_global_step_offset(self, offset: int) -> None:
        self._offset = int(offset)

    @property
    def global_step_offset(self) -> int:
        return self._offset

    def log_metrics(self, metrics: Dict[str, Any], step: Optional[int] = None, is_valid_step: bool = False) -> None:
        record = {k: (float(v) if hasattr(v, "__float__") else v) for k, v in metrics.items()}
        logical_step = None if step is None else int(step) + (0 if is_valid_step else self._offset)
        record["_step"] = logical_step
        record["_time"] = time.time()
        with open(self._jsonl_path, "a") as f:
            f.write(json.dumps(record) + "\n")
        if self._wandb is not None:
            payload = {k: v for k, v in record.items() if not k.startswith("_")}
            if logical_step is not None:
                payload["trainer/valid_step" if is_valid_step else "trainer/global_step"] = logical_step
            self._wandb.log(payload)

    def finish(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()
