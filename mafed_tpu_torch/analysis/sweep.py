"""CKA sweep CLI: per-layer average CKA and text/image ratio over a
task-checkpoint directory (counterpart of mafed_tpu/analysis/sweep.py).

For every consecutive pair of task checkpoints of a CL run, the per-layer
linear CKA of text and image token representations on a shared validation
stream, reported as JSON (and optionally a matplotlib plot):

    python -m mafed_tpu_torch.analysis.sweep --experiment_dir storage/out/run1 \\
        [--tasks action count ...] [--probe_task action] [--max_batches 8] \\
        [--output report.json] [--plot cka.png] [--synthetic_images] [--device cpu]

The experiment directory holds log/hps.json, log/model_config.json,
log/task_order.json and ckpt/{task}_best.safetensors, as the port's (and
the JAX package's) ContinualLearningTrainer writes them. The models run on
the card unless --device cpu.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from mafed_tpu_torch.analysis.representation_similarity import cka_between_checkpoints, save_cka_report
from mafed_tpu_torch.core.config import ModelConfig, TrainConfig
from mafed_tpu_torch.core.device import resolve_device
from mafed_tpu_torch.core.logging import LOGGER


def _load_experiment(experiment_dir: str):
    with open(os.path.join(experiment_dir, "log", "hps.json")) as f:
        config = TrainConfig.from_dict(json.load(f))
    mc_path = os.path.join(experiment_dir, "log", "model_config.json")
    model_cfg = ModelConfig.from_json(mc_path) if os.path.exists(mc_path) else ModelConfig()
    with open(os.path.join(experiment_dir, "log", "task_order.json")) as f:
        tasks = json.load(f)["tasks"]
    return config, model_cfg, tasks


def _batches_factory(config: TrainConfig, model_cfg: ModelConfig, task: str, synthetic_images: bool):
    """The validation batch stream of the probe task (the same for every checkpoint)."""
    from mafed_tpu_torch.data.factory import make_val_loader, prepare_val_dataset
    from mafed_tpu_torch.data.tokenizer import build_tokenizer

    tokenizer = build_tokenizer(
        config.tokenizer_name, model_max_length=100, padding_side="left",
        allow_fallback=config.allow_tokenizer_fallback,
    )
    text_len = config.max_txt_len + 4
    dataset = prepare_val_dataset(config, task, tokenizer, model_cfg.vision, synthetic_images)

    def factory():
        return iter(make_val_loader(config, dataset, text_len))

    return factory


def sweep(
    experiment_dir: str,
    tasks: Optional[List[str]] = None,
    max_batches: int = 8,
    probe_task: Optional[str] = None,
    synthetic_images: bool = False,
    device="cuda",
) -> Dict:
    """Per-layer CKA between consecutive task checkpoints, averaged over the pairs."""
    from mafed_tpu_torch.models.vl_pythia import VLPythia
    from mafed_tpu_torch.utils.checkpoint import load_task_checkpoint, task_checkpoint_path

    device = resolve_device(device)
    config, model_cfg, task_order = _load_experiment(experiment_dir)
    tasks = tasks or task_order
    if len(tasks) < 2:
        raise ValueError("need at least two task checkpoints to compare")
    probe_task = probe_task or tasks[0]
    batches_factory = _batches_factory(config, model_cfg, probe_task, synthetic_images)
    # one model on the device, each checkpoint loaded in turn: the decoder in
    # float32 and the frozen tower in bfloat16, as the trainer holds them
    model = VLPythia(model_cfg, device=device)
    model.vision_encoder.to(torch.bfloat16)

    pairs, per_pair = [], []
    for prev, cur in zip(tasks[:-1], tasks[1:]):
        a = load_task_checkpoint(task_checkpoint_path(experiment_dir, prev))
        b = load_task_checkpoint(task_checkpoint_path(experiment_dir, cur))
        LOGGER.info("CKA: %s_best vs %s_best (probe data: %s)", prev, cur, probe_task)
        per_pair.append(cka_between_checkpoints(model, a, b, model_cfg, batches_factory, max_batches))
        pairs.append(f"{prev}->{cur}")

    text = np.asarray([r["text_cka"] for r in per_pair])  # [pairs, layers]
    image = np.asarray([r["image_cka"] for r in per_pair])
    avg_text, avg_image = text.mean(axis=0), image.mean(axis=0)
    return {
        "experiment_dir": experiment_dir,
        "probe_task": probe_task,
        "pairs": pairs,
        "layers": list(per_pair[0]["layers"]),
        "per_pair": per_pair,
        "avg_text_cka": avg_text.tolist(),
        "avg_image_cka": avg_image.tolist(),
        "avg_ti_ratio": (avg_text / np.maximum(avg_image, 1e-12)).tolist(),
    }


def maybe_plot(result: Dict, path: str) -> bool:
    """A PNG of the averaged curves, where matplotlib is installed (it is optional)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        LOGGER.warning("matplotlib unavailable; skipping plot")
        return False
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.plot(result["layers"], result["avg_text_cka"], marker="o", label="text CKA")
    ax.plot(result["layers"], result["avg_image_cka"], marker="s", label="image CKA")
    ax.set_xlabel("layer")
    ax.set_ylabel("avg CKA (consecutive task ckpts)")
    ax.set_ylim(0, 1.05)
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return True


def main(argv=None) -> Dict:
    parser = argparse.ArgumentParser(description="Per-layer CKA between consecutive task checkpoints of a CL run")
    parser.add_argument("--experiment_dir", required=True)
    parser.add_argument("--tasks", nargs="*", default=None)
    parser.add_argument("--probe_task", default=None)
    parser.add_argument("--max_batches", type=int, default=8)
    parser.add_argument("--output", default=None, help="report JSON path (default: <experiment_dir>/log/cka_report.json)")
    parser.add_argument("--plot", default=None, help="optional PNG path")
    parser.add_argument("--synthetic_images", action="store_true")
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    result = sweep(args.experiment_dir, tasks=args.tasks, max_batches=args.max_batches, probe_task=args.probe_task,
                   synthetic_images=args.synthetic_images, device=args.device)
    out = args.output or os.path.join(args.experiment_dir, "log", "cka_report.json")
    save_cka_report(result, out)
    LOGGER.info("CKA report written to %s", out)
    if args.plot:
        maybe_plot(result, args.plot)
    return result


if __name__ == "__main__":
    main()
