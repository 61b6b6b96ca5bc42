"""`{task}_best` checkpoints and the initial checkpoint (counterpart of
mafed_tpu/utils/checkpoint.py).

Weights only, top-1 on a task's generative VQA accuracy, at
``<output_dir>/ckpt/{task}_best<ext>``: a safetensors file whose keys are
the reference's torch names (a VLPythia state_dict) and whose values are
float32, as the JAX package writes them, so each package reads the other's.

A resume bundle's optimizer state (the JAX package saves it with orbax) is
`save_opt_state`'s: the tensors of the OptState / MultiStepsState tuples in
one safetensors file by path ("adam.mu.<param>", ...), and their integer
counters returned for the bundle's fit_state.json, which is written last
(`atomic_json_commit`) and so marks the bundle complete. The JAX package
cannot read these files, and has no need to.

Files on disk hold the whole model and optimizer state under the
reference's names, whatever the layout that wrote them: under tensor
parallelism (core/mesh.py) every rank gathers (`gather_opt_state`, the
runner's `full_trainable`), rank 0 writes, and a load shards what it reads
(`load_opt_state(..., group)`), so a bundle round-trips bit for bit and
loads under any layout.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

from mafed_tpu_torch.core.config import TrainConfig
from mafed_tpu_torch.core.logging import LOGGER
from mafed_tpu_torch.core.mesh import gather_state_dict, shard_state_dict
from mafed_tpu_torch.models.weights import load_safetensors, load_torch_pickle, save_safetensors


def task_checkpoint_path(output_dir: str, task: str, extension: str = ".safetensors") -> str:
    return os.path.join(output_dir, "ckpt", f"{task}_best{extension}")


def save_task_checkpoint(state_dict: Dict[str, torch.Tensor], path: str) -> None:
    """Write a state_dict in safetensors format (whatever the extension),
    every floating tensor as float32."""
    LOGGER.info("saving checkpoint %s", path)
    save_safetensors({k: v.float() if v.is_floating_point() else v for k, v in state_dict.items()}, path)


def load_task_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A {task}_best checkpoint as a state_dict on the CPU: safetensors, or a
    torch pickle (.ckpt / .bin) whose state_dict (a Lightning checkpoint's
    `state_dict` field) has its `model.` prefixes stripped, as the JAX
    package reads it (mafed_tpu/utils/checkpoint.py:87-102). Pickles are read
    with weights_only=True."""
    LOGGER.info("loading checkpoint %s", path)
    if path.endswith(".safetensors"):
        return load_safetensors(path)
    sd = load_torch_pickle(path)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return {k[len("model."):] if k.startswith("model.") else k: v for k, v in sd.items()}


def atomic_json_commit(path: str, meta: Dict[str, Any], **dump_kwargs) -> None:
    """Write a checkpoint's commit marker atomically (a temporary file, then
    os.replace), after every other file of the checkpoint: a kill mid-save
    leaves no marker or a whole one, never a truncated one."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f, **dump_kwargs)
    os.replace(tmp, path)


def _flatten(node, prefix: str, tensors: Dict[str, torch.Tensor], counters: Dict[str, Any]) -> None:
    if isinstance(node, torch.Tensor):
        tensors[prefix] = node
    elif isinstance(node, tuple) and hasattr(node, "_fields"):  # the optimizer's NamedTuples
        for name in node._fields:
            _flatten(getattr(node, name), f"{prefix}.{name}" if prefix else name, tensors, counters)
    elif isinstance(node, dict):
        for name, value in node.items():
            _flatten(value, f"{prefix}.{name}", tensors, counters)
    elif node is None or isinstance(node, int):
        counters[prefix] = node
    else:
        raise TypeError(f"optimizer state leaf {prefix!r} of type {type(node).__name__}")


def _restore(node, prefix: str, tensors: Dict[str, torch.Tensor], counters: Dict[str, Any],
             put=lambda old, new: old.copy_(new)):
    """`node`'s structure with each tensor `put(old, tensors[path])` (by
    default overwritten in place) and its counters taken from `counters`."""
    if isinstance(node, torch.Tensor):
        return put(node, tensors[prefix])
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(_restore(getattr(node, n), f"{prefix}.{n}" if prefix else n, tensors, counters, put)
                            for n in node._fields))
    if isinstance(node, dict):
        return {k: _restore(v, f"{prefix}.{k}", tensors, counters, put) for k, v in node.items()}
    return counters[prefix]


def gather_opt_state(opt_state, group):
    """The optimizer state of the whole model, of which every rank of the
    model group `group` holds its shard (collective); `opt_state` itself
    without a model axis. Moments split like their parameters."""
    if group is None or group.size == 1:
        return opt_state
    tensors: Dict[str, torch.Tensor] = {}
    counters: Dict[str, Any] = {}
    _flatten(opt_state, "", tensors, counters)
    return _restore(opt_state, "", gather_state_dict(tensors, group), counters, put=lambda old, new: new)


def save_opt_state(opt_state, path: str) -> Dict[str, Any]:
    """Write the optimizer state's tensors to `path` (safetensors, their
    dtypes kept); returns its counters, which the caller commits."""
    tensors: Dict[str, torch.Tensor] = {}
    counters: Dict[str, Any] = {}
    _flatten(opt_state, "", tensors, counters)
    save_safetensors(tensors, path)
    return counters


def load_opt_state(template, path: str, counters: Dict[str, Any], group=None):
    """An optimizer state of `template`'s structure, devices and dtypes (a
    fresh `init`), its tensors read from `path` (this rank's shards of them
    under the model group `group`) and its counters from `counters`."""
    return _restore(template, "", shard_state_dict(load_safetensors(path), group), counters)


def get_initialization_checkpoint(config: TrainConfig, task_id: int = 0) -> Optional[str]:
    """The checkpoint that initialises the first task (reference utils/checkpoint.py:32-41)."""
    if task_id != 0:
        return None
    if config.checkpoint is not None:
        return config.checkpoint
    if config.checkpoint_dir is not None:
        return os.path.join(config.checkpoint_dir, f"{config.tasks[0]}_best{config.init_ckpt_extension}")
    return None
