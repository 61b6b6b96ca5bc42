"""Pretrained-model loading in the port against the JAX package.

`load_pretrained` over a model directory in each of the reference's
formats (a single model.safetensors, sharded *.safetensors,
pytorch_model.bin written with torch.save), with and without config.json,
with and without the `gpt_neox.` / `vision_encoder.` prefixes (and
`embed_out.weight` under either name), each equal bit for bit in float32 to
`params_from_jax` of the JAX package's load_pretrained of the same
directory; Lightning `.ckpt` checkpoints (`state_dict`, `model.` prefixes)
against the JAX load_task_checkpoint; pickles that hold more than tensors
refused. Then the pipeline: `python -m mafed_tpu_torch.pretrain_vlpythia`
on a manifest of images from a tiny model directory, and both packages'
continual-learning trainers with its checkpoint-final as --model_name,
starting from the same parameters.
"""

import dataclasses
import json
import os
import pickle

import numpy as np
import pytest
import torch

import jax

from mafed_tpu.models.weights import load_pretrained as jax_load_pretrained
from mafed_tpu.models.weights import params_to_reference_state_dict
from mafed_tpu.trainer.continual import ContinualLearningTrainer as JaxTrainer
from mafed_tpu.utils.checkpoint import load_task_checkpoint as jax_load_checkpoint
from mafed_tpu_torch import pretrain_vlpythia as tcli
from mafed_tpu_torch.models.weights import load_pretrained, load_safetensors, params_from_jax
from mafed_tpu_torch.trainer.continual import ContinualLearningTrainer
from mafed_tpu_torch.trainer.runner import TaskRunner
from mafed_tpu_torch.utils.checkpoint import load_task_checkpoint
from tests.helpers import write_synthetic_vqa as jax_write_synthetic_vqa
from tests.torch_helpers import jax_params, one_torch_thread, tiny_cfgs  # noqa: F401 (a fixture)


def _reference_state_dict(seed=0):
    """(JAX config, port config, the reference-format state_dict as numpy
    float32) of the tiny model."""
    jcfg, tc = tiny_cfgs()
    params = jax.tree.map(np.asarray, jax_params(jcfg, seed=seed))
    sd = params_to_reference_state_dict(params, jcfg)
    return jcfg, tc, {k: np.ascontiguousarray(v, dtype=np.float32) for k, v in sd.items()}


def _bare(name):
    """The names of a file without the prefixes: the decoder's and the
    tower's bare, embed_out inside gpt_neox."""
    if name == "embed_out.weight":
        return "gpt_neox.embed_out.weight"
    for prefix in ("gpt_neox.", "vision_encoder."):
        if name.startswith(prefix):
            return name[len(prefix):]
    return name


def _write_model_dir(root, jcfg, sd, fmt, prefixed, with_config):
    from safetensors.numpy import save_file

    os.makedirs(root, exist_ok=True)
    name = (lambda k: k) if prefixed else _bare
    if fmt == "single":
        save_file({name(k): v for k, v in sd.items()}, os.path.join(root, "model.safetensors"))
    elif fmt == "sharded":
        keys = sorted(sd)
        for i, part in enumerate((keys[: len(keys) // 2], keys[len(keys) // 2:])):
            save_file({name(k): sd[k] for k in part}, os.path.join(root, f"model-0000{i + 1}-of-00002.safetensors"))
    else:  # the tower in bfloat16, as the reference stores its frozen encoder
        torch.save({name(k): torch.from_numpy(v.copy()).to(torch.bfloat16 if k.startswith("vision_encoder.") else
                                                           torch.float32) for k, v in sd.items()},
                   os.path.join(root, "pytorch_model.bin"))
    if with_config:
        with open(os.path.join(root, "config.json"), "w") as f:
            json.dump(dataclasses.asdict(jcfg), f)


@pytest.mark.parametrize("fmt", ["single", "sharded", "bin"])
@pytest.mark.parametrize("variant", ["prefixed_with_config", "bare_names_config_argument"])
def test_load_pretrained_matches_jax(tmp_path, fmt, variant):
    jcfg, tc, sd = _reference_state_dict()
    prefixed = variant == "prefixed_with_config"
    root = str(tmp_path / "model")
    _write_model_dir(root, jcfg, sd, fmt, prefixed=prefixed, with_config=prefixed)
    if prefixed:
        got, cfg = load_pretrained(root)
        assert json.dumps(cfg.to_dict()) == json.dumps(tc.to_dict())  # tuples read back as lists
        jparams, _ = jax_load_pretrained(root)
    else:
        got, cfg = load_pretrained(root, tc)
        assert cfg is tc
        jparams, _ = jax_load_pretrained(root, jcfg)
    want = params_from_jax(jax.tree.map(np.asarray, jparams), tc)
    assert got.keys() == want.keys()
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        assert torch.equal(got[name].float(), w.float()), name
    if fmt == "bin":
        assert got["vision_encoder.cls_token"].dtype == torch.bfloat16


def test_load_pretrained_needs_weights(tmp_path):
    with pytest.raises(FileNotFoundError, match="no weights"):
        load_pretrained(str(tmp_path))


def test_lightning_checkpoint_matches_jax(tmp_path):
    jcfg, tc, sd = _reference_state_dict(seed=3)
    path = str(tmp_path / "task_best.ckpt")
    torch.save({"epoch": 3, "global_step": 120, "state_dict": {f"model.{k}": torch.from_numpy(v.copy()) for k, v in sd.items()},
                "callbacks": {"ModelCheckpoint": {"best_model_score": torch.tensor(0.5)}}}, path)
    got = load_task_checkpoint(path)
    want = params_from_jax(jax.tree.map(np.asarray, jax_load_checkpoint(path, jcfg)), tc)
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k].float(), w.float()) for k, w in want.items())
    # a plain state_dict in a .bin, without the Lightning wrapper
    bin_path = str(tmp_path / "task_best.bin")
    torch.save({k: torch.from_numpy(v.copy()) for k, v in sd.items()}, bin_path)
    assert all(torch.equal(load_task_checkpoint(bin_path)[k], v) for k, v in got.items())


@pytest.mark.parametrize("where", ["pytorch_model.bin", "task_best.ckpt"])
def test_pickles_beyond_tensors_are_refused(tmp_path, where):
    path = str(tmp_path / where)
    torch.save({"x": torch.zeros(2), "hook": os.getcwd}, path)
    with pytest.raises(pickle.UnpicklingError):
        if where.endswith(".bin"):
            load_pretrained(str(tmp_path), tiny_cfgs()[1])
        else:
            load_task_checkpoint(path)


# --- pretrain, then continual learning ---------------------------------------------------------------

def _write_png(path, w, h, seed):
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    rng = np.random.default_rng(seed)
    Image.fromarray(rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)).save(path)


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    """The port's pretrain CLI from a tiny model directory (config.json and
    model.safetensors) over a manifest of 16 written images, every third a
    Visual-Genome region: one epoch of 4 updates; returns (root, its
    output directory, the starting state_dict, the final TrainState)."""
    root = str(tmp_path_factory.mktemp("pretrain_cli"))
    jcfg, tc, sd = _reference_state_dict(seed=5)
    model_dir = os.path.join(root, "model")
    _write_model_dir(model_dir, jcfg, sd, "single", prefixed=True, with_config=True)
    for split, n in (("train", 16), ("val", 4)):
        with open(os.path.join(root, f"{split}.jsonl"), "w") as f:
            for i in range(n):
                path = os.path.join(root, "images", f"{split}{i}.png")
                _write_png(path, 40 + 4 * i, 36, seed=i)
                row = {"image": path, "caption": f"a red ball number {i}", "source": "coco", "metadata": {}}
                if i % 3 == 0:
                    row.update(source="visual_genome", metadata={"bbox": [i, 2, 12, 10]})
                f.write(json.dumps(row) + "\n")
    out = os.path.join(root, "out")
    state = tcli.train([
        "--model_name", model_dir, "--manifest", os.path.join(root, "train.jsonl"),
        "--eval_manifest", os.path.join(root, "val.jsonl"), "--output_dir", out, "--allow_tokenizer_fallback",
        "--model_max_length", "24", "--per_device_train_batch_size", "4", "--per_device_eval_batch_size", "4",
        "--num_train_epochs", "1", "--learning_rate", "1e-3", "--save_steps", "0.5", "--eval_steps", "0.5",
        "--device", "cpu",
    ])
    return root, out, {k: torch.from_numpy(v.copy()) for k, v in sd.items()}, state


def test_pretrain_cli_runs_from_a_model_directory(pretrained):
    root, out, start, state = pretrained
    assert state.step == 4
    assert sorted(os.listdir(out)) == ["checkpoint-2", "checkpoint-4", "checkpoint-final", "metrics.jsonl"]
    final = load_safetensors(os.path.join(out, "checkpoint-final", "model.safetensors"))
    assert final.keys() == start.keys()
    moved = [k for k in start if not torch.equal(final[k], start[k])]
    assert moved and all(not k.startswith("vision_encoder.") for k in moved)  # the tower stays frozen
    with open(os.path.join(out, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [r["_step"] for r in records if "train/loss" in r] == [1, 2, 3, 4]
    assert all(np.isfinite(r.get("train/loss", r.get("eval/loss"))) for r in records)


def test_cl_trainers_start_from_the_pretrain_checkpoint(pretrained, tmp_path, monkeypatch):
    """Both trainers with --model_name <pretrain out>/checkpoint-final: the
    JAX trainer's initial parameters and those the port's first task loads
    are equal (the port runs a one-task sequence; its first load_params is
    the initial state)."""
    root, out, _, _ = pretrained
    ckpt_dir = os.path.join(out, "checkpoint-final")
    jcfg_model, tc = tiny_cfgs()
    jcfg = jax_write_synthetic_vqa(str(tmp_path / "data"), n_train=8, n_val=4).replace(
        output_dir=str(tmp_path / "jax"), model_name=ckpt_dir, tasks=["taskA"], vision_cache=False)
    want = params_from_jax(jax.tree.map(np.asarray, JaxTrainer(jcfg, model_cfg=jcfg_model, synthetic_images=True,
                                                                use_mesh=False)._initial_params()), tc)

    from mafed_tpu_torch.core import config as tcfg

    cfg = tcfg.TrainConfig.from_dict({**jcfg.to_dict(), "output_dir": str(tmp_path / "torch")})
    loaded = []
    load_params = TaskRunner.load_params

    def spy(self, params):
        if not loaded:
            loaded.append({k: v.detach().clone() for k, v in params.items()})
        return load_params(self, params)

    monkeypatch.setattr(TaskRunner, "load_params", spy)
    result = ContinualLearningTrainer(cfg, model_cfg=tc, synthetic_images=True, device="cpu").main()
    assert np.asarray(result["accuracy_matrix"]).shape == (1, 1)
    (got,) = loaded
    final = load_safetensors(os.path.join(ckpt_dir, "model.safetensors"))
    assert got.keys() == want.keys() == final.keys()
    for name, w in want.items():
        assert torch.equal(got[name].float(), w.float()), name
        assert torch.equal(got[name].float(), final[name]), name
