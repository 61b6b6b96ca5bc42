"""The port's continual-learning trainer against the JAX package's.

One two-task featdistill (MAFED) sequence runs in both packages from the
same initial parameters (the JAX `init_params` carried over by
`params_from_jax`) on the same synthetic data: fused windows of 4
microbatches of 4 with a replay batch every 4th (two windows an epoch), the
vision cache on, compute float32, the teacher in bfloat16 on both sides.
The port's cache is seeded with the JAX run's feature files (its own stamp
first), so both train and decode from identical patches and the port primes
none. Tolerances: memory indices and the accuracy matrix equal; every
logged loss and grad norm within rtol 1e-4; each task's best parameters
(the checkpoints) within atol 1e-6; the answers each trainer's decoder
(bfloat16) gives every validation question from the last checkpoint equal.
(Measured on a CPU: 7e-6 relative, 2.4e-8, and equal.) Then port-only sequences of naive,
replay and EWC, and featdistill on the per-microbatch `MultiSteps` path,
with the steps each task takes; the command line against JAX's parser; the
settings the port lacks raise; without a GPU the trainer raises.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax

from mafed_tpu.core.config import TrainConfig as JTrainConfig
from mafed_tpu.core.config import build_arg_parser as jax_parser
from mafed_tpu.core.config import parse_with_config as jax_parse
from mafed_tpu.trainer.continual import ContinualLearningTrainer as JaxTrainer
from mafed_tpu_torch.core import config as tcfg
from mafed_tpu_torch.data.vision_cache import VisionFeatureCache, vision_fingerprint
from mafed_tpu_torch.models.weights import load_safetensors, params_from_jax
from mafed_tpu_torch.trainer.continual import ContinualLearningTrainer
from mafed_tpu_torch.trainer.runner import TaskRunner
from mafed_tpu_torch.train import main as train_main
from tests.helpers import write_synthetic_vqa as jax_write_synthetic_vqa
from tests.torch_helpers import one_torch_thread, jax_params, tiny_cfgs, torch_model, write_synthetic_vqa  # noqa: F401 (a fixture)

LOSS_RTOL = 1e-4
PARAM_ATOL = 1e-6

MAFED = dict(
    cl_method="featdistill", accumulate_grad_batches=4, replay_interval=4, cl_memory=8, compute_dtype="float32",
    distillation_modality_weighing_strategy="balanced", distillation_layer_weighing_strategy="discounted",
    distillation_layer_discount=0.5, device_vision_table_mb=0, teacher_state_cache="off",
)


def _metrics(out_dir):
    with open(os.path.join(out_dir, "log", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cl_parity"))
    jcfg_model, tc = tiny_cfgs()
    # host copies: the JAX steps donate their device buffers
    params = jax.tree.map(np.asarray, jax_params(jcfg_model, seed=0))
    jcfg = jax_write_synthetic_vqa(root, n_train=32, n_val=8).replace(output_dir=os.path.join(root, "jax"), **MAFED)
    jax_trainer = JaxTrainer(jcfg, model_cfg=jcfg_model, synthetic_images=True, init_params=params, use_mesh=False)
    jax_result = jax_trainer.main()

    port_out = os.path.join(root, "torch")
    cfg = tcfg.TrainConfig.from_dict({**jcfg.to_dict(), "output_dir": port_out})
    cache = VisionFeatureCache(os.path.join(port_out, "vision_cache"), tc.vision.num_patches, tc.vision.embed_dim)
    cache.set_fingerprint(vision_fingerprint(torch_model(params, tc)))
    jax_cache = os.path.join(jcfg.output_dir, "vision_cache")
    for sub in os.listdir(jax_cache):
        if os.path.isdir(os.path.join(jax_cache, sub)):
            shutil.copytree(os.path.join(jax_cache, sub), os.path.join(cache.cache_dir, sub))
    trainer = ContinualLearningTrainer(cfg, model_cfg=tc, synthetic_images=True,
                                       init_params=params_from_jax(params, tc), device="cpu")
    result = trainer.main()
    return jcfg, jax_trainer, jax_result, cfg, trainer, result


def test_featdistill_sequence_matches_jax(both_runs):
    jcfg, jax_trainer, jax_result, cfg, trainer, result = both_runs
    assert trainer.primed == [0, 0, 0]  # every feature came from the JAX run's cache
    assert [d.indices for d in trainer.strategy.datasets] == [d.indices for d in jax_trainer.strategy.datasets]
    np.testing.assert_array_equal(np.asarray(result["accuracy_matrix"]), np.asarray(jax_result["accuracy_matrix"]))
    assert result["bwt"] == jax_result["bwt"]
    # task 0: two CE windows; task 1: two MAFED windows (a replay position in each)
    assert [log["steps"] for log in trainer.fit_logs] == [{"ce_window": 2}, {"mafed_window": 2}]

    want, got = _metrics(jcfg.output_dir), _metrics(cfg.output_dir)
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    n_checked = 0
    for g, w in zip(got, want):
        assert g["_step"] == w["_step"]
        for key, value in w.items():
            if "loss" in key or "grad_norm" in key:
                np.testing.assert_allclose(g[key], value, rtol=LOSS_RTOL, err_msg=key)
                n_checked += 1
            elif key.endswith("acc"):
                assert g[key] == value, key
    assert n_checked >= 12  # 4 windows: loss + grad norm, and the distill taps of the MAFED ones


def test_best_checkpoints_match_jax(both_runs):
    from safetensors.numpy import load_file

    jcfg, _, _, cfg, trainer, _ = both_runs
    for task in cfg.tasks:
        name = f"{task}_best.safetensors"
        got = load_safetensors(os.path.join(cfg.output_dir, "ckpt", name))
        want = load_file(os.path.join(jcfg.output_dir, "ckpt", name))
        assert set(got) == set(want)
        for k, w in want.items():
            assert got[k].dtype == torch.float32
            np.testing.assert_allclose(got[k].numpy(), w, atol=PARAM_ATOL, rtol=0, err_msg=k)
    # the teacher is the bfloat16 of task 0's best trainable parameters
    best0 = load_safetensors(os.path.join(cfg.output_dir, "ckpt", f"{cfg.tasks[0]}_best.safetensors"))
    teacher = trainer.strategy.teacher.state_dict()
    for k, v in teacher.items():
        if not k.startswith("vision_encoder."):
            assert torch.equal(v, best0[k].to(torch.bfloat16)), k


def test_final_answers_match_jax(both_runs):
    from mafed_tpu.evaluation.validate import validate_vqa as jax_validate
    from mafed_tpu.utils.checkpoint import load_task_checkpoint as jax_load

    jcfg, jax_trainer, _, cfg, trainer, _ = both_runs
    name = f"{cfg.tasks[-1]}_best.safetensors"
    jax_last = jax_load(os.path.join(jcfg.output_dir, "ckpt", name), jax_trainer.model_cfg)
    trainer.runner.load_params(load_safetensors(os.path.join(cfg.output_dir, "ckpt", name)))
    for task in cfg.tasks:
        _, want = jax_validate(jax_last, jax_trainer.runner.decoder, jax_trainer.val_loaders[task],
                               jax_trainer.tokenizer, jcfg.val_batch_size)
        _, got = trainer.runner.validate(trainer.val_loaders[task])
        assert got == want


def test_outputs_of_a_sequence(both_runs):
    _, _, _, cfg, _, result = both_runs
    acc = np.asarray(result["accuracy_matrix"])
    assert acc.shape == (2, 2) and np.isfinite(acc).all() and ((acc >= 0) & (acc <= 1)).all()
    assert result["bwt"] == pytest.approx(acc[0, 1] - acc[0, 0], abs=1e-12)
    for name in ("hps.json", "results.json", "model_config.json", "task_order.json", "log.txt"):
        assert os.path.exists(os.path.join(cfg.output_dir, "log", name)), name
    with open(os.path.join(cfg.output_dir, "log", "hps.json")) as f:
        assert json.load(f)["cl_method"] == "featdistill"


# --- port-only sequences ---------------------------------------------------------

def _port_sequence(tmp_path, **overrides):
    jcfg_model, tc = tiny_cfgs()
    params = jax_params(jcfg_model, seed=1)
    cfg = write_synthetic_vqa(str(tmp_path), n_train=16, n_val=4)
    cfg = cfg.replace(**{**MAFED, "cl_memory": 4, **overrides})
    state_dict = params_from_jax(jax.tree.map(np.asarray, params), tc)
    trainer = ContinualLearningTrainer(cfg, model_cfg=tc, synthetic_images=True, init_params=state_dict, device="cpu")
    result = trainer.main()
    acc = np.asarray(result["accuracy_matrix"])
    assert acc.shape == (2, 2) and np.isfinite(acc).all()
    for task in cfg.tasks:
        assert os.path.exists(os.path.join(cfg.output_dir, "ckpt", f"{task}_best.safetensors"))
    return trainer


@pytest.mark.parametrize("method, overrides, steps", [
    ("naive", {}, [{"ce_window": 1}, {"ce_window": 1}]),
    # the replay batch is one of the window's CE microbatches
    ("replay", {}, [{"ce_window": 1}, {"ce_window": 1}]),
    ("ewc", {"reg_lambda": 100.0}, [{"ce_window": 1}, {"ewc_window": 1}]),
    # per-microbatch steps under MultiSteps(4): the 4th of each window is the distill step on task 1
    ("featdistill", {"fused_window": False}, [{"ce_step": 4}, {"ce_step": 3, "distill_step": 1}]),
    ("featdistill", {"fused_window": False, "distillation_modality_weighing_strategy": "adaptive"},
     [{"ce_step": 4}, {"ce_step": 3, "distill_step": 1}]),
], ids=["naive", "replay", "ewc", "featdistill_multisteps", "featdistill_adaptive_multisteps"])
def test_port_sequences(tmp_path, method, overrides, steps):
    trainer = _port_sequence(tmp_path, cl_method=method, **overrides)
    assert [log["steps"] for log in trainer.fit_logs] == steps
    if method == "replay":
        assert len(trainer.strategy.datasets[0]) == 4
    if method == "ewc":
        fisher = trainer.strategy.fisher
        assert all(torch.isfinite(v).all() for v in fisher.values()) and any(v.sum() > 0 for v in fisher.values())
    if overrides.get("distillation_modality_weighing_strategy") == "adaptive":
        lang = trainer.strategy.lang_coeff
        assert lang.shape == (2,) and ((lang > 0) & (lang < 1)).all()


# --- the command line, the settings left out, the device ---------------------------

ARGVS = [
    ["--config", "config/train-vqa-base-cl-vlpythia.json"],
    ["--config", "config/train-vqa-base-cl-vlpythia.json", "--no_fused_window", "--epochs", "1", "1",
     "--tasks", "a", "b", "--cl_method", "featdistill", "--no_vision_cache", "--optim", "adam"],
    ["--batch_size", "16", "--accumulate_grad_batches", "4", "--distillation_layer_discount", "0.5",
     "--teacher_state_cache", "off", "--device_vision_table_mb", "0", "--allow_tokenizer_fallback"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=["json", "json_and_cli", "cli"])
def test_parse_with_config_matches_jax(argv):
    got = tcfg.parse_with_config(tcfg.build_arg_parser(), argv)
    want = jax_parse(jax_parser(), argv)
    assert got.to_dict() == want.to_dict()
    assert tcfg.TrainConfig().to_dict() == JTrainConfig().to_dict()


def test_model_config_from_json_matches_jax():
    from mafed_tpu.core.config import ModelConfig as JModelConfig

    for name in ("vlpythia-base", "vlpythia-160m", "vlpythia-1b"):
        path = f"config/{name}.json"
        assert tcfg.ModelConfig.from_json(path).to_dict() == JModelConfig.from_json(path).to_dict()


@pytest.mark.parametrize("overrides", [
    {"profile_dir": "trace"},
    {"distributed_init": True},
    {"mesh_shape": [2, 1]},
], ids=["profile", "distributed", "mesh"])
def test_settings_left_out_raise(tmp_path, overrides):
    """A mesh of two ranks on one rank raises (one device a rank);
    distributed_init without a launcher's
    variables raises (tests/test_torch_multiprocess.py runs two ranks);
    profile_dir is ported (tests/test_torch_profiling.py traces a run) and
    builds a trainer."""
    cfg = write_synthetic_vqa(str(tmp_path)).replace(cl_method="featdistill", **overrides)
    if "profile_dir" in overrides:
        trainer = ContinualLearningTrainer(cfg, model_cfg=tiny_cfgs()[1], device="cpu")
        assert trainer.runner.config.profile_dir == "trace"
        return
    if "distributed_init" in overrides:
        with pytest.raises(RuntimeError, match="RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT"):
            ContinualLearningTrainer(cfg, device="cpu")
        return
    with pytest.raises(ValueError, match=r"grid of 2 x 1 = 2 ranks, but the run has 1 rank\(s\)"):
        ContinualLearningTrainer(cfg, device="cpu")


def test_pretrained_directory_raises(tmp_path):
    """A model directory as model_name goes through load_pretrained
    (tests/test_torch_pretrained.py loads real ones); one without weights raises."""
    _, tc = tiny_cfgs()
    cfg = write_synthetic_vqa(str(tmp_path)).replace(model_name=str(tmp_path))
    trainer = ContinualLearningTrainer(cfg, model_cfg=tc, synthetic_images=True, device="cpu")
    with pytest.raises(FileNotFoundError, match="no weights found"):
        trainer.main()


def test_entry_points_need_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    _, tc = tiny_cfgs()
    cfg = write_synthetic_vqa(str(tmp_path))
    with pytest.raises(RuntimeError, match="no GPU"):
        ContinualLearningTrainer(cfg, model_cfg=tc)
    with pytest.raises(RuntimeError, match="no GPU"):
        TaskRunner(tc, cfg, tokenizer=None)
    with pytest.raises(RuntimeError, match="no GPU"):
        train_main(["--output_dir", str(tmp_path / "cli"), "--tasks", "taskA", "--device_vision_table_mb", "0"])
