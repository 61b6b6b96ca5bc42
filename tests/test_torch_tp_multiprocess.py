"""The port's tensor parallelism through both trainers: a two-task
featdistill sequence of the CL trainer on 4 ranks under mesh_shape [2, 2]
and pretraining on 2 ranks under [1, 2], each against one process of the
same program (tests/torch_tp_worker.py, gloo on the CPU), and a torchrun
launch of both entry points with --mesh_shape 1 2.

Tolerances (float32 compute in the CL run, bf16 in pretraining, as the
entry point runs it):
  * CL: the ranks' accuracy matrices equal to each other and to one
    process's; the logged losses rtol 1e-4; the final and the best
    parameters atol 1e-5 (lr / 100: model-group sums reorder the sums of
    one process, and AdamW moves an element whose gradient is rounding
    noise by up to lr);
  * the CL run preempted on the grid and resumed: bit-equal to the
    uninterrupted run on the grid (its bundle is whole: gathered, then
    sharded again on load);
  * pretraining: the train and eval losses rtol 2.5e-4 (bf16, the
    tolerance of tests/test_torch_multiprocess.py's two data ranks; the
    first loss, on the same weights and rows, measured 1.7e-5 relative:
    each rank's partial products round to bf16 before their sum), the
    parameters at checkpoint-final within 1 % of one process's update
    (||tp - one|| / ||one - start||), the frozen tower equal.
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

import jax

from mafed_tpu_torch.models.weights import load_safetensors, params_from_jax
from mafed_tpu_torch.utils.checkpoint import save_task_checkpoint
from tests import torch_mp_worker as MPW
from tests.test_torch_tensor_parallel import WAIT_S, run_groups
from tests.torch_helpers import jax_params, one_torch_thread, tiny_cfgs, write_synthetic_vqa  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL, PARAM_ATOL = 1e-4, 1e-5
PRETRAIN_LOSS_RTOL, PRETRAIN_UPDATE_RTOL = 2.5e-4, 1e-2


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_tp_mp"))
    jm, tc = tiny_cfgs()
    write_synthetic_vqa(root)
    save_task_checkpoint(params_from_jax(jax.tree.map(np.asarray, jax_params(jm, seed=0)), tc),
                         os.path.join(root, MPW.INIT_PARAMS))
    results = run_groups(root, [(4, "cl4", "cl", (2, 2)), (1, "cl1", "cl", (1, 1)),
                                (2, "pre2", "pretrain", (1, 2)), (1, "pre1", "pretrain", (1, 1))])
    return root, results


def _losses(out_dir, suffix):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [(rec["_step"], k, v) for rec in map(json.loads, f) for k, v in rec.items() if k.endswith(suffix)]


def _close(a: dict, b: dict, atol: float) -> None:
    assert a.keys() == b.keys()
    for k in b:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), atol=atol, rtol=0, err_msg=k)


def test_cl_sequence_on_a_2x2_grid_matches_one_process(runs):
    root, results = runs
    grid, (one,) = results["cl4"], results["cl1"]
    assert [r["is_main"] for r in grid] == [True, False, False, False]
    assert all(r["window"] == 2 and r["steps"] == one["steps"] for r in grid)
    assert all(r["accuracy_matrix"] == one["accuracy_matrix"] for r in grid)
    # the vision cache's images and the teacher's states primed once over the four ranks
    assert [sum(r["primed"][i] for r in grid) for i in range(len(one["primed"]))] == one["primed"]
    assert sum(r["teacher_cache"][0]["primed"] for r in grid) == one["teacher_cache"][0]["primed"] > 0
    _close(load_safetensors(os.path.join(root, "final_cl4.safetensors")),
           load_safetensors(os.path.join(root, "final_cl1.safetensors")), PARAM_ATOL)
    for task in ("taskA", "taskB"):  # written whole by rank 0, under the reference's names
        got, want = (load_safetensors(os.path.join(root, tag, "ckpt", f"{task}_best.safetensors"))
                     for tag in ("cl4", "cl1"))
        _close(got, want, PARAM_ATOL)
    got, want = (_losses(os.path.join(root, tag, "log"), "/train_loss") for tag in ("cl4", "cl1"))
    assert [g[:2] for g in got] == [w[:2] for w in want] and len(got) > 0
    np.testing.assert_allclose([g[2] for g in got], [w[2] for w in want], rtol=LOSS_RTOL)
    # the resume bundle holds the whole optimizer state
    opt = load_safetensors(os.path.join(root, "cl4", "resume", "opt_state.safetensors"))
    ref = load_safetensors(os.path.join(root, "cl1", "resume", "opt_state.safetensors"))
    assert {k: v.shape for k, v in opt.items()} == {k: v.shape for k, v in ref.items()}


def test_grid_countdown_restart_matches_uninterrupted(runs):
    root = runs[0]
    pre = run_groups(root, [(4, "clp", "cl_preempt:4", (2, 2))])["clp"]
    assert [r["preempted"] for r in pre] == [143] * 4
    assert all(r["bundle"] == pre[0]["bundle"] for r in pre) and pre[0]["bundle"]["task_id"] == 1
    res = run_groups(root, [(4, "clp", "cl_resume", (2, 2))])["clp"]
    assert all(r["accuracy_matrix"] == runs[1]["cl4"][0]["accuracy_matrix"] for r in res)
    for name in ("final_{}.safetensors", os.path.join("{}", "ckpt", "taskB_best.safetensors")):
        a, b = (load_safetensors(os.path.join(root, name.format(tag))) for tag in ("cl4", "clp"))
        assert a.keys() == b.keys() and all(np.array_equal(a[k].numpy(), b[k].numpy()) for k in a), name


def test_pretraining_on_a_1x2_grid_matches_one_process(runs):
    root, results = runs
    two, (one,) = results["pre2"], results["pre1"]
    assert [r["is_main"] for r in two] == [True, False]
    assert all(r["global_batch"] == 8 and r["local_rows"] == 8 for r in two + [one])
    for suffix in ("train/loss", "eval/loss"):
        got, want = (_losses(os.path.join(root, tag), suffix) for tag in ("pre2", "pre1"))
        assert [g[0] for g in got] == [w[0] for w in want] and len(got) > 0
        np.testing.assert_allclose([g[2] for g in got], [w[2] for w in want], rtol=PRETRAIN_LOSS_RTOL)
    before = load_safetensors(os.path.join(root, "before_pre1.safetensors"))
    a, b = (load_safetensors(os.path.join(root, tag, "checkpoint-final", "model.safetensors")) for tag in ("pre2", "pre1"))
    assert a.keys() == b.keys() and before.keys() < a.keys()
    assert all(np.array_equal(a[k].numpy(), b[k].numpy()) for k in a.keys() - before.keys())  # the frozen tower
    diff, update = (math.sqrt(sum(float((x[k].double() - y[k].double()).square().sum()) for k in before))
                    for x, y in ((a, b), (b, before)))
    assert update > 0 and diff / update < PRETRAIN_UPDATE_RTOL, (diff, update)


def test_torchrun_launches_both_entry_points_on_a_grid(tmp_path):
    """`torchrun --nproc_per_node 2` runs the trainer's and pretraining's
    command lines with --mesh_shape 1 2: no entry point refuses a model
    axis, rank 0 writes the results and whole checkpoints."""
    from PIL import Image

    from mafed_tpu_torch.models.vl_pythia import init_model

    root = str(tmp_path)
    write_synthetic_vqa(root, n_train=16, n_val=4)
    images = os.path.join(root, "images")
    os.makedirs(images)
    rng = np.random.default_rng(0)
    for i in range(16):
        Image.fromarray(rng.integers(0, 256, (28, 28, 3)).astype(np.uint8)).save(
            os.path.join(images, f"synthetic_{i}"), format="PNG")
    model_dir = os.path.join(root, "model")
    os.makedirs(model_dir)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(MPW.tiny_model_cfg().to_dict(), f)
    save_task_checkpoint(init_model(MPW.tiny_model_cfg(), seed=0, device="cpu").state_dict(),
                         os.path.join(model_dir, "model.safetensors"))
    with open(os.path.join(root, "captions.jsonl"), "w") as f:
        for i in range(16):
            f.write(json.dumps({"image": os.path.join(images, f"synthetic_{i}"), "caption": f"a photo of {i}",
                                "source": "coco", "metadata": {}}) + "\n")
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env.update(PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2", "-m"]
    commands = {
        "cl": ["mafed_tpu_torch.train", "--output_dir", os.path.join(root, "cl"), "--data_dir", root,
               "--question_task_ids", os.path.join(root, "contvqa"), "--exp", "tiny", "--train_img_dirs", images,
               "--val_img_dirs", images, "--tasks", "taskA", "taskB", "--epochs", "1", "1", "--batch_size", "4",
               "--val_batch_size", "2", "--max_txt_len", "24", "--cl_method", "featdistill", "--cl_memory", "4",
               "--distillation_layer_weighing_strategy", "discounted", "--model_name", model_dir,
               "--allow_tokenizer_fallback", "--device", "cpu", "--mesh_shape", "1", "2"],
        "pretrain": ["mafed_tpu_torch.pretrain_vlpythia", "--model_name", model_dir, "--manifest",
                     os.path.join(root, "captions.jsonl"), "--output_dir", os.path.join(root, "pretrain"),
                     "--allow_tokenizer_fallback", "--model_max_length", "24", "--per_device_train_batch_size", "2",
                     "--num_train_epochs", "1", "--device", "cpu", "--mesh_shape", "1", "2"],
    }
    procs = {name: subprocess.Popen(torchrun + command, cwd=REPO, env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True) for name, command in commands.items()}
    try:
        outs = {name: p.communicate(timeout=WAIT_S)[0] for name, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    for name, p in procs.items():
        assert p.returncode == 0, f"{name}:\n{outs[name][-6000:]}"
    with open(os.path.join(root, "cl", "log", "results.json")) as f:
        assert np.asarray(json.load(f)["accuracy_matrix"]).shape == (2, 2)
    best = load_safetensors(os.path.join(root, "cl", "ckpt", "taskB_best.safetensors"))
    assert tuple(best["gpt_neox.embed_in.weight"].shape) == (512, 128)  # whole, not a shard
    with open(os.path.join(root, "pretrain", "metrics.jsonl")) as f:
        assert [r["_step"] for r in map(json.loads, f) if "train/loss" in r] == [1, 2, 3, 4]
    final = load_safetensors(os.path.join(root, "pretrain", "checkpoint-final", "model.safetensors"))
    assert tuple(final["embed_out.weight"].shape) == (512, 128)
