"""The port's data-parallel path (mafed_tpu_torch/core/dist.py and its call
sites) over two gloo ranks on the CPU, against one rank of the same program
and against the JAX package: the counterpart of tests/test_multiprocess.py.

The ranks are processes of tests/torch_mp_worker.py, each group on a port
of its own, each wait bounded. Tolerances:

  * the loaders' rows and the cache's shard owners: equal to the JAX package's;
  * process_reduce_sum on (rank + 1, 10): (3, 20) exactly;
  * two MAFED windows (float32) on the rows split between the ranks against
    one rank: metrics rtol 1e-5, parameters atol 1e-5 (lr / 100);
  * the EWC Fisher of two ranks against one rank's: rtol 1e-4, atol 1e-6 of
    each tensor's largest entry (float32 gradients of half batches, summed:
    measured 1.4e-5 relative at most, on an entry of 5.7e-7 where the halves
    cancel; squares summed over the ranks instead differ by tens of percent);
  * the CL run (tests/mp_worker.py's configuration, float32 compute, the
    vision cache seeded with the JAX run's features): two ranks bit-equal to
    each other; their accuracy matrix equal to one rank's and to the JAX
    package's one process on a (2, 1) mesh; the final parameters within
    atol 1e-6 of one rank's, the best checkpoints within atol 5e-6 of the
    JAX package's (the tolerance of the port's teacher-cache sequence test:
    each package trains on the teacher states it primed); logged losses
    within rtol 1e-4;
  * preemption: rank 1's flag alone stops both ranks at the same update;
    the countdown's restart bit-equal to the uninterrupted two-rank run;
  * pretraining (bf16 compute, as the entry point runs it) against one rank
    at the same global batch: the first loss equal (the same weights and
    rows); the later train and eval losses within rtol 2.5e-4 (measured
    7.8e-5 relative, 3.8e-4 absolute: the ranks' half batches round
    differently in bf16, and AdamW at lr 1e-3 carries it, so the JAX
    package's atol 1e-4 between its layouts of one program does not hold
    here; with no all-reduce of the gradients, 8.7e-4 relative); the
    ranks' trainable parameters at checkpoint-final bit-equal; their
    distance from one rank's within 1 % of one rank's update
    (||two - one|| / ||one - start||, measured 0.13 %, 31 % with no
    all-reduce of the gradients; 4 updates at lr 1e-3
    move an element by 2e-3 at most, so no absolute limit tells a wrong
    update from a right one), the frozen tower equal.
"""

import itertools
import json
import math
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from mafed_tpu.core.config import TrainConfig as JTrainConfig
from mafed_tpu.data import diskcache as jdc
from mafed_tpu.data.loader import BatchLoader as JaxLoader
from mafed_tpu.trainer.continual import ContinualLearningTrainer as JaxTrainer
from mafed_tpu_torch.data import diskcache as tdc
from mafed_tpu_torch.data.loader import BatchLoader
from mafed_tpu_torch.data.vision_cache import VisionFeatureCache, vision_fingerprint
from mafed_tpu_torch.evaluation.classifier import all_reduce_metrics
from mafed_tpu_torch.models.weights import load_safetensors, params_from_jax
from mafed_tpu_torch.pretrain.trainer import PretrainConfig, PretrainTrainer
from mafed_tpu_torch.trainer.continual import ContinualLearningTrainer
from mafed_tpu_torch.utils.checkpoint import save_task_checkpoint
from tests import torch_mp_worker as W
from tests.torch_helpers import TINY, TINY_VISION, jax_params, one_torch_thread, tiny_cfgs, torch_model  # noqa: F401
from tests.torch_helpers import write_synthetic_vqa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 300  # each worker's bound
FINAL_ATOL, JAX_PARAM_ATOL, LOSS_RTOL, FISHER_RTOL = 1e-6, 5e-6, 1e-4, 1e-4
PRETRAIN_LOSS_RTOL, PRETRAIN_UPDATE_RTOL, WINDOW_PARAM_ATOL = 2.5e-4, 1e-2, 1e-5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_groups(root: str, groups) -> dict:
    """Start every (world, tag, mode) group at once, a free port each; wait
    for each rank within WAIT_S; {tag: [each rank's result]}."""
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = []
    for world, tag, mode in groups:
        port = str(_free_port())
        procs += [(tag, subprocess.Popen([sys.executable, W.__file__, str(r), str(world), port, root, tag, mode],
                                         cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                         text=True)) for r in range(world)]
    outs = []
    try:
        for _, p in procs:
            outs.append(p.communicate(timeout=WAIT_S)[0])
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for (tag, p), out in zip(procs, outs):
        assert p.returncode == 0, f"{tag} rank failed:\n{out[-6000:]}"
    results = {}
    for world, tag, _ in groups:
        results[tag] = []
        for r in range(world):
            with open(os.path.join(root, f"worker_{tag}_{r}.json")) as f:
                results[tag].append(json.load(f))
    return results


def test_worker_model_is_the_tiny_model():
    assert W.TINY == TINY and W.TINY_VISION == TINY_VISION
    assert W.tiny_model_cfg().to_dict() == tiny_cfgs()[1].to_dict()


# --- loaders and cache ownership against the JAX package ----------------------------------------------

class _Rows:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return int(i)


def _rows(loader, n_batches=None):
    it = iter(loader)
    try:
        return [list(b) for b in itertools.islice(it, n_batches)]
    finally:
        it.close()


@pytest.mark.parametrize("n, batch, shards, shuffle, drop_last, infinite", [
    (10, 2, 2, True, True, False), (11, 2, 2, True, True, False), (11, 3, 2, False, False, False),
    (13, 2, 3, True, False, False), (24, 4, 2, True, True, False), (7, 2, 1, True, False, False),
    (8, 4, 2, True, True, True), (9, 4, 2, True, True, True), (5, 4, 3, True, True, True),
    (3, 4, 2, False, True, True),
])
def test_sharded_loader_rows_match_jax(n, batch, shards, shuffle, drop_last, infinite):
    for shard in range(shards):
        kw = dict(batch_size=batch, collate=list, shuffle=shuffle, seed=3, num_workers=1, drop_last=drop_last,
                  infinite=infinite, shard_id=shard, num_shards=shards)
        port, ref = BatchLoader(_Rows(n), **kw), JaxLoader(_Rows(n), **kw)
        take = 7 if infinite else None
        assert _rows(port, take) == _rows(ref, take)
        if infinite:
            port.set_draws(2)
            ref.set_draws(2)
        else:
            assert len(port) == len(ref)
            port.set_epoch(1, start_batch=1)
            ref.set_epoch(1, start_batch=1)
        assert _rows(port, take) == _rows(ref, take)


@pytest.mark.parametrize("shards", [2, 3])
def test_shards_hold_the_global_batches(shards):
    """Batch i of every shard together are batch i of one loader at shards x the batch."""
    one = _rows(BatchLoader(_Rows(29), batch_size=2 * shards, collate=list, shuffle=True, seed=1, drop_last=True))
    per_shard = [_rows(BatchLoader(_Rows(29), batch_size=2, collate=list, shuffle=True, seed=1, drop_last=True,
                                   shard_id=s, num_shards=shards)) for s in range(shards)]
    assert [sorted(sum(parts, [])) for parts in zip(*per_shard)] == [sorted(b) for b in one]


def test_infinite_loader_needs_a_row_a_shard():
    with pytest.raises(ValueError, match="at least 2 samples"):
        BatchLoader(_Rows(1), batch_size=1, collate=list, infinite=True, num_shards=2)


def test_shard_owner_matches_jax():
    keys = [f"COCO_train2014_{i:012d}" for i in range(500)] + list(range(500))
    for n in (2, 3, 8):
        owners = [tdc.shard_owner(k, n) for k in keys]
        assert owners == [jdc.shard_owner(k, n) for k in keys]
        assert set(owners) == set(range(n))


# --- layouts that do not fit the ranks raise ----------------------------------------------------------

@pytest.mark.parametrize("mesh", [[2, 2], [2, 1], [1, 2]])
@pytest.mark.parametrize("entry", ["trainer", "pretrain", "all_reduce_metrics"])
def test_unported_layouts_raise(tmp_path, entry, mesh):
    """A (data, model) grid of more ranks than the run has (one here) is
    refused by every entry point: one device a rank, so D x M must be the
    number of ranks (tests/test_torch_tensor_parallel.py runs the grids)."""
    with pytest.raises(ValueError, match=r"but the run has 1 rank\(s\): one device a rank"):
        if entry == "trainer":
            cfg = write_synthetic_vqa(str(tmp_path)).replace(mesh_shape=mesh)
            ContinualLearningTrainer(cfg, model_cfg=tiny_cfgs()[1], device="cpu")
        elif entry == "pretrain":
            PretrainTrainer(tiny_cfgs()[1], PretrainConfig(output_dir=str(tmp_path), mesh_shape=tuple(mesh)),
                            [], device="cpu")
        else:
            all_reduce_metrics(1.0, 2.0, 3.0, mesh_shape=mesh)


# --- two ranks ------------------------------------------------------------------------------------------

def _seed_vision_cache(out_dir, jax_out, params, tc):
    """The port's cache under `out_dir`, stamped with its tower and holding
    the JAX run's feature files, so both packages train on the same patches."""
    cache = VisionFeatureCache(os.path.join(out_dir, "vision_cache"), tc.vision.num_patches, tc.vision.embed_dim)
    cache.set_fingerprint(vision_fingerprint(torch_model(params, tc)))
    src = os.path.join(jax_out, "vision_cache")
    for sub in os.listdir(src):
        if os.path.isdir(os.path.join(src, sub)):
            shutil.copytree(os.path.join(src, sub), os.path.join(cache.cache_dir, sub))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The synthetic data and starting weights; the JAX package's run on a
    (2, 1) mesh; then the port's groups: the CL run on two ranks and on one,
    rank 1's preemption flag, the units, and pretraining on two ranks and on
    one."""
    root = str(tmp_path_factory.mktemp("torch_mp"))
    jm, tc = tiny_cfgs()
    params = jax.tree.map(np.asarray, jax_params(jm, seed=0))
    write_synthetic_vqa(root)
    save_task_checkpoint(params_from_jax(params, tc), os.path.join(root, W.INIT_PARAMS))
    jcfg = JTrainConfig.from_dict({**W.cl_config(root, "jax").to_dict(), "mesh_shape": [2, 1]})
    jax_result = JaxTrainer(jcfg, model_cfg=jm, synthetic_images=True, init_params=params).main()
    for tag in ("mp", "sp", "pre"):
        _seed_vision_cache(os.path.join(root, tag), jcfg.output_dir, params, tc)
    results = _run_groups(root, [(2, "mp", "none"), (1, "sp", "none"), (2, "flag", "flag:2")])
    results.update(_run_groups(root, [(2, "units", "units"), (1, "units1", "units"),
                                      (2, "pmp", "pretrain"), (1, "psp", "pretrain")]))
    return root, jcfg, jax_result, results


def _losses(out_dir, suffix):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [(rec["_step"], k, v) for rec in map(json.loads, f) for k, v in rec.items() if k.endswith(suffix)]


def test_process_reduce_sum_over_two_ranks(runs):
    _, _, _, results = runs
    for r in results["units"]:
        assert r["reduce"] == r["reduce_expected"] == [3.0, 20.0]
    assert results["units1"][0]["reduce"] == [1.0, 10.0]


def test_ewc_fisher_two_ranks_match_one(runs):
    root = runs[0]
    two, one = (load_safetensors(os.path.join(root, f"fisher_{w}.safetensors")) for w in (2, 1))
    assert two.keys() == one.keys()
    assert sum(float(v.sum()) for v in one.values()) > 0
    for k in one:
        np.testing.assert_allclose(two[k].numpy(), one[k].numpy(), rtol=FISHER_RTOL,
                                   atol=1e-6 * float(one[k].abs().max()), err_msg=k)


def test_two_rank_mafed_windows_match_one_rank(runs):
    """Two fused MAFED windows, the rows of each split between the ranks
    (their token counts differ, so the distill loss needs the global counts),
    against one rank on all of them: metrics rtol 1e-5, parameters atol 1e-5,
    a hundredth of the learning rate (measured 1.04e-6: AdamW moves an
    element whose gradient is rounding noise by up to lr an update)."""
    root, _, _, results = runs
    two, one = results["units"][0]["windows"], results["units1"][0]["windows"]
    assert results["units"][1]["windows"] == two  # every rank reports the batch's metrics
    for got, want in zip(two, one):
        assert got.keys() == want.keys() and want["distill_loss"] > 0.1
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL / 10, err_msg=k)
    a, b = (load_safetensors(os.path.join(root, f"window_{w}.safetensors")) for w in (2, 1))
    for k in b:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), atol=WINDOW_PARAM_ATOL, rtol=0, err_msg=k)


def test_two_rank_cl_run_matches_one_rank_and_jax(runs):
    root, jcfg, jax_result, results = runs
    mp, (sp,) = results["mp"], results["sp"]
    assert [r["is_main"] for r in mp] == [True, False] and [r["metrics_none"] for r in mp] == [False, True]
    assert all(r["window"] == 2 for r in mp + [sp])  # fused windows stay on over ranks
    assert mp[0]["steps"] == mp[1]["steps"] == sp["steps"]
    acc = np.asarray(mp[0]["accuracy_matrix"])
    np.testing.assert_array_equal(acc, np.asarray(mp[1]["accuracy_matrix"]))
    np.testing.assert_array_equal(acc, np.asarray(sp["accuracy_matrix"]))
    np.testing.assert_array_equal(acc, np.asarray(jax_result["accuracy_matrix"]))

    final = [load_safetensors(os.path.join(root, f"final_{tag}_{r}.safetensors")) for tag, r in
             (("mp", 0), ("mp", 1), ("sp", 0))]
    for k in final[2]:
        assert torch.equal(final[0][k], final[1][k]), k
        np.testing.assert_allclose(final[0][k].numpy(), final[2][k].numpy(), atol=FINAL_ATOL, rtol=0, err_msg=k)
    from safetensors.numpy import load_file

    out = os.path.join(root, "mp")
    for task in jcfg.tasks:
        got = load_safetensors(os.path.join(out, "ckpt", f"{task}_best.safetensors"))
        want = load_file(os.path.join(jcfg.output_dir, "ckpt", f"{task}_best.safetensors"))
        for k, w in want.items():
            np.testing.assert_allclose(got[k].numpy(), w, atol=JAX_PARAM_ATOL, rtol=0, err_msg=f"{task}:{k}")

    # rank 0 wrote the run's files; the teacher states were primed into one shared directory
    for path in ("log/results.json", "log/hps.json", "resume/fit_state.json", "resume/opt_state.safetensors",
                 "teacher_cache/gen0/fingerprint.json"):
        assert os.path.exists(os.path.join(out, path)), path
    with open(os.path.join(out, "log", "results.json")) as f:
        np.testing.assert_array_equal(np.asarray(json.load(f)["accuracy_matrix"]), acc)
    got, want = _losses(os.path.join(out, "log"), "/train_loss"), _losses(os.path.join(root, "sp", "log"),
                                                                          "/train_loss")
    assert [g[:2] for g in got] == [w[:2] for w in want] and len(got) > 0
    np.testing.assert_allclose([g[2] for g in got], [w[2] for w in want], rtol=LOSS_RTOL)


def test_preemption_flag_on_one_rank_stops_both(runs):
    """Rank 1 alone sets the flag after its second update; both ranks stop
    there and save one bundle. The run primed its own vision cache, each
    rank the images it owns."""
    flag = runs[3]["flag"]
    assert [r["preempted"] for r in flag] == [143, 143]
    assert [r["updates"] for r in flag] == [2, 2]
    assert flag[0]["bundle"] == flag[1]["bundle"] and flag[0]["bundle"]["global_step"] == 4
    # 8 val images, then the 16 more of task A's 24 train images, split between the owners
    assert [a + b for a, b in zip(flag[0]["primed"], flag[1]["primed"])] == [8, 16]
    assert all(0 < n for r in flag for n in r["primed"])


def test_two_rank_countdown_restart_matches_uninterrupted(runs):
    root = runs[0]
    pre = _run_groups(root, [(2, "pre", "preempt:4")])["pre"]
    assert [r["preempted"] for r in pre] == [143, 143]
    assert pre[0]["bundle"]["task_id"] == 1 and pre[0]["bundle"] == pre[1]["bundle"]
    res = _run_groups(root, [(2, "pre", "resume")])["pre"]
    assert res[0]["accuracy_matrix"] == res[1]["accuracy_matrix"] == runs[3]["mp"][0]["accuracy_matrix"]
    for task in ("taskA", "taskB"):
        a = load_safetensors(os.path.join(root, "mp", "ckpt", f"{task}_best.safetensors"))
        b = load_safetensors(os.path.join(root, "pre", "ckpt", f"{task}_best.safetensors"))
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a), task
    for r in range(2):
        a, b = (load_safetensors(os.path.join(root, f"final_{tag}_{r}.safetensors")) for tag in ("mp", "pre"))
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_two_rank_pretraining_matches_one_rank(runs):
    root, _, _, results = runs
    assert [r["is_main"] for r in results["pmp"]] == [True, False]
    assert [r["metrics_none"] for r in results["pmp"]] == [False, True]
    assert results["pmp"][0]["global_batch"] == results["psp"][0]["global_batch"] == 8
    for suffix in ("train/loss", "eval/loss"):
        got, want = (_losses(os.path.join(root, tag), suffix) for tag in ("pmp", "psp"))
        assert [g[0] for g in got] == [w[0] for w in want] and len(got) > 0
        np.testing.assert_allclose([g[2] for g in got], [w[2] for w in want], rtol=PRETRAIN_LOSS_RTOL)
        if suffix == "train/loss":
            assert got[0][2] == want[0][2]
    ranks = [load_safetensors(os.path.join(root, f"final_pmp_{r}.safetensors")) for r in range(2)]
    assert all(torch.equal(ranks[0][k], ranks[1][k]) for k in ranks[0])
    before = load_safetensors(os.path.join(root, "before_psp.safetensors"))
    a, b = (load_safetensors(os.path.join(root, tag, "checkpoint-final", "model.safetensors")) for tag in ("pmp", "psp"))
    assert a.keys() == b.keys() and before.keys() < a.keys()
    assert all(torch.equal(a[k], ranks[0][k]) for k in before)
    assert all(torch.equal(a[k], b[k]) for k in a.keys() - before.keys())  # the frozen tower
    diff, update = (math.sqrt(sum(float((x[k].double() - y[k].double()).square().sum()) for k in before))
                    for x, y in ((a, b), (b, before)))
    assert update > 0 and diff / update < PRETRAIN_UPDATE_RTOL, (diff, update)


def test_torchrun_launches_both_entry_points(tmp_path):
    """`torchrun --nproc_per_node 2` runs the trainer's and pretraining's
    command lines with no switch beyond --device cpu: rank 0 writes the
    results and checkpoints, and no entry point raises for mesh [-1, 1]."""
    from PIL import Image

    from mafed_tpu_torch.models.vl_pythia import init_model

    root = str(tmp_path)
    write_synthetic_vqa(root, n_train=16, n_val=4)
    images = os.path.join(root, "images")
    os.makedirs(images)
    rng = np.random.default_rng(0)
    for i in range(16):  # the file each synthetic question names
        Image.fromarray(rng.integers(0, 256, (28, 28, 3)).astype(np.uint8)).save(
            os.path.join(images, f"synthetic_{i}"), format="PNG")
    model_dir = os.path.join(root, "model")
    os.makedirs(model_dir)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(W.tiny_model_cfg().to_dict(), f)
    save_task_checkpoint(init_model(W.tiny_model_cfg(), seed=0, device="cpu").state_dict(),
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
               "--allow_tokenizer_fallback", "--device", "cpu"],
        "pretrain": ["mafed_tpu_torch.pretrain_vlpythia", "--model_name", model_dir, "--manifest",
                     os.path.join(root, "captions.jsonl"), "--output_dir", os.path.join(root, "pretrain"),
                     "--allow_tokenizer_fallback", "--model_max_length", "24", "--per_device_train_batch_size", "2",
                     "--num_train_epochs", "1", "--device", "cpu"],
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
        assert outs[name].count("torch.distributed initialized: rank") == 2, name
    with open(os.path.join(root, "cl", "log", "results.json")) as f:
        assert np.asarray(json.load(f)["accuracy_matrix"]).shape == (2, 2)
    assert all(os.path.exists(os.path.join(root, "cl", "ckpt", f"{t}_best.safetensors")) for t in ("taskA", "taskB"))
    with open(os.path.join(root, "pretrain", "metrics.jsonl")) as f:
        assert [r["_step"] for r in map(json.loads, f) if "train/loss" in r] == [1, 2, 3, 4]  # 16 captions, 4 a batch
    assert os.path.exists(os.path.join(root, "pretrain", "checkpoint-final", "model.safetensors"))
