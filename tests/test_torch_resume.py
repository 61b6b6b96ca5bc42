"""Resume bundles and cooperative preemption in the port's trainer
(mafed_tpu_torch/core/preempt.py, trainer/runner.py), the contracts of the
JAX package's tests/test_preempt.py and tests/test_resume.py.

A run preempted at an update boundary (Preempted, exit code 143, a
mid-epoch bundle) and restarted with resume_from_checkpoint ends with
parameters and checkpoints equal bit for bit to the run never interrupted
(float32 on the CPU): on fused windows, on the per-microbatch MultiSteps
cadence, for two-task replay and for two-task MAFED with the vision table
and the teacher table on (the trainer's defaults), and from an epoch-end
bundle that carries part of a window into the next epoch. A bundle saved
after the early stop trains no further epoch, and its model.safetensors
reads in the JAX package.
"""

import json
import os
import signal

import numpy as np
import pytest
import torch

import jax

from mafed_tpu_torch.core import preempt
from mafed_tpu_torch.models.weights import load_safetensors, params_from_jax
from mafed_tpu_torch.trainer.continual import ContinualLearningTrainer
from tests.torch_helpers import one_torch_thread, jax_params, tiny_cfgs, write_synthetic_vqa  # noqa: F401 (a fixture)


@pytest.fixture(autouse=True)
def _clean_preempt_state():
    preempt.clear()
    yield
    preempt.clear()


def test_signal_handler_sets_flag_and_chains():
    seen = []
    prev = signal.signal(signal.SIGUSR1, lambda signum, frame: seen.append(signum))
    try:
        preempt.install_handlers((signal.SIGUSR1,))
        assert not preempt.preemption_requested()
        os.kill(os.getpid(), signal.SIGUSR1)
        assert preempt.preemption_requested() and seen == [signal.SIGUSR1]
        preempt.clear()
        assert not preempt.preemption_requested()
    finally:
        signal.signal(signal.SIGUSR1, prev)


def test_request_after_counts_updates():
    preempt.request_preemption_after(2)
    assert not preempt.preemption_requested()
    preempt.tick_update()
    assert not preempt.preemption_requested()
    preempt.tick_update()
    assert preempt.preemption_requested()
    assert preempt.Preempted().code == 143


def _trainer(root, out, tasks=("taskA",), n_train=16, **overrides):
    jm, tc = tiny_cfgs()
    params = params_from_jax(jax.tree.map(np.asarray, jax_params(jm, seed=4)), tc)
    cfg = write_synthetic_vqa(root, tasks=tasks, n_train=n_train, n_val=4)
    cfg = cfg.replace(output_dir=out, accumulate_grad_batches=2, log_every=100, compute_dtype="float32", **overrides)
    return ContinualLearningTrainer(cfg, model_cfg=tc, synthetic_images=True, init_params=params, device="cpu")


def _files(out, tasks):
    paths = [os.path.join(out, "resume", "model.safetensors")]
    paths += [os.path.join(out, "ckpt", f"{t}_best.safetensors") for t in tasks]
    return [load_safetensors(p) for p in paths]


def _assert_same(a_files, b_files):
    for a, b in zip(a_files, b_files):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), f"{k} diverged after the resume"


def _meta(out):
    with open(os.path.join(out, "resume", "fit_state.json")) as f:
        return json.load(f)


TWO_TASKS = dict(tasks=("taskA", "taskB"), cl_memory=8, replay_interval=4, epochs=[1, 2])
FEATDISTILL = dict(TWO_TASKS, cl_method="featdistill", distillation_modality_weighing_strategy="balanced",
                   distillation_layer_weighing_strategy="discounted", distillation_layer_discount=0.5)


# (overrides, updates before the preemption, the bundle's expected fields)
CASES = {
    # 4 batches an epoch, windows of 2: stopped after the first window of epoch 0
    "fused_window": (dict(cl_method="naive", epochs=[2]), 1, {"task_id": 0, "epoch": 0, "batches_done": 2}),
    "multisteps": (dict(cl_method="naive", epochs=[2], fused_window=False), 3,
                   {"task_id": 0, "epoch": 0, "batches_done": 3}),
    # task 0 takes 2 updates; stopped after task 1's second window (one memory draw)
    "replay_two_task": (dict(TWO_TASKS, cl_method="replay"), 4,
                        {"task_id": 1, "epoch": 0, "batches_done": 4, "mem_draws": 1}),
    "featdistill_two_task_tables": (FEATDISTILL, 4, {"task_id": 1, "epoch": 0, "batches_done": 4, "mem_draws": 1}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_preempt_then_resume_matches_uninterrupted(tmp_path, case):
    overrides, after, expected = CASES[case]
    root = str(tmp_path)
    t_a = _trainer(root, os.path.join(root, "a"), **overrides)
    r_a = t_a.main()
    tasks = t_a.config.tasks

    out_b = os.path.join(root, "b")
    preempt.request_preemption_after(after)
    t_b = _trainer(root, out_b, **overrides)
    with pytest.raises(preempt.Preempted) as exc:
        t_b.main()
    assert exc.value.code == 143
    meta = _meta(out_b)
    assert {k: meta[k] for k in expected} == expected
    assert meta["global_step"] == meta["batches_done"]  # the task's microbatches so far, all of epoch 0
    if case == "featdistill_two_task_tables":
        assert [t["tier"] for t in t_b.vision_tables] == ["train+memory+val"] * 2
        assert [log["tier"] for log in t_b.strategy.teacher_cache_log] == ["table"]

    preempt.clear()
    t_b2 = _trainer(root, out_b, resume_from_checkpoint=os.path.join(out_b, "resume"), **overrides)
    r_b = t_b2.main()
    assert r_b["accuracy_matrix"] == r_a["accuracy_matrix"]
    _assert_same(_files(t_a.config.output_dir, tasks), _files(out_b, tasks))
    if len(tasks) == 2:
        # task 0 finished before the bundle: loaded, not trained again
        assert len(t_b2.fit_logs) == 1
    if case == "featdistill_two_task_tables":
        assert [log["primed"] for log in t_b2.strategy.teacher_cache_log] == [0]  # the restart's cache is warm

        def steps_of(trainer, key):
            with open(os.path.join(trainer.config.output_dir, "log", "metrics.jsonl")) as f:
                return {rec["_step"] for rec in map(json.loads, f) if key in rec}

        # the restart's task-1 records continue the global step axis (the bundle's metrics offset)
        assert steps_of(t_a, "task_1/valid_acc") <= steps_of(t_b2, "task_1/valid_acc")


def test_epoch_bundle_window_carry_resume_matches_uninterrupted(tmp_path):
    """5 batches an epoch, windows of 2: each epoch carries one microbatch
    into the next; the resume replays it into its first window."""
    root = str(tmp_path)
    t_a = _trainer(root, os.path.join(root, "a"), n_train=20, cl_method="naive", epochs=[2])
    t_a.main()
    out_b = os.path.join(root, "b")
    _trainer(root, out_b, n_train=20, cl_method="naive", epochs=[1]).main()
    assert _meta(out_b)["window_carry"] == [[0, 4]]
    _trainer(root, out_b, n_train=20, cl_method="naive", epochs=[2],
             resume_from_checkpoint=os.path.join(out_b, "resume")).main()
    _assert_same(_files(t_a.config.output_dir, ["taskA"]), _files(out_b, ["taskA"]))


def test_resume_after_early_stop_trains_no_extra_epoch(tmp_path, monkeypatch):
    """The epoch-end bundle is saved before the early-stop check: a restart
    from one whose patience ran out trains nothing more."""
    import mafed_tpu_torch.trainer.runner as runner_mod

    real_validate = runner_mod.validate_vqa
    calls = []

    def fixed_validate(*args, **kw):  # a constant accuracy: epoch 1 exhausts patience 1
        calls.append(1)
        log, preds = real_validate(*args, **kw)
        return {**log, "valid/acc": 0.5}, preds

    monkeypatch.setattr(runner_mod, "validate_vqa", fixed_validate)
    out = str(tmp_path / "out")
    t1 = _trainer(str(tmp_path), out, cl_method="naive", epochs=[4], patience=1)
    t1.main()
    meta = _meta(out)
    assert meta["task_id"] == 0 and meta["epoch"] == 1 and meta["wait"] >= 1
    assert len(calls) == 3  # two epochs, then the eval round
    calls.clear()
    t2 = _trainer(str(tmp_path), out, cl_method="naive", epochs=[4], patience=1,
                  resume_from_checkpoint=os.path.join(out, "resume"))
    t2.main()
    assert calls == [1]  # the eval round only
    assert t2.fit_logs[0]["steps"] == {} and t2.fit_logs[0]["epochs_run"] == 2


def test_bundles_each_epoch_and_read_by_jax(tmp_path):
    """resume_bundle_every=1 (the default): a bundle at each epoch end, its
    save time logged, its model readable by the JAX package; a resume past
    the last epoch trains nothing; resume_bundle_every=0 writes none."""
    from mafed_tpu.utils.checkpoint import load_task_checkpoint as jax_load
    from mafed_tpu_torch.utils.checkpoint import load_opt_state

    out = str(tmp_path / "out")
    trainer = _trainer(str(tmp_path), out, cl_method="naive", epochs=[2])
    assert trainer.config.resume_bundle_every == 1
    trainer.main()
    meta = _meta(out)
    assert meta["task_id"] == 0 and meta["epoch"] == 1 and meta["opt_counters"]["adam.count"] == 4
    assert len(trainer.runner.bundle_save_s) == 2
    with open(os.path.join(out, "log", "metrics.jsonl")) as f:
        saves = [v for rec in map(json.loads, f) for k, v in rec.items() if k.endswith("bundle_save_s")]
    assert len(saves) == 2 and all(s >= 0 for s in saves)

    params = load_safetensors(os.path.join(out, "resume", "model.safetensors"))
    want = params_from_jax(jax.tree.map(np.asarray, jax_load(os.path.join(out, "resume", "model.safetensors"),
                                                             tiny_cfgs()[0])), trainer.model_cfg)
    assert params.keys() == want.keys() and all(torch.equal(params[k], want[k]) for k in params)
    state = trainer.runner.init_state(params)
    restored = load_opt_state(state.opt_state, os.path.join(out, "resume", "opt_state.safetensors"),
                              meta["opt_counters"])
    assert restored.adam.count == 4 and restored.schedule.count == 4

    again = _trainer(str(tmp_path), out, cl_method="naive", epochs=[2], resume_from_checkpoint=os.path.join(out, "resume"))
    again.main()
    assert again.fit_logs[0]["steps"] == {}

    none = str(tmp_path / "none")
    _trainer(str(tmp_path), none, cl_method="naive", epochs=[1], resume_bundle_every=0).main()
    assert not os.path.exists(os.path.join(none, "resume"))
