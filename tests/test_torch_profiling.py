"""Profiling and metrics logging of the port: core/profiling.py (trace,
annotate, StepTimer), the trainer's trace window (batches 10-20 of task 0,
epoch 0, as mafed_tpu/trainer/runner.py:687-689,733-737,755-756 open and
close it), and MetricsLogger's wandb branch through a mock module (the cases
of tests/test_logging_wandb.py)."""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

import jax

from mafed_tpu_torch.core import profiling
from mafed_tpu_torch.core.logging import MetricsLogger
from mafed_tpu_torch.models.weights import params_from_jax
from mafed_tpu_torch.trainer import runner as trunner
from mafed_tpu_torch.trainer.continual import ContinualLearningTrainer
from tests.torch_helpers import one_torch_thread, jax_params, tiny_cfgs, write_synthetic_vqa  # noqa: F401 (a fixture)


# --- core/profiling.py -------------------------------------------------------------------

def test_trace_writes_a_chrome_trace_with_annotations(tmp_path):
    with profiling.trace(str(tmp_path / "prof")) as capture:
        with profiling.annotate("mafed_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert capture.path == str(tmp_path / "prof" / profiling.TRACE_FILE)
    with open(capture.path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "mafed_region" in names and "aten::mm" in names


def test_trace_is_a_no_op_without_a_dir(tmp_path):
    with profiling.trace(None) as capture:
        pass
    assert capture is None
    with profiling.trace("") as capture:
        pass
    assert capture is None


def test_step_timer(monkeypatch):
    clock = iter([10.0, 12.0])
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(clock))
    timer = profiling.StepTimer()
    timer.start()
    timer.tick(30)
    timer.tick(10)
    assert timer.stop(sync_on=torch.zeros(1)) == pytest.approx(20.0)  # a CPU tensor: nothing to synchronise


# --- the trainer's trace window ----------------------------------------------------------

@pytest.mark.parametrize("n_train, accumulate, stop_after", [
    (96, 1, 21),  # 24 batches one at a time: stops after batch 20
    (96, 4, 24),  # windows of 4 end at batches 3, 7, ..., 23: the stop check runs after the window holding 20
    (64, 1, 16),  # 16 batches: the epoch ends inside the window
], ids=["steps", "windows", "epoch_end"])
def test_trainer_traces_batches_10_to_20_of_task_0(tmp_path, monkeypatch, n_train, accumulate, stop_after):
    """The trace starts before batch 10 (10 updates' batches done) and stops
    at the first update boundary at or after batch 20, or at the epoch's end;
    only task 0, epoch 0 is traced, into <profile_dir>/trace.json."""
    events = []

    class Recorded(profiling.Trace):
        def start(self):
            events.append(("start", sum(trainer.runner.step_counts.values())))
            return super().start()

        def stop(self):
            events.append(("stop", sum(trainer.runner.step_counts.values())))
            return super().stop()

    monkeypatch.setattr(trunner, "Trace", Recorded)
    jcfg, tc = tiny_cfgs()
    cfg = write_synthetic_vqa(str(tmp_path), n_train=n_train, n_val=4).replace(
        cl_method="naive", compute_dtype="float32", accumulate_grad_batches=accumulate, epochs=[2, 1],
        profile_dir=str(tmp_path / "prof"), device_vision_table_mb=0)
    state_dict = params_from_jax(jax.tree.map(np.asarray, jax_params(jcfg, seed=1)), tc)
    trainer = ContinualLearningTrainer(cfg, model_cfg=tc, synthetic_images=True, init_params=state_dict, device="cpu")
    trainer.main()
    # updates taken when the trace opened and closed (one per batch, or per window of `accumulate`)
    assert events == [("start", 10 // accumulate), ("stop", stop_after // accumulate)]
    with open(tmp_path / "prof" / profiling.TRACE_FILE) as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    assert "aten::mm" in names


# --- MetricsLogger with wandb (a mock module) ------------------------------------------

class FakeRun:
    def __init__(self):
        self.defined = []
        self.logged = []

    def define_metric(self, name, step_metric=None, step_sync=None):
        self.defined.append((name, step_metric))

    def log(self, payload):
        self.logged.append(dict(payload))

    def finish(self):
        self.finished = True


@pytest.fixture
def fake_wandb(monkeypatch):
    mod = types.ModuleType("wandb")
    runs = []

    def init(**kwargs):
        run = FakeRun()
        run.init_kwargs = kwargs
        runs.append(run)
        return run

    mod.init = init
    mod._runs = runs
    monkeypatch.setitem(sys.modules, "wandb", mod)
    return mod


def make_logger(tmp_path):
    return MetricsLogger(project="proj", entity="ent", group="grp", name="run",
                         output_dir=str(tmp_path), use_wandb=True)


def test_define_metric_axes_match_logged_keys(tmp_path, fake_wandb):
    logger = make_logger(tmp_path)
    run = fake_wandb._runs[0]
    assert run.init_kwargs == {"project": "proj", "entity": "ent", "group": "grp", "name": "run"}
    assert ("trainer/global_step", None) in run.defined
    assert ("*", "trainer/global_step") in run.defined
    assert ("validation/*", "trainer/valid_step") in run.defined
    assert logger._wandb is run


def test_train_metrics_carry_offset_global_step(tmp_path, fake_wandb):
    logger = make_logger(tmp_path)
    run = fake_wandb._runs[0]
    logger.log_metrics({"task_0/train_loss": 1.5}, step=7)
    logger.set_global_step_offset(100)
    logger.log_metrics({"task_1/train_loss": 1.0}, step=7)
    assert run.logged[0]["trainer/global_step"] == 7
    assert run.logged[1]["trainer/global_step"] == 107
    assert run.logged[1]["task_1/train_loss"] == 1.0


def test_validation_metrics_use_valid_step_axis_without_offset(tmp_path, fake_wandb):
    logger = make_logger(tmp_path)
    run = fake_wandb._runs[0]
    logger.set_global_step_offset(500)
    logger.log_metrics({"validation/average_accuracy": 0.4, "validation/BWT": -0.01}, step=2, is_valid_step=True)
    payload = run.logged[0]
    assert payload["trainer/valid_step"] == 2
    assert "trainer/global_step" not in payload
    assert payload["validation/average_accuracy"] == pytest.approx(0.4)
    assert payload["validation/BWT"] == pytest.approx(-0.01)


def test_jsonl_written_alongside_wandb(tmp_path, fake_wandb):
    logger = make_logger(tmp_path)
    logger.log_metrics({"task_0/valid_acc": 0.25}, step=3)
    logger.finish()
    lines = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert lines[0]["task_0/valid_acc"] == 0.25
    assert lines[0]["_step"] == 3
    assert getattr(fake_wandb._runs[0], "finished", False)


def test_wandb_init_failure_falls_back_to_jsonl(tmp_path, monkeypatch):
    mod = types.ModuleType("wandb")

    def init(**kwargs):
        raise RuntimeError("no network")

    mod.init = init
    monkeypatch.setitem(sys.modules, "wandb", mod)
    logger = make_logger(tmp_path)
    assert logger._wandb is None
    logger.log_metrics({"x": 1.0}, step=0)
    assert os.path.exists(tmp_path / "metrics.jsonl")
