"""The port's CKA analysis (analysis/cka.py, representation_similarity.py,
sweep.py) against the JAX package's.

Tolerances: the CKA functions on the same float32 inputs within 1e-5 (the
JAX package computes in float32 too; sums run in other orders); hidden
states collected in float32 within 1e-4 (as the tower tests); the sweep
over one tiny experiment directory written by the port's trainer, both
packages at their default bfloat16 forward, within 5e-3 per layer (bf16
rounds at other points in the two frameworks; the two differ by up to
1.2e-3 on this run).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mafed_tpu.analysis import cka as jcka
from mafed_tpu.analysis import representation_similarity as jrs
from mafed_tpu.analysis import sweep as jsweep

from mafed_tpu_torch.analysis import cka as tcka
from mafed_tpu_torch.analysis import representation_similarity as trs
from mafed_tpu_torch.analysis import sweep as tsweep
from mafed_tpu_torch.models.weights import params_from_jax
from mafed_tpu_torch.trainer.continual import ContinualLearningTrainer
from tests.torch_helpers import (  # noqa: F401 (a fixture)
    TINY_VISION_64, jax_params, one_torch_thread, tiny_cfgs, torch_model, write_synthetic_vqa,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _xy(seed, n=48, dx=6, dy=10):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, dx)).astype(np.float32)
    y = (x @ rng.normal(size=(dx, dy)) + 0.5 * rng.normal(size=(n, dy))).astype(np.float32)
    return x, y


@pytest.mark.parametrize("debiased", [False, True], ids=["biased", "debiased"])
def test_cka_functions_match_jax(debiased):
    x, y = _xy(0)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    np.testing.assert_allclose(tcka.gram_linear(tx).numpy(), np.asarray(jcka.gram_linear(x)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tcka.gram_rbf(tx, 0.5).numpy(), np.asarray(jcka.gram_rbf(x, 0.5)), rtol=1e-5, atol=1e-6)
    g = np.array(jcka.gram_linear(x))
    np.testing.assert_allclose(tcka.center_gram(torch.from_numpy(g), unbiased=debiased).numpy(),
                               np.asarray(jcka.center_gram(jnp.asarray(g), unbiased=debiased)), rtol=1e-5, atol=1e-4)
    for kernel in ("gram_linear", "gram_rbf"):
        got = tcka.cka_from_gram(getattr(tcka, kernel)(tx), getattr(tcka, kernel)(ty), debiased=debiased)
        want = jcka.cka_from_gram(getattr(jcka, kernel)(x), getattr(jcka, kernel)(y), debiased=debiased)
        assert got == pytest.approx(want, abs=1e-5), kernel
    got = tcka.feature_space_linear_cka(tx, ty, debiased=debiased)
    assert got == pytest.approx(jcka.feature_space_linear_cka(x, y, debiased=debiased), abs=1e-5)
    # the feature-space form equals the gram form, and numpy input reads as tensors do
    assert got == pytest.approx(tcka.cka_from_gram(tcka.gram_linear(tx), tcka.gram_linear(ty), debiased), abs=1e-5)
    assert tcka.feature_space_linear_cka(x, y, debiased) == got


def test_cka_identities():
    x, _ = _xy(3, n=60)
    tx = torch.from_numpy(x)
    assert tcka.feature_space_linear_cka(tx, tx) == pytest.approx(1.0, abs=1e-5)
    q, _ = np.linalg.qr(np.random.default_rng(4).normal(size=(6, 6)))
    assert tcka.feature_space_linear_cka(tx, 3.0 * tx @ torch.from_numpy(q.astype(np.float32))) == pytest.approx(1.0, abs=1e-4)
    # float64 in, float64 arithmetic; the even-count median of numpy
    assert tcka.feature_space_linear_cka(tx.double(), tx.double()) == pytest.approx(1.0, abs=1e-12)
    d = torch.tensor([[0.0, 1.0], [3.0, 10.0]])
    assert tcka._median(d).item() == np.median(d.numpy()) == 2.0


def _model_and_batches(select_feature="patch"):
    jcfg, tc = tiny_cfgs(TINY_VISION_64)
    jcfg.select_feature = tc.select_feature = select_feature
    params = jax_params(jcfg, seed=4, vision_dtype=jnp.float32)
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(2):
        mask = np.ones((3, 8), np.int32)
        mask[:, :2] = 0
        batches.append({"input_ids": rng.integers(1, 500, size=(3, 8)).astype(np.int32), "attention_mask": mask,
                        "pixels": rng.integers(0, 256, size=(3, 56, 56, 3)).astype(np.uint8)})
    return jcfg, tc, params, batches


def test_collect_hidden_states_matches_jax():
    jcfg, tc, params, batches = _model_and_batches()
    want = jrs.collect_hidden_states(params, jcfg, [{k: jnp.asarray(v) for k, v in b.items()} for b in batches],
                                     max_batches=2, dtype=jnp.float32)
    got = trs.collect_hidden_states(torch_model(params, tc), tc, batches, max_batches=2, dtype=torch.float32)
    assert sorted(got) == sorted(want) == list(range(tc.num_hidden_layers + 1))
    for layer in want:
        for part in ("text", "image"):
            assert got[layer][part].shape == want[layer][part].shape
            np.testing.assert_allclose(got[layer][part].numpy(), want[layer][part], atol=1e-4, rtol=1e-4)
    assert got[0]["image"].shape == (2 * 3 * 16, 128) and got[0]["text"].shape == (2 * 3 * 6, 128)


def test_cls_patch_vision_prefix():
    """select_feature="cls_patch": the prefix is 17 tokens (n_vision_tokens).
    The JAX package slices it at num_patches (16), so its text slice is one
    token longer than the mask and the boolean index raises; the port splits
    the tokens right."""
    jcfg, tc, params, batches = _model_and_batches("cls_patch")
    with pytest.raises(IndexError):
        jrs.collect_hidden_states(params, jcfg, [{k: jnp.asarray(v) for k, v in b.items()} for b in batches],
                                  max_batches=1, dtype=jnp.float32)
    got = trs.collect_hidden_states(torch_model(params, tc), tc, batches, max_batches=1, dtype=torch.float32)
    assert got[0]["image"].shape == (3 * 17, 128) and got[0]["text"].shape == (3 * 6, 128)


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """A two-task run of the port's trainer (tiny model, synthetic images): its output directory."""
    root = tmp_path_factory.mktemp("cka_run")
    jcfg, tc = tiny_cfgs(TINY_VISION_64)
    cfg = write_synthetic_vqa(str(root), n_train=16, n_val=8).replace(
        cl_method="naive", compute_dtype="float32", learning_rate=1e-2, device_vision_table_mb=0)
    state = params_from_jax(jax.tree.map(np.asarray, jax_params(jcfg, seed=1)), tc)
    ContinualLearningTrainer(cfg, model_cfg=tc, synthetic_images=True, init_params=state, device="cpu").main()
    return cfg.output_dir


def test_sweep_matches_jax(experiment):
    got = tsweep.sweep(experiment, max_batches=2, synthetic_images=True, device="cpu")
    want = jsweep.sweep(experiment, max_batches=2, synthetic_images=True)
    assert got.keys() == want.keys()
    assert (got["pairs"], got["layers"], got["probe_task"]) == (want["pairs"], want["layers"], want["probe_task"])
    assert got["pairs"] == ["taskA->taskB"] and got["layers"] == [0, 1, 2, 3]
    for key in ("avg_text_cka", "avg_image_cka"):
        assert all(0.0 <= v <= 1.0 + 1e-6 for v in got[key])
        np.testing.assert_allclose(got[key], want[key], atol=5e-3, err_msg=key)


def test_sweep_cli_writes_the_report(experiment, tmp_path):
    out = str(tmp_path / "report.json")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "mafed_tpu_torch.analysis.sweep", "--experiment_dir", experiment, "--max_batches", "1",
         "--synthetic_images", "--device", "cpu", "--output", out, "--tasks", "taskA", "taskB"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out) as f:
        report = json.load(f)
    assert report["pairs"] == ["taskA->taskB"] and len(report["per_pair"][0]["text_cka"]) == 4
