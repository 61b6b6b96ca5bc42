"""The classifier-VQA path of the port (data/answer_vocab.py,
evaluation/classifier.py) against the JAX package's, on the same seeded
annotations, logits and soft targets."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mafed_tpu.data import answer_vocab as jvocab
from mafed_tpu.evaluation import classifier as jcls

from mafed_tpu_torch.data import answer_vocab as tvocab
from mafed_tpu_torch.evaluation import classifier as tcls

ANSWERS = ["Two", "two", "2", "red", "Red!", "the red one", "yes", "Yes", "no", "a cat", "cat", "cats", "none"]


def _annotations(n=200, seed=0):
    rng = np.random.default_rng(seed)
    return [{"multiple_choice_answer": ANSWERS[int(rng.integers(len(ANSWERS)))]} for _ in range(n)]


@pytest.mark.parametrize("min_count", [1, 9, 25])
def test_answer_vocab_matches_jax(min_count):
    anns = _annotations()
    assert tvocab.build_answer_vocab(anns, min_count) == jvocab.build_answer_vocab(anns, min_count)


def test_soft_targets_match_jax():
    rng = np.random.default_rng(1)
    for _ in range(20):
        answers = [ANSWERS[int(i)] for i in rng.integers(len(ANSWERS), size=10)]
        assert tvocab.soft_target_scores(answers) == jvocab.soft_target_scores(answers)


@pytest.mark.parametrize("keep_max", [False, True])
def test_get_vqa_target_matches_jax(keep_max):
    examples = [{"target": {"labels": [3, 0, 7], "scores": [0.3, 1.0, 0.6]}},
                {"target": {"labels": [], "scores": []}},
                {"target": {"labels": [5], "scores": [0.9]}}]
    for ex in examples:
        got = tvocab.get_vqa_target(ex, 8, keep_max=keep_max)
        want = jvocab.get_vqa_target(ex, 8, keep_max=keep_max)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("text_first, ignore_cls, ignore_eos", [(True, False, True), (False, True, False)])
def test_vqa_masking_matches_jax(text_first, ignore_cls, ignore_eos):
    t = tvocab.VQAMasking(text_first, ignore_cls, ignore_eos).get_language_and_image_masks(7, 5)
    j = jvocab.VQAMasking(text_first, ignore_cls, ignore_eos).get_language_and_image_masks(7, 5)
    for got, want in zip(t, j):
        np.testing.assert_array_equal(got, want)


def _scores(seed, b=16, a=12):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(b, a)).astype(np.float32)
    targets = np.where(rng.random((b, a)) < 0.3, rng.choice([0.3, 0.6, 0.9, 1.0], size=(b, a)), 0.0).astype(np.float32)
    return logits, targets


def test_compute_score_with_logits_matches_jax():
    logits, targets = _scores(2)
    got = tcls.compute_score_with_logits(torch.from_numpy(logits), torch.from_numpy(targets))
    want = np.asarray(jcls.compute_score_with_logits(jnp.asarray(logits), jnp.asarray(targets)))
    assert got.shape == (16,)
    np.testing.assert_array_equal(got.numpy(), want)


def test_vqa_accuracy_matches_jax():
    t_acc, j_acc = tcls.VQAAccuracy(), jcls.VQAAccuracy()
    for seed in range(3):
        logits, targets = _scores(10 + seed, b=5 + seed)
        t_acc(torch.from_numpy(logits), torch.from_numpy(targets))
        j_acc(jnp.asarray(logits), jnp.asarray(targets))
    t_acc.update(torch.zeros(0, 12), torch.zeros(0, 12))  # an empty batch changes nothing
    assert t_acc.total == j_acc.total == 18
    assert t_acc.compute() == pytest.approx(j_acc.compute(), abs=1e-6)
    assert tcls.VQAAccuracy().compute() == jcls.VQAAccuracy().compute() == 0.0


def test_all_reduce_metrics_one_process(monkeypatch):
    """The identity on one rank (tests/test_torch_multiprocess.py sums over
    two, tests/test_torch_tensor_parallel.py over a data group); a mesh of
    more ranks than the run has raises, and so does a launch of several
    ranks that has not joined its process group."""
    assert tcls.all_reduce_metrics(4.0, 2.5, 3.0) == jcls.all_reduce_metrics(4.0, 2.5, 3.0) == (4.0, 2.5, 3.0)
    assert tcls.all_reduce_metrics(4.0, 2.5, 3.0, mesh_shape=(-1, 1)) == (4.0, 2.5, 3.0)
    with pytest.raises(ValueError, match=r"grid of 2 x 1 = 2 ranks, but the run has 1 rank\(s\)"):
        tcls.all_reduce_metrics(4.0, 2.5, 3.0, mesh_shape=(2, 1))
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="no process group"):
        tcls.all_reduce_metrics(4.0, 2.5, 3.0)
