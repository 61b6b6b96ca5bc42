"""The port's teacher-state cache (mafed_tpu_torch/data/teacher_cache.py and
cl/distillation.py's policy) against the JAX package's.

Exact: the mode parsing, cache files read across packages, the table's
rows against the streamed states, the bookkeeping (generations, stamps,
ids). Computed:

  * the states each package primes for the same weights and examples: both
    run a bfloat16 forward, with XLA's attention against the port's plain
    one, so they differ by a bfloat16 ulp or two (measured on a CPU: 2.0e-3
    at most on states of magnitude up to 0.25). Held within atol 4e-3, and
    against a float64 forward of the port, the port's states no farther
    than 1.5x the JAX package's (measured 1.03x);
  * a distill step, and fused and unfused MAFED windows, fed the primed
    states against the same step with its in-step teacher, bfloat16 as the
    primed states: loss rtol 1e-5, parameters rtol 1e-5 + atol 1e-6 (as
    the JAX package's test);
  * a two-task MAFED sequence of each trainer from the same weights, with
    the trainer's default settings (the vision table, teacher_state_cache
    "auto", device_teacher_table_mb 4096: the states fit and go to the
    table) and with device_teacher_table_mb 0 ("auto" keeps the in-step
    teacher): equal accuracy matrices; checkpoints within atol 5e-6 with
    the table (each package trains on the states it primed: measured
    9.3e-7) and 1e-6 without (measured 2.4e-8).
"""

import os
import shutil

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mafed_tpu.data import teacher_cache as jtc
from mafed_tpu.data.collate import collate_train as jcollate
from mafed_tpu.trainer.continual import ContinualLearningTrainer as JaxTrainer
from mafed_tpu.training.train_state import split_params
from mafed_tpu_torch.core import config as tcfg
from mafed_tpu_torch.data import teacher_cache as ttc
from mafed_tpu_torch.data.collate import collate_train
from mafed_tpu_torch.data.vision_cache import VisionFeatureCache, vision_fingerprint
from mafed_tpu_torch.models import vl_pythia as tvl
from mafed_tpu_torch.models.weights import load_safetensors, params_from_jax
from mafed_tpu_torch.optim.optimizer import build_optimizer, set_schedule
from mafed_tpu_torch.trainer.continual import ContinualLearningTrainer
from mafed_tpu_torch.training.step import make_distill_step, make_mafed_window_step
from mafed_tpu_torch.training.train_state import TrainState, make_teacher, trainable_parameters
from tests.helpers import write_synthetic_vqa as jax_write_synthetic_vqa
from tests.torch_helpers import batch as np_batch
from tests.torch_helpers import one_torch_thread, jax_params, stack, tiny_cfgs, to_torch, torch_model  # noqa: F401 (a fixture)

STATES_ATOL = 4e-3
TABLE_PARAM_ATOL, INSTEP_PARAM_ATOL = 5e-6, 1e-6


@pytest.mark.parametrize("value", [True, False, "auto", "AUTO", "on", "off", "1", "0", "", "true", "no", "sometimes"])
def test_resolve_teacher_cache_mode_matches_jax(value):
    try:
        want = jtc.resolve_teacher_cache_mode(value)
    except ValueError:
        with pytest.raises(ValueError):
            ttc.resolve_teacher_cache_mode(value)
        return
    assert ttc.resolve_teacher_cache_mode(value) == want


def test_cache_roundtrip_generations_and_cross_read(tmp_path):
    base = str(tmp_path / "tc")
    c0 = ttc.TeacherStateCache(base, generation=0, n_states=3, seq_len=8, hidden=4)
    states = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 8, 4)).astype(np.float32))
    c0.save("q1", states)
    assert c0.has("q1") and not c0.has("q2")
    assert torch.equal(c0.load("q1"), states.to(torch.bfloat16))
    with pytest.raises(ValueError):
        c0.save("bad", torch.zeros(2, 8, 4))
    # the JAX package reads the port's entry, and the port reads the JAX package's
    j0 = jtc.TeacherStateCache(base, generation=0, n_states=3, seq_len=8, hidden=4)
    np.testing.assert_array_equal(np.asarray(j0.load("q1"), np.float32), states.to(torch.bfloat16).float().numpy())
    j0.save(7, states.numpy() * 2)
    assert torch.equal(c0.load(7), (states * 2).to(torch.bfloat16))

    c1 = ttc.TeacherStateCache(base, generation=1, n_states=3, seq_len=8, hidden=4)
    c1.drop_older_generations()
    assert not os.path.isdir(c0.cache_dir) and os.path.isdir(c1.cache_dir) and not c1.has("q1")


def test_stale_fingerprint_wipes_cache(tmp_path):
    cache = ttc.TeacherStateCache(str(tmp_path), generation=0, n_states=2, seq_len=4, hidden=3)
    cache.set_fingerprint("teacher:run-A")
    cache.save("q0", torch.ones(2, 4, 3))
    assert cache.set_fingerprint("teacher:run-A") is False and cache.has("q0")
    assert cache.set_fingerprint("teacher:run-B") is True and not cache.has("q0")
    cache.save("q1", torch.ones(2, 4, 3))
    os.remove(os.path.join(cache.cache_dir, "fingerprint.json"))  # entries and no stamp
    assert cache.set_fingerprint("teacher:run-B") is True and not cache.has("q1")


class _Memory:
    """Memory examples with ids, text and cached patches; counts full loads."""

    def __init__(self, items, port=True):
        self.items, self.port, self.loads = items, port, []

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        self.loads.append(i)
        it = dict(self.items[i])
        if "patches" in it:
            p = it["patches"]
            it["patches"] = torch.from_numpy(p).to(torch.bfloat16) if self.port else p.astype(ml_dtypes.bfloat16)
        return it

    def question_id(self, i):
        return self.items[i]["question_id"]


def _items(tc, n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        ids = rng.integers(1, 500, size=int(rng.integers(6, 14))).astype(np.int32)
        labels = ids.copy()
        labels[:-3] = -100
        out.append({"question_id": f"q{i}", "input_ids": ids, "labels": labels,
                    "patches": rng.normal(size=(tc.vision.num_patches, tc.vision.embed_dim)).astype(np.float32)})
    return out


def test_priming_rejects_missing_or_duplicate_qids_and_scans_metadata(tmp_path):
    cache = ttc.TeacherStateCache(str(tmp_path), generation=0, n_states=2, seq_len=4, hidden=3)
    teacher = torch.nn.Linear(1, 1)  # fingerprinted only: nothing is left to prime
    for qids, match in ((("q0", None, "q2"), "question_id"), (("q0", "q1", "q0"), "duplicate")):
        with pytest.raises(ValueError, match=match):
            ttc.prime_teacher_cache(cache, _Memory([{"question_id": q} for q in qids]), teacher, None, 1)
    cache.set_fingerprint(ttc.teacher_fingerprint(teacher))
    for i in range(3):
        cache.save(f"q{i}", torch.zeros(2, 4, 3))
    memory = _Memory([{"question_id": f"q{i}"} for i in range(3)])
    assert ttc.prime_teacher_cache(cache, memory, teacher, None, 1) == 0
    assert memory.loads == []  # a warm cache costs no item load


TEXT_LEN = 16


def _prime_both(tmp_path, params, jm, tc, n=6, jax_too=True):
    """The states the JAX package (with `jax_too`) and the port prime for the
    same bf16 teacher (decoder and tower) and memory examples, in batches of
    4 (a short last one); the port's teacher."""
    items = _items(tc, n)
    deep = tc.num_hidden_layers - 2
    seq = ttc.teacher_seq_len(tc, TEXT_LEN)
    jcache = None
    if jax_too:
        trainable, frozen = split_params(params)
        jcache = jtc.TeacherStateCache(str(tmp_path / "jax"), 0, deep + 1, seq, tc.hidden_size)
        assert jtc.prime_teacher_cache(
            jcache, _Memory(items, port=False), jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), trainable),
            frozen, jm, collate=lambda it: jcollate(it, text_len=TEXT_LEN), deepest_tap=deep, batch_size=4) == n
    model = torch_model(params, tc)
    model.vision_encoder.to(torch.bfloat16)
    teacher = make_teacher(model)
    cache = ttc.TeacherStateCache(str(tmp_path / "port"), 0, deep + 1, seq, tc.hidden_size)
    assert ttc.prime_teacher_cache(cache, _Memory(items), teacher, lambda it: collate_train(it, text_len=TEXT_LEN),
                                   deep, batch_size=4) == n
    return items, jcache, cache, teacher


def test_primed_states_match_jax(tmp_path):
    jm, tc = tiny_cfgs()
    params = jax.tree.map(np.asarray, jax_params(jm, seed=3))
    items, jcache, cache, teacher = _prime_both(tmp_path, params, jm, tc)
    deep = tc.num_hidden_layers - 2
    batch = collate_train([_Memory(items)[i] for i in range(len(items))], text_len=TEXT_LEN)
    with torch.no_grad():
        ref = tvl.forward(torch_model(params, tc, dtype=torch.float64), torch.from_numpy(batch["input_ids"]),
                          torch.from_numpy(batch["attention_mask"]), None, patch_embeddings=batch["patches"].double(),
                          output_hidden_states=True, dtype=torch.float64, need_logits=False,
                          num_layers=deep).hidden_states.transpose(0, 1).numpy()
    port = np.stack([cache.load(it["question_id"]).float().numpy() for it in items])
    want = np.stack([np.asarray(jcache.load(it["question_id"]), np.float32) for it in items])
    assert port.shape == (len(items), deep + 1, ttc.teacher_seq_len(tc, TEXT_LEN), tc.hidden_size)
    np.testing.assert_allclose(port, want, atol=STATES_ATOL, rtol=0)
    assert np.abs(port - ref).max() <= 1.5 * np.abs(want - ref).max()

    # the same weights in float32 stamp alike: a restart does not re-prime
    again = make_teacher(torch_model(params, tc))
    assert ttc.teacher_fingerprint(again) == ttc.teacher_fingerprint(teacher)
    assert ttc.prime_teacher_cache(cache, _Memory(items), again.float(), None, deep) == 0


def test_table_gather_matches_streamed_states(tmp_path):
    cache = ttc.TeacherStateCache(str(tmp_path), generation=0, n_states=2, seq_len=4, hidden=3)
    rng = np.random.default_rng(3)
    qids = ["q0", "q1", "q2"]
    for q in qids:
        cache.save(q, torch.from_numpy(rng.standard_normal((2, 4, 3)).astype(np.float32)))
    table = ttc.build_teacher_table(cache, qids)
    assert table.nbytes == ttc.teacher_table_nbytes(3, 2, 4, 3) == jtc.teacher_table_nbytes(3, 2, 4, 3)
    memory = _Memory([{"question_id": q, "input_ids": np.asarray([1, 2], np.int32),
                       "labels": np.asarray([-100, 2], np.int32), "patches": np.zeros((2, 3), np.float32)}
                      for q in qids])
    by_rows = [ttc.TeacherIndexView(memory, table)[i] for i in (2, 0, 1)]
    streamed = [ttc.TeacherStateView(memory, cache)[i] for i in (2, 0, 1)]
    b_idx, b_st = collate_train(by_rows, text_len=4), collate_train(streamed, text_len=4)
    assert b_idx["t_idx"].tolist() == [2, 0, 1] and b_idx["t_idx"].dtype == np.int32
    resolved = table.resolve(b_idx)
    assert "t_idx" not in resolved and torch.equal(resolved["t_hs"], b_st["t_hs"])
    assert ttc.TeacherStateView(memory, cache).question_id(1) == "q1"
    with pytest.raises(ValueError, match="mixes cached teacher states"):
        collate_train(streamed[:1] + [{k: v for k, v in streamed[1].items() if k != "t_hs"}], text_len=4)


@pytest.mark.parametrize("path", ["distill_step", "window_fused", "window_unfused"])
def test_cached_teacher_matches_in_step(tmp_path, path):
    """bf16 steps from the same weights: the teacher's states primed by
    prime_teacher_cache against the teacher the step runs."""
    jm, tc = tiny_cfgs()
    params = jax.tree.map(np.asarray, jax_params(jm, seed=0))
    items, _, cache, teacher = _prime_both(tmp_path, params, jm, tc, n=4, jax_too=False)
    memory = collate_train([_Memory(items)[i] for i in range(4)], text_len=TEXT_LEN)
    cached = {**memory, "t_hs": torch.stack([cache.load(it["question_id"]) for it in items])}
    train_cfg = tcfg.TrainConfig(batch_size=4, learning_rate=1e-3, optim="adamw", replay_coeff=1.0,
                                 distillation_coeff=1.0, distillation_modality_weighing_strategy="balanced",
                                 distillation_layer_weighing_strategy="discounted", distillation_layer_discount=0.5,
                                 compute_dtype="bfloat16", label_tail=0)
    lang = torch.full((tc.num_hidden_layers - 1,), 0.5)
    ce = to_torch(stack([np_batch(tc, 4, TEXT_LEN, seed=s) for s in (1, 2, 3)]))

    def run(distill_batch):
        model = torch_model(params, tc)
        trainable = trainable_parameters(model)
        opt = build_optimizer(train_cfg, trainable)
        state = TrainState(0, model, set_schedule(opt.init(trainable), 0, 100))
        batch = {k: torch.as_tensor(v) for k, v in distill_batch.items()}
        if path == "distill_step":
            _, m = make_distill_step(tc, train_cfg, opt, device="cpu")(state, teacher, batch, lang)
        else:
            step = make_mafed_window_step(tc, train_cfg, opt, n_ce=3, fuse_ce_batch=path == "window_fused", device="cpu")
            _, m = step(state, teacher, ce, batch, lang)
        return float(m["loss"]), {k: v.detach().clone() for k, v in trainable.items()}

    (loss_ref, p_ref), (loss_c, p_c) = run(memory), run(cached)
    np.testing.assert_allclose(loss_c, loss_ref, rtol=1e-5, atol=1e-6)
    for k in p_ref:
        np.testing.assert_allclose(p_c[k].numpy(), p_ref[k].numpy(), rtol=1e-5, atol=1e-6, err_msg=k)


# --- sequences against the JAX trainer ---------------------------------------------------------

MAFED = dict(cl_method="featdistill", accumulate_grad_batches=4, replay_interval=4, cl_memory=8,
             compute_dtype="float32", distillation_modality_weighing_strategy="balanced",
             distillation_layer_weighing_strategy="discounted", distillation_layer_discount=0.5)


@pytest.fixture(scope="module")
def sequences(tmp_path_factory):
    """{table_mb: (jax cfg, jax result, port cfg, port trainer, port result)}:
    one sequence of each trainer from the same weights, the port's vision
    cache seeded with the JAX run's feature files (both train on the same
    patches); the settings the tests do not name are the trainer's defaults."""
    root = str(tmp_path_factory.mktemp("teacher_cache_seq"))
    jm, tc = tiny_cfgs()
    params = jax.tree.map(np.asarray, jax_params(jm, seed=0))
    out = {}
    for mb in (tcfg.TrainConfig().device_teacher_table_mb, 0):
        jcfg = jax_write_synthetic_vqa(os.path.join(root, f"data{mb}"), n_train=32, n_val=4)
        jcfg = jcfg.replace(output_dir=os.path.join(root, f"jax{mb}"), device_teacher_table_mb=mb, **MAFED)
        jax_result = JaxTrainer(jcfg, model_cfg=jm, synthetic_images=True, init_params=params, use_mesh=False).main()
        cfg = tcfg.TrainConfig.from_dict({**jcfg.to_dict(), "output_dir": os.path.join(root, f"torch{mb}")})
        cache = VisionFeatureCache(os.path.join(cfg.output_dir, "vision_cache"), tc.vision.num_patches,
                                   tc.vision.embed_dim)
        cache.set_fingerprint(vision_fingerprint(torch_model(params, tc)))
        jax_cache = os.path.join(jcfg.output_dir, "vision_cache")
        for sub in os.listdir(jax_cache):
            if os.path.isdir(os.path.join(jax_cache, sub)):
                shutil.copytree(os.path.join(jax_cache, sub), os.path.join(cache.cache_dir, sub))
        trainer = ContinualLearningTrainer(cfg, model_cfg=tc, synthetic_images=True,
                                           init_params=params_from_jax(params, tc), device="cpu")
        out[mb] = (jcfg, jax_result, cfg, trainer, trainer.main())
    return out


@pytest.mark.parametrize("table_mb, tier, atol", [(4096, "table", TABLE_PARAM_ATOL), (0, "in-step", INSTEP_PARAM_ATOL)],
                         ids=["default_table", "auto_over_budget"])
def test_featdistill_sequence_matches_jax(sequences, table_mb, tier, atol):
    from safetensors.numpy import load_file

    jcfg, jax_result, cfg, trainer, result = sequences[table_mb]
    assert cfg.teacher_state_cache == "auto" and cfg.device_vision_table_mb == tcfg.TrainConfig().device_vision_table_mb
    assert trainer.primed == [0, 0, 0]
    assert [log["tier"] for log in trainer.strategy.teacher_cache_log] == [tier]
    assert [log["steps"] for log in trainer.fit_logs] == [{"ce_window": 2}, {"mafed_window": 2}]
    for out in (jcfg.output_dir, cfg.output_dir):  # primed states on disk only where the table engaged
        assert os.path.isdir(os.path.join(out, "teacher_cache", "gen0")) == (tier == "table")
    if tier == "table":
        log = trainer.strategy.teacher_cache_log[0]
        assert log["primed"] == log["examples"] == 8 and trainer.runner.teacher_table is not None
    np.testing.assert_array_equal(np.asarray(result["accuracy_matrix"]), np.asarray(jax_result["accuracy_matrix"]))
    for task in cfg.tasks:
        got = load_safetensors(os.path.join(cfg.output_dir, "ckpt", f"{task}_best.safetensors"))
        want = load_file(os.path.join(jcfg.output_dir, "ckpt", f"{task}_best.safetensors"))
        for k, w in want.items():
            np.testing.assert_allclose(got[k].numpy(), w, atol=atol, rtol=0, err_msg=f"{task}:{k}")
