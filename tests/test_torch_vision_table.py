"""The port's device vision table (mafed_tpu_torch/data/vision_table.py)
against the JAX package's, on the same cache files.

Exact equality throughout, since nothing here is computed in a different
order: table rows gathered by both packages (bfloat16 bits), the int8 rows
and scales of the quantization and the rows dequantized from them (one
bfloat16 multiply of two bfloat16 numbers, correctly rounded on both
sides), the rows the port's dataset, window stacking and validation loop
resolve against the streamed features, and the tier each trainer picks
under the same budgets. Then port sequences: a two-task MAFED run with the
table against the same run streaming its features, float32 on the CPU,
equal accuracy matrices (atol 1e-9, as the JAX package's test) and, beyond
that test, bit-equal checkpoints; with int8 rows, equal accuracy matrices.
"""

import os

import ml_dtypes
import numpy as np
import pytest
import torch

import jax

from mafed_tpu.data import vision_table as jvt
from mafed_tpu.data.factory import get_val_loaders as jax_val_loaders
from mafed_tpu.data.factory import prepare_train_dataset as jax_train_dataset
from mafed_tpu.data.vision_cache import VisionFeatureCache as JVisionFeatureCache
from mafed_tpu.trainer.continual import ContinualLearningTrainer as JaxTrainer
from mafed_tpu_torch.data import vision_table as vt
from mafed_tpu_torch.data.collate import collate_train, collate_val
from mafed_tpu_torch.data.factory import get_val_loaders, prepare_train_dataset
from mafed_tpu_torch.data.loader import BatchLoader
from mafed_tpu_torch.data.vision_cache import VisionFeatureCache
from mafed_tpu_torch.evaluation.validate import validate_vqa
from mafed_tpu_torch.models.weights import load_safetensors, params_from_jax
from mafed_tpu_torch.trainer.continual import ContinualLearningTrainer
from mafed_tpu_torch.trainer.runner import TaskRunner
from tests.helpers import write_synthetic_vqa as jax_write_synthetic_vqa
from tests.torch_helpers import one_torch_thread, jax_params, tiny_cfgs, write_synthetic_vqa  # noqa: F401 (a fixture)

N_PATCHES, DIM = 4, 32  # the tiny tower's features


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).astype(ml_dtypes.bfloat16).view(np.uint16)


def _features(n: int, seed: int = 0) -> np.ndarray:
    """bfloat16-exact float32 features with a spread of magnitudes and one all-zero patch."""
    rng = np.random.default_rng(seed)
    f = rng.normal(size=(n, N_PATCHES, DIM)) * rng.uniform(0.01, 30, size=(n, N_PATCHES, 1))
    f[0, 1] = 0.0
    return f.astype(ml_dtypes.bfloat16).astype(np.float32)


def _caches(root, keys, seed=0):
    """The same features under `keys` in a JAX cache and, read from its files, a port cache."""
    jcache = JVisionFeatureCache(os.path.join(root, "vc"), N_PATCHES, DIM)
    for key, f in zip(keys, _features(len(keys), seed)):
        jcache.save(key, f)
    return jcache, VisionFeatureCache(os.path.join(root, "vc"), N_PATCHES, DIM)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_table_rows_match_jax(tmp_path, dtype):
    keys = [f"synthetic:{i}" for i in range(6)]
    jcache, cache = _caches(str(tmp_path), keys)
    jtable, table = jvt.build_table(jcache, keys, dtype=dtype), vt.build_table(cache, keys, dtype=dtype)
    assert table.key_to_idx == jtable.key_to_idx and table.nbytes == jtable.nbytes
    assert table.nbytes == vt.table_nbytes(len(keys), N_PATCHES, DIM, dtype) == jvt.table_nbytes(len(keys), N_PATCHES, DIM, dtype)
    if dtype == "int8":
        q, scale = table.host
        jq, jscale = jvt._quantize_rows(np.stack([np.asarray(jcache.load(k), np.float32) for k in keys]))
        np.testing.assert_array_equal(q, jq)
        np.testing.assert_array_equal(scale, jscale)
        assert scale[0, 1, 0] == 1.0  # the all-zero patch
    rows = np.asarray([[2, 0, 5], [5, 5, 1]], np.int32)
    for method in ("resolve", "resolve_host"):
        got = getattr(table, method)({"patch_idx": rows, "x": 1})
        want = getattr(jtable, method)({"patch_idx": rows, "x": 1})
        assert "patch_idx" not in got and got["x"] == 1
        assert got["patches"].dtype == torch.bfloat16 and tuple(got["patches"].shape) == (2, 3, N_PATCHES, DIM)
        np.testing.assert_array_equal(_bits(got["patches"]), _bits(want["patches"]), err_msg=method)
    assert table.resolve({"patches": 1}) == {"patches": 1}  # no rows: the batch as it was


def test_table_nbytes_matches_jax():
    for args in ((1, 256, 1024), (7, 4, 32)):
        for dtype in ("bfloat16", "int8"):
            assert vt.table_nbytes(*args, dtype=dtype) == jvt.table_nbytes(*args, dtype=dtype)
    assert vt.table_nbytes(1, 256, 1024, dtype="int8") < vt.table_nbytes(1, 256, 1024) / 1.9


def test_build_table_refuses_a_miss(tmp_path):
    _, cache = _caches(str(tmp_path), ["a"])
    with pytest.raises(RuntimeError, match="cache miss"):
        vt.build_table(cache, ["a", "b"])
    with pytest.raises(ValueError):
        vt.build_table(cache, [])


# --- the port's batches carry rows -------------------------------------------------------

@pytest.fixture
def primed(tmp_path):
    """A task's train and val datasets and a port cache holding features for every image key."""
    _, tc = tiny_cfgs()
    cfg = write_synthetic_vqa(str(tmp_path), n_train=8, n_val=6)
    cache = VisionFeatureCache(str(tmp_path / "vc"), N_PATCHES, DIM)
    from mafed_tpu_torch.data.tokenizer import ByteTokenizer

    ds = prepare_train_dataset(cfg, "taskA", ByteTokenizer(), tc.vision, synthetic_images=True, vision_cache=cache)
    val = get_val_loaders(cfg, ByteTokenizer(), tc.vision, 16, synthetic_images=True, vision_cache=cache)
    keys = list(dict.fromkeys(vt.iter_image_keys([ds] + [v.dataset for v in val.values()])))
    for key, f in zip(keys, _features(len(keys), seed=1)):
        cache.save(key, torch.from_numpy(f))
    return tc, cfg, cache, ds, val["taskA"].dataset, keys


def test_items_ship_rows_and_gather_matches_stream(primed):
    tc, cfg, cache, ds, _, keys = primed
    streamed = torch.stack([ds[i]["patches"] for i in range(4)])
    table = vt.build_table(cache, keys)
    assert vt.attach([ds], table)
    item = ds[0]
    assert "patch_idx" in item and "patches" not in item and "pixels" not in item
    assert isinstance(item["patch_idx"], np.int32)
    batch = collate_train([ds[i] for i in range(4)], text_len=24)
    assert batch["patch_idx"].dtype == np.int32 and batch["patch_idx"].shape == (4,)
    assert torch.equal(table.resolve(batch)["patches"], streamed)
    assert torch.equal(table.resolve_host(batch)["patches"], streamed)
    vt.attach([ds], None)
    assert "patches" in ds[0]


def test_image_keys_through_nesting(primed):
    from mafed_tpu_torch.data.teacher_cache import TeacherStateView
    from mafed_tpu_torch.data.vqa_dataset import ConcatDataset, Subset

    _, _, _, ds, _, _ = primed
    nested = ConcatDataset([TeacherStateView(Subset(ds, [3, 1]), cache=None), ds])
    assert [vt.image_key_of(nested, i) for i in range(3)] == ["synthetic:3", "synthetic:1", "synthetic:0"]
    assert len(list(vt.iter_image_keys([nested]))) == 2 + len(ds)


def test_collate_rejects_mixed_rows():
    a = {"input_ids": np.ones(3, np.int32), "labels": np.asarray([-100, 1, 2], np.int32), "patch_idx": np.int32(0)}
    b = {"input_ids": np.ones(3, np.int32), "labels": np.asarray([-100, 1, 2], np.int32),
         "patches": torch.zeros((4, 8), dtype=torch.bfloat16)}
    with pytest.raises(ValueError, match="mixes vision-table"):
        collate_train([a, b], text_len=8)


def test_stack_window_and_validate_resolve_rows(primed):
    """A window's [n_mb, B] rows stack and gather to the table's rows; decode
    batches of rows reach the decoder as the streamed features."""
    tc, cfg, cache, ds, val_ds, keys = primed
    streamed = torch.stack([val_ds[i]["patches"] for i in range(len(val_ds))])
    runner = TaskRunner(tc, cfg, tokenizer=None, device="cpu")
    runner.vision_table = table = vt.build_table(cache, keys)
    rng = np.random.default_rng(0)
    rows = [rng.integers(0, len(keys), size=4).astype(np.int32) for _ in range(2)]
    stacked = runner.stack_window([{"input_ids": np.ones((4, 8), np.int32), "patch_idx": r} for r in rows])
    assert "patch_idx" not in stacked and tuple(stacked["patches"].shape) == (2, 4, N_PATCHES, DIM)
    assert torch.equal(stacked["patches"], table.host[torch.from_numpy(np.stack(rows)).long()])

    vt.attach([val_ds], table)
    seen = []

    def decoder(model, batch):
        assert "patch_idx" not in batch
        seen.append(batch["patches"])
        return torch.zeros((batch["input_ids"].shape[0], 4), dtype=torch.int32)

    loader = BatchLoader(val_ds, batch_size=4, collate=lambda items: collate_val(items, text_len=16))
    from mafed_tpu_torch.data.tokenizer import ByteTokenizer

    validate_vqa(None, decoder, loader, ByteTokenizer(), batch_size=4, resolve=runner.resolve_tables)
    assert torch.equal(torch.cat(seen)[: len(val_ds)], streamed)  # the short last batch padded, then dropped
    vt.attach([val_ds], None)


# --- the tiers of the two trainers ------------------------------------------------------------

def _attached(datasets):
    return ["patch_idx" in d[0] for d in datasets]


def test_table_tiers_match_jax(tmp_path, monkeypatch):
    """The same datasets, cache contents and budgets (1 MB a key): both
    trainers choose the same tier, with the same rows, and attach the same
    datasets; over every budget the task streams."""
    from mafed_tpu.core.config import ModelConfig, VisionConfig
    from mafed_tpu.data.vqa_dataset import Subset as JSubset
    from mafed_tpu_torch.core import config as tcfg
    from mafed_tpu_torch.data.vqa_dataset import Subset

    root = str(tmp_path)
    jcfg = jax_write_synthetic_vqa(os.path.join(root, "data"), n_train=8, n_val=12)
    jcfg = jcfg.replace(cl_method="naive", output_dir=os.path.join(root, "jax"))
    vis = dict(img_size=28, patch_size=14, embed_dim=DIM, depth=2, num_heads=2, mlp_ratio=2.0)
    dec = dict(vocab_size=512, hidden_size=32, num_hidden_layers=3, num_attention_heads=2, intermediate_size=64)
    jax_trainer = JaxTrainer(jcfg, model_cfg=ModelConfig(**dec, vision=VisionConfig(**vis)), synthetic_images=True,
                             use_mesh=False)
    cfg = tcfg.TrainConfig.from_dict({**jcfg.to_dict(), "output_dir": os.path.join(root, "torch")})
    trainer = ContinualLearningTrainer(cfg, model_cfg=tcfg.ModelConfig(**dec, vision=tcfg.VisionConfig(**vis)),
                                       synthetic_images=True, device="cpu")
    for key, f in zip([f"synthetic:{i}" for i in range(12)], _features(12, seed=2)):
        jax_trainer.vision_cache.save(key, f)
        trainer.vision_cache.save(key, torch.from_numpy(f))

    def setup(t, val_loaders, train_dataset):
        t.val_loaders = val_loaders(t.config, t.tokenizer, t.model_cfg.vision, t.runner.val_text_len,
                                    synthetic_images=True, vision_cache=t.vision_cache)
        ds = {task: train_dataset(t.config, task, t.tokenizer, t.model_cfg.vision, synthetic_images=True,
                                  vision_cache=t.vision_cache) for task in t.config.tasks}
        return ds, [t.val_loaders[task].dataset for task in t.config.tasks]

    jds, jval = setup(jax_trainer, jax_val_loaders, jax_train_dataset)
    ds, val = setup(trainer, get_val_loaders, prepare_train_dataset)
    monkeypatch.setattr(jvt, "table_nbytes", lambda n, p, d, **kw: n * (1 << 20))
    monkeypatch.setattr(vt, "table_nbytes", lambda n, p, d, **kw: n * (1 << 20))

    class Memory:  # a strategy's memory: 4 examples of task A's images 4..7
        def __init__(self, subset, train):
            self.datasets = [subset(train, [4, 5, 6, 7])]

    # 12 keys over the train set, the memory and the val sets; 8 over train + memory
    for budget, rows in ((1024, 12), (12, 12), (11, 8), (8, 8), (7, None)):
        choices = []
        for t, subset, train, val_sets in ((jax_trainer, JSubset, jds, jval), (trainer, Subset, ds, val)):
            t.config = t.config.replace(device_vision_table_mb=budget)
            t._refresh_vision_table(Memory(subset, train["taskA"]), train["taskB"], "taskB")
            table = t.runner.vision_table
            choices.append((None if table is None else len(table), _attached([train["taskB"]] + val_sets)))
        assert choices[0] == choices[1], (budget, choices)
        assert choices[1][0] == rows, (budget, choices)
    assert trainer.vision_tables[-1] == {"tier": None, "rows": 0, "mb": 0.0}
    assert [t["tier"] for t in trainer.vision_tables[:4]] == ["train+memory+val"] * 2 + ["train+memory"] * 2


# --- sequences: the table against streaming ------------------------------------------------------

MAFED = dict(cl_method="featdistill", accumulate_grad_batches=4, replay_interval=4, cl_memory=8,
             compute_dtype="float32", distillation_modality_weighing_strategy="balanced",
             distillation_layer_weighing_strategy="discounted", distillation_layer_discount=0.5)


def _sequence(root, **overrides):
    jm, tc = tiny_cfgs()
    params = params_from_jax(jax.tree.map(np.asarray, jax_params(jm, seed=2)), tc)
    cfg = write_synthetic_vqa(root, n_train=32, n_val=4).replace(**{**MAFED, **overrides})
    trainer = ContinualLearningTrainer(cfg, model_cfg=tc, synthetic_images=True, init_params=params, device="cpu")
    return cfg, trainer, trainer.main()


def test_featdistill_table_matches_streaming(tmp_path):
    cfg_t, trainer_t, r_table = _sequence(str(tmp_path / "table"))
    cfg_s, trainer_s, r_stream = _sequence(str(tmp_path / "stream"), device_vision_table_mb=0)
    assert [t["tier"] for t in trainer_t.vision_tables] == ["train+memory+val"] * 2
    assert trainer_s.vision_tables == [] and trainer_s.runner.vision_table is None
    assert [log["steps"] for log in trainer_t.fit_logs] == [{"ce_window": 2}, {"mafed_window": 2}]
    np.testing.assert_allclose(np.asarray(r_table["accuracy_matrix"]), np.asarray(r_stream["accuracy_matrix"]),
                               atol=1e-9)
    for task in cfg_t.tasks:
        a = load_safetensors(os.path.join(cfg_t.output_dir, "ckpt", f"{task}_best.safetensors"))
        b = load_safetensors(os.path.join(cfg_s.output_dir, "ckpt", f"{task}_best.safetensors"))
        assert all(torch.equal(a[k], b[k]) for k in a), task

    _, trainer_8, r_int8 = _sequence(str(tmp_path / "int8"), vision_table_dtype="int8")
    assert trainer_8.runner.vision_table.dtype == "int8"
    np.testing.assert_allclose(np.asarray(r_int8["accuracy_matrix"]), np.asarray(r_stream["accuracy_matrix"]),
                               atol=1e-9)
