"""The port's data pipeline, caches and checkpoints against the JAX package,
on the same files.

Exact equality for everything that is integer or copied: dataset items,
collated batches, loader index orders, decoded PNGs (PIL on both sides),
cache entries read across packages (bit for bit), checkpoint keys and
values. The one computed comparison: features primed by the port's tower
(bfloat16, attention on the plain flash path) against the JAX package's
(bfloat16, XLA attention) on a tiny tower of 16 patches, 2 heads of 64,
within atol 0.05 + rtol 0.05 (a few bfloat16 ulps of features of order 1;
both round each op's output to bfloat16, at different points).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mafed_tpu.core.config import VisionConfig as JVisionConfig
from mafed_tpu.data import collate as jcollate
from mafed_tpu.data import images as jimages
from mafed_tpu.data.diskcache import ArrayDiskCache as JArrayDiskCache
from mafed_tpu.data.factory import get_val_loaders as jax_val_loaders
from mafed_tpu.data.factory import prepare_train_dataset as jax_train_dataset
from mafed_tpu.data.loader import BatchLoader as JBatchLoader
from mafed_tpu.data.tokenizer import ByteTokenizer as JByteTokenizer
from mafed_tpu.data.vision_cache import VisionFeatureCache as JVisionFeatureCache
from mafed_tpu.data.vision_cache import prime_vision_cache as jax_prime
from mafed_tpu.models.weights import params_to_reference_state_dict, save_reference_safetensors
from mafed_tpu.utils.checkpoint import load_task_checkpoint as jax_load_checkpoint
from mafed_tpu.utils.cl_utils import random_task_order as jax_task_order
from mafed_tpu_torch.core import config as tcfg
from mafed_tpu_torch.core.logging import MetricsLogger
from mafed_tpu_torch.data import collate as tcollate
from mafed_tpu_torch.data import images as timages
from mafed_tpu_torch.data.diskcache import ArrayDiskCache
from mafed_tpu_torch.data.factory import get_val_loaders, prepare_train_dataset
from mafed_tpu_torch.data.loader import BatchLoader
from mafed_tpu_torch.data.prefetch import DevicePrefetcher
from mafed_tpu_torch.data.tokenizer import ByteTokenizer
from mafed_tpu_torch.data.vision_cache import VisionFeatureCache, prime_vision_cache
from mafed_tpu_torch.data.vqa_dataset import format_text
from mafed_tpu_torch.models.weights import load_safetensors, params_from_jax
from mafed_tpu_torch.utils.checkpoint import load_task_checkpoint, save_task_checkpoint
from mafed_tpu_torch.utils.cl_utils import random_task_order
from mafed_tpu_torch.utils.save import save_configs
from tests.helpers import write_learnable_vqa, write_synthetic_vqa as jax_write_synthetic_vqa
from tests.torch_helpers import TINY_VISION, TINY_VISION_64, jax_params, tiny_cfgs, torch_model, write_synthetic_vqa

FEATURE_ATOL = FEATURE_RTOL = 5e-2


def _bits(x) -> np.ndarray:
    """The bfloat16 bits of a torch tensor or an ml_dtypes array, as uint16."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def _datasets(tmp_path, vision_cache=(None, None)):
    """(JAX, port) train datasets of task A over the same synthetic files."""
    jcfg = jax_write_synthetic_vqa(str(tmp_path), n_train=12, n_val=5)
    cfg = tcfg.TrainConfig.from_dict(jcfg.to_dict())
    vis = tcfg.VisionConfig(**TINY_VISION)
    jds = jax_train_dataset(jcfg, "taskA", JByteTokenizer(), JVisionConfig(**TINY_VISION), synthetic_images=True,
                            vision_cache=vision_cache[0])
    ds = prepare_train_dataset(cfg, "taskA", ByteTokenizer(), vis, synthetic_images=True, vision_cache=vision_cache[1])
    return jcfg, cfg, jds, ds


# --- the synthetic data writer, the dataset, collate -------------------------------

def test_writer_matches_the_jax_fixture(tmp_path):
    jax_write_synthetic_vqa(str(tmp_path / "jax"), n_train=7, n_val=3)
    write_synthetic_vqa(str(tmp_path / "port"), n_train=7, n_val=3)
    for rel in ("train_annotations.json", "val_annotations.json", "contvqa/tiny/train_question_ids.json",
                "contvqa/tiny/valid_question_ids.json"):
        with open(tmp_path / "jax" / rel) as a, open(tmp_path / "port" / rel) as b:
            assert json.load(a) == json.load(b), rel


def test_dataset_items_match_jax(tmp_path):
    _, _, jds, ds = _datasets(tmp_path)
    assert len(ds) == len(jds) == 12
    for i in range(len(ds)):
        got, want = ds[i], jds[i]
        assert set(got) == set(want)
        for key in ("question_id", "answers", "raw"):
            assert got[key] == want[key], key
        for key in ("input_ids", "labels", "pixels"):
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert format_text("  what is it") == "What is it."


@pytest.mark.parametrize("label_tail", [None, 16])
def test_collate_matches_jax(tmp_path, label_tail):
    jcfg, cfg, jds, ds = _datasets(tmp_path)
    items, jitems = [ds[i] for i in range(4)], [jds[i] for i in range(4)]
    got = tcollate.collate_train(items, text_len=48, label_tail=label_tail)
    want = jcollate.collate_train(jitems, text_len=48, label_tail=label_tail)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # val items of the same files
    jval = jax_val_loaders(jcfg, JByteTokenizer(), JVisionConfig(**TINY_VISION), 32, synthetic_images=True)
    val = get_val_loaders(cfg, ByteTokenizer(), tcfg.VisionConfig(**TINY_VISION), 32, synthetic_images=True)
    for task in cfg.tasks:
        vitems = [val[task].dataset[i] for i in range(3)]
        jvitems = [jval[task].dataset[i] for i in range(3)]
        got, want = tcollate.collate_val(vitems, text_len=32), jcollate.collate_val(jvitems, text_len=32)
        assert set(got) == set(want)
        for k in ("answers", "qids"):
            assert got[k] == want[k]
        for k in ("input_ids", "attention_mask", "pixels"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_collate_label_tail_guard_matches_jax(tmp_path):
    _, _, jds, ds = _datasets(tmp_path)
    for collate, item in ((tcollate.collate_train, ds[0]), (jcollate.collate_train, jds[0])):
        with pytest.raises(ValueError, match="label_tail"):
            collate([item], text_len=48, label_tail=4)


def test_collate_stacks_cached_patches():
    rng = np.random.default_rng(0)
    feats = [rng.normal(size=(4, 8)).astype(np.float32) for _ in range(3)]
    base = {"input_ids": np.ones(3, np.int32), "labels": np.asarray([-100, 1, 2], np.int32)}
    got = tcollate.collate_train([{**base, "patches": torch.from_numpy(f).bfloat16()} for f in feats], text_len=8)
    want = jcollate.collate_train([{**base, "patches": np.asarray(jnp.asarray(f, jnp.bfloat16))} for f in feats],
                                  text_len=8)
    assert got["patches"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got["patches"]), _bits(want["patches"]))
    mixed = [{**base, "patches": torch.zeros(4, 8, dtype=torch.bfloat16)}, {**base, "pixels": np.zeros((2, 2, 3), np.uint8)}]
    with pytest.raises(ValueError, match="mixes cached"):
        tcollate.collate_train(mixed, text_len=8)


# --- the loader and the prefetcher ---------------------------------------------------

class _Indices:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return int(i)


def _orders(loader, epochs, start_batch=0, take=None):
    out = []
    for e in epochs:
        loader.set_epoch(e, start_batch=start_batch)
        it = iter(loader)
        out.append([next(it) for _ in range(take)] if take else list(it))
        it.close()
    return out


@pytest.mark.parametrize("shuffle, drop_last, start_batch", [
    (True, True, 0), (True, True, 2), (False, False, 0), (True, False, 1),
])
def test_loader_orders_match_jax(shuffle, drop_last, start_batch):
    kw = dict(batch_size=4, collate=list, shuffle=shuffle, seed=7, num_workers=3, drop_last=drop_last)
    got = _orders(BatchLoader(_Indices(19), **kw), range(3), start_batch)
    want = _orders(JBatchLoader(_Indices(19), **kw), range(3), start_batch)
    assert got == want
    assert len(BatchLoader(_Indices(19), **kw)) == len(JBatchLoader(_Indices(19), **kw))


@pytest.mark.parametrize("n", [3, 10])
def test_infinite_loader_matches_jax(n):
    """Fewer rows than a batch (3 < 4) and more (10): full batches cycling
    through the seeded epoch orders."""
    kw = dict(batch_size=4, collate=list, shuffle=True, seed=1, num_workers=2, drop_last=True, infinite=True)
    assert _orders(BatchLoader(_Indices(n), **kw), [0], take=9) == _orders(JBatchLoader(_Indices(n), **kw), [0], take=9)


def test_loader_raises_a_collate_error():
    def bad(items):
        raise ValueError("collate failed")

    with pytest.raises(ValueError, match="collate failed"):
        list(BatchLoader(_Indices(8), batch_size=4, collate=bad))


def test_prefetcher_on_the_cpu_keeps_order_and_closes_the_loader():
    batches = [{"input_ids": np.full((2, 3), i, np.int32), "qids": [f"q{i}"]} for i in range(5)]
    closed = []

    def stream():
        try:
            yield from batches
        finally:
            closed.append(True)

    out = list(DevicePrefetcher(stream(), "cpu", depth=2))
    assert [int(b["input_ids"][0, 0]) for b in out] == list(range(5))
    assert all(isinstance(b["input_ids"], torch.Tensor) and b["qids"] == [f"q{i}"] for i, b in enumerate(out))
    it = iter(DevicePrefetcher(stream(), "cpu", depth=2))
    next(it)
    it.close()
    assert closed == [True, True]


# --- images -----------------------------------------------------------------------------

@pytest.mark.parametrize("native", ["1", "0"], ids=["engine", "pil"])
@pytest.mark.parametrize("img_size", [28, 224])
def test_load_and_resize_matches_jax_pil(tmp_path, monkeypatch, img_size, native):
    """Both packages at their defaults, with the C++ engine (MAFED_NATIVE_IMAGES=1) and with PIL (0)."""
    monkeypatch.setenv("MAFED_NATIVE_IMAGES", native)
    cfg = write_learnable_vqa(str(tmp_path), tasks=("hue", "side"), n_train=3, n_val=1)
    img_dir = cfg.train_img_dirs[0]
    names = sorted(os.listdir(img_dir))
    assert names
    for name in names:
        path = os.path.join(img_dir, name)
        got = timages.load_and_resize(path, tcfg.VisionConfig(img_size=img_size))
        want = jimages.load_and_resize(path, JVisionConfig(img_size=img_size))
        assert got.dtype == np.uint8 and got.shape == (img_size, img_size, 3)
        np.testing.assert_array_equal(got, want)
    assert timages.get_image_path("d", "coco_train2014_000000000009.npz") == jimages.get_image_path(
        "d", "coco_train2014_000000000009.npz")


# --- the caches ------------------------------------------------------------------------------

def test_cache_entries_cross_read_bit_for_bit(tmp_path):
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(6, 8)).astype(np.float32)
    jcache, cache = JArrayDiskCache(str(tmp_path), (6, 8)), ArrayDiskCache(str(tmp_path), (6, 8))
    jcache.save("img:jax", np.asarray(jnp.asarray(feats, jnp.bfloat16)))
    cache.save("img:port", torch.from_numpy(feats))
    assert cache.has("img:jax") and jcache.has("img:port")
    np.testing.assert_array_equal(_bits(cache.load("img:jax")), _bits(jcache.load("img:jax")))
    np.testing.assert_array_equal(_bits(jcache.load("img:port")), _bits(cache.load("img:port")))
    np.testing.assert_array_equal(_bits(cache.load("img:port")), _bits(torch.from_numpy(feats).bfloat16()))
    assert cache.load("img:missing") is None
    assert ArrayDiskCache(str(tmp_path), (6, 9)).load("img:port") is None  # another shape reads as a miss
    # the stamp: another fingerprint wipes the directory
    assert cache.set_fingerprint("a") is True  # entries without a stamp
    cache.save("img:port", torch.from_numpy(feats))
    assert cache.set_fingerprint("a") is False and cache.has("img:port")
    assert cache.set_fingerprint("b") is True and not cache.has("img:port")


def test_primed_features_match_jax(tmp_path):
    jcfg_model, tc = tiny_cfgs(TINY_VISION_64)
    params = jax.tree.map(np.asarray, jax_params(jcfg_model, seed=3))
    vis, jvis = tc.vision, jcfg_model.vision
    jcache = JVisionFeatureCache(str(tmp_path / "jax"), vis.num_patches, vis.embed_dim)
    cache = VisionFeatureCache(str(tmp_path / "port"), vis.num_patches, vis.embed_dim)
    jcfg = jax_write_synthetic_vqa(str(tmp_path / "data"), n_train=10, n_val=2)
    cfg = tcfg.TrainConfig.from_dict(jcfg.to_dict())
    jds = jax_train_dataset(jcfg, "taskA", JByteTokenizer(), jvis, synthetic_images=True, vision_cache=jcache)
    ds = prepare_train_dataset(cfg, "taskA", ByteTokenizer(), vis, synthetic_images=True, vision_cache=cache)
    assert jax_prime(jcache, [jds], {"vision": params["vision"]}, jcfg_model, batch_size=4) == 10
    model = torch_model(params, tc)
    assert prime_vision_cache(cache, [ds], model, batch_size=4) == 10
    assert prime_vision_cache(cache, [ds], model, batch_size=4) == 0  # warm
    # a float32 copy of the tower stamps alike: the warm cache survives
    model.vision_encoder.float()
    assert prime_vision_cache(cache, [ds], model) == 0
    for i in range(10):
        got, want = ds[i]["patches"], jds[i]["patches"]
        assert got.dtype == torch.bfloat16 and got.shape == (vis.num_patches, vis.embed_dim)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   atol=FEATURE_ATOL, rtol=FEATURE_RTOL)
    # other tower weights wipe the cache and recompute
    other = torch_model(jax.tree.map(np.asarray, jax_params(jcfg_model, seed=4)), tc)
    assert prime_vision_cache(cache, [ds], other, batch_size=4) == 10


# --- checkpoints ------------------------------------------------------------------------------

def test_checkpoints_cross_read(tmp_path):
    from safetensors.numpy import load_file

    jcfg_model, tc = tiny_cfgs()
    params = jax.tree.map(np.asarray, jax_params(jcfg_model, seed=5))
    want = params_to_reference_state_dict(params, jcfg_model)
    model = torch_model(params, tc)
    assert set(model.state_dict()) == set(want)  # no buffer joins the reference names

    port_path = str(tmp_path / "port_best.safetensors")
    save_task_checkpoint(model.state_dict(), port_path)
    by_safetensors = load_file(port_path)
    assert set(by_safetensors) == set(want)
    for k, v in want.items():
        assert by_safetensors[k].dtype == np.float32
        np.testing.assert_array_equal(by_safetensors[k], np.asarray(v, np.float32), err_msg=k)
    jax_read = jax.tree.map(np.asarray, jax_load_checkpoint(port_path, jcfg_model))
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, np.asarray(b, np.float32)), jax_read,
                 jax.tree.map(lambda x: np.asarray(x, np.float32), params))

    jax_path = str(tmp_path / "jax_best.safetensors")
    save_reference_safetensors(params, jcfg_model, jax_path)
    got = load_task_checkpoint(jax_path)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v, np.float32), err_msg=k)
    # the port's own file reads back bit for bit
    back = load_task_checkpoint(port_path)
    assert all(torch.equal(back[k], v.float()) for k, v in model.state_dict().items())
    # and loads into a model
    fresh = torch_model(jax.tree.map(np.asarray, jax_params(jcfg_model, seed=6)), tc)
    fresh.load_state_dict(params_from_jax(jax_read, tc))
    # a Lightning checkpoint of the same weights ('state_dict', 'model.' prefixes), as the JAX package reads it
    ckpt = str(tmp_path / "x.ckpt")
    torch.save({"state_dict": {f"model.{k}": torch.from_numpy(np.asarray(v, np.float32).copy())
                               for k, v in want.items()}}, ckpt)
    by_ckpt = load_task_checkpoint(ckpt)
    assert set(by_ckpt) == set(want)
    assert all(torch.equal(by_ckpt[k], back[k]) for k in want)


# --- small utilities ------------------------------------------------------------------------------

def test_task_order_config_dump_and_metrics(tmp_path):
    split = tmp_path / "split.json"
    split.write_text(json.dumps({t: [] for t in ("a", "b", "c", "d", "e")}))
    for seed in (0, 42):
        assert random_task_order("x", str(split), seed=seed) == jax_task_order("x", str(split), seed=seed)
    cfg = write_synthetic_vqa(str(tmp_path / "data"))
    save_configs(cfg)
    with open(os.path.join(cfg.output_dir, "log", "hps.json")) as f:
        assert json.load(f) == json.loads(json.dumps(cfg.to_dict(), default=str))
    logger = MetricsLogger(output_dir=str(tmp_path / "log"))
    logger.log_metrics({"loss": torch.tensor(2.5)}, step=3)
    logger.set_global_step_offset(10)
    logger.log_metrics({"loss": 1.0}, step=3)
    logger.log_metrics({"acc": 0.5}, step=1, is_valid_step=True)
    with open(tmp_path / "log" / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert [(r["_step"], r.get("loss", r.get("acc"))) for r in records] == [(3, 2.5), (13, 1.0), (1, 0.5)]
