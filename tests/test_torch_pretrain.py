"""The port's captioning pretraining against the JAX package's.

Same tiny model on both sides (hidden 128, 2 heads of 64, 3 layers, a tower
of 4 patches; parameters from the JAX `init_params` carried over by
`params_from_jax`), the same records, the JAX steps with XLA attention on
the CPU. Checked:

  * dataset items and `collate_pretrain` batches equal bit for bit (ids,
    labels, mask, uint8 pixels), over a manifest with COCO images and a
    Visual-Genome region (object-centre crop) the test writes, records, and
    a list of dicts as the map-style source;
  * one `make_train_step` (label_tail 0, float32) on a right-padded caption
    batch from pixels: loss, gradients and the update against `jax.grad`
    and the JAX step (rtol 1e-5 / atol 1e-6);
  * both PretrainTrainers over two epochs from the same weights, bfloat16
    as both build it: every logged train and eval loss within rtol 1e-3
    (measured on a CPU: 1.1e-4), the same checkpoint names after rotation,
    trainer_state.json's step, epoch, batch_idx and rng_state equal, and
    the port's checkpoint-final read by the JAX load_task_checkpoint within
    atol 4e-3 of the JAX run's params: 8 AdamW updates of lr 1e-3, where
    Adam turns bf16 rounding in a near-zero gradient into up to a step of
    lr an update; 4 such steps (measured: 1.4e-3);
  * the port's mid-epoch resume equal bit for bit to its uninterrupted run,
    with and without gradient accumulation;
  * the JAX trainer's rotation fault (the best checkpoint rotated out, then
    loaded: FileNotFoundError) and the port finishing with it kept; its
    checkpoints' "step" counting microbatches under accumulation, the
    port's counting updates;
  * the command line: the port's parser against the JAX dataclasses, and
    the JAX parser's duplicate --model_max_length flag.
"""

import argparse
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mafed_tpu import pretrain_vlpythia as jcli
from mafed_tpu.core.config import TrainConfig as JTrainConfig
from mafed_tpu.data.tokenizer import ByteTokenizer as JByteTokenizer
from mafed_tpu.optim import optimizer as jopt
from mafed_tpu.optim.sched import linear_warmup_schedule as jsched
from mafed_tpu.pretrain import dataset as jds
from mafed_tpu.pretrain.trainer import PretrainConfig as JPretrainConfig
from mafed_tpu.pretrain.trainer import PretrainTrainer as JPretrainTrainer
from mafed_tpu.training import step as jstep
from mafed_tpu.training.train_state import TrainState as JTrainState, split_params
from mafed_tpu.utils.checkpoint import load_task_checkpoint as jax_load_checkpoint
from mafed_tpu_torch import pretrain_vlpythia as tcli
from mafed_tpu_torch.core.config import TrainConfig as TTrainConfig
from mafed_tpu_torch.data.images import make_normalizer
from mafed_tpu_torch.data.tokenizer import ByteTokenizer
from mafed_tpu_torch.models.weights import load_safetensors, params_from_jax
from mafed_tpu_torch.optim import optimizer as topt
from mafed_tpu_torch.optim.sched import linear_warmup_schedule as tsched
from mafed_tpu_torch.pretrain import dataset as tds
from mafed_tpu_torch.pretrain.trainer import PretrainConfig, PretrainTrainer
from mafed_tpu_torch.training import step as tstep
from mafed_tpu_torch.training.train_state import TrainState, trainable_parameters
from tests.torch_helpers import jax_params, one_torch_thread, tiny_cfgs, to_jax, to_torch, torch_model  # noqa: F401

TEXT = 32
LOSS_RTOL = 1e-3
PARAM_ATOL = 4e-3


def _write_png(path, w, h, seed):
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    rng = np.random.default_rng(seed)
    Image.fromarray(rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)).save(path)


def _records(root):
    """Caption rows over images the test writes: COCO photos of two sizes
    and Visual-Genome regions, one near the bottom-right edge."""
    rows = []
    for i, (w, h) in enumerate([(60, 40), (36, 52), (90, 90)]):
        path = os.path.join(root, "coco", f"{i}.png")
        _write_png(path, w, h, seed=i)
        rows.append({"image": path, "caption": f"  a photo of thing {i} ", "source": "coco", "metadata": {}})
    vg = os.path.join(root, "vg", "7.png")
    _write_png(vg, 80, 64, seed=7)
    for bbox in ([5, 6, 20, 14], [60, 50, 15, 10]):
        rows.append({"image": vg, "caption": "red ball on the left", "source": "visual_genome",
                     "metadata": {"bbox": bbox}})
    return rows


@pytest.mark.parametrize("native", ["1", "0"], ids=["engine", "pil"])
@pytest.mark.parametrize("source", ["manifest", "records", "dict_rows"])
def test_items_and_collate_match_jax(tmp_path, monkeypatch, source, native):
    monkeypatch.setenv("MAFED_NATIVE_IMAGES", native)  # both packages' C++ engine (1, the default) or PIL (0)
    jcfg, tc = tiny_cfgs()
    rows = _records(str(tmp_path))
    kwargs = {"model_max_length": TEXT}
    if source == "manifest":
        path = str(tmp_path / "train.jsonl")
        with open(path, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
        jkw, tkw = dict(manifest_path=path), dict(manifest_path=path)
    elif source == "records":
        jkw = dict(records=[jds.CaptionRecord(**r) for r in rows])
        tkw = dict(records=[tds.CaptionRecord(**r) for r in rows])
    else:  # metadata as a JSON string in some rows, as HF datasets store it
        dict_rows = [dict(r, metadata=json.dumps(r["metadata"])) if i % 2 else r for i, r in enumerate(rows)]
        jkw, tkw = dict(hf_dataset=dict_rows), dict(hf_dataset=dict_rows)
    want = jds.PretrainDataset(JByteTokenizer(model_max_length=TEXT), jcfg.vision, **jkw, **kwargs)
    got = tds.PretrainDataset(ByteTokenizer(model_max_length=TEXT), tc.vision, **tkw, **kwargs)
    assert len(got) == len(want) == len(rows)
    items = [got[i] for i in range(len(rows))]
    for i, item in enumerate(items):
        ref = want[i]
        assert item["raw"] == ref["raw"]
        for key in ("input_ids", "labels", "pixels"):
            assert item[key].dtype == ref[key].dtype and item[key].shape == ref[key].shape, key
            np.testing.assert_array_equal(item[key], ref[key], err_msg=f"{key} of item {i}")
    assert items[3]["pixels"].shape == (tc.vision.img_size, tc.vision.img_size, 3)
    for side in ("right", "left"):
        b_got = tds.collate_pretrain(items, text_len=24, padding_side=side)
        b_want = jds.collate_pretrain([want[i] for i in range(len(rows))], text_len=24, padding_side=side)
        assert b_got.keys() == b_want.keys()
        for key in b_want:
            assert b_got[key].dtype == b_want[key].dtype, key
            np.testing.assert_array_equal(b_got[key], b_want[key], err_msg=key)


def _caption_batch(tc, n, text_len, seed):
    """A right-padded caption batch of `n` rows of different lengths, with pixels."""
    tok = ByteTokenizer(model_max_length=text_len)
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n):
        caption = " ".join(f"w{j}" for j in range(1 + 2 * i))
        ids = np.asarray(tok(caption).input_ids[:text_len], np.int32)
        items.append({"input_ids": ids, "labels": ids.copy(),
                      "pixels": rng.integers(0, 256, (tc.vision.img_size, tc.vision.img_size, 3), dtype=np.uint8)})
    return tds.collate_pretrain(items, text_len=text_len)


def test_train_step_matches_jax_f32():
    jcfg, tc = tiny_cfgs()
    params = jax_params(jcfg, seed=3)
    batch = _caption_batch(tc, 4, 20, seed=1)
    assert len({int(m.sum()) for m in batch["attention_mask"]}) == 4  # ragged right padding
    kw = dict(optim="adamw", learning_rate=1e-3, label_tail=0, compute_dtype="float32", betas=[0.9, 0.999],
              grad_norm=1.0)

    # gradients of the loss, before any update
    trainable, frozen = split_params(params)
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda t: jstep._ce_loss(
        t, frozen, jcfg, to_jax(batch), jnp.float32, "xla", label_tail=None)))(trainable)
    model = torch_model(params, tc)
    tb = to_torch(batch)
    loss = tstep._ce_loss(model, tb, tstep._vision_features(model, tb, make_normalizer(tc.vision), torch.float32),
                          torch.float32, None, remat=False)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), tc)
    grads = {n: p.grad for n, p in trainable_parameters(model).items()}
    assert grads.keys() == want.keys()
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-5, atol=1e-6, err_msg=name)

    # one step of each package's make_train_step
    jcfg_train = JTrainConfig(**kw)
    tx = jopt.build_optimizer(jcfg_train, trainable, jsched(1e-3, 0, 10))
    jstate = JTrainState(jnp.zeros((), jnp.int32), trainable, frozen, tx.init(trainable))
    jnew, jm = jstep.make_train_step(jcfg, jcfg_train, tx, attn_impl="xla", donate=False)(jstate, to_jax(batch))
    model = torch_model(params, tc)
    opt = topt.build_optimizer(TTrainConfig(**kw), trainable_parameters(model), tsched(1e-3, 0, 10))
    state = TrainState(0, model, opt.init(trainable_parameters(model)))
    state, m = tstep.make_train_step(tc, TTrainConfig(**kw), opt, device="cpu")(state, tb)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    j_sd = params_from_jax(jax.tree.map(np.asarray, jnew.trainable), tc)
    for name, p in trainable_parameters(model).items():
        np.testing.assert_allclose(p.detach().numpy(), j_sd[name].numpy(), atol=1e-6, rtol=1e-5, err_msg=name)


# --- both trainers ------------------------------------------------------------------------------

def _caption_rows(n, offset=0):
    return [dict(image=f"img{i}", caption=f"a photo of {'thing ' * (1 + (i + offset) % 5)}{i}", source="coco")
            for i in range(offset, offset + n)]


def _datasets(pkg, vision_cfg, n_train=16, n_eval=8):
    mod, tok = (jds, JByteTokenizer) if pkg == "jax" else (tds, ByteTokenizer)

    def make(rows):
        return mod.PretrainDataset(tok(model_max_length=TEXT), vision_cfg, records=[mod.CaptionRecord(**r) for r in rows],
                                   model_max_length=TEXT, synthetic_images=True)

    return make(_caption_rows(n_train)), make(_caption_rows(n_eval, offset=100))


ARGS = dict(per_device_train_batch_size=4, per_device_eval_batch_size=4, num_train_epochs=2, learning_rate=1e-3,
            save_steps=0.25, eval_steps=0.25, model_max_length=TEXT, logging_steps=1)


def _metrics(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("pretrain_parity")
    jcfg, tc = tiny_cfgs()
    params = jax.tree.map(np.asarray, jax_params(jcfg, seed=0))  # host copies: the JAX steps donate
    j_train, j_eval = _datasets("jax", jcfg.vision)
    jargs = JPretrainConfig(output_dir=str(root / "jax"), **ARGS)
    jstate = JPretrainTrainer(jcfg, jargs, j_train, j_eval, tokenizer=JByteTokenizer(), init_params=params).train()
    t_train, t_eval = _datasets("torch", tc.vision)
    args = PretrainConfig(output_dir=str(root / "torch"), **ARGS)
    trainer = PretrainTrainer(tc, args, t_train, t_eval, init_params=params_from_jax(params, tc), device="cpu")
    trainer.train()
    return jcfg, tc, jargs, jstate, args, trainer


def test_trainers_log_the_same_losses(both_runs):
    _, _, jargs, _, args, _ = both_runs
    want, got = _metrics(jargs.output_dir), _metrics(args.output_dir)
    assert [sorted(k for k in r if not k.startswith("_")) + [r["_step"]] for r in got] == \
           [sorted(k for k in r if not k.startswith("_")) + [r["_step"]] for r in want]
    assert sum("eval/loss" in r for r in got) == 4 and sum("train/loss" in r for r in got) == 8
    for g, w in zip(got, want):
        for key in ("train/loss", "eval/loss"):
            if key in w:
                np.testing.assert_allclose(g[key], w[key], rtol=LOSS_RTOL, err_msg=f"{key} at {w['_step']}")


def test_trainers_write_the_same_checkpoints(both_runs):
    jcfg, tc, jargs, jstate, args, trainer = both_runs
    names = sorted(d for d in os.listdir(jargs.output_dir) if d.startswith("checkpoint-"))
    assert names == sorted(d for d in os.listdir(args.output_dir) if d.startswith("checkpoint-"))
    assert "checkpoint-final" in names and len(names) == 1 + args.save_total_limit
    for name in names:
        with open(os.path.join(jargs.output_dir, name, "trainer_state.json")) as f:
            want = json.load(f)
        with open(os.path.join(args.output_dir, name, "trainer_state.json")) as f:
            got = json.load(f)
        assert {k: got[k] for k in want} == want, name
    # the port's final checkpoint, read by the JAX package, against the JAX run's parameters
    port_final = jax_load_checkpoint(os.path.join(args.output_dir, "checkpoint-final", "model.safetensors"), jcfg)
    got_sd = params_from_jax(jax.tree.map(np.asarray, port_final), tc)
    jax_final = jax_load_checkpoint(os.path.join(jargs.output_dir, "checkpoint-final", "model.safetensors"), jcfg)
    want_sd = params_from_jax(jax.tree.map(np.asarray, jax_final), tc)
    for name, want in want_sd.items():
        np.testing.assert_allclose(got_sd[name].float().numpy(), want.float().numpy(), atol=PARAM_ATOL, rtol=0,
                                   err_msg=name)
    # the best checkpoint is loaded at the end, as the JAX trainer's state
    best = params_from_jax(jax.tree.map(np.asarray, {**jstate.trainable, "vision": jstate.frozen["vision"]}), tc)
    for name, p in trainer.model.state_dict().items():
        np.testing.assert_allclose(p.float().numpy(), best[name].float().numpy(), atol=PARAM_ATOL, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("accum", [1, 2])
def test_midepoch_resume_matches_uninterrupted(tmp_path, accum):
    """A run resumed from a mid-epoch checkpoint ends bit-equal to the
    uninterrupted run (the port's counterpart of the JAX package's
    test_pretrain_midepoch_resume_matches_uninterrupted); with gradient
    accumulation too, whose checkpoints count optimizer updates."""
    _, tc = tiny_cfgs()
    train_ds, _ = _datasets("torch", tc.vision, n_train=32)

    def run(out, resume=None):
        args = PretrainConfig(output_dir=str(tmp_path / out), per_device_train_batch_size=4 // accum,
                              gradient_accumulation_steps=accum, num_train_epochs=2, learning_rate=1e-3,
                              save_steps=0.3, eval_steps=10.0, model_max_length=TEXT,
                              load_best_model_at_end=False, save_total_limit=10)
        trainer = PretrainTrainer(tc, args, train_ds, device="cpu")
        state = trainer.train(resume_from_checkpoint=resume)
        return args, state, trainer

    args1, state1, t1 = run("uninterrupted")
    mid = os.path.join(args1.output_dir, "checkpoint-4")  # 8 updates an epoch: mid-epoch 0
    with open(os.path.join(mid, "trainer_state.json")) as f:
        meta = json.load(f)
    assert (meta["step"], meta["epoch"], meta["batch_idx"]) == (4, 0, 4 * accum - 1)
    args2, state2, t2 = run("resumed", resume=mid)
    assert state2.step == state1.step == 16 * accum
    assert sorted(os.listdir(args2.output_dir)) == sorted(set(os.listdir(args1.output_dir)) - {"checkpoint-4"})
    for name, p in t1.model.state_dict().items():
        assert torch.equal(p, t2.model.state_dict()[name]), name
    log1 = [r for r in _metrics(args1.output_dir) if r["_step"] > 4]
    log2 = _metrics(args2.output_dir)
    assert [(r["_step"], r["train/loss"]) for r in log2] == [(r["_step"], r["train/loss"]) for r in log1]


# --- the rotation fault -----------------------------------------------------------------------------

FAULT_ARGS = dict(per_device_train_batch_size=4, per_device_eval_batch_size=4, num_train_epochs=2,
                  learning_rate=0.0, save_steps=0.25, eval_steps=0.25, save_total_limit=1, model_max_length=TEXT)


def test_rotation_keeps_the_best_checkpoint(tmp_path):
    """lr 0: the eval loss never improves after step 2, so checkpoint-2 stays
    the best while checkpoints 4, 6 and 8 are saved with save_total_limit 1.
    The JAX trainer rotates it out and then fails to load it; the port keeps
    it (and the newest), loads it and finishes."""
    jcfg, tc = tiny_cfgs()
    params = jax.tree.map(np.asarray, jax_params(jcfg, seed=2))
    j_train, j_eval = _datasets("jax", jcfg.vision)
    jargs = JPretrainConfig(output_dir=str(tmp_path / "jax"), **FAULT_ARGS)
    with pytest.raises(FileNotFoundError, match="checkpoint-2"):
        JPretrainTrainer(jcfg, jargs, j_train, j_eval, tokenizer=JByteTokenizer(), init_params=params).train()
    assert sorted(os.listdir(jargs.output_dir)) == ["checkpoint-8", "checkpoint-final", "metrics.jsonl"]

    t_train, t_eval = _datasets("torch", tc.vision)
    args = PretrainConfig(output_dir=str(tmp_path / "torch"), **FAULT_ARGS)
    trainer = PretrainTrainer(tc, args, t_train, t_eval, init_params=params_from_jax(params, tc), device="cpu")
    trainer.train()
    assert trainer.best_path == os.path.join(args.output_dir, "checkpoint-2")
    assert sorted(os.listdir(args.output_dir)) == ["checkpoint-2", "checkpoint-8", "checkpoint-final", "metrics.jsonl"]
    best = load_safetensors(os.path.join(trainer.best_path, "model.safetensors"))
    assert all(torch.equal(p.float(), best[k]) for k, p in trainer.model.state_dict().items())
    # a limit of 2 keeps the best and the newest: no exception to make
    trainer.args.save_total_limit = 2
    trainer._prune_checkpoints()
    assert sorted(d for d in os.listdir(args.output_dir) if d[-1].isdigit()) == ["checkpoint-2", "checkpoint-8"]


def test_checkpoint_step_counts_updates_with_accumulation(tmp_path):
    """With 2 microbatches an update, the JAX trainer's trainer_state.json
    "step" counts microbatches (its TrainState.step), which `train` reads
    back on resume as updates; the port's counts updates."""
    jcfg, tc = tiny_cfgs()
    params = jax.tree.map(np.asarray, jax_params(jcfg, seed=2))
    kw = dict(per_device_train_batch_size=2, gradient_accumulation_steps=2, num_train_epochs=1, learning_rate=1e-3,
              save_steps=0.5, eval_steps=10.0, model_max_length=TEXT, load_best_model_at_end=False)
    j_train, _ = _datasets("jax", jcfg.vision)
    jargs = JPretrainConfig(output_dir=str(tmp_path / "jax"), **kw)
    JPretrainTrainer(jcfg, jargs, j_train, tokenizer=JByteTokenizer(), init_params=params).train()
    t_train, _ = _datasets("torch", tc.vision)
    args = PretrainConfig(output_dir=str(tmp_path / "torch"), **kw)
    PretrainTrainer(tc, args, t_train, init_params=params_from_jax(params, tc), device="cpu").train()
    for out, want in ((jargs.output_dir, 4), (args.output_dir, 2)):  # checkpoint-2 of 4 updates of 2 microbatches
        with open(os.path.join(out, "checkpoint-2", "trainer_state.json")) as f:
            assert json.load(f)["step"] == want


# --- the command line ---------------------------------------------------------------------------------

CLI_CASES = {
    "defaults": [],
    "flags": ["--manifest", "a.jsonl", "--eval_manifest", "b.jsonl", "--model_max_length", "64",
              "--allow_tokenizer_fallback", "--betas", "0.8", "0.95", "--learning_rate", "1e-4",
              "--per_device_train_batch_size", "64", "--gradient_accumulation_steps", "2"],
    "paths_and_ints": ["--model_name", "storage/models/x", "--select_layer", "-1", "--save_total_limit", "3",
                       "--mesh_shape", "1", "1", "--output_dir", "out", "--num_train_epochs", "1"],
}


def _expected(argv):
    """The JAX package's three dataclasses for `argv`, built from the flags
    (its parser raises before parsing: see test_jax_parser_duplicates_a_flag)."""
    values = {}
    it = iter(argv)
    for tok in it:
        name = tok[2:]
        field = next(f for dc in (jcli.ModelArguments, jcli.DataArguments, JPretrainConfig)
                     for f in dataclasses.fields(dc) if f.name == name)
        if isinstance(field.default, bool):
            values[name] = True
        elif isinstance(field.default, tuple):
            elem = int if all(isinstance(x, int) for x in field.default) else float
            n = len(field.default)
            values[name] = tuple(elem(v) for v in [next(it) for _ in range(n)])
        else:
            values[name] = type(field.default)(next(it))

    def build(dc):
        names = {f.name for f in dataclasses.fields(dc)}
        return dc(**{k: v for k, v in values.items() if k in names})

    return build(jcli.ModelArguments), build(jcli.DataArguments), build(JPretrainConfig)


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_matches_jax_dataclasses(case):
    argv = CLI_CASES[case]
    got = tcli.parse_args(argv + ["--device", "cpu"])
    assert got[3] == "cpu"
    for g, w in zip(got[:3], _expected(argv)):
        assert type(g).__name__ == type(w).__name__
        assert dataclasses.asdict(g) == dataclasses.asdict(w)


def test_jax_parser_duplicates_a_flag():
    """The JAX entry point adds --model_max_length for ModelArguments and
    again for PretrainConfig, and argparse refuses the second."""
    with pytest.raises(argparse.ArgumentError, match="model_max_length"):
        jcli.train(["--manifest", "unused.jsonl"])
    assert {f.name for f in dataclasses.fields(tcli.ModelArguments)} & {f.name for f in dataclasses.fields(PretrainConfig)} \
        == {"model_max_length"}


def test_more_than_one_device_raises(tmp_path):
    """Two devices in one process does not exist here (one device a rank),
    so a mesh of two on one rank raises; a distributed_init without a
    launcher's variables raises before anything runs
    (tests/test_torch_multiprocess.py pretrains over two ranks,
    tests/test_torch_tp_multiprocess.py over a (1, 2) grid)."""
    _, tc = tiny_cfgs()
    train_ds, _ = _datasets("torch", tc.vision)
    with pytest.raises(ValueError, match=r"grid of 2 x 1 = 2 ranks, but the run has 1 rank\(s\)"):
        PretrainTrainer(tc, PretrainConfig(output_dir=str(tmp_path), mesh_shape=(2, 1)), train_ds, device="cpu")
    with pytest.raises(RuntimeError, match="RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT"):
        PretrainTrainer(tc, PretrainConfig(output_dir=str(tmp_path), distributed_init=True), train_ds, device="cpu")
