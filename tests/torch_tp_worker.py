"""One rank of the port's tensor-parallel tests (tests/test_torch_tensor_parallel.py,
tests/test_torch_tp_multiprocess.py): a gloo process group on the CPU, as
tests/torch_mp_worker.py joins it, and a (data, model) mesh. It imports
only mafed_tpu_torch (and torch_mp_worker's helpers).

    python tests/torch_tp_worker.py <rank> <world> <port> <root> <tag> <mode> <D> <M>

With world 1 no group is joined: the one-process run of the same program.
Each rank writes <root>/worker_<tag>_<rank>.json. Modes:

  layers         another grid refused; column -> row MLP, vocab-parallel
                 embedding and CE, and a decoder layer with and without the
                 parallel residual, against their dense versions on every
                 rank (max |diff| of outputs and gradients)
  model          the tiny model from <root>/init.safetensors: the values of
                 gather_to_replicated, greedy tokens and validate_vqa of the gathered copy,
                 two CE windows under the remat policies "" and "dots", an
                 EWC window after a Fisher; rank 0 saves the gathered results
  windows:<cfg>  two fused MAFED windows of tests/mp_worker.py's
                 `_tp_step_probe` program (cfg "tiny" or "1b": the 1B
                 proportions), the rows split over the data group, then the
                 optimizer state's round trip through a file
  cl             the CL trainer of torch_mp_worker.cl_config under the mesh;
                 rank 0 saves the final trainable parameters, gathered
  cl_preempt:N   the same, the countdown of a preemption after N updates
  cl_resume      the same command with resume_from_checkpoint
  pretrain       PretrainTrainer on torch_mp_worker's captions at a global 8
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
INIT_PARAMS = "init.safetensors"

# the JAX package's tests/helpers.py::tiny_model_cfg and the 1B proportions of
# tests/test_sharding.py::test_tp2_window_step_1b_proportions (8 heads, rotary 0.25)
PROBE_MODELS = {
    "tiny": dict(vocab_size=512, hidden_size=32, num_hidden_layers=3, num_attention_heads=2, intermediate_size=64,
                 rotary_pct=0.25),
    "1b": dict(vocab_size=256, hidden_size=64, num_hidden_layers=2, num_attention_heads=8, intermediate_size=256,
               rotary_pct=0.25),
}
PROBE_VISION = {"tiny": dict(img_size=28, patch_size=14, embed_dim=32, depth=2, num_heads=2, mlp_ratio=2.0),
                "1b": dict(img_size=28, patch_size=14, embed_dim=32, depth=1, num_heads=2, mlp_ratio=2.0)}


def probe_model_cfg(name: str):
    from mafed_tpu_torch.core.config import ModelConfig, VisionConfig

    return ModelConfig(**PROBE_MODELS[name], vision=VisionConfig(**PROBE_VISION[name]), vision_encoder_name="tiny-eva")


def probe_train_kwargs() -> dict:
    """`_tp_step_probe`'s TrainConfig, with float32 compute."""
    return dict(batch_size=4, optim="adamw", weight_decay=0.01, grad_norm=2.0, replay_coeff=1.0,
                distillation_coeff=1.0, distillation_modality_weighing_strategy="balanced",
                distillation_layer_weighing_strategy="discounted", compute_dtype="float32")


def example_batch(cfg, batch: int, text_len: int, seed: int = 0) -> dict:
    """__graft_entry__._example_batch (that module imports JAX)."""
    rng = np.random.default_rng(seed)
    img = cfg.vision.img_size
    input_ids = rng.integers(1, min(200, cfg.vocab_size - 1), size=(batch, text_len)).astype(np.int32)
    attention_mask = np.ones((batch, text_len), np.int32)
    attention_mask[:, : text_len // 4] = 0
    labels = input_ids.copy()
    labels[:, : -min(8, max(2, text_len // 4))] = -100
    pixels = rng.integers(0, 256, size=(batch, img, img, 3)).astype(np.uint8)
    return {"input_ids": input_ids, "attention_mask": attention_mask, "labels": labels, "pixels": pixels}


def _max_diff(a, b) -> float:
    return float((a.detach().double() - b.detach().double()).abs().max())


def _layers(rank: int) -> dict:
    """Each layer on this rank's shards against the dense layer on the whole
    weights, same seeded inputs on every rank."""
    import torch
    import torch.nn.functional as F

    from mafed_tpu_torch.core.dist import model_group
    from mafed_tpu_torch.core.mesh import make_mesh, shard_tensor
    from mafed_tpu_torch.models import gpt_neox
    from mafed_tpu_torch.models.tensor_parallel import (
        copy_to_model_group, vocab_parallel_cross_entropy, vocab_parallel_embedding,
    )

    group = model_group()
    gen = torch.Generator().manual_seed(0)
    out = {}
    try:  # the process runs the grid main() installed, and no other
        make_mesh((2, 1))
        out["other_grid_raises"] = False
    except ValueError:
        out["other_grid_raises"] = True

    # column -> row: fc2(gelu(fc1(x))), fc1 split over its outputs, fc2 over its inputs
    fc1, fc2 = torch.nn.Linear(16, 32), torch.nn.Linear(32, 16)
    with torch.no_grad():
        for p in (*fc1.parameters(), *fc2.parameters()):
            p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    x = torch.randn(3, 5, 16, generator=gen, requires_grad=True)
    r = torch.randn(3, 5, 16, generator=gen)
    y = gpt_neox.dense(F.gelu(gpt_neox.dense(x, fc1, torch.float32)), fc2, torch.float32)
    (y * r).sum().backward()
    l1, l2 = torch.nn.Linear(16, 16), torch.nn.Linear(16, 16)
    with torch.no_grad():
        l1.weight = torch.nn.Parameter(shard_tensor(fc1.weight, 0, group).clone())
        l1.bias = torch.nn.Parameter(shard_tensor(fc1.bias, 0, group).clone())
        l2.weight = torch.nn.Parameter(shard_tensor(fc2.weight, 1, group).clone())
        l2.bias = torch.nn.Parameter(fc2.bias.clone())
    xt = x.detach().clone().requires_grad_(True)
    h = gpt_neox.dense(copy_to_model_group(xt, group), l1, torch.float32)
    yt = gpt_neox.dense(F.gelu(h), l2, torch.float32, reduce=group)
    (yt * r).sum().backward()
    out["mlp"] = {"y": _max_diff(yt, y), "dx": _max_diff(xt.grad, x.grad),
                  "dw1": _max_diff(l1.weight.grad, shard_tensor(fc1.weight.grad, 0, group)),
                  "db1": _max_diff(l1.bias.grad, shard_tensor(fc1.bias.grad, 0, group)),
                  "dw2": _max_diff(l2.weight.grad, shard_tensor(fc2.weight.grad, 1, group)),
                  "db2": _max_diff(l2.bias.grad, fc2.bias.grad)}

    # vocab-parallel embedding: rows of a table of 12, split over the group
    table = torch.randn(12, 8, generator=gen, requires_grad=True)
    ids = torch.randint(0, 12, (3, 7), generator=gen)
    r = torch.randn(3, 7, 8, generator=gen)
    emb = F.embedding(ids, table)
    (emb * r).sum().backward()
    local = shard_tensor(table.detach(), 0, group).clone().requires_grad_(True)
    embt = vocab_parallel_embedding(ids, local, group)
    (embt * r).sum().backward()
    out["embedding"] = {"y": _max_diff(embt, emb), "dw": _max_diff(local.grad, shard_tensor(table.grad, 0, group))}

    # vocab-parallel CE against log_softmax and a gather
    logits = (3 * torch.randn(3, 7, 12, generator=gen)).requires_grad_(True)
    target = torch.randint(0, 12, (3, 7), generator=gen)
    r = torch.randn(3, 7, generator=gen)
    ce = -torch.gather(F.log_softmax(logits, dim=-1), -1, target[..., None])[..., 0]
    (ce * r).sum().backward()
    lt = shard_tensor(logits.detach(), 2, group).clone().requires_grad_(True)
    cet = vocab_parallel_cross_entropy(lt, target, group)
    (cet * r).sum().backward()
    out["cross_entropy"] = {"y": _max_diff(cet, ce), "dlogits": _max_diff(lt.grad, shard_tensor(logits.grad, 2, group))}

    # a decoder layer with and without the parallel residual (one reduction a layer, or two)
    from mafed_tpu_torch.core.config import ModelConfig
    from mafed_tpu_torch.core.mesh import param_partition_spec

    for parallel in (True, False):
        cfg = ModelConfig(vocab_size=64, hidden_size=32, num_hidden_layers=1, num_attention_heads=4,
                          intermediate_size=64, rotary_pct=0.25, use_parallel_residual=parallel)
        dense_layer, layer = gpt_neox.GPTNeoXLayer(cfg), gpt_neox.GPTNeoXLayer(cfg)
        with torch.no_grad():
            for p in dense_layer.parameters():
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
            for (name, p), q in zip(layer.named_parameters(), dense_layer.parameters()):
                dim = param_partition_spec(f"gpt_neox.layers.0.{name}")
                p.data = q.detach().clone() if dim is None else shard_tensor(q.detach(), dim, group).clone()
        layer.tp = group
        h = torch.randn(2, 6, 32, generator=gen, requires_grad=True)
        r = torch.randn(2, 6, 32, generator=gen)
        cos, sin = gpt_neox.rotary_tables(cfg, torch.arange(6)[None].expand(2, 6))
        y = dense_layer(h, cos, sin, None, torch.float32)
        (y * r).sum().backward()
        ht = h.detach().clone().requires_grad_(True)
        yt = layer(ht, cos, sin, None, torch.float32)
        (yt * r).sum().backward()
        diffs = {"y": _max_diff(yt, y), "dh": _max_diff(ht.grad, h.grad)}
        for (name, p), q in zip(layer.named_parameters(), dense_layer.parameters()):
            dim = param_partition_spec(f"gpt_neox.layers.0.{name}")
            diffs[name] = _max_diff(p.grad, q.grad if dim is None else shard_tensor(q.grad, dim, group))
        out[f"layer_parallel_residual_{parallel}"] = diffs
    return out


def _tiny_runner(root: str, mesh):
    import torch_mp_worker as W

    from mafed_tpu_torch.core.config import TrainConfig
    from mafed_tpu_torch.data.tokenizer import ByteTokenizer
    from mafed_tpu_torch.trainer.runner import TaskRunner
    from mafed_tpu_torch.utils.checkpoint import load_task_checkpoint

    cfg = TrainConfig(optim="adamw", weight_decay=0.01, learning_rate=1e-3, compute_dtype="float32",
                      mesh_shape=list(mesh), val_batch_size=4, reg_lambda=100.0)
    runner = TaskRunner(W.tiny_model_cfg(), cfg, ByteTokenizer(), device="cpu")
    runner.load_params(load_task_checkpoint(os.path.join(root, INIT_PARAMS)))
    return runner, cfg


def _model(root: str, rank: int, world: int, mesh) -> dict:
    import torch
    import torch_mp_worker as W

    from mafed_tpu_torch.core.dist import data_group, data_index
    from mafed_tpu_torch.core.mesh import gather_state_dict
    from mafed_tpu_torch.evaluation.decode import make_greedy_decoder
    from mafed_tpu_torch.evaluation.validate import gather_to_replicated, validate_vqa
    from mafed_tpu_torch.optim.optimizer import build_optimizer, set_schedule
    from mafed_tpu_torch.training.step import make_ce_window_step, make_ewc_fisher_fn
    from mafed_tpu_torch.training.train_state import TrainState, trainable_parameters
    from mafed_tpu_torch.utils.checkpoint import load_task_checkpoint, save_task_checkpoint

    out = {}
    full_sd = load_task_checkpoint(os.path.join(root, INIT_PARAMS))
    runner, cfg = _tiny_runner(root, mesh)
    gathered = gather_to_replicated(runner.model).state_dict()
    out["gather_exact"] = gathered.keys() == full_sd.keys() and all(
        torch.equal(gathered[k], full_sd[k].to(gathered[k].dtype)) for k in full_sd)
    out["shard_shapes"] = {k: list(p.shape) for k, p in runner.model.named_parameters()
                           if k.startswith("gpt_neox.layers.0.") or "vision_embed_tokens" in k or "embed" in k}

    # greedy tokens and validate_vqa: the val rows split over every rank
    tc = W.tiny_model_cfg()
    decoder = make_greedy_decoder(tc, max_new_tokens=4, eos_token_id=0, dtype=torch.float32, device="cpu")
    batches = []
    for i in range(3):
        b = example_batch(tc, 4, 8, seed=10 + i)
        b.pop("labels")
        b["answers"] = [["1", "1", "2"]] * 4
        b["qids"] = [f"q{i}_{j}" for j in range(4)]
        batches.append(b)
    out["tokens"] = decoder(gather_to_replicated(runner.model),
                            {k: torch.from_numpy(batches[0][k]) for k in ("input_ids", "attention_mask", "pixels")}
                            ).tolist()

    class Tok:
        def batch_decode(self, toks, skip_special_tokens=True):
            return [" ".join(str(int(t)) for t in row if int(t) != 0) for row in np.asarray(toks)]

    log, results = validate_vqa(runner.model, decoder, batches[rank::world], Tok(), batch_size=4)
    out["validate"] = {"acc": log["valid/acc"], "n_ex": log["valid/n_ex"], "results": results}

    # CE windows (2 microbatches of 4 rows, the rows split over the data group) under two remat policies
    rows = slice(data_index(), None, data_group().size)
    ce = {k: np.stack([example_batch(tc, 4, 12, seed=30 + i)[k] for i in range(2)]) for k in
          ("input_ids", "attention_mask", "labels", "pixels")}
    ce = {k: torch.from_numpy(v[:, rows]) for k, v in ce.items()}
    for policy in ("", "dots"):
        runner, cfg = _tiny_runner(root, mesh)
        cfg.remat_policy = policy
        trainable = trainable_parameters(runner.model)
        opt = build_optimizer(cfg, trainable, tp=runner.tp)
        state = TrainState(0, runner.model, set_schedule(opt.init(trainable), 0, 100))
        step = make_ce_window_step(tc, cfg, opt, device="cpu")
        metrics = []
        for _ in range(2):
            state, m = step(state, ce)
            metrics.append({k: float(v) for k, v in m.items()})
        out[f"ce_window_{policy or 'full'}"] = metrics
        params = runner.host_trainable()
        if rank == 0:
            save_task_checkpoint(params, os.path.join(root, f"ce_{policy or 'full'}_{world}.safetensors"))

    # the Fisher of one batch, then an EWC window from the last state
    fisher_step = make_ewc_fisher_fn(tc, cfg, device="cpu")
    fb = {k: torch.from_numpy(v[rows]) for k, v in example_batch(tc, 4, 12, seed=40).items()}
    fisher = fisher_step(runner.model, fb, {k: torch.zeros_like(p) for k, p in trainable.items()})
    old = {k: p.detach().clone() for k, p in trainable.items()}
    with torch.no_grad():  # theta moves away from theta*, so the penalty is far from 0
        for p in trainable.values():
            p.add_(1e-2)
    ewc_step = make_ce_window_step(tc, cfg, opt, with_ewc=True, device="cpu")
    state, m = ewc_step(state, ce, (fisher, old))
    out["ewc_window"] = {k: float(v) for k, v in m.items()}
    fisher_full = gather_state_dict(fisher, runner.tp)
    params = runner.host_trainable()
    if rank == 0:
        save_task_checkpoint(fisher_full, os.path.join(root, f"fisher_{world}.safetensors"))
        save_task_checkpoint(params, os.path.join(root, f"ewc_{world}.safetensors"))
    return out


def _windows(root: str, tag: str, rank: int, world: int, mesh, preset: str) -> dict:
    """`_tp_step_probe`: two fused MAFED windows (n_ce 1, 4 rows, the rows
    split over the data group), the teacher a bfloat16 copy of the start,
    lr linear_warmup_schedule(1e-3, 2, 10); then the optimizer state
    gathered, written, read back and sharded into a fresh state."""
    import torch

    import torch.distributed as dist

    from mafed_tpu_torch.core.config import TrainConfig
    from mafed_tpu_torch.core.dist import barrier, data_group, data_index, process_count
    from mafed_tpu_torch.data.tokenizer import ByteTokenizer
    from mafed_tpu_torch.optim.optimizer import build_optimizer
    from mafed_tpu_torch.optim.sched import linear_warmup_schedule
    from mafed_tpu_torch.trainer.runner import TaskRunner
    from mafed_tpu_torch.training.step import make_mafed_window_step
    from mafed_tpu_torch.training.train_state import TrainState, make_teacher, trainable_parameters
    from mafed_tpu_torch.utils.checkpoint import (
        _flatten, gather_opt_state, load_opt_state, load_task_checkpoint, save_opt_state, save_task_checkpoint,
    )

    mc = probe_model_cfg(preset)
    cfg = TrainConfig(**probe_train_kwargs(), mesh_shape=list(mesh))
    runner = TaskRunner(mc, cfg, ByteTokenizer(), device="cpu")
    runner.load_params(load_task_checkpoint(os.path.join(root, f"probe_{preset}.safetensors")))
    model = runner.model
    trainable = trainable_parameters(model)
    tx = build_optimizer(cfg, trainable, linear_warmup_schedule(1e-3, 2, 10), tp=runner.tp)
    state = TrainState(0, model, tx.init(trainable))
    teacher = make_teacher(model)
    step = make_mafed_window_step(mc, cfg, tx, n_ce=1, device="cpu")
    rows = slice(data_index(), None, data_group().size)
    lang = torch.full((mc.num_hidden_layers - 1,), 0.5)
    losses = []
    for s in range(2):
        ce = {k: torch.from_numpy(v[None, rows]) for k, v in example_batch(mc, 4, 12, seed=10 + s).items()}
        db = {k: torch.from_numpy(v[rows]) for k, v in example_batch(mc, 4, 12, seed=20 + s).items()}
        state, m = step(state, teacher, ce, db, lang)
        losses.append({k: float(m[k]) for k in ("loss", "ce_loss", "distill_loss", "grad_norm")})
    params = runner.host_trainable()
    full_opt = gather_opt_state(state.opt_state, runner.tp)
    path = os.path.join(root, f"{tag}_opt.safetensors")
    counters = save_opt_state(full_opt, path) if rank == 0 else None
    if process_count() > 1:
        box = [counters]
        dist.broadcast_object_list(box, src=0)
        counters = box[0]
    barrier("opt_saved")
    restored = load_opt_state(tx.init(trainable), path, counters, runner.tp)
    a, b = {}, {}
    _flatten(state.opt_state, "", a, {})
    _flatten(restored, "", b, {})
    roundtrip = max(float((a[k].float() - b[k].float()).abs().max()) for k in a)
    if rank == 0:
        save_task_checkpoint(params, os.path.join(root, f"{tag}_params.safetensors"))
    return {"losses": losses, "opt_roundtrip_max_diff": roundtrip, "n_opt_tensors": len(a),
            "local_qkv_rows": int(trainable["gpt_neox.layers.0.attention.query_key_value.weight"].shape[0])}


def _cl(root: str, tag: str, rank: int, mesh, mode: str) -> dict:
    """The CL run ("cl"), preempted by the countdown after N updates on
    every rank ("cl_preempt:N"), or resumed from its bundle ("cl_resume")."""
    import torch_mp_worker as W

    from mafed_tpu_torch.core import preempt
    from mafed_tpu_torch.trainer.continual import ContinualLearningTrainer
    from mafed_tpu_torch.utils.checkpoint import load_task_checkpoint, save_task_checkpoint

    cfg = W.cl_config(root, tag)
    cfg.mesh_shape = list(mesh)
    if mode == "cl_resume":
        cfg.resume_from_checkpoint = os.path.join(cfg.output_dir, "resume")
    trainer = ContinualLearningTrainer(cfg, model_cfg=W.tiny_model_cfg(), synthetic_images=True,
                                       init_params=load_task_checkpoint(os.path.join(root, W.INIT_PARAMS)),
                                       device="cpu")
    if mode.startswith("cl_preempt:"):
        preempt.request_preemption_after(int(mode.split(":")[1]))
    try:
        result = trainer.main()
    except preempt.Preempted as exc:
        with open(os.path.join(cfg.output_dir, "resume", "fit_state.json")) as f:
            bundle = json.load(f)
        return {"preempted": exc.code, "bundle": {k: bundle[k] for k in ("task_id", "epoch", "batches_done")}}
    final = trainer.runner.host_trainable()
    if rank == 0:
        save_task_checkpoint(final, os.path.join(root, f"final_{tag}.safetensors"))
    return {"is_main": trainer.is_main, "accuracy_matrix": result["accuracy_matrix"], "bwt": result["bwt"],
            "window": trainer.runner.window, "steps": [log["steps"] for log in trainer.fit_logs],
            "primed": trainer.primed, "teacher_cache": trainer.strategy.teacher_cache_log}


def _pretrain(root: str, tag: str, rank: int, world: int, mesh) -> dict:
    import torch_mp_worker as W

    from mafed_tpu_torch.data.tokenizer import ByteTokenizer
    from mafed_tpu_torch.pretrain.trainer import PretrainTrainer
    from mafed_tpu_torch.training.train_state import trainable_parameters
    from mafed_tpu_torch.utils.checkpoint import save_task_checkpoint

    model_cfg, tokenizer = W.tiny_model_cfg(), ByteTokenizer(model_max_length=32)
    train_ds, eval_ds = W.pretrain_datasets(tokenizer, model_cfg.vision)
    args = W.pretrain_config(root, tag, 8 // world)
    args.mesh_shape = tuple(mesh)
    trainer = PretrainTrainer(model_cfg, args, train_ds, eval_ds, tokenizer=tokenizer, device="cpu")
    if rank == 0 and world == 1:
        save_task_checkpoint(trainable_parameters(trainer.model), os.path.join(root, f"before_{tag}.safetensors"))
    trainer.train()
    return {"is_main": trainer.is_main, "global_batch": trainer.global_batch,
            "local_rows": trainer.global_batch // (world // mesh[1])}


def main() -> None:
    rank, world, port, root, tag, mode = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
                                          sys.argv[5], sys.argv[6])
    mesh = (int(sys.argv[7]), int(sys.argv[8]))
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=port)
    sys.path.insert(0, REPO)
    import torch

    torch.set_num_threads(1)
    from mafed_tpu_torch.core.dist import data_index, maybe_initialize_distributed, model_index, process_count
    from mafed_tpu_torch.core.mesh import make_mesh

    maybe_initialize_distributed(backend="gloo", device="cpu")
    if process_count() != world:
        raise AssertionError(f"{process_count()} ranks, expected {world}")
    grid = make_mesh(mesh)
    out = {"rank": rank, "data_index": data_index(), "model_index": model_index(),
           "data_ranks": list(grid.data.ranks), "model_ranks": list(grid.model.ranks)}
    from mafed_tpu_torch.evaluation.classifier import all_reduce_metrics

    # the metric states summed over the data group: model peers, which score the same rows, once
    out["metrics_sum"] = list(all_reduce_metrics(1.0, 2.0, 3.0, mesh_shape=mesh))
    try:
        all_reduce_metrics(1.0, 2.0, 3.0, mesh_shape=(world, 1))
        out["metrics_other_grid_raises"] = False
    except ValueError:
        out["metrics_other_grid_raises"] = True
    if mode == "layers":
        out.update(_layers(rank))
    elif mode == "model":
        out.update(_model(root, rank, world, mesh))
    elif mode.startswith("windows:"):
        out.update(_windows(root, tag, rank, world, mesh, mode.split(":")[1]))
    elif mode.startswith("cl"):
        out.update(_cl(root, tag, rank, mesh, mode))
    elif mode == "pretrain":
        out.update(_pretrain(root, tag, rank, world, mesh))
    else:
        raise ValueError(mode)
    with open(os.path.join(root, f"worker_{tag}_{rank}.json"), "w") as f:
        json.dump(out, f)
    print(f"rank {rank}/{world} {mode} ok", flush=True)


if __name__ == "__main__":
    main()
