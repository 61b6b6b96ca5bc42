"""One rank of the port's multi-process tests (tests/test_torch_multiprocess.py),
the counterpart of tests/mp_worker.py: a gloo process group on the CPU,
joined through the launcher's variables as torchrun sets them. It imports
only mafed_tpu_torch.

    python tests/torch_mp_worker.py <rank> <world> <port> <root> <tag> <mode>

With world 1 no group is joined: the one-rank run of the same program.
Each rank writes <root>/worker_<tag>_<rank>.json. Modes:

  units       process_reduce_sum on known values; the EWC Fisher of the tiny
              model over the sharded loader of task A (rank 0 saves it); two
              MAFED windows on the rank's rows of 8 (`window_batches`)
  cl          the continual-learning trainer in tests/mp_worker.py's
              configuration (`cl_config`); each rank saves its final
              trainable parameters
  preempt:N   the same, the countdown of a preemption after N updates on
              every rank
  resume      the same command with resume_from_checkpoint
  flag:K      the same, rank 1 alone setting the preemption flag after K
              updates, as a SIGTERM would
  pretrain    PretrainTrainer on 32 + 8 captions at 8 a global batch; rank 0
              saves the trainable parameters it starts from, each rank
              those of checkpoint-final
"""

from __future__ import annotations

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the tiny model of tests/torch_helpers.py::tiny_cfgs (that module imports JAX)
TINY = dict(vocab_size=512, hidden_size=128, num_hidden_layers=3, num_attention_heads=2, intermediate_size=256,
            rotary_pct=0.25)
TINY_VISION = dict(img_size=28, patch_size=14, embed_dim=32, depth=2, num_heads=2, mlp_ratio=2.0)
INIT_PARAMS = "init.safetensors"  # the starting weights the test writes into <root>


def tiny_model_cfg():
    from mafed_tpu_torch.core.config import ModelConfig, VisionConfig

    return ModelConfig(**TINY, vision=VisionConfig(**TINY_VISION), vision_encoder_name="tiny-eva")


def cl_config(root: str, tag: str):
    """tests/mp_worker.py's trainer configuration over the data of
    tests/torch_helpers.py::write_synthetic_vqa under `root`: featdistill
    with fused windows of 2 (a replay batch every 2nd), a global batch of 8,
    the teacher-state cache on, a resume bundle every epoch, epochs [2, 2];
    compute in float32, as the port's parity tests run."""
    from mafed_tpu_torch.core.config import TrainConfig

    return TrainConfig(
        output_dir=os.path.join(root, tag), data_dir=root, question_task_ids=os.path.join(root, "contvqa"),
        exp="tiny", tasks=["taskA", "taskB"], train_img_dirs=["unused"], val_img_dirs=["unused"],
        batch_size=8, val_batch_size=4, accumulate_grad_batches=2, replay_interval=2, epochs=[2, 2],
        max_txt_len=24, n_workers=2, val_num_workers=2, learning_rate=1e-3, optim="adamw", weight_decay=0.01,
        text_pad_multiple=8, mesh_shape=[-1, 1], log_every=1, seed=42, allow_tokenizer_fallback=True,
        cl_method="featdistill", cl_memory=8, replay_coeff=1.0, distillation_coeff=1.0,
        distillation_modality_weighing_strategy="balanced", distillation_layer_weighing_strategy="discounted",
        fused_window=True, resume_bundle_every=1, teacher_state_cache=True, compute_dtype="float32",
    )


def _units(root: str, rank: int, world: int) -> dict:
    from mafed_tpu_torch.cl.ewc import EWC
    from mafed_tpu_torch.core.dist import process_reduce_sum
    from mafed_tpu_torch.data.factory import prepare_train_dataset
    from mafed_tpu_torch.data.tokenizer import build_tokenizer
    from mafed_tpu_torch.trainer.runner import TaskRunner
    from mafed_tpu_torch.training.train_state import TrainState
    from mafed_tpu_torch.utils.checkpoint import load_task_checkpoint, save_task_checkpoint

    reduced = process_reduce_sum(float(rank) + 1.0, 10.0)
    cfg, model_cfg = cl_config(root, "units"), tiny_model_cfg()
    tokenizer = build_tokenizer(cfg.tokenizer_name, model_max_length=100, padding_side="left",
                                allow_fallback=True)
    runner = TaskRunner(model_cfg, cfg, tokenizer, device="cpu")
    runner.load_params(load_task_checkpoint(os.path.join(root, INIT_PARAMS)))
    dataset = prepare_train_dataset(cfg, "taskA", tokenizer, model_cfg.vision, synthetic_images=True)
    ewc = EWC(cfg, model_cfg)
    ewc.update(runner, TrainState(0, runner.model, None), dataset, runner.make_train_loader(dataset, shuffle=False))
    if rank == 0:
        save_task_checkpoint(ewc.fisher, os.path.join(root, f"fisher_{world}.safetensors"))
    return {"reduce": list(reduced), "reduce_expected": [sum(range(1, world + 1)) * 1.0, 10.0 * world],
            "windows": _windows(root, rank, world)}


def window_batches(seed: int, n_ce: int = 2, b: int = 8, text_len: int = 16):
    """A window's CE stack [n_ce, b, ...] and memory batch [b, ...] of the
    tiny model: left padding of 0 to 11 positions a row, so that the rows'
    token counts differ, a 4-token answer, cached patches."""
    import numpy as np

    rng, cfg = np.random.default_rng(seed), tiny_model_cfg()

    def batch(n):
        ids = rng.integers(1, cfg.vocab_size - 1, size=(n, text_len)).astype(np.int64)
        mask = np.ones((n, text_len), np.int64)
        for i, pad in enumerate(rng.integers(0, 12, size=n)):
            mask[i, :pad] = 0
        labels = ids.copy()
        labels[:, :-4] = -100
        patches = rng.normal(size=(n, cfg.vision.num_patches, cfg.vision.embed_dim)).astype(np.float32)
        return {"input_ids": ids, "attention_mask": mask, "labels": labels, "patches": patches}

    ce = [batch(b) for _ in range(n_ce)]
    return {k: np.stack([mb[k] for mb in ce]) for k in ce[0]}, batch(b)


def _windows(root: str, rank: int, world: int) -> list:
    """Two fused MAFED windows of the tiny model (float32, a teacher from
    other weights, so that the distill loss and its gradient are far from
    0) on this rank's interleaved rows; rank 0 saves the parameters."""
    import torch

    from mafed_tpu_torch.core.config import TrainConfig
    from mafed_tpu_torch.models.vl_pythia import init_model
    from mafed_tpu_torch.optim.optimizer import build_optimizer, set_schedule
    from mafed_tpu_torch.training.step import make_mafed_window_step
    from mafed_tpu_torch.training.train_state import TrainState, make_teacher, trainable_parameters
    from mafed_tpu_torch.utils.checkpoint import load_task_checkpoint, save_task_checkpoint

    cfg = tiny_model_cfg()
    train_cfg = TrainConfig(optim="adamw", weight_decay=0.01, learning_rate=1e-3, compute_dtype="float32",
                            replay_coeff=1.0, distillation_coeff=1.0,
                            distillation_modality_weighing_strategy="balanced",
                            distillation_layer_weighing_strategy="discounted")
    model = init_model(cfg, seed=0, device="cpu")
    model.load_state_dict(load_task_checkpoint(os.path.join(root, INIT_PARAMS)))
    teacher = make_teacher(init_model(cfg, seed=1, device="cpu"))
    trainable = trainable_parameters(model)
    opt = build_optimizer(train_cfg, trainable)
    state = TrainState(0, model, set_schedule(opt.init(trainable), 0, 100))
    step = make_mafed_window_step(cfg, train_cfg, opt, n_ce=2, device="cpu")
    lang = torch.full((cfg.num_hidden_layers - 1,), 0.5)
    rows, metrics = slice(rank, None, world), []
    for seed in range(2):
        ce, memory = window_batches(seed)
        state, m = step(state, teacher, {k: torch.from_numpy(v[:, rows]) for k, v in ce.items()},
                        {k: torch.from_numpy(v[rows]) for k, v in memory.items()}, lang)
        metrics.append({k: v.tolist() for k, v in m.items()})
    if rank == 0:
        save_task_checkpoint(trainable, os.path.join(root, f"window_{world}.safetensors"))
    return metrics


def _cl(root: str, tag: str, mode: str, rank: int, world: int) -> dict:
    from mafed_tpu_torch.core import preempt
    from mafed_tpu_torch.trainer.continual import ContinualLearningTrainer
    from mafed_tpu_torch.utils.checkpoint import load_task_checkpoint, save_task_checkpoint

    cfg = cl_config(root, tag)
    if mode == "resume":
        cfg.resume_from_checkpoint = os.path.join(cfg.output_dir, "resume")
    trainer = ContinualLearningTrainer(cfg, model_cfg=tiny_model_cfg(), synthetic_images=True,
                                       init_params=load_task_checkpoint(os.path.join(root, INIT_PARAMS)),
                                       device="cpu")
    out = {"is_main": trainer.is_main, "metrics_none": trainer.metrics is None, "primed": trainer.primed}
    ticks = []
    if mode.startswith("preempt:"):
        preempt.request_preemption_after(int(mode.split(":")[1]))
    elif mode.startswith("flag:"):
        after, tick = int(mode.split(":")[1]), preempt.tick_update

        def counted_tick():
            tick()
            ticks.append(1)
            if rank == 1 and len(ticks) == after:
                preempt.request_preemption()  # this rank alone, as its SIGTERM handler does

        preempt.tick_update = counted_tick
    try:
        result = trainer.main()
    except preempt.Preempted as exc:
        with open(os.path.join(cfg.output_dir, "resume", "fit_state.json")) as f:
            bundle = json.load(f)
        return {**out, "preempted": exc.code, "updates": len(ticks),
                "bundle": {k: bundle[k] for k in ("task_id", "epoch", "batches_done", "global_step")}}
    if mode != "none" and mode != "resume":
        raise AssertionError(f"{mode}: no preemption")
    save_task_checkpoint(trainer.runner.host_trainable(), os.path.join(root, f"final_{tag}_{rank}.safetensors"))
    return {**out, "accuracy_matrix": result["accuracy_matrix"], "bwt": result["bwt"],
            "window": trainer.runner.window, "steps": [log["steps"] for log in trainer.fit_logs]}


def pretrain_datasets(tokenizer, vision_cfg):
    from mafed_tpu_torch.pretrain.dataset import CaptionRecord, PretrainDataset

    def dataset(n, prefix):
        records = [CaptionRecord(image=f"{prefix}{i}", caption=f"a photo of thing {i}", source="coco")
                   for i in range(n)]
        return PretrainDataset(tokenizer, vision_cfg, records=records, model_max_length=32, synthetic_images=True)

    return dataset(32, "tr"), dataset(8, "ev")


def pretrain_config(root: str, tag: str, per_device: int):
    """tests/mp_worker.py's pretraining arguments at `per_device` rows a rank."""
    from mafed_tpu_torch.pretrain.trainer import PretrainConfig

    return PretrainConfig(output_dir=os.path.join(root, tag), per_device_train_batch_size=per_device,
                          per_device_eval_batch_size=per_device, num_train_epochs=1, learning_rate=1e-3,
                          save_steps=1.0, eval_steps=0.5, model_max_length=32, logging_steps=1)


def _pretrain(root: str, tag: str, rank: int, world: int) -> dict:
    from mafed_tpu_torch.data.tokenizer import ByteTokenizer
    from mafed_tpu_torch.pretrain.trainer import PretrainTrainer

    model_cfg, tokenizer = tiny_model_cfg(), ByteTokenizer(model_max_length=32)
    train_ds, eval_ds = pretrain_datasets(tokenizer, model_cfg.vision)
    from mafed_tpu_torch.training.train_state import trainable_parameters
    from mafed_tpu_torch.utils.checkpoint import save_task_checkpoint

    trainer = PretrainTrainer(model_cfg, pretrain_config(root, tag, 8 // world), train_ds, eval_ds,
                              tokenizer=tokenizer, device="cpu")
    if rank == 0:
        save_task_checkpoint(trainable_parameters(trainer.model), os.path.join(root, f"before_{tag}.safetensors"))
    save = trainer.save_checkpoint

    def save_and_keep(state, ckpt_tag, *args, **kwargs):
        # each rank's parameters of checkpoint-final, before the best checkpoint loads over them
        if ckpt_tag == "checkpoint-final":
            save_task_checkpoint(trainable_parameters(trainer.model),
                                 os.path.join(root, f"final_{tag}_{rank}.safetensors"))
        return save(state, ckpt_tag, *args, **kwargs)

    trainer.save_checkpoint = save_and_keep
    trainer.train()
    return {"is_main": trainer.is_main, "metrics_none": trainer.metrics is None, "global_batch": trainer.global_batch}


def main() -> None:
    rank, world, port, root, tag, mode = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
                                          sys.argv[5], sys.argv[6])
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=port)
    sys.path.insert(0, REPO)
    import torch

    torch.set_num_threads(1)
    from mafed_tpu_torch.core.dist import maybe_initialize_distributed, process_count

    maybe_initialize_distributed(backend="gloo", device="cpu")
    if process_count() != world:
        raise AssertionError(f"{process_count()} ranks, expected {world}")
    if mode == "units":
        out = _units(root, rank, world)
    elif mode == "pretrain":
        out = _pretrain(root, tag, rank, world)
    else:
        out = _cl(root, tag, mode, rank, world)
    with open(os.path.join(root, f"worker_{tag}_{rank}.json"), "w") as f:
        json.dump({"rank": rank, **out}, f)
    print(f"rank {rank}/{world} {mode} ok", flush=True)


if __name__ == "__main__":
    main()
