"""Where the time of the port's main paths goes on an NVIDIA GPU.

    python3 scripts/profile_torch.py [--path window|window_unfused|ce_window|train_step|decode|cl_sequence|pretrain_step]
                                     [--preset 410m|1b|1.4b|neox20b_4l|1b_d512|neox20b_4l_d384] [--reps 2] [--train-questions 1024]
                                     [--compute_dtype bfloat16|float32] [--out PATH]

window: the fused MAFED window of chip_smoke.py (VL-Pythia-410M at full width
and depth, 3 CE microbatches of 16 + 1 memory microbatch of 16, 256 cached
patches + 80 text tokens, bf16), two warm-up windows, then `--reps` profiled
windows. window_unfused: the same window with fuse_ce_batch=False (one pass
and one backward per CE microbatch). --compute_dtype float32 runs either
window at float32 (chip_smoke.py's window_f32: the float32 flash kernels).

ce_window: the CE window of chip_smoke.py's train_steps phase (the same
model, 4 CE microbatches of 16 merged into one pass with per-layer remat, one
AdamW update). train_step: one CE microbatch of 16 with its own update and no
remat (the saved (o, lse) go straight to the backward kernels).

decode: the greedy decode of chip_smoke.py's decode phase (410M + EVA-02-L,
bf16 weights, batch 32, text 64 with 16 left-padded positions, 10 new
tokens): the whole decode from uint8 pixels and from cached patches, and its
parts alone: the tower, the KV-cache prefill, and one single-token step.

cl_sequence: chip_smoke.py's two-task MAFED sequence through the trainer's
entry points (the shipped config and its 410M model, synthetic data), with
`--train-questions` a task (1024: 16 windows a task) and 32 val questions,
in two variants: "streaming" (chip_smoke.STREAMING_SWITCHES: the features
streamed, the in-step teacher; phase cl_sequence) and "default" (the
shipped config with no switch: both device tables; phase
cl_sequence_default). One process runs a warm-up sequence at 128 questions
(the kernels' build and every first use in the process land there); then,
unprofiled, streaming, default, default, streaming, for the trainer's own
stage times, `train_ex_per_s`, bundle saves and teacher priming; then each
variant once with each task's fit (its epoch and the epoch's validation)
profiled as one unit. `--preset` does not apply to it.

pretrain_step: one update of captioning pretraining as PretrainTrainer
runs it (chip_smoke.py's pretrain phase: VL-Pythia-410M + EVA-02-L, batch
128 of uint8 pixels through the frozen tower, 100 caption tokens
right-padded per row, AdamW, bf16), from a batch of the trainer's own
loader on the card; and one batch of its eval loss (forward only).

--preset 1b runs every other path with VL-Pythia-1B (hidden 2048, 16 layers, 8
heads of 256) at the same shapes in place of the 410M model; 1.4b with
VL-Pythia-1.4B (16 heads of 128), neox20b_4l with the decoder at
GPT-NeoX-20B's widths cut to 4 layers (64 heads of 96); 1b_d512 and
neox20b_4l_d384 with 1B's decoder regrouped as 4 heads of 512 and that cut
as 16 heads of 384 (the wide kernels): chip_smoke.DECODER_CONFIGS.

For each profiled unit, torch.profiler over `--reps` steady repetitions
gives the wall ms per repetition (host clock, ending in a synchronise),
the device busy ms (union of kernel intervals), the idle share, kernel time
by category, kernel launches per repetition and the top kernels. One JSON
object goes to stdout, and with --out to that file too.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def category(name: str) -> str:
    for kernel in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        if any(f"{kernel}_{form}kernel" in name for form in ("", "wide_", "f32_")):
            return kernel
    lowered = name.lower()
    if any(s in lowered for s in ("gemm", "xmma", "cutlass", "nvjet", "cublas")):
        return "matmul"
    if "reduce" in lowered or "norm" in lowered or "softmax" in lowered:
        return "reduction"
    if "memcpy" in lowered or "memset" in lowered:
        return "copy"
    return "elementwise"


def busy_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def profile(fn, reps: int, warmup: int = 2) -> dict:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        start = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3 / reps
    per_kernel = defaultdict(lambda: [0.0, 0])
    intervals = []
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        intervals.append((evt.time_range.start, evt.time_range.end))
        per_kernel[evt.name][0] += evt.time_range.elapsed_us()
        per_kernel[evt.name][1] += 1
    by_category = defaultdict(float)
    for name, (us, _) in per_kernel.items():
        by_category[category(name)] += us / 1e3 / reps
    busy_ms = busy_us(intervals) / 1e3 / reps
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:12]
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
        "kernel_ms_by_category": dict(sorted(by_category.items(), key=lambda kv: -kv[1])),
        "device_events": len(intervals) / reps,
        "top_kernels": [
            {"name": n[:100], "ms": us / 1e3 / reps, "calls": c / reps} for n, (us, c) in top
        ],
    }


def window_units(reps: int, preset: str, fuse: bool = True, compute_dtype: str = "bfloat16") -> dict:
    from chip_smoke import model_config, window_setup
    from mafed_tpu_torch.models.vl_pythia import init_model

    cfg = model_config(preset)
    model = init_model(cfg, seed=0, device="cuda")
    step, state, teacher, ce, distill, lang = window_setup(cfg, model, 3, 16, 80, torch.Generator().manual_seed(2), "cuda",
                                                           fuse_ce_batch=fuse, compute_dtype=compute_dtype)
    box = [state]

    def window():
        box[0], _ = step(box[0], teacher, ce, distill, lang)

    return {"window" if fuse else "window_unfused": profile(window, reps)}


def ce_units(path: str, reps: int, preset: str) -> dict:
    from chip_smoke import example_batch, model_config, stack, train_config
    from mafed_tpu_torch.models.vl_pythia import init_model
    from mafed_tpu_torch.optim.optimizer import build_optimizer, set_schedule
    from mafed_tpu_torch.training.step import make_ce_window_step, make_train_step
    from mafed_tpu_torch.training.train_state import TrainState, trainable_parameters

    cfg = model_config(preset)
    model = init_model(cfg, seed=0, device="cuda")
    train_cfg = train_config()
    trainable = trainable_parameters(model)
    opt = build_optimizer(train_cfg, trainable)
    box = [TrainState(0, model, set_schedule(opt.init(trainable), 0, 100))]
    gen = torch.Generator().manual_seed(2)
    mbs = [{k: v.cuda() for k, v in example_batch(gen, cfg, 16, 80).items()} for _ in range(4)]
    if path == "ce_window":
        step, data = make_ce_window_step(cfg, train_cfg, opt), stack(mbs)
    else:
        step, data = make_train_step(cfg, train_cfg, opt), mbs[0]

    def unit():
        box[0], _ = step(box[0], data)

    return {path: profile(unit, reps)}


def decode_units(reps: int, preset: str) -> dict:
    from chip_smoke import decode_batches, model_config
    from mafed_tpu_torch.data.images import make_normalizer, prep_pixels
    from mafed_tpu_torch.evaluation.decode import make_greedy_decoder
    from mafed_tpu_torch.models import gpt_neox
    from mafed_tpu_torch.models import vl_pythia as V
    from mafed_tpu_torch.models.vl_pythia import init_model

    cfg = model_config(preset)
    b, text_len, pad, max_new, dtype = 32, 64, 16, 10, torch.bfloat16
    model = init_model(cfg, seed=0, device="cuda", dtype=dtype)
    decode = make_greedy_decoder(cfg, max_new_tokens=max_new)
    host = {k: torch.from_numpy(v) for k, v in decode_batches(cfg, 1, b, text_len, pad, seed=4)[0].items()}
    with torch.inference_mode():
        px = prep_pixels({"pixels": host["pixels"].cuda()}, make_normalizer(cfg.vision), dtype)
        patches = V.get_patch_embeddings(model, px, dtype=dtype)
        ids, mask = host["input_ids"].cuda(), host["attention_mask"].cuda()
        embeds, full_mask = V.build_inputs(model, ids, mask, patches, dtype=dtype)
    buf_mask = torch.cat([full_mask, full_mask.new_ones((b, max_new))], dim=1)
    prefix = embeds.shape[1]
    cache = gpt_neox.KVCache.create(cfg, b, prefix + max_new, dtype=dtype, device="cuda")
    tok = torch.ones(b, 1, dtype=torch.int32, device="cuda")
    cached = {"input_ids": host["input_ids"], "attention_mask": host["attention_mask"], "patches": patches}

    def tower():
        with torch.inference_mode():
            V.get_patch_embeddings(model, px, dtype=dtype)

    def prefill():
        with torch.inference_mode():
            cache.length = 0
            h = model.gpt_neox(embeds, attention_mask=buf_mask, cache=cache, dtype=dtype)["last_hidden_state"]
            gpt_neox.logits(model.embed_out, h[:, -1], dtype=dtype).argmax(-1)

    def step():  # the 5th single-token step
        with torch.inference_mode():
            cache.length = prefix + 4
            e = gpt_neox.embed(model.gpt_neox, tok, dtype=dtype)
            h = model.gpt_neox(e, attention_mask=buf_mask, cache=cache, dtype=dtype)["last_hidden_state"]
            gpt_neox.logits(model.embed_out, h[:, -1], dtype=dtype).argmax(-1)

    return {
        "decode_pixels": profile(lambda: decode(model, host), reps),
        "decode_patches": profile(lambda: decode(model, cached), reps),
        "tower": profile(tower, reps),
        "prefill": profile(prefill, reps),
        "step": profile(step, reps),
    }


def cl_sequence_units(train_questions: int) -> dict:
    import tempfile

    from chip_smoke import STREAMING_SWITCHES, cl_sequence_argv, write_synthetic_vqa
    from mafed_tpu_torch.core.config import ModelConfig, build_arg_parser, parse_with_config
    from mafed_tpu_torch.trainer.continual import ContinualLearningTrainer

    switches = {"streaming": STREAMING_SWITCHES, "default": []}
    runs = [("warmup", "default", 128, False)]
    runs += [(f"{v}_{i}", v, train_questions, False)
             for i, v in enumerate(("streaming", "default", "default", "streaming"), start=1)]
    runs += [(f"profiled_{v}", v, train_questions, True) for v in ("streaming", "default")]
    units = {}
    for name, variant, n_train, profiled in runs:
        with tempfile.TemporaryDirectory(prefix="cl_sequence_") as root:
            write_synthetic_vqa(root, ("taskA", "taskB"), n_train, 32)
            cfg = parse_with_config(build_arg_parser(), cl_sequence_argv(root) + switches[variant])
            trainer = ContinualLearningTrainer(cfg, model_cfg=ModelConfig.from_json(cfg.model_config),
                                               synthetic_images=True)
            if profiled:
                fit = trainer.runner.fit

                def profiled_fit(*args, **kwargs):
                    out = []
                    units[f"{name}_fit_task{args[4]}"] = profile(lambda: out.append(fit(*args, **kwargs)), reps=1,
                                                                 warmup=0)
                    return out[0]

                trainer.runner.fit = profiled_fit
            start = time.perf_counter()
            trainer.main()
            if not profiled:
                units[name] = {
                    "variant": variant, "wall_s": time.perf_counter() - start, "seconds": trainer.timings,
                    "train_ex_per_s": [[h["train_ex_per_s"] for h in log["history"]] for log in trainer.fit_logs],
                    "steps": [log["steps"] for log in trainer.fit_logs], "images_primed": trainer.primed,
                    "bundle_save_s": trainer.runner.bundle_save_s, "vision_tables": trainer.vision_tables,
                    "teacher_cache": trainer.strategy.teacher_cache_log,
                }
            del trainer
            torch.cuda.empty_cache()
    return units


def pretrain_units(reps: int) -> dict:
    import tempfile

    from chip_smoke import pretrain_argv
    from mafed_tpu_torch.data.prefetch import to_device
    from mafed_tpu_torch.data.tokenizer import ByteTokenizer
    from mafed_tpu_torch.pretrain.dataset import PretrainDataset
    from mafed_tpu_torch.pretrain.trainer import PretrainTrainer
    from mafed_tpu_torch.pretrain_vlpythia import parse_args
    from mafed_tpu_torch.core.config import ModelConfig
    from mafed_tpu_torch.training.step import _ce_loss, _vision_features
    from mafed_tpu_torch.training.train_state import TrainState, trainable_parameters

    with tempfile.TemporaryDirectory(prefix="profile_pretrain_") as root:
        _, data_args, args, _ = parse_args(pretrain_argv(root))
        cfg = ModelConfig()
        tok = ByteTokenizer(model_max_length=args.model_max_length, padding_side="right")
        train = PretrainDataset(tok, cfg.vision, manifest_path=data_args.manifest, model_max_length=args.model_max_length)
        trainer = PretrainTrainer(cfg, args, train, None, tok)
        batch = to_device(next(iter(trainer._loader(train, trainer.global_batch, args.model_max_length, shuffle=True))),
                          trainer.device)
    box = [TrainState(0, trainer.model, trainer.tx.init(trainable_parameters(trainer.model)))]

    def step():
        box[0], _ = trainer.step_fn(box[0], batch)

    def eval_batch():
        with torch.no_grad():
            patches = _vision_features(trainer.model, batch, trainer._normalize, torch.bfloat16)
            _ce_loss(trainer.model, batch, patches, torch.bfloat16, None, remat=False)

    units = {"pretrain_step": profile(step, reps)}
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    units["pretrain_step"]["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    units["pretrain_eval_batch"] = profile(eval_batch, reps)
    return units


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--path", choices=("window", "window_unfused", "ce_window", "train_step", "decode",
                                           "cl_sequence", "pretrain_step"),
                        default="window")
    parser.add_argument("--preset", choices=("410m", "1b", "1.4b", "neox20b_4l", "1b_d512", "neox20b_4l_d384"),
                        default="410m")
    parser.add_argument("--reps", type=int, default=2)
    parser.add_argument("--train-questions", type=int, default=1024, help="cl_sequence: train questions a task")
    parser.add_argument("--compute_dtype", choices=("bfloat16", "float32"), default="bfloat16",
                        help="window, window_unfused: the compute dtype")
    parser.add_argument("--out", help="also write the JSON object to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.path in ("window", "window_unfused"):
        units = window_units(args.reps, args.preset, fuse=args.path == "window", compute_dtype=args.compute_dtype)
    elif args.path == "decode":
        units = decode_units(args.reps, args.preset)
    elif args.path == "cl_sequence":
        units = cl_sequence_units(args.train_questions)
    elif args.path == "pretrain_step":
        units = pretrain_units(args.reps)
    else:
        units = ce_units(args.path, args.reps, args.preset)
    result = {"card": smi, "path": args.path, "preset": args.preset, "compute_dtype": args.compute_dtype,
              "reps": args.reps, "units": units}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
